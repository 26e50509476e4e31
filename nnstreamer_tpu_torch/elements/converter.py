"""tensor_converter — media→tensor ingress.

Reference parity: gst/nnstreamer/elements/gsttensor_converter.c: per-media
branches video (:1046), audio (:1110), text (:1114) and octet (:1144),
frames-per-tensor accumulation via GstAdapter (:971), and converter
subplugin dispatch for arbitrary media (:1237-1239).

All of it is host work on numpy arrays, as in the JAX package: a video
frame (H, W, C) becomes a (N, H, W, C) uint8 tensor of N =
frames_per_tensor frames; audio chunks of any length become
(frames_per_tensor, channels) tensors; text and octet frames become the
declared fixed-size tensor. `mode=custom:<name>` dispatches to a
`ConverterSubplugin` registered with `register_converter` (`wire`,
elements/wire_codec.py), `mode=custom-script:<script.py>` to a python3
CustomConverter script (elements/script_codec.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.registry import PluginKind, register_element, registry
from nnstreamer_tpu_torch.graph.media import (
    AudioSpec, MediaSpec, OctetSpec, TextSpec, VideoSpec)
from nnstreamer_tpu_torch.graph.pipeline import Element, Emission, PropDef, StreamSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec


@register_element("tensor_converter")
class TensorConverter(Element):
    ELEMENT_NAME = "tensor_converter"
    PROPS = {
        "frames_per_tensor": PropDef(int, 1, "batch N media frames per tensor"),
        "input_dim": PropDef(str, "", "required for octet/text input"),
        "input_type": PropDef(str, "", "required for octet input"),
        "mode": PropDef(str, "", "custom converter: custom:<name> or "
                                 "custom-script:<script.py>"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._pending: List[TensorBuffer] = []
        self._audio_backlog: Optional[np.ndarray] = None
        self._subplugin = None

    # -- negotiation -------------------------------------------------------
    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = in_specs[0]
        n = self.props["frames_per_tensor"]
        if n < 1:
            self.fail_negotiation(f"frames-per-tensor must be >= 1, got {n}")
        mode = self.props["mode"]
        if mode:
            kind, _, sub = mode.partition(":")
            if kind == "custom-script" and sub:
                # reference python3 converter scripts (CustomConverter)
                from nnstreamer_tpu_torch.elements.script_codec import (
                    make_script_converter)

                self._subplugin = make_script_converter(sub)
                return [self._subplugin.negotiate(spec)]
            if kind != "custom" or not sub:
                self.fail_negotiation(
                    f"mode must be custom:<subplugin name> or "
                    f"custom-script:<script.py>, got {mode!r}")
            self._subplugin = registry.get(PluginKind.CONVERTER, sub)()
            return [self._subplugin.negotiate(spec)]
        if isinstance(spec, VideoSpec):
            h, w, c = spec.frame_shape
            if not (h and w):
                self.fail_negotiation(
                    "video input needs fixed width/height before conversion")
            return [TensorsSpec.of(
                TensorInfo((n, h, w, c), DType.UINT8),
                rate=spec.rate / n if spec.rate and n > 1 else spec.rate)]
        if isinstance(spec, AudioSpec):
            return [TensorsSpec.of(
                TensorInfo((n, spec.channels),
                           DType.from_name(spec.dtype_name)),
                rate=spec.rate)]
        if isinstance(spec, TextSpec):
            if not self.props["input_dim"]:
                self.fail_negotiation(
                    "text input requires input-dim=<N> (fixed byte width per "
                    "frame, reference gsttensor_converter text branch)")
            ti = TensorInfo.from_dim_string(self.props["input_dim"], "uint8")
            return [TensorsSpec.of(ti, rate=spec.rate)]
        if isinstance(spec, OctetSpec):
            if not (self.props["input_dim"] and self.props["input_type"]):
                self.fail_negotiation(
                    "octet input requires input-dim= and input-type= "
                    "(self-describing raw bytes)")
            ti = TensorInfo.from_dim_string(
                self.props["input_dim"], self.props["input_type"])
            return [TensorsSpec.of(ti, rate=spec.rate)]
        if isinstance(spec, TensorsSpec):
            return [spec]  # tensor passthrough (reference allows this)
        self.fail_negotiation(
            f"no conversion for input stream {spec}; use mode=custom:<name> "
            f"with a registered converter subplugin")

    # -- dataflow ----------------------------------------------------------
    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        if self._subplugin is not None:
            return [(0, self._subplugin.convert(buf))]
        spec = self.in_specs[0]
        n = self.props["frames_per_tensor"]
        if isinstance(spec, VideoSpec):
            frame = np.asarray(buf.tensors[0])
            if frame.shape != spec.frame_shape:
                raise PipelineError(
                    f"tensor_converter {self.name}: video frame shape "
                    f"{frame.shape} != negotiated {spec.frame_shape}")
            batched = frame[None, ...]
            if n == 1:
                return [(0, buf.with_tensors((batched,)))]
            # frames-per-tensor accumulation (GstAdapter analog :971)
            self._pending.append(buf.with_tensors((batched,)))
            if len(self._pending) < n:
                return []
            chunk = self._pending[:n]
            self._pending = self._pending[n:]
            stacked = np.concatenate([b.tensors[0] for b in chunk], axis=0)
            return [(0, chunk[0].with_tensors((stacked,)))]
        if isinstance(spec, AudioSpec):
            # sample adapter: arbitrary-length chunks in, fixed
            # (frames_per_tensor, channels) tensors out (GstAdapter analog)
            arr = np.asarray(buf.tensors[0])
            if arr.ndim == 1:
                arr = arr[:, None]
            if arr.shape[1] != spec.channels:
                raise PipelineError(
                    f"tensor_converter {self.name}: audio chunk has "
                    f"{arr.shape[1]} channels, negotiated {spec.channels}")
            arr = arr.astype(DType.from_name(spec.dtype_name).np_dtype,
                             copy=False)
            self._audio_backlog = (
                arr if self._audio_backlog is None
                else np.concatenate([self._audio_backlog, arr], axis=0))
            out: List[Emission] = []
            while self._audio_backlog.shape[0] >= n:
                chunk, self._audio_backlog = (
                    self._audio_backlog[:n], self._audio_backlog[n:])
                out.append((0, buf.with_tensors((chunk,))))
            return out
        if isinstance(spec, TextSpec):
            out_info: TensorInfo = self.out_specs[0].tensors[0]
            raw = buf.meta.get("text", "")
            data = raw.encode("utf-8") if isinstance(raw, str) else bytes(raw)
            fixed = np.zeros(out_info.num_elements, np.uint8)
            clipped = data[: out_info.num_elements]
            fixed[: len(clipped)] = np.frombuffer(clipped, np.uint8)
            return [(0, buf.with_tensors((fixed.reshape(out_info.shape),)))]
        if isinstance(spec, OctetSpec):
            out_info = self.out_specs[0].tensors[0]
            raw = np.asarray(buf.tensors[0], np.uint8).tobytes()
            if len(raw) != out_info.nbytes:
                raise PipelineError(
                    f"tensor_converter {self.name}: octet frame of {len(raw)} "
                    f"bytes != declared input-dim size {out_info.nbytes}")
            arr = np.frombuffer(raw, out_info.dtype.np_dtype).reshape(
                out_info.shape)
            return [(0, buf.with_tensors((arr,)))]
        return [(0, buf)]  # tensor passthrough

    def flush(self) -> List[Emission]:
        # incomplete batch at EOS is dropped (reference adapter behavior)
        self._pending = []
        self._audio_backlog = None
        return []


class ConverterSubplugin:
    """API for custom media→tensor converters (NNStreamerExternalConverter
    analog, include/nnstreamer_plugin_api_converter.h:41)."""

    NAME = ""

    def negotiate(self, in_spec: MediaSpec) -> TensorsSpec:
        raise NotImplementedError

    def convert(self, buf: TensorBuffer) -> TensorBuffer:
        raise NotImplementedError


def register_converter(name: str):
    """Class decorator: `@register_converter("wire")` makes a
    ConverterSubplugin available as `tensor_converter mode=custom:wire`."""
    def deco(cls):
        cls.NAME = name
        registry.register(PluginKind.CONVERTER, name, cls)
        return cls
    return deco

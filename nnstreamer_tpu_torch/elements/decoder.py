"""tensor_decoder — tensor→media egress via decoder subplugins.

Reference parity: gsttensor_decoder.c dispatching to
`GstTensorDecoderDef` subplugins (include/nnstreamer_plugin_api_decoder.h:39).

- ``device=false`` (default): the subplugin's host decode on numpy.
- ``device=true``: its device decode on the tensors where they are; the
  compact result tensor (label index, 16x6 boxes, 17x3 keypoints) is
  emitted instead of media, so raw model outputs never cross to the
  host. Next to a tensor_filter it is folded into the filter by
  graph/optimize.py.
- ``device=compact``: a device reduction (the top-K candidate rows)
  then the host decode with its own semantics; only the candidates
  cross. Never folded away: its host stage still has work.
- ``max_in_flight=N`` (compact and host decode): up to N frames' D2H
  copies in flight at once; a frame's decode is emitted when N are
  queued behind it, the rest at EOS. The copies go into pinned host
  memory behind a CUDA event (`TensorBuffer.prefetch_host`), and the
  wait goes through runtime/sync.to_host.
- Decode-time constants (the SSD anchors) come from the subplugin's
  ``device_aux()`` and are handed to each decode as an argument, moved to
  the tensors' device once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.registry import PluginKind, register_element, registry
from nnstreamer_tpu_torch.graph.pipeline import (
    Element, Emission, PropDef, StreamSpec, prop_bool)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec


class DecoderSubplugin:
    """tensor→media decoder API (GstTensorDecoderDef analog)."""

    MODE = ""

    def init(self, props: dict) -> None:
        """Receive the decoder element's option properties."""

    def negotiate(self, in_spec: TensorsSpec) -> StreamSpec:
        """Validate the tensor input and declare the output media spec."""
        raise NotImplementedError

    def decode(self, buf: TensorBuffer) -> TensorBuffer:
        """Host decode of a buffer whose tensors are numpy."""
        raise NotImplementedError

    # -- device decode (device=true) --------------------------------------
    def device_negotiate(self, in_spec: TensorsSpec) -> TensorsSpec:
        raise PipelineError(
            f"decoder mode={self.MODE} has no device decode path; drop "
            f"device=true to use the host decoder")

    def device_decode(self, tensors, aux=None):
        """Tuple of tensors → tuple of tensors, on their device. `aux` is
        device_aux()'s dict, already on that device."""
        raise NotImplementedError

    def device_aux(self):
        """Optional dict of decode-time constant tensors (SSD anchors)."""
        return None

    # -- device compaction (device=compact) -------------------------------
    def device_compact(self, tensors, aux=None):
        """Raw output tensors → compact tensors that decode() consumes
        (flagged by `consume_compact`)."""
        raise PipelineError(
            f"decoder mode={self.MODE} has no device compaction; use "
            f"device=true (full device decode) or the host decoder")

    def device_compact_check(self) -> None:
        """Raise PipelineError at negotiation when this subplugin (or its
        configured scheme) cannot compact."""
        raise PipelineError(
            f"decoder mode={self.MODE} has no device compaction; use "
            f"device=true (full device decode) or the host decoder")


def _prop_device(v) -> object:
    """false | true | compact."""
    if isinstance(v, str) and v.strip().lower() == "compact":
        return "compact"
    return prop_bool(v)


def aux_on(aux, device: torch.device):
    """device_aux()'s dict with every tensor on `device` (None stays)."""
    if aux is None:
        return None
    return {k: v.to(device) for k, v in aux.items()}


def register_decoder(mode: str):
    def deco(cls):
        cls.MODE = mode
        registry.register(PluginKind.DECODER, mode, cls)
        return cls
    return deco


@register_element("tensor_decoder")
class TensorDecoder(Element):
    ELEMENT_NAME = "tensor_decoder"
    WANTS_HOST = True
    PROPS = {
        "mode": PropDef(str, None, "decoder subplugin name"),
        "device": PropDef(_prop_device, False,
                          "device-side decode (false|true|compact)"),
        "max_in_flight": PropDef(int, 1, "decode D2H pipelining depth"),
        # the reference's positional options; each subplugin documents
        # what it reads
        **{f"option{i}": PropDef(str, "") for i in range(1, 10)},
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        import nnstreamer_tpu_torch.decoders  # noqa: F401 (registers built-ins)

        if not self.props["mode"]:
            raise PipelineError(
                f"tensor_decoder ({self.name}) requires mode=<subplugin>; "
                f"available: {registry.names(PluginKind.DECODER)}")
        self.sub: DecoderSubplugin = registry.get(
            PluginKind.DECODER, self.props["mode"])()
        self.sub.init(dict(self.props))
        self._aux = None
        self._aux_dev: Dict[torch.device, dict] = {}
        self._inflight: List[TensorBuffer] = []
        if self.props["device"]:
            # device decode emits tensors whose work may still be queued
            self.WANTS_HOST = False
            self.DEVICE_RESIDENT = True  # nnlint: disable=NNL001 residency is the device= property's choice, set before the scheduler ever reads it

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        dev = self.props["device"]
        try:
            if dev == "compact":
                self.sub.device_compact_check()   # fail fast pre-stream
                out = self.sub.negotiate(spec)
                self.sub.consume_compact = True
            elif dev:
                out = self.sub.device_negotiate(spec)
            else:
                out = self.sub.negotiate(spec)
            if dev:
                self._aux = self.sub.device_aux()
        except (ValueError, PipelineError) as e:
            self.fail_negotiation(
                f"decoder mode={self.props['mode']} rejected input {spec}: {e}")
        return [out]

    def _device_tensors(self, tensors):
        """(tensors on one device, that device's aux). Host arrays (no
        filter upstream) go to the port's default device first."""
        from nnstreamer_tpu_torch.backends.base import pick_device
        from nnstreamer_tpu_torch.backends.torch_backend import stage

        dev = next((t.device for t in tensors if isinstance(t, torch.Tensor)),
                   None)
        if dev is None:
            dev = pick_device("")
        tensors, _ = stage(tensors, dev)
        if dev not in self._aux_dev:
            self._aux_dev[dev] = aux_on(self._aux, dev)
        return tensors, self._aux_dev[dev]

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        dev = self.props["device"]
        depth = max(1, int(self.props["max_in_flight"]))
        if dev:
            tensors, aux = self._device_tensors(buf.tensors)
            with torch.inference_mode():
                if dev == "compact":
                    out = self.sub.device_compact(tensors, aux)
                else:
                    out = self.sub.device_decode(tensors, aux)
            buf = buf.with_tensors(tuple(out))
            if dev != "compact":
                return [(0, buf)]
        if dev == "compact" or depth > 1:
            return self._window(buf, depth)
        return [(0, self.sub.decode(self._host(buf)))]

    def _host(self, buf: TensorBuffer) -> TensorBuffer:
        """The frame on the host: the decoder is the pipeline's sync
        point, and its forced sync is counted and traced here."""
        return buf.to_host(self._tracer, self.name)

    def _window(self, buf: TensorBuffer, depth: int) -> List[Emission]:
        """Queue the frame's D2H copy; decode and emit frames while
        `depth` are queued (flush() drains the rest at EOS)."""
        self._inflight.append(buf.prefetch_host())
        ems: List[Emission] = []
        while len(self._inflight) >= depth:
            ems.append((0, self.sub.decode(
                self._host(self._inflight.pop(0)))))
        return ems

    def flush(self) -> List[Emission]:
        ems = [(0, self.sub.decode(self._host(b))) for b in self._inflight]
        self._inflight.clear()
        return ems

"""Scripted converter/decoder subplugins — the reference's python3
custom-script contract, the JAX package's elements/script_codec.py on the
port.

Reference parity:
- `tensor_decoder mode=python3 option1=<script.py>` —
  `ext/nnstreamer/tensor_decoder/tensordec-python3.cc`: the script's
  ``CustomDecoder.decode(raw_data, in_info, rate_n, rate_d) -> bytes``
  serializes tensors to a media frame.
- `tensor_converter mode=custom-script:<script.py>` —
  `ext/nnstreamer/tensor_converter/tensor_converter_python3.cc`: the
  script's ``CustomConverter.convert([bytes array]) ->
  (tensors_info, raw_data, rate_n, rate_d)`` parses a media frame into
  tensors (a FLEXIBLE stream — shapes are per-frame).

Both are host work on numpy: the decoder element hands its subplugin a
frame already on the host (one counted sync), and the converter's
tensors are new host arrays.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional

import numpy as np

from nnstreamer_tpu_torch.backends.python3_script import (
    TensorShape, load_script_class)
from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.elements.converter import ConverterSubplugin
from nnstreamer_tpu_torch.elements.decoder import (
    DecoderSubplugin, register_decoder)
from nnstreamer_tpu_torch.graph.media import MediaSpec, OctetSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec


def _rate_pair(rate: Optional[Fraction]):
    if not rate:
        return 0, 1
    return int(rate.numerator), int(rate.denominator)


@register_decoder("python3")
class Python3Decoder(DecoderSubplugin):
    """tensors → media bytes via a CustomDecoder script."""

    def init(self, props: dict) -> None:
        path = props.get("option1", "")
        if not path:
            raise PipelineError(
                "tensor_decoder mode=python3 requires option1=<script "
                "path> (reference tensordec-python3 contract)")
        cls = load_script_class(path, "CustomDecoder")
        try:
            self._decoder = cls()
        except Exception as e:
            raise PipelineError(
                f"python3 decoder script {path!r}: CustomDecoder() "
                f"raised {type(e).__name__}: {e}") from e
        self._path = path
        self._rate = None

    def negotiate(self, in_spec: TensorsSpec) -> MediaSpec:
        self._rate = in_spec.rate
        return OctetSpec(rate=in_spec.rate)

    def decode(self, buf: TensorBuffer) -> TensorBuffer:
        arrays = [np.asarray(t) for t in buf.tensors]
        # reference dims are innermost-first, always rank 4 (1-padded);
        # higher ranks cannot be represented on this wire — fail loud
        # rather than truncate
        for a in arrays:
            if a.ndim > 4:
                raise PipelineError(
                    f"python3 decoder {self._path!r}: rank-{a.ndim} "
                    f"tensor does not fit the reference's 4-dim wire")
        raw = [np.ascontiguousarray(a).view(np.uint8).ravel()
               for a in arrays]
        info = [TensorShape((list(reversed(a.shape)) + [1, 1, 1, 1])[:4],
                            a.dtype) for a in arrays]
        n, d = _rate_pair(self._rate)
        out = self._decoder.decode(raw, info, n, d)
        if not isinstance(out, (bytes, bytearray)):
            raise PipelineError(
                f"python3 decoder {self._path!r}: decode returned "
                f"{type(out).__name__}, expected bytes")
        return buf.with_tensors((np.frombuffer(bytes(out), np.uint8).copy(),))


class Python3Converter(ConverterSubplugin):
    """media bytes → tensors via a CustomConverter script (FLEXIBLE
    stream: every frame is self-describing)."""

    def __init__(self, path: str):
        cls = load_script_class(path, "CustomConverter")
        try:
            self._converter = cls()
        except Exception as e:
            raise PipelineError(
                f"python3 converter script {path!r}: CustomConverter() "
                f"raised {type(e).__name__}: {e}") from e
        self._path = path

    def negotiate(self, in_spec: MediaSpec) -> TensorsSpec:
        return TensorsSpec(tensors=(), format=TensorFormat.FLEXIBLE,
                           rate=in_spec.rate)

    def convert(self, buf: TensorBuffer) -> TensorBuffer:
        flat = np.ascontiguousarray(
            np.asarray(buf.tensors[0])).view(np.uint8).ravel()
        out = self._converter.convert([flat])
        try:
            infos, raws, rate_n, rate_d = out
        except (TypeError, ValueError):
            raise PipelineError(
                f"python3 converter {self._path!r}: convert must return "
                f"(tensors_info, raw_data, rate_n, rate_d), got "
                f"{type(out).__name__}") from None
        if len(infos) != len(raws):
            raise PipelineError(
                f"python3 converter {self._path!r}: {len(infos)} "
                f"tensors_info entries but {len(raws)} raw_data blobs")
        tensors: List[np.ndarray] = []
        for ts, raw in zip(infos, raws):
            if not isinstance(ts, TensorShape):
                raise PipelineError(
                    f"python3 converter {self._path!r}: tensors_info "
                    f"entries must be nnstreamer_python.TensorShape")
            dt = np.dtype(ts.getType())
            # reference dims are innermost-first and zero/one-padded to
            # rank 4; drop the 0 axes
            dims = [int(x) for x in ts.getDims() if int(x) > 0]
            shape = tuple(reversed(dims))
            if not isinstance(raw, (bytes, bytearray)):
                raw = np.ascontiguousarray(np.asarray(raw))
            arr = np.frombuffer(raw, np.uint8).view(dt)
            if arr.size != int(np.prod(shape)):
                raise PipelineError(
                    f"python3 converter {self._path!r}: tensor of "
                    f"{arr.size} {dt} elements does not fit declared "
                    f"dims {dims}")
            tensors.append(arr.reshape(shape).copy())
        meta = {}
        if rate_n and rate_d:
            meta["rate"] = (int(rate_n), int(rate_d))
        return TensorBuffer(tensors=tuple(tensors),
                            format=TensorFormat.FLEXIBLE, meta=meta,
                            pts=buf.pts)


def make_script_converter(path: str) -> ConverterSubplugin:
    """Factory for `tensor_converter mode=custom-script:<path>`."""
    return Python3Converter(path)

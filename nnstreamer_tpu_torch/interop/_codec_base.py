"""Shared decoder/converter subplugin wrapper for the interop codecs.

All three schema'd codecs (protobuf/flatbuf/flexbuf) expose the same
pipeline surface: `tensor_decoder mode=<name>` serializes tensors to
frame bytes, `tensor_converter mode=custom:<name>` parses them back as a
FLEXIBLE stream. One factory instead of three verbatim class pairs.

The decoder element hands `decode` a frame already on the host: a frame
of CUDA tensors crosses in the element's one counted forced sync,
traced under the decoder's name (elements/decoder.py `_host`).
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.interop.gst_meta import check_wire_dtype
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec


def host_arrays(buf: TensorBuffer, tracer=None, name=None):
    """The buffer's tensors as C-contiguous host numpy arrays. A buffer
    of CUDA tensors crosses in one counted forced sync (traced on
    `tracer` under `name`); a host buffer costs nothing."""
    host = buf.to_host(tracer, name)
    return [np.ascontiguousarray(np.asarray(t)) for t in host.tensors]


def register_codec_pair(name: str, encode_fn, decode_fn):
    """Register tensors→bytes decoder + bytes→tensors converter under
    `name`. encode_fn(buf, rate=...) -> bytes; decode_fn(bytes) ->
    TensorBuffer. Returns the two classes.

    The element imports live here, not at module top: a codec module may
    be the first thing imported in a process, and elements/__init__
    imports the codecs, so a top-level import of elements.converter from
    this module would make that cycle unresolvable."""
    from nnstreamer_tpu_torch.elements.converter import (
        ConverterSubplugin, register_converter)
    from nnstreamer_tpu_torch.elements.decoder import (
        DecoderSubplugin, register_decoder)
    from nnstreamer_tpu_torch.graph.media import MediaSpec, OctetSpec

    class Encode(DecoderSubplugin):
        def negotiate(self, in_spec: TensorsSpec) -> OctetSpec:
            for ti in in_spec.tensors:
                check_wire_dtype(ti.dtype)
            self._rate = in_spec.rate
            return OctetSpec(rate=in_spec.rate)

        def decode(self, buf: TensorBuffer) -> TensorBuffer:
            frame = encode_fn(buf, rate=getattr(self, "_rate", None))
            return buf.with_tensors(
                (np.frombuffer(frame, np.uint8).copy(),))

    class Decode(ConverterSubplugin):
        def negotiate(self, in_spec: MediaSpec) -> TensorsSpec:
            # FLEXIBLE: every frame is self-describing; shapes may vary
            return TensorsSpec(tensors=(), format=TensorFormat.FLEXIBLE,
                               rate=in_spec.rate)

        def convert(self, buf: TensorBuffer) -> TensorBuffer:
            data = np.ascontiguousarray(np.asarray(buf.tensors[0])).tobytes()
            out = decode_fn(data)
            if buf.pts is not None:
                out = out.with_tensors(out.tensors, pts=buf.pts)
            return out

    Encode.__name__ = f"{name.capitalize()}Encode"
    Decode.__name__ = f"{name.capitalize()}Decode"
    Encode.__doc__ = f"tensors → {name} frame bytes."
    Decode.__doc__ = f"{name} frame bytes → tensors (FLEXIBLE stream)."
    register_decoder(name)(Encode)
    register_converter(name)(Decode)
    return Encode, Decode

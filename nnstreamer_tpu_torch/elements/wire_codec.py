"""Wire-format converter/decoder subplugins, the JAX package's
elements/wire_codec.py on the port.

Reference parity: the flatbuf/flexbuf/protobuf converter+decoder pairs
(ext/nnstreamer/tensor_converter/*, tensor_decoder/tensordec-{flatbuf,
flexbuf,protobuf}.cc) that serialize tensor streams for IPC, collapsed
into the one self-describing wire codec (edge/wire.py):

- decoder mode ``wire``: tensors → one uint8 wire-frame tensor
  (application/octet-stream payload a transport ships as-is)
- converter ``mode=custom:wire``: wire bytes → the original tensors

Roundtrip: `... ! tensor_decoder mode=wire ! <any byte transport> !
tensor_converter mode=custom:wire ! ...`.
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.edge.wire import decode_buffer, encode_buffer
from nnstreamer_tpu_torch.elements.converter import (
    ConverterSubplugin, register_converter)
from nnstreamer_tpu_torch.elements.decoder import (
    DecoderSubplugin, register_decoder)
from nnstreamer_tpu_torch.graph.media import MediaSpec, OctetSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec


@register_decoder("wire")
class WireEncode(DecoderSubplugin):
    """tensors → wire bytes (the flatbuf/protobuf decoder analog)."""

    def negotiate(self, in_spec: TensorsSpec) -> OctetSpec:
        return OctetSpec(rate=in_spec.rate)

    def decode(self, buf: TensorBuffer) -> TensorBuffer:
        frame = encode_buffer(buf)
        return buf.with_tensors((np.frombuffer(frame, np.uint8).copy(),))


@register_converter("wire")
class WireDecode(ConverterSubplugin):
    """wire bytes → tensors. The stream is FLEXIBLE: every frame is
    self-describing, so shapes may vary per buffer."""

    def negotiate(self, in_spec: MediaSpec) -> TensorsSpec:
        return TensorsSpec(tensors=(), format=TensorFormat.FLEXIBLE,
                           rate=in_spec.rate)

    def convert(self, buf: TensorBuffer) -> TensorBuffer:
        data = np.ascontiguousarray(np.asarray(buf.tensors[0])).tobytes()
        out, _ = decode_buffer(data)
        if buf.pts is not None and out.pts is None:
            out = out.with_tensors(out.tensors, pts=buf.pts)
        return out

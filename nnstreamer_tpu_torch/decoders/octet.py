"""octet_stream decoder — tensors → raw bytes (the JAX package's
decoders/octet.py).

Reference parity: ext/nnstreamer/tensor_decoder/tensordec-octetstream.c
(130 LoC): concatenates each tensor's bytes into application/octet-stream.
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.elements.decoder import DecoderSubplugin, register_decoder
from nnstreamer_tpu_torch.graph.media import OctetSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec


@register_decoder("octet_stream")
class OctetStream(DecoderSubplugin):
    def negotiate(self, in_spec: TensorsSpec) -> OctetSpec:
        return OctetSpec(rate=in_spec.rate)

    def decode(self, buf: TensorBuffer) -> TensorBuffer:
        payload = b"".join(
            np.ascontiguousarray(np.asarray(t)).tobytes() for t in buf.tensors)
        return buf.with_tensors((np.frombuffer(payload, np.uint8).copy(),))

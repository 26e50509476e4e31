"""tensor_sparse_enc / tensor_sparse_dec — COO sparse codec elements.

Reference parity: gsttensor_sparseenc.c / gsttensor_sparsedec.c /
gsttensor_sparseutil.c. The wire codec itself lives in tensor/sparse.py
(values + flat uint32 indices after a self-describing MetaHeader); these
elements switch a stream between STATIC dense payloads and SPARSE
byte payloads (each tensor becomes a uint8 wire-frame array — the shape
a transport element ships as-is). The codec is host work: a CUDA tensor
is read back first (one forced sync, counted under the element).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import Element, Emission, StreamSpec
from nnstreamer_tpu_torch.runtime.sync import to_host
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec
from nnstreamer_tpu_torch.tensor.sparse import sparse_decode, sparse_encode


@register_element("tensor_sparse_enc")
class TensorSparseEnc(Element):
    ELEMENT_NAME = "tensor_sparse_enc"
    PROPS = {}

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        if spec.format != TensorFormat.STATIC:
            self.fail_negotiation(
                f"sparse encoder takes a STATIC dense stream, got "
                f"{spec.format.name}"
            )
        return [TensorsSpec(tensors=spec.tensors,
                            format=TensorFormat.SPARSE, rate=spec.rate)]

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        frames = tuple(
            np.frombuffer(sparse_encode(np.asarray(t)), np.uint8)
            for t in to_host(buf.tensors, self._tracer, self.name))
        return [(0, buf.with_tensors(frames, format=TensorFormat.SPARSE))]


@register_element("tensor_sparse_dec")
class TensorSparseDec(Element):
    ELEMENT_NAME = "tensor_sparse_dec"
    PROPS = {}

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        if spec.format != TensorFormat.SPARSE:
            self.fail_negotiation(
                f"sparse decoder takes a SPARSE stream (from "
                f"tensor_sparse_enc or a transport), got {spec.format.name}"
            )
        return [TensorsSpec(tensors=spec.tensors,
                            format=TensorFormat.STATIC, rate=spec.rate)]

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        dense = tuple(sparse_decode(np.asarray(t).tobytes())
                      for t in to_host(buf.tensors, self._tracer, self.name))
        return [(0, buf.with_tensors(dense, format=TensorFormat.STATIC))]

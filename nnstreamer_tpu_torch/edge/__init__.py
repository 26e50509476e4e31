"""Among-device transport (counterpart of the JAX package's edge/).

- wire.py     — TensorBuffer ↔ wire frame codec (MetaHeader per tensor),
  the same bytes as the JAX package's for the same buffer.
- protocol.py — length-prefixed TCP messages (HELLO/DATA/RESULT/BUSY).
- query.py    — tensor_query_client / serversrc / serversink and the
  batching `BatchedQueryServer`.
- broker.py   — `EdgeBroker`: discovery (connect_type=hybrid), topic
  pub/sub, the clock exchange.

The JAX package's MQTT wire codec and the pub/sub elements (edgesrc,
edgesink, mqtt*) are not ported yet.
"""

from nnstreamer_tpu_torch.edge.broker import BrokerClient, EdgeBroker
from nnstreamer_tpu_torch.edge.query import (
    BatchedQueryServer, QueryServer, TensorQueryClient,
    TensorQueryServerSink, TensorQueryServerSrc)
from nnstreamer_tpu_torch.edge.wire import decode_buffer, encode_buffer

__all__ = [
    "BatchedQueryServer",
    "BrokerClient",
    "EdgeBroker",
    "QueryServer",
    "TensorQueryClient",
    "TensorQueryServerSink",
    "TensorQueryServerSrc",
    "decode_buffer",
    "encode_buffer",
]

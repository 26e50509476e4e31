"""Among-device transport (counterpart of the JAX package's edge/).

- wire.py     — TensorBuffer ↔ wire frame codec (MetaHeader per tensor),
  the same bytes as the JAX package's for the same buffer.
- protocol.py — length-prefixed TCP messages (HELLO/DATA/RESULT/BUSY).
- query.py    — tensor_query_client / serversrc / serversink and the
  batching `BatchedQueryServer`.
- pubsub.py   — edgesink (publisher) / edgesrc (subscriber) elements.
- broker.py   — `EdgeBroker`: discovery (connect_type=hybrid), topic
  pub/sub, the clock exchange, and an MQTT 3.1.1 listener bridged into
  the same topics; mqttsink/mqttsrc (elements/mqtt.py) ride it.
- mqtt_wire.py — the MQTT 3.1.1 codec and `MqttClient` (no external
  MQTT library).
"""

from nnstreamer_tpu_torch.edge.broker import BrokerClient, EdgeBroker
from nnstreamer_tpu_torch.edge.pubsub import EdgeSink, EdgeSrc
from nnstreamer_tpu_torch.edge.query import (
    BatchedQueryServer, QueryServer, TensorQueryClient,
    TensorQueryServerSink, TensorQueryServerSrc)
from nnstreamer_tpu_torch.edge.wire import decode_buffer, encode_buffer

__all__ = [
    "BatchedQueryServer",
    "BrokerClient",
    "EdgeBroker",
    "EdgeSink",
    "EdgeSrc",
    "QueryServer",
    "TensorQueryClient",
    "TensorQueryServerSink",
    "TensorQueryServerSrc",
    "decode_buffer",
    "encode_buffer",
]

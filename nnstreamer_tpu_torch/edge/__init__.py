"""Among-device transport.

- wire.py — TensorBuffer ↔ wire frame codec (MetaHeader per tensor), the
  same bytes as the JAX package's for the same buffer.

The JAX package's edge elements (query, pub/sub, broker, TCP protocol)
are not ported yet, so this package imports only the codec.
"""

from nnstreamer_tpu_torch.edge.wire import decode_buffer, encode_buffer

__all__ = ["decode_buffer", "encode_buffer"]

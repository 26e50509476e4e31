"""TensorBuffer ↔ wire-frame codec, the JAX package's edge/wire.py on the
port: the same bytes for the same buffer, so a frame crosses to a JAX
peer and back.

Frame layout (little-endian):

  u32 magic 'TPUF'   u32 num_tensors   s64 pts (ns, -1 = none)
  u64 client_id      u32 meta_len      meta_len bytes of JSON meta
  per tensor: MetaHeader (tensor/meta.py) + raw payload bytes

The per-tensor MetaHeader is the same self-describing header flexible
streams use in-process (GstTensorMetaInfo analog), so any stream —
static, flexible, or sparse-encoded — serializes without negotiation
context; the receiver reconstructs shapes/dtypes from the wire alone
(the property the reference's query/edge elements get from caps strings
in their connect handshake plus per-memory headers).
"""

from __future__ import annotations

import json
import math
import struct
from typing import Optional, Tuple

import numpy as np

from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import MAX_TENSORS_PER_FRAME, TensorFormat
from nnstreamer_tpu_torch.tensor.meta import MetaHeader

FRAME_MAGIC = 0x54505546  # 'TPUF'
_HEAD = struct.Struct("<IIqQI")  # magic, num, pts, client_id, meta_len

#: refuse to allocate absurd frames from hostile/corrupt headers
MAX_FRAME_BYTES = 1 << 31

# -- same-host shared-memory lane record framing --------------------------
# The shm ring (serving/shm.py) moves the exact same wire-frame bytes the
# pipe would have pickled, so the cross-host protocol above is untouched;
# only the *carrier* changes. Each ring record is SHM_REC header + payload.
SHM_REC_MAGIC = 0x54505553  # 'TPUS'
SHM_REC = struct.Struct("<IIQ")  # magic, payload_len, seq


def pack_shm_record(payload: bytes, seq: int) -> bytes:
    """Header for one shm ring record carrying ``payload``."""
    return SHM_REC.pack(SHM_REC_MAGIC, len(payload), seq)


def unpack_shm_record(head: bytes) -> Tuple[int, int]:
    """``(payload_len, seq)`` from a record header; raises ValueError
    on a bad magic (a torn or stale record — the reader treats that as
    a transport fault and falls back to the pipe lane)."""
    magic, length, seq = SHM_REC.unpack(head)
    if magic != SHM_REC_MAGIC:
        raise ValueError(
            f"bad shm record magic 0x{magic:08x} (want "
            f"0x{SHM_REC_MAGIC:08x})")
    return length, seq


#: recursion guard for nested meta (a trace context is depth 3:
#: ctx → hops list → hop dict; 8 leaves headroom without letting a
#: pathological self-referential meta spin the encoder)
_MAX_META_DEPTH = 8


def _jsonable(v, depth: int):
    """JSON-safe view of one meta value, recursing through dicts/lists
    (the trace context rides meta as nested dicts — dropping composites
    would silently sever every cross-process timeline). Returns the
    sentinel `_DROP` for unserializable values."""
    import base64

    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, np.ndarray):
        return {"__nd__": True, "dtype": str(v.dtype),
                "shape": list(v.shape),
                "b64": base64.b64encode(
                    np.ascontiguousarray(v).tobytes()).decode()}
    if depth >= _MAX_META_DEPTH:
        return _DROP
    if isinstance(v, dict):
        out = {}
        for k, item in v.items():
            if not isinstance(k, str):
                return _DROP
            j = _jsonable(item, depth + 1)
            if j is not _DROP:
                out[k] = j
        return out
    if isinstance(v, (list, tuple)):
        items = []
        for item in v:
            j = _jsonable(item, depth + 1)
            if j is not _DROP:
                items.append(j)
        return items
    return _DROP


_DROP = object()


def _meta_to_json(meta: dict) -> dict:
    """JSON-able meta. Arrays (decoder outputs: boxes/keypoints/class_map)
    ride as base64'd payloads, and nested dicts/lists (trace context)
    pass through recursively, so the documented meta contract survives
    the wire; unserializable values are dropped with a log line."""
    out = {}
    for k, v in meta.items():
        j = _jsonable(v, 0)
        if j is not _DROP:
            out[k] = j
        else:
            from nnstreamer_tpu_torch.core.log import get_logger

            get_logger("edge.wire").debug(
                "meta key %r (%s) is not wire-serializable; dropped",
                k, type(v).__name__)
    return out


def _meta_from_json(meta: dict) -> dict:
    import base64

    out = {}
    for k, v in meta.items():
        if isinstance(v, dict) and v.get("__nd__"):
            out[k] = np.frombuffer(
                base64.b64decode(v["b64"]),
                np.dtype(v["dtype"])).reshape(v["shape"]).copy()
        else:
            out[k] = v
    return out


def encode_buffer(buf: TensorBuffer, client_id: int = 0,
                  tracer=None, name=None) -> bytes:
    """Serialize a TensorBuffer. A buffer of CUDA tensors comes to the
    host here in one counted forced sync (TensorBuffer.to_host, traced on
    `tracer` under element `name` when given) — the transport boundary is
    by definition a D2H point."""
    host = buf.to_host(tracer, name)
    metable = _meta_to_json(host.meta)
    meta_bytes = json.dumps(metable).encode() if metable else b""
    parts = [
        _HEAD.pack(FRAME_MAGIC, host.num_tensors,
                   -1 if host.pts is None else host.pts,
                   client_id, len(meta_bytes)),
        meta_bytes,
    ]
    for t in host.tensors:
        a = np.ascontiguousarray(t)
        hdr = MetaHeader(shape=tuple(a.shape) or (1,),
                         dtype=DType.from_np(a.dtype),
                         format=host.format)
        parts.append(hdr.pack())
        parts.append(a.tobytes())
    return b"".join(parts)


def peek_pts(data: bytes) -> Optional[int]:
    """pts of an encoded frame without decoding tensors/meta — the mesh
    host agent needs only the correlation id to synthesize a BUSY when
    a local forward fails. None for frames too short or with pts=-1."""
    if len(data) < _HEAD.size:
        return None
    magic, _num, pts, _cid, _mlen = _HEAD.unpack_from(data, 0)
    if magic != FRAME_MAGIC or pts < 0:
        return None
    return pts


def decode_buffer(data: bytes) -> Tuple[TensorBuffer, int]:
    """→ (buffer, client_id). Raises ValueError on corrupt frames."""
    if len(data) < _HEAD.size:
        raise ValueError(f"wire frame too small: {len(data)} bytes")
    magic, num, pts, client_id, meta_len = _HEAD.unpack_from(data, 0)
    if magic != FRAME_MAGIC:
        raise ValueError(
            f"bad wire frame magic 0x{magic:08x}; peer speaks a different "
            f"protocol (expected 0x{FRAME_MAGIC:08x})")
    if num > MAX_TENSORS_PER_FRAME:
        raise ValueError(f"corrupt frame: {num} tensors > limit")
    off = _HEAD.size
    meta = {}
    if meta_len:
        if meta_len > len(data) - off:
            raise ValueError("corrupt frame: meta overruns payload")
        meta = _meta_from_json(json.loads(data[off:off + meta_len]))
        off += meta_len
    tensors = []
    fmt = TensorFormat.STATIC
    for _ in range(num):
        hdr, used = MetaHeader.unpack(data[off:])
        off += used
        # math.prod on python ints: arbitrary precision, no silent int64
        # wraparound from a crafted header's u32 dims
        n_elems = math.prod(int(d) for d in hdr.shape)
        if n_elems > MAX_FRAME_BYTES:
            raise ValueError(
                f"corrupt frame: header claims {n_elems} elements")
        n_bytes = n_elems * hdr.dtype.itemsize
        if n_bytes > MAX_FRAME_BYTES or n_bytes > len(data) - off:
            raise ValueError(
                f"corrupt frame: tensor payload {n_bytes}B overruns frame")
        a = np.frombuffer(data[off:off + n_bytes],
                          hdr.dtype.np_dtype).reshape(hdr.shape).copy()
        off += n_bytes
        tensors.append(a)
        fmt = hdr.format
    return (TensorBuffer(tensors=tuple(tensors),
                         pts=None if pts < 0 else pts,
                         format=fmt, meta=meta),
            client_id)

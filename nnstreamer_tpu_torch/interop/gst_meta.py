"""GstTensorMetaInfo v1 header codec — the reference's self-describing
per-tensor wire header, for interop payloads (a copy of the JAX
package's interop/gst_meta.py).

Reference: tensor_typedef.h:268-296 (struct), nnstreamer_plugin_api_util_impl.c
:1130-1145 (version macros, v1 header size 128), :1288-1330 (update/parse).
Layout, little-endian u32, zero-padded to 128 bytes:

  [0]      version   0xDE000000 | major<<12 | minor   (v1 = 0xDE001000)
  [1]      type      tensor dtype enum (== our DType values 0..9)
  [2..17]  dimension innermost-first, zero-terminated (rank = #nonzero prefix)
  [18]     format    static=0 / flexible=1 / sparse=2
  [19]     media     media type enum (tensor=0)
  [20]     nnz       sparse non-zero count (union GstSparseTensorInfo)

This is distinct from tensor/meta.py (our own richer TPUT header used on
in-framework flexible streams): interop codecs speak the reference layout
so an unmodified nnstreamer can parse flexible frames we produce.
"""

from __future__ import annotations

import struct
from typing import Tuple

from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorFormat

HEADER_SIZE = 128
META_RANK_LIMIT = 16
VERSION_V1 = 0xDE000000 | (1 << 12)
_MASK_VALID = 0xDE000000

#: dtypes expressible in the interop enums (values 0..9 match our DType).
WIRE_DTYPES = frozenset(range(10))
PAD_RANK = 4  # NNS_TENSOR_RANK_LIMIT in the reference wire convention


def check_wire_dtype(dt: DType) -> None:
    if int(dt) not in WIRE_DTYPES:
        raise StreamError(
            f"dtype {dt.type_name} has no interop encoding (the reference "
            f"enum stops at uint64); insert "
            f"`tensor_transform mode=typecast option=float32` upstream"
        )


def wire_dims(shape) -> list:
    """numpy shape → innermost-first dims padded with 1 to rank 4
    (gst_tensor_parse_dimension pads with 1,
    nnstreamer_plugin_api_util_impl.c:911-912)."""
    dims = [int(d) for d in reversed(tuple(shape))]
    while len(dims) < PAD_RANK:
        dims.append(1)
    return dims


def shape_from_wire(dims) -> tuple:
    """Inverse of wire_dims: strip the trailing pad-1s, reverse. Rank is
    not on the wire, so trailing 1-dims are canonicalized away; exact
    shapes travel in the GstTensorMetaInfo header on FLEXIBLE streams."""
    ds = [int(d) for d in dims]
    while len(ds) > 1 and ds[-1] == 1:
        ds.pop()
    return tuple(reversed(ds))


def payload_to_array(raw: bytes, dims, dtype: DType, fmt: TensorFormat,
                     label: str):
    """Decode one interop tensor payload → numpy array. Shared by all
    three codecs; every corruption mode (bad header, size mismatch,
    truncated buffer) surfaces as StreamError — the codec contract."""
    import math

    import numpy as np

    try:
        if fmt != TensorFormat.STATIC and len(raw) >= HEADER_SIZE:
            shape, hdt, _, _, _, off = parse_gst_meta(raw)
            return np.frombuffer(raw, hdt.np_dtype, offset=off,
                                 count=math.prod(shape)
                                 ).reshape(shape).copy()
        shape = shape_from_wire(dims)
        n = math.prod(shape) if shape else 1
        if n * dtype.itemsize != len(raw):
            raise StreamError(
                f"{label}: {len(raw)} payload bytes != {n} elements of "
                f"{dtype.type_name} from dims {list(dims)}")
        return np.frombuffer(raw, dtype.np_dtype).reshape(shape).copy()
    except StreamError:
        raise
    except (ValueError, TypeError) as e:   # truncated/corrupt buffers
        raise StreamError(f"{label}: corrupt tensor payload: {e}") from None


def pack_gst_meta(shape: Tuple[int, ...], dtype: DType,
                  fmt: TensorFormat = TensorFormat.FLEXIBLE,
                  media: int = 0, nnz: int = 0) -> bytes:
    """numpy-order shape → 128-byte GstTensorMetaInfo v1 header."""
    dims = [int(d) for d in reversed(shape)] or [1]
    if len(dims) > META_RANK_LIMIT:
        raise StreamError(
            f"rank {len(dims)} exceeds the interop header limit "
            f"{META_RANK_LIMIT} (NNS_TENSOR_META_RANK_LIMIT)"
        )
    if any(d <= 0 for d in dims):
        # zero terminates the dim list in this layout, so zero-sized
        # tensors cannot travel in reference-flexible frames
        raise StreamError(
            f"zero/negative dim in shape {shape} not representable in a "
            f"GstTensorMetaInfo header (dims are zero-terminated)"
        )
    dims += [0] * (META_RANK_LIMIT - len(dims))
    head = struct.pack("<21I", VERSION_V1, int(dtype), *dims,
                       int(fmt), int(media), int(nnz))
    return head + b"\x00" * (HEADER_SIZE - len(head))


def parse_gst_meta(data: bytes):
    """Parse header from the front of data →
    (shape numpy-order, DType, TensorFormat, media, nnz, header_size)."""
    if len(data) < HEADER_SIZE:
        raise StreamError(
            f"buffer too small for GstTensorMetaInfo header: {len(data)} "
            f"< {HEADER_SIZE}"
        )
    vals = struct.unpack_from("<21I", data, 0)
    version = vals[0]
    # mask the FULL tag byte: (v & 0xDE000000) == 0xDE000000 would also
    # accept 0xFF/0xFE/0xDF tags (bit-superset false positives)
    if (version & 0xFF000000) != _MASK_VALID:
        raise StreamError(
            f"bad GstTensorMetaInfo version 0x{version:08x}; not a "
            f"reference-flexible tensor payload"
        )
    dtype = DType(vals[1])
    dims = []
    for d in vals[2:2 + META_RANK_LIMIT]:
        if d == 0:
            break
        dims.append(int(d))
    if not dims:
        raise StreamError("corrupt GstTensorMetaInfo: empty dimension list")
    fmt = TensorFormat(vals[18])
    return tuple(reversed(dims)), dtype, fmt, vals[19], vals[20], HEADER_SIZE

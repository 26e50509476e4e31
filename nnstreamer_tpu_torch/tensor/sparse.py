"""Sparse tensor wire codec (COO over flat indices).

Reference parity: gst/nnstreamer/elements/gsttensor_sparseutil.c —
`gst_tensor_sparse_from_dense` (:116) / `gst_tensor_sparse_to_dense` (:27).
Wire frame = MetaHeader(format=SPARSE, extra=nnz) + values[nnz] (element
dtype) + indices[nnz] (uint32 flat row-major offsets).

The codec is host numpy, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import MediaType, TensorFormat
from nnstreamer_tpu_torch.tensor.meta import MetaHeader

#: Refuse to materialize dense outputs larger than this from wire data; a
#: corrupt/malicious header must not be able to OOM the pipeline process.
MAX_DENSE_BYTES = 1 << 31  # 2 GiB


def sparse_encode(dense: np.ndarray) -> bytes:
    """Dense array → sparse wire frame. Worth it when density < ~50%."""
    flat = np.ascontiguousarray(dense).reshape(-1)
    idx = np.flatnonzero(flat).astype(np.uint32)
    values = flat[idx]
    hdr = MetaHeader(
        shape=tuple(dense.shape) or (1,),
        dtype=_dtype_of(dense),
        format=TensorFormat.SPARSE,
        media=MediaType.TENSOR,
        extra=int(idx.size),
    )
    return hdr.pack() + values.tobytes() + idx.tobytes()


def sparse_decode(frame: bytes) -> np.ndarray:
    """Sparse wire frame → dense array."""
    hdr, off = MetaHeader.unpack(frame)
    if hdr.format != TensorFormat.SPARSE:
        raise ValueError(f"not a sparse tensor frame (format={hdr.format.name})")
    nnz = hdr.extra
    np_dt = hdr.dtype.np_dtype
    total = math.prod(hdr.shape)
    if total * np_dt.itemsize > MAX_DENSE_BYTES:
        raise ValueError(
            f"sparse frame dense size {total * np_dt.itemsize} bytes (shape "
            f"{hdr.shape}) exceeds decode limit {MAX_DENSE_BYTES}; refusing "
            f"allocation for a likely-corrupt header"
        )
    if nnz > total:
        raise ValueError(
            f"corrupt sparse frame: nnz {nnz} exceeds element count {total} "
            f"for shape {hdr.shape}"
        )
    vbytes = nnz * np_dt.itemsize
    need = off + vbytes + nnz * 4
    if len(frame) < need:
        raise ValueError(f"truncated sparse frame: have {len(frame)}, need {need}")
    values = np.frombuffer(frame, dtype=np_dt, count=nnz, offset=off)
    idx = np.frombuffer(frame, dtype=np.uint32, count=nnz, offset=off + vbytes)
    if nnz and int(idx.max()) >= total:
        raise ValueError(
            f"corrupt sparse frame: index {int(idx.max())} out of range for "
            f"{total} elements (shape {hdr.shape})"
        )
    dense = np.zeros(total, dtype=np_dt)
    dense[idx] = values
    return dense.reshape(hdr.shape)


def sparse_nbytes(dense: np.ndarray) -> Tuple[int, int]:
    """→ (sparse wire size, dense size) for the enc/dec worth-it check."""
    nnz = int(np.count_nonzero(dense))
    hdr = MetaHeader(
        shape=tuple(dense.shape) or (1,),
        dtype=_dtype_of(dense),
        format=TensorFormat.SPARSE,
        extra=nnz,
    )
    return hdr.header_size + nnz * (dense.dtype.itemsize + 4), dense.nbytes


def _dtype_of(arr: np.ndarray):
    return DType.from_np(arr.dtype)

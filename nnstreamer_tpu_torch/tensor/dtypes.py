"""Tensor element dtypes.

Reference parity: the 11 dtypes of `_nns_tensor_type`
(gst/nnstreamer/include/tensor_typedef.h:131-146). The wire enum order is
kept (so serialized streams stay stable), with ``bfloat16`` — the card's
preferred compute dtype, absent from the reference — at the tail.

Each DType maps to a numpy dtype (host arrays) and a torch dtype (device
tensors). torch's uint16/uint32/uint64 support copies and casts but few
arithmetic ops: code that computes on them widens first (the normalize
kernel's plain version widens narrow ints to int32).
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class DType(enum.IntEnum):
    """Element type of a tensor. Values are the wire/enum encoding."""

    INT32 = 0
    UINT32 = 1
    INT16 = 2
    UINT16 = 3
    INT8 = 4
    UINT8 = 5
    FLOAT64 = 6
    FLOAT32 = 7
    INT64 = 8
    UINT64 = 9
    FLOAT16 = 10
    BFLOAT16 = 11

    @property
    def np_dtype(self) -> np.dtype:
        try:
            return _NP_DTYPES[self]
        except KeyError:
            raise TypeError(
                f"dtype {self.type_name} has no host numpy representation on "
                f"this system (bfloat16 requires the ml_dtypes package)"
            ) from None

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self]

    @property
    def itemsize(self) -> int:
        return _TORCH_DTYPES[self].itemsize

    @property
    def type_name(self) -> str:
        return _NAMES[self]

    @property
    def is_float(self) -> bool:
        return _TORCH_DTYPES[self].is_floating_point

    @classmethod
    def from_name(cls, name: str) -> "DType":
        try:
            return _BY_NAME[name.strip().lower()]
        except KeyError:
            raise ValueError(
                f"unknown tensor dtype {name!r}; valid names: {sorted(_BY_NAME)}"
            ) from None

    @classmethod
    def from_np(cls, dtype) -> "DType":
        key = "bfloat16" if str(dtype) == "bfloat16" else str(np.dtype(dtype))
        try:
            return _BY_NAME[key]
        except KeyError:
            raise ValueError(f"no tensor DType for numpy dtype {dtype!r}") from None

    @classmethod
    def from_torch(cls, dtype: torch.dtype) -> "DType":
        try:
            return _BY_TORCH[dtype]
        except KeyError:
            raise ValueError(f"no tensor DType for torch dtype {dtype}") from None

    @classmethod
    def of(cls, array) -> "DType":
        """DType of a numpy array, a torch tensor, or anything holding a
        torch dtype (a D2H copy in flight)."""
        if isinstance(array.dtype, torch.dtype):
            return cls.from_torch(array.dtype)
        return cls.from_np(array.dtype)


_NP_DTYPES = {
    DType.INT32: np.dtype(np.int32),
    DType.UINT32: np.dtype(np.uint32),
    DType.INT16: np.dtype(np.int16),
    DType.UINT16: np.dtype(np.uint16),
    DType.INT8: np.dtype(np.int8),
    DType.UINT8: np.dtype(np.uint8),
    DType.FLOAT64: np.dtype(np.float64),
    DType.FLOAT32: np.dtype(np.float32),
    DType.INT64: np.dtype(np.int64),
    DType.UINT64: np.dtype(np.uint64),
    DType.FLOAT16: np.dtype(np.float16),
}
try:  # bfloat16 host arrays need ml_dtypes; device tensors do not.
    import ml_dtypes

    _NP_DTYPES[DType.BFLOAT16] = np.dtype(ml_dtypes.bfloat16)
except ImportError:
    pass

_TORCH_DTYPES = {
    DType.INT32: torch.int32,
    DType.UINT32: torch.uint32,
    DType.INT16: torch.int16,
    DType.UINT16: torch.uint16,
    DType.INT8: torch.int8,
    DType.UINT8: torch.uint8,
    DType.FLOAT64: torch.float64,
    DType.FLOAT32: torch.float32,
    DType.INT64: torch.int64,
    DType.UINT64: torch.uint64,
    DType.FLOAT16: torch.float16,
    DType.BFLOAT16: torch.bfloat16,
}

_NAMES = {
    DType.INT32: "int32",
    DType.UINT32: "uint32",
    DType.INT16: "int16",
    DType.UINT16: "uint16",
    DType.INT8: "int8",
    DType.UINT8: "uint8",
    DType.FLOAT64: "float64",
    DType.FLOAT32: "float32",
    DType.INT64: "int64",
    DType.UINT64: "uint64",
    DType.FLOAT16: "float16",
    DType.BFLOAT16: "bfloat16",
}

_BY_NAME = {name: dt for dt, name in _NAMES.items()}
_BY_TORCH = {tdt: dt for dt, tdt in _TORCH_DTYPES.items()}


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """Host array → CPU tensor sharing its memory where it can.
    ``torch.from_numpy`` refuses ml_dtypes' bfloat16, so a bfloat16
    array crosses as its int16 bits, viewed back as torch.bfloat16."""
    a = np.ascontiguousarray(a)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)

"""Tensor stream type descriptors — the negotiation currency of the graph.

Reference parity: `GstTensorInfo` / `GstTensorsInfo` / `GstTensorsConfig`
(gst/nnstreamer/include/tensor_typedef.h:229-258), the dim-string helpers
(nnstreamer_plugin_api_util_impl.c) and the static/flexible/sparse
formats (tensor_typedef.h:185-193).

Shapes are stored row-major with arbitrary rank. Reference dim strings
("3:224:224:1", innermost-first) are accepted by `from_dim_string`. A
`TensorsSpec` is immutable and hashable.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, replace
from fractions import Fraction
from typing import Sequence, Tuple

from nnstreamer_tpu_torch.tensor.dtypes import DType

#: tensors per frame, as in the reference (tensor_typedef.h:35)
MAX_TENSORS_PER_FRAME = 16
#: rank limit of dim strings (tensor_typedef.h:34)
MAX_RANK = 16


class TensorFormat(enum.IntEnum):
    """Stream data format (tensor_typedef.h:185-193)."""

    STATIC = 0
    FLEXIBLE = 1
    SPARSE = 2


class MediaType(enum.IntEnum):
    """Origin media domain of a tensor stream (for converters/decoders)."""

    TENSOR = 0
    VIDEO = 1
    AUDIO = 2
    TEXT = 3
    OCTET = 4
    ANY = 5


def parse_dim_string(s: str) -> Tuple[int, ...]:
    """"3:224:224:1" (innermost first) → (1, 224, 224, 3) (row-major)."""
    if not s.strip():
        raise ValueError(f"empty tensor dimension string: {s!r}")
    parts = s.strip().split(":")
    if any(p == "" for p in parts):
        raise ValueError(
            f"malformed dimension string {s!r}: empty segment (did you mean "
            f"'3:224:224:1'?)")
    if len(parts) > MAX_RANK:
        raise ValueError(
            f"dimension string {s!r} has rank {len(parts)} > limit {MAX_RANK}")
    dims = []
    for p in parts:
        try:
            v = int(p)
        except ValueError:
            raise ValueError(
                f"invalid dimension {p!r} in {s!r}: dimensions must be "
                f"positive integers separated by ':' (e.g. '3:224:224:1')"
            ) from None
        if v <= 0:
            raise ValueError(
                f"invalid dimension {v} in {s!r}: dimensions must be >= 1")
        dims.append(v)
    return tuple(reversed(dims))


def to_dim_string(shape: Sequence[int]) -> str:
    """Row-major shape → reference-style innermost-first dim string."""
    return ":".join(str(d) for d in reversed(tuple(shape)))


def shapes_compatible(a: Sequence[int], b: Sequence[int]) -> bool:
    """Shape equality ignoring leading (outermost) size-1 dims."""
    def strip(s):
        s = tuple(s)
        while len(s) > 1 and s[0] == 1:
            s = s[1:]
        return s
    return strip(a) == strip(b)


@dataclass(frozen=True)
class TensorInfo:
    """Shape/dtype/name of one tensor in a stream (GstTensorInfo analog)."""

    shape: Tuple[int, ...]
    dtype: DType = DType.FLOAT32
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        if not isinstance(self.dtype, DType):
            object.__setattr__(self, "dtype", DType.from_name(str(self.dtype)))
        for d in self.shape:
            if d <= 0:
                raise ValueError(f"non-positive dim in shape {self.shape}")

    @classmethod
    def from_dim_string(cls, dims: str, dtype="float32",
                        name: str = "") -> "TensorInfo":
        dt = dtype if isinstance(dtype, DType) else DType.from_name(str(dtype))
        return cls(shape=parse_dim_string(dims), dtype=dt, name=name)

    @property
    def num_elements(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def nbytes(self) -> int:
        """Byte size of one frame (gst_tensor_info_get_size analog)."""
        return self.num_elements * self.dtype.itemsize

    def to_dim_string(self) -> str:
        return to_dim_string(self.shape)

    def is_compatible(self, other: "TensorInfo") -> bool:
        return (self.dtype == other.dtype
                and shapes_compatible(self.shape, other.shape))

    def __str__(self) -> str:
        n = f" name={self.name!r}" if self.name else ""
        return (f"Tensor({self.dtype.type_name}"
                f"[{','.join(map(str, self.shape))}]{n})")


@dataclass(frozen=True)
class TensorsSpec:
    """Type of a whole tensor stream (GstTensorsConfig analog)."""

    tensors: Tuple[TensorInfo, ...]
    format: TensorFormat = TensorFormat.STATIC
    rate: Fraction = Fraction(0, 1)  # frames/sec; 0/1 = unknown
    #: >0: buffers carry micro-batches (tensor_batch upstream) of up to
    #: this many frames on a leading batch axis. `tensors` keeps the
    #: PER-FRAME shapes: occupancy varies buffer to buffer, so it is not
    #: part of the static type. Elements that are not batch-aware refuse
    #: such streams at negotiation (Element.expect_tensors)
    dyn_batch: int = 0

    def __post_init__(self):
        object.__setattr__(self, "tensors", tuple(self.tensors))
        if len(self.tensors) > MAX_TENSORS_PER_FRAME:
            raise ValueError(
                f"{len(self.tensors)} tensors per frame exceeds limit "
                f"{MAX_TENSORS_PER_FRAME}")
        if not isinstance(self.rate, Fraction):
            object.__setattr__(self, "rate", Fraction(self.rate))

    @classmethod
    def of(cls, *infos: TensorInfo, **kw) -> "TensorsSpec":
        return cls(tensors=tuple(infos), **kw)

    @classmethod
    def from_strings(cls, dims: str, types: str = "float32", names: str = "",
                     rate=Fraction(0, 1),
                     format=TensorFormat.STATIC) -> "TensorsSpec":
        """e.g. dims="3:224:224:1,1001:1", types="uint8,float32"
        (tensor_filter input/inputtype/inputname properties)."""
        dim_list = [d for d in dims.split(",") if d.strip()]
        type_list = [t for t in types.split(",") if t.strip()]
        name_list = names.split(",") if names else []
        if len(type_list) == 1 and len(dim_list) > 1:
            type_list = type_list * len(dim_list)
        if len(type_list) != len(dim_list):
            raise ValueError(
                f"dimension list has {len(dim_list)} entries but type list "
                f"has {len(type_list)}: {dims!r} vs {types!r}")
        infos = []
        for i, d in enumerate(dim_list):
            nm = name_list[i].strip() if i < len(name_list) else ""
            infos.append(TensorInfo.from_dim_string(
                d.strip(), type_list[i].strip(), nm))
        return cls(tensors=tuple(infos), rate=rate, format=format)

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def is_compatible(self, other: "TensorsSpec") -> bool:
        """Flexible streams match anything tensor-typed; static streams
        need per-tensor dtype+shape compatibility."""
        if TensorFormat.FLEXIBLE in (self.format, other.format):
            return True
        if self.dyn_batch != other.dyn_batch:
            # batched buffers carry an extra, variable batch axis
            return False
        if self.format != other.format or self.num_tensors != other.num_tensors:
            return False
        return all(a.is_compatible(b)
                   for a, b in zip(self.tensors, other.tensors))

    def to_strings(self):
        """→ (dims, types, names) reference-style property strings (the
        query handshake's caps)."""
        return (
            ",".join(t.to_dim_string() for t in self.tensors),
            ",".join(t.dtype.type_name for t in self.tensors),
            ",".join(t.name for t in self.tensors),
        )

    def with_rate(self, rate) -> "TensorsSpec":
        return replace(self, rate=Fraction(rate))

    def __str__(self) -> str:
        body = ", ".join(str(t) for t in self.tensors)
        r = f" @{self.rate}fps" if self.rate else ""
        db = f" dyn_batch<={self.dyn_batch}" if self.dyn_batch else ""
        return f"TensorsSpec[{self.format.name.lower()}]({body}{r}{db})"

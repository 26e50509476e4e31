"""Self-describing per-tensor wire header for flexible/sparse streams.

Reference parity: `GstTensorMetaInfo` + gst_tensor_meta_info_append_header /
parse (gst/nnstreamer/include/tensor_typedef.h:268-296,
nnstreamer_plugin_api_impl.c:1397). A flexible-format stream opts out of
static negotiation by prefixing every tensor payload with this header; the
sparse codec (sparse.py) adds an nnz field and COO payload layout.

Wire layout (little-endian uint32 fields, variable length):

  magic     'TPUT' (0x54505554)
  version   1
  dtype     DType enum value
  format    TensorFormat enum value
  media     MediaType enum value
  rank      r (1..16)
  dims[r]   row-major shape
  extra     sparse: nnz; otherwise 0
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Tuple

from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import MAX_RANK, MediaType, TensorFormat, TensorInfo

MAGIC = 0x54505554  # 'TPUT'
VERSION = 1
_FIXED = struct.Struct("<6I")  # magic, version, dtype, format, media, rank


@dataclass(frozen=True)
class MetaHeader:
    shape: Tuple[int, ...]
    dtype: DType
    format: TensorFormat = TensorFormat.FLEXIBLE
    media: MediaType = MediaType.TENSOR
    extra: int = 0  # sparse: number of non-zeros

    @classmethod
    def for_info(cls, info: TensorInfo, format=TensorFormat.FLEXIBLE,
                 media=MediaType.TENSOR, extra: int = 0) -> "MetaHeader":
        return cls(shape=info.shape, dtype=info.dtype, format=format,
                   media=media, extra=extra)

    def to_info(self) -> TensorInfo:
        return TensorInfo(shape=self.shape, dtype=self.dtype)

    @property
    def header_size(self) -> int:
        return _FIXED.size + 4 * len(self.shape) + 4

    def pack(self) -> bytes:
        rank = len(self.shape)
        if not 1 <= rank <= MAX_RANK:
            raise ValueError(f"rank {rank} out of range 1..{MAX_RANK}")
        return (
            _FIXED.pack(MAGIC, VERSION, int(self.dtype), int(self.format),
                        int(self.media), rank)
            + struct.pack(f"<{rank}I", *self.shape)
            + struct.pack("<I", self.extra)
        )

    @classmethod
    def unpack(cls, data: bytes) -> Tuple["MetaHeader", int]:
        """Parse a header from the front of `data` → (header, bytes consumed)."""
        if len(data) < _FIXED.size:
            raise ValueError(
                f"buffer too small for tensor meta header: {len(data)} bytes "
                f"< fixed header size {_FIXED.size}"
            )
        magic, version, dtype, fmt, media, rank = _FIXED.unpack_from(data, 0)
        if magic != MAGIC:
            raise ValueError(
                f"bad tensor meta magic 0x{magic:08x} (expected 0x{MAGIC:08x}); "
                f"is this a flexible-format tensor stream?"
            )
        if version != VERSION:
            raise ValueError(f"unsupported tensor meta version {version}")
        if not 1 <= rank <= MAX_RANK:
            raise ValueError(f"corrupt tensor meta: rank {rank}")
        need = _FIXED.size + 4 * rank + 4
        if len(data) < need:
            raise ValueError(
                f"truncated tensor meta header: have {len(data)}, need {need}"
            )
        shape = struct.unpack_from(f"<{rank}I", data, _FIXED.size)
        (extra,) = struct.unpack_from("<I", data, _FIXED.size + 4 * rank)
        hdr = cls(shape=tuple(shape), dtype=DType(dtype),
                  format=TensorFormat(fmt), media=MediaType(media), extra=extra)
        return hdr, need

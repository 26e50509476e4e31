"""The `nnstreamer.protobuf` interop schema (interop/tensors.proto in the
JAX package) with its own protobuf wire encoder and decoder.

The JAX package's `tensors_pb2.py` is protoc output over
`google.protobuf`; this module stands in for it with no protobuf
runtime. Field numbers and enum values are the schema's (the contract;
names are not):

    message Tensor  { string name = 1; Tensor_type type = 2;
                      repeated uint32 dimension = 3; bytes data = 4; }
    message Tensors { uint32 num_tensor = 1; frame_rate fr = 2;
                      repeated Tensor tensor = 3; Tensor_format format = 4;
                      message frame_rate { int32 rate_n = 1;
                                           int32 rate_d = 2; } }
    service TensorService {
      rpc SendTensors (stream Tensors) returns (google.protobuf.Empty);
      rpc RecvTensors (google.protobuf.Empty) returns (stream Tensors); }

`SerializeToString` writes protobuf's canonical proto3 encoding: fields
in field-number order, scalars equal to their default left out,
`dimension` packed, `fr` present once set (even to zeros). So a message
serializes to the same bytes as the generated class's. `FromString`
accepts any valid encoding (unpacked dimensions, repeated scalars where
the last wins, unknown fields skipped). `google.protobuf.Empty`
serializes to no bytes at all.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from nnstreamer_tpu_torch.modelio.protowire import (
    iter_fields, packed_varints, to_signed64)

SERVICE = "nnstreamer.protobuf.TensorService"
#: Tensor.Tensor_type: NNS_INT32 = 0 … NNS_UINT64 = 9 (the port's DType
#: values 0..9)
NNS_END = 10
#: Tensors.Tensor_format
FORMAT_STATIC, FORMAT_FLEXIBLE, FORMAT_SPARSE = 0, 1, 2
#: google.protobuf.Empty on the wire
EMPTY = b""

_U32 = (1 << 32) - 1


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1                  # negative ints: two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _int(fid: int, n: int) -> bytes:
    """A varint field (wire type 0); left out at its default 0."""
    return _varint(fid << 3) + _varint(n) if n else b""


def _len(fid: int, data: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(fid << 3 | 2) + _varint(len(data)) + data


def _i32(v: int) -> int:
    v = to_signed64(v) & _U32
    return v - (1 << 32) if v >= 1 << 31 else v


@dataclass
class Tensor:
    name: str = ""
    type: int = 0
    dimension: List[int] = field(default_factory=list)
    data: bytes = b""

    def SerializeToString(self) -> bytes:
        out = [_len(1, self.name.encode("utf-8")) if self.name else b"",
               _int(2, int(self.type))]
        if self.dimension:
            out.append(_len(3, b"".join(_varint(int(d) & _U32)
                                        for d in self.dimension)))
        if self.data:
            out.append(_len(4, bytes(self.data)))
        return b"".join(out)

    @classmethod
    def FromString(cls, data: bytes) -> "Tensor":
        t = cls()
        for fid, wt, v in iter_fields(data):
            if fid == 1 and wt == 2:
                t.name = v.decode("utf-8")
            elif fid == 2 and wt == 0:
                t.type = _i32(v)
            elif fid == 3 and wt == 2:
                t.dimension.extend(d & _U32 for d in packed_varints(v))
            elif fid == 3 and wt == 0:
                t.dimension.append(v & _U32)
            elif fid == 4 and wt == 2:
                t.data = v
        return t


@dataclass
class FrameRate:
    rate_n: int = 0
    rate_d: int = 0

    def SerializeToString(self) -> bytes:
        return _int(1, int(self.rate_n)) + _int(2, int(self.rate_d))

    def merge(self, data: bytes) -> None:
        for fid, wt, v in iter_fields(data):
            if fid == 1 and wt == 0:
                self.rate_n = _i32(v)
            elif fid == 2 and wt == 0:
                self.rate_d = _i32(v)


@dataclass
class Tensors:
    num_tensor: int = 0
    fr: Optional[FrameRate] = None
    tensor: List[Tensor] = field(default_factory=list)
    format: int = 0

    def SerializeToString(self) -> bytes:
        out = [_int(1, int(self.num_tensor) & _U32)]
        if self.fr is not None:
            out.append(_len(2, self.fr.SerializeToString()))
        out.extend(_len(3, t.SerializeToString()) for t in self.tensor)
        out.append(_int(4, int(self.format)))
        return b"".join(out)

    @classmethod
    def FromString(cls, data: bytes) -> "Tensors":
        """Parse one message; raises ValueError (or UnicodeDecodeError)
        on a corrupt or truncated frame."""
        msg = cls()
        for fid, wt, v in iter_fields(data):
            if fid == 1 and wt == 0:
                msg.num_tensor = v & _U32
            elif fid == 2 and wt == 2:
                if msg.fr is None:
                    msg.fr = FrameRate()
                msg.fr.merge(v)
            elif fid == 3 and wt == 2:
                msg.tensor.append(Tensor.FromString(v))
            elif fid == 4 and wt == 0:
                msg.format = _i32(v)
        return msg

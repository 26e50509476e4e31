"""Minimal protobuf wire-format reader (dependency-free).

A copy of the JAX package's modelio/protowire.py. The TFLite loader
uses `wire_context` so a corrupt file fails as a `BackendError` naming
it; the protobuf-based loaders (GraphDef, Caffe, UFF) will read their
files with the rest without importing TensorFlow (the reference links
the whole TF runtime for this, `tensor_filter_tensorflow.cc`). Protobuf's
wire format is five primitive field encodings — this module decodes them
generically and the caller interprets field numbers against the public
.proto schemas.

Wire types: 0=varint, 1=fixed64, 2=length-delimited, 5=fixed32.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union

Value = Union[int, bytes]


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """→ (value, new_pos). Unsigned; callers reinterpret as needed.

    Raises ValueError on truncation/corruption — the module's single
    error type (never IndexError/struct.error)."""
    result = 0
    shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise ValueError("truncated varint (corrupt protobuf)")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def to_signed64(v: int) -> int:
    """Reinterpret an unsigned varint as two's-complement int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Value]]:
    """Yield (field_number, wire_type, value) for one message's bytes.

    Length-delimited values come back as bytes; varints as unsigned int;
    fixed32/64 as their raw little-endian unsigned int.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = read_varint(buf, pos)
            yield field, wt, v
        elif wt == 1:
            if pos + 8 > n:
                raise ValueError(f"truncated fixed64 at field {field}")
            v = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
            yield field, wt, v
        elif wt == 2:
            ln, pos = read_varint(buf, pos)
            if pos + ln > n:
                raise ValueError(
                    f"length-delimited field {field} claims {ln} bytes "
                    f"past the end (corrupt protobuf)")
            yield field, wt, bytes(buf[pos:pos + ln])
            pos += ln
        elif wt == 5:
            if pos + 4 > n:
                raise ValueError(f"truncated fixed32 at field {field}")
            v = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            yield field, wt, v
        elif wt in (3, 4):      # group start/end (deprecated, unused)
            raise ValueError(f"unsupported protobuf group at field {field}")
        else:
            raise ValueError(f"bad wire type {wt} for field {field}")


import contextlib


@contextlib.contextmanager
def wire_context(what: str, exc_type):
    """Translate any parse-time failure into the caller's typed error.

    A corrupt file must fail as the loader's documented error type
    (e.g. BackendError naming the file), never escape as IndexError/
    struct.error/UnicodeDecodeError from the wire internals."""
    try:
        yield
    except (ValueError, IndexError, KeyError, OverflowError,
            struct.error, UnicodeDecodeError) as e:
        raise exc_type(f"{what}: malformed file: {e}") from None


def fields_dict(buf: bytes) -> Dict[int, List[Value]]:
    """Collect all occurrences of each field (repeated-safe)."""
    out: Dict[int, List[Value]] = {}
    for field, _wt, v in iter_fields(buf):
        out.setdefault(field, []).append(v)
    return out


def first(d: Dict[int, List[Value]], field: int, default=None):
    vs = d.get(field)
    return vs[0] if vs else default


def fixed32_to_float(v: int) -> float:
    return struct.unpack("<f", struct.pack("<I", v))[0]


def packed_varints(data: bytes) -> List[int]:
    """Decode a packed repeated varint payload."""
    out = []
    pos = 0
    while pos < len(data):
        v, pos = read_varint(data, pos)
        out.append(v)
    return out

"""Dependency-free FlexBuffers reader (decode only).

FlexBuffers is flatbuffers' schema-less sibling; TFLite custom-op
options and the reference's flexbuf tensor frames use it.  The repo's
other wire formats already have from-scratch readers (protowire for
protobuf, modelio/tflite.py's flatbuffer walker); this closes the gap so
custom-op ingestion (modelio/tflite.py) and flexbuf frame decode work
without the external ``flatbuffers`` package installed.

Format (public spec, mirrors flexbuffers.h semantics):
  buffer = [...values...][root value: root_w bytes][packed type][root_w]
  packed_type = (type << 2) | log2(child byte width)
  offset types store a uint at the value position; target address is
  ``value_pos - offset`` (offsets point backwards).
  vector: length at addr-w, elements at addr (w bytes each), 1 packed
  type byte per element after the elements.
  map: vector of values + keys-vector pointer at addr-3w (own byte
  width at addr-2w); keys vector is a typed vector of KEYs.
  string/blob: length at addr-w, bytes at addr.  key: NUL-terminated.

A copy of the JAX package's interop/flexbuf_read.py (tested there
byte for byte against the stock ``flatbuffers.flexbuffers`` builder);
the port's TFLite loader reads custom-op options with it.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List

# type enum (flexbuffers.h FBT_*)
_NULL, _INT, _UINT, _FLOAT, _KEY, _STRING = 0, 1, 2, 3, 4, 5
_INDIRECT_INT, _INDIRECT_UINT, _INDIRECT_FLOAT = 6, 7, 8
_MAP, _VECTOR = 9, 10
_VECTOR_INT, _VECTOR_UINT, _VECTOR_FLOAT, _VECTOR_KEY = 11, 12, 13, 14
_VECTOR_STRING_DEPR = 15
_VECTOR_INT2, _VECTOR_FLOAT4 = 16, 24   # fixed typed vectors span 16..24
_BLOB, _BOOL, _VECTOR_BOOL = 25, 26, 36

_UINT_FMT = {1: "<B", 2: "<H", 4: "<I", 8: "<Q"}
_INT_FMT = {1: "<b", 2: "<h", 4: "<i", 8: "<q"}
_FLT_FMT = {2: "<e", 4: "<f", 8: "<d"}


class FlexDecodeError(ValueError):
    pass


def _scalar(fmts, data: bytes, off: int, w: int):
    # Bounds-check every dereference: corrupt offsets must raise, not
    # read from the buffer tail via Python negative indexing.
    if off < 0 or off + w > len(data):
        raise FlexDecodeError(f"offset {off} (+{w}) out of bounds")
    try:
        return struct.unpack_from(fmts[w], data, off)[0]
    except (KeyError, struct.error) as e:
        raise FlexDecodeError(f"bad scalar at {off}: {e}") from None


def _u(data: bytes, off: int, w: int) -> int:
    return _scalar(_UINT_FMT, data, off, w)


def _i(data: bytes, off: int, w: int) -> int:
    return _scalar(_INT_FMT, data, off, w)


def _f(data: bytes, off: int, w: int) -> float:
    return _scalar(_FLT_FMT, data, off, w)


def _indirect(data: bytes, off: int, parent_w: int) -> int:
    addr = off - _u(data, off, parent_w)
    if addr < 0:
        raise FlexDecodeError(f"backward offset at {off} underflows")
    return addr


def _key(data: bytes, addr: int) -> str:
    if addr < 0 or addr >= len(data):
        raise FlexDecodeError(f"key offset {addr} out of bounds")
    end = data.find(b"\x00", addr)
    if end < 0:
        raise FlexDecodeError(f"unterminated key at {addr}")
    try:
        return data[addr:end].decode("utf-8")
    except UnicodeDecodeError as e:
        raise FlexDecodeError(f"key at {addr} is not utf-8: {e}") \
            from None


def _types_start(data: bytes, addr: int, w: int, n: int) -> int:
    """Start of a vector/map's trailing per-element type bytes, bounds
    checked so truncated buffers raise instead of IndexError."""
    start = addr + n * w
    if start + n > len(data):
        raise FlexDecodeError(
            f"vector type bytes at {start} (+{n}) exceed buffer")
    return start


def _typed_vector(data: bytes, addr: int, w: int, elem_type: int,
                  length: int) -> List[Any]:
    out: List[Any] = []
    for idx in range(length):
        pos = addr + idx * w
        if elem_type == _INT:
            out.append(_i(data, pos, w))
        elif elem_type == _UINT:
            out.append(_u(data, pos, w))
        elif elem_type == _FLOAT:
            out.append(_f(data, pos, w))
        elif elem_type == _BOOL:
            out.append(bool(_u(data, pos, w)))
        elif elem_type == _KEY:
            out.append(_key(data, _indirect(data, pos, w)))
        else:
            raise FlexDecodeError(f"typed vector of type {elem_type}")
    return out


def _ref(data: bytes, off: int, parent_w: int, packed: int) -> Any:
    t, child_w = packed >> 2, 1 << (packed & 3)
    if t == _NULL:
        return None
    if t == _INT:
        return _i(data, off, parent_w)
    if t in (_UINT, _BOOL):
        v = _u(data, off, parent_w)
        return bool(v) if t == _BOOL else v
    if t == _FLOAT:
        return _f(data, off, parent_w)
    # everything below is an offset type
    addr = _indirect(data, off, parent_w)
    if t == _KEY:
        return _key(data, addr)
    if t in (_STRING, _BLOB):
        n = _u(data, addr - child_w, child_w)
        if addr + n > len(data):
            raise FlexDecodeError(
                f"{'string' if t == _STRING else 'blob'} length {n} at "
                f"{addr} exceeds buffer")
        raw = data[addr:addr + n]
        if t == _BLOB:
            return bytes(raw)
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise FlexDecodeError(
                f"string at {addr} is not utf-8: {e}") from None
    if t == _INDIRECT_INT:
        return _i(data, addr, child_w)
    if t == _INDIRECT_UINT:
        return _u(data, addr, child_w)
    if t == _INDIRECT_FLOAT:
        return _f(data, addr, child_w)
    if t == _MAP:
        n = _u(data, addr - child_w, child_w)
        keys_w = _u(data, addr - 2 * child_w, child_w)
        keys_addr = _indirect(data, addr - 3 * child_w, child_w)
        keys = _typed_vector(data, keys_addr, keys_w, _KEY, n)
        types_at = _types_start(data, addr, child_w, n)
        out: Dict[str, Any] = {}
        for idx in range(n):
            out[keys[idx]] = _ref(data, addr + idx * child_w, child_w,
                                  data[types_at + idx])
        return out
    if t == _VECTOR:
        n = _u(data, addr - child_w, child_w)
        types_at = _types_start(data, addr, child_w, n)
        return [_ref(data, addr + idx * child_w, child_w,
                     data[types_at + idx]) for idx in range(n)]
    if _VECTOR_INT <= t <= _VECTOR_STRING_DEPR or t == _VECTOR_BOOL:
        n = _u(data, addr - child_w, child_w)
        elem = _BOOL if t == _VECTOR_BOOL else (
            _KEY if t >= _VECTOR_KEY else t - _VECTOR_INT + _INT)
        return _typed_vector(data, addr, child_w, elem, n)
    if _VECTOR_INT2 <= t <= _VECTOR_FLOAT4:
        n = (t - _VECTOR_INT2) // 3 + 2
        elem = (t - _VECTOR_INT2) % 3 + _INT
        return _typed_vector(data, addr, child_w, elem, n)
    raise FlexDecodeError(f"unsupported flexbuffer type {t}")


def flexbuf_loads(data: bytes) -> Any:
    """Decode a whole FlexBuffers buffer to plain Python values."""
    if len(data) < 3:
        raise FlexDecodeError("flexbuffer too short")
    root_w = data[-1]
    if root_w not in _UINT_FMT:
        raise FlexDecodeError(f"bad root byte width {root_w}")
    if len(data) < 2 + root_w:
        raise FlexDecodeError("flexbuffer shorter than its root value")
    packed = data[-2]
    return _ref(data, len(data) - 2 - root_w, root_w, packed)

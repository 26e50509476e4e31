"""Minimal FlatBuffers binary reader (a copy of the JAX package's).

Self-contained decoder for the FlatBuffers wire format (little-endian,
vtable-based tables) — enough to walk a schema'd file like `.tflite`
without the flatbuffers runtime or generated schema code. Read-only and
zero-copy: byte vectors are returned as numpy views into the file buffer.

Wire format summary (flatbuffers internals doc):
- root: uint32 offset at position 0 to the root table.
- table: int32 at table-pos is the *backwards* offset to its vtable;
  vtable = [u16 vtable_bytes, u16 table_bytes, u16 slot_0, u16 slot_1, …]
  where slot_i is the field's offset from table-pos (0 / absent ⇒ field
  not present, use schema default).
- scalar fields are inline at table_pos+slot; reference fields (string /
  vector / table) hold a uint32 forward offset relative to their own
  position.
- vector: u32 count then elements (inline scalars, or u32 offsets).
- string: u32 length then utf-8 bytes.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np


class Reader:
    """Cursor-free reader over one flatbuffer."""

    def __init__(self, buf: bytes):
        self.buf = buf

    # -- primitive loads ---------------------------------------------------
    def u8(self, pos: int) -> int:
        return self.buf[pos]

    def i8(self, pos: int) -> int:
        return struct.unpack_from("<b", self.buf, pos)[0]

    def u16(self, pos: int) -> int:
        return struct.unpack_from("<H", self.buf, pos)[0]

    def i32(self, pos: int) -> int:
        return struct.unpack_from("<i", self.buf, pos)[0]

    def u32(self, pos: int) -> int:
        return struct.unpack_from("<I", self.buf, pos)[0]

    def i64(self, pos: int) -> int:
        return struct.unpack_from("<q", self.buf, pos)[0]

    def f32(self, pos: int) -> float:
        return struct.unpack_from("<f", self.buf, pos)[0]

    def f64(self, pos: int) -> float:
        return struct.unpack_from("<d", self.buf, pos)[0]

    # -- tables ------------------------------------------------------------
    def root(self) -> int:
        return self.u32(0)

    def field_pos(self, table: int, fid: int) -> Optional[int]:
        """Absolute position of field `fid` in `table`, or None if absent."""
        vtable = table - self.i32(table)
        entry = 4 + 2 * fid
        if entry >= self.u16(vtable):
            return None
        slot = self.u16(vtable + entry)
        return table + slot if slot else None

    def indirect(self, pos: int) -> int:
        return pos + self.u32(pos)

    # -- typed field accessors (with schema defaults) -----------------------
    def field_scalar(self, table: int, fid: int, fmt: str, default=0):
        pos = self.field_pos(table, fid)
        if pos is None:
            return default
        return struct.unpack_from(fmt, self.buf, pos)[0]

    def field_bool(self, table: int, fid: int, default=False) -> bool:
        return bool(self.field_scalar(table, fid, "<b", int(default)))

    def field_table(self, table: int, fid: int) -> Optional[int]:
        pos = self.field_pos(table, fid)
        return self.indirect(pos) if pos is not None else None

    def field_string(self, table: int, fid: int) -> Optional[str]:
        pos = self.field_pos(table, fid)
        if pos is None:
            return None
        spos = self.indirect(pos)
        n = self.u32(spos)
        return bytes(self.buf[spos + 4:spos + 4 + n]).decode("utf-8")

    # -- vectors -------------------------------------------------------------
    def _vec(self, table: int, fid: int):
        pos = self.field_pos(table, fid)
        if pos is None:
            return None, 0
        vpos = self.indirect(pos)
        return vpos + 4, self.u32(vpos)

    def field_vec_scalars(self, table: int, fid: int,
                          dtype: np.dtype) -> Optional[np.ndarray]:
        """Scalar vector as a zero-copy numpy view (little-endian host)."""
        base, n = self._vec(table, fid)
        if base is None:
            return None
        dtype = np.dtype(dtype)
        return np.frombuffer(self.buf, dtype=dtype, count=n, offset=base)

    def field_vec_tables(self, table: int, fid: int) -> List[int]:
        base, n = self._vec(table, fid)
        if base is None:
            return []
        return [self.indirect(base + 4 * i) for i in range(n)]

    def field_vec_strings(self, table: int, fid: int) -> List[str]:
        base, n = self._vec(table, fid)
        if base is None:
            return []
        out = []
        for i in range(n):
            spos = self.indirect(base + 4 * i)
            ln = self.u32(spos)
            out.append(bytes(self.buf[spos + 4:spos + 4 + ln])
                       .decode("utf-8"))
        return out

    def field_vec_len(self, table: int, fid: int) -> int:
        _, n = self._vec(table, fid)
        return n

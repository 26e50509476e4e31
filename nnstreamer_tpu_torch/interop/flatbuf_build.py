"""Minimal FlatBuffers writer for the interop frames (no `flatbuffers`
package; modelio/flatbuf.py's `Reader` reads what it writes back).

It writes front to back: the root offset at 0, then each table right
after its vtable, then the objects its reference fields point to. Every
uoffset so points forward (to a higher address), as the format requires,
and every vtable sits before its table (a positive soffset). A table's
reference fields are written as placeholders and patched with
`point(field_pos, target_pos)` once the target exists.

Layout rules kept (the flatbuffers internals doc):
- a table starts 4-aligned with its soffset to the vtable; its fields
  follow inline, each aligned to its size;
- a vtable is [u16 vtable bytes, u16 table bytes, u16 per slot]: slot i
  at 4 + 2i holds the field's offset from the table start, 0 = absent;
- a vector is a u32 count then its elements, the elements aligned to
  their size (and the count to 4); a string is a byte vector plus a NUL.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

#: a table field: (slot, struct format or None for a reference, value)
Field = Tuple[int, Optional[str], object]


class Builder:
    def __init__(self):
        self.buf = bytearray(4)          # the root uoffset, set by finish

    def _pad(self, align: int, extra: int = 0) -> None:
        """Pad so that `extra` bytes from here lands on `align`."""
        self.buf.extend(b"\0" * ((-(len(self.buf) + extra)) % align))

    def point(self, field_pos: int, target_pos: int) -> None:
        """Set the uoffset at `field_pos` to reach `target_pos`."""
        struct.pack_into("<I", self.buf, field_pos, target_pos - field_pos)

    def table(self, fields: Sequence[Field]) -> Tuple[int, Dict[int, int]]:
        """Write a vtable and its table → (table position, {slot: field
        position} of the reference fields, to `point` later). Fields the
        schema defaults are the caller's to leave out."""
        layout: List[Tuple[int, str, object, int]] = []
        cur = 4                                   # after the soffset
        for slot, fmt, value in fields:
            fmt = fmt or "<I"
            size = struct.calcsize(fmt)
            cur += (-cur) % min(size, 8)
            layout.append((slot, fmt, value, cur))
            cur += size
        n_slots = max([-1] + [f[0] for f in fields]) + 1
        vt = [4 + 2 * n_slots, cur] + [0] * n_slots
        for slot, _, _, at in layout:
            vt[2 + slot] = at
        self._pad(4)
        vt_pos = len(self.buf)
        self.buf.extend(struct.pack(f"<{len(vt)}H", *vt))
        self._pad(8)
        table_pos = len(self.buf)
        self.buf.extend(b"\0" * cur)
        struct.pack_into("<i", self.buf, table_pos, table_pos - vt_pos)
        refs = {}
        for slot, fmt, value, at in layout:
            if value is None:
                refs[slot] = table_pos + at
            elif isinstance(value, tuple):
                struct.pack_into(fmt, self.buf, table_pos + at, *value)
            else:
                struct.pack_into(fmt, self.buf, table_pos + at, value)
        return table_pos, refs

    def vector(self, data: bytes, count: int, align: int = 4) -> int:
        """A vector of `count` scalars whose little-endian bytes are
        `data` → its position (the count's)."""
        self._pad(max(4, align), 4)
        pos = len(self.buf)
        self.buf.extend(struct.pack("<I", count))
        self.buf.extend(data)
        return pos

    def string(self, s: str) -> int:
        raw = s.encode("utf-8")
        pos = self.vector(raw, len(raw))
        self.buf.append(0)
        return pos

    def ref_vector(self, count: int) -> List[int]:
        """A vector of `count` references → the position of each element,
        to `point` later; the vector's own position comes first."""
        pos = self.vector(b"\0" * (4 * count), count)
        return [pos] + [pos + 4 + 4 * i for i in range(count)]

    def finish(self, root_pos: int) -> bytes:
        self.point(0, root_pos)
        return bytes(self.buf)

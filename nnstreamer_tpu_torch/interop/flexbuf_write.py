"""Minimal FlexBuffers writer for the interop frames (no `flatbuffers`
package; interop/flexbuf_read.py reads what it writes back, and so does
the stock `flexbuffers.Loads`).

One byte width, 8, for every object: each vector, map, string, blob and
offset is stored in 8-byte slots, and each packed type byte says so
(bit-width code 3). That wastes a few bytes against the stock builder's
narrowest widths and keeps every offset in range at any frame size.
Objects are written before the vectors that point at them, so every
offset points backwards as the format requires, and a map's keys are
sorted by their bytes (readers binary-search them).

Values: `int` → INT, `Uint(n)` → UINT, `str` → STRING, `bytes` → BLOB,
`Ints([...])` → a typed vector of INT, `list` → VECTOR of any of these,
`dict` → MAP (str keys).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

W = 8               # the byte width of everything written
_W_CODE = 3         # log2(W)
_NULL, _INT, _UINT, _KEY, _STRING = 0, 1, 2, 4, 5
_MAP, _VECTOR, _VECTOR_INT, _VECTOR_KEY, _BLOB = 9, 10, 11, 14, 25


class Uint(int):
    """An unsigned integer value (UINT)."""


class Ints(list):
    """A typed vector of signed integers (VECTOR_INT)."""


def _packed(t: int) -> int:
    return t << 2 | _W_CODE


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def _align(self) -> None:
        self.buf.extend(b"\0" * ((-len(self.buf)) % W))

    def _uint(self, v: int) -> bytes:
        return struct.pack("<Q", v)

    def _slots(self, items: List[Tuple[int, Any]], prefix: bytes = b"",
               types: bool = True) -> int:
        """Write [prefix][length][slots][type bytes] → the first slot's
        address. `items`: (packed type, inline int or target address)."""
        self._align()
        self.buf.extend(prefix)
        self.buf.extend(self._uint(len(items)))
        addr = len(self.buf)
        for i, (packed, v) in enumerate(items):
            if packed >> 2 in (_INT, _UINT):
                self.buf.extend(struct.pack(
                    "<q" if packed >> 2 == _INT else "<Q", v))
            else:                                    # backward offset
                self.buf.extend(self._uint(addr + i * W - v))
        if types:
            self.buf.extend(bytes(p for p, _ in items))
        return addr

    def value(self, v: Any) -> Tuple[int, int]:
        """Write what `v` needs out of line → (packed type, the inline
        int or the target address)."""
        if isinstance(v, bool):
            raise TypeError("flexbuf_write: bool values are not supported")
        if isinstance(v, Uint):
            return _packed(_UINT), int(v)
        if isinstance(v, int):
            return _packed(_INT), v
        if isinstance(v, (str, bytes)):
            raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            self._align()
            self.buf.extend(self._uint(len(raw)))
            addr = len(self.buf)
            self.buf.extend(raw)
            if isinstance(v, str):
                self.buf.append(0)
            return _packed(_STRING if isinstance(v, str) else _BLOB), addr
        if isinstance(v, Ints):
            return _packed(_VECTOR_INT), self._slots(
                [(_packed(_INT), int(x)) for x in v], types=False)
        if isinstance(v, list):
            return _packed(_VECTOR), self._slots([self.value(x) for x in v])
        if isinstance(v, dict):
            return _packed(_MAP), self._map(v)
        raise TypeError(f"flexbuf_write: no encoding for {type(v).__name__}")

    def _map(self, d: Dict[str, Any]) -> int:
        keys = sorted(d, key=lambda k: k.encode("utf-8"))
        key_addrs = []
        for k in keys:
            key_addrs.append(len(self.buf))
            self.buf.extend(k.encode("utf-8") + b"\0")
        keys_addr = self._slots([(_packed(_KEY), a) for a in key_addrs],
                                types=False)
        values = [self.value(d[k]) for k in keys]
        # [keys offset][keys byte width] precede the map's length
        self._align()
        prefix_at = len(self.buf)
        prefix = self._uint(prefix_at - keys_addr) + self._uint(W)
        return self._slots(values, prefix=prefix)

    def finish(self, packed: int, target: int) -> bytes:
        self._align()
        self.buf.extend(self._uint(len(self.buf) - target))
        self.buf.extend(bytes([packed, W]))
        return bytes(self.buf)


def dumps(root: Dict[str, Any]) -> bytes:
    """A map at the root → the FlexBuffers bytes."""
    w = _Writer()
    packed, target = w.value(root)
    return w.finish(packed, target)

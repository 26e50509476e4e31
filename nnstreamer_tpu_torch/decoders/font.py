"""Tiny bitmap font rasterizer shared by overlay decoders.

Reference parity: ext/nnstreamer/tensor_decoder/tensordec-font.c — an 8x8
raster font used by bounding-box/label overlays. Ours is an original 3x5
micro-glyph set (defined below as 15-bit masks) upscaled to 8x8 cells, so
overlay text is legible without shipping a font table.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# 3 columns x 5 rows per glyph, row-major bits (msb = left column).
# Covers digits, uppercase, and common label punctuation; unknown chars
# render as a filled box.
_GLYPHS: Dict[str, Tuple[str, ...]] = {
    "0": ("111", "101", "101", "101", "111"),
    "1": ("010", "110", "010", "010", "111"),
    "2": ("111", "001", "111", "100", "111"),
    "3": ("111", "001", "111", "001", "111"),
    "4": ("101", "101", "111", "001", "001"),
    "5": ("111", "100", "111", "001", "111"),
    "6": ("111", "100", "111", "101", "111"),
    "7": ("111", "001", "010", "010", "010"),
    "8": ("111", "101", "111", "101", "111"),
    "9": ("111", "101", "111", "001", "111"),
    "A": ("010", "101", "111", "101", "101"),
    "B": ("110", "101", "110", "101", "110"),
    "C": ("011", "100", "100", "100", "011"),
    "D": ("110", "101", "101", "101", "110"),
    "E": ("111", "100", "110", "100", "111"),
    "F": ("111", "100", "110", "100", "100"),
    "G": ("011", "100", "101", "101", "011"),
    "H": ("101", "101", "111", "101", "101"),
    "I": ("111", "010", "010", "010", "111"),
    "J": ("001", "001", "001", "101", "010"),
    "K": ("101", "110", "100", "110", "101"),
    "L": ("100", "100", "100", "100", "111"),
    "M": ("101", "111", "111", "101", "101"),
    "N": ("101", "111", "111", "111", "101"),
    "O": ("010", "101", "101", "101", "010"),
    "P": ("110", "101", "110", "100", "100"),
    "Q": ("010", "101", "101", "110", "011"),
    "R": ("110", "101", "110", "110", "101"),
    "S": ("011", "100", "010", "001", "110"),
    "T": ("111", "010", "010", "010", "010"),
    "U": ("101", "101", "101", "101", "111"),
    "V": ("101", "101", "101", "101", "010"),
    "W": ("101", "101", "111", "111", "101"),
    "X": ("101", "101", "010", "101", "101"),
    "Y": ("101", "101", "010", "010", "010"),
    "Z": ("111", "001", "010", "100", "111"),
    " ": ("000", "000", "000", "000", "000"),
    "-": ("000", "000", "111", "000", "000"),
    "_": ("000", "000", "000", "000", "111"),
    ".": ("000", "000", "000", "000", "010"),
    ":": ("000", "010", "000", "010", "000"),
    "%": ("101", "001", "010", "100", "101"),
    "/": ("001", "001", "010", "100", "100"),
}

CELL = 8  # rendered glyph cell (8x8, reference-compatible density)


def _glyph_bitmap(ch: str) -> np.ndarray:
    rows = _GLYPHS.get(ch.upper())
    if rows is None:
        g = np.ones((5, 3), np.uint8)  # unknown → filled box
    else:
        g = np.array([[c == "1" for c in r] for r in rows], np.uint8)
    # upscale 3x5 → 6x5 horizontally padded to 8x8 cell with 1px margins
    up = np.repeat(g, 2, axis=1)            # (5, 6)
    cell = np.zeros((CELL, CELL), np.uint8)
    cell[1:6, 1:7] = up
    return cell


_CACHE: Dict[str, np.ndarray] = {}


def render_text(text: str) -> np.ndarray:
    """→ (8, 8*len(text)) uint8 {0,1} bitmap."""
    cells = []
    for ch in text:
        if ch not in _CACHE:
            _CACHE[ch] = _glyph_bitmap(ch)
        cells.append(_CACHE[ch])
    if not cells:
        return np.zeros((CELL, 0), np.uint8)
    return np.concatenate(cells, axis=1)


def blit_text(img: np.ndarray, text: str, x: int, y: int,
              color=(255, 255, 255, 255)) -> None:
    """Draw text onto an (H, W, C) uint8 image in place, clipped."""
    bm = render_text(text)
    h, w = bm.shape
    H, W = img.shape[:2]
    x0, y0 = max(0, x), max(0, y)
    x1, y1 = min(W, x + w), min(H, y + h)
    if x1 <= x0 or y1 <= y0:
        return
    sub = bm[y0 - y : y1 - y, x0 - x : x1 - x].astype(bool)
    img[y0:y1, x0:x1][sub] = np.array(color[: img.shape[2]], np.uint8)

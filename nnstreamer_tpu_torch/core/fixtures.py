"""Deterministic synthetic raster frames for tests and benchmarks.

The reference checks in small generators that synthesize test rasters
(`tests/gen24bBMP.py` in nnstreamer) rather than binary fixtures; this
is the same idea for classifier inputs. Frames are structured —
per-channel gradient, flat color, one saturated block, mild noise — so
a classifier's logits are peaked and argmax is stable under ±1
quantized-step numeric skew; pure noise would give near-uniform logits
whose argmax flips on rounding-mode differences and misreads them as
model error. Arithmetic is int16 + clip (uint8 += wraps modulo 256 and
would punch near-black holes into the saturated block).
"""

from __future__ import annotations

import numpy as np


def synthetic_frames(n: int, seed: int = 42, size: int = 224,
                     block: int = 64) -> np.ndarray:
    """(n, size, size, 3) uint8 structured frames, deterministic in
    `seed`. Block origins are bounded so blocks are never truncated."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, size, size, 3), np.int16)
    x[..., 0] = np.linspace(0, 255, size, dtype=np.int16)[None, None, :]
    hi = max(size - block + 1, 1)
    for i in range(n):
        x[i, :, :, 1] = rng.integers(0, 256)
        bx, by = rng.integers(0, hi, 2)
        x[i, by:by + block, bx:bx + block, 2] = 255
    noise = rng.integers(0, 30, x.shape)
    return np.clip(x + noise, 0, 255).astype(np.uint8)

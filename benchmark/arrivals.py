"""Seeded request sizes for the traffic mixes.

Every mix draws its *multiset* of sizes from the mix file's own
`base_seed`, and the run's `--seed` only permutes their order: two
seeds offer the same work, so the spread between seeds is the system's
and not the traffic's.
"""

from __future__ import annotations

import numpy as np


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """`n` integer lengths from a length spec of a mix file:
    ``{"dist": "uniform", "lo", "hi"}`` (inclusive),
    ``{"dist": "loguniform", "lo", "hi"}`` or
    ``{"dist": "lognormal", "median", "sigma", "lo", "hi"}`` (clipped)."""
    lo, hi = int(spec["lo"]), int(spec["hi"])
    dist = spec["dist"]
    if dist == "uniform":
        v = rng.integers(lo, hi + 1, size=n)
    elif dist == "loguniform":
        v = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=n))
    elif dist == "lognormal":
        v = rng.lognormal(np.log(float(spec["median"])),
                          float(spec["sigma"]), size=n)
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return np.clip(np.floor(v), lo, hi).astype(np.int64)


def request_sizes(mix: dict, n: int, seed: int) -> tuple:
    """(prompt lengths, output lengths) of `n` requests: the multiset
    from the mix's `base_seed`, in the order `seed` gives."""
    rng = np.random.default_rng(int(mix["base_seed"]))
    plen = lengths(mix["prompt"], n, rng)
    olen = lengths(mix["output"], n, rng)
    order = np.random.default_rng(int(seed)).permutation(n)
    return plen[order], olen[order]

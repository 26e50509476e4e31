"""Shared decoder option helpers (tensordecutil.c analog)."""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

from nnstreamer_tpu_torch.core.errors import PipelineError


def load_labels(path: str, what: str) -> List[str]:
    """One-label-per-line file → list; actionable error when missing."""
    if not path:
        return []
    p = Path(path)
    if not p.is_file():
        raise PipelineError(
            f"{what}: labels file {path!r} not found (expected a "
            f"one-label-per-line text file)")
    return [l.strip() for l in p.read_text().splitlines() if l.strip()]


def parse_wh(s: str, default_w: int, default_h: int) -> Tuple[int, int]:
    """'W:H' option string → (w, h); empty → defaults."""
    if not s:
        return default_w, default_h
    w, _, h = s.partition(":")
    try:
        return int(w), int(h)
    except ValueError:
        raise PipelineError(
            f"bad size option {s!r}: expected 'WIDTH:HEIGHT' (e.g. 640:480)"
        ) from None

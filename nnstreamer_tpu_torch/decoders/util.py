"""Shared decoder option helpers (tensordecutil.c analog)."""

from __future__ import annotations

from pathlib import Path
from typing import List

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

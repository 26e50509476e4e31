"""Whole step: operations of the sub-window's live tokens over it, % of
bf16 peak."""
from benchmark.readers import mfu_tokens as read  # noqa: F401

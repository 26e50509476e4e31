"""Compiled windows: % of the model filter's frames served inside a window."""
from benchmark.readers import window_frame_share as read  # noqa: F401

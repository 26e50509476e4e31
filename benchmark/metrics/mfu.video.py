"""Whole step: MobileNetV2 operations of the sub-window's frames over it, %
of bf16 peak."""
from benchmark.readers import mfu_frames as read  # noqa: F401

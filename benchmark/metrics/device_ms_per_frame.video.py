"""Filter and vision model: profiler device ms per frame in the traced sub-
window."""
from benchmark.readers import device_ms_per_frame as read  # noqa: F401

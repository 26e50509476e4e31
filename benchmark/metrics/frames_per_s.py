"""frames_per_s: frames reaching the sink in the window over the window."""
from benchmark.readers import frames_per_s as read  # noqa: F401

"""Pipeline and scheduler: host ms in process() per frame, summed over
elements."""
from benchmark.readers import sched_host_ms_per_frame as read  # noqa: F401

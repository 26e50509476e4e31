"""Paged cache: % of allocatable blocks at the allocator's high-water mark."""
from benchmark.readers import kv_high_water as read  # noqa: F401

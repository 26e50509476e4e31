"""Kernels: paged decode attention, % of its roofline bound."""
from benchmark.readers import paged_decode_roofline as read  # noqa: F401

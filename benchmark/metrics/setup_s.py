"""setup_s: process start to the first timed item (loading, weights, warm-
up)."""
from benchmark.readers import setup_s as read  # noqa: F401

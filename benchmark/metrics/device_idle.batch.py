"""Device: % of the traced window with no operation on the card."""
from benchmark.readers import device_idle as read  # noqa: F401

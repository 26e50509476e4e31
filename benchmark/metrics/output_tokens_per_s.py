"""output_tokens_per_s: every token reaching the sink in the window over
the window."""
from benchmark.readers import output_tokens_per_s as read  # noqa: F401

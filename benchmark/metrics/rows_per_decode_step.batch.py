"""tensor_llm and engine: decode rows per decode step in the traced sub-
window."""
from benchmark.readers import rows_per_decode_step as read  # noqa: F401

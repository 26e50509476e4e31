"""Serving: the versioned model store, device placement (logical
devices, the lease ledger) and sharded LLM serving (more of the serving
stack is still to be ported)."""

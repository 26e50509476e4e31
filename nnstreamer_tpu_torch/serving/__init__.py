"""Serving: the versioned model store (more of the serving stack is
still to be ported)."""

"""Filter backends: the torch model engine and the hand-written kernels."""

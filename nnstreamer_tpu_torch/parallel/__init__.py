"""Attention across the sequence (counterpart of the JAX package's
parallel/). Only the single-card ground truth is ported; the ring over
several cards waits for the multi-GPU slice."""

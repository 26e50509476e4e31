"""Meshes, attention across the sequence and batch dispatch (counterpart
of the JAX package's parallel/): `mesh` (logical devices with named
axes), `ring_attention` (the sequence split over a mesh axis, K/V
rotating between the devices), `dispatch` (frames from many streams
coalesced into batches on one card) and `train` (the training step on
one device). The mesh dispatcher over several cards, pipeline, MoE,
sharded training and multi-host are not ported yet."""

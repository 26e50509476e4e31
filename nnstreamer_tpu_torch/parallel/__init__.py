"""Meshes and attention across the sequence (counterpart of the JAX
package's parallel/): `mesh` (logical devices with named axes) and
`ring_attention` (the sequence split over a mesh axis, K/V rotating
between the devices). Dispatch, pipeline, MoE, training and multi-host
are not ported yet."""

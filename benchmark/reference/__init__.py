"""Plain PyTorch references of the benchmark's models, in float32 with
TF32 off. They import nothing of the program (`nnstreamer_tpu_torch`),
nor `jax` or `nnstreamer_tpu`, and take from the program nothing but
the outputs they judge: the weights and inputs are the benchmark's own.

`precision="fp8"` runs the same arithmetic with every matrix product's
operands rounded to float8 e4m3 (per output channel for weights, per
row or per sample for activations): the control of the comparison, one
precision step below the bfloat16 the configurations state."""

"""On-stream training (reference: the reserved `tensor_trainer` subplugin
type, nnstreamer_subplugin.h TRAINER slot — never fleshed out upstream),
the JAX package's trainer/ on the port.

`tensor_trainer` consumes (x, label) tensor frames and runs one optimizer
step per frame on a zoo model on one device (parallel/train.py), emits
the scalar loss downstream, and checkpoints with `torch.save` when
`checkpoint_dir` is set.
"""

from nnstreamer_tpu_torch.trainer.element import TensorTrainer

__all__ = ["TensorTrainer"]

"""The training step on one device (counterpart of the JAX package's
parallel/train.py).

JAX's step is `jax.value_and_grad` through XLA ops and an optax update,
jitted with the state donated. Here it is `torch.autograd` and a
`torch.optim` step, and the parameters are updated in place, which
stands for the donation: no second copy of the weights.

- **The leaf set is JAX's.** JAX's params tree holds every leaf
  (MobileNetV2's BN `mean` and `var` too: buffers of the port's module),
  and optax updates every leaf. `torch.optim` skips a tensor whose
  `.grad` is None, so each step gives every leaf the loss does not reach
  a zero gradient: with `adamw` its weight decay then acts on it as
  optax's does; with `sgd` and `adam` a zero gradient leaves it as it is
  in both packages.
- **Optimizers** (`sgd`, `adam`, `adamw`) are factories of a
  `torch.optim.Optimizer` over the leaves, with optax's algebra and
  defaults: SGD without momentum; Adam b1 0.9, b2 0.999, eps 1e-8 (eps
  outside the square root, as both); AdamW with optax's weight decay
  1e-4, not torch's 1e-2.
- **Meshes** (`shard_state`, `make_train_step(mesh=...)`) wait for ROADMAP
  Queue 1 item 6 and raise until then.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List

import torch
from torch import nn

from nnstreamer_tpu_torch.core.errors import PipelineError

LossFn = Callable[..., torch.Tensor]   # loss_fn(params, *batch) -> scalar
#: leaves → the optimizer over them (`sgd`, `adam`, `adamw` build these)
Optimizer = Callable[[List[torch.Tensor]], torch.optim.Optimizer]

ADAMW_WEIGHT_DECAY = 1e-4   # optax.adamw's default


def sgd(lr: float) -> Optimizer:
    return lambda leaves: torch.optim.SGD(leaves, lr=lr)


def adam(lr: float) -> Optimizer:
    return lambda leaves: torch.optim.Adam(
        leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def adamw(lr: float, weight_decay: float = ADAMW_WEIGHT_DECAY) -> Optimizer:
    return lambda leaves: torch.optim.AdamW(
        leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay)


def leaves(params) -> List[torch.Tensor]:
    """Every tensor of `params` in a fixed order: a module's parameters
    then its buffers; a dict/list tree's leaves depth first (dicts in
    their insertion order)."""
    if isinstance(params, nn.Module):
        return list(params.parameters()) + list(params.buffers())
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return [t for v in params.values() for t in leaves(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in leaves(v)]
    raise TypeError(f"params leaf of type {type(params).__name__} is not "
                    f"a tensor")


@dataclass
class TrainState:
    step: int
    params: Any                          # an nn.Module or a tensor tree
    opt_state: torch.optim.Optimizer     # holds the moments


def init_state(params, optimizer: Optimizer) -> TrainState:
    """Make every leaf trainable and build the optimizer over them."""
    ls = leaves(params)
    for t in ls:
        t.requires_grad_(True)
    return TrainState(step=0, params=params, opt_state=optimizer(ls))


def _mesh_refusal(what: str) -> PipelineError:
    return PipelineError(
        f"{what}: training sharded over a device mesh is not ported yet "
        f"(ROADMAP Queue 1 item 6); train on one device (no mesh)")


def shard_state(state: TrainState, mesh, rules=None) -> TrainState:
    raise _mesh_refusal("shard_state")


def make_train_step(loss_fn: LossFn, optimizer: Optimizer = None,
                    mesh=None):
    """Build `step(state, *batch) -> (state, loss)`: the loss at the
    current parameters, then one optimizer update of every leaf in place
    (the state comes back updated; `loss` is a detached scalar on the
    parameters' device). `optimizer` is the factory `init_state` was
    given (JAX's signature): the optimizer it built rides in the state,
    with the moments."""
    if mesh is not None:
        raise _mesh_refusal("make_train_step(mesh=...)")

    def step(state: TrainState, *batch):
        ls = leaves(state.params)
        state.opt_state.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(state.params, *batch)
            loss.backward()
        for t in ls:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        state.opt_state.step()
        state.step += 1
        return state, loss.detach()

    return step

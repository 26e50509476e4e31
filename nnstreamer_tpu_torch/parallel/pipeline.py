"""Pipeline parallelism — GPipe-style microbatched execution over the
``pp`` axis of a mesh (counterpart of the JAX package's
parallel/pipeline.py).

Stages live on different devices and activations flow stage to stage:
a model deeper than one device's memory runs across several.

- stage parameters are *stacked* on a leading stage dim
  (`stack_stage_params`); stage s's slice runs on the s-th device along
  the axis;
- the input is split into microbatches and the classic GPipe schedule
  runs: at step t, stage s computes microbatch t − s, taking the output
  stage s − 1 made at step t − 1, copied to its device (JAX's
  `lax.ppermute`, here ``.to(dev, non_blocking=True)``, counted in
  `PIPELINE_MOVES`);
- the bubble is (n_stages − 1) of (n_micro + n_stages − 1) steps. JAX
  computes a stage's idle steps on clamped inputs and throws them away;
  the port launches nothing there (ROADMAP N38);
- stages must be shape-preserving, the standard homogeneous-pipeline
  restriction;
- the last stage's results are gathered on the input's device (JAX
  psum-broadcasts them, replicated).

The port drives the stages from one process, each stage's launches on
its own device: on several cards the stages overlap as the schedule
lets them; on logical devices of one card they run one after another.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from nnstreamer_tpu_torch.parallel.mesh import Mesh, Moves

#: copies between the stages' logical devices, over every call
PIPELINE_MOVES = Moves()


def _map(fn, *trees):
    """`fn` over the leaves of trees of one structure (dict/list/tuple)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_stage_params(per_stage_params) -> Any:
    """[stage0_tree, stage1_tree, ...] → one tree with a leading stage
    dim (what pipeline_apply expects)."""
    return _map(lambda *leaves: torch.stack(leaves, dim=0), *per_stage_params)


def pipeline_apply(stage_fn: Callable, stage_params, x, *, mesh: Mesh,
                   axis: str = "pp"):
    """Run x through n_stages of `stage_fn`, pipelined over `axis`.

    stage_fn(params, a) -> a  (shape-preserving)
    stage_params: tree, every leaf (n_stages, ...), n_stages = the
    axis's size
    x: (n_micro, mb, ...) microbatched input
    → (n_micro, mb, ...) outputs on x's device.
    """
    n = mesh.shape[axis]
    n_micro = x.shape[0]
    if n_micro < 1:
        raise ValueError("pipeline_apply needs at least one microbatch")
    devs, ords = mesh.along(axis), mesh.ordinals_along(axis)
    moves = PIPELINE_MOVES
    stacked = []
    _map(lambda a: stacked.append(a.shape[0]), stage_params)
    if any(s != n for s in stacked):
        raise ValueError(
            f"stage params stack {sorted(set(stacked))} stages; the "
            f"{axis!r} axis has {n} devices (one stage each)")
    params = [_map(lambda a, s=s: a[s].to(devs[s], non_blocking=True),
                   stage_params) for s in range(n)]
    home = ords[0]
    outs = [None] * n_micro
    acts = [None] * n            # each stage's output of the last step
    for t in range(n_micro + n - 1):
        # the last stage first: each stage reads what the one before
        # it made at step t - 1 before that one moves on
        for s in reversed(range(n)):
            mb = t - s
            if not 0 <= mb < n_micro:
                continue         # a bubble: nothing runs
            a = moves.to(x[mb], devs[0], home, ords[0]) if s == 0 else \
                moves.to(acts[s - 1], devs[s], ords[s - 1], ords[s])
            y = stage_fn(params[s], a)
            if s == n - 1:
                outs[mb] = moves.to(y, x.device, ords[s], home)
            else:
                acts[s] = y
    return torch.stack(outs, dim=0)


def reference_pipeline(stage_fn: Callable, per_stage_params, x):
    """Serial ground truth: fold the stages over every microbatch."""
    def one(mb):
        a = mb
        for p in per_stage_params:
            a = stage_fn(p, a)
        return a

    return torch.stack([one(x[i]) for i in range(x.shape[0])], dim=0)

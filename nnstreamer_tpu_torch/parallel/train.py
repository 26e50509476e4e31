"""The training step, on one device or sharded over a mesh
(counterpart of the JAX package's parallel/train.py).

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
- **Meshes** (`shard_state`, `make_train_step(mesh=...)`) keep JAX's SPMD
  semantics: the sharded step computes what the one-device step computes
  on the whole batch. `shard_state` keeps one master copy of each leaf
  (`ShardedParams`): a leaf the rules split over ``tp``
  (mesh.default_param_rules) as its slices on the tp devices, any other
  whole on the first, as serving/sharding's groups store theirs (N28);
  the optimizer is built again over these, each moment beside its
  slice. Each step runs one thread per dp shard this process drives:
  the thread gathers every leaf whole onto its shard's device (``.to()``
  and ``torch.cat``, both differentiable; counted in the step's
  `moves`) and runs `loss_fn` on its rows under `layers.batch_stats`,
  whose reduction sums train-mode BN's statistics over the shards on the
  first shard's device and sends the totals back: the global batch's
  statistics, as JAX's jit gives a dp-sharded batch (per-shard
  statistics would be another result). The loss is the shards' losses,
  each weighted by its share of the global batch, summed on that device
  (`loss_fn` is a mean over the batch's rows, as every zoo loss is). One
  ``backward()`` leaves the global gradient on the master leaves, and the
  optimizer steps each slice where it lives.
- **Across processes** (parallel/multihost.py's global mesh): a process
  runs the dp shards of its own devices; BN's sums and the loss are
  summed over the processes with torch.distributed inside the graph, the
  gradient after ``backward()``, so every process holds the serial
  step's parameters.
"""

from __future__ import annotations

import copy
import functools
import inspect
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.parallel.mesh import (
    FnCall, Mesh, Moves, Spec, default_param_rules, param_leaves,
    rebuild_tree, shard_params)

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
    their insertion order); `ShardedParams`' master tensors (each leaf's
    slices in order, leaf after leaf in that order)."""
    if isinstance(params, ShardedParams):
        return params.masters()
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


def make_train_step(loss_fn: LossFn, optimizer: Optimizer = None,
                    mesh: Optional[Mesh] = None,
                    batch_spec: Optional[Sequence[Spec]] = None):
    """Build `step(state, *batch) -> (state, loss)`: the loss at the
    current parameters, then one optimizer update of every leaf in place
    (the state comes back updated; `loss` is a detached scalar on the
    parameters' device). `optimizer` is the factory `init_state` was
    given (JAX's signature): the optimizer it built rides in the state,
    with the moments.

    With a mesh the state must come from `shard_state` and the step is a
    `ShardedStep`; `batch_spec` gives each batch argument's spec (the
    port's: per dim the mesh axis it is split over; ``("dp",)`` splits
    the leading dim over dp, ``()`` gives every shard the whole
    argument), by default ``("dp",)`` for each."""
    if mesh is not None:
        return ShardedStep(loss_fn, mesh, batch_spec)

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


# -- meshes -------------------------------------------------------------------

def leaf_paths(params) -> List[str]:
    """The path of each of `leaves(params)` (state-dict names for a
    module, ``/``-joined keys for a tree: `mesh.param_leaves`' paths)."""
    if isinstance(params, nn.Module):
        return [n for n, _ in params.named_parameters()] + \
            [n for n, _ in params.named_buffers()]
    return [p for p, _ in param_leaves(params)]


@dataclass
class ShardedParams:
    """A params tree placed on a mesh: each leaf's master copy
    (`mesh.shard_params`' {path: {"spec", "dim", "parts"}}: a split
    leaf's slices on `devices` in order, a whole leaf on the first), the
    leaf paths in `leaves()` order of the unsharded params, and the
    params on the meta device to rebuild them from whole leaves."""

    placed: Dict[str, dict]
    order: List[str]
    template: Any
    devices: list
    ordinals: List[int]
    _skeletons: Dict[int, Any] = field(default_factory=dict, repr=False)

    def masters(self) -> List[torch.Tensor]:
        return [p for path in self.order for p in self.placed[path]["parts"]]

    def whole(self, device, moves: Optional[Moves] = None,
              ordinal: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """{path: the whole leaf on `device`}: a split leaf's slices
        concatenated in order, differentiable (a step's gather; `moves`
        counts the copies to logical device `ordinal`)."""
        moves = moves if moves is not None else Moves()
        dst = self.ordinals[0] if ordinal is None else ordinal
        out = {}
        for path in self.order:
            leaf = self.placed[path]
            moved = [moves.to(p, device, o, dst)
                     for p, o in zip(leaf["parts"], self.ordinals)]
            out[path] = moved[0] if leaf["dim"] is None else \
                torch.cat(moved, dim=leaf["dim"])
        return out

    def call(self, shard: int, fn: Callable, full: Dict[str, torch.Tensor],
             *xs):
        """``fn(params, *xs)`` with the params rebuilt from `full`: a
        module through `torch.func.functional_call` on a skeleton of this
        shard's own (the call swaps attributes, so no two threads share
        one), a tree rebuilt."""
        if not isinstance(self.template, nn.Module):
            return fn(rebuild_tree(self.template, full), *xs)
        skel = self._skeletons.get(shard)
        if skel is None:
            skel = self._skeletons[shard] = FnCall(
                fn, copy.deepcopy(self.template))
        skel.fn = fn
        return torch.func.functional_call(
            skel, {"m." + k: v for k, v in full.items()}, xs)

    def unsharded(self, device):
        """Detached whole leaves on `device` as the params they came
        from: a module (its state dict loaded into a copy of the
        template) or the tree."""
        full = {k: v.detach().clone() for k, v in
                self.whole(device).items()}
        if isinstance(self.template, nn.Module):
            module = copy.deepcopy(self.template).to_empty(device=device)
            module.load_state_dict(full, strict=True)
            return module
        return rebuild_tree(self.template, full)


def _optimizer_like(old: torch.optim.Optimizer, params) -> torch.optim.Optimizer:
    """An optimizer of `old`'s type and hyperparameters over `params`."""
    accepted = inspect.signature(type(old).__init__).parameters
    kw = {k: v for k, v in old.param_groups[0].items()
          if k != "params" and k in accepted}
    return type(old)(params, **kw)


def _moment_part(k: str, v, dim, n: int, i: int, device):
    """Part i of one optimizer state entry: a moment (every entry but
    torch's ``step`` count, which stays as it is) cut as its leaf is and
    placed beside the part."""
    if not isinstance(v, torch.Tensor):
        return v
    if k == "step":
        return v.detach().clone()
    if dim is not None:
        v = torch.chunk(v.detach(), n, dim=dim)[i]
    return v.detach().to(device, copy=True).contiguous()


def shard_state(state: TrainState, mesh: Mesh, rules=None) -> TrainState:
    """Place a TrainState on the mesh: the params by `rules` (default
    `mesh.default_param_rules`) over the ``tp`` devices of this
    process's first dp shard, the optimizer built again over the placed
    leaves with every moment cut and placed as its leaf is (JAX's
    ``place_opt``), the step as it is."""
    params = state.params
    if isinstance(params, ShardedParams):
        return state
    rules = rules if rules is not None else default_param_rules()
    first = _local_shards(mesh)[0]
    at = {"dp": first}
    placed = shard_params(params, mesh, "tp", rules, at=at)
    for leaf in placed.values():
        for p in leaf["parts"]:
            p.requires_grad_(True)
    from nnstreamer_tpu_torch.backends.torch_backend import params_on_meta

    sp = ShardedParams(placed=placed, order=leaf_paths(params),
                       template=params_on_meta(params),
                       devices=mesh.along("tp", at),
                       ordinals=mesh.ordinals_along("tp", at))
    old = state.opt_state
    opt = _optimizer_like(old, sp.masters())
    for path, leaf in zip(sp.order, leaves(params)):
        st = old.state.get(leaf)
        if not st:
            continue
        pl = placed[path]
        n = len(pl["parts"])
        for i, part in enumerate(pl["parts"]):
            opt.state[part] = {k: _moment_part(k, v, pl["dim"], n, i,
                                               part.device)
                               for k, v in st.items()}
    return TrainState(step=state.step, params=sp, opt_state=opt)


def unshard_state(state: TrainState, device=None) -> TrainState:
    """The inverse of `shard_state`: whole leaves on `device` (default:
    the first master's), the optimizer over them with every moment's
    slices concatenated. What a checkpoint of a sharded state holds, so
    it resumes with a mesh or without one."""
    sp = state.params
    if not isinstance(sp, ShardedParams):
        return state
    device = device if device is not None else sp.devices[0]
    params = sp.unsharded(device)
    ls = leaves(params)
    for t in ls:
        t.requires_grad_(True)
    old = state.opt_state
    opt = _optimizer_like(old, ls)
    for path, leaf in zip(sp.order, ls):
        parts = sp.placed[path]["parts"]
        sts = [old.state.get(p) for p in parts]
        if not all(sts):
            continue
        dim = sp.placed[path]["dim"]
        merged = {}
        for k, v in sts[0].items():
            if not isinstance(v, torch.Tensor) or k == "step":
                merged[k] = v.detach().clone() \
                    if isinstance(v, torch.Tensor) else v
            elif dim is None:
                merged[k] = v.detach().to(device, copy=True)
            else:
                merged[k] = torch.cat([s[k].detach().to(device)
                                       for s in sts], dim=dim)
        opt.state[leaf] = merged
    return TrainState(step=state.step, params=params, opt_state=opt)


def _local_shards(mesh: Mesh) -> List[int]:
    """The dp indices whose devices this process drives (every one on a
    mesh of one process)."""
    from nnstreamer_tpu_torch.parallel.multihost import process_index

    owners = mesh.processes_along("dp")
    rank = process_index() if max(owners) > 0 else 0
    mine = [d for d, p in enumerate(owners) if p == rank]
    if not mine:
        raise PipelineError(
            f"process {rank} drives no dp shard of the mesh {mesh.shape}")
    return mine


class _StatsGroup:
    """One step's shard threads and their reductions for train-mode BN
    (across processes too: `multihost.all_reduce`).

    The threads take turns, a baton passed in shard order: one runs until
    its next reduction, hands its per-channel sums in and passes the
    baton on. The last shard's thread sums them on the first shard's
    device — always that thread, so the graph and the order of every sum
    are the same each step — and passes the baton back to shard 0; each
    shard takes the mean to its own device when its turn comes again.
    One thread runs at a time: on the GIL they would run one after
    another anyway, and taking turns spares them a switch at every
    launch."""

    def __init__(self, step: "ShardedStep", n: int):
        self.step = step
        self.n = n
        self.slots: List[Optional[torch.Tensor]] = [None] * n
        self.counts = [0] * n
        self.mean_: Optional[torch.Tensor] = None
        self.turns = [threading.Event() for _ in range(n)]
        self.turns[0].set()
        self.failed = False

    def wait_turn(self, j: int) -> None:
        self.turns[j].wait()
        self.turns[j].clear()
        if self.failed:
            raise PipelineError("sharded train step: another shard failed")

    def pass_turn(self, j: int) -> None:
        self.turns[(j + 1) % self.n].set()

    def fail(self) -> None:
        self.failed = True
        for t in self.turns:
            t.set()

    def mean(self, j: int, sums: torch.Tensor, count: int) -> torch.Tensor:
        self.slots[j], self.counts[j] = sums, count
        if j == self.n - 1:
            self._reduce()
        self.pass_turn(j)
        self.wait_turn(j)
        st = self.step
        return st.moves.to(self.mean_, st.devices[j], st.ordinals[0],
                           st.ordinals[j])

    def _reduce(self) -> None:
        from nnstreamer_tpu_torch.parallel.multihost import all_reduce

        st = self.step
        total = None
        for j, t in enumerate(self.slots):
            t = st.moves.to(t, st.devices[0], st.ordinals[j], st.ordinals[0])
            total = t if total is None else total + t
        if st.world > 1:
            total = all_reduce(total)
        self.mean_ = total / (sum(self.counts) * st.world)


class ShardedStep:
    """`make_train_step(mesh=...)`: ``step(state, *batch) -> (state,
    loss)`` over the dp shards this process drives (module docstring).
    `moves` counts the copies between logical devices."""

    def __init__(self, loss_fn: LossFn, mesh: Mesh,
                 batch_spec: Optional[Sequence[Spec]] = None):
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.batch_spec = batch_spec
        self.shards = _local_shards(mesh)
        devs, ords = mesh.along("dp"), mesh.ordinals_along("dp")
        self.devices = [devs[d] for d in self.shards]
        self.ordinals = [ords[d] for d in self.shards]
        self.world = int(mesh.processes.max()) + 1
        self.moves = Moves()

    def _split(self, b, spec, j: int):
        axis = spec[0] if spec else None
        if axis is None:
            return b
        if axis != "dp" or any(a is not None for a in spec[1:]):
            raise PipelineError(
                f"batch_spec {tuple(spec)}: the port splits a batch "
                f"argument's leading dim over dp, or gives it whole (())")
        n = len(self.shards)
        if b.shape[0] % n:
            raise PipelineError(
                f"a batch of {b.shape[0]} rows does not split over {n} dp "
                f"shards")
        k = b.shape[0] // n
        return b[j * k:(j + 1) * k]

    def __call__(self, state: TrainState, *batch):
        from nnstreamer_tpu_torch.models import layers
        from nnstreamer_tpu_torch.parallel.multihost import (
            GlobalBatch, all_reduce_)

        sp = state.params
        if not isinstance(sp, ShardedParams):
            raise PipelineError(
                "make_train_step(mesh=...) takes a state placed by "
                "shard_state")
        specs = list(self.batch_spec) if self.batch_spec is not None \
            else [("dp",)] * len(batch)
        local = [b.local if isinstance(b, GlobalBatch) else b for b in batch]
        local = [b if isinstance(b, torch.Tensor) else torch.as_tensor(b)
                 for b in local]
        n = len(self.shards)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        group = _StatsGroup(self, n)
        losses: List[Optional[torch.Tensor]] = [None] * n

        def run(j):
            dev, o = self.devices[j], self.ordinals[j]
            try:
                group.wait_turn(j)
                xs = []
                for b, s in zip(local, specs):
                    part = self._split(b, s, j)
                    xs.append(part.to(dev, non_blocking=True)
                              if part.device.type == "cpu" else
                              self.moves.to(part, dev, self.ordinals[0], o))
                with torch.enable_grad(), layers.batch_stats(
                        functools.partial(group.mean, j)):
                    full = sp.whole(dev, self.moves, o)
                    loss = sp.call(j, self.loss_fn, full, *xs)
                # equal shards: the global batch's mean
                losses[j] = loss / (n * self.world)
            except BaseException:
                group.fail()
                raise
            group.pass_turn(j)

        if n == 1:
            run(0)
        else:
            with ThreadPoolExecutor(n, thread_name_prefix="train-shard") \
                    as ex:
                for f in [ex.submit(run, j) for j in range(n)]:
                    f.result()
        with torch.enable_grad():
            total = None
            for j, l in enumerate(losses):
                l = self.moves.to(l, self.devices[0], self.ordinals[j],
                                  self.ordinals[0])
                total = l if total is None else total + l
            total.backward()
        masters = sp.masters()
        for t in masters:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        if self.world > 1:
            flat = torch.cat([t.grad.reshape(-1) for t in masters])
            all_reduce_(flat)
            for t, g in zip(masters, flat.split([t.numel() for t in masters])):
                t.grad.copy_(g.view_as(t))
        opt.step()
        state.step += 1
        loss = total.detach()
        return state, (all_reduce_(loss) if self.world > 1 else loss)

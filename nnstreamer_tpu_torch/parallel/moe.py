"""Mixture-of-Experts with expert parallelism over the ``ep`` axis of a
mesh (counterpart of the JAX package's parallel/moe.py).

Experts live on different devices; tokens travel to their expert and
back. Switch-transformer-style, as JAX's:

- top-1 gating (softmax in f32; `argmax` takes the first maximum in
  both packages) with a fixed per-expert capacity
  C = max(1, ceil(capacity_factor · t_local / E)); a shard's tokens over
  an expert's capacity, in arrival order, are dropped from the expert
  path: their output is exactly zero (the caller's residual carries
  them);
- tokens are sharded over ``ep`` too (each device owns tokens and hosts
  E/ep experts). Each token owner fills an (E, C, d) buffer by index
  (JAX fills it with a one-hot einsum, a TPU choice: routing here is
  an index_put and a gather, ROADMAP N39; a dropped token's row goes to
  a spare slot and its output is selected away, so nothing waits on
  the host to count the kept tokens). JAX's first `all_to_all` becomes
  a copy of each expert group's block of that buffer to the group's
  device; there each group runs its experts over the (E/ep, ep·C, d)
  blocks it received as one batched product, `gelu` in its tanh form
  (`jax.nn.gelu`'s default); the second `all_to_all` copies each
  sender's block of the result back; the owner gathers every kept
  token's row and scales it by its gate probability. The copies are
  ``.to(dev, non_blocking=True)``, counted in `MOE_MOVES`.
- slot positions count in int64 whatever the activation dtype (JAX:
  int32), so no bf16 rounding merges two tokens' slots.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.parallel.mesh import Mesh, Moves, Spec

#: copies between the shards' logical devices, over every call
MOE_MOVES = Moves()


def init_moe_params(generator: torch.Generator, d_model: int,
                    d_hidden: int, n_experts: int,
                    dtype: torch.dtype = torch.float32,
                    device: Optional[torch.device] = None
                    ) -> Dict[str, torch.Tensor]:
    """{"gate": (d, E), "w1": (E, d, h), "w2": (E, h, d)} from
    `generator`: normals scaled by d^-0.5 (gate, w1) and h^-0.5 (w2), as
    JAX's init (`jax.random` draws cannot be reproduced here; parity
    runs carry JAX's params across with models/bridge.moe_params)."""
    s = d_model ** -0.5

    def normal(*shape):
        return torch.randn(*shape, generator=generator)

    out = {"gate": normal(d_model, n_experts) * s,
           "w1": normal(n_experts, d_model, d_hidden) * s,
           "w2": normal(n_experts, d_hidden, d_model) * d_hidden ** -0.5}
    return {k: v.to(device=device, dtype=dtype) for k, v in out.items()}


def moe_param_specs() -> Dict[str, Spec]:
    """Sharding rules: experts over ep, gate replicated."""
    return {"gate": (), "w1": ("ep",), "w2": ("ep",)}


def _route(x: torch.Tensor, gate_w: torch.Tensor, n_experts: int,
           capacity: int):
    """Top-1 routing for local tokens x: (t, d) → (expert (t,) int64,
    slot (t,) int64: the token's place in its expert's buffer in arrival
    order, keep (t,) bool: slot < capacity, p (t,) in x's dtype: the gate
    probability)."""
    logits = x @ gate_w                                   # (t, E)
    probs = torch.softmax(logits.float(), dim=-1)
    expert = probs.argmax(dim=-1)                         # first maximum
    p = probs.max(dim=-1).values
    counts = F.one_hot(expert, n_experts)                 # (t, E) int64
    slot = ((counts.cumsum(dim=0) - 1) * counts).sum(dim=-1)
    return expert, slot, slot < capacity, p.to(x.dtype)


def moe_apply(params, x: torch.Tensor, *, mesh: Mesh, axis: str = "ep",
              capacity_factor: float = 1.25) -> torch.Tensor:
    """Expert-parallel MoE layer. x: (T, d), T split over the `axis`
    devices in order; params per init_moe_params, w1/w2 split over
    `axis` on dim 0 (expert group g on the axis's g-th device). Returns
    (T, d) on x's device. Add the residual outside."""
    n = mesh.shape[axis]
    n_experts = params["w1"].shape[0]
    if n_experts % n:
        raise ValueError(
            f"{n_experts} experts do not divide over ep={n} devices")
    if x.shape[0] % n:
        raise ValueError(
            f"{x.shape[0]} tokens do not divide over ep={n} devices")
    t_local = x.shape[0] // n
    capacity = max(1, math.ceil(capacity_factor * t_local / n_experts))
    devs, ords = mesh.along(axis), mesh.ordinals_along(axis)
    moves = MOE_MOVES
    e_local = n_experts // n
    home = ords[0]
    w1 = [moves.to(params["w1"][g * e_local:(g + 1) * e_local], devs[g],
                   home, ords[g]) for g in range(n)]
    w2 = [moves.to(params["w2"][g * e_local:(g + 1) * e_local], devs[g],
                   home, ords[g]) for g in range(n)]
    # token owners: route, fill the (E, C, d) buffer by index
    routes, sent = [], []
    for i in range(n):
        xs = moves.to(x[i * t_local:(i + 1) * t_local], devs[i], home,
                      ords[i])
        expert, slot, keep, p = _route(
            xs, moves.to(params["gate"], devs[i], home, ords[i]),
            n_experts, capacity)
        # a dropped token lands on a spare last row (no host sync to
        # count the kept ones)
        flat = torch.where(keep, expert * capacity + slot,
                           n_experts * capacity)
        buf = xs.new_zeros((n_experts * capacity + 1, xs.shape[1]))
        buf[flat] = xs
        routes.append((flat, keep, p))
        sent.append(buf[:-1].view(n_experts, capacity, xs.shape[1]))
    # exchange 1: each expert group's block to its owner → (E/n, n·C, d)
    ys = []
    for g in range(n):
        recv = torch.cat([moves.to(sent[i][g * e_local:(g + 1) * e_local],
                                   devs[g], ords[i], ords[g])
                          for i in range(n)], dim=1)
        h = F.gelu(torch.einsum("ecd,edh->ech", recv, w1[g]),
                   approximate="tanh")
        ys.append(torch.einsum("ech,ehd->ecd", h, w2[g]))
    # exchange 2: each sender's C slots back → (E, C, d); combine
    outs = []
    for i, (flat, keep, p) in enumerate(routes):
        back = torch.cat([moves.to(ys[g][:, i * capacity:(i + 1) * capacity],
                                   devs[i], ords[g], ords[i])
                          for g in range(n)], dim=0)
        rows = back.reshape(-1, back.shape[-1])[
            flat.clamp(max=n_experts * capacity - 1)]
        out = torch.where(keep[:, None], rows * p[:, None],
                          rows.new_zeros(()))
        outs.append(moves.to(out, x.device, ords[i], home))
    return torch.cat(outs, dim=0)


def reference_moe(params, x: torch.Tensor) -> torch.Tensor:
    """Serial ground truth (no capacity drops): every token goes to its
    argmax expert, scaled by the gate prob."""
    logits = x @ params["gate"]
    probs = torch.softmax(logits.float(), dim=-1)
    expert = probs.argmax(dim=-1)
    p = probs.max(dim=-1).values.to(x.dtype)
    h = F.gelu(torch.einsum("td,edh->teh", x, params["w1"]),
               approximate="tanh")
    y = torch.einsum("teh,ehd->ted", h, params["w2"])     # (t, E, d)
    sel = y[torch.arange(y.shape[0], device=y.device), expert]
    return sel * p[:, None]

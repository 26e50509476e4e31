"""Sharded serving: one model across N devices (``shards=N``), the
counterpart of the JAX package's serving/sharding.py — the dense filter
path (`ShardedBackend`, `ShardedReplicaSet`) and the paged LLM path.

**Dense path** (`ShardedBackend`): any ``fn(params, *inputs)`` model
serves sharded by storing its params through parallel/mesh.py's
`shard_params` under `dense_shard_rules` (a conv's output channels, the
classifier's input features, the column/row rules of 2-D dense weights;
what a group does not divide stays whole): each split leaf lives as its
contiguous slices, slice i on the group's device i. Each invoke gathers
the split leaves onto the group's first ("home") device —
``torch.cat`` of the slices in their fixed order, pure data movement —
and runs the unmodified model on them (`torch.func.functional_call` for
an nn.Module), so the output equals the one-device output bit for bit
for ANY model. Storage is partitioned; the gathered copy lives on the
home device for the invoke (the JAX package gathers inside its SPMD
program, ROADMAP N28). `ShardedReplicaSet` (``devices=M shards=N``)
puts M/N such groups behind the `ReplicaSet` front door, each leasing
its devices from a `ChipLeaseTable`; fencing any member device fences
its whole group, and its queued work re-offers to the others.

**Canonical blocking — the bit-parity mechanism.** Every sharded weight
is cut into a FIXED number of blocks (``FIXED_BLOCKS = 8``, the largest
supported group) along its tensor-parallel axis: wq/wk/wv and the SwiGLU
gate/up column-wise per head/feature block, wo/wd row-wise per block,
the LM head column-wise per vocab block. A group of N devices holds 8/N
contiguous blocks each, and the computation is a loop over *blocks*,
never over shards: per-block products have shapes that do not depend on
N, row-parallel partial sums are gathered in the fixed global block order
and reduced by a fixed chain of adds, column-parallel outputs are
concatenated in block order. Numerics are a function of the block count,
a constant, so ``shards=N`` outputs are bit-identical to ``shards=1``.

**One controller.** The JAX package runs this as one `shard_map` program
per call. The port drives the N devices from one process: each shard's
blocks and its slice of the paged KV pool (split on the kv-head axis)
live on its device (serving/placement.visible_devices, which may map
several logical devices onto one card); the residual stream, the norms
and the embedding live on the group's first device (the "home" device),
from which each layer's normed activations are copied to every shard
device, and to which the shards' partial sums are copied back for the
fixed-order combine. No `torch.distributed`, no NCCL.

**Ring prefill.** Prompts at or past ``ring_prefill_min`` tokens prefill
through sequence-parallel ring attention over the same devices
(`ring_prefill`, parallel/ring_attention.py): the unblocked projections
run on the home device, where the executor holds the raw params (the
JAX package replicates them over the group for its SPMD program; one
controller needs one copy), and the attention of every layer runs as a
ring over the shard devices. Its online softmax reassociates, so the ring
is equivalent math (allclose), not bit-exact; the blocked path is the
parity anchor.

The sharded decode and prefill attention is plain torch (the JAX
package's einsum), not a kernel; the ring's step is the
`flash_block_update` kernel on CUDA tensors.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.llm.paged_model import _rope_rows
from nnstreamer_tpu_torch.models.transformer import (
    _expand_kv, _mlp, _qkv, attend, rmsnorm, rope)
from nnstreamer_tpu_torch.serving.placement import (
    VIRTUAL_DEVICES_HINT, ChipLeaseTable, ReplicaSet, device_of,
    visible_devices)

log = get_logger("serving.sharding")

#: canonical block count: numerics depend on this constant, never on the
#: shard count, so any N dividing it serves bit-identical outputs
FIXED_BLOCKS = 8

#: shard counts the blocked layout supports (divisors of FIXED_BLOCKS)
SUPPORTED_SHARDS = (1, 2, 4, 8)

#: the blocked leaves of a layer (the rest stay whole)
_BLOCKED = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def validate_shards(n: int) -> int:
    n = int(n)
    if n not in SUPPORTED_SHARDS:
        raise BackendError(
            f"shards={n}: supported counts are {SUPPORTED_SHARDS} (divisors "
            f"of the canonical block count {FIXED_BLOCKS})")
    return n


def shard_devices(indices: Sequence[int]) -> List[torch.device]:
    """The devices of a shard group's logical ordinals (typed error past
    the visible ones, naming ``[parallel] virtual_devices``)."""
    return [device_of(int(i)) for i in indices]


# -- the dense path: split storage, gathered on use ----------------------------

def dense_shard_rules():
    """Column/row rules for dict-tree dense params (the JAX layout:
    ``w1``-style names split the output axis, ``w2``/``wo``/``wd`` the
    input axis), layered over parallel/mesh.default_param_rules (the
    conv and classifier rules under the port's names)."""
    from nnstreamer_tpu_torch.parallel.mesh import default_param_rules

    return (
        ("w1", (None, "tp")),
        ("wi", (None, "tp")),
        ("wqkv", (None, "tp")),
        ("w2", ("tp", None)),
        ("wo", ("tp", None)),
        ("wd", ("tp", None)),
    ) + tuple(default_param_rules())


class _Call(torch.nn.Module):
    """The unmodified model fn over a module: `functional_call` swaps in
    the gathered params and buffers under the ``m.`` prefix."""

    def __init__(self, fn, module: torch.nn.Module):
        super().__init__()
        self.fn = fn
        self.m = module

    def forward(self, *xs):
        return self.fn(self.m, *xs)


def _rebuild(tree, full: Dict[str, torch.Tensor], path=()):
    """`tree` (dict/list/tuple of leaves) with every leaf replaced by
    ``full[<its /-joined path>]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, full, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, full, path + (str(i),))
                          for i, v in enumerate(tree))
    key = "/".join(path)
    return full.get(key, tree)


class ShardedBackend:
    """One model served from one shard group of N logical devices.

    Its params are stored split over the group (`shard_params` under
    `dense_shard_rules`); each invoke gathers the split leaves onto the
    home device in their fixed order and runs the unmodified model fn,
    so outputs are those of the one-device backend bit for bit and each
    device stores 1/N of every split weight.

    The store handle protocol, as the torch backend's:
    `prewarm_version` places the incoming version and runs it once on
    every input signature this group served, before the store's epoch
    flips (a failure raises there: nothing flipped); `maybe_adopt` flips
    at the next invoke, and a flip after a prewarm runs nothing for the
    first time."""

    def __init__(self, model, device_indices: Sequence[int], *,
                 name: str = "sharded"):
        from nnstreamer_tpu_torch.parallel.mesh import Mesh

        self.name = name
        self.device_indices = tuple(int(i) for i in device_indices)
        self.shards = validate_shards(len(self.device_indices))
        self.devices = shard_devices(self.device_indices)
        self.home = self.devices[0]
        self.mesh = Mesh(np.array(self.devices, dtype=object), ("tp",))
        self.invokes = 0
        self.invoke_failures = 0
        self.adopted_epoch = -1
        self.swap_count = 0
        self.staging_transfers = 0
        self.staging_elided = 0
        self._lock = threading.Lock()
        #: (version, input signature) pairs run once (the JAX package's
        #: compiles: one per SPMD executable)
        self._ran: set = set()
        #: version → {"placed", "fn", "skeleton", "tree", "host_pre"}
        self._vers: Dict[Any, dict] = {}
        self._entry = None
        self._pinned = None
        self._version: Any = None
        self._bind(model)

    # -- model binding -------------------------------------------------------
    def _bind(self, model) -> None:
        if isinstance(model, str) and model.startswith("store://"):
            from nnstreamer_tpu_torch.serving.store import (
                get_store, parse_store_ref)

            ref = parse_store_ref(model)
            self._entry = get_store().entry(ref.name)
            if ref.version is not None:
                self._pinned = self._entry.resolve_version(ref.version)
                self._version = self._pinned
            else:
                cur, epoch = self._entry.state
                self._version, self.adopted_epoch = cur, epoch
            if self._version is None:
                raise BackendError(
                    f"sharded backend: store model {ref.name!r} has no "
                    f"versions registered")
            self._vers[self._version] = self._place(
                self._entry.bundle(self._version))
            self._entry.attach(self)
            return
        # anything else (zoo://, ModelBundle, callables, model files)
        # resolves through the torch backend's model resolution
        from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend

        self._version = None
        self._vers[None] = self._place(TorchBackend()._resolve(model))

    def _place(self, bundle) -> dict:
        """Split a version's params over the group (copies; the bundle
        stays the store's)."""
        from nnstreamer_tpu_torch.backends.torch_backend import (
            params_on_meta)
        from nnstreamer_tpu_torch.parallel.mesh import shard_params

        params = bundle.params
        ver = {"fn": bundle.fn, "host_pre": getattr(bundle, "host_pre", None),
               "placed": {}, "skeleton": None, "tree": params}
        if params is None:
            return ver
        ver["placed"] = shard_params(params, self.mesh, "tp",
                                     dense_shard_rules())
        if isinstance(params, torch.nn.Module):
            ver["skeleton"] = _Call(bundle.fn, params_on_meta(params).eval())
        return ver

    def _gather(self, ver: dict) -> Dict[str, torch.Tensor]:
        """Every leaf whole on the home device: a split leaf's slices
        concatenated in device order, a whole one as stored."""
        full = {}
        for path, leaf in ver["placed"].items():
            parts = leaf["parts"]
            if leaf["dim"] is None:
                full[path] = parts[0]
            else:
                full[path] = torch.cat(
                    [p.to(self.home, non_blocking=True) for p in parts],
                    dim=leaf["dim"])
        return full

    @property
    def tracks_store_epoch(self) -> bool:
        return self._entry is not None and self._pinned is None

    def shard_bytes(self) -> List[int]:
        """Bytes of params stored on each device of the group, in group
        order (whole leaves count on the home device)."""
        out = [0] * len(self.devices)
        with self._lock:
            vers = list(self._vers.values())
        for ver in vers:
            for leaf in ver["placed"].values():
                for i, p in enumerate(leaf["parts"]):
                    out[i] += p.numel() * p.element_size()
        return out

    def resident_bytes(self) -> int:
        return sum(self.shard_bytes())

    # -- store handle protocol -----------------------------------------------
    def maybe_adopt(self) -> None:
        if not self.tracks_store_epoch:
            return
        cur, epoch = self._entry.state
        if epoch == self.adopted_epoch:
            return
        with self._lock:
            if cur not in self._vers:        # flip without a prewarm
                self._vers[cur] = self._place(self._entry.bundle(cur))
            for v in [v for v in self._vers
                      if v not in (cur, self._pinned)]:
                del self._vers[v]
            self._version, self.adopted_epoch = cur, epoch
            self.swap_count += 1
        log.info("sharded %s adopted %s@%s epoch=%d", self.name,
                 self._entry.name, cur, epoch)

    def prewarm_version(self, version, bundle) -> int:
        """Swap controller hook: place the incoming version over the
        group and run it once on every input signature the group has
        served, before the flip (a failure raises here). → signatures
        run."""
        with self._lock:
            self._vers[version] = self._place(bundle)
            served = sorted({k[1] for k in self._ran})
        warmed = 0
        for sig in served:
            xs = tuple(torch.zeros(shape, dtype=dt, device=self.home)
                       for shape, dt in sig)
            self._run(xs, version)
            warmed += 1
        return warmed

    # -- execution -------------------------------------------------------------
    def _run(self, xs: tuple, version) -> tuple:
        ver = self._vers[version]
        sig = tuple((tuple(x.shape), x.dtype) for x in xs)
        self._ran.add((version, sig))
        with torch.inference_mode():
            if ver["skeleton"] is not None:
                full = {"m." + k: v for k, v in self._gather(ver).items()}
                out = torch.func.functional_call(ver["skeleton"], full, xs)
            elif ver["placed"]:
                out = ver["fn"](_rebuild(ver["tree"], self._gather(ver)),
                                *xs)
            else:
                out = ver["fn"](ver["tree"], *xs)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def invoke(self, inputs: tuple) -> tuple:
        from nnstreamer_tpu_torch.backends.torch_backend import stage

        self.maybe_adopt()
        version = self._version
        try:
            pre = self._vers[version]["host_pre"]
            if pre is not None:
                inputs = pre(tuple(inputs))
            xs, moved = stage(inputs, self.home)
            self.staging_transfers += moved
            self.staging_elided += len(xs) - moved
            out = self._run(xs, version)
        except BackendError:
            self.invoke_failures += 1
            raise
        self.invokes += 1
        return out

    def invoke_batched(self, inputs: tuple, n: int, keepdims) -> tuple:
        # the group serves the stacked batch as one invocation; the
        # batching semantics (stack axis, keepdims) are the caller's
        return self.invoke(inputs)

    # -- lifecycle -------------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """(version, input signature) pairs run for the first time."""
        return len(self._ran)

    def warm_start(self) -> None:
        return None

    def close(self) -> None:
        if self._entry is not None:
            try:
                self._entry.detach(self)
            except Exception:
                pass
        with self._lock:
            self._vers.clear()

    def stats(self) -> dict:
        return {
            "devices": list(self.device_indices),
            "shards": self.shards,
            "invokes": self.invokes,
            "compile_count": self.compile_count,
            "adopted_epoch": self.adopted_epoch,
            "swap_count": self.swap_count,
            "shard_bytes": self.shard_bytes(),
        }


class ShardedReplicaSet(ReplicaSet):
    """G shard groups of N devices each behind the ReplicaSet front door.

    Each "replica" is one `ShardedBackend`, so routing, backpressure,
    the re-offer path and the conservation ledger are the ReplicaSet's;
    what changes is the unit of failure: `fence_device(d)` fences the
    device's whole GROUP (a group cannot serve without one of its
    slices), its lease rows go fenced in the group's `ChipLeaseTable`,
    and the stranded work re-routes to the surviving groups."""

    def __init__(self, backends, group_devices: List[Tuple[int, ...]],
                 leases: Optional[ChipLeaseTable] = None, **kw):
        self.group_devices = [tuple(g) for g in group_devices]
        self.leases = leases
        super().__init__(backends, list(range(len(backends))), **kw)

    @classmethod
    def open_sharded(cls, model, *, shards: int, groups: int = 0,
                     leases: Optional[ChipLeaseTable] = None,
                     queue_cap: int = 64, name: str = "sharded",
                     tracer=None) -> "ShardedReplicaSet":
        """Open `groups` shard groups of `shards` devices (0 = as many as
        the visible devices fit, at least one), each leasing its devices
        from `leases` under one owner (a fresh table over the visible
        devices when the caller shares none)."""
        shards = validate_shards(shards)
        ndev = len(visible_devices())
        if groups <= 0:
            groups = max(1, ndev // shards)
        if groups * shards > ndev:
            raise BackendError(
                f"shards={shards} x {groups} groups needs "
                f"{groups * shards} devices, {ndev} visible; "
                f"{VIRTUAL_DEVICES_HINT}")
        if leases is None:
            leases = ChipLeaseTable(range(ndev))
        store_name = ""
        if isinstance(model, str) and model.startswith("store://"):
            store_name = model[len("store://"):].split("@", 1)[0]
        backends, group_devs = [], []
        try:
            for g in range(groups):
                chips = leases.lease(f"{name}/g{g}", shards)
                b = ShardedBackend(model, chips, name=f"{name}/g{g}")
                backends.append(b)
                group_devs.append(chips)
        except Exception:
            for g, b in enumerate(backends):
                try:
                    b.close()
                except Exception:
                    pass
                leases.release(f"{name}/g{g}")
            raise
        return cls(backends, group_devs, leases, queue_cap=queue_cap,
                   bucket=1, name=name, tracer=tracer,
                   store_name=store_name)

    def group_of(self, chip: int) -> Optional[int]:
        for g, devs in enumerate(self.group_devices):
            if int(chip) in devs:
                return g
        return None

    def fence_device(self, chip: int, cause: str = "fenced") -> bool:
        """A member device died: fence its whole shard group — the lease
        rows and the routing replica — so conservation flows through the
        inherited re-offer path."""
        g = self.group_of(chip)
        if g is None:
            return False
        if self.leases is not None:
            self.leases.fence(f"{self.name}/g{g}")
        return self.fence(g, f"member device {chip} {cause}")

    def stats(self) -> dict:
        out = super().stats()
        # rows stay under "replicas" (filter.extra_stats and the metric
        # scrape read that key); sharding adds fields, not a schema
        for g, row in enumerate(out["replicas"]):
            row["group"] = g
            row["devices"] = list(self.group_devices[g])
            row["shards"] = len(self.group_devices[g])
        out["group_size"] = (len(self.group_devices[0])
                             if self.group_devices else 0)
        if self.leases is not None:
            out["leases"] = self.leases.snapshot()["counts"]
        return out


# -- blocked weights -----------------------------------------------------------

def blocked_transformer_params(params, *, n_heads: int) -> Dict:
    """Re-pack transformer params (models/transformer.init_params layout)
    into the canonical blocked layout: per block b of FIXED_BLOCKS, wq/wk/
    wv hold head-block b's projection columns, wg/wu the SwiGLU gate/up
    feature block, wo/wd the matching row block, head the vocab column
    block — each with the block axis leading, ``(8, …)``. Norms and the
    embedding stay whole."""
    nb = FIXED_BLOCKS
    d = int(params["embed"].shape[1])
    vocab = int(params["head"].shape[1])
    hd = d // n_heads
    kv_dim = (int(params["blocks"][0]["wqkv"].shape[1]) - d) // 2
    n_kv = kv_dim // hd
    d_ff = int(params["blocks"][0]["wd"].shape[0])
    for nm, v in (("n_heads", n_heads), ("n_kv_heads", n_kv),
                  ("d_ff", d_ff), ("vocab", vocab)):
        if v % nb:
            raise BackendError(
                f"shards=N needs {nm}={v} divisible by the canonical block "
                f"count {nb} (models/transformer.init_params geometry)")
    if "wqkv_scale" in params["blocks"][0]:
        raise BackendError(
            "sharded serving is float-only: W8A8-quantized store versions "
            "cannot re-block (per-column scales would split); serve "
            "quantized models unsharded")

    def cols(w):
        # (in, out) → (8, in, out/8) column blocks
        return w.reshape(w.shape[0], nb, -1).permute(1, 0, 2).contiguous()

    def rows(w):
        # (in, out) → (8, in/8, out) row blocks
        return w.reshape(nb, -1, w.shape[1]).contiguous()

    blocks = []
    for blk in params["blocks"]:
        wqkv, wi = blk["wqkv"], blk["wi"]
        blocks.append({
            "ln1": blk["ln1"],
            "wq": cols(wqkv[:, :d]), "wk": cols(wqkv[:, d:d + kv_dim]),
            "wv": cols(wqkv[:, d + kv_dim:]),
            "wo": rows(blk["wo"]),
            "ln2": blk["ln2"],
            "wg": cols(wi[:, :d_ff]), "wu": cols(wi[:, d_ff:]),
            "wd": rows(blk["wd"]),
        })
    return {"embed": params["embed"], "blocks": blocks,
            "ln_f": params["ln_f"], "head": cols(params["head"])}


def shard_llm_params(params, devs: Sequence[torch.device], *, n_heads: int,
                     dtype: torch.dtype = torch.float32) -> Dict:
    """Blocked re-pack + placement over the group: every blocked leaf
    becomes a list with one (8/N, …) slice per shard, on that shard's
    device; the embedding and the norms go to the home device (devs[0]).
    Floats are cast to the activation dtype once (every use casts to it
    anyway)."""
    blocked = blocked_transformer_params(params, n_heads=n_heads)
    n = validate_shards(len(devs))
    per = FIXED_BLOCKS // n
    home = devs[0]

    def split(w):
        return [w[i * per:(i + 1) * per].to(dev, dtype)
                for i, dev in enumerate(devs)]

    return {
        "embed": blocked["embed"].to(home, dtype),
        "ln_f": blocked["ln_f"].to(home, dtype),
        "head": split(blocked["head"]),
        "blocks": [{k: split(v) if k in _BLOCKED else v.to(home, dtype)
                    for k, v in blk.items()}
                   for blk in blocked["blocks"]],
    }


def kv_pool_placer(devs: Sequence[torch.device]):
    """Placement hook for `PagedKVCache(placer=…)`: the pool (L,
    num_blocks, block_size, n_kv, hd) becomes one zeroed slice per shard
    device, split on the kv-head axis, next to the head-blocked
    projections that read and write it."""
    def place(shape, dtype):
        loc = shape[3] // len(devs)
        return [torch.zeros((*shape[:3], loc, shape[4]), dtype=dtype,
                            device=dev) for dev in devs]

    return place


# -- the blocked layer math ------------------------------------------------------

def _combine_rows(parts: List[torch.Tensor], home) -> torch.Tensor:
    """Row-parallel combine with N-independent numerics: the 8 block
    partial sums, in global block order on the home device, reduced by a
    fixed chain of adds (a reduction tied to the shard count would break
    bit-parity)."""
    allp = [p.to(home, non_blocking=True) for p in parts]
    acc = allp[0]
    for p in allp[1:]:
        acc = acc + p
    return acc


def _concat_cols(parts: List[torch.Tensor], home) -> torch.Tensor:
    """Column-parallel combine: the blocks concatenated along the feature
    axis in global block order (exact: pure data movement)."""
    return torch.cat([p.to(home, non_blocking=True) for p in parts], dim=-1)


def _per_shard(t: torch.Tensor, devs) -> List[torch.Tensor]:
    """`t` on every shard device (the tensor itself where it already is)."""
    return [t.to(dev, non_blocking=True) for dev in devs]


def _blocked_mlp(blk, h, devs):
    """SwiGLU with per-block gate/up/down: block b's activation slice
    never meets another block's columns, so the only combine is the final
    fixed-order row sum."""
    parts = []
    for i, hi in enumerate(_per_shard(h, devs)):
        for wg, wu, wd in zip(blk["wg"][i], blk["wu"][i], blk["wd"][i]):
            parts.append((F.silu(hi @ wg) * (hi @ wu)) @ wd)
    return _combine_rows(parts, devs[0])


def _head(params, x, devs):
    """The LM head's vocab blocks, concatenated → f32 logits."""
    xs = _per_shard(x, devs)
    return _concat_cols([xs[i] @ w for i in range(len(devs))
                         for w in params["head"][i]], devs[0]).float()


def _geometry(params, k_pool, hd: int):
    """(local head blocks per shard, q heads per block, kv heads per
    block)."""
    nloc = params["blocks"][0]["wq"][0].shape[0]
    hpb = params["blocks"][0]["wq"][0].shape[2] // hd
    return nloc, hpb, k_pool[0].shape[3] // nloc


def sharded_paged_decode_step(params, cur, tables, pos, k_pool, v_pool, *,
                              devs, n_heads=4, dtype=torch.float32):
    """Blocked tensor-parallel twin of `llm/paged_model.paged_decode_step`
    over `shard_llm_params`' tree and per-shard pool slices. Per shard and
    local head block: project q/k/v, rope, write this step's K/V into the
    shard's pool slice, attend through the block tables (the shared
    einsum/softmax formulation), partial-project through wo; then one
    fixed-order row combine per layer on the home device. Returns
    (logits (B_b, vocab) f32, k_pool, v_pool); the pools are written in
    place."""
    b = cur.shape[0]
    hd = k_pool[0].shape[-1]
    block_size = k_pool[0].shape[2]
    kv_len = tables.shape[1] * block_size
    nloc, hpb, kvpb = _geometry(params, k_pool, hd)
    tabs, poss = _per_shard(tables, devs), _per_shard(pos, devs)
    rows = torch.arange(b, device=tables.device)
    wblk = _per_shard(tables[rows, pos // block_size], devs)
    woff = _per_shard(pos % block_size, devs)
    masks = [torch.arange(kv_len, device=p.device)[None, None, None, :]
             <= p[:, None, None, None] for p in poss]
    x = params["embed"][cur][:, None, :]                      # (B,1,D)
    for li, blk in enumerate(params["blocks"]):
        h = rmsnorm(x, blk["ln1"])
        parts = []
        for i, hi in enumerate(_per_shard(h, devs)):
            kp, vp = k_pool[i], v_pool[i]
            for j in range(nloc):
                q = (hi @ blk["wq"][i][j]).reshape(b, 1, hpb, hd)
                k = (hi @ blk["wk"][i][j]).reshape(b, 1, kvpb, hd)
                v = (hi @ blk["wv"][i][j]).reshape(b, 1, kvpb, hd)
                q, k = _rope_rows(q, poss[i]), _rope_rows(k, poss[i])
                kvs = slice(j * kvpb, (j + 1) * kvpb)
                kp[li, wblk[i], woff[i], kvs] = k[:, 0].to(kp.dtype)
                vp[li, wblk[i], woff[i], kvs] = v[:, 0].to(vp.dtype)
                kc = kp[li][:, :, kvs][tabs[i]].reshape(b, kv_len, kvpb, hd)
                vc = vp[li][:, :, kvs][tabs[i]].reshape(b, kv_len, kvpb, hd)
                attn = attend(q, kc, vc, masks[i], hpb, dtype)
                parts.append(attn.reshape(b, 1, -1) @ blk["wo"][i][j])
        x = x + _combine_rows(parts, devs[0])
        h = rmsnorm(x, blk["ln2"])
        x = x + _blocked_mlp(blk, h, devs)
    x = rmsnorm(x, params["ln_f"])
    return _head(params, x[:, 0], devs), k_pool, v_pool


def sharded_paged_prefill(params, ids, blk_idx, blk_off, k_pool, v_pool,
                          last_idx, *, devs, n_heads=4, dtype=torch.float32):
    """Blocked tensor-parallel twin of `paged_prefill`: the full-sequence
    causal forward with each shard's K/V written into its pool slice. The
    same canonical blocking as the decode step, so ``shards=N`` prefill
    logits (and the K/V every later decode reads) are bit-identical to
    ``shards=1``. Returns (last-token logits (vocab,) f32, k_pool,
    v_pool)."""
    s_len = ids.shape[1]
    hd = k_pool[0].shape[-1]
    nloc, hpb, kvpb = _geometry(params, k_pool, hd)
    poss = [torch.arange(s_len, device=dev) for dev in devs]
    causal = [(p[None, :] <= p[:, None])[None, None] for p in poss]
    bis, bos = _per_shard(blk_idx, devs), _per_shard(blk_off, devs)
    x = params["embed"][ids]                                  # (1,S,D)
    for li, blk in enumerate(params["blocks"]):
        h = rmsnorm(x, blk["ln1"])
        parts = []
        for i, hi in enumerate(_per_shard(h, devs)):
            kp, vp = k_pool[i], v_pool[i]
            for j in range(nloc):
                q = (hi @ blk["wq"][i][j]).reshape(1, s_len, hpb, hd)
                k = (hi @ blk["wk"][i][j]).reshape(1, s_len, kvpb, hd)
                v = (hi @ blk["wv"][i][j]).reshape(1, s_len, kvpb, hd)
                q, k = rope(q, poss[i]), rope(k, poss[i])
                kvs = slice(j * kvpb, (j + 1) * kvpb)
                kp[li, bis[i], bos[i], kvs] = k[0].to(kp.dtype)
                vp[li, bis[i], bos[i], kvs] = v[0].to(vp.dtype)
                attn = attend(q, k, v, causal[i], hpb, dtype)
                parts.append(attn.reshape(1, s_len, -1) @ blk["wo"][i][j])
        x = x + _combine_rows(parts, devs[0])
        h = rmsnorm(x, blk["ln2"])
        x = x + _blocked_mlp(blk, h, devs)
    x = rmsnorm(x, params["ln_f"])
    return _head(params, x[0, last_idx][None], devs)[0], k_pool, v_pool


def ring_prefill(params, ids, devs, *, n_heads=4, dtype=torch.float32):
    """Long-context prefill with ring attention over `devs` (the group
    re-axed as ``("sp",)``): the raw (unblocked) projections on the
    params' device, every layer's attention a ring over the shard
    devices. Returns (logits (1, S, vocab) f32, ks, vs) with ks/vs (L, 1,
    S, n_kv, hd), `paged_prefill`'s K/V layout."""
    from nnstreamer_tpu_torch.parallel.mesh import Mesh
    from nnstreamer_tpu_torch.parallel.ring_attention import ring_attention

    mesh = Mesh(list(devs), ("sp",))
    b, s = ids.shape
    if s % len(devs):
        raise BackendError(
            f"ring prefill needs the bucketed prompt length ({s}) divisible "
            f"by the shard count ({len(devs)})")
    x = params["embed"][ids].to(dtype)
    pos = torch.arange(s, device=ids.device)
    ks, vs = [], []
    for blk in params["blocks"]:
        h = rmsnorm(x, blk["ln1"].to(dtype))
        q, k, v = _qkv(blk, h, n_heads, dtype)
        q, k = rope(q, pos), rope(k, pos)
        ks.append(k)
        vs.append(v)
        attn = ring_attention(q, _expand_kv(k, n_heads),
                              _expand_kv(v, n_heads), mesh=mesh, axis="sp",
                              causal=True)
        x = x + attn.reshape(b, s, -1) @ blk["wo"].to(dtype)
        h = rmsnorm(x, blk["ln2"].to(dtype))
        x = x + _mlp(blk, h, dtype)
    x = rmsnorm(x, params["ln_f"].to(dtype))
    logits = (x @ params["head"].to(dtype)).float()
    return logits, torch.stack(ks), torch.stack(vs)


def make_llm_fns(devs: Sequence[torch.device]) -> Dict:
    """The sharded paged family over `devs`, by kind, with
    `llm/paged_model.py`'s signatures ((params, …, k_pool, v_pool) →
    (logits, k_pool, v_pool), the pools lists of per-shard slices):
    "prefill" and "decode" take `shard_llm_params`' tree, "ring" the raw
    params on the home device."""
    devs = list(devs)

    def prefill(params, ids, blk_idx, blk_off, k_pool, v_pool, last_idx,
                *, n_heads=4, dtype=torch.float32):
        return sharded_paged_prefill(params, ids, blk_idx, blk_off, k_pool,
                                     v_pool, last_idx, devs=devs,
                                     n_heads=n_heads, dtype=dtype)

    def decode(params, cur, tables, pos, k_pool, v_pool, *, n_heads=4,
               dtype=torch.float32):
        return sharded_paged_decode_step(params, cur, tables, pos, k_pool,
                                         v_pool, devs=devs, n_heads=n_heads,
                                         dtype=dtype)

    def ring(params, ids, blk_idx, blk_off, k_pool, v_pool, last_idx, *,
             n_heads=4, dtype=torch.float32):
        logits, ks, vs = ring_prefill(params, ids, devs, n_heads=n_heads,
                                      dtype=dtype)
        # paged_prefill's scatter, each shard taking its kv heads
        loc = k_pool[0].shape[3]
        for i, (bi, bo) in enumerate(zip(_per_shard(blk_idx, devs),
                                         _per_shard(blk_off, devs))):
            heads = slice(i * loc, (i + 1) * loc)
            k_pool[i][:, bi, bo] = ks[:, 0, :, heads].to(
                devs[i], k_pool[i].dtype, non_blocking=True)
            v_pool[i][:, bi, bo] = vs[:, 0, :, heads].to(
                devs[i], v_pool[i].dtype, non_blocking=True)
        return logits[0, last_idx], k_pool, v_pool

    return {"prefill": prefill, "decode": decode, "ring": ring}

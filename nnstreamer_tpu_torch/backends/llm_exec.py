"""Paged-LLM executor: bucketed prefill/decode over the paged KV pool
(counterpart of the JAX package's backends/llm_exec.py, one device).

The LLM engine's device half. It owns the paged KV pools and the params
on its device (`pick_device("")`: cuda unless the CPU is asked for),
and runs three bucketed families:

- prefill: the prompt padded to pow2 (>= 8);
- decode: the live-row count padded to pow2, padding rows writing the
  scratch block;
- chunk: one prompt chunk padded to its bucket, attending everything the
  sequence has written so far.

PyTorch runs eagerly, so nothing compiles: "compile" keeps the JAX
accounting's meaning as the first run of a (kind, bucket, kernel) — for
``pallas``, the first run also builds the CUDA kernels — and
``compile_count``/``cache_hits``/``cache_misses`` count it the same way.

Tracing (the engine hands down its tracer): each prefill, prefill chunk
and decode is one backend span on the engine's track — "compile" on a
bucket's first run, "invoke" after — with ``what=``, ``bucket=`` and
``kernel=`` (pallas | xla | ring), so `Tracer.kernel_spans()` counts the
calls per kernel; warm-up runs are "compile" spans without ``kernel=``.
A span's host time includes the read-back when the call syncs (its
forced sync is traced under ``<name>:prefill`` etc.), and only the
launches when it does not.

``paged_kernel`` (property, else ``$NNS_PAGED_KERNEL``, else ``xla``):
``pallas`` runs the attention through the hand-written CUDA kernels
(backends/paged_attn.py) and routes whole-prompt prefills through the
chunk family; ``xla`` runs the torch reference (llm/paged_model.py), the
token-for-token twin of `transformer.generate`. A kernel that fails to
build or launch raises; nothing falls back (``kernel_fallback`` stays in
`stats()` and is always 0).

A ``store://`` model rides the model-store epoch: `prewarm_version` checks
an incoming version's cache geometry and places its params on the
device, `maybe_adopt` swaps them in at a step boundary.

``shards=N`` serves tensor-parallel over N logical devices
(serving/sharding.py; ``shard_chips`` names their ordinals, default 0 ..
N-1): projections canonically blocked and head-sharded, the KV pool one
kv-head slice per shard device, the residual stream on the group's first
device — bit-identical to ``shards=1``. Prompts at or past
``ring_prefill_min`` prefill through ring attention over the same devices
(kind "ring": allclose, not bit-equal, to the blocked path; counted under
``kernel_invokes["xla"]`` as the JAX package counts it). Sharded serving
is float-only and refuses chunked prefill and ``paged_kernel=pallas``
(the JAX package falls back to XLA there with a count; the port raises).
``warm_start`` replays the persistent bucket manifest
(serving/compile_cache.py) at element start, when it is on.

The device profiler (runtime/devprof.py), when on, sees every dispatch
under the JAX package's bucket names (``prefill:N``, ``ring:N``,
``chunk:N``, ``decode:N``, ``decmulti:BxK``; a warm run under the bucket
it warms): a CUDA-event pair around the launches, read at the next
``device_sync`` on the engine's thread, as the filter path does it. A
bucket's first run (served or warm; not a window, as in JAX) is also
counted under FlopCounterMode (`capture_cost`), and the executor shows
as the ``model:<name>`` row of the memory ledger (`resident_bytes`).

The compiled decode window (``decode_multi``, the engine's
``decode_window``) runs K greedy decode steps with the sampled token
fed back on the device (``torch.argmax``, the first maximum, as the
host's ``np.argmax``) and one read-back per window. Its body is exactly
the per-step decode, K times. On the CPU it runs eagerly; on the card the
first window of a (row bucket, steps, kernel) runs eagerly and is then
captured into one CUDA graph (backends/cuda_graphs.py) that later
windows replay: ``cur``, ``tables`` and ``pos`` are its
static inputs, the KV pools are written in place (their storage never
changes), and the graphs share one memory pool. They bake in the params
held, so a store swap drops them at adoption. A capture that fails
raises; nothing falls back.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.backends import cuda_graphs
from nnstreamer_tpu_torch.backends.base import pick_device
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.llm.paged_cache import SCRATCH_BLOCK, PagedKVCache
from nnstreamer_tpu_torch.runtime import devprof
from nnstreamer_tpu_torch.runtime.sync import to_host
from nnstreamer_tpu_torch.runtime.tracing import NULL_TRACER

log = get_logger("backends.llm")


def _next_pow2(n: int, floor: int = 1) -> int:
    v = max(n, floor)
    return 1 << (v - 1).bit_length()


def _derive_dims(params: dict, n_heads: int) -> dict:
    """Model dims from the transformer params themselves (a store version
    may differ from the element's properties; a W8A8 version's int8
    weights have the float version's shapes)."""
    try:
        d_model = int(params["embed"].shape[1])
        vocab = int(params["head"].shape[1])
        n_layers = len(params["blocks"])
        hd = d_model // n_heads
        n_kv = (int(params["blocks"][0]["wqkv"].shape[1]) - d_model) \
            // 2 // hd
    except (KeyError, IndexError, AttributeError, TypeError) as e:
        raise BackendError(
            f"tensor_llm needs transformer-family params (embed/blocks/"
            f"ln_f/head, models/transformer.py); could not read dims: "
            f"{e}") from e
    if hd * n_heads != d_model:
        raise BackendError(
            f"n_heads={n_heads} does not divide d_model={d_model}")
    return {"d_model": d_model, "vocab": vocab, "n_layers": n_layers,
            "head_dim": hd, "n_kv": n_kv}


def _fns(kind: str, kernel: str):
    """The function serving (kind, kernel)."""
    if kind == "prefill":
        from nnstreamer_tpu_torch.llm.paged_model import paged_prefill
        return paged_prefill
    if kernel == "pallas":
        from nnstreamer_tpu_torch.backends import paged_attn
        return (paged_attn.paged_flash_prefill_chunk if kind == "chunk"
                else paged_attn.paged_flash_decode_step)
    from nnstreamer_tpu_torch.llm import paged_model
    return (paged_model.paged_prefill_chunk if kind == "chunk"
            else paged_model.paged_decode_step)


class PagedLLMExecutor:
    """Device executor for the continuous-batching engine.

    `model` is a ``store://name[@version]`` ref (tracked or pinned; zoo
    builtins seed as @0), a ``zoo://name`` ref (served through the
    store) or a transformer params dict of torch tensors. One instance
    per engine; every method runs on the engine's one scheduler thread.
    """

    def __init__(self, model="store://transformer", *, n_heads: int = 4,
                 dtype: Optional[torch.dtype] = None, block_size: int = 16,
                 num_blocks: int = 64, max_len: int = 128,
                 paged_kernel: Optional[str] = None, shards: int = 0,
                 shard_chips=None, ring_prefill_min: int = 0,
                 tracer=NULL_TRACER, name: str = "llm"):
        kern = (paged_kernel or os.environ.get("NNS_PAGED_KERNEL")
                or "xla").strip().lower()
        if kern not in ("pallas", "xla"):
            raise BackendError(
                f"paged_kernel must be 'pallas' or 'xla', got {kern!r}")
        self.name = name
        self.tracer = tracer
        self.paged_kernel = kern
        self.kernel_invokes: Dict[str, int] = {"pallas": 0, "xla": 0}
        self.n_heads = int(n_heads)
        self.dtype = dtype or torch.float32
        self.max_len = int(max_len)
        self.shards = int(shards)
        self.ring_prefill_min = int(ring_prefill_min)
        self._shard_chips: tuple = ()
        self._shard_devs: List[torch.device] = []
        if self.shards:
            from nnstreamer_tpu_torch.serving import sharding as shg

            shg.validate_shards(self.shards)
            if kern == "pallas":
                raise BackendError(
                    f"llm {name}: paged_kernel=pallas runs the single-card "
                    f"paged kernels; shards={self.shards} serves through the "
                    f"sharded torch attention — set paged_kernel=xla")
            chips = tuple(int(c) for c in shard_chips) \
                if shard_chips is not None else tuple(range(self.shards))
            if len(chips) != self.shards:
                raise BackendError(
                    f"llm {name}: shards={self.shards} but {len(chips)} "
                    f"devices leased: {chips}")
            self._shard_chips = chips
            self._shard_devs = shg.shard_devices(chips)
            self.device = self._shard_devs[0]
        elif self.ring_prefill_min > 0:
            raise BackendError(
                f"llm {name}: ring_prefill_min={self.ring_prefill_min} needs "
                f"shards>0 (the ring runs over the shard group's devices)")
        else:
            self.device = pick_device("")
        self._entry = None
        self._pinned: Optional[int] = None
        self._version: Optional[int] = None
        self._staged: Dict[int, Any] = {}    # version → placed params
        self.adopted_epoch = -1
        self.swap_count = 0
        if isinstance(model, str):
            from nnstreamer_tpu_torch.serving.store import (
                get_store, parse_store_ref)

            if model.startswith("zoo://"):
                model = "store://" + model[len("zoo://"):]
            ref = parse_store_ref(model)
            self._entry = get_store().entry(ref.name)
            if ref.version is not None:
                self._pinned = self._entry.resolve_version(ref.version)
                self._version = self._pinned
            else:
                self._version, self.adopted_epoch = self._entry.state
            raw = self._entry.bundle(self._version).params
            self._entry.attach(self)
        elif isinstance(model, dict):
            raw = model
        else:
            raise BackendError(
                f"tensor_llm model must be a store:// or zoo:// ref or a "
                f"params dict, got {type(model).__name__}")
        self.__dict__.update(_derive_dims(raw, self.n_heads))
        # sharded: the blocked tree first, so its typed refusals (float
        # only, 8-divisible geometry) come before any pool exists
        self._sparams = self._place_sharded(raw)
        self.params = self._place(raw)
        self._sfns = None
        placer = None
        if self.shards:
            from nnstreamer_tpu_torch.serving import sharding as shg

            self._sfns = shg.make_llm_fns(self._shard_devs)
            placer = shg.kv_pool_placer(self._shard_devs)
        bs = int(block_size)
        self.max_blocks = max(1, -(-self.max_len // bs))
        self.cache = PagedKVCache(
            num_blocks=int(num_blocks), block_size=bs,
            n_layers=self.n_layers, n_kv=self.n_kv,
            head_dim=self.head_dim, device=self.device, placer=placer)
        #: (kind, bucket, kernel) families run at least once
        self._seen: set = set()
        self.compile_count = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.prefills = 0
        self.chunk_prefills = 0
        self.decode_steps = 0
        # compiled decode windows (decode_multi): windows run, and the
        # decode steps they served
        self.decode_windows = 0
        self.window_steps = 0
        # (bucket, steps, kernel) → graph, for the params version held
        # (the store epoch adopted)
        self._graphs = cuda_graphs.GraphCache()
        self._graphs.use(self.adopted_epoch)

    # -- params ------------------------------------------------------------
    def _place(self, params, key: str = ""):
        """Params on the executor's device, floats in the activation
        dtype. Every use casts to that dtype anyway (``w.to(dtype)``), so
        casting once here changes no result and makes each use a no-op.
        A W8A8 version keeps its int8 weights int8, stored column-major
        (`quant.column_major`, the layout the card's int8 product reads
        fast), and its ``*_scale`` columns f32, as the JAX package keeps
        them: a bf16 scale would rescale to other numbers."""
        if isinstance(params, dict):
            return {k: self._place(v, k) for k, v in params.items()}
        if isinstance(params, (list, tuple)):
            return [self._place(v) for v in params]
        t = torch.as_tensor(params)
        if key.endswith("_scale"):
            return t.to(self.device, torch.float32)
        if t.dtype == torch.int8 and t.dim() == 2:
            from nnstreamer_tpu_torch.models.quant import column_major

            return column_major(t.to(self.device))
        if t.is_floating_point():
            return t.to(self.device, self.dtype)
        return t.to(self.device)

    def _place_sharded(self, raw):
        """The blocked tree over the shard devices (None unsharded)."""
        if not self.shards:
            return None
        from nnstreamer_tpu_torch.serving import sharding as shg

        return shg.shard_llm_params(raw, self._shard_devs,
                                    n_heads=self.n_heads, dtype=self.dtype)

    def _geometry_check(self, dims: dict, what: str) -> None:
        if (dims["n_layers"], dims["n_kv"], dims["head_dim"]) != \
                (self.n_layers, self.n_kv, self.head_dim):
            raise BackendError(
                f"{what} changes the cache geometry (layers/kv-heads/"
                f"head-dim); tensor_llm cannot hot-swap it over live paged "
                f"state — restart the element to serve it")

    # -- store integration -------------------------------------------------
    @property
    def tracks_store_epoch(self) -> bool:
        return self._entry is not None and self._pinned is None

    def maybe_adopt(self) -> None:
        """Adopt a flipped store epoch at a step boundary: a params swap.
        In-flight sequences keep their old-version KV (retiring them
        would turn every swap into a latency spike)."""
        if not self.tracks_store_epoch:
            return
        cur, epoch = self._entry.state        # one read = consistent
        if epoch == self.adopted_epoch:
            return
        old = self._version
        placed = self._staged.pop(cur, None)
        if placed is None:                    # not pre-warmed through us
            raw = self._entry.bundle(cur).params
            self._geometry_check(_derive_dims(raw, self.n_heads),
                                 f"store swap {self._entry.name}@{old} → "
                                 f"@{cur}")
            placed = (self._place_sharded(raw), self._place(raw))
        self._sparams, self.params = placed
        self._staged.clear()
        self._graphs.use(epoch)   # the old graphs baked in the old params
        self._version, self.adopted_epoch = cur, epoch
        self.swap_count += 1
        self.tracer.record_swap(
            self.name, time.perf_counter(), model=self._entry.name,
            from_version=old, to_version=cur, epoch=epoch,
            prewarmed=True)
        log.info("llm %s adopted %s@%d epoch=%d", self.name,
                 self._entry.name, cur, epoch)

    def prewarm_version(self, version: int, bundle) -> int:
        """Swap-controller hook (serving/store.py update()): check the
        incoming version's cache geometry and place its params on the
        device before the epoch flips. Nothing compiles → 0."""
        params = getattr(bundle, "params", bundle)
        self._geometry_check(_derive_dims(params, self.n_heads),
                             f"incoming {self._entry.name}@{version}")
        # sharded: blocking refuses a quantized or ill-shaped version
        # here, before the epoch flips
        self._staged[version] = (self._place_sharded(params),
                                 self._place(params))
        return 0

    def _fn(self, kind: str):
        """The function serving `kind` on this executor."""
        if self.shards:
            return self._sfns[kind]
        return _fns(kind, self._kind_kernel(kind))

    def _exec_params(self, kind: str):
        """The params tree `kind` runs on: sharded prefill/decode the
        blocked tree, everything else (the ring too) the placed raw
        params."""
        if self.shards and kind != "ring":
            return self._sparams
        return self.params

    def _get_fn(self, kind: str, bucket: int):
        """→ (function, first run of this bucket?)."""
        key = (kind, bucket, self._kind_kernel(kind))
        if key in self._seen:
            self.cache_hits += 1
            return self._fn(kind), False
        self.cache_misses += 1
        self._seen.add(key)
        if self._entry is not None and self._version is not None:
            self._entry.note_bucket(self._version, (kind, bucket))
        return self._fn(kind), True

    def _kind_kernel(self, kind: str) -> str:
        """The whole-prompt prefill is always the torch `apply_seq_kv`
        path; chunk and decode follow the selected kernel."""
        return "xla" if kind == "prefill" else self.paged_kernel

    def _prefill_kind(self) -> str:
        """Whole-prompt prefills run as one chunk covering the prompt
        when the kernel is ``pallas`` or the bound params are W8A8
        (`apply_seq_kv` is float-only and kernel-fixed; the chunk family
        is quant-aware and kernel-selectable). Float params on the torch
        reference keep `apply_seq_kv`, the `generate` parity anchor. The
        current params are read, so a store swap to a W8A8 version
        reroutes whole prompts. Sharded serving (float, xla only) keeps
        the whole-prompt family; the ring cutover is per prompt."""
        if self.shards:
            return "prefill"
        if self.paged_kernel == "pallas":
            return "chunk"
        return "chunk" if "wqkv_scale" in self.params["blocks"][0] \
            else "prefill"

    def _span(self, kind: str, t0: float, t1: float, **args) -> None:
        if self.tracer.active:
            self.tracer.backend_span(self.name, kind, t0, t1, **args)

    # -- device performance plane (runtime/devprof.py) ---------------------
    def resident_bytes(self) -> int:
        """Device bytes this executor pins: the placed params of every
        version held (sharded: the blocked tree and the raw tree the ring
        runs on; staged versions too) plus the paged KV pool's k and v —
        the executor's row of the memory ledger."""
        trees = [self.params, self._sparams]
        for staged in self._staged.values():
            trees.extend(staged)
        return devprof.tensor_bytes(*trees, self.cache.k, self.cache.v)

    def _run(self, fn, params, args: tuple, kind: str, bucket,
             fresh: bool):
        """``fn(params, *args)`` under the profiler's hooks, as the bucket
        ``kind:bucket``: a dispatch stamp before its launches and the
        launched mark after them (the next ``device_sync`` on this thread
        reads the pair); a bucket's first run is counted under
        FlopCounterMode too (`capture_cost`, the JAX package's
        compile-event capture). With the profiler off, one ``enabled``
        test."""
        prof = devprof.get()
        if not prof.enabled:
            return fn(params, *args, n_heads=self.n_heads, dtype=self.dtype)
        label = f"{kind}:{bucket}"
        prof.note_dispatch(self.name, label, self.device)
        if fresh:
            prof.attach_model(self.name, self)
            out = prof.capture_cost(
                self.name, label,
                lambda: fn(params, *args, n_heads=self.n_heads,
                           dtype=self.dtype), params=params, inputs=args)
        else:
            out = fn(params, *args, n_heads=self.n_heads, dtype=self.dtype)
        prof.note_launched()
        return out

    def _logits(self, logits, sync: bool, what: str):
        """Host (vocab,)-rows of `logits` after one traced forced sync
        when `sync`, else the device tensor."""
        if not sync:
            return logits
        return to_host((logits,), self.tracer, f"{self.name}:{what}")[0]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- prefill -----------------------------------------------------------
    def prefill(self, prompt: np.ndarray, block_table: List[int],
                *, sync: bool = True):
        """One whole prompt; its KV lands in the blocks of `block_table`.
        Returns last-token logits: host (vocab,) f32 when `sync`, else
        the device tensor, so the engine resolves a whole step's
        admissions with one sync."""
        plen = int(prompt.shape[0])
        if self._prefill_kind() == "chunk":
            return self.prefill_chunk(prompt, 0, block_table,
                                      bucket=_next_pow2(plen, 8), sync=sync)
        kind = "prefill"
        if self.shards and 0 < self.ring_prefill_min <= plen:
            kind = "ring"    # the sequence-parallel long-prompt cutover
        s_b = _next_pow2(plen, 8)
        bs = self.cache.block_size
        ids = np.zeros((1, s_b), np.int32)
        ids[0, :plen] = prompt
        blk_idx = np.full((s_b,), SCRATCH_BLOCK, np.int32)
        blk_idx[:plen] = np.asarray(block_table, np.int32)[
            np.arange(plen) // bs]
        blk_off = (np.arange(s_b) % bs).astype(np.int32)
        fn, fresh = self._get_fn(kind, s_b)
        t0 = time.perf_counter()
        params = self._exec_params(kind)
        args = (self._tensor(ids), self._tensor(blk_idx),
                self._tensor(blk_off), self.cache.k, self.cache.v, plen - 1)
        logits, self.cache.k, self.cache.v = self._run(
            fn, params, args, kind, s_b, fresh)
        out = self._logits(logits, sync, "prefill")
        kernel = "ring" if kind == "ring" else "xla"
        if fresh:
            self._span("compile", t0, time.perf_counter(),
                       what="llm_prefill", bucket=s_b, kernel=kernel)
        else:
            self._span("invoke", t0, time.perf_counter(),
                       what="llm_prefill", bucket=s_b, plen=plen,
                       kernel=kernel)
        self.compile_count += int(fresh)
        self.prefills += 1
        self.kernel_invokes["xla"] += 1
        return out

    def prefill_chunk(self, chunk: np.ndarray, pos0: int,
                      block_table: List[int], *, bucket: int = 0,
                      sync: bool = True):
        """One prompt chunk starting at absolute position `pos0`, written
        into `block_table`'s blocks and attending the whole prefix
        written so far. `bucket` pins the pad width so every chunk of a
        prompt runs one bucket; 0 = pow2 of this chunk. Returns the
        chunk's last-token logits (host when `sync`, device otherwise)."""
        if self.shards:
            raise BackendError(
                f"llm {self.name}: chunked prefill is not supported with "
                f"shards={self.shards}; long prompts go through the "
                f"sequence-parallel ring prefill (ring_prefill_min)")
        clen = int(chunk.shape[0])
        c_b = max(int(bucket) or 0, _next_pow2(clen, 8))
        bs = self.cache.block_size
        ids = np.zeros((1, c_b), np.int32)
        ids[0, :clen] = chunk
        blk_idx = np.full((c_b,), SCRATCH_BLOCK, np.int32)
        blk_idx[:clen] = np.asarray(block_table, np.int32)[
            (int(pos0) + np.arange(clen)) // bs]
        blk_off = ((int(pos0) + np.arange(c_b)) % bs).astype(np.int32)
        tab = np.full((self.max_blocks,), SCRATCH_BLOCK, np.int32)
        tab[:len(block_table)] = block_table
        fn, fresh = self._get_fn("chunk", c_b)
        t0 = time.perf_counter()
        args = (self._tensor(ids), int(pos0), self._tensor(blk_idx),
                self._tensor(blk_off), self._tensor(tab), self.cache.k,
                self.cache.v, clen - 1)
        logits, self.cache.k, self.cache.v = self._run(
            fn, self.params, args, "chunk", c_b, fresh)
        out = self._logits(logits, sync, "prefill_chunk")
        kernel = self._kind_kernel("chunk")
        if fresh:
            self._span("compile", t0, time.perf_counter(),
                       what="llm_prefill_chunk", bucket=c_b, kernel=kernel)
        else:
            self._span("invoke", t0, time.perf_counter(),
                       what="llm_prefill_chunk", bucket=c_b, clen=clen,
                       kernel=kernel)
        self.compile_count += int(fresh)
        self.chunk_prefills += 1
        self.kernel_invokes[kernel] += 1
        return out

    # -- decode ------------------------------------------------------------
    def _decode_inputs(self, cur: List[int], tables: List[List[int]],
                       pos: List[int], b_b: int) -> Tuple[torch.Tensor, ...]:
        """(cur, tables, pos) of the live rows padded to the row bucket
        `b_b`, on the device; padding rows write the scratch block."""
        n = len(cur)
        cur_a = np.zeros((b_b,), np.int32)
        cur_a[:n] = cur
        tab_a = np.full((b_b, self.max_blocks), SCRATCH_BLOCK, np.int32)
        for i, t in enumerate(tables):
            tab_a[i, :len(t)] = t
        pos_a = np.zeros((b_b,), np.int32)
        pos_a[:n] = pos
        return self._tensor(cur_a), self._tensor(tab_a), self._tensor(pos_a)

    def decode(self, cur: List[int], tables: List[List[int]],
               pos: List[int], *, sync: bool = True):
        """One decode step for `len(cur)` live rows (bucketed to pow2;
        padding rows write the scratch block). With `sync` returns host
        logits (n, vocab) f32 for the live rows; else the padded device
        tensor (b_b, vocab)."""
        n = len(cur)
        b_b = _next_pow2(n, 1)
        fn, fresh = self._get_fn("decode", b_b)
        t0 = time.perf_counter()
        params = self._exec_params("decode")
        args = (*self._decode_inputs(cur, tables, pos, b_b), self.cache.k,
                self.cache.v)
        logits, self.cache.k, self.cache.v = self._run(
            fn, params, args, "decode", b_b, fresh)
        out = self._logits(logits, sync, "decode")
        kernel = self._kind_kernel("decode")
        if fresh:
            self._span("compile", t0, time.perf_counter(),
                       what="llm_decode", bucket=b_b, kernel=kernel)
        else:
            self._span("invoke", t0, time.perf_counter(),
                       what="llm_decode", bucket=b_b, rows=n, kernel=kernel)
        self.compile_count += int(fresh)
        self.decode_steps += 1
        self.kernel_invokes[kernel] += 1
        return out[:n] if sync else out

    def decode_multi(self, cur: List[int], tables: List[List[int]],
                     pos: List[int], steps: int) -> np.ndarray:
        """`steps` greedy decode steps for `len(cur)` live rows as one
        window (the engine's `decode_window`): the sampled token feeds the
        next step on the device, and the host reads the tokens back once.
        Returns a host (n, steps) int32 token matrix.

        The caller keeps the window's invariants (llm/engine.py
        `_window_len`): every row greedy, `steps` within every row's
        remaining budget (its blocks were allocated at admission, so
        position pos + steps - 1 is backed), and a row that meets EOS
        mid-window has its later tokens discarded on the host — their KV
        writes land in blocks it still owned."""
        n = len(cur)
        steps = int(steps)
        b_b = _next_pow2(n, 1)
        kernel = self._kind_kernel("decode")
        fn = self._fn("decode")
        params = self._exec_params("decode")

        def body(cur_t, tab_t, pos_t):
            toks = []
            for _ in range(steps):
                logits, _, _ = fn(params, cur_t, tab_t, pos_t, self.cache.k,
                                  self.cache.v, n_heads=self.n_heads,
                                  dtype=self.dtype)
                cur_t = torch.argmax(logits, dim=-1).to(torch.int32)
                toks.append(cur_t)
                pos_t = pos_t + 1
            return torch.stack(toks, dim=1)

        key = (b_b, steps, kernel)
        fresh = ("decmulti",) + key not in self._seen
        inputs = self._decode_inputs(cur, tables, pos, b_b)
        t0 = time.perf_counter()
        prof = devprof.get()
        if prof.enabled:
            # a window is one sample, replayed or eager (no cost capture:
            # the JAX package captures none for its window either)
            prof.note_dispatch(self.name, f"decmulti:{b_b}x{steps}",
                               self.device)
        g = self._graphs.get(key)
        if g is not None:
            toks = g.run(inputs)
        else:
            # the first window of a key (every window on the CPU) runs
            # eagerly; on the card it is the warm-up of the capture
            toks = body(*inputs)
            if self.device.type == "cuda":
                self._graphs.capture(
                    key, body, inputs, keep=(params,),
                    what=f"llm {self.name} decode window (bucket, steps, "
                         f"kernel) {key}")
        if prof.enabled:
            prof.note_launched()
        self._seen.add(("decmulti",) + key)
        out = to_host((toks,), self.tracer, f"{self.name}:decmulti")[0][:n]
        t1 = time.perf_counter()
        if fresh:
            self.compile_count += 1
            self._span("compile", t0, t1, what="llm_decode_multi",
                       bucket=b_b, steps=steps, kernel=kernel)
        else:
            self._span("invoke", t0, t1, what="llm_decode_multi",
                       bucket=b_b, steps=steps, rows=n, kernel=kernel)
        # the ledger counts the same decode steps whether or not a
        # window served them
        self.decode_steps += steps
        self.kernel_invokes[kernel] += steps
        self.decode_windows += 1
        self.window_steps += steps
        return out

    def window_graphs(self) -> List[tuple]:
        """(bucket, steps, kernel) of every decode-window graph held."""
        return sorted(self._graphs.graphs)

    # -- warm paths --------------------------------------------------------
    def _warm_compile(self, kind: str, bucket: int) -> bool:
        """Run one bucket ahead of traffic on dummy inputs whose every
        write targets the scratch block (which absorbs garbage by
        design), so the first served request finds it warm — for the
        CUDA kernels, already built. Returns whether it was the bucket's
        first run."""
        if (kind, bucket, self._kind_kernel(kind)) in self._seen:
            return False
        fn, _ = self._get_fn(kind, bucket)
        t0 = time.perf_counter()
        params = self._exec_params(kind)
        zeros = self._tensor(np.zeros((bucket,), np.int32))
        blk = self._tensor(np.full((bucket,), SCRATCH_BLOCK, np.int32))
        off = self._tensor(
            (np.arange(bucket) % self.cache.block_size).astype(np.int32))
        kv = (self.cache.k, self.cache.v)
        if kind in ("prefill", "ring"):
            args = (zeros[None], blk, off, *kv, 0)
        elif kind == "chunk":
            tab = self._tensor(np.full((self.max_blocks,), SCRATCH_BLOCK,
                                       np.int32))
            args = (zeros[None], 0, blk, off, tab, *kv, 0)
        else:
            tab = self._tensor(np.full((bucket, self.max_blocks),
                                       SCRATCH_BLOCK, np.int32))
            args = (zeros, tab, zeros, *kv)
        logits, self.cache.k, self.cache.v = self._run(
            fn, params, args, kind, bucket, True)
        to_host((logits,), self.tracer, f"{self.name}:warm_{kind}")
        self.compile_count += 1
        self._span("compile", t0, time.perf_counter(),
                   what=f"llm_{kind}_warm", bucket=bucket)
        return True

    def prewarm_buckets(self, *, max_batch: int, max_prompt: int,
                        chunk: int = 0) -> int:
        """Run every bucket a serving run can hit once, ahead of traffic:
        decode pow2 buckets up to `max_batch`, prefill (or, with the CUDA
        kernels, chunk) pow2 buckets up to `max_prompt`, and the chunk
        bucket of chunked prefill; sharded with a ring cutover, the ring
        buckets a cutover prompt can land in."""
        compiled = 0
        b, top_b = 1, _next_pow2(max(1, max_batch), 1)
        while b <= top_b:
            compiled += int(self._warm_compile("decode", b))
            b *= 2
        if chunk > 0:
            compiled += int(self._warm_compile("chunk",
                                               _next_pow2(chunk, 8)))
        kind = self._prefill_kind()
        s, top_s = 8, _next_pow2(min(max(1, max_prompt), self.max_len), 8)
        while s <= top_s:
            compiled += int(self._warm_compile(kind, s))
            s *= 2
        if self.shards and self.ring_prefill_min > 0:
            s = _next_pow2(max(8, self.ring_prefill_min), 8)
            while s <= top_s:
                compiled += int(self._warm_compile("ring", s))
                s *= 2
        return compiled

    def warm_start(self) -> int:
        """Replay the persistent manifest's prefill/decode/chunk/ring
        buckets for the bound version (element start(), off the hot
        path; serving/compile_cache.py): each runs once, as prewarm runs
        them. A bucket that fails is skipped with a warning — warm start
        is never a gate. → buckets run."""
        if self._entry is None:
            return 0
        from nnstreamer_tpu_torch.serving.compile_cache import (
            manifest_buckets)

        compiled = 0
        for kind, bucket in manifest_buckets(self._entry.name,
                                             self._version):
            if (kind == "chunk" and self.shards) or (
                    kind == "ring" and not self.shards):
                continue
            try:
                compiled += int(self._warm_compile(kind, bucket))
            except Exception as e:    # warm start is never a gate
                log.warning("llm warm_start bucket %s failed: %s",
                            (kind, bucket), e)
        return compiled

    def close(self) -> None:
        if self._entry is not None:
            self._entry.detach(self)
        self._staged.clear()

    def stats(self) -> dict:
        out = {
            "compile_count": self.compile_count,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "prefills": self.prefills,
            "chunk_prefills": self.chunk_prefills,
            "decode_steps": self.decode_steps,
            "decode_windows": self.decode_windows,
            "window_steps": self.window_steps,
            "swap_count": self.swap_count,
            "paged_kernel": self.paged_kernel,
            "kernel_invokes": dict(self.kernel_invokes),
            "kernel_fallback": 0,     # nothing falls back
        }
        if self.shards:
            out["shards"] = self.shards
            out["shard_chips"] = list(self._shard_chips)
            # the physical device of each shard: a group of logical
            # devices on one card cannot pass for one across cards
            out["shard_devices"] = [str(d) for d in self._shard_devs]
            out["ring_prefill_min"] = self.ring_prefill_min
        if self._entry is not None:
            out["store"] = f"{self._entry.name}@{self._version}"
        return out

"""Device placement (counterpart of the JAX package's serving/placement.py):
data-parallel replicas and profiled model segmentation.

- `visible_devices` is the one place that enumerates devices: every
  replica, shard group, ring and plan stage picks its devices by
  ordinal from this list.
- `ChipLeaseTable` is the ownership ledger: which owner holds which
  device ordinals (free, leased or fenced).

**Data-parallel replicas** (`ReplicaSet`, ``tensor_filter devices=N``):
N whole `TorchBackend`s, replica i pinned to logical device i
(`accelerator_for`), each fed by its own bounded
`parallel/dispatch.BatchCore` queue (raw payloads: a filter invocation
or micro-batch each). Routing is least-outstanding with a round-robin
tiebreak; a fenced replica's queued work is re-offered to a survivor, so
Σ replica invokes == filter replied holds exactly through a fence. Hot
swap goes through the model store's handle protocol: every replica
backend is a handle, so one ``ModelStore.update()`` pre-warms the new
version on each (a failure aborts before the flip) and the entry's one
state assignment is the commit.

**Profiled segmentation** (`segment_plan`, `segment_plan_tp`,
`plan_from_tracer`, `apply_plan`): the tracer's per-element proctime
picks the cut points (a balanced contiguous partition), `apply_plan`
pins each stage's filters to ``<type>:<ordinal>`` of its logical device
and records the plan on the pipeline, so `graph/optimize.fuse_segments`
composes within a stage and never across a cut. The handoff between
stages is the next stage backend's staging copy (counted in its
`staging_transfers`; on logical devices that share a card it is a copy
on that card, the one a second card would receive).

Logical devices: the JAX package tests its mesh code on 8 virtual CPU
devices (``--xla_force_host_platform_device_count``). The port's
counterpart is the config key ``[parallel] virtual_devices`` (env
``NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES``): N > 0 maps N logical
devices round-robin onto the physical devices of the configured
accelerator. On one card a 4-way group then runs all four shards on
``cuda:0`` with the kernel launches four cards would make; on four cards
the same code puts one shard on each. 0 (the default) means the physical
devices themselves. A logical device is its physical ``torch.device``;
its ordinal is its place in the list, and ``accelerator=cuda:<ordinal>``
(or ``cpu:<ordinal>``) pins a backend to it (`backends.base.pick_device`).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from nnstreamer_tpu_torch.backends.base import pick_device
from nnstreamer_tpu_torch.core.config import get_config
from nnstreamer_tpu_torch.core.errors import (
    BackendError, ConfigError, StreamError)
from nnstreamer_tpu_torch.core.log import get_logger

log = get_logger("serving.placement")

#: what to set when a group wants more devices than are visible
VIRTUAL_DEVICES_HINT = (
    "set [parallel] virtual_devices (env NNSTREAMER_TPU_TORCH_PARALLEL_"
    "VIRTUAL_DEVICES=N) to map N logical devices onto the physical ones")


def physical_devices() -> List[torch.device]:
    """The devices of the configured accelerator ([filter] accelerator):
    every CUDA card for ``cuda``, that card for ``cuda:<i>``, one CPU for
    ``cpu``. Raises as `pick_device` does when no card is visible and the
    CPU was not asked for."""
    accel = (get_config().get("filter", "accelerator") or "cuda").strip()
    dev = pick_device(accel)
    if dev.type == "cpu" or ":" in accel:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def visible_devices() -> List[torch.device]:
    """Every logical device, in ordinal order: the physical devices, or
    ``[parallel] virtual_devices`` of them round-robin."""
    n = get_config().get_int("parallel", "virtual_devices", 0)
    if n < 0:
        raise ConfigError(f"[parallel] virtual_devices must be >= 0, got {n}")
    phys = physical_devices()
    if n == 0:
        return phys
    return [phys[i % len(phys)] for i in range(n)]


def device_of(index: int) -> torch.device:
    """The logical device with ordinal `index`; typed error past the
    end."""
    devs = visible_devices()
    if not 0 <= index < len(devs):
        raise BackendError(
            f"device index {index} out of range: {len(devs)} device(s) "
            f"visible; {VIRTUAL_DEVICES_HINT}")
    return devs[index]


def accelerator_for(index: int) -> str:
    """The ``accelerator=`` string pinning a backend to logical device
    `index` (``cuda:3``, ``cpu:3``): how a replica or a plan stage
    reaches `pick_device`."""
    return f"{device_of(index).type}:{index}"


# -- data-parallel replicas ------------------------------------------------------

class _Replica:
    """One replica: a backend pinned to its logical device and the
    bounded BatchCore queue that feeds it."""

    def __init__(self, index: int, backend, core, platform: str):
        self.index = index            # logical device ordinal
        self.backend = backend
        self.core = core
        self.platform = platform
        self.fenced = False

    @property
    def outstanding(self) -> int:
        return self.core.outstanding


class ReplicaSet:
    """N replicas behind one submit()/invoke() front door.

    `ReplicaSet.open(framework, props, count)` opens one backend per
    logical device with ``accelerator=<type>:<i>``; `configure` replays
    the head's backend setup (fuse, set_input_info) on each, so every
    replica runs the single-device program: the same bits.

    Routing: least outstanding work first, round-robin among ties; a
    replica whose bounded queue is full is skipped, and when every
    replica is full or fenced the frame fails with a typed StreamError
    (backpressure, never unbounded buffering). A payload stranded by a
    fence is re-offered to a survivor (`reoffers`), so Σ replica invokes
    == frames replied holds exactly through a fence.
    """

    def __init__(self, backends: Sequence[Any], device_indices: Sequence[int],
                 *, queue_cap: int = 64, bucket: int = 4,
                 max_delay_ms: float = 0.0, name: str = "replicas",
                 tracer=None, store_name: str = ""):
        if not backends:
            raise BackendError("ReplicaSet needs at least one backend")
        from nnstreamer_tpu_torch.parallel.dispatch import BatchCore

        self.name = name
        self.tracer = tracer
        self.store_name = store_name
        self._lock = threading.Lock()
        self._rr = 0
        self.routed = 0
        self.reoffers = 0
        self.rejected = 0
        self.fences = 0
        self.max_redeliver = 1
        devs = visible_devices()
        self._replicas: List[_Replica] = []
        for b, di in zip(backends, device_indices):
            core = BatchCore(
                self._make_run(len(self._replicas), di),
                buckets=[max(1, int(bucket))],
                max_delay_s=max_delay_ms / 1e3,
                capacity=int(queue_cap), raw=True,
                name=f"{name}-dev{di}")
            self._replicas.append(
                _Replica(di, b, core,
                         devs[di].type if di < len(devs) else "cpu"))

    @classmethod
    def open(cls, framework: str, props: Dict[str, Any], count: int, *,
             configure: Optional[Callable[[Any], None]] = None,
             queue_cap: int = 64, bucket: int = 4,
             max_delay_ms: float = 0.0, name: str = "replicas",
             tracer=None) -> "ReplicaSet":
        """Open `count` backends of `framework`, replica i pinned to
        logical device i. All or none: the backends opened so far are
        closed again if a later one fails."""
        from nnstreamer_tpu_torch.backends.base import get_backend

        devs = visible_devices()
        if count > len(devs):
            raise BackendError(
                f"devices={count} requested but only {len(devs)} "
                f"device(s) visible; {VIRTUAL_DEVICES_HINT}")
        model = props.get("model")
        store_name = ""
        if isinstance(model, str) and model.startswith("store://"):
            store_name = model[len("store://"):].split("@", 1)[0]
        backends = []
        try:
            for i in range(count):
                b = get_backend(framework)
                p = dict(props)
                p["accelerator"] = accelerator_for(i)
                b.open(p)
                if configure is not None:
                    configure(b)
                backends.append(b)
        except Exception:
            for b in backends:
                try:
                    b.close()
                except Exception:
                    pass
            raise
        return cls(backends, list(range(count)), queue_cap=queue_cap,
                   bucket=bucket, max_delay_ms=max_delay_ms, name=name,
                   tracer=tracer, store_name=store_name)

    # -- execution ---------------------------------------------------------
    def _make_run(self, ridx: int, dev_index: int):
        def run(items: List[tuple], n: int) -> List[tuple]:
            r = self._replicas[ridx]
            out: List[tuple] = []
            for payload in items:
                kind = payload[0]
                t0 = time.perf_counter()
                if kind == "invoke":
                    res = r.backend.invoke(payload[1])
                elif kind == "batched":
                    res = r.backend.invoke_batched(
                        payload[1], payload[2], payload[3])
                else:
                    raise StreamError(
                        f"unknown replica payload kind {kind!r}")
                tr = self.tracer
                if tr is not None and tr.active:
                    tr.device_span(dev_index, "invoke", t0,
                                   time.perf_counter(), element=self.name,
                                   frames=payload[2]
                                   if kind == "batched" else 1)
                out.append(tuple(res) if isinstance(res, (tuple, list))
                           else (res,))
            return out

        return run

    # -- routing -----------------------------------------------------------
    def _pick(self, exclude: Tuple[int, ...] = ()) -> Optional[_Replica]:
        """Least-outstanding live replica; round-robin breaks ties, so an
        idle set still spreads work over every device."""
        with self._lock:
            live = [r for r in self._replicas
                    if not r.fenced and r.index not in exclude]
            if not live:
                return None
            start = self._rr % len(live)
            self._rr += 1
            order = live[start:] + live[:start]
            return min(order, key=lambda r: r.outstanding)

    def _route(self, payload, outer: Future, attempts: int,
               exclude: Tuple[int, ...] = ()) -> None:
        tried: List[int] = list(exclude)
        while True:
            r = self._pick(tuple(tried))
            if r is None:
                with self._lock:
                    self.rejected += 1
                outer.set_exception(StreamError(
                    f"{self.name}: no live replica accepted the frame "
                    f"(fenced/full: {sorted(tried)})"))
                return
            try:
                inner = r.core.submit(payload)
            except StreamError:
                tried.append(r.index)   # full, or fenced mid-pick
                continue
            with self._lock:
                self.routed += 1

            def _done(fut, r=r, payload=payload, attempts=attempts):
                exc = fut.exception()
                if exc is None:
                    if not outer.done():
                        outer.set_result(fut.result())
                    return
                # a fence strands queued payloads: re-route them to a
                # survivor (the frame never ran, so a retry is safe);
                # a model error propagates as it is
                if r.fenced and attempts < self.max_redeliver:
                    with self._lock:
                        self.reoffers += 1
                    self._route(payload, outer, attempts + 1,
                                exclude=(r.index,))
                    return
                if not outer.done():
                    outer.set_exception(exc)

            inner.add_done_callback(_done)
            return

    def submit(self, inputs: tuple) -> Future:
        """Route one invocation (a tuple of input tensors); the future
        resolves to the output tuple (host numpy arrays)."""
        outer: Future = Future()
        self._route(("invoke", tuple(inputs)), outer, 0)
        return outer

    def submit_batched(self, inputs: tuple, n: int, keepdims) -> Future:
        outer: Future = Future()
        self._route(("batched", tuple(inputs), int(n), keepdims), outer, 0)
        return outer

    def invoke(self, inputs: tuple, timeout: Optional[float] = 60.0):
        return self.submit(inputs).result(timeout)

    def invoke_batched(self, inputs: tuple, n: int, keepdims,
                       timeout: Optional[float] = 60.0):
        return self.submit_batched(inputs, n, keepdims).result(timeout)

    # -- fencing -----------------------------------------------------------
    def fence(self, index: int, cause: str = "fenced") -> bool:
        """Take replica `index` out of service: stop routing to it, fail
        its queued work at once (re-routed by the outer futures), let
        what is already launched finish."""
        with self._lock:
            r = next((x for x in self._replicas if x.index == index), None)
            if r is None or r.fenced:
                return False
            r.fenced = True
            self.fences += 1
        r.core.abort(f"replica dev{index} {cause}")
        log.warning("%s: replica dev%d fenced (%s)", self.name, index,
                    cause)
        return True

    def live_replicas(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas if not r.fenced)

    # -- store hot swap ----------------------------------------------------
    def swap(self, version=None, wait_s: Optional[float] = None) -> dict:
        """Two-phase hot swap across every replica through the store's
        handle protocol: prepare runs the target version on every bucket
        each replica served (a failure raises before the flip: nothing
        moved); the commit is the entry's one state assignment, after
        which each replica adopts the new epoch at its next invoke."""
        if not self.store_name:
            raise BackendError(
                f"{self.name}: not store-backed (model was not a "
                f"store:// ref); register the model in the ModelStore "
                f"to hot swap replicas")
        from nnstreamer_tpu_torch.serving.store import get_store

        return get_store().update(self.store_name, version,
                                  prewarm=True, wait_s=wait_s)

    def adopted_epochs(self) -> List[int]:
        return [getattr(r.backend, "adopted_epoch", -1)
                for r in self._replicas]

    def compile_counts(self) -> List[int]:
        """Per replica, the graphs captured and the batched-shape
        verdicts taken (what the JAX package counts as compiles): a swap
        after prewarm adds none."""
        return [int(getattr(r.backend, "compile_count", 0) or 0)
                for r in self._replicas]

    # -- lifecycle / stats -------------------------------------------------
    def warm_start(self, tracer=None, trace_name: str = "") -> None:
        for r in self._replicas:
            if tracer is not None:
                r.backend.tracer = tracer
                r.backend.trace_name = (
                    f"{trace_name or self.name}/dev{r.index}")
            r.backend.warm_start()
        if tracer is not None:
            self.tracer = tracer

    def close(self) -> None:
        for r in self._replicas:
            r.core.shutdown()
        for r in self._replicas:
            try:
                r.backend.close()
            except Exception:
                pass

    def stats(self) -> dict:
        rows = []
        with self._lock:
            reps = list(self._replicas)
            totals = {"routed": self.routed, "reoffers": self.reoffers,
                      "rejected": self.rejected, "fences": self.fences}
        for r in reps:
            cs = r.core.stats()
            rows.append({
                "device": r.index,
                "platform": r.platform,
                "invokes": cs["frames"],
                "batches": cs["batches"],
                "errors": cs["errors"],
                "queue_depth": cs["outstanding"],
                "up": not r.fenced,
                "state": "fenced" if r.fenced else "ready",
                "compile_count": int(
                    getattr(r.backend, "compile_count", 0) or 0),
                "adopted_epoch": getattr(r.backend, "adopted_epoch", -1),
            })
        out = {"replicas": rows, "devices": len(rows),
               "live": sum(1 for x in rows if x["up"])}
        out.update(totals)
        return out


# -- device leases ---------------------------------------------------------------

class ChipLeaseTable:
    """Which owner holds which device ordinals — the fencing ledger.

    States per device: ``free`` (unowned), ``leased`` (owned by a live
    owner), ``fenced`` (its owner died; out of service until the owner's
    replacement re-leases it). `lease()` prefers the owner's own fenced
    devices, so a restarted owner gets its devices back."""

    def __init__(self, chips: Sequence[int]):
        self._lock = threading.Lock()
        self._chips: Dict[int, dict] = {
            int(c): {"owner": None, "state": "free"} for c in chips}
        self.fences_total = 0
        self.releases_total = 0

    def lease(self, owner, want: Optional[int] = None) -> Tuple[int, ...]:
        """Lease `want` devices to `owner` (None = all of its fenced
        devices, i.e. a re-lease after a restart). Own fenced devices come
        back first; free ones top up the rest. A typed error when the
        table cannot satisfy the request: an under-lease is never
        silent."""
        with self._lock:
            got: List[int] = [c for c, row in sorted(self._chips.items())
                              if row["state"] == "fenced"
                              and row["owner"] == owner]
            if want is None:
                want = len(got)
            for c, row in sorted(self._chips.items()):
                if len(got) >= want:
                    break
                if row["state"] == "free":
                    got.append(c)
            if len(got) < want:
                raise BackendError(
                    f"chip lease for {owner!r}: wanted {want}, only "
                    f"{len(got)} available ({self._counts_locked()})")
            got = got[:want]
            for c in got:
                self._chips[c] = {"owner": owner, "state": "leased"}
            return tuple(sorted(got))

    def fence(self, owner) -> Tuple[int, ...]:
        """The owner died: its leased devices go out of service, still
        associated with the owner so its restart re-leases them."""
        with self._lock:
            fenced = []
            for c, row in self._chips.items():
                if row["owner"] == owner and row["state"] == "leased":
                    row["state"] = "fenced"
                    fenced.append(c)
            self.fences_total += len(fenced)
            return tuple(sorted(fenced))

    def release(self, owner) -> Tuple[int, ...]:
        """Give the owner's devices (leased or fenced) back to the free
        pool."""
        with self._lock:
            freed = []
            for c, row in self._chips.items():
                if row["owner"] == owner:
                    self._chips[c] = {"owner": None, "state": "free"}
                    freed.append(c)
            self.releases_total += len(freed)
            return tuple(sorted(freed))

    def chips_of(self, owner) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(c for c, row in self._chips.items()
                                if row["owner"] == owner))

    def _counts_locked(self) -> dict:
        counts = {"free": 0, "leased": 0, "fenced": 0}
        for row in self._chips.values():
            counts[row["state"]] += 1
        return counts

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "chips": {c: dict(row)
                          for c, row in sorted(self._chips.items())},
                "counts": self._counts_locked(),
                "fences_total": self.fences_total,
                "releases_total": self.releases_total,
            }


# -- profiled model segmentation ---------------------------------------------------

@dataclass
class SegmentPlan:
    """Where to cut a filter chain and which device runs each piece."""

    stages: List[List[str]]        # element names, dataflow order
    devices: List[int]             # first logical ordinal per stage
    stage_times_s: List[float]     # profiled per-stage proctime sum
    bubble_fraction: float         # steady-state device idle share
    total_s: float                 # profiled single-device total
    source: str = "profile"
    tp: List[int] = field(default_factory=list)  # shards per stage (1 = none)

    def tp_of(self, stage: int) -> int:
        return self.tp[stage] if self.tp else 1

    def chips_total(self) -> int:
        return sum(self.tp) if self.tp else len(self.stages)

    def stage_of(self) -> Dict[str, int]:
        return {name: i for i, group in enumerate(self.stages)
                for name in group}

    def report(self) -> dict:
        """Per-stage and bubble summary (feeds the metrics plane)."""
        return {
            "stages": [
                {"stage": i, "device": self.devices[i],
                 "elements": list(self.stages[i]),
                 "time_s": self.stage_times_s[i],
                 "tp": self.tp_of(i)}
                for i in range(len(self.stages))],
            "bubble_fraction": self.bubble_fraction,
            "bottleneck_s": max(self.stage_times_s, default=0.0),
            "total_s": self.total_s,
            "chips_total": self.chips_total(),
            "source": self.source,
        }

    def measured_report(self, tracer) -> dict:
        """`report()` with each stage's time re-read from the live tracer
        profile of its surviving head element: planned against measured,
        whether the cut points still fit the traffic."""
        hists = tracer.hists() if getattr(tracer, "active", False) else {}
        times = []
        for group in self.stages:
            h = hists.get(group[0]) if group else None
            times.append(h["sum"] / h["count"]
                         if h and h["count"] else 0.0)
        mx = max(times, default=0.0)
        rep = self.report()
        for i, row in enumerate(rep["stages"]):
            row["measured_s"] = times[i]
        rep["measured_bubble_fraction"] = (
            1.0 - (sum(times) / (len(times) * mx)) if mx > 0 else 0.0)
        return rep


def _bubble(stage_times: List[float]) -> float:
    """Steady-state idle share of a synchronous pipeline: every cycle
    takes the bottleneck stage's time, so each other stage idles for
    (max - its own time) of it."""
    mx = max(stage_times, default=0.0)
    if mx <= 0 or len(stage_times) <= 1:
        return 0.0
    return 1.0 - sum(stage_times) / (len(stage_times) * mx)


def _partition_table(ts: List[float], k: int):
    """The linear-partition DP over the first i elements into j parts,
    minimizing the largest part: (prefix sums, best[j][i], cut[j][i])."""
    n = len(ts)
    prefix = [0.0]
    for t in ts:
        prefix.append(prefix[-1] + t)
    inf = float("inf")
    best = [[inf] * (n + 1) for _ in range(k + 1)]
    cut = [[0] * (n + 1) for _ in range(k + 1)]
    best[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(j, n + 1):
            for m in range(j - 1, i):
                cand = max(best[j - 1][m], prefix[i] - prefix[m])
                if cand < best[j][i]:
                    best[j][i] = cand
                    cut[j][i] = m
    return prefix, best, cut


def _bounds(cut, n: int, j: int) -> List[int]:
    """The end index of each of the j parts, in order."""
    bounds: List[int] = []
    i = n
    while j > 0:
        bounds.append(i)
        i = cut[j][i]
        j -= 1
    bounds.reverse()
    return bounds


def segment_plan(costs: Sequence[Tuple[str, float]],
                 ndev: int, *, source: str = "profile") -> SegmentPlan:
    """Optimal contiguous partition of a profiled chain over up to `ndev`
    devices, minimizing the bottleneck stage (the linear-partition DP,
    O(n²k)). `costs` is [(element name, seconds)] in dataflow order;
    elements never profiled cost zero and ride with their neighbours.
    Stage s goes on logical device s."""
    names = [n for n, _ in costs]
    ts = [max(0.0, float(t)) for _, t in costs]
    n = len(ts)
    if n == 0:
        raise BackendError("segment_plan: empty cost profile")
    k = max(1, min(int(ndev), n))
    prefix, best, cut = _partition_table(ts, k)
    # fewer stages can tie the bottleneck (one dominant element): the
    # smallest stage count that reaches it wins, since an extra cut buys
    # nothing but a handoff
    kbest = min(range(1, k + 1), key=lambda j: (best[j][n], j))
    stages, times = [], []
    lo = 0
    for hi in _bounds(cut, n, kbest):
        stages.append(names[lo:hi])
        times.append(prefix[hi] - prefix[lo])
        lo = hi
    return SegmentPlan(stages=stages, devices=list(range(len(stages))),
                       stage_times_s=times, bubble_fraction=_bubble(times),
                       total_s=prefix[n], source=source)


def _tp_speedup(t: int, eff: float) -> float:
    """Modelled speedup of `t` tensor-parallel shards for one stage: each
    doubling buys 2·eff (eff < 1 pays for the gathers), so speedup(t) =
    t · eff^log2(t); speedup(1) == 1."""
    return float(t) * (eff ** max(0, t.bit_length() - 1))


def segment_plan_tp(costs: Sequence[Tuple[str, float]], ndev: int, *,
                    tp_efficiency: float = 0.7,
                    source: str = "profile") -> SegmentPlan:
    """Spend an `ndev`-device budget on pipeline cuts AND shard groups,
    minimizing the modelled bottleneck. For each stage count j the
    partition DP gives the best j-way cut; the j-1 spare devices then go
    greedily to doubling the shard width of the current bottleneck
    stage (widths within `serving.sharding.SUPPORTED_SHARDS`). The j
    with the lowest bottleneck wins; ties prefer fewer stages, then
    fewer devices. `stage_times_s` holds the modelled times after the
    shards; `devices[i]` is the first ordinal of stage i's group."""
    from nnstreamer_tpu_torch.serving.sharding import SUPPORTED_SHARDS

    names = [n for n, _ in costs]
    ts = [max(0.0, float(t)) for _, t in costs]
    n = len(ts)
    if n == 0:
        raise BackendError("segment_plan_tp: empty cost profile")
    if not 0.0 < tp_efficiency <= 1.0:
        raise BackendError(
            f"segment_plan_tp: tp_efficiency must be in (0, 1], "
            f"got {tp_efficiency}")
    ndev = max(1, int(ndev))
    k = min(ndev, n)
    prefix, _, cut = _partition_table(ts, k)
    top_tp = max(SUPPORTED_SHARDS)
    champion = None  # (key, bounds, tps, eff)
    for j in range(1, k + 1):
        bounds = _bounds(cut, n, j)
        raw = []
        lo = 0
        for hi in bounds:
            raw.append(prefix[hi] - prefix[lo])
            lo = hi
        tps = [1] * j
        spare = ndev - j
        # double the bottleneck's width while a doubling fits the budget
        # and lowers the modelled bottleneck
        while True:
            eff = [raw[s] / _tp_speedup(tps[s], tp_efficiency)
                   for s in range(j)]
            b = max(range(j), key=lambda s: eff[s])
            grow = tps[b]  # doubling costs tps[b] more devices
            if (tps[b] * 2 > top_tp or grow > spare
                    or _tp_speedup(tps[b] * 2, tp_efficiency)
                    <= _tp_speedup(tps[b], tp_efficiency)):
                break
            tps[b] *= 2
            spare -= grow
        eff = [raw[s] / _tp_speedup(tps[s], tp_efficiency)
               for s in range(j)]
        key = (max(eff), j, sum(tps))
        if champion is None or key < champion[0]:
            champion = (key, bounds, tps, eff)
    _, bounds, tps, eff = champion
    stages = []
    lo = 0
    for hi in bounds:
        stages.append(names[lo:hi])
        lo = hi
    devices, off = [], 0
    for t in tps:
        devices.append(off)
        off += t
    return SegmentPlan(stages=stages, devices=devices,
                       stage_times_s=eff, bubble_fraction=_bubble(eff),
                       total_s=prefix[n], source=source, tp=tps)


def plan_from_tracer(tracer, names: Sequence[str], ndev: int,
                     tp_efficiency: Optional[float] = None) -> SegmentPlan:
    """A plan from the tracer's per-element proctime histograms
    (`Tracer.hists()`): each element costs its mean process() time;
    elements with no profile cost zero. `tp_efficiency` lets the planner
    trade cuts against shard groups (`segment_plan_tp`); None keeps the
    pure segmentation DP."""
    hists = tracer.hists() if getattr(tracer, "active", False) else {}
    costs = []
    for nm in names:
        h = hists.get(nm)
        costs.append((nm, h["sum"] / h["count"]
                      if h and h["count"] else 0.0))
    if tp_efficiency is not None:
        return segment_plan_tp(costs, ndev, tp_efficiency=tp_efficiency,
                               source="tracer")
    return segment_plan(costs, ndev, source="tracer")


def apply_plan(pipe, plan: SegmentPlan) -> int:
    """Pin each planned stage's filters to its logical device (the
    `accelerator` prop; before negotiation) and record the plan on the
    pipeline, so `fuse_segments` composes within a stage, never across a
    cut. A stage the planner gave a shard group (`plan.tp[i] > 1`) gets
    the `shards` prop instead of a device pin. → elements pinned."""
    pinned = 0
    for si, (group, dev) in enumerate(zip(plan.stages, plan.devices)):
        tp = plan.tp_of(si)
        accel = accelerator_for(dev)
        for name in group:
            e = pipe.elements.get(name)
            if e is None:
                log.warning("apply_plan: element %r not in pipeline "
                            "(already fused?)", name)
                continue
            if tp > 1 and ("shards" in e.PROPS or "shards" in e.props):
                e.props["shards"] = tp
                pinned += 1
            elif "accelerator" in e.PROPS or "accelerator" in e.props:
                e.props["accelerator"] = accel
                pinned += 1
    pipe.segment_plan = plan
    return pinned

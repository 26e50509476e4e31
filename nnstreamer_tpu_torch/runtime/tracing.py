"""Pipeline tracing: span events, interlatency, queue gauges, Chrome trace.

The four GstShark tracers that matter for pipeline tuning, as runtime
citizens (counterpart of the JAX package's runtime/tracing.py):

- proctime    → always-on `ElementStats` (scheduler.py) + "X" span events
                per element invocation when tracing is on
- interlatency→ per-buffer source-timestamp tagging: every source emit
                stamps `buf.meta[SOURCE_TS_META]`; every downstream
                element records (now - source_ts) into a bounded
                reservoir, giving p50/p95/p99 end-to-end latency *per
                element* (the sink rows are the pipeline latency)
- queuelevel  → queue-depth gauges sampled at enqueue/dequeue ("C"
                counter events) + an always-on per-queue high-water mark
- forced syncs and the async window → `record_forced_sync` per element
                (runtime/sync.py) and the in-flight gauge

Two implementations share one duck type: `Tracer` (recording) and
`NullTracer` (`NULL_TRACER`, the default). The scheduler keeps hooks out
of the hot path by guarding every call site with `if tracer.active:` —
a traced-off run pays one attribute load per hook site, nothing else.

Timing model. Every span is host time (`time.perf_counter`). PyTorch
queues CUDA work and returns, so a process span of a DEVICE_RESIDENT
element (tensor_filter) covers the launches only; the card's time for
that frame lands on whichever span waits for it — the decoder's or
sink's read-back, counted as a forced sync. The tracer adds no CUDA
events: device time per kernel belongs to a device profiler.

Ring-buffer discipline: events land in a `collections.deque(maxlen=N)`
under one lock, with the count of events ever recorded, so the count
stays exact across worker threads; when the ring wraps, the oldest
events fall off and `events_dropped` in `summary()` says how many.

Export: `to_chrome_trace()` emits the Trace Event Format JSON that
chrome://tracing and Perfetto load — one named track (tid) per element
thread, "X" complete spans for process/timer/flush/backend work, "C"
counters for queue depth and in-flight windows, "i" instants for EOS,
drops, errors, watchdog warnings and forced syncs.

Request-scoped tracing (the serving edge): a trace context rides
``buf.meta[TRACE_CTX_META]`` across the query wire (`ensure_trace_ctx`,
`stamp_hop`, `hop_spans`); a query server records each completed
request's hop list (`record_request`, `requests`, `tenant_summary`) and
each admission refusal or shed by cause (`record_shed`, `shed_counts`).

Child tracers (serving/pool.py): a worker process runs its own `Tracer`
and ships `ship_delta()` payloads (drained event batches plus monotone
counter and histogram deltas) over its pipe; the parent's `ingest_child`
merges them with a per-worker clock offset sampled at handshake, so
`to_chrome_trace()` renders one Perfetto *process* (track group) per
worker and `summary()` is pool-wide. Counter merging is delta-based,
which keeps parent totals monotone across worker restarts. The payload
layout is the JAX package's: a port child ships to a JAX parent and back.
A pool child also counts its kernel launches here (`record_launches`,
fed by `cuda_graphs.observe_launches`) and ships them under a
``launches`` key of its own, which the JAX parent ignores.
The pool's lifecycle events (`record_worker_event`) and the autotuner's
decisions (`record_autotune`) are kept whole beside the ring.
"""

from __future__ import annotations

import bisect
import math
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

#: TensorBuffer.meta key carrying the pipeline-entry timestamp
#: (time.perf_counter seconds, stamped by the scheduler at source emit).
#: `with_tensors` copies meta, so the stamp survives every element.
SOURCE_TS_META = "_trace_src_ts"

#: TensorBuffer.meta key carrying the request-scoped trace context:
#: ``{"id": <16-hex>, "hops": [{"hop": str, "t": float, "pid": int,
#: ...extra}, ...]}``. Everything inside is wire-JSON-safe (edge/wire.py
#: serializes nested dicts/lists), so the context crosses the query wire
#: intact and comes back in the reply — to a JAX peer too (the same key).
TRACE_CTX_META = "_trace_ctx"


def new_trace_id() -> str:
    """16-hex request id (random, collision-safe at serving scale)."""
    return uuid.uuid4().hex[:16]


def ensure_trace_ctx(meta: dict, trace_id: Optional[str] = None) -> dict:
    """Get-or-create the trace context in `meta`. Creation happens at
    most once per request: a retry path re-offering the SAME buffer finds
    the existing context and keeps its id."""
    ctx = meta.get(TRACE_CTX_META)
    if not isinstance(ctx, dict) or "id" not in ctx:
        ctx = meta[TRACE_CTX_META] = {
            "id": trace_id or new_trace_id(), "hops": []}
    elif not isinstance(ctx.get("hops"), list):
        ctx["hops"] = []
    return ctx


def get_trace_ctx(meta) -> Optional[dict]:
    """The trace context riding `meta`, or None (never creates)."""
    if not isinstance(meta, dict):
        return None
    ctx = meta.get(TRACE_CTX_META)
    return ctx if isinstance(ctx, dict) and "id" in ctx else None


def stamp_hop(meta, hop: str, t: Optional[float] = None,
              **extra) -> Optional[dict]:
    """Append one hop record to the trace context in `meta` — a no-op
    (one dict lookup) when no context rides the buffer, so stamping sites
    can live on the hot path unguarded. Returns the hop record (or None).
    Timestamps are `time.perf_counter()` seconds (CLOCK_MONOTONIC on
    Linux, shared by every process on the host)."""
    ctx = get_trace_ctx(meta)
    if ctx is None:
        return None
    rec = {"hop": hop, "t": time.perf_counter() if t is None else t,
           "pid": os.getpid()}
    if extra:
        rec.update(extra)
    ctx["hops"].append(rec)
    return rec


#: canonical serving-path hop order; hop_spans() derives the per-stage
#: decomposition from it
HOP_STAGES = (
    ("admission_wait_ms", "admit", "dequeue"),
    ("route_ms", "dequeue", "dispatch"),
    ("worker_queue_ms", "dispatch", "worker_recv"),
    ("service_ms", "worker_recv", "worker_done"),
    ("reply_ms", "worker_done", "reply"),
)


def hop_spans(hops: List[dict]) -> Dict[str, Any]:
    """Per-stage latency decomposition (ms) from a hop list: admission
    wait / route / worker queue / service / reply, plus total. For a
    redelivered request the LAST occurrence of each hop wins (the attempt
    that produced the reply); earlier occurrences show up in
    `retries`/`redeliveries` counts instead."""
    last: Dict[str, dict] = {}
    for h in hops:
        if isinstance(h, dict) and "hop" in h and "t" in h:
            last[h["hop"]] = h
    out: Dict[str, Any] = {}
    for key, a, b in HOP_STAGES:
        if a in last and b in last:
            dt = (last[b]["t"] - last[a]["t"]) * 1e3
            if dt >= 0:
                out[key] = round(dt, 3)
    ts = [h["t"] for h in hops if isinstance(h, dict) and "t" in h]
    if len(ts) >= 2:
        out["total_ms"] = round((max(ts) - min(ts)) * 1e3, 3)
    n_send = sum(1 for h in hops if isinstance(h, dict)
                 and h.get("hop") == "client_send")
    if n_send > 1:
        out["retries"] = n_send - 1
    n_re = sum(1 for h in hops if isinstance(h, dict)
               and h.get("hop") == "reoffer")
    if n_re:
        out["redeliveries"] = n_re
    hosts: List[str] = []
    for h in hops:
        if isinstance(h, dict) and h.get("hop") == "dispatch" \
                and "host" in h and str(h["host"]) not in hosts:
            hosts.append(str(h["host"]))
    if hosts:
        out["hosts"] = hosts
    return out


#: the hop chain every REPLIED frame's trace carries on the pooled
#: serving path (client_send/client_recv are recorded locally by the
#: client, not serialized). A redelivered frame repeats hops;
#: completeness only asks that each stage appears at least once.
REQUIRED_REPLY_HOPS = ("admit", "dequeue", "dispatch", "worker_recv",
                       "worker_done", "reply")


def missing_hops(hops: List[dict],
                 required: tuple = REQUIRED_REPLY_HOPS) -> tuple:
    """The required hop names absent from a trace's hop list, in
    canonical order — empty tuple means the chain is complete."""
    seen = {h.get("hop") for h in hops if isinstance(h, dict)}
    return tuple(r for r in required if r not in seen)


def trace_chain_complete(hops: List[dict],
                         required: tuple = REQUIRED_REPLY_HOPS) -> bool:
    """True iff the trace carries the full serving hop chain."""
    return not missing_hops(hops, required)

#: histogram bucket upper bounds (seconds) for per-element proctime —
#: log-spaced 10µs → 10s, the range a pipeline stage can plausibly
#: occupy (the JAX package's bounds, so the two render the same buckets)
HIST_BOUNDS_S = tuple(
    round(10.0 ** (e / 3.0), 9) for e in range(-15, 4))  # 1e-5 .. 10.0


class _Hist:
    """Fixed-bound cumulative histogram: monotone counts (never
    recomputed from a windowed reservoir — two consecutive reads must
    never see a bucket count decrease)."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self):
        self.counts = [0] * (len(HIST_BOUNDS_S) + 1)   # +1 = +Inf
        self.sum = 0.0
        self.count = 0

    def record(self, v: float) -> None:
        self.counts[bisect.bisect_left(HIST_BOUNDS_S, v)] += 1
        self.sum += v
        self.count += 1

    def add_counts(self, counts: List[int], s: float, n: int) -> None:
        for i, c in enumerate(counts[:len(self.counts)]):
            self.counts[i] += c
        self.sum += s
        self.count += n

    def snapshot(self) -> dict:
        return {"bounds": list(HIST_BOUNDS_S),
                "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


def percentile(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile over an already-sorted sample (0.0 when
    empty)."""
    if not sorted_vals:
        return 0.0
    k = max(1, min(len(sorted_vals),
                   math.ceil(p / 100.0 * len(sorted_vals))))
    return sorted_vals[k - 1]


class NullTracer:
    """Do-nothing tracer: the default. Every hook exists so callers can
    skip the `.active` guard where the call is not on a hot path."""

    active = False

    def source_emit(self, name, buf, t):
        pass

    def enqueue(self, dst, depth, t):
        pass

    def dequeue(self, name, depth, t):
        pass

    def record_process(self, name, buf, t0, t1):
        pass

    def record_timer(self, name, t0, t1):
        pass

    def record_flush(self, name, t0, t1):
        pass

    def record_eos(self, name, t):
        pass

    def record_drop(self, name, t):
        pass

    def record_error(self, name, exc_type, t, **args):
        pass

    def record_watchdog(self, name, kind, t, **args):
        pass

    def watchdog_counts(self):
        return {}

    def record_flight(self, kind, t, **args):
        pass

    def flight_dumps(self):
        return []

    def record_device_counter(self, name, value, t):
        pass

    def worker_counts(self):
        return {}

    def backend_span(self, name, kind, t0, t1, **args):
        pass

    def device_span(self, device, kind, t0, t1, **args):
        pass

    def record_swap(self, name, t, **args):
        pass

    def swap_events(self):
        return []

    def record_llm_request(self, name, req_id, t, **args):
        pass

    def record_forced_sync(self, name, t):
        pass

    def record_inflight(self, name, depth, t):
        pass

    def record_compiled_window(self, name, k, t0, t1):
        pass

    def compiled_windows(self):
        return {}

    def record_loop_bail(self, name, cause, t):
        pass

    def loop_bails(self):
        return {}

    def record_shed(self, name, cause, t, **args):
        pass

    def record_worker_event(self, name, wid, kind, t, **args):
        pass

    def record_request(self, name, trace_id, hops, t, **args):
        pass

    def requests(self):
        return []

    def shed_counts(self):
        return {}

    def record_autotune(self, name, knob, t, **args):
        pass

    def enable_shipping(self):
        pass

    def ship_delta(self):
        return None

    def ingest_child(self, wid, pid, payload, offset_s=0.0, label=None):
        pass

    def worker_events(self):
        return []

    def autotune_events(self):
        return []

    def autotune_counts(self):
        return {}

    def children(self):
        return {}

    def tenant_summary(self):
        return {}

    def kernel_spans(self):
        return {}

    def record_launches(self, kernel, n=1):
        pass

    def kernel_launches(self):
        return {}

    def instant(self, name, label, t=None, **args):
        pass


#: shared no-op singleton — scheduler, elements and backends all default
#: to this; PipelineRunner(trace=True) swaps in a recording Tracer
NULL_TRACER = NullTracer()

# event tuple layout: (ph, cat, name, label, ts, dur, args)
_Event = Tuple[str, str, str, str, float, float, Any]


class Tracer(NullTracer):
    """Recording tracer fed by the scheduler's hook points.

    All hooks are called from element worker threads. The event ring
    and its count sit under one lock; each element's interlatency
    reservoir, histogram and per-element counters are written only by
    the thread that runs that element; the gauge peak update is a benign
    read-modify-write between an element's producers and its worker (a
    lost race costs one sample, never a crash).
    """

    active = True

    def __init__(self, max_events: int = 65536,
                 max_latency_samples: int = 8192):
        self._t0 = time.perf_counter()
        self._events: Deque[_Event] = deque(maxlen=max_events)
        self._total_events = 0
        self._lock = threading.Lock()
        self._max_latency_samples = max_latency_samples
        # element name -> reservoir of (t_done - t_source_emit) seconds
        self._interlat: Dict[str, Deque[float]] = {}
        # dst element name -> {"peak": max depth ever sampled}
        self._gauges: Dict[str, Dict[str, int]] = {}
        # model hot-swap adoptions (serving/store.py): kept whole, not
        # just as ring events, so report() renders every swap even after
        # the ring wraps
        self._swaps: List[Tuple[str, float, dict]] = []
        # retired LLM requests (llm/engine.py): kept whole for the same
        # reason — per-request serving latency survives ring wrap
        self._llm_requests: List[Tuple[str, str, float, dict]] = []
        # element name -> count of forced host syncs (runtime/sync.py)
        self._forced: Dict[str, int] = {}
        # (element, kernel) -> backend spans tagged with a kernel= arg
        # (llm_exec prefill/chunk/decode): kept whole like _forced so
        # per-kernel attribution survives ring wrap
        self._kernel_spans: Dict[Tuple[str, str], int] = {}
        # kernel wrapper name -> launches its wrapper counted while this
        # tracer observed them (`cuda_graphs.observe_launches`, set in a
        # pool worker child); a child's ship as deltas, merged w{wid}/
        self._launches: Dict[str, int] = {}
        # element name -> {"peak": max async in-flight depth sampled}
        self._inflight: Dict[str, Dict[str, int]] = {}
        # element name -> {"windows": n, "frames": n} compiled
        # steady-state windows (runtime/compiled_loop.py): kept whole so
        # the compiled-window share survives ring wrap
        self._compiled: Dict[str, Dict[str, int]] = {}
        # element name -> {cause: count} of armed windows that fell back
        # to per-frame mode (kept whole for the same reason)
        self._loop_bails: Dict[str, Dict[str, int]] = {}
        # element name -> cumulative proctime histogram (seconds)
        self._hists: Dict[str, _Hist] = {}
        # element name -> {kind: count} of watchdog warnings: kept whole
        # so the totals survive ring wrap
        self._watchdogs: Dict[str, Dict[str, int]] = {}
        # flight-recorder dumps: kept whole — each one is a post-mortem
        # anchor
        self._flights: List[Tuple[str, float, dict]] = []
        # server name -> {cause: count} of admission sheds/rejections
        # (edge/query.py): kept whole — per-cause totals must survive
        # ring wrap under sustained overload
        self._sheds: Dict[str, Dict[str, int]] = {}
        # completed request timelines (name, trace_id, t_done, hops,
        # args): kept whole, bounded
        self._requests: List[Tuple[str, str, float, list, dict]] = []
        self._max_requests = 4096
        self._requests_dropped = 0
        # worker-pool lifecycle events (serving/pool.py): kept whole — a
        # post-mortem needs the full spawn/kill/restart/degraded sequence
        # even after a chaos run wraps the ring
        self._worker_events: List[Tuple[str, int, str, float, dict]] = []
        # autotuner decisions (serving/autotune.py): bounded keep-whole
        # list with the same FIFO drop scheme as _requests, plus
        # per-knob/outcome counts that survive the drop
        self._autotune: List[Tuple[str, str, float, dict]] = []
        self._max_autotune = 1024
        self._autotune_dropped = 0
        self._autotune_counts: Dict[str, Dict[str, int]] = {}
        # -- worker-side shipping state (enable_shipping/ship_delta) --
        self._shipping = False
        self._ship_samples: Dict[str, List[float]] = {}
        self._shipped_events = 0
        self._ship_prev: Dict[str, Any] = {}
        # -- parent-side child-merge state (ingest_child) --
        # wid -> ring of offset-adjusted child events (own drop budget,
        # so a wrapped parent ring never silently eats child telemetry)
        self._child_events: Dict[int, Deque[_Event]] = {}
        self._child_meta: Dict[int, dict] = {}
        self._child_max_events = max(1024, max_events // 4)

    # -- scheduler hooks ---------------------------------------------------
    def source_emit(self, name: str, buf, t: float) -> None:
        """Stamp the buffer's pipeline-entry time (interlatency origin)."""
        meta = getattr(buf, "meta", None)
        if isinstance(meta, dict):
            meta[SOURCE_TS_META] = t
        self._append("i", "source", name, "emit", t, 0.0, None)

    def enqueue(self, dst: str, depth: int, t: float) -> None:
        self._gauge(dst, depth, t)

    def dequeue(self, name: str, depth: int, t: float) -> None:
        self._gauge(name, depth, t)

    def record_process(self, name: str, buf, t0: float, t1: float) -> None:
        self._append("X", "element", name, "process", t0, t1 - t0, None)
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = _Hist()
        h.record(t1 - t0)
        src_ts = self._buf_source_ts(buf)
        if src_ts is not None:
            r = self._interlat.get(name)
            if r is None:
                r = self._interlat[name] = deque(
                    maxlen=self._max_latency_samples)
            r.append(t1 - src_ts)
            if self._shipping:
                s = self._ship_samples.get(name)
                if s is None:
                    s = self._ship_samples[name] = []
                if len(s) < self._max_latency_samples:
                    s.append(t1 - src_ts)

    def record_timer(self, name: str, t0: float, t1: float) -> None:
        self._append("X", "element", name, "timer", t0, t1 - t0, None)

    def record_flush(self, name: str, t0: float, t1: float) -> None:
        self._append("X", "element", name, "flush", t0, t1 - t0, None)

    def record_eos(self, name: str, t: float) -> None:
        self._append("i", "element", name, "eos", t, 0.0, None)

    def record_drop(self, name: str, t: float) -> None:
        self._append("i", "element", name, "buffer_dropped", t, 0.0, None)

    def record_error(self, name: str, exc_type: str, t: float,
                     **args) -> None:
        """A process() exception handled by the element's error policy
        (args carry the policy and the buffer's pts)."""
        args = dict(args, exc=exc_type)
        self._append("i", "error", name, "error", t, 0.0, args)

    def record_watchdog(self, name: str, kind: str, t: float,
                        **args) -> None:
        """A watchdog warning: kind is "stall" (process() over budget)
        or "queue" (input queue at capacity over budget), counted per
        (element, kind) wrap-proof."""
        c = self._watchdogs.get(name)
        if c is None:
            c = self._watchdogs[name] = {}
        c[kind] = c.get(kind, 0) + 1
        self._append("i", "watchdog", name, f"watchdog_{kind}", t, 0.0,
                     args or None)

    def watchdog_counts(self) -> Dict[str, Dict[str, int]]:
        """Per-element watchdog-kind totals (wrap-proof)."""
        return {name: dict(c) for name, c in self._watchdogs.items()}

    def backend_span(self, name: str, kind: str, t0: float, t1: float,
                     **args) -> None:
        """Backend-side span (invoke; the LLM executor's first run of a
        bucket is "compile") on the owning element's track; args carry
        bucket details. A ``kernel=`` arg (the LLM executor's
        pallas/xla attribution) is additionally counted per (element,
        kernel) — wrap-proof, read back via `kernel_spans()`."""
        kern = (args or {}).get("kernel")
        if kern is not None:
            key = (name, str(kern))
            self._kernel_spans[key] = self._kernel_spans.get(key, 0) + 1
        self._append("X", "backend", name, kind, t0, t1 - t0, args or None)

    def kernel_spans(self) -> Dict[Tuple[str, str], int]:
        """(element, kernel) -> count of kernel-tagged backend spans."""
        return dict(self._kernel_spans)

    def record_launches(self, kernel: str, n: int = 1) -> None:
        """`n` launches of the kernel wrapper `kernel`, as its launch
        counter (`cuda_graphs.count_launch`) counted them."""
        with self._lock:
            self._launches[kernel] = self._launches.get(kernel, 0) + n

    def kernel_launches(self) -> Dict[str, int]:
        """Launches by kernel wrapper; a child's under ``w{wid}/``."""
        with self._lock:
            return dict(self._launches)

    def device_span(self, device: int, kind: str, t0: float, t1: float,
                    **args) -> None:
        """Per-device span (replica invoke / shard stage): one track per
        card (``dev0``..``devN``); args carry the owning element."""
        self._append("X", "device", f"dev{int(device)}", kind, t0,
                     t1 - t0, args or None)

    def record_shed(self, name: str, cause: str, t: float,
                    **args) -> None:
        """One request refused or shed at a query server's admission
        queue (edge/query.py). `cause` is the admission taxonomy:
        queue_full / inflight_full / deadline / reject_oldest /
        dispatch_error / shutdown. Dict writes under the GIL — a lost
        race between two threads costs one count at worst."""
        c = self._sheds.get(name)
        if c is None:
            c = self._sheds[name] = {}
        c[cause] = c.get(cause, 0) + 1
        self._append("i", "admission", name, f"shed_{cause}", t, 0.0,
                     args or None)

    def shed_counts(self) -> Dict[str, Dict[str, int]]:
        return {name: dict(c) for name, c in self._sheds.items()}

    def record_worker_event(self, name: str, wid: int, kind: str,
                            t: float, **args) -> None:
        """One worker-pool lifecycle event (serving/pool.py). `kind` is
        the supervision taxonomy: spawn / ready / kill / exit / restart
        / reoffer / degraded / swap_commit / swap_abort / drain_stop.
        wid is the pool slot (-1 for pool-level events like swaps)."""
        self._worker_events.append((name, wid, kind, t, dict(args)))
        self._append("i", "worker", f"{name}/w{wid}", f"worker_{kind}",
                     t, 0.0, args or None)

    def worker_events(self) -> List[Tuple[str, int, str, float, dict]]:
        return list(self._worker_events)

    def worker_counts(self) -> Dict[str, Dict[str, int]]:
        """Per-pool event-kind totals (the summary() view; the full
        ordered sequence is worker_events())."""
        out: Dict[str, Dict[str, int]] = {}
        for name, _wid, kind, _t, _args in list(self._worker_events):
            c = out.setdefault(name, {})
            c[kind] = c.get(kind, 0) + 1
        return out

    def record_autotune(self, name: str, knob: str, t: float,
                        **args) -> None:
        """One autotuner decision (serving/autotune.py); args carry
        old/new/outcome plus the sensor evidence that justified it.
        Single writer (the controller thread)."""
        self._autotune.append((name, knob, t, dict(args)))
        if len(self._autotune) > self._max_autotune:
            drop = max(1, self._max_autotune // 4)
            del self._autotune[:drop]
            self._autotune_dropped += drop
        c = self._autotune_counts.get(knob)
        if c is None:
            c = self._autotune_counts[knob] = {}
        outcome = str(args.get("outcome", "unknown"))
        c[outcome] = c.get(outcome, 0) + 1
        self._append("i", "autotune", name, f"tune_{knob}", t, 0.0,
                     args or None)

    def autotune_events(self) -> List[Tuple[str, str, float, dict]]:
        return list(self._autotune)

    def autotune_counts(self) -> Dict[str, Dict[str, int]]:
        return {k: dict(v) for k, v in self._autotune_counts.items()}

    def record_request(self, name: str, trace_id: str, hops: List[dict],
                       t: float, **args) -> None:
        """One completed request timeline: `hops` is the trace-context
        hop list that came back with the reply (edge/query.py). Kept
        whole (bounded FIFO) so timelines survive ring wrap."""
        if len(self._requests) >= self._max_requests:
            del self._requests[:self._max_requests // 4]
            self._requests_dropped += self._max_requests // 4
        self._requests.append(
            (name, trace_id, t, [dict(h) for h in hops
                                 if isinstance(h, dict)], dict(args)))
        self._append("i", "request", name, "request_done", t, 0.0,
                     dict(args, trace_id=trace_id, hops=len(hops)))

    def requests(self) -> List[Tuple[str, str, float, list, dict]]:
        return list(self._requests)

    def tenant_summary(self) -> Dict[str, dict]:
        """Per-tenant rollup over the bounded request window: completed
        count, completion rate across the window span, and server-side
        latency percentiles (first recorded hop → completion). Only
        requests recorded with a ``tenant=`` arg contribute (the query
        server adds it when admission stamped a tenant class) — what the
        ScalingController reads for per-tenant demand."""
        acc: Dict[str, dict] = {}
        for _name, _tid, t, hops, args in list(self._requests):
            tenant = args.get("tenant")
            if tenant is None:
                continue
            row = acc.setdefault(
                tenant, {"count": 0, "lat": [], "t0": t, "t1": t})
            row["count"] += 1
            row["t0"] = min(row["t0"], t)
            row["t1"] = max(row["t1"], t)
            ts = [h["t"] for h in hops
                  if isinstance(h.get("t"), (int, float))]
            if ts:
                row["lat"].append(max(0.0, t - min(ts)))
        out: Dict[str, dict] = {}
        for tenant, row in acc.items():
            lat = sorted(row["lat"])
            span = row["t1"] - row["t0"]
            out[tenant] = {
                "count": row["count"],
                "rate_hz": (row["count"] - 1) / span
                if row["count"] > 1 and span > 0 else float(row["count"]),
                "p50_ms": 1e3 * percentile(lat, 50.0),
                "p99_ms": 1e3 * percentile(lat, 99.0),
            }
        return out

    def record_swap(self, name: str, t: float, **args) -> None:
        """A store-driven model hot swap adopted by `name` (the torch
        backend's and the LLM executor's adoption); args carry model/
        from_version/to_version/epoch/prewarmed."""
        self._swaps.append((name, t, dict(args)))
        self._append("i", "swap", name, "model_swap", t, 0.0,
                     args or None)

    def swap_events(self) -> List[Tuple[str, float, dict]]:
        return list(self._swaps)

    def record_llm_request(self, name: str, req_id: str, t: float,
                           **args) -> None:
        """One retired LLM request (llm/engine.py); args carry the
        request summary: prompt_len/n_tokens/first_token_ms/itl_p50_ms/
        finish_reason. Kept whole so per-request serving latency
        survives ring wrap."""
        self._llm_requests.append((name, req_id, t, dict(args)))
        self._append("i", "llm", name, "llm_request", t, 0.0,
                     dict(args, req_id=req_id))

    def llm_requests(self) -> List[Tuple[str, str, float, dict]]:
        return list(self._llm_requests)

    def record_forced_sync(self, name: str, t: float) -> None:
        """A semantic host sync (runtime/sync.py device_sync or to_host
        with forced=True): a decoder or sink reading results back, the
        LLM engine's whole-step read-back. These are the host-path tax
        async dispatch exists to remove — count per element."""
        self._forced[name] = self._forced.get(name, 0) + 1
        self._append("i", "sync", name, "forced_sync", t, 0.0, None)

    def forced_syncs(self) -> Dict[str, int]:
        return dict(self._forced)

    def record_inflight(self, name: str, depth: int, t: float) -> None:
        """Async-dispatch window gauge: number of unresolved device
        results a DEVICE_RESIDENT element holds in flight (sampled after
        the window drain, so the recorded peak never exceeds
        [runtime] max_inflight)."""
        g = self._inflight.get(name)
        if g is None:
            g = self._inflight[name] = {"peak": 0}
        if depth > g["peak"]:
            g["peak"] = depth
        self._append("C", "inflight", name, "inflight_dispatch", t, 0.0,
                     depth)

    def inflight_gauges(self) -> Dict[str, dict]:
        return {name: dict(g) for name, g in self._inflight.items()}

    def record_compiled_window(self, name: str, k: int, t0: float,
                               t1: float) -> None:
        """One compiled steady-state window (runtime/compiled_loop.py):
        `k` frames served by one backend invoke_window (one CUDA-graph
        replay on the card). Counted wrap-proof per element."""
        c = self._compiled.get(name)
        if c is None:
            c = self._compiled[name] = {"windows": 0, "frames": 0}
        c["windows"] += 1
        c["frames"] += int(k)
        self._append("X", "element", name, "compiled_window", t0,
                     t1 - t0, {"frames": int(k)})

    def compiled_windows(self) -> Dict[str, Dict[str, int]]:
        """Per-element {"windows": n, "frames": n} totals (wrap-proof)."""
        return {name: dict(c) for name, c in self._compiled.items()}

    def record_loop_bail(self, name: str, cause: str, t: float) -> None:
        """An armed compiled window fell back to per-frame mode; cause is
        one of compiled_loop.BAIL_CAUSES."""
        c = self._loop_bails.get(name)
        if c is None:
            c = self._loop_bails[name] = {}
        c[cause] = c.get(cause, 0) + 1
        self._append("i", "element", name, f"loop_bail_{cause}", t,
                     0.0, None)

    def loop_bails(self) -> Dict[str, Dict[str, int]]:
        """Per-element {cause: count} bail totals (wrap-proof)."""
        return {name: dict(c) for name, c in self._loop_bails.items()}

    def record_flight(self, kind: str, t: float, **args) -> None:
        """One flight-recorder dump; args carry the bundle path and
        trigger cause. Kept whole — dumps are rare."""
        self._flights.append((kind, t, dict(args)))
        self._append("i", "flight", "flightrec", f"flight_{kind}", t,
                     0.0, args or None)

    def flight_dumps(self) -> List[Tuple[str, float, dict]]:
        return list(self._flights)

    def record_device_counter(self, name: str, value: float,
                              t: float) -> None:
        """Device-plane counter sample (utilization per bucket, memory
        per device), rendered as a Chrome-trace counter track."""
        self._append("C", "devprof", name, "devprof", t, 0.0, value)

    def instant(self, name: str, label: str, t: Optional[float] = None,
                **args) -> None:
        if t is None:
            t = time.perf_counter()
        self._append("i", "element", name, label, t, 0.0, args or None)

    # -- worker-side shipping ----------------------------------------------
    def enable_shipping(self) -> None:
        """Mark this tracer as a worker-side child that will be drained
        by periodic `ship_delta()` calls (serving/worker.py heartbeat
        thread). Turns on the interlatency sample side-buffer; without
        shipping enabled that buffer is never touched."""
        self._shipping = True

    def ship_delta(self) -> Optional[dict]:
        """Drain everything recorded since the last ship into one
        picklable payload for the supervisor pipe, or None when nothing
        happened. Counters and histograms ship as DELTAS, not
        cumulative values: the parent adds them, which keeps pool-level
        totals monotone across worker restarts (a replacement worker
        simply resumes contributing deltas from zero)."""
        prev = self._ship_prev
        payload: Dict[str, Any] = {}

        with self._lock:
            events = list(self._events)
            self._events.clear()
            total = self._total_events
            self._shipped_events += len(events)
        if events:
            payload["events"] = events
        total_prev = prev.get("total_events", 0)
        if total != total_prev:
            payload["events_total_delta"] = total - total_prev
            prev["total_events"] = total
        dropped = max(0, total - self._shipped_events)
        drop_prev = prev.get("events_dropped", 0)
        if dropped != drop_prev:
            payload["events_dropped_delta"] = dropped - drop_prev
            prev["events_dropped"] = dropped

        hist_prev = prev.setdefault("hists", {})
        hist_out = {}
        for name, h in list(self._hists.items()):
            p = hist_prev.get(name)
            if p is None:
                p = hist_prev[name] = {
                    "counts": [0] * len(h.counts), "sum": 0.0, "count": 0}
            if h.count != p["count"]:
                counts, hsum, hcount = list(h.counts), h.sum, h.count
                hist_out[name] = {
                    "counts": [c - pc for c, pc
                               in zip(counts, p["counts"])],
                    "sum": hsum - p["sum"],
                    "count": hcount - p["count"],
                }
                p["counts"] = counts
                p["sum"], p["count"] = hsum, hcount
        if hist_out:
            payload["hists"] = hist_out

        forced_prev = prev.setdefault("forced", {})
        forced_out = {}
        for name, n in list(self._forced.items()):
            d = n - forced_prev.get(name, 0)
            if d:
                forced_out[name] = d
                forced_prev[name] = n
        if forced_out:
            payload["forced"] = forced_out

        # read after the histograms: a frame's launch is counted before
        # its process span ends, so a payload never ships a span whose
        # launch it lacks
        launch_prev = prev.setdefault("launches", {})
        launch_out = {}
        for name, n in self.kernel_launches().items():
            d = n - launch_prev.get(name, 0)
            if d:
                launch_out[name] = d
                launch_prev[name] = n
        if launch_out:
            payload["launches"] = launch_out

        shed_prev = prev.setdefault("sheds", {})
        shed_out: Dict[str, Dict[str, int]] = {}
        for name, causes in list(self._sheds.items()):
            p = shed_prev.setdefault(name, {})
            for cause, n in list(causes.items()):
                d = n - p.get(cause, 0)
                if d:
                    shed_out.setdefault(name, {})[cause] = d
                    p[cause] = n
        if shed_out:
            payload["sheds"] = shed_out

        if self._ship_samples:
            samples, self._ship_samples = self._ship_samples, {}
            payload["interlat"] = samples

        for key, src in (("swaps", self._swaps),
                         ("worker_events", self._worker_events),
                         ("requests", self._requests)):
            i = prev.get(f"n_{key}", 0)
            if len(src) > i:
                payload[key] = src[i:]
                prev[f"n_{key}"] = len(src)

        gauges = {name: g["peak"] for name, g in list(self._gauges.items())}
        if gauges != prev.get("gauges"):
            payload["gauges"] = gauges
            prev["gauges"] = dict(gauges)
        inflight = {name: g["peak"]
                    for name, g in list(self._inflight.items())}
        if inflight != prev.get("inflight"):
            payload["inflight"] = inflight
            prev["inflight"] = dict(inflight)

        return payload or None

    # -- parent-side child merge -------------------------------------------
    def ingest_child(self, wid: int, pid: int, payload: dict,
                     offset_s: float = 0.0,
                     label: Optional[str] = None) -> None:
        """Merge one `ship_delta()` payload from worker slot `wid`.
        Child element names are namespaced `w{wid}/` so per-element
        stats never collide across workers; child events land in a
        per-worker ring (own drop budget) with `offset_s` applied, so a
        wrapped parent ring never silently eats child telemetry and
        `to_chrome_trace()` can render one process track group per
        worker."""
        meta = self._child_meta.get(wid)
        if meta is None:
            meta = self._child_meta[wid] = {
                "pid": pid, "label": label or f"worker{wid}",
                "offset_s": offset_s, "events_total": 0,
                "events_dropped_child": 0, "batches": 0}
        else:
            # a restarted slot reuses the ring but tracks the new pid
            meta["pid"] = pid
            meta["offset_s"] = offset_s
            if label:
                meta["label"] = label
        meta["batches"] += 1
        pfx = f"w{wid}/"

        events = payload.get("events")
        if events:
            ring = self._child_events.get(wid)
            if ring is None:
                ring = self._child_events[wid] = deque(
                    maxlen=self._child_max_events)
            for ev in events:
                ph, cat, name, lbl, ts, dur, args = ev
                ring.append((ph, cat, name, lbl, ts + offset_s, dur,
                             args))
            meta["events_total"] += len(events)
        meta["events_dropped_child"] += payload.get(
            "events_dropped_delta", 0)

        for name, h in payload.get("hists", {}).items():
            dst = self._hists.get(pfx + name)
            if dst is None:
                dst = self._hists[pfx + name] = _Hist()
            dst.add_counts(h["counts"], h["sum"], h["count"])

        for name, d in payload.get("forced", {}).items():
            key = pfx + name
            self._forced[key] = self._forced.get(key, 0) + d

        for name, d in payload.get("launches", {}).items():
            self.record_launches(pfx + name, d)

        for name, causes in payload.get("sheds", {}).items():
            c = self._sheds.setdefault(pfx + name, {})
            for cause, d in causes.items():
                c[cause] = c.get(cause, 0) + d

        for name, samples in payload.get("interlat", {}).items():
            r = self._interlat.get(pfx + name)
            if r is None:
                r = self._interlat[pfx + name] = deque(
                    maxlen=self._max_latency_samples)
            r.extend(samples)

        for name, t, args in payload.get("swaps", ()):
            self._swaps.append((pfx + name, t + offset_s, dict(args)))
        for name, w, kind, t, args in payload.get("worker_events", ()):
            self._worker_events.append(
                (pfx + name, w, kind, t + offset_s, dict(args)))
        for name, tid_, t, hops, args in payload.get("requests", ()):
            self.record_request(pfx + name, tid_, hops, t + offset_s,
                                **args)

        for name, peak in payload.get("gauges", {}).items():
            g = self._gauges.setdefault(pfx + name, {"peak": 0})
            if peak > g["peak"]:
                g["peak"] = peak
        for name, peak in payload.get("inflight", {}).items():
            g = self._inflight.setdefault(pfx + name, {"peak": 0})
            if peak > g["peak"]:
                g["peak"] = peak

    def children(self) -> Dict[int, dict]:
        """Per-worker merge bookkeeping: pid, label, clock offset,
        events ingested, and the two drop budgets (child-reported +
        parent-ring)."""
        out = {}
        for wid, meta in list(self._child_meta.items()):
            m = dict(meta)
            ring = self._child_events.get(wid)
            kept = len(ring) if ring is not None else 0
            m["events_kept"] = kept
            m["events_dropped"] = (m["events_dropped_child"]
                                   + max(0, m["events_total"] - kept))
            out[wid] = m
        return out

    # -- internals ---------------------------------------------------------
    def _append(self, ph: str, cat: str, name: str, label: str,
                ts: float, dur: float, args) -> None:
        with self._lock:
            self._total_events += 1
            self._events.append((ph, cat, name, label, ts, dur, args))

    @staticmethod
    def _buf_source_ts(buf) -> Optional[float]:
        """Earliest source stamp reachable from `buf`: its own, or for a
        micro-batch the oldest frame's (the deadline-bound frame, whose
        latency matters)."""
        meta = getattr(buf, "meta", None)
        if not isinstance(meta, dict):
            return None
        ts = meta.get(SOURCE_TS_META)
        if ts is not None:
            return ts
        db = meta.get("dyn_batch")
        if isinstance(db, dict):
            stamps = [f["meta"][SOURCE_TS_META]
                      for f in db.get("frames", ())
                      if isinstance(f.get("meta"), dict)
                      and SOURCE_TS_META in f["meta"]]
            if stamps:
                return min(stamps)
        return None

    def _gauge(self, dst: str, depth: int, t: float) -> None:
        g = self._gauges.get(dst)
        if g is None:
            g = self._gauges[dst] = {"peak": 0}
        if depth > g["peak"]:
            g["peak"] = depth
        self._append("C", "queue", dst, "queue_depth", t, 0.0, depth)

    # -- read-out ----------------------------------------------------------
    def events(self) -> List[_Event]:
        return list(self._events)

    @property
    def total_events(self) -> int:
        """Monotone count of every event ever recorded in the tree
        (never decreases when the ring wraps; ring length is
        `len(events())`); on a pool parent, children's events too."""
        n = self._total_events
        for m in list(self._child_meta.values()):
            n += m["events_total"]
        return n

    @property
    def events_dropped(self) -> int:
        """Events lost anywhere in the tree: this ring's wrap losses
        (events shipped to a parent are not drops) plus, on a pool
        parent, every child's, child-reported and parent-ring alike."""
        own = max(0, self._total_events - self._shipped_events
                  - len(self._events))
        for m in self.children().values():
            own += m["events_dropped"]
        return own

    def hists(self) -> Dict[str, dict]:
        """Per-element cumulative proctime histograms (snapshot dicts)."""
        return {name: h.snapshot() for name, h in self._hists.items()}

    def interlatency(self) -> Dict[str, dict]:
        """Per-element end-to-end latency percentiles (ms) from source
        emit to completion of that element's process()."""
        out = {}
        for name, r in self._interlat.items():
            vals = sorted(r)
            if not vals:
                continue
            out[name] = {
                "n": len(vals),
                "p50_ms": 1e3 * percentile(vals, 50),
                "p95_ms": 1e3 * percentile(vals, 95),
                "p99_ms": 1e3 * percentile(vals, 99),
                "max_ms": 1e3 * vals[-1],
            }
        return out

    def queue_gauges(self) -> Dict[str, dict]:
        return {name: dict(g) for name, g in self._gauges.items()}

    def summary(self) -> dict:
        """The JAX package's summary keys."""
        return {
            "interlatency": self.interlatency(),
            "queues": self.queue_gauges(),
            "events": len(self._events),
            "events_dropped": self.events_dropped,
            "swaps": len(self._swaps),
            "llm_requests": len(self._llm_requests),
            "forced_syncs": dict(self._forced),
            "inflight": self.inflight_gauges(),
            "sheds": self.shed_counts(),
            "workers": self.worker_counts(),
            "autotune": self.autotune_counts(),
            "requests": len(self._requests) + self._requests_dropped,
            "children": {str(wid): m
                         for wid, m in self.children().items()},
        }

    def to_chrome_trace(self, pipeline_name: str = "pipeline") -> dict:
        """Trace Event Format dict — `json.dump` it and load the file in
        Perfetto or chrome://tracing. pid 0 is this process, one tid per
        element in order of first appearance; each ingested worker gets
        its own pid (= wid + 1), so it renders as its own Perfetto
        process track group, named from the handshake label. ts/dur in
        µs relative to tracer creation."""
        trace: List[dict] = []
        tids_by_pid: Dict[int, Dict[str, int]] = {}

        def add_process(pid: int, pname: str) -> None:
            trace.append({"ph": "M", "name": "process_name", "pid": pid,
                          "tid": 0, "args": {"name": pname}})

        def tid_of(pid: int, name: str) -> int:
            tids = tids_by_pid.setdefault(pid, {})
            t = tids.get(name)
            if t is None:
                t = tids[name] = len(tids) + 1
                trace.append({"ph": "M", "name": "thread_name", "pid": pid,
                              "tid": t, "args": {"name": name}})
            return t

        def emit(pid: int, events) -> None:
            for ph, cat, name, label, ts, dur, args in events:
                us = round((ts - self._t0) * 1e6, 3)
                if ph == "X":
                    ev = {"ph": "X", "cat": cat, "name": label, "pid": pid,
                          "tid": tid_of(pid, name), "ts": us,
                          "dur": round(dur * 1e6, 3)}
                    if args:
                        ev["args"] = dict(args)
                elif ph == "C":
                    if cat == "devprof":
                        ev = {"ph": "C", "cat": cat, "name": name,
                              "pid": pid, "tid": 0, "ts": us,
                              "args": {"value": args}}
                    else:
                        track = "inflight" if cat == "inflight" else "queue"
                        ev = {"ph": "C", "cat": cat,
                              "name": f"{track}:{name}", "pid": pid,
                              "tid": 0, "ts": us, "args": {"depth": args}}
                else:  # "i" instant, scoped to the element's track
                    ev = {"ph": "i", "cat": cat, "name": label, "pid": pid,
                          "tid": tid_of(pid, name), "ts": us, "s": "t"}
                    if args:
                        ev["args"] = dict(args)
                trace.append(ev)

        add_process(0, pipeline_name)
        emit(0, list(self._events))
        for wid in sorted(self._child_events):
            meta = self._child_meta.get(wid, {})
            add_process(wid + 1,
                        f"{meta.get('label', f'worker{wid}')} "
                        f"(pid {meta.get('pid', '?')})")
            emit(wid + 1, list(self._child_events[wid]))
        return {"traceEvents": trace, "displayTimeUnit": "ms"}


def merge_chrome_traces(docs: List[dict],
                        labels: Optional[List[str]] = None) -> dict:
    """Merge several Trace Event Format documents (each from
    `to_chrome_trace`) into one, remapping pids so every input keeps
    its own process track groups — the `trace --merge` CLI. `labels`
    (optional, parallel to `docs`) prefix each input's process names so
    the Perfetto sidebar says which file a track came from."""
    merged: List[dict] = []
    base = 0
    for i, doc in enumerate(docs):
        events = doc.get("traceEvents", []) if isinstance(doc, dict) \
            else list(doc)
        label = labels[i] if labels and i < len(labels) else None
        top = 0
        for ev in events:
            pid = ev.get("pid", 0)
            top = max(top, pid if isinstance(pid, int) else 0)
            ev = dict(ev, pid=(pid if isinstance(pid, int) else 0) + base)
            if (label and ev.get("ph") == "M"
                    and ev.get("name") == "process_name"):
                args = dict(ev.get("args") or {})
                args["name"] = f"{label}/{args.get('name', '?')}"
                ev["args"] = args
            merged.append(ev)
        base += top + 1
    return {"traceEvents": merged, "displayTimeUnit": "ms"}

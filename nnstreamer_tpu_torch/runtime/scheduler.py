"""Push-model streaming scheduler, per-frame mode.

One worker thread per element with a bounded input channel per element —
the analog of GStreamer's streaming threads plus queues. Every link is
double-buffered, so a filter's device work overlaps upstream conversion.

- Sources run a pump thread iterating `generate()`.
- Every buffer goes to `Element.process(pad, buf)`; emissions are routed
  by (element, src_pad) → link → destination channel.
- EOS: one sentinel per pad; when all sink pads of an element saw EOS,
  its `flush()` drains, then EOS cascades.
- Errors: under the default `error-policy=fail` any exception in a
  worker stops the pipeline and re-raises from `wait()` (fail loud,
  never hang). skip / retry:N[:backoff_ms] / degrade are enforced per
  element (`_process_with_policy`), with run-level escalation after
  `max_consecutive_errors` policy-handled errors in a row.
- Watchdog (default on): a monitor thread flags an element inside
  process()/flush() longer than `stall_budget_s` and an input queue at
  capacity longer than `queue_stall_budget_s`, and an admission queue
  (an element with `admission_counters()`, tensor_query_serversrc)
  pinned at max_pending with no reply for that budget;
  `watchdog_action=fail` tears the pipeline down with WatchdogStall.
- Backpressure: bounded channels block the producer ([runtime]
  queue_capacity).
- Chain fusion ([runtime] chain_fusion, default on): maximal linear
  runs of cheap single-in/single-out elements with `error-policy=fail`
  (converter→transform→decoder chains) execute in ONE worker thread
  with direct call-through. tensor_filter (CHAIN_FUSABLE=False: its
  thread is what overlaps its launches with upstream conversion),
  sources/sinks, fan-in/fan-out, non-fail policies and timer elements
  keep their own threads. Stats, tracing and EOS/flush ordering stay
  attributed per element.
- Async dispatch window ([runtime] max_inflight): a DEVICE_RESIDENT
  element's worker passes its outputs on while their device work is
  still queued, and syncs the oldest once more than max_inflight are in
  flight. Sinks and host decoders are the pipeline's sync points; EOS
  drains the window before it propagates.
- Timers: a worker bounds its channel wait by its element's
  `next_deadline()` and fires `on_timer()` when it passes with no input
  (tensor_llm runs one serving step per fire).
- Compiled steady-state loop ([runtime] compiled_loop, default on):
  after `compiled_loop_arm` identical-signature frames a fail-fast
  tensor_filter's worker sweeps up to `compiled_loop_window` frames
  already queued into one window (`process_window`; one CUDA-graph
  replay on the card), rounded down to a power of two; shape changes,
  errors, pending swaps, armed timers and EOS bail back to per-frame
  mode, counted by cause (runtime/compiled_loop.py). Fused chains never
  enter a window.
- Observability: always-on `ElementStats` per element (`stats()`,
  `report()`); with `trace=True` a recording `Tracer` gets every hook,
  each behind one `if tracer.active:` test (runtime/tracing.py says how
  to read host spans of device work).

The JAX package's device segments are not ported yet, so neither their
runner knob nor their report section exists here.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.core.config import get_config
from nnstreamer_tpu_torch.core.errors import (
    CircuitOpenError, PipelineError, StreamError, WatchdogStall)
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.graph.pipeline import Element, Link, Pipeline, SourceElement
from nnstreamer_tpu_torch.runtime.channel import CLOSED, TIMED_OUT, Channel
from nnstreamer_tpu_torch.runtime.compiled_loop import (
    LoopStats, SteadyStateDetector, frame_signature)
from nnstreamer_tpu_torch.runtime.sync import device_sync
from nnstreamer_tpu_torch.runtime.tracing import NULL_TRACER, Tracer
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

log = get_logger("runtime")


class _EOSType:
    def __repr__(self):
        return "EOS"


#: end-of-stream sentinel
EOS = _EOSType()


class _ChainFailure(Exception):
    """A fused-chain member's process()/flush() raised; carries the
    failing element so `_fail` attributes the error correctly."""

    def __init__(self, elem: Element, exc: BaseException):
        super().__init__(str(exc))
        self.elem = elem
        self.exc = exc


class ElementStats:
    """Per-element processing-time counters (the GstShark proctime
    tracer analog), always on. Read via PipelineRunner.stats()."""

    __slots__ = ("buffers", "total_s", "max_s", "wait_s", "wait_max_s",
                 "timer_fires", "dropped", "queue_peak", "errors",
                 "retries", "skipped", "degraded", "watchdog_warnings",
                 "event_errors")

    def __init__(self):
        self.buffers = 0
        self.total_s = 0.0
        self.max_s = 0.0
        # time buffers spent parked in this element's input queue —
        # separates "this element is slow" (proctime) from "this element
        # is starved or stalled behind others" (queue wait)
        self.wait_s = 0.0
        self.wait_max_s = 0.0
        # deadline wakeups delivered to on_timer()
        self.timer_fires = 0
        # buffers this element emitted that teardown aborted mid-put
        # (counted on the *producer* so the loss is attributable)
        self.dropped = 0
        # high-water mark of this element's input queue (capacity is the
        # runner's queue_capacity)
        self.queue_peak = 0
        # -- robustness counters (error-policy machinery) ------------------
        # process() exceptions caught under this element's error policy
        # (every failed attempt counts, so retries show up here too)
        self.errors = 0
        # re-invocations attempted under retry:N
        self.retries = 0
        # input buffers abandoned after an error (skip policy, or retry
        # budget exhausted). Conservation per pipeline:
        # emitted + skipped + dropped == generated
        self.skipped = 0
        # input buffers routed to the fallback src pad (degrade policy)
        self.degraded = 0
        # watchdog incidents flagged against this element
        self.watchdog_warnings = 0
        # handle_upstream_event() exceptions (event not consumed,
        # propagation continues past this element)
        self.event_errors = 0

    def record(self, dt: float) -> None:
        self.buffers += 1
        self.total_s += dt
        if dt > self.max_s:
            self.max_s = dt

    def record_wait(self, dt: float) -> None:
        self.wait_s += dt
        if dt > self.wait_max_s:
            self.wait_max_s = dt

    @property
    def avg_us(self) -> float:
        return 1e6 * self.total_s / self.buffers if self.buffers else 0.0

    def as_dict(self) -> dict:
        return {"buffers": self.buffers, "proctime_avg_us": self.avg_us,
                "proctime_max_us": 1e6 * self.max_s,
                "proctime_total_s": self.total_s,
                "queue_wait_avg_us": (1e6 * self.wait_s / self.buffers
                                      if self.buffers else 0.0),
                "queue_wait_max_us": 1e6 * self.wait_max_s,
                "timer_fires": self.timer_fires,
                "dropped": self.dropped,
                "queue_peak": self.queue_peak,
                "errors": self.errors,
                "retries": self.retries,
                "skipped": self.skipped,
                "degraded": self.degraded,
                "watchdog_warnings": self.watchdog_warnings,
                "event_errors": self.event_errors}


class PipelineRunner:
    """Runs a negotiated pipeline: one worker thread per element (or per
    fused chain).

    Knobs (None = the [runtime] config key, same defaults as the JAX
    package): `trace` (False → the shared NULL_TRACER, True → a fresh
    Tracer, or a tracer object), `max_consecutive_errors` (100; 0 never
    escalates), `watchdog` (on), `stall_budget_s` (30.0),
    `queue_stall_budget_s` (= stall_budget_s), `watchdog_action` (warn |
    fail), `chain_fusion` (on), `max_inflight` (8), `queue_capacity` (4),
    `compiled_loop` (on), `compiled_loop_window` (8, at least 2),
    `compiled_loop_arm` (4).
    """

    def __init__(self, pipeline: Pipeline, queue_capacity: Optional[int] = None,
                 optimize: bool = True, trace=False,
                 max_consecutive_errors: Optional[int] = None,
                 watchdog: Optional[bool] = None,
                 stall_budget_s: Optional[float] = None,
                 queue_stall_budget_s: Optional[float] = None,
                 watchdog_action: Optional[str] = None,
                 chain_fusion: Optional[bool] = None,
                 max_inflight: Optional[int] = None,
                 compiled_loop: Optional[bool] = None,
                 compiled_loop_window: Optional[int] = None,
                 compiled_loop_arm: Optional[int] = None):
        self.pipeline = pipeline
        self._optimize = optimize
        if hasattr(trace, "active"):
            self.tracer = trace
        elif trace:
            self.tracer = Tracer()
        else:
            self.tracer = NULL_TRACER
        cfg = get_config()
        self._cap = max(1, queue_capacity
                        or cfg.get_int("runtime", "queue_capacity", 4))
        if max_inflight is None:
            max_inflight = cfg.get_int("runtime", "max_inflight", 8)
        self._max_inflight = max(0, max_inflight)
        if chain_fusion is None:
            chain_fusion = cfg.get_bool("runtime", "chain_fusion", True)
        self._chain_fusion = bool(chain_fusion)
        # compiled steady-state loop: arm after N identical-signature
        # frames, then sweep <= K queued frames into one window
        if compiled_loop is None:
            compiled_loop = cfg.get_bool("runtime", "compiled_loop", True)
        self._compiled_loop = bool(compiled_loop)
        if compiled_loop_window is None:
            compiled_loop_window = cfg.get_int(
                "runtime", "compiled_loop_window", 8)
        self._loop_window = max(2, compiled_loop_window)
        if compiled_loop_arm is None:
            compiled_loop_arm = cfg.get_int("runtime", "compiled_loop_arm", 4)
        self._loop_arm = max(1, compiled_loop_arm)
        # element name -> LoopStats, only for elements whose worker runs
        # with the loop on
        self._loop_stats: Dict[str, LoopStats] = {}
        # head name -> ordered members; member name -> head name (built
        # in start(), after transform fusion)
        self._chains: Dict[str, List[Element]] = {}
        self._chain_member: Dict[str, str] = {}
        # built in start(), after transform fusion removed elements
        self._stats: Dict[str, ElementStats] = {}
        self._queues: Dict[str, Channel] = {}
        self._threads: List[threading.Thread] = []
        self._stop_evt = threading.Event()
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._started = False
        self._route: Dict[Tuple[str, int], Link] = {}
        # -- fault tolerance -----------------------------------------------
        if max_consecutive_errors is None:
            max_consecutive_errors = cfg.get_int(
                "runtime", "max_consecutive_errors", 100)
        self._max_consec = max(0, max_consecutive_errors)
        # run-level counter, reset by ANY successful process(); plain
        # int ops under the GIL (a lost race costs one count)
        self._consec_errors = 0
        if watchdog is None:
            watchdog = cfg.get_bool("runtime", "watchdog", True)
        self._watchdog_enabled = bool(watchdog)
        if stall_budget_s is None:
            stall_budget_s = cfg.get_float("runtime", "stall_budget_s", 30.0)
        self._stall_budget_s = max(0.01, stall_budget_s)
        if queue_stall_budget_s is None:
            queue_stall_budget_s = cfg.get_float(
                "runtime", "queue_stall_budget_s", self._stall_budget_s)
        self._queue_stall_budget_s = max(0.01, queue_stall_budget_s)
        action = watchdog_action or cfg.get(
            "runtime", "watchdog_action", "warn") or "warn"
        if action not in ("warn", "fail"):
            raise PipelineError(
                f"watchdog_action must be 'warn' or 'fail', got {action!r}")
        self._watchdog_action = action
        self._watchdog_thread: Optional[threading.Thread] = None
        # element name -> monotonic instant its worker entered process()
        # (or flush()); written by the worker, read by the watchdog
        self._inflight: Dict[str, float] = {}
        # watchdog incident bookkeeping, pruned the moment an element
        # or queue recovers
        self._wd_warned_proc: Dict[str, float] = {}
        self._wd_q_full_since: Dict[str, float] = {}
        self._wd_warned_q: Dict[str, float] = {}
        # wedged admission: element name -> (monotonic instant its
        # admission queue was found pinned, its replied count then), and
        # the incident already warned
        self._wd_adm_since: Dict[str, Tuple[float, int]] = {}
        self._wd_warned_adm: Dict[str, float] = {}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "PipelineRunner":
        if self._started:
            raise PipelineError("runner already started")
        pipe = self.pipeline
        if not pipe._negotiated:
            if self._optimize:
                from nnstreamer_tpu_torch.graph.optimize import fuse_transforms

                fuse_transforms(pipe)
            pipe.negotiate()
        for name in pipe.elements:
            self._stats.setdefault(name, ElementStats())
        for e in pipe.elements.values():
            e._event_router = self._route_upstream
            # before start(), so elements can hand it on (tensor_filter →
            # its backend's invoke spans, tensor_llm → its engine)
            e._tracer = self.tracer
            e._stop_evt = self._stop_evt
            e.start()
        for l in pipe.links:
            self._route[(l.src.name, l.src_pad)] = l
        self._build_chains()
        # mid-chain members are fed by direct call-through: no channel
        for e in pipe.elements.values():
            if not isinstance(e, SourceElement) \
                    and e.name not in self._chain_member:
                self._queues[e.name] = Channel(self._cap)
        for e in pipe.elements.values():
            if isinstance(e, SourceElement):
                t = threading.Thread(target=self._pump, args=(e,),
                                     name=f"src:{e.name}", daemon=True)
            elif e.name in self._chains:
                t = threading.Thread(target=self._chain_work,
                                     args=(self._chains[e.name],),
                                     name=f"chain:{e.name}", daemon=True)
            elif e.name in self._chain_member:
                continue
            else:
                t = threading.Thread(target=self._work, args=(e,),
                                     name=f"elem:{e.name}", daemon=True)
            self._threads.append(t)
        self._started = True
        for t in self._threads:
            t.start()
        if self._watchdog_enabled:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop,
                name=f"watchdog:{pipe.name}", daemon=True)
            self._watchdog_thread.start()
        return self

    #: how long wait() gives remaining workers to drain once a worker
    #: error is recorded and no caller deadline bounds the join
    _error_drain_grace_s = 5.0

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every element finished (EOS fully propagated)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._threads:
            while t.is_alive():
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self.stop()
                        if self._error is not None:
                            # the hang is a symptom: surface the root
                            # cause, not a bare timeout
                            raise StreamError(
                                f"pipeline {self.pipeline.name!r} failed: "
                                f"{self._error} (thread {t.name} then did "
                                f"not finish within {timeout}s)"
                            ) from self._error
                        raise StreamError(
                            f"pipeline {self.pipeline.name!r} did not "
                            f"finish within {timeout}s (thread {t.name} "
                            f"still running)")
                    t.join(min(0.2, remaining))
                elif self._error is not None:
                    # the pipeline already failed: give the stragglers a
                    # bounded grace, then leak them (daemons) rather
                    # than hang the caller behind a stuck process()
                    self.stop()
                    t.join(self._error_drain_grace_s)
                    if t.is_alive():
                        log.warning(
                            "pipeline %r: thread %s still running %.0fs "
                            "after pipeline failure — leaking it (daemon "
                            "thread; likely stuck in process())",
                            self.pipeline.name, t.name,
                            self._error_drain_grace_s)
                    break
                else:
                    t.join(0.2)
        if self._error is not None:
            raise StreamError(
                f"pipeline {self.pipeline.name!r} failed: {self._error}"
            ) from self._error

    def stop(self) -> None:
        """Request teardown; safe to call multiple times."""
        self._stop_evt.set()
        for e in self.pipeline.elements.values():
            if isinstance(e, SourceElement):
                try:
                    e.interrupt()
                except Exception:
                    log.exception("error interrupting %s", e.name)
        for ch in self._queues.values():
            ch.close()
        for e in self.pipeline.elements.values():
            try:
                e.stop()
            except Exception:  # teardown must not mask the first error
                log.exception("error stopping %s", e.name)
        wt = self._watchdog_thread
        if wt is not None and wt is not threading.current_thread():
            wt.join(2.0)  # exits on its next poll tick (stop_evt set)
            if wt.is_alive():
                log.warning("watchdog thread %s did not stop within 2s; "
                            "leaking it (daemon thread)", wt.name)

    def run(self, timeout: Optional[float] = None) -> None:
        self.start()
        try:
            self.wait(timeout)
        finally:
            self.stop()

    # -- read-out ----------------------------------------------------------
    def stats(self) -> Dict[str, dict]:
        """Per-element proctime/buffer/robustness counters, merged with
        each element's `extra_stats()` (tensor_filter's backend and
        breaker counters, tensor_fault's injections, ...)."""
        out = {}
        for name, s in self._stats.items():
            d = s.as_dict()
            e = self.pipeline.elements.get(name)
            if hasattr(e, "latency_us"):
                # tensor_filter's own props, the reference's two counters
                d["invoke_latency_us"] = e.latency_us
                d["invoke_throughput"] = e.throughput
            extra = getattr(e, "extra_stats", None)
            if extra is not None:
                d.update(extra())
            ls = self._loop_stats.get(name)
            if ls is not None:
                # loop_entries / compiled_steps / loop_bails{cause}
                d.update(ls.snapshot())
            out[name] = d
        return out

    def report(self) -> str:
        """Human-readable observability report: per-element proctime
        table (heaviest first), fused chains, per-link queue high-water
        marks, micro-batching, compiled windows, robustness counters and — when tracing is on —
        interlatency per element (sinks marked: the sink rows are the
        end-to-end latency), forced syncs and in-flight window peaks,
        then backend counters and model swaps."""
        st = self.stats()
        lines = [f"pipeline {self.pipeline.name!r} — element report",
                 "",
                 f"{'element':<22} {'buffers':>8} {'total ms':>9} "
                 f"{'avg µs':>9} {'max µs':>9} {'wait µs':>9} "
                 f"{'q.peak':>6} {'drop':>5} {'timer':>6}"]
        for name, d in sorted(st.items(),
                              key=lambda kv: -kv[1]["proctime_total_s"]):
            lines.append(
                f"{name:<22} {d['buffers']:>8} "
                f"{d['proctime_total_s'] * 1e3:>9.2f} "
                f"{d['proctime_avg_us']:>9.1f} {d['proctime_max_us']:>9.1f} "
                f"{d['queue_wait_avg_us']:>9.1f} {d['queue_peak']:>6} "
                f"{d['dropped']:>5} {d['timer_fires']:>6}")
        if self._chains:
            lines.append("")
            lines.append("fused chains (one worker thread, direct "
                         "call-through):")
            for chain in self._chains.values():
                lines.append("  " + " → ".join(m.name for m in chain))
        lines.append("")
        lines.append(f"queue high-water (capacity {self._cap}):")
        for l in self.pipeline.links:
            d = st.get(l.dst.name)
            if d is None or l.dst.name in self._chain_member:
                continue     # mid-chain links have no queue at all
            lines.append(f"  {l.src.name} → {l.dst.name}: "
                         f"peak {d['queue_peak']}/{self._cap}")
        batchers = [(name, d) for name, d in sorted(st.items())
                    if "occupancy_hist" in d]
        if batchers:
            lines.append("")
            lines.append("micro-batching (occupancy {frames: batches}, "
                         "flush reasons):")
            for name, d in batchers:
                lines.append(
                    f"  {name}: {d['frames_in']} frames in "
                    f"{d['batches_out']} batches, occupancy "
                    f"{d['occupancy_hist']} avg {d['occupancy_avg']:.2f}; "
                    f"flushes full={d['flush_full']} "
                    f"deadline={d['flush_deadline']} eos={d['flush_eos']}")
        loops = [(name, ls) for name, ls in sorted(self._loop_stats.items())
                 if ls.entries or ls.steps or ls.bails]
        if loops:
            lines.append("")
            lines.append("compiled steady-state windows (scheduler "
                         "bypass, [runtime] compiled_loop):")
            for name, ls in loops:
                total = st.get(name, {}).get("buffers", 0)
                share = 100.0 * ls.steps / total if total else 0.0
                bails = " ".join(f"{c}={ls.bails[c]}"
                                 for c in sorted(ls.bails)) or "none"
                lines.append(
                    f"  {name}: windows={ls.entries} "
                    f"compiled_frames={ls.steps} ({share:.0f}% of "
                    f"{total}) bails: {bails}")
        rob = [(name, d) for name, d in sorted(st.items())
               if any(d.get(k) for k in
                      ("errors", "retries", "skipped", "degraded",
                       "watchdog_warnings", "event_errors"))]
        if rob:
            lines.append("")
            lines.append("robustness (error-policy / watchdog counters):")
            for name, d in rob:
                lines.append(
                    f"  {name}: errors={d['errors']} "
                    f"retries={d['retries']} skipped={d['skipped']} "
                    f"degraded={d['degraded']} "
                    f"watchdog={d['watchdog_warnings']} "
                    f"event_errors={d['event_errors']}")
        tr = self.tracer
        if tr.active:
            inter = tr.interlatency()
            if inter:
                sinks = {e.name for e in self.pipeline.elements.values()
                         if not self.pipeline.links_from(e)}
                lines.append("")
                lines.append("interlatency source → element (ms):")
                lines.append(f"  {'element':<22} {'n':>6} {'p50':>8} "
                             f"{'p95':>8} {'p99':>8} {'max':>8}")
                for name, r in sorted(inter.items(),
                                      key=lambda kv: kv[1]["p50_ms"]):
                    mark = " (sink)" if name in sinks else ""
                    lines.append(
                        f"  {name + mark:<22} {r['n']:>6} "
                        f"{r['p50_ms']:>8.3f} {r['p95_ms']:>8.3f} "
                        f"{r['p99_ms']:>8.3f} {r['max_ms']:>8.3f}")
            forced = tr.forced_syncs()
            gauges = tr.inflight_gauges()
            if forced or gauges:
                lines.append("")
                lines.append("async dispatch (forced syncs / in-flight "
                             "window peaks):")
                for name, n in sorted(forced.items()):
                    lines.append(f"  {name}: forced_syncs={n}")
                for name, g in sorted(gauges.items()):
                    lines.append(f"  {name}: inflight_peak={g['peak']} "
                                 f"(window {self._max_inflight})")
            if tr.events_dropped:
                lines.append("")
                lines.append(f"note: event ring wrapped, "
                             f"{tr.events_dropped} oldest events dropped")
        backend_rows = [
            (name, {k: v for k, v in d.items() if k.startswith("backend_")})
            for name, d in st.items()]
        backend_rows = [(n, b) for n, b in backend_rows if b]
        if backend_rows:
            lines.append("")
            lines.append("backend counters:")
            for name, b in backend_rows:
                kv = " ".join(f"{k[len('backend_'):]}={v}"
                              for k, v in sorted(b.items()))
                lines.append(f"  {name}: {kv}")
        swaps = tr.swap_events() if tr.active else []
        if swaps:
            lines.append("")
            lines.append("model swaps (store:// epoch adoptions):")
            for name, _, args in swaps:
                lines.append(
                    f"  {name}: {args.get('model', '?')} "
                    f"v{args.get('from_version', '?')} → "
                    f"v{args.get('to_version', '?')} "
                    f"epoch={args.get('epoch', '?')} "
                    f"prewarmed={args.get('prewarmed', 0)}")
        return "\n".join(lines)

    # -- upstream events ---------------------------------------------------
    def _route_upstream(self, origin: Element, event: dict) -> None:
        """Walk the link graph upstream from `origin`, offering `event`
        to each element until consumed (upstream QoS event path). Every
        in-link is followed, so the walk crosses tensor_mux (several
        in-links) and tensor_demux (several out-links, one of them
        ours) alike; each element is offered the event once."""
        seen = {origin.name}
        frontier = [origin]
        while frontier:
            e = frontier.pop()
            for l in self.pipeline.links_to(e):
                u = l.src
                if u.name in seen:
                    continue
                seen.add(u.name)
                try:
                    consumed = u.handle_upstream_event(event)
                except Exception:
                    # a broken handler must not end the walk: treat the
                    # event as NOT consumed so it keeps propagating, and
                    # count the failure where it happened
                    log.exception("upstream event failed at %s", u.name)
                    stats = self._stats.get(u.name)
                    if stats is not None:
                        stats.event_errors += 1
                    consumed = False
                if not consumed:
                    frontier.append(u)

    # -- chain fusion ------------------------------------------------------
    def _chain_eligible(self, e: Element) -> bool:
        """Can `e` run as a member of a fused chain? Exactly one in-link
        and one out-link (no fan-in/fan-out, which excludes sources and
        sinks), fail-fast error policy (the other policies need the
        per-element worker's policy loop), no timer deadlines (a member
        cannot be woken apart from its chain), and not opted out via
        CHAIN_FUSABLE (tensor_filter)."""
        if isinstance(e, SourceElement) or not e.CHAIN_FUSABLE:
            return False
        if e.error_policy.kind != "fail":
            return False
        if len(self.pipeline.links_to(e)) != 1 \
                or len(self.pipeline.links_from(e)) != 1:
            return False
        cls = type(e)
        if cls.next_deadline is not Element.next_deadline \
                or cls.on_timer is not Element.on_timer:
            return False
        return True

    def _build_chains(self) -> None:
        """Group maximal linear runs of eligible elements into fused
        chains. Runs in start() after transform fusion, so fused-away
        transforms never appear as chain members."""
        if not self._chain_fusion:
            return
        pipe = self.pipeline
        elig = {e.name for e in pipe.elements.values()
                if self._chain_eligible(e)}
        for e in pipe.elements.values():
            if e.name not in elig:
                continue
            # heads are eligible elements whose single upstream is not
            # eligible (an eligible upstream extends the same chain)
            if pipe.links_to(e)[0].src.name in elig:
                continue
            chain = [e]
            cur = e
            while True:
                nxt = pipe.links_from(cur)[0].dst
                if nxt.name not in elig:
                    break
                chain.append(nxt)
                cur = nxt
            if len(chain) < 2:
                continue          # nothing to fuse with
            self._chains[e.name] = chain
            for m in chain[1:]:
                self._chain_member[m.name] = e.name
            log.debug("pipeline %r: chain-fused %s (one worker thread)",
                      pipe.name, " → ".join(m.name for m in chain))

    def fused_chains(self) -> List[List[str]]:
        """Element-name chains the scheduler fused (after start())."""
        return [[m.name for m in chain]
                for chain in self._chains.values()]

    def _chain_work(self, chain: List[Element]) -> None:
        """Worker loop for a fused chain: one channel read at the head,
        then direct call-through over every member."""
        head, tail = chain[0], chain[-1]
        ch = self._queues[head.name]
        head_stats = self._stats[head.name]
        tr = self.tracer
        try:
            while not self._stop_evt.is_set():
                msg, depth = ch.get()
                if msg is CLOSED:     # teardown wakeup
                    return
                pad, item, t_enq = msg
                if tr.active:
                    tr.dequeue(head.name, depth, time.perf_counter())
                if item is EOS:
                    # heads have exactly one in-link, so the first EOS
                    # completes the chain: flush members in order
                    self._chain_flush(chain)
                    self._broadcast_eos(tail)
                    return
                head_stats.record_wait(time.perf_counter() - t_enq)
                self._chain_deliver(chain, 0, pad, item)
        except _ChainFailure as cf:
            self._fail(cf.elem, cf.exc)
            self._try_eos(tail)
        except Exception as e:
            self._fail(head, e)
            self._try_eos(tail)

    def _chain_deliver(self, chain: List[Element], start_idx: int,
                       pad: int, item) -> None:
        """Push one buffer through chain[start_idx:] by direct calls.
        Depth-first over emissions so buffer order at the tail matches
        the unfused schedule. Stats, watchdog stamps and trace spans stay
        attributed to the member that did the work."""
        tr = self.tracer
        last = len(chain) - 1
        stack = [(start_idx, pad, item)]
        while stack:
            i, pad, buf = stack.pop()
            elem = chain[i]
            t0 = time.perf_counter()
            self._inflight[elem.name] = time.monotonic()
            try:
                emissions = elem.process(pad, buf)
            except Exception as exc:
                raise _ChainFailure(elem, exc) from exc
            finally:
                self._inflight.pop(elem.name, None)
            t1 = time.perf_counter()
            self._stats[elem.name].record(t1 - t0)
            self._consec_errors = 0
            if tr.active:
                tr.record_process(elem.name, buf, t0, t1)
            if i == last:
                for sp, b in emissions:
                    self._emit(elem, sp, b)
                continue
            nxt = chain[i + 1].name
            pending = []
            for sp, b in emissions:
                link = self._route[(elem.name, sp)]
                if link.dst.name == nxt:
                    pending.append((i + 1, link.dst_pad, b))
                else:          # defensive: members have one out-link
                    self._emit(elem, sp, b)
            stack.extend(reversed(pending))

    def _chain_flush(self, chain: List[Element]) -> None:
        """EOS drain for a fused chain: flush members head→tail, each
        member's flush emissions flowing through the remaining members
        before those flush — the order the unfused cascade produces."""
        tr = self.tracer
        last = len(chain) - 1
        for i, elem in enumerate(chain):
            t0 = time.perf_counter()
            self._inflight[elem.name] = time.monotonic()
            try:
                emissions = elem.flush()
            except Exception as exc:
                raise _ChainFailure(elem, exc) from exc
            finally:
                self._inflight.pop(elem.name, None)
            if tr.active:
                t1 = time.perf_counter()
                tr.record_flush(elem.name, t0, t1)
                tr.record_eos(elem.name, t1)
            if i == last:
                for sp, b in emissions:
                    self._emit(elem, sp, b)
                continue
            nxt = chain[i + 1].name
            for sp, b in emissions:
                link = self._route[(elem.name, sp)]
                if link.dst.name == nxt:
                    self._chain_deliver(chain, i + 1, link.dst_pad, b)
                else:
                    self._emit(elem, sp, b)

    # -- error policies ----------------------------------------------------
    def _process_with_policy(self, elem: Element, stats: ElementStats,
                             policy, pad: int, item, tr):
        """Run elem.process under a non-fail error policy.

        Returns the emissions list, or None when the buffer was consumed
        by the policy (skipped, degraded, or lost to teardown). Raises
        only for escalation (max_consecutive_errors), which the worker
        loop's outer handler turns into pipeline failure."""
        attempts = 0
        while True:
            self._inflight[elem.name] = time.monotonic()
            try:
                return elem.process(pad, item)
            except Exception as e:
                stats.errors += 1
                if tr.active:
                    tr.record_error(elem.name, type(e).__name__,
                                    time.perf_counter(),
                                    policy=policy.kind,
                                    pts=getattr(item, "pts", None))
                self._note_error(elem, e)   # may raise (escalation)
                # a breaker short-circuit is by definition not transient
                # — retrying it just burns the backoff budget
                retryable = (policy.kind == "retry"
                             and attempts < policy.retries
                             and not isinstance(e, CircuitOpenError))
                if retryable:
                    attempts += 1
                    stats.retries += 1
                    delay_s = policy.backoff_ms * (2 ** (attempts - 1)) / 1e3
                    log.debug(
                        "element %s: process failed (%s); retry %d/%d "
                        "in %.0fms", elem.name, e, attempts,
                        policy.retries, delay_s * 1e3)
                    if delay_s and self._stop_evt.wait(delay_s):
                        stats.dropped += 1    # teardown mid-backoff
                        return None
                    continue
                if policy.kind == "degrade":
                    fb = elem.fallback_src_pad
                    if fb is not None:
                        stats.degraded += 1
                        log.warning(
                            "element %s: process failed on buffer pts=%s "
                            "(%s); degrading — routing input to fallback "
                            "pad %d", elem.name,
                            getattr(item, "pts", None), e, fb)
                        self._emit(elem, fb, item)
                        return None
                stats.skipped += 1
                log.warning(
                    "element %s: process failed on buffer pts=%s (%s); "
                    "%s — buffer dropped", elem.name,
                    getattr(item, "pts", None), e,
                    "retry budget exhausted" if policy.kind == "retry"
                    else f"error-policy={policy.kind}")
                return None
            finally:
                self._inflight.pop(elem.name, None)

    def _note_error(self, elem: Element, exc: BaseException) -> None:
        """Track run-level consecutive errors; escalate to failure when
        the pipeline makes no progress between errors (poison stream)."""
        self._consec_errors += 1
        if self._max_consec and self._consec_errors >= self._max_consec:
            raise StreamError(
                f"element {elem.name}: {self._consec_errors} consecutive "
                f"errors with no successful buffer anywhere in the "
                f"pipeline (max_consecutive_errors={self._max_consec}) — "
                f"escalating to failure; last error: {exc}") from exc

    # -- watchdog ----------------------------------------------------------
    def _watchdog_loop(self) -> None:
        """Flags elements stuck in process() beyond the stall budget and
        input queues pinned at capacity beyond theirs, one warning per
        incident, counted in the element's stats and traced."""
        poll = max(0.02, min(1.0, min(self._stall_budget_s,
                                      self._queue_stall_budget_s) / 4.0))
        while not self._stop_evt.wait(poll):
            if self._watchdog_scan(time.monotonic()):
                return

    def _flag(self, name: str, kind: str, msg: str, err: str,
              **args) -> bool:
        """One watchdog incident: count it, log it, trace it; under
        watchdog_action=fail tear the pipeline down (→ True)."""
        stats = self._stats.get(name)
        if stats is not None:
            stats.watchdog_warnings += 1
        log.warning("watchdog: %s", msg)
        if self.tracer.active:
            self.tracer.record_watchdog(name, kind, time.perf_counter(),
                                        **args)
        if self._watchdog_action == "fail":
            self._fail(self.pipeline.elements.get(name), WatchdogStall(err))
            return True
        return False

    def _watchdog_scan(self, now: float) -> bool:
        """One watchdog pass at monotonic instant `now`; True when a
        watchdog_action='fail' teardown fired (the loop must exit).
        Separate from the loop so tests can drive it with synthetic
        clocks; the `_wd_*` bookkeeping is pruned the moment an
        element or queue recovers."""
        budget = self._stall_budget_s
        q_budget = self._queue_stall_budget_s
        warned_proc = self._wd_warned_proc
        q_full_since = self._wd_q_full_since
        warned_q = self._wd_warned_q
        inflight = dict(self._inflight)
        for name in list(warned_proc):
            if inflight.get(name) != warned_proc[name]:
                del warned_proc[name]
        for name, t0 in inflight.items():
            stalled = now - t0
            if stalled <= budget or warned_proc.get(name) == t0:
                continue
            warned_proc[name] = t0
            if self._flag(
                    name, "stall",
                    f"element {name} has been inside process()/flush() "
                    f"for {stalled:.2f}s (stall budget {budget:.2f}s)",
                    f"element {name} exceeded its stall budget: process() "
                    f"has not returned for {stalled:.2f}s (budget "
                    f"{budget:.2f}s)",
                    stalled_s=round(stalled, 3), budget_s=budget):
                return True
        for name, ch in self._queues.items():
            if not ch.full():
                q_full_since.pop(name, None)
                warned_q.pop(name, None)
                continue
            since = q_full_since.setdefault(name, now)
            full_for = now - since
            if full_for <= q_budget or warned_q.get(name) == since:
                continue
            warned_q[name] = since
            if self._flag(
                    name, "queue",
                    f"input queue of {name} has been at capacity "
                    f"({self._cap}) for {full_for:.2f}s (budget "
                    f"{q_budget:.2f}s) — the element is not draining; "
                    f"upstream is blocked",
                    f"input queue of element {name} stayed at capacity "
                    f"({self._cap}) for {full_for:.2f}s (budget "
                    f"{q_budget:.2f}s)",
                    full_for_s=round(full_for, 3), budget_s=q_budget,
                    capacity=self._cap):
                return True
        return self._scan_admission(now, q_budget)

    def _scan_admission(self, now: float, q_budget: float) -> bool:
        """Wedged admission: an element exposing `admission_counters()`
        (tensor_query_serversrc) whose admission queue sits pinned at
        max_pending with ZERO replies for the queue stall budget. Depth
        alone is healthy under overload (BUSY at the door is the design);
        depth pinned AND no reply progress means the service behind the
        queue is gone while clients burn their timeouts. Reply progress
        re-arms the incident; depth recovery prunes it."""
        adm_since = self._wd_adm_since
        warned_adm = self._wd_warned_adm
        for name, elem in list(self.pipeline.elements.items()):
            probe = getattr(elem, "admission_counters", None)
            if probe is None:
                continue
            try:
                c = probe()
            except Exception:
                continue
            if c["depth"] < c["max_pending"]:
                adm_since.pop(name, None)
                warned_adm.pop(name, None)
                continue
            since, replied0 = adm_since.setdefault(
                name, (now, c["replied"]))
            if c["replied"] != replied0:
                # progress: re-arm the incident at the new reply count
                adm_since[name] = (now, c["replied"])
                warned_adm.pop(name, None)
                continue
            wedged_for = now - since
            if wedged_for <= q_budget or warned_adm.get(name) == since:
                continue
            warned_adm[name] = since
            if self._flag(
                    name, "wedged-admission",
                    f"admission queue of {name} wedged — depth pinned at "
                    f"max_pending ({c['max_pending']}) with zero replies "
                    f"for {wedged_for:.2f}s (budget {q_budget:.2f}s); the "
                    f"service behind it is not draining",
                    f"wedged-admission: admission queue of {name} stayed "
                    f"pinned at max_pending ({c['max_pending']}) with zero "
                    f"replies for {wedged_for:.2f}s (budget "
                    f"{q_budget:.2f}s)",
                    wedged_for_s=round(wedged_for, 3), budget_s=q_budget,
                    max_pending=c["max_pending"], replied=c["replied"]):
                return True
        return False

    # -- dataflow ----------------------------------------------------------
    def _fail(self, elem, exc: BaseException) -> None:
        with self._error_lock:
            if self._error is None:
                self._error = exc
        log.error("element %s failed: %s", getattr(elem, "name", "?"), exc)
        self._stop_evt.set()
        for ch in self._queues.values():
            ch.close()

    def _emit(self, elem: Element, src_pad: int, item) -> None:
        link = self._route.get((elem.name, src_pad))
        if link is None:
            raise PipelineError(
                f"element {elem.name} emitted on unlinked src pad {src_pad}")
        tr = self.tracer
        # blocking put; returns the post-append depth measured under the
        # channel's own lock, so the always-on high-water mark costs no
        # extra lock
        depth = self._queues[link.dst.name].put(
            (link.dst_pad, item, time.perf_counter()))
        if depth is not None:
            dst_stats = self._stats.get(link.dst.name)
            if dst_stats is not None and depth > dst_stats.queue_peak:
                dst_stats.queue_peak = depth
            if tr.active:
                tr.enqueue(link.dst.name, depth, time.perf_counter())
            return
        # the channel closed (teardown/failure) before the put landed:
        # the buffer is lost; count it on the producer (EOS is not a
        # payload — no loss to count)
        if item is not EOS:
            stats = self._stats.get(elem.name)
            if stats is not None:
                stats.dropped += 1
            log.debug("teardown dropped a buffer from %s -> %s (pts=%s)",
                      elem.name, link.dst.name, getattr(item, "pts", None))
            if tr.active:
                tr.record_drop(elem.name, time.perf_counter())

    def _broadcast_eos(self, elem: Element) -> None:
        for l in self.pipeline.links_from(elem):
            self._emit(elem, l.src_pad, EOS)

    def _try_eos(self, elem: Element) -> None:
        """EOS after a failure, best effort (channels may be closed)."""
        try:
            self._broadcast_eos(elem)
        except Exception:
            pass

    def _pump(self, src: SourceElement) -> None:
        tr = self.tracer
        try:
            for buf in src.generate():
                if self._stop_evt.is_set():
                    break
                if tr.active:
                    # interlatency origin: stamp the pipeline-entry time
                    tr.source_emit(src.name, buf, time.perf_counter())
                self._emit(src, 0, buf)
            self._broadcast_eos(src)
        except Exception as e:
            self._fail(src, e)
            self._try_eos(src)

    def _run_compiled_window(self, elem, ch: Channel, stats: ElementStats,
                             lstats: LoopStats,
                             detector: SteadyStateDetector,
                             pending: deque, window, tr, pad: int, item,
                             t_enq: float, sig) -> bool:
        """One compiled steady-state window attempt, starting at `item`
        (detector already armed). True when the frame was consumed here —
        a window ran, or its frames went back through `pending` for the
        per-frame path; False when the caller must process `item` per
        frame (entry bail, or fewer than two matching frames queued).

        Stats reconcile exactly on every path: a K-frame window records
        K buffers of dt/K each (and per-frame queue waits and tracer
        process spans); an errored window re-runs its frames per frame
        so the error policy lands on the precise frame that faulted."""
        now = time.perf_counter()
        # entry bails: state a window must not bake in. Both are
        # transient — the detector stays armed and the next frame retries
        # (swap adoption and timer fires happen per frame)
        if elem.swap_pending():
            lstats.bail("swap")
            if tr.active:
                tr.record_loop_bail(elem.name, "swap", now)
            return False
        if elem.next_deadline() is not None:
            lstats.bail("timer")
            if tr.active:
                tr.record_loop_bail(elem.name, "timer", now)
            return False
        batch = [(pad, item, t_enq)]
        eos_msg = None
        parked = None
        while len(batch) < self._loop_window:
            m, d = ch.get_nowait()
            if m is TIMED_OUT or m is CLOSED:
                break      # channel empty or closed: run what we have
            if tr.active:
                tr.dequeue(elem.name, d, time.perf_counter())
            p2, it2, _ = m
            if it2 is EOS:
                # the partial window runs first, then the EOS cascades
                # through the ordinary path (flush + in-flight drain)
                eos_msg = m
                lstats.bail("eos")
                if tr.active:
                    tr.record_loop_bail(elem.name, "eos",
                                        time.perf_counter())
                detector.reset()
                break
            if p2 != pad or frame_signature(it2) != sig:
                # divergent frame: parked for the per-frame path after
                # this window; the streak restarts behind it
                parked = m
                lstats.bail("shape")
                if tr.active:
                    tr.record_loop_bail(elem.name, "shape",
                                        time.perf_counter())
                detector.reset()
                break
            batch.append(m)
        if len(batch) < 2:
            # a window of one is the per-frame path with extra steps
            if parked is not None:
                pending.append(parked)
            if eos_msg is not None:
                pending.append(eos_msg)
            return False
        # power-of-two round-down: each K is its own captured graph, so
        # {2, 4, 8} bounds a signature's graphs to log2(window); the
        # remainder runs per frame through `pending`
        k = 1 << (len(batch).bit_length() - 1)
        leftover = batch[k:]
        batch = batch[:k]
        t0 = time.perf_counter()
        for _, _, te in batch:
            if te:
                stats.record_wait(t0 - te)
        self._inflight[elem.name] = time.monotonic()
        try:
            emissions = elem.process_window(pad, [m[1] for m in batch])
        except Exception as e:
            # re-run every frame per frame so the error (and the
            # fail-fast policy) lands on the precise frame that faulted —
            # frames before it still emit. t_enq zeroed: the queue wait
            # is already counted. The element's first failed window is
            # a warning; later ones (a capture that keeps failing) show
            # in the error bails and at debug level
            lstats.bail("error")
            say = log.warning if lstats.bails["error"] == 1 else log.debug
            say("element %s: a window of %d frames failed (%s); they re-run "
                "per frame", elem.name, k, e)
            if tr.active:
                tr.record_loop_bail(elem.name, "error", time.perf_counter())
            detector.reset()
            rerun = [(p, it, 0.0) for p, it, _ in batch]
            rerun.extend(leftover)
            if parked is not None:
                rerun.append(parked)
            if eos_msg is not None:
                rerun.append(eos_msg)
            pending.extendleft(reversed(rerun))
            return True
        finally:
            self._inflight.pop(elem.name, None)
        t1 = time.perf_counter()
        lstats.entries += 1
        lstats.steps += k
        per = (t1 - t0) / k
        for i, m in enumerate(batch):
            stats.record(per)
            if tr.active:
                tr.record_process(elem.name, m[1], t0 + i * per,
                                  t0 + (i + 1) * per)
        if tr.active:
            tr.record_compiled_window(elem.name, k, t0, t1)
        self._consec_errors = 0
        for sp, b in emissions:
            self._emit(elem, sp, b)
            if window is not None and isinstance(b, TensorBuffer) \
                    and b.on_device:
                window.append(b.tensors)
        if window:
            while len(window) > self._max_inflight:
                device_sync(window.popleft(), forced=False)
            if tr.active:
                tr.record_inflight(elem.name, len(window),
                                   time.perf_counter())
        pending.extend(leftover)
        if parked is not None:
            pending.append(parked)
        if eos_msg is not None:
            pending.append(eos_msg)
        return True

    def _work(self, elem: Element) -> None:
        ch = self._queues[elem.name]
        n_pads = max(1, len(self.pipeline.links_to(elem)))
        eos_pads = set()
        stats = self._stats[elem.name]
        tr = self.tracer
        policy = elem.error_policy    # resolved once; immutable per run
        # async-dispatch window (DEVICE_RESIDENT elements): outputs go
        # downstream with their device work still queued; this worker
        # syncs the OLDEST once more than max_inflight are live
        window = deque() if elem.DEVICE_RESIDENT else None
        # compiled steady-state loop: only fail-fast elements whose
        # window_capable() holds (tensor_filter with a window-capable
        # backend); every other element pays one probe at thread start
        loop_on = (self._compiled_loop and policy.kind == "fail"
                   and getattr(elem, "window_capable", None) is not None
                   and elem.window_capable())
        detector = SteadyStateDetector(self._loop_arm) if loop_on else None
        lstats = None
        if loop_on:
            lstats = self._loop_stats[elem.name] = LoopStats()
        # frames taken off the channel but handed back by a window bail
        # (a divergent frame, an error re-run, a trailing EOS): consumed
        # in order before the channel is read again, and never re-enter
        # a window, so order is kept by construction
        pending: deque = deque()
        try:
            while not self._stop_evt.is_set():
                # deadline-aware wait: the channel wait ends at the
                # element's next deadline, so a timer element wakes up
                # without input; no deadline = a plain blocking get
                deadline = elem.next_deadline()
                if deadline is not None:
                    now = time.perf_counter()
                    if now >= deadline:
                        stats.timer_fires += 1
                        for sp, b in elem.on_timer():
                            self._emit(elem, sp, b)
                        if tr.active:
                            tr.record_timer(elem.name, now,
                                            time.perf_counter())
                        continue
                if pending:
                    # bailed-window frames: already dequeued and traced
                    msg = pending.popleft()
                    from_pending = True
                else:
                    msg, depth = ch.get(deadline)
                    if msg is CLOSED:  # teardown wakeup (stop()/_fail())
                        return
                    if msg is TIMED_OUT:  # deadline due: fire next turn
                        continue
                    if tr.active:
                        tr.dequeue(elem.name, depth, time.perf_counter())
                    from_pending = False
                pad, item, t_enq = msg
                if item is EOS:
                    eos_pads.add(pad)
                    if len(eos_pads) >= n_pads:
                        t0 = time.perf_counter()
                        self._inflight[elem.name] = time.monotonic()
                        try:
                            for sp, b in elem.flush():
                                self._emit(elem, sp, b)
                        finally:
                            self._inflight.pop(elem.name, None)
                        if window:
                            # nothing behind the EOS is still unresolved
                            while window:
                                device_sync(window.popleft(), forced=False)
                            if tr.active:
                                tr.record_inflight(
                                    elem.name, 0, time.perf_counter())
                        if tr.active:
                            tr.record_flush(elem.name, t0,
                                            time.perf_counter())
                            tr.record_eos(elem.name, time.perf_counter())
                        self._broadcast_eos(elem)
                        return
                    continue
                # bail-parked frames never re-enter a window (that would
                # reorder them past frames still in `pending`)
                if detector is not None and not from_pending:
                    sig = frame_signature(item)
                    if detector.observe(sig) and self._run_compiled_window(
                            elem, ch, stats, lstats, detector, pending,
                            window, tr, pad, item, t_enq, sig):
                        continue
                t0 = time.perf_counter()
                if t_enq:
                    stats.record_wait(t0 - t_enq)
                if policy.kind == "fail":
                    # hot path: one watchdog stamp on either side
                    self._inflight[elem.name] = time.monotonic()
                    try:
                        emissions = elem.process(pad, item)
                    finally:
                        self._inflight.pop(elem.name, None)
                else:
                    emissions = self._process_with_policy(
                        elem, stats, policy, pad, item, tr)
                    if emissions is None:
                        continue      # buffer skipped/degraded/dropped
                t1 = time.perf_counter()
                stats.record(t1 - t0)
                self._consec_errors = 0
                if tr.active:
                    tr.record_process(elem.name, item, t0, t1)
                for sp, b in emissions:
                    self._emit(elem, sp, b)
                    if window is not None and isinstance(b, TensorBuffer) \
                            and b.on_device:
                        window.append(b.tensors)
                if window:
                    while len(window) > self._max_inflight:
                        device_sync(window.popleft(), forced=False)
                    if tr.active:
                        tr.record_inflight(elem.name, len(window),
                                           time.perf_counter())
        except Exception as e:
            self._fail(elem, e)
            self._try_eos(elem)


def run_pipeline(pipeline: Pipeline, timeout: Optional[float] = None,
                 optimize: bool = True) -> None:
    """Negotiate (with transform fusion by default), run to EOS, tear
    down. The gst-launch behavior."""
    PipelineRunner(pipeline, optimize=optimize).run(timeout)

"""SLO-breach flight recorder: always-on forensic capture (the JAX
package's runtime/flightrec.py on the port).

An incident investigation needs the telemetry from *around* the
incident — and by the time a human is looking, the event ring has
wrapped and the bad minute is gone.  The flight recorder keeps a
bounded ring of periodic metric snapshots next to the tracer's own
(always-on, bounded) event ring, watches a small set of trigger
predicates, and on the first firing dumps an atomic bundle directory:
Chrome trace, Prometheus text, autotune audit ring, env snapshot,
snapshot ring, and the trigger cause. Adversarial drills read these
bundles instead of asking "can you reproduce it".

Trigger taxonomy (each independently rate-limited by a per-trigger
cooldown so a sustained breach produces one bundle per window, not a
disk flood):

- ``slo_breach``     — observed p99 above the SLOSpec budget (fed by
  serving/autotune's sensor, or directly via :meth:`note_slo_breach`)
- ``conservation``   — admission ledger mismatch (offered ≠ replied +
  rejected + shed + depth + inflight) on two *consecutive* scans; one
  scan's worth of slack absorbs the benign mid-flight read races the
  conservation tests allow
- ``worker_fence``   — a worker/host kill|fence lifecycle event
- ``kernel_fallback``— a requested kernel path served by the torch
  reference instead
- ``watchdog``       — a watchdog incident recorded by the tracer
- ``manual``         — operator-requested dump (CLI / tests)

Counter-derived triggers (fence, fallback, watchdog) are watermarked:
the first observation of a source only sets the baseline, so attaching
the recorder to a system with historical faults does not dump.

Atomicity: bundles are written to a dot-prefixed temp directory and
``os.rename``d into place — a reader listing the flight dir never sees
a partial bundle (``list_bundles`` additionally ignores dot-entries).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from nnstreamer_tpu_torch.core.log import get_logger

log = get_logger("runtime.flightrec")

#: the trigger kinds a recorder can fire (fixed taxonomy; cause.json
#: carries the evidence)
TRIGGERS = ("slo_breach", "conservation", "worker_fence",
            "kernel_fallback", "watchdog", "manual",
            "scenario_violation")

DEFAULT_COOLDOWN_S = 60.0


class FlightRecorder:
    """Bounded snapshot ring + trigger predicates + atomic bundle dump.

    ``clock`` is injectable (tests drive cooldown windows without
    sleeping).  All state is under one lock; predicates and dumps run
    on whatever thread polls (the serve loop's poller thread or a
    metrics scrape), never on the frame hot path.
    """

    def __init__(self, out_dir: str, *,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 snap_ring: int = 32,
                 clock: Callable[[], float] = time.monotonic):
        self.out_dir = str(out_dir)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._snaps: deque = deque(maxlen=max(1, int(snap_ring)))
        self._last_dump: Dict[str, float] = {}
        self._seq = 0
        self._counts: Dict[str, int] = {}        # fired, by kind
        self._suppressed: Dict[str, int] = {}    # cooldown-gated, by kind
        self._watermarks: Dict[str, float] = {}  # monotone-source baselines
        self._conservation_streak = 0
        # attached telemetry sources (all optional)
        self._tracer = None
        self._autotune = None
        self._prom: Optional[Callable[[], str]] = None
        self._env: Optional[Callable[[], dict]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        os.makedirs(self.out_dir, exist_ok=True)

    # -- wiring -------------------------------------------------------------
    def attach(self, *, tracer=None, autotune=None,
               prom: Optional[Callable[[], str]] = None,
               env: Optional[Callable[[], dict]] = None
               ) -> "FlightRecorder":
        """Attach telemetry sources consulted at dump time: the tracer
        (Chrome trace + worker/watchdog counters), the autotuner (audit
        ring + SLO), a ``prom()`` callable returning exposition text,
        and an ``env()`` callable returning a JSON-able snapshot."""
        if tracer is not None:
            self._tracer = tracer
        if autotune is not None:
            self._autotune = autotune
            setattr(autotune, "flight", self)
        if prom is not None:
            self._prom = prom
        if env is not None:
            self._env = env
        return self

    # -- periodic snapshot ring ----------------------------------------------
    def tick(self, snapshot: Optional[dict] = None) -> None:
        """Append one periodic metric snapshot to the ring (bounded —
        always-on costs a fixed amount of memory)."""
        with self._lock:
            self._snaps.append({"t": self._clock(),
                                "snapshot": snapshot or {}})

    # -- trigger feeds --------------------------------------------------------
    def note_slo_breach(self, p99_ms: float, budget_ms: float,
                        **ctx) -> Optional[str]:
        """Direct SLO-breach feed (serving/autotune's sensor calls this
        when the observed p99 exceeds the budget)."""
        return self.trigger("slo_breach", dict(
            ctx, p99_ms=round(float(p99_ms), 3),
            p99_budget_ms=float(budget_ms)))

    def scan(self, *, p99_ms: Optional[float] = None,
             p99_budget_ms: Optional[float] = None,
             admission: Optional[dict] = None,
             worker_counts: Optional[dict] = None,
             watchdog_counts: Optional[dict] = None,
             kernel_fallbacks: Optional[float] = None) -> List[str]:
        """Evaluate every predicate against one round of signals and
        dump for each that fires; returns the kinds that dumped."""
        fired: List[str] = []

        def hit(kind: str, cause: dict) -> None:
            if self.trigger(kind, cause) is not None:
                fired.append(kind)

        if p99_ms is not None and p99_budget_ms and p99_ms > p99_budget_ms:
            hit("slo_breach", {"p99_ms": round(p99_ms, 3),
                               "p99_budget_ms": p99_budget_ms})
        if admission is not None:
            accounted = (
                float(admission.get("replied", 0))
                + sum(admission.get("rejected", {}).values())
                + sum(admission.get("shed", {}).values())
                + float(admission.get("depth", 0))
                + float(admission.get("inflight", 0)))
            offered = float(admission.get("offered", 0))
            if offered != accounted:
                with self._lock:
                    self._conservation_streak += 1
                    streak = self._conservation_streak
                if streak >= 2:
                    hit("conservation", {
                        "offered": offered, "accounted": accounted,
                        "delta": offered - accounted,
                        "consecutive_scans": streak})
            else:
                with self._lock:
                    self._conservation_streak = 0
        for kind, counts in (("worker_fence", worker_counts),
                             ("watchdog", watchdog_counts)):
            if counts:
                total = sum(float(v) for sub in counts.values()
                            for v in (sub.values()
                                      if isinstance(sub, dict) else [sub]))
                if self._rose(kind, total):
                    hit(kind, {"count": total, "events": {
                        k: (dict(v) if isinstance(v, dict) else v)
                        for k, v in counts.items()}})
        if kernel_fallbacks is not None \
                and self._rose("kernel_fallback", float(kernel_fallbacks)):
            hit("kernel_fallback", {"count": float(kernel_fallbacks)})
        return fired

    def poll(self, *, admission: Optional[dict] = None,
             llm: Optional[Dict[str, dict]] = None) -> List[str]:
        """One recorder pass over attached + passed sources: snapshot
        tick, then scan.  The serve loop's poller calls this."""
        self.tick()
        kw: Dict[str, Any] = {"admission": admission}
        tr = self._tracer
        if tr is not None and getattr(tr, "active", False):
            kw["worker_counts"] = {
                n: {k: v for k, v in kinds.items()
                    if k in ("kill", "fence", "fenced", "killed")}
                for n, kinds in tr.worker_counts().items()}
            kw["watchdog_counts"] = tr.watchdog_counts()
        if llm:
            kw["kernel_fallbacks"] = sum(
                float(st.get("executor", st).get("kernel_fallback", 0))
                for st in llm.values())
        return self.scan(**kw)

    def _rose(self, key: str, total: float) -> bool:
        """Watermark test: True when a monotone source increased past
        its last-seen value; the first observation only baselines."""
        with self._lock:
            prev = self._watermarks.get(key)
            self._watermarks[key] = total
        return prev is not None and total > prev

    # -- dumping --------------------------------------------------------------
    def trigger(self, kind: str, cause: Optional[dict] = None
                ) -> Optional[str]:
        """Fire one trigger: within the kind's cooldown window this is
        counted and suppressed; otherwise a complete bundle directory
        is atomically published and its path returned."""
        kind = str(kind)
        now = self._clock()
        with self._lock:
            last = self._last_dump.get(kind)
            if last is not None and now - last < self.cooldown_s:
                self._suppressed[kind] = self._suppressed.get(kind, 0) + 1
                return None
            self._last_dump[kind] = now
            self._seq += 1
            seq = self._seq
            self._counts[kind] = self._counts.get(kind, 0) + 1
        try:
            path = self._dump(kind, seq, dict(cause or {}), now)
        except Exception as e:
            log.exception("flight dump for %s failed", kind)
            with self._lock:   # a failed dump must not eat the window
                if self._last_dump.get(kind) == now:
                    del self._last_dump[kind]
            raise RuntimeError(f"flight dump failed: {e}") from e
        tr = self._tracer
        if tr is not None and getattr(tr, "active", False):
            tr.record_flight(kind, time.perf_counter(), path=path)
        log.warning("flight recorder fired: %s -> %s", kind, path)
        return path

    def _dump(self, kind: str, seq: int, cause: dict, now: float) -> str:
        """Assemble the bundle in a dot-prefixed temp dir, then publish
        with one ``os.rename`` — partial bundles are never visible."""
        name = f"flight-{seq:04d}-{kind}"
        tmp = os.path.join(self.out_dir, f".tmp-{name}-{os.getpid()}")
        final = os.path.join(self.out_dir, name)
        os.makedirs(tmp, exist_ok=True)

        def put(fname: str, payload: Any, raw: bool = False) -> None:
            with open(os.path.join(tmp, fname), "w") as f:
                if raw:
                    f.write(payload)
                else:
                    json.dump(payload, f, indent=2, default=str)
                    f.write("\n")

        put("cause.json", {
            "kind": kind, "seq": seq, "cause": cause,
            "monotonic": now, "wall_time": time.time(),
            "cooldown_s": self.cooldown_s})
        with self._lock:
            snaps = list(self._snaps)
        put("snapshots.json", snaps)
        tr = self._tracer
        if tr is not None and getattr(tr, "active", False):
            try:
                put("trace.json", tr.to_chrome_trace("flight"))
            except Exception as e:
                put("trace.error", f"{type(e).__name__}: {e}\n", raw=True)
        if self._prom is not None:
            try:
                put("metrics.prom", self._prom(), raw=True)
            except Exception as e:
                put("metrics.error", f"{type(e).__name__}: {e}\n",
                    raw=True)
        at = self._autotune
        if at is not None:
            try:
                put("autotune.json", {"audit": at.audit(),
                                      "stats": at.stats()})
            except Exception as e:
                put("autotune.error", f"{type(e).__name__}: {e}\n",
                    raw=True)
        if self._env is not None:
            try:
                put("env.json", self._env())
            except Exception as e:
                put("env.error", f"{type(e).__name__}: {e}\n", raw=True)
        os.rename(tmp, final)
        return final

    # -- background poller ----------------------------------------------------
    def run_background(self, signal_fn: Optional[Callable[[], dict]] = None,
                       interval_s: float = 2.0) -> "FlightRecorder":
        """Start the poller thread: every ``interval_s`` it calls
        ``poll(**signal_fn())`` (``signal_fn`` returns the poll kwargs —
        fresh admission counters, llm stats — or {})."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.poll(**(signal_fn() if signal_fn else {}))
                except Exception:
                    log.exception("flight poll failed")

        self._thread = threading.Thread(
            target=run, name="flight-recorder", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    # -- read-out -------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "out_dir": self.out_dir,
                "cooldown_s": self.cooldown_s,
                "snapshots": len(self._snaps),
                "dumps": dict(self._counts),
                "suppressed": dict(self._suppressed),
                "dumps_total": sum(self._counts.values()),
                "suppressed_total": sum(self._suppressed.values()),
            }


# -- bundle inspection (CLI + tests) ------------------------------------------

def list_bundles(out_dir: str) -> List[Dict[str, Any]]:
    """Complete bundles under ``out_dir``, oldest first.  Dot-entries
    (in-progress temp dirs) are invisible by construction."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(out_dir))
    except OSError:
        return out
    for name in names:
        if name.startswith(".") or not name.startswith("flight-"):
            continue
        path = os.path.join(out_dir, name)
        if not os.path.isdir(path):
            continue
        info: Dict[str, Any] = {"name": name, "path": path,
                                "files": sorted(os.listdir(path))}
        try:
            with open(os.path.join(path, "cause.json")) as f:
                c = json.load(f)
            info.update({"kind": c.get("kind"), "seq": c.get("seq"),
                         "wall_time": c.get("wall_time"),
                         "cause": c.get("cause")})
        except Exception:
            info["kind"] = "?"
        out.append(info)
    return out


def load_bundle(path: str) -> Dict[str, Any]:
    """Parse every bundle artifact into one dict (JSON files parsed,
    .prom/.error text inlined)."""
    out: Dict[str, Any] = {"path": path}
    for name in sorted(os.listdir(path)):
        p = os.path.join(path, name)
        if not os.path.isfile(p):
            continue
        key = name.rsplit(".", 1)[0]
        try:
            if name.endswith(".json"):
                with open(p) as f:
                    out[key] = json.load(f)
            else:
                with open(p) as f:
                    out[name] = f.read()
        except Exception as e:
            out[name] = f"<unreadable: {e}>"
    return out

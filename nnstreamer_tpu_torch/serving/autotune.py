"""Online SLO autotuner — closed-loop control of the serving knobs (the
JAX package's serving/autotune.py on the port: under the same clock and
sensors it takes the same decisions, in the same audit order).

Every load-sensitive knob the runtime has grown (admission
``max_pending``, the ``tensor_batch`` deadline, the compile-bucket set,
shed policy, pool sizing) is set by hand, while the tracer already
measures exactly what a controller needs. This module closes the loop:

- **SLOSpec** — the declared contract: a p99 latency budget, an
  optional goodput floor, optional per-tenant budget overrides, and
  declared min/max ranges per knob. JSON-loadable like the tenant
  table (``serve --slo FILE``), eagerly validated with typed errors.

- **AutoTuner** — a controller thread (same lifecycle shape as the
  tenancy ``ScalingController``: ``start()``/``stop()``/``tick()``,
  injectable clock) closing sensor→decision→actuation:

  * sensors read only existing surfaces — ``AdmissionQueue.counters()``
    (depth, per-cause sheds, the EWMA reply interval), the tracer's
    interlatency percentiles and ``tenant_summary()``, the batch
    element's occupancy stats, and the torch backend's observed
    batch-size histogram;
  * actuators are existing live-reconfiguration paths —
    ``AdmissionQueue.configure()`` with a ``max_pending`` derived from
    the *measured* service rate (Little's law: the depth the p99
    budget can absorb at the observed per-reply interval), the batch
    deadline via ``tensor_batch``'s live-read props, and bucket-set
    refinement staged through the backend's pre-warm path
    (``stage_bucket``) so a bucket change never recompiles in-band;
  * shed-policy and pool-scaling decisions are **hints only**
    (outcome ``proposed``): the tenancy ScalingController stays the
    single binding owner — the autotuner proposes, the scaler binds.

Every decision passes one guardrail ladder (`_drive`): clamp to the
declared knob range, a hysteresis band (small deviations are held, so
flapping sensors cannot oscillate the knob), a per-knob cooldown, and
a bounded step toward the target. Each decision lands in a bounded
audit ring (knob, old, new, sensor evidence, outcome) with exact
accounting across ring wrap, is recorded on the tracer
(``record_autotune``), and is exported as ``nns_autotune_*`` series
(serving/metrics.py). ``dry_run=True`` evaluates and records every
decision without applying anything.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.serving.tenancy import validate_tenant_name

log = logging.getLogger("nnstreamer_tpu_torch.autotune")

#: decision outcomes (audit ring / metrics label values)
OUTCOMES = ("applied", "dry_run", "proposed", "hysteresis", "cooldown",
            "error")

#: headroom factor on the Little's-law admission target: a queue sized
#: to exactly budget/ewma puts the last admitted request AT the budget,
#: and the wait the bound predicts is a floor — the in-service request,
#: host scheduling jitter, and reply overhead all add on top (the ramp
#: drill measures the tail ~1.3x over (depth+1)*ewma on a loaded CPU
#: host). Aim the settled wait at mid-budget so the observed p99 lands
#: under the budget, not on it.
LITTLE_MARGIN = 0.5


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


@dataclass(frozen=True)
class KnobRange:
    """Declared [lo, hi] clamp for one knob (both inclusive)."""

    knob: str
    lo: float
    hi: float

    def __post_init__(self):
        for side, v in (("min", self.lo), ("max", self.hi)):
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                raise ValueError(
                    f"knob {self.knob!r}: {side} must be a finite "
                    f"number, got {v!r}")
        if self.lo > self.hi:
            raise ValueError(
                f"knob {self.knob!r}: min {self.lo} > max {self.hi}")

    def clamp(self, v: float) -> float:
        return min(max(v, self.lo), self.hi)


#: knobs the controller understands, with conservative default ranges
#: (an SLO file narrows them; it cannot invent new knob names)
DEFAULT_KNOB_RANGES: Dict[str, KnobRange] = {
    "max_pending": KnobRange("max_pending", 2, 4096),
    "batch_deadline_ms": KnobRange("batch_deadline_ms", 0.25, 200.0),
    "max_batch": KnobRange("max_batch", 1, 1024),
}


@dataclass(frozen=True)
class SLOSpec:
    """The declared serving contract the controller defends.

    JSON shape (``serve --slo FILE``, mirroring the tenant table)::

        {"p99_budget_ms": 90,
         "goodput_floor_rps": 50,
         "tenants": {"acme": {"p99_budget_ms": 50}},
         "knobs": {"max_pending": {"min": 4, "max": 256},
                   "batch_deadline_ms": {"min": 1, "max": 20}}}
    """

    p99_budget_ms: float
    goodput_floor_rps: float = 0.0
    tenants: Dict[str, float] = field(default_factory=dict)
    knobs: Dict[str, KnobRange] = field(default_factory=dict)

    def __post_init__(self):
        b = self.p99_budget_ms
        if not isinstance(b, (int, float)) or not math.isfinite(b) \
                or b <= 0:
            raise ValueError(
                f"p99_budget_ms must be a finite number > 0, got {b!r}")
        g = self.goodput_floor_rps
        if not isinstance(g, (int, float)) or not math.isfinite(g) \
                or g < 0:
            raise ValueError(
                f"goodput_floor_rps must be a finite number >= 0, "
                f"got {g!r}")
        for name, budget in self.tenants.items():
            if not validate_tenant_name(name):
                raise ValueError(
                    f"tenant override {name!r} is invalid: must match "
                    f"[a-zA-Z0-9_-]{{1,64}}")
            if not isinstance(budget, (int, float)) \
                    or not math.isfinite(budget) or budget <= 0:
                raise ValueError(
                    f"tenant {name!r}: p99_budget_ms must be a finite "
                    f"number > 0, got {budget!r}")
        for knob in self.knobs:
            if knob not in DEFAULT_KNOB_RANGES:
                raise ValueError(
                    f"unknown knob {knob!r}: declared knobs are "
                    f"{' | '.join(sorted(DEFAULT_KNOB_RANGES))}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SLOSpec":
        """Parse + validate eagerly — a malformed SLO file fails at
        load time with a typed error, never mid-control-loop."""
        if not isinstance(d, dict):
            raise ValueError(
                f"SLO spec must be a JSON object, got {type(d).__name__}")
        if "p99_budget_ms" not in d:
            raise ValueError("SLO spec needs p99_budget_ms")
        tenants: Dict[str, float] = {}
        raw_t = d.get("tenants", {})
        if not isinstance(raw_t, dict):
            raise ValueError(
                f"tenants must be a name -> override mapping, "
                f"got {type(raw_t).__name__}")
        for name, spec in raw_t.items():
            if isinstance(spec, dict):
                if "p99_budget_ms" not in spec:
                    raise ValueError(
                        f"tenant {name!r}: override needs p99_budget_ms")
                tenants[name] = _num(spec["p99_budget_ms"],
                                     f"tenant {name!r} p99_budget_ms")
            else:
                tenants[name] = _num(spec,
                                     f"tenant {name!r} p99_budget_ms")
        knobs: Dict[str, KnobRange] = {}
        raw_k = d.get("knobs", {})
        if not isinstance(raw_k, dict):
            raise ValueError(
                f"knobs must be a name -> {{min, max}} mapping, "
                f"got {type(raw_k).__name__}")
        for knob, rng in raw_k.items():
            if not isinstance(rng, dict) or "min" not in rng \
                    or "max" not in rng:
                raise ValueError(
                    f"knob {knob!r}: range must be an object with "
                    f"min and max, got {rng!r}")
            knobs[knob] = KnobRange(
                knob, _num(rng["min"], f"knob {knob!r} min"),
                _num(rng["max"], f"knob {knob!r} max"))
        return cls(
            p99_budget_ms=_num(d["p99_budget_ms"], "p99_budget_ms"),
            goodput_floor_rps=_num(d.get("goodput_floor_rps", 0.0),
                                   "goodput_floor_rps"),
            tenants=tenants, knobs=knobs)

    @classmethod
    def from_json(cls, path: str) -> "SLOSpec":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def knob_range(self, knob: str) -> KnobRange:
        return self.knobs.get(knob) or DEFAULT_KNOB_RANGES[knob]

    def tenant_budget_ms(self, tenant: str) -> float:
        return self.tenants.get(tenant, self.p99_budget_ms)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "p99_budget_ms": self.p99_budget_ms,
            "goodput_floor_rps": self.goodput_floor_rps,
            "tenants": dict(self.tenants),
            "knobs": {k: {"min": r.lo, "max": r.hi}
                      for k, r in self.knobs.items()},
        }


def _num(v: Any, what: str) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)) \
            or not math.isfinite(v):
        raise ValueError(f"{what} must be a finite number, got {v!r}")
    return float(v)


class AutoTuner:
    """The controller thread (module docstring).

    Bindings are all optional — the controller only drives the knobs
    it was given targets for, so tests can bind a single fake:

    admission       — an AdmissionQueue (configure()/counters())
    batch_elements  — tensor_batch elements (live ``props`` actuation)
    filters         — tensor_filter elements whose backend exposes the
                      observed ``batch_size_hist`` (bucket refinement)
    scaler          — tenancy ScalingController (hints only; it binds)
    tracer          — decisions recorded via ``record_autotune``
    on_apply        — callback(record) after each applied decision
                      (the bench drill checks conservation here)
    on_victims      — callback(list) for entries a configure() shrink
                      shed (each is owed a BUSY reply by the caller)
    """

    def __init__(self, slo: SLOSpec, admission: Any = None,
                 batch_elements: Tuple[Any, ...] = (),
                 filters: Tuple[Any, ...] = (),
                 scaler: Any = None, tracer: Any = None,
                 interval_s: float = 1.0, dry_run: bool = False,
                 step_frac: float = 0.5, hysteresis_frac: float = 0.15,
                 cooldown_s: float = 5.0, audit_size: int = 256,
                 on_apply: Optional[Callable[[dict], None]] = None,
                 on_victims: Optional[Callable[[List[Any]], None]] = None,
                 now: Callable[[], float] = time.monotonic,
                 name: str = "autotune"):
        self.slo = slo
        self.admission = admission
        self.batch_elements = tuple(batch_elements)
        self.filters = tuple(filters)
        self.scaler = scaler
        self.tracer = tracer
        self.interval_s = float(interval_s)
        self.dry_run = bool(dry_run)
        self.step_frac = float(step_frac)
        self.hysteresis_frac = float(hysteresis_frac)
        self.cooldown_s = float(cooldown_s)
        self.name = name
        # flight recorder (the JAX package's runtime/flightrec.py, not
        # ported yet: Queue 1 item 4f): when set, tick() feeds it
        # observed-p99-over-budget breaches
        self.flight: Any = None
        self._on_apply = on_apply
        self._on_victims = on_victims
        self._now = now
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # accounting (under _lock): the audit ring holds the last
        # `audit_size` decisions; the per-knob/outcome counters keep
        # the exact totals across ring wrap
        self._audit: deque = deque(maxlen=max(1, int(audit_size)))
        self._audit_total = 0
        self._decisions: Dict[str, Dict[str, int]] = {}
        self.ticks = 0
        self._last_apply: Dict[str, float] = {}
        self._last_hint: Dict[str, Any] = {}
        # bucket refinement never raises max_batch past what the batch
        # element negotiated downstream — record the ceiling at bind
        self._batch_ceilings = {
            id(el): int(el.props["max_batch"])
            for el in self.batch_elements}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "AutoTuner":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="slo-autotuner", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                log.exception("autotune tick failed")

    # -- one control-loop pass ---------------------------------------------
    def tick(self) -> List[dict]:
        """One sensor→decision→actuation pass; returns the decision
        records produced (possibly empty). Callable from tests with an
        injected clock."""
        now = self._now()
        with self._lock:
            self.ticks += 1
        out: List[dict] = []
        for fn in (self._tick_admission, self._tick_batch_deadline,
                   self._tick_buckets, self._tick_hints):
            try:
                out.extend(fn(now))
            except Exception:
                log.exception("autotune stage %s failed", fn.__name__)
        if self.flight is not None:
            try:
                p99 = self._observed_p99_ms()
                if p99 is not None and p99 > self.slo.p99_budget_ms:
                    self.flight.note_slo_breach(
                        p99, self.slo.p99_budget_ms, source=self.name)
            except Exception:
                log.exception("flight-recorder SLO feed failed")
        return out

    # -- stages ------------------------------------------------------------
    def _tick_admission(self, now: float) -> List[dict]:
        """Little's-law admission bound: the p99 budget divided by the
        measured per-reply interval is the deepest queue whose wait
        still fits the budget — that is what max_pending should be,
        not a guess."""
        if self.admission is None:
            return []
        c = self.admission.counters()
        ewma = c.get("ewma_reply_s")
        if not ewma or not math.isfinite(ewma) or ewma <= 0:
            return []                   # no service-rate signal yet
        target = LITTLE_MARGIN * (self.slo.p99_budget_ms / 1e3) / ewma
        evidence = {"ewma_reply_s": round(ewma, 6),
                    "p99_budget_ms": self.slo.p99_budget_ms,
                    "depth": c["depth"], "depth_peak": c["depth_peak"]}

        def apply(v: float) -> None:
            victims = self.admission.configure(max_pending=int(round(v)))
            if victims and self._on_victims is not None:
                self._on_victims(victims)

        rec = self._drive("max_pending", float(c["max_pending"]), target,
                          evidence, apply, now, integer=True)
        return [rec] if rec else []

    def _tick_batch_deadline(self, now: float) -> List[dict]:
        """Adaptive batch deadline: grow it while the observed p99 has
        headroom and batches flush half-empty (occupancy is where
        throughput comes from); shrink it the moment the p99 budget is
        threatened — latency wins over occupancy."""
        if not self.batch_elements:
            return []
        p99 = self._observed_p99_ms()
        if p99 is None:
            return []
        budget = self.slo.p99_budget_ms
        out = []
        for el in self.batch_elements:
            cur = float(el.props["max_latency_ms"])
            st = el.extra_stats()
            occ = float(st.get("occupancy_avg", 0.0))
            max_batch = int(el.props["max_batch"])
            if p99 > 0.8 * budget:
                target = cur * 0.5
            elif p99 < 0.4 * budget and st.get("batches_out", 0) \
                    and occ < 0.5 * max_batch:
                target = cur * 2.0
            else:
                continue
            evidence = {"p99_ms": round(p99, 3), "p99_budget_ms": budget,
                        "occupancy_avg": round(occ, 2),
                        "max_batch": max_batch}
            rec = self._drive(
                "batch_deadline_ms", cur, target, evidence,
                lambda v, el=el: el.props.__setitem__(
                    "max_latency_ms", float(v)),
                now, label=el.name)
            if rec:
                out.append(rec)
        return out

    def _tick_buckets(self, now: float) -> List[dict]:
        """Bucket-set refinement from the observed batch-size
        histogram: when the p95 observed occupancy fits a smaller pow2
        bucket than max_batch advertises, shrink max_batch to that
        bucket — batches then fill their compile bucket exactly
        instead of padding. The smaller bucket is staged through the
        backend's pre-warm path first, so the flip never recompiles
        in-band. Shrink-only: the negotiated ceiling is never raised."""
        if not self.batch_elements or not self.filters:
            return []
        hist: Dict[int, int] = {}
        backends = []
        for f in self.filters:
            h = getattr(getattr(f, "backend", None),
                        "batch_size_hist", None)
            if h:
                backends.append(f.backend)
                for n, cnt in dict(h).items():
                    hist[int(n)] = hist.get(int(n), 0) + int(cnt)
        total = sum(hist.values())
        if total < 8:
            return []                  # not enough signal to refine on
        p95 = _hist_percentile(hist, 95.0)
        target_bucket = _next_pow2(p95)
        out = []
        for el in self.batch_elements:
            cur = float(el.props["max_batch"])
            ceiling = self._batch_ceilings.get(id(el), int(cur))
            target = float(min(target_bucket, ceiling))
            if target >= cur:
                continue               # refinement only ever shrinks
            evidence = {"occupancy_p95": p95,
                        "target_bucket": target_bucket,
                        "invokes": total}

            def apply(v: float, el=el, backends=tuple(backends)) -> None:
                nb = int(round(v))
                for be in backends:
                    stage = getattr(be, "stage_bucket", None)
                    if stage is not None:
                        stage(nb)      # off-band compile, never in-band
                el.props["max_batch"] = nb

            rec = self._drive("max_batch", cur, target, evidence,
                              apply, now, integer=True, label=el.name)
            if rec:
                out.append(rec)
        return out

    def _tick_hints(self, now: float) -> List[dict]:
        """Advisory decisions (outcome ``proposed``; never actuated):
        pool scaling when the measured reply rate sits under the
        declared goodput floor at a saturated queue, and a shed-policy
        suggestion when a saturated reject-newest queue is serving
        requests that then miss the budget anyway. The tenancy scaler
        stays the binding owner for both."""
        if self.admission is None:
            return []
        c = self.admission.counters()
        ewma = c.get("ewma_reply_s")
        out = []
        if self.slo.goodput_floor_rps > 0 and ewma and ewma > 0:
            rate = 1.0 / ewma
            saturated = c["depth"] >= max(1, c["max_pending"] // 2)
            if rate < self.slo.goodput_floor_rps and saturated:
                rec = self._propose(
                    "pool_slots", "current", "scale_up",
                    {"reply_rate_rps": round(rate, 2),
                     "goodput_floor_rps": self.slo.goodput_floor_rps,
                     "depth": c["depth"]}, now)
                if rec:
                    out.append(rec)
        p99 = self._observed_p99_ms()
        if p99 is not None and p99 > self.slo.p99_budget_ms \
                and c["shed_policy"] == "reject-newest" \
                and c["depth_peak"] >= c["max_pending"]:
            rec = self._propose(
                "shed_policy", "reject-newest", "reject-oldest",
                {"p99_ms": round(p99, 3),
                 "p99_budget_ms": self.slo.p99_budget_ms,
                 "depth_peak": c["depth_peak"]}, now)
            if rec:
                out.append(rec)
        return out

    # -- sensors -----------------------------------------------------------
    def _observed_p99_ms(self) -> Optional[float]:
        """Worst observed p99 across the tracer's surfaces: tenant
        request latency when tenancy records it, else the widest
        per-element interlatency."""
        tr = self.tracer
        if tr is None or not getattr(tr, "active", False):
            return None
        vals: List[float] = []
        try:
            for row in tr.tenant_summary().values():
                vals.append(float(row.get("p99_ms", 0.0)))
        except Exception:
            pass
        if not vals:
            try:
                for row in tr.interlatency().values():
                    vals.append(float(row.get("p99_ms", 0.0)))
            except Exception:
                pass
        return max(vals) if vals else None

    # -- the guardrail ladder ----------------------------------------------
    def _drive(self, knob: str, current: float, target: float,
               evidence: Dict[str, Any], apply: Callable[[float], Any],
               now: float, integer: bool = False,
               label: Optional[str] = None) -> Optional[dict]:
        """Clamp → hysteresis → cooldown → bounded step → actuate.
        Returns the audit record for a decision that moved (applied /
        dry_run / error); holds count in the outcome counters only, so
        a flapping sensor cannot flood the ring."""
        rng = self.slo.knob_range(knob)
        clamped = rng.clamp(target)
        if abs(clamped - current) <= \
                self.hysteresis_frac * max(abs(current), 1e-9):
            self._count(knob, "hysteresis")
            return None
        last = self._last_apply.get(knob)
        if last is not None and now - last < self.cooldown_s:
            self._count(knob, "cooldown")
            return None
        step = abs(current) * self.step_frac
        if integer:
            step = max(step, 1.0)
        new = rng.clamp(current + min(max(clamped - current, -step), step))
        if integer:
            new = float(int(round(new)))
        if new == current:
            self._count(knob, "hysteresis")
            return None
        outcome = "dry_run" if self.dry_run else "applied"
        if not self.dry_run:
            try:
                apply(new)
            except Exception:
                log.exception("actuating %s=%s failed", knob, new)
                outcome = "error"
        # dry_run honors the cooldown too: the decision stream must
        # look exactly like the live one, just without actuation
        self._last_apply[knob] = now
        return self._record(knob, current, new, evidence, outcome, now,
                            label=label)

    def _propose(self, knob: str, old: Any, new: Any,
                 evidence: Dict[str, Any], now: float) -> Optional[dict]:
        """Hint path: cooldown + dedup (the same proposal is not
        re-recorded every tick), never actuates."""
        last = self._last_apply.get(knob)
        if last is not None and now - last < self.cooldown_s:
            self._count(knob, "cooldown")
            return None
        if self._last_hint.get(knob) == new:
            self._count(knob, "hysteresis")
            return None
        self._last_hint[knob] = new
        self._last_apply[knob] = now
        return self._record(knob, old, new, evidence, "proposed", now)

    def _count(self, knob: str, outcome: str) -> None:
        with self._lock:
            d = self._decisions.setdefault(knob, {})
            d[outcome] = d.get(outcome, 0) + 1

    def _record(self, knob: str, old: Any, new: Any,
                evidence: Dict[str, Any], outcome: str, now: float,
                label: Optional[str] = None) -> dict:
        rec = {"t": now, "knob": knob, "old": old, "new": new,
               "evidence": dict(evidence), "outcome": outcome}
        if label:
            rec["target"] = label
        with self._lock:
            self._audit.append(rec)
            self._audit_total += 1
            d = self._decisions.setdefault(knob, {})
            d[outcome] = d.get(outcome, 0) + 1
        # side effects outside the lock (tracer/callback take their own)
        tr = self.tracer
        if tr is not None:
            try:
                tr.record_autotune(
                    self.name, knob, time.perf_counter(), old=old,
                    new=new, outcome=outcome, **evidence)
            except Exception:
                pass
        if outcome == "applied" and self._on_apply is not None:
            try:
                self._on_apply(rec)
            except Exception:
                log.exception("on_apply callback failed")
        return rec

    # -- introspection -----------------------------------------------------
    def audit(self) -> List[dict]:
        """The bounded audit ring, oldest first (the exact totals
        across wrap are in stats()["decisions"])."""
        with self._lock:
            return [dict(r) for r in self._audit]

    def knob_values(self) -> Dict[str, float]:
        """Current knob readings from the bound targets (gauges for
        the metrics plane)."""
        out: Dict[str, float] = {}
        if self.admission is not None:
            try:
                c = self.admission.counters()
                out["max_pending"] = float(c["max_pending"])
            except Exception:
                pass
        for i, el in enumerate(self.batch_elements):
            sfx = "" if len(self.batch_elements) == 1 else f"_{i}"
            try:
                out[f"batch_deadline_ms{sfx}"] = \
                    float(el.props["max_latency_ms"])
                out[f"max_batch{sfx}"] = float(el.props["max_batch"])
            except Exception:
                pass
        return out

    def stats(self) -> Dict[str, Any]:
        knobs = self.knob_values()       # targets' locks, not ours
        with self._lock:
            decisions = {k: dict(v) for k, v in self._decisions.items()}
            applied = sum(v.get("applied", 0)
                          for v in decisions.values())
            proposed = sum(v.get("proposed", 0)
                           for v in decisions.values())
            dry = sum(v.get("dry_run", 0) for v in decisions.values())
            return {
                "name": self.name,
                "dry_run": self.dry_run,
                "interval_s": self.interval_s,
                "ticks": self.ticks,
                "decisions": decisions,
                "applied_total": applied,
                "proposed_total": proposed,
                "dry_run_total": dry,
                "audit": [dict(r) for r in list(self._audit)[-32:]],
                "audit_len": len(self._audit),
                "audit_total": self._audit_total,
                "audit_dropped": self._audit_total - len(self._audit),
                "knobs": knobs,
                "hints": dict(self._last_hint),
                "slo": self.slo.to_dict(),
            }


def _hist_percentile(hist: Dict[int, int], p: float) -> int:
    """Nearest-rank percentile over a {value: count} histogram."""
    total = sum(hist.values())
    if total == 0:
        return 1
    rank = max(1, math.ceil(total * p / 100.0))
    seen = 0
    for v in sorted(hist):
        seen += hist[v]
        if seen >= rank:
            return int(v)
    return int(max(hist))

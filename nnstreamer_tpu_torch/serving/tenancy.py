"""Multi-tenant serving: tenant classes, model residency, replica scaling
(the JAX package's serving/tenancy.py; the port keeps its own copy).

One pool, M models, N tenants. Three cooperating pieces turn the
single-tenant serving stack into a shared one:

- **TenantTable** — the declarative config: each tenant class has a
  name, a WFQ weight, an optional ``store://`` model binding, and an
  optional per-class latency budget (``deadline_ms``) and queue bound
  (``max_pending``). `AdmissionQueue.set_tenants` consumes it to grow a
  weighted-fair front (traffic/admission.py); the pool consumes it to
  route frames tenant→model.

- **ModelResidency** — the worker-side pressure valve. A multiplex
  worker keeps several store models resident, each with its own
  bucketed-jit cache; under a configurable bound (max resident models
  with live compiles, or max resident bytes) the *least-recently-used*
  cold model's compiled buckets are released. Eviction is a counted
  event, never an error: the next invoke for that model recompiles.

- **ScalingController** — traffic-driven replica scaling. A daemon
  thread samples per-tenant arrival rates from the tracer, converts
  them to per-model demand, and re-binds pool slots to models through
  `WorkerPool.rebind` — which reuses the swap broadcast's two-phase
  prepare/commit, so a rebind is epoch-atomic: every slot flips in the
  same pool epoch or none does.

Tenant names double as Prometheus label values, so they are validated
at the edge: ``[a-zA-Z0-9_-]{1,64}`` (`validate_tenant_name`). Requests
with a malformed ``meta["tenant"]`` are refused with cause
``bad_tenant`` and attributed to the pseudo-class `INVALID_CLASS`
(spelled with a ``!``, outside the tenant charset, so it can never
collide with a real tenant) — per-class counters still sum exactly to
the global conservation invariants.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger("nnstreamer_tpu_torch.tenancy")

#: TensorBuffer.meta key clients set to claim a tenant class
TENANT_META = "tenant"

#: TensorBuffer.meta key the admission queue stamps with the *resolved*
#: class name (after default-class fallback), so downstream accounting
#: (pool dispatch, query-server reply) attributes completions to the
#: same class the offer was counted under even if the table changes.
CLASS_META = "_tenant_class"

#: pseudo-class charging refusals of malformed tenant names; '!' is
#: outside the tenant charset so no real tenant can collide with it
INVALID_CLASS = "!invalid"

#: the class requests without a tenant claim fall into
DEFAULT_CLASS = "default"

_NAME_RE = re.compile(r"\A[a-zA-Z0-9_-]{1,64}\Z")


def validate_tenant_name(name: Any) -> bool:
    """True iff `name` is a str matching ``[a-zA-Z0-9_-]{1,64}``.

    This bounds Prometheus label cardinality (the charset excludes
    every character `serving/metrics.py` escapes) and keeps hostile
    input out of the label path entirely."""
    return isinstance(name, str) and _NAME_RE.match(name) is not None


@dataclass(frozen=True)
class TenantClass:
    """One tenant's contract: scheduling weight, model binding, SLO."""

    name: str
    weight: float = 1.0
    model: Optional[str] = None        # store:// model name, or None
    deadline_ms: Optional[float] = None
    max_pending: Optional[int] = None  # per-class queue bound override

    def __post_init__(self):
        if not validate_tenant_name(self.name):
            raise ValueError(
                f"tenant name {self.name!r} is invalid: must match "
                f"[a-zA-Z0-9_-]{{1,64}}")
        if not (self.weight > 0 and self.weight == self.weight):
            raise ValueError(
                f"tenant {self.name!r}: weight must be finite and > 0, "
                f"got {self.weight}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"tenant {self.name!r}: deadline_ms must be > 0, "
                f"got {self.deadline_ms}")
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError(
                f"tenant {self.name!r}: max_pending must be >= 1, "
                f"got {self.max_pending}")


class TenantTable:
    """Immutable name→TenantClass mapping with a default class.

    Requests that carry no ``meta["tenant"]`` resolve to the default
    class (created implicitly with weight 1.0 if the table doesn't
    declare one). Unknown-but-valid tenant names also fall back to the
    default class — a tenant the operator never declared gets best-
    effort service, not an error."""

    def __init__(self, classes: List[TenantClass],
                 default: str = DEFAULT_CLASS):
        if not classes:
            raise ValueError("TenantTable needs at least one class")
        self._classes: Dict[str, TenantClass] = {}
        for c in classes:
            if c.name in self._classes:
                raise ValueError(f"duplicate tenant class {c.name!r}")
            self._classes[c.name] = c
        if default not in self._classes:
            self._classes[default] = TenantClass(name=default)
        self.default = default

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TenantTable":
        """Parse the ``--tenants FILE`` JSON shape::

            {"default": "free",
             "tenants": [{"name": "acme", "weight": 3.0,
                          "model": "mobilenet_v2", "deadline_ms": 50,
                          "max_pending": 32}, ...]}

        ``tenants`` may also be a name→spec mapping."""
        raw = d.get("tenants", d)
        if isinstance(raw, dict):
            entries = [dict(spec, name=name) for name, spec in raw.items()]
        else:
            entries = [dict(e) for e in raw]
        classes = []
        for e in entries:
            classes.append(TenantClass(
                name=e["name"],
                weight=float(e.get("weight", 1.0)),
                model=e.get("model"),
                deadline_ms=(float(e["deadline_ms"])
                             if e.get("deadline_ms") is not None else None),
                max_pending=(int(e["max_pending"])
                             if e.get("max_pending") is not None else None),
            ))
        return cls(classes, default=d.get("default", DEFAULT_CLASS)
                   if isinstance(d.get("tenants"), (list, dict))
                   else DEFAULT_CLASS)

    @classmethod
    def from_json(cls, path: str) -> "TenantTable":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def class_of(self, tenant: Optional[str]) -> TenantClass:
        """Resolve a (validated) tenant name to its class; None or an
        undeclared name falls back to the default class."""
        if tenant is not None and tenant in self._classes:
            return self._classes[tenant]
        return self._classes[self.default]

    def model_of(self, tenant: Optional[str]) -> Optional[str]:
        return self.class_of(tenant).model

    def names(self) -> List[str]:
        return list(self._classes)

    def classes(self) -> List[TenantClass]:
        return list(self._classes.values())

    def models(self) -> List[str]:
        """Distinct bound model names, declaration order."""
        seen: Dict[str, None] = {}
        for c in self._classes.values():
            if c.model is not None:
                seen.setdefault(c.model, None)
        return list(seen)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "default": self.default,
            "tenants": [
                {"name": c.name, "weight": c.weight, "model": c.model,
                 "deadline_ms": c.deadline_ms, "max_pending": c.max_pending}
                for c in self._classes.values()
            ],
        }


class ModelResidency:
    """LRU pressure bound over resident models' compiled state.

    Tracks which models have live bucketed-jit compiles and how much
    device memory their params hold. When the bound is exceeded
    (``max_models`` with compiles, or ``max_bytes`` of resident params),
    the least-recently-*invoked* model beyond the bound has its
    compiled buckets released via ``backend.release_compiled()``.

    Eviction is bookkeeping, not failure: the evicted model stays
    registered and its next invoke rebuilds what it needs (a graph
    captured again, a verdict taken again). The
    ``jit_evictions`` counter is the only externally visible effect —
    results are bitwise unchanged.
    """

    def __init__(self, max_models: int = 0, max_bytes: int = 0):
        # 0 = unbounded (that axis imposes no pressure)
        self.max_models = int(max_models)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._lru: "OrderedDict[str, Any]" = OrderedDict()  # name → backend
        self.jit_evictions = 0          # models whose compiles were dropped
        self.entries_evicted = 0        # individual jit entries dropped

    def register(self, name: str, backend: Any) -> None:
        with self._lock:
            self._lru[name] = backend
            self._lru.move_to_end(name)

    def touch(self, name: str) -> List[str]:
        """Mark `name` most-recently-used, then enforce the bound.
        Returns the names evicted this call (usually empty)."""
        with self._lock:
            if name in self._lru:
                self._lru.move_to_end(name)
            return self._evict_locked(keep=name)

    def _evict_locked(self, keep: str) -> List[str]:
        evicted: List[str] = []
        # Pressure by count: models (≠ keep) holding live compiles
        if self.max_models > 0:
            while True:
                warm = [n for n, b in self._lru.items()
                        if self._cache_size(b) > 0]
                if len(warm) <= self.max_models:
                    break
                victim = next((n for n in warm if n != keep), None)
                if victim is None:
                    break
                evicted.append(victim)
                self._release(victim)
        # Pressure by bytes: resident param bytes across models
        if self.max_bytes > 0:
            while self._resident_bytes() > self.max_bytes:
                victim = next(
                    (n for n, b in self._lru.items()
                     if n != keep and self._cache_size(b) > 0), None)
                if victim is None:
                    break
                evicted.append(victim)
                self._release(victim)
        return evicted

    def _release(self, name: str) -> None:
        backend = self._lru[name]
        dropped = backend.release_compiled()
        self.jit_evictions += 1
        self.entries_evicted += int(dropped)
        self._lru.move_to_end(name, last=False)   # coldest position
        log.info("residency: evicted %s (%d compiled entries released)",
                 name, dropped)

    @staticmethod
    def _cache_size(backend: Any) -> int:
        try:
            return int(backend.jit_cache_size())
        except Exception:
            return 0

    def _resident_bytes(self) -> int:
        total = 0
        for b in self._lru.values():
            try:
                total += int(b.resident_bytes())
            except Exception:
                pass
        return total

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "resident": list(self._lru),
                "warm": [n for n, b in self._lru.items()
                         if self._cache_size(b) > 0],
                "jit_evictions": self.jit_evictions,
                "entries_evicted": self.entries_evicted,
                "resident_bytes": self._resident_bytes(),
                "max_models": self.max_models,
                "max_bytes": self.max_bytes,
            }


class ScalingController:
    """Traffic-driven slot→model rebinding.

    Every ``interval_s`` the controller reads `tracer.tenant_summary()`
    (per-tenant completion rates over the tracer's request window),
    folds tenant rates into per-model demand via the TenantTable, and
    computes a proportional slot allocation: each bound model gets
    ``max(min_slots, round(slots * share))`` with leftovers going to
    the hottest models. If the allocation differs from the current
    binding it calls ``pool.rebind(mapping)`` — a two-phase broadcast,
    so every slot re-binds in the same pool epoch or none does.

    Rates of exactly zero everywhere (cold start, idle) keep the
    current binding: scaling reacts to traffic, it never thrashes an
    idle pool. Failed rebinds are counted and retried on the next tick.
    """

    def __init__(self, pool: Any, table: TenantTable, tracer: Any,
                 interval_s: float = 1.0, min_slots: int = 1,
                 now: Callable[[], float] = time.monotonic):
        self.pool = pool
        self.table = table
        self.tracer = tracer
        self.interval_s = float(interval_s)
        self.min_slots = int(min_slots)
        self._now = now
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # counters / introspection (under _lock)
        self.decisions = 0       # ticks that computed a plan
        self.rebinds = 0         # plans that changed the binding
        self.rebind_failures = 0
        self.last_plan: Dict[str, int] = {}
        self.last_rates: Dict[str, float] = {}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ScalingController":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="tenancy-scaler", daemon=True)
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
                log.exception("scaling tick failed")

    # -- one decision ------------------------------------------------------
    def tick(self) -> Optional[Dict[str, int]]:
        """One scaling decision; returns the applied plan or None if
        the binding was left alone. Callable directly from tests."""
        demand = self._model_demand()
        with self._lock:
            self.decisions += 1
            self.last_rates = dict(demand)
        models = self.table.models()
        if not models or not any(demand.get(m, 0.0) > 0 for m in models):
            return None
        plan = self._allocate(models, demand)
        current = self._current_binding()
        if current == plan:
            return None
        ok = self._apply(plan)
        with self._lock:
            if ok:
                self.rebinds += 1
                self.last_plan = dict(plan)
            else:
                self.rebind_failures += 1
        return plan if ok else None

    def _model_demand(self) -> Dict[str, float]:
        """Per-model demand = sum of its tenants' observed rates."""
        try:
            per_tenant = self.tracer.tenant_summary()
        except Exception:
            per_tenant = {}
        demand: Dict[str, float] = {}
        for tenant, row in per_tenant.items():
            model = self.table.model_of(tenant)
            if model is None:
                continue
            demand[model] = demand.get(model, 0.0) + float(
                row.get("rate_hz", 0.0))
        return demand

    def _slot_weights(self) -> Dict[int, int]:
        """{wid: capacity weight} — chip count for chip-leased pools
        (serving/placement.py: a K-chip worker serves K replicas'
        traffic), 1 everywhere else. Pool doubles without the surface
        weigh every slot 1."""
        sw = getattr(self.pool, "slot_weights", None)
        if callable(sw):
            try:
                return {int(k): max(1, int(v)) for k, v in sw().items()}
            except Exception:
                pass
        return {}

    def _allocate(self, models: List[str],
                  demand: Dict[str, float]) -> Dict[str, int]:
        """Proportional share with a per-model floor, largest-remainder
        for the leftovers. Deterministic: ties break by model order.
        The budget is CAPACITY slots (chip-weighted), not processes —
        a 2-worker × 4-chip pool allocates 8 units."""
        slots = max(int(getattr(self.pool, "capacity_slots", 0)
                        or self.pool.size), 1)
        total = sum(max(demand.get(m, 0.0), 0.0) for m in models)
        floors = {m: self.min_slots for m in models}
        base = sum(floors.values())
        spare = max(0, slots - base)
        if total <= 0.0 or spare == 0:
            return floors
        exact = {m: spare * max(demand.get(m, 0.0), 0.0) / total
                 for m in models}
        plan = {m: floors[m] + int(exact[m]) for m in models}
        left = slots - sum(plan.values())
        by_frac = sorted(models, key=lambda m: exact[m] - int(exact[m]),
                         reverse=True)
        for m in by_frac:
            if left <= 0:
                break
            plan[m] += 1
            left -= 1
        return plan

    def _current_binding(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        w = self._slot_weights()
        try:
            for sid, model in self.pool.bindings().items():
                if model is not None:
                    counts[model] = counts.get(model, 0) + w.get(sid, 1)
        except Exception:
            pass
        return counts

    def _apply(self, plan: Dict[str, int]) -> bool:
        """Expand a {model: n_slots} plan to {slot_id: model} and push
        it through the pool's two-phase rebind. Slots currently bound
        to a model keep it where the plan allows (minimal churn)."""
        try:
            current = dict(self.pool.bindings())
        except Exception:
            return False
        w = self._slot_weights()
        want = dict(plan)
        mapping: Dict[int, Optional[str]] = {}
        unassigned: List[int] = []
        for sid in sorted(current):
            cur = current[sid]
            wt = w.get(sid, 1)
            # keep the slot only when the plan still owes its model the
            # slot's FULL weight — a K-chip slot consumes K plan units
            if cur is not None and want.get(cur, 0) >= wt:
                mapping[sid] = cur
                want[cur] -= wt
            else:
                unassigned.append(sid)
        for sid in unassigned:
            wt = w.get(sid, 1)
            owed = sorted(((m, n) for m, n in want.items() if n > 0),
                          key=lambda kv: (-kv[1], kv[0]))
            if owed:
                m = owed[0][0]
                mapping[sid] = m
                want[m] -= wt
            else:
                mapping[sid] = None
        try:
            rep = self.pool.rebind(mapping)
        except Exception:
            log.exception("rebind failed")
            return False
        return bool(rep.get("ok"))

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "decisions": self.decisions,
                "rebinds": self.rebinds,
                "rebind_failures": self.rebind_failures,
                "last_plan": dict(self.last_plan),
                "last_rates": dict(self.last_rates),
                "interval_s": self.interval_s,
                "min_slots": self.min_slots,
            }

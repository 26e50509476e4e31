"""Bounded admission queue — load shedding at the serving edge (the JAX
package's traffic/admission.py; the port keeps its own copy).

The reference's query server buffers unboundedly and collapses under
overload (every request eventually times out, goodput → 0). Real
serving edges shed instead: a bounded queue admits up to `max_pending`
requests, refuses the rest with a *typed* rejection the client can act
on (wire `BUSY`, edge/protocol.py), and keeps per-cause counters so the
operator can see exactly what was shed and why.

Policy knobs:

- ``max_pending``   — bound on queued-but-not-yet-dequeued requests.
- ``max_inflight``  — bound on total outstanding requests (queued +
  dequeued-but-not-yet-replied); 0 = unlimited. This caps end-to-end
  concurrency/memory, not just the queue.
- ``shed_policy``   — what happens when the queue is full:
    * ``reject-newest`` (default): refuse the arriving request. FIFO
      fairness; the cheapest policy (nothing admitted is ever wasted).
    * ``reject-oldest``: admit the arrival, shed the oldest *queued*
      request (which has waited longest and is most likely to miss its
      deadline anyway). The victim still gets a BUSY reply — nothing is
      ever silently dropped.
    * ``deadline-drop``: requests carrying a ``meta["deadline_ms"]``
      budget are purged once the budget expires (measured from arrival,
      so no cross-host clock agreement is needed); a full queue with no
      expired entries falls back to reject-newest.

Multi-tenancy (``set_tenants``): with a `TenantTable` installed the
queue grows a weighted-fair front. Each request resolves to a tenant
class via ``meta["tenant"]`` (malformed names are refused with cause
``bad_tenant`` and charged to the ``!invalid`` pseudo-class; missing or
undeclared names fall to the table's default class). Each class gets
its own FIFO deque, and ``get()`` dequeues by start-time fair queueing:
the backlogged class with the smallest virtual time ``_vt[c]`` is
served and charged ``1/weight`` virtual time, so over any backlogged
interval class throughput converges to the weight ratio. A class also
gets a queue bound — explicit ``max_pending`` from its TenantClass, or
a fair share ``ceil(global_max_pending * weight / total_weight)`` — and
arrivals beyond it are refused (or, under reject-oldest, displace that
same class's oldest entry) with cause ``tenant_over_share``: one tenant
flooding can exhaust only its own share, never the whole queue. A class
``deadline_ms`` default applies to requests that don't carry their own.

Accounting contract (the conservation invariant tests assert):

    offered  == admitted + sum(rejected.values())
    admitted == replied + sum(shed.values()) + depth + inflight

``rejected`` counts at-the-door refusals (never entered the queue);
``shed`` counts post-admission victims (reject-oldest, deadline purge,
shutdown drain, dispatch errors). Both reach the client as BUSY. With
tenancy enabled both invariants additionally hold *per class* (see
``counters()["classes"]``), and the per-class counters sum exactly to
the globals: the resolved class is stamped into ``meta["_tenant_class"]``
at offer() and rides the buffer through the wire, so completion
accounting (``note_replied(cls=...)`` / ``note_failed(cls=...)``)
lands on the same class the offer was counted under.

The queue doubles as the serversrc's frame source: ``get()`` is
``queue.Queue``-compatible (blocking, raises ``queue.Empty`` on
timeout) so it drops into the existing drain loops, and ``None``
sentinels pushed via ``put_nowait`` bypass admission entirely (they are
teardown wakeups, not requests — and must never be lost to a full
queue).
"""

from __future__ import annotations

import math
import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.runtime.tracing import stamp_hop
from nnstreamer_tpu_torch.serving.tenancy import (
    CLASS_META, INVALID_CLASS, TENANT_META, TenantTable,
    validate_tenant_name,
)

SHED_POLICIES = ("reject-newest", "reject-oldest", "deadline-drop")

#: TensorBuffer.meta key: per-request latency budget in ms, measured
#: from server-side arrival (deadline-drop purges expired entries)
DEADLINE_META = "deadline_ms"

#: retry-after suggestion before any service-rate estimate exists
_DEFAULT_RETRY_MS = 50.0


@dataclass
class AdmissionDecision:
    """Outcome of one `offer()`: admitted or not, why not, and any
    previously-admitted victims the caller must send BUSY replies for
    (reject-oldest / deadline purge)."""

    admitted: bool
    cause: Optional[str] = None          # rejection cause when refused
    queue_depth: int = 0
    retry_after_ms: float = _DEFAULT_RETRY_MS
    victims: List[Any] = field(default_factory=list)
    victim_cause: Optional[str] = None   # cause for the victims' BUSY


class _ClassState:
    """Per-tenant-class queue + accounting (all fields under the
    AdmissionQueue lock)."""

    __slots__ = ("name", "weight", "max_pending", "deadline_ms",
                 "q", "vt", "offered", "admitted", "replied",
                 "rejected", "shed", "inflight", "depth_peak")

    def __init__(self, name: str, weight: float = 1.0,
                 max_pending: Optional[int] = None,
                 deadline_ms: Optional[float] = None):
        self.name = name
        self.weight = weight
        self.max_pending = max_pending   # None = fair-share default
        self.deadline_ms = deadline_ms
        self.q: deque = deque()          # (item, enq_t, expiry_or_None)
        self.vt = 0.0                    # virtual finish time (SFQ)
        self.offered = 0
        self.admitted = 0
        self.replied = 0
        self.rejected: Dict[str, int] = {}
        self.shed: Dict[str, int] = {}
        self.inflight = 0
        self.depth_peak = 0


class AdmissionQueue:
    """Bounded request queue with typed rejection (module docstring)."""

    def __init__(self, max_pending: int = 64, max_inflight: int = 0,
                 shed_policy: str = "reject-newest"):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._q: deque = deque()          # (item, enq_t, expiry_or_None)
        self.configure(max_pending=max_pending, max_inflight=max_inflight,
                       shed_policy=shed_policy)
        self._inflight = 0
        self._closed = False
        # counters (all mutated under _lock)
        self._offered = 0
        self._admitted = 0
        self._replied = 0
        self._rejected: Dict[str, int] = {}
        self._shed: Dict[str, int] = {}
        self._depth_peak = 0
        # EWMA of inter-reply interval → retry-after suggestion
        self._ewma_reply_s: Optional[float] = None
        self._last_reply_t: Optional[float] = None
        # tenancy (None = single-tenant legacy mode)
        self._table: Optional[TenantTable] = None
        self._classes: Dict[str, _ClassState] = {}
        self._vnow = 0.0                 # system virtual time (SFQ)

    def configure(self, max_pending: Optional[int] = None,
                  max_inflight: Optional[int] = None,
                  shed_policy: Optional[str] = None) -> List[Any]:
        """Re-knob a live queue (serversrc applies its properties at
        start(); the process-wide QueryServer is created earlier with
        defaults).

        Changing ``shed_policy`` mid-stream re-evaluates the queued
        snapshot under the *new* policy instead of silently keeping the
        old one's assumptions: per-queue FIFO order is preserved (every
        policy dequeues FIFO; they differ only in full-queue/expiry
        behavior), and switching **to** ``deadline-drop`` immediately
        purges entries whose budget already expired — those victims are
        returned and the caller owes each a BUSY (cause ``deadline``),
        exactly as if the purge had happened on an offer().

        Shrinking ``max_pending`` below the current depth under
        ``reject-oldest`` immediately sheds the excess oldest entries
        (cause ``bound_shrink``) — they are returned as victims and the
        caller owes each a BUSY. Under the other policies queued
        entries drain naturally (``reject-newest`` only ever refuses
        arrivals), so the depth falls to the new bound without
        eviction. Either way nothing is stranded or double-counted:
        the conservation invariants hold exactly across a live bound
        change (see tests/test_traffic.py)."""
        victims: List[Any] = []
        with self._lock:
            if max_pending is not None:
                if max_pending < 1:
                    raise ValueError(
                        f"max_pending must be >= 1, got {max_pending}")
                self.max_pending = max_pending
                victims.extend(self._shrink_to_bound_locked())
            if max_inflight is not None:
                if max_inflight < 0:
                    raise ValueError(
                        f"max_inflight must be >= 0 (0 = unlimited), "
                        f"got {max_inflight}")
                self.max_inflight = max_inflight
            if shed_policy is not None:
                if shed_policy not in SHED_POLICIES:
                    raise ValueError(
                        f"shed_policy must be one of "
                        f"{' | '.join(SHED_POLICIES)}, got {shed_policy!r}")
                old = getattr(self, "shed_policy", None)
                self.shed_policy = shed_policy
                if old is not None and old != shed_policy \
                        and shed_policy == "deadline-drop":
                    victims = self._purge_expired(time.monotonic())
        return victims

    # -- tenancy -----------------------------------------------------------
    def set_tenants(self, table: Optional[TenantTable]) -> None:
        """Install (or clear) the weighted-fair tenant front. Existing
        per-class counters for classes that survive are kept; classes
        are created for every table entry so counters() shows declared
        tenants even before their first request."""
        with self._lock:
            self._table = table
            if table is None:
                return
            keep = set(table.names()) | {INVALID_CLASS}
            for name in [n for n in self._classes if n not in keep]:
                if not self._classes[name].q:
                    del self._classes[name]
            for c in table.classes():
                st = self._classes.get(c.name)
                if st is None:
                    st = _ClassState(c.name)
                    self._classes[c.name] = st
                st.weight = c.weight
                st.max_pending = c.max_pending
                st.deadline_ms = c.deadline_ms

    @property
    def tenancy(self) -> bool:
        return self._table is not None

    def _class_for(self, meta) -> Tuple[Optional[_ClassState], bool]:
        """Resolve a request's tenant class (lock held). Returns
        (state, valid): valid=False means the tenant name was malformed
        and the request must be refused with ``bad_tenant``."""
        tenant = meta.get(TENANT_META) if isinstance(meta, dict) else None
        if tenant is not None and not validate_tenant_name(tenant):
            return self._class_state(INVALID_CLASS), False
        cls = self._table.class_of(tenant)
        st = self._class_state(cls.name)
        return st, True

    def _class_state(self, name: str) -> _ClassState:
        st = self._classes.get(name)
        if st is None:
            st = _ClassState(name)
            self._classes[name] = st
        return st

    def _class_bound(self, st: _ClassState) -> int:
        """Effective per-class queue bound: explicit override, else a
        fair share of the global bound by weight (recomputed live so a
        configure(max_pending=...) re-shares automatically)."""
        if st.max_pending is not None:
            return st.max_pending
        total_w = sum(c.weight for c in self._table.classes()) or 1.0
        return max(1, math.ceil(self.max_pending * st.weight / total_w))

    def _total_depth(self) -> int:
        if self._table is None:
            return len(self._q)
        return len(self._q) + sum(
            len(st.q) for st in self._classes.values())

    # -- admission ---------------------------------------------------------
    def offer(self, item, now: Optional[float] = None) -> AdmissionDecision:
        """Admit `item` or return a typed refusal. Never blocks."""
        if now is None:
            now = time.monotonic()
        meta = getattr(item, "meta", None)
        with self._cv:
            self._offered += 1
            if self._table is not None:
                return self._offer_tenant(item, meta, now)
            expiry = self._expiry_from(meta, now, None)
            if self._closed:
                return self._refuse("shutdown")
            victims: List[Any] = []
            victim_cause = None
            if self.shed_policy == "deadline-drop":
                victims = self._purge_expired(now)
                if victims:
                    victim_cause = "deadline"
            if self.max_inflight and \
                    len(self._q) + self._inflight >= self.max_inflight:
                d = self._refuse("inflight_full")
                d.victims, d.victim_cause = victims, victim_cause
                return d
            if len(self._q) >= self.max_pending:
                if self.shed_policy == "reject-oldest":
                    victim, _, _ = self._q.popleft()
                    victims.append(victim)
                    victim_cause = "reject_oldest"
                    self._shed["reject_oldest"] = \
                        self._shed.get("reject_oldest", 0) + 1
                else:      # reject-newest, or deadline-drop w/o expiries
                    d = self._refuse("queue_full")
                    d.victims, d.victim_cause = victims, victim_cause
                    return d
            self._admitted += 1
            self._q.append((item, now, expiry))
            if isinstance(meta, dict):
                stamp_hop(meta, "admit", depth=len(self._q))
            if len(self._q) > self._depth_peak:
                self._depth_peak = len(self._q)
            self._cv.notify()
            return AdmissionDecision(
                admitted=True, queue_depth=len(self._q),
                retry_after_ms=self._retry_after_locked(),
                victims=victims, victim_cause=victim_cause)

    def _offer_tenant(self, item, meta, now: float) -> AdmissionDecision:
        """Tenant-mode admission (lock held; self._offered already
        counted). Same decision ladder as legacy mode, with the class
        resolved first so *every* outcome — including refusals — is
        attributed to exactly one class."""
        st, valid = self._class_for(meta)
        st.offered += 1
        if not valid:
            return self._refuse("bad_tenant", st)
        if self._closed:
            return self._refuse("shutdown", st)
        expiry = self._expiry_from(meta, now, st.deadline_ms)
        victims: List[Any] = []
        victim_cause = None
        if self.shed_policy == "deadline-drop":
            victims = self._purge_expired(now)
            if victims:
                victim_cause = "deadline"
        if self.max_inflight and \
                self._total_depth() + self._inflight >= self.max_inflight:
            d = self._refuse("inflight_full", st)
            d.victims, d.victim_cause = victims, victim_cause
            return d
        bound = self._class_bound(st)
        if len(st.q) >= bound:
            # the class is over its share: under reject-oldest it
            # displaces ITS OWN oldest entry (never another tenant's);
            # otherwise the arrival is refused. Either way the cause is
            # tenant_over_share — a flood only ever exhausts its share.
            if self.shed_policy == "reject-oldest" and st.q:
                victim, _, _ = st.q.popleft()
                victims.append(victim)
                victim_cause = "tenant_over_share"
                st.shed["tenant_over_share"] = \
                    st.shed.get("tenant_over_share", 0) + 1
                self._shed["tenant_over_share"] = \
                    self._shed.get("tenant_over_share", 0) + 1
            else:
                d = self._refuse("tenant_over_share", st)
                d.victims, d.victim_cause = victims, victim_cause
                return d
        elif self._total_depth() >= self.max_pending:
            # global bound (shared headroom exhausted even though this
            # class is within its share) — refuse, never displace
            # another class's entries
            d = self._refuse("queue_full", st)
            d.victims, d.victim_cause = victims, victim_cause
            return d
        self._admitted += 1
        st.admitted += 1
        if not st.q:                      # class goes backlogged: SFQ
            st.vt = max(st.vt, self._vnow)
        st.q.append((item, now, expiry))
        if isinstance(meta, dict):
            meta[CLASS_META] = st.name
            stamp_hop(meta, "admit", depth=self._total_depth(),
                      tenant=st.name)
        if len(st.q) > st.depth_peak:
            st.depth_peak = len(st.q)
        total = self._total_depth()
        if total > self._depth_peak:
            self._depth_peak = total
        self._cv.notify()
        return AdmissionDecision(
            admitted=True, queue_depth=total,
            retry_after_ms=self._retry_after_locked(),
            victims=victims, victim_cause=victim_cause)

    @staticmethod
    def _expiry_from(meta, now: float,
                     default_ms: Optional[float]) -> Optional[float]:
        budget = None
        if isinstance(meta, dict):
            b = meta.get(DEADLINE_META)
            if isinstance(b, (int, float)) and b > 0:
                budget = float(b)
        if budget is None and default_ms is not None:
            budget = float(default_ms)
        return None if budget is None else now + budget / 1e3

    def _refuse(self, cause: str,
                st: Optional[_ClassState] = None) -> AdmissionDecision:
        self._rejected[cause] = self._rejected.get(cause, 0) + 1
        if st is not None:
            st.rejected[cause] = st.rejected.get(cause, 0) + 1
        return AdmissionDecision(
            admitted=False, cause=cause, queue_depth=self._total_depth(),
            retry_after_ms=self._retry_after_locked())

    def _purge_expired(self, now: float) -> List[Any]:
        """deadline-drop: shed queued entries whose budget has passed.
        Expired work is wasted work — purge on every offer, not only
        when full."""
        victims = []
        kept = deque()
        for item, enq_t, expiry in self._q:
            if expiry is not None and expiry <= now:
                victims.append(item)
            else:
                kept.append((item, enq_t, expiry))
        if victims:
            self._q = kept
            self._shed["deadline"] = \
                self._shed.get("deadline", 0) + len(victims)
        for st in self._classes.values():
            if not st.q:
                continue
            mine = []
            ckept: deque = deque()
            for item, enq_t, expiry in st.q:
                if expiry is not None and expiry <= now:
                    mine.append(item)
                else:
                    ckept.append((item, enq_t, expiry))
            if mine:
                st.q = ckept
                st.shed["deadline"] = \
                    st.shed.get("deadline", 0) + len(mine)
                self._shed["deadline"] = \
                    self._shed.get("deadline", 0) + len(mine)
                victims.extend(mine)
        return victims

    def _shrink_to_bound_locked(self) -> List[Any]:
        """Mid-stream ``max_pending`` shrink (lock held; called from
        configure()). Only ``reject-oldest`` displaces queued work, so
        only that policy sheds here — the oldest excess entries go
        first, mirroring what the policy does on a full-queue offer.
        Teardown sentinels (`None` rides the legacy queue via
        put_nowait) are never evicted. Every victim is counted exactly
        once — globally and, in tenant mode, on the class that owned
        it — so ``admitted == replied + shed + depth + inflight``
        stays exact through the change."""
        if getattr(self, "shed_policy", None) != "reject-oldest":
            return []
        shed = getattr(self, "_shed", None)
        if shed is None:      # __init__-time configure: queue is empty
            return []
        victims: List[Any] = []
        # tenant mode: trim each class to its recomputed fair-share
        # bound (the global bound re-shares live through _class_bound)
        if self._table is not None:
            for st in self._classes.values():
                bound = self._class_bound(st)
                while len(st.q) > bound:
                    item, _, _ = st.q.popleft()
                    victims.append(item)
                    st.shed["bound_shrink"] = \
                        st.shed.get("bound_shrink", 0) + 1
                    shed["bound_shrink"] = \
                        shed.get("bound_shrink", 0) + 1
        # legacy queue: trim the global excess, oldest first,
        # skipping sentinels
        excess = self._total_depth() - self.max_pending
        if excess > 0 and self._q:
            kept: deque = deque()
            for entry in self._q:
                if excess > 0 and entry[0] is not None:
                    victims.append(entry[0])
                    shed["bound_shrink"] = \
                        shed.get("bound_shrink", 0) + 1
                    excess -= 1
                else:
                    kept.append(entry)
            self._q = kept
        return victims

    def _retry_after_locked(self) -> float:
        """Suggested client backoff: expected time for the current queue
        to drain at the EWMA service rate, clamped to [1ms, 10s].

        Cold start: before the first reply lands the EWMA has no
        samples — a freshly joined host must still advertise a finite,
        positive hint (a zero/degenerate backoff would turn every BUSY
        into an immediate-retry hot loop against the emptiest host in
        the mesh), so the default and a non-finite/non-positive EWMA
        both fall back to `_DEFAULT_RETRY_MS`."""
        ewma = self._ewma_reply_s
        if ewma is None or not math.isfinite(ewma) or ewma <= 0.0:
            return _DEFAULT_RETRY_MS
        est = (self._total_depth() + 1) * ewma * 1e3
        if not math.isfinite(est):
            return 10_000.0
        return min(max(est, 1.0), 10_000.0)

    # -- queue.Queue-compatible consumer side ------------------------------
    def get(self, timeout: Optional[float] = None):
        """Blocking dequeue; raises `queue.Empty` on timeout (drop-in
        for the previous `queue.Queue` drain loops). A dequeued request
        becomes *inflight* until `note_replied`/`note_failed`. In
        tenancy mode the backlogged class with the smallest virtual
        time is served (weighted fair)."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._total_depth() > 0,
                                     timeout=timeout):
                raise _queue.Empty
            if self._q:               # legacy queue / teardown sentinels
                item, _, _ = self._q.popleft()
            else:
                item = self._dequeue_fair_locked()
            if item is not None:          # None = teardown sentinel
                self._inflight += 1
                meta = getattr(item, "meta", None)
                if self._table is not None and isinstance(meta, dict):
                    st = self._classes.get(meta.get(CLASS_META, ""))
                    if st is not None:
                        st.inflight += 1
                stamp_hop(meta, "dequeue")
            return item

    def _dequeue_fair_locked(self):
        """SFQ pick: min virtual time among backlogged classes; the
        served class is charged 1/weight so higher-weight classes are
        picked proportionally more often over any backlogged period."""
        st = min((s for s in self._classes.values() if s.q),
                 key=lambda s: (s.vt, s.name))
        item, _, _ = st.q.popleft()
        self._vnow = st.vt
        st.vt += 1.0 / max(st.weight, 1e-9)
        return item

    def put_nowait(self, item) -> None:
        """Sentinel bypass: enqueue without admission accounting. Used
        for `None` teardown wakeups, which must never be refused or lost
        to a full queue (the seed's `queue.Full` drop left `generate()`
        blocked forever)."""
        with self._cv:
            self._q.append((item, time.monotonic(), None))
            self._cv.notify()

    # -- completion accounting ---------------------------------------------
    def note_replied(self, cls: Optional[str] = None) -> None:
        """One admitted request answered (RESULT sent, or attempted —
        a vanished client still counts as served). `cls` is the value
        the offer stamped into ``meta["_tenant_class"]``; pass it
        whenever tenancy is enabled so the per-class invariant stays
        exact."""
        now = time.monotonic()
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            self._replied += 1
            st = self._class_done_locked(cls)
            if st is not None:
                st.replied += 1
            if self._last_reply_t is not None:
                dt = now - self._last_reply_t
                self._ewma_reply_s = dt if self._ewma_reply_s is None \
                    else 0.8 * self._ewma_reply_s + 0.2 * dt
            self._last_reply_t = now

    def note_failed(self, cause: str = "dispatch_error",
                    cls: Optional[str] = None) -> None:
        """One dequeued request failed before a RESULT could be sent —
        counts as shed so conservation still balances; the caller owes
        the client a BUSY with the same cause."""
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            self._shed[cause] = self._shed.get(cause, 0) + 1
            st = self._class_done_locked(cls)
            if st is not None:
                st.shed[cause] = st.shed.get(cause, 0) + 1

    def _class_done_locked(self, cls: Optional[str]):
        """Per-class inflight release for a completion (lock held).
        With tenancy on, a completion with no class (a request admitted
        before set_tenants, or a caller that lost the meta) lands on
        the default class — global counters stay exact either way."""
        if self._table is None:
            return None
        if cls is None or cls not in self._classes:
            cls = self._table.default
        st = self._class_state(cls)
        st.inflight = max(0, st.inflight - 1)
        return st

    def shed_remaining(self, cause: str = "shutdown") -> List[Any]:
        """Drain every queued request (at close): they are shed with
        `cause`, returned so the caller can send each a BUSY reply, and
        further offers are refused with the same cause."""
        with self._cv:
            self._closed = True
            victims = [item for item, _, _ in self._q if item is not None]
            self._q.clear()
            for st in self._classes.values():
                if st.q:
                    mine = [item for item, _, _ in st.q]
                    st.q.clear()
                    st.shed[cause] = st.shed.get(cause, 0) + len(mine)
                    victims.extend(mine)
            if victims:
                self._shed[cause] = \
                    self._shed.get(cause, 0) + len(victims)
            self._cv.notify_all()
            return victims

    def reopen(self) -> None:
        """Undo `shed_remaining`'s closed latch (tests / restart)."""
        with self._lock:
            self._closed = False

    # -- introspection ------------------------------------------------------
    @property
    def depth(self) -> int:
        with self._lock:
            return self._total_depth()

    def counters(self) -> Dict[str, Any]:
        """Consistent snapshot of the accounting state (one lock hold).
        With tenancy enabled, ``classes`` maps each class name to the
        same shape of counters scoped to that class (plus its weight
        and effective bound); per-class values sum to the globals."""
        with self._lock:
            out = {
                "offered": self._offered,
                "admitted": self._admitted,
                "replied": self._replied,
                "rejected": dict(self._rejected),
                "shed": dict(self._shed),
                "depth": self._total_depth(),
                "inflight": self._inflight,
                "depth_peak": self._depth_peak,
                "max_pending": self.max_pending,
                "max_inflight": self.max_inflight,
                "shed_policy": self.shed_policy,
                # measured per-reply interval (the autotuner's
                # Little's-law service-rate sensor); None until the
                # second reply lands
                "ewma_reply_s": self._ewma_reply_s,
            }
            if self._table is not None:
                out["classes"] = {
                    st.name: {
                        "offered": st.offered,
                        "admitted": st.admitted,
                        "replied": st.replied,
                        "rejected": dict(st.rejected),
                        "shed": dict(st.shed),
                        "depth": len(st.q),
                        "inflight": st.inflight,
                        "depth_peak": st.depth_peak,
                        "weight": st.weight,
                        "max_pending": (
                            st.max_pending
                            if st.name == INVALID_CLASS
                            else self._class_bound(st)),
                        "deadline_ms": st.deadline_ms,
                    }
                    for st in self._classes.values()
                }
            return out

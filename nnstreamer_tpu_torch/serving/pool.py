"""Supervised multi-process worker pool for the serving edge (the JAX
package's serving/pool.py on the port: the same supervision, routing,
admission accounting and wire, so a port client talks to it as to a JAX
pool and back).

N copies of a pipeline in child processes behind one `QueryServer`, with
a supervisor that keeps the pool alive through worker crashes, hangs,
and restarts — and keeps the admission conservation invariants exact
through every one of them:

    offered  == admitted + rejected
    admitted == replied + shed + depth + inflight

The process tree::

    PooledQueryServer                 (parent process)
      ├─ QueryServer transport        HELLO/DATA/RESULT/BUSY wire
      ├─ router thread                admission queue -> least-
      │                               outstanding ready worker
      ├─ per-worker reader threads    results / errors / heartbeats
      ├─ supervisor thread            liveness + restart + circuit
      └─ worker processes (spawn)     serving/worker.py, one pipeline
                                      copy each — crash isolation AND
                                      a GIL sidestep in one move

Supervision contract:

- **Crash** (nonzero exit, SIGKILL, lost pipe): the reader drains every
  result the worker managed to send, then the supervisor *re-offers*
  each remaining in-flight frame to a live worker (up to
  ``max_redeliver`` times) and *sheds* the rest with a typed
  ``BUSY(worker_lost)`` — a killed worker never turns into client-side
  silence.
- **Hang** (heartbeat older than ``hb_timeout_s``, or any in-flight
  frame older than ``frame_deadline_s``): the worker is SIGKILLed and
  handled as a crash. Heartbeats ride a dedicated child thread, so a
  busy worker is distinguished from a wedged one by its *frames*, not
  its pulse.
- **Restart**: exponential backoff (``restart_backoff_s`` doubling to
  ``restart_backoff_max_s``) per slot. A slot that restarts more than
  ``restart_budget`` times inside ``restart_window_s`` is *disabled* —
  the pool degrades to fewer workers and records it (stats +
  ``record_worker_event``) instead of flapping forever.
- **Drain** (`close()` / SIGTERM via `install_signal_handlers`): stop
  admitting (queued frames get ``BUSY(shutdown)``), let in-flight
  frames finish within ``drain_timeout_s``, BUSY whatever remains,
  then stop children gracefully and escalate terminate -> kill. No
  orphan processes, ever (children also self-exit when the pipe dies).

Hot swap: ``swap(name, version)`` broadcasts a two-phase
prepare/commit to every ready worker; any prepare failure aborts every
worker, so the pool's model epoch flips all-or-none — the model store's
epoch semantics lifted across process boundaries.

On the card every pipeline child makes its own CUDA context (its start
is seconds, not the echo worker's tens of milliseconds: give
`ready_timeout_s` and `spawn_grace_s` room for it), and children that
share one card cap their allocators at an equal share (serving/worker.py).
A child SIGKILLed mid-kernel loses its context with the process; the
replacement comes up with a fresh one.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import pickle
import signal
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.edge.query import QueryServer
from nnstreamer_tpu_torch.edge.wire import encode_buffer
from nnstreamer_tpu_torch.runtime.tracing import NULL_TRACER, get_trace_ctx
from nnstreamer_tpu_torch.serving.worker import RID_META, WorkerSpec, worker_main
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

log = get_logger("serving.pool")

#: a process-wide pool number in each pool's ring names: two pools of one
#: name in one process (a mesh's hosts) never meet on a segment name
_POOL_SEQ = itertools.count()

#: worker lifecycle states (the supervision tree)
STARTING, READY, DEAD, DISABLED, STOPPING = (
    "starting", "ready", "dead", "disabled", "stopping")


def proc_alive(pid: int) -> bool:
    """True when `pid` is a live (non-zombie) process — a psutil-free
    /proc probe, the orphan audit the chaos tests and harness run after
    close(): `any(proc_alive(p) for p in pool.all_pids_ever())` must be
    False once the pool is down."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read().decode("ascii", "replace")
        # field 3 is the state char; the comm field may contain spaces
        # and parens, so split from the LAST ')'
        state = data.rsplit(")", 1)[1].split()[0]
        return state != "Z"
    except (OSError, IndexError):
        return False


class _Request:
    """One admitted frame in flight somewhere in the pool. Carries the
    re-encoded wire payload so a re-offer after a worker death needs no
    surviving TensorBuffer."""

    __slots__ = ("rid", "client_id", "pts", "payload", "attempts",
                 "t_sent", "traced", "hops", "cls", "model")

    def __init__(self, rid: int, client_id, pts, payload: bytes,
                 traced: bool = False, cls: Optional[str] = None,
                 model: Optional[str] = None):
        self.rid = rid
        self.client_id = client_id
        self.pts = pts
        self.payload = payload
        self.attempts = 0             # deliveries so far
        self.t_sent = 0.0
        # tenancy: the admission-resolved class (for per-class shed
        # accounting on this request's failure paths) and the model it
        # routes to (for bound-slot dispatch preference)
        self.cls = cls
        self.model = model
        # parent-side hop records (dispatch/reoffer): the payload is
        # already-encoded bytes when the router touches it, so router
        # hops are kept here and merged into the reply's trace context
        # at _on_result — this is what makes a redelivered frame's
        # timeline show BOTH the dead and the replacement worker (the
        # dead worker's own stamps died with it; the parent's dispatch
        # record carries its wid/pid)
        self.traced = traced
        self.hops: List[dict] = []

    def hop(self, name: str, **extra) -> None:
        if self.traced:
            rec = {"hop": name, "t": time.perf_counter(),
                   "pid": os.getpid()}
            rec.update(extra)
            self.hops.append(rec)


class _Slot:
    """One supervised worker slot: the process occupying it now plus
    the slot's restart history (the circuit breaker is per-slot, so one
    poisoned pipeline copy cannot disable its healthy siblings)."""

    def __init__(self, wid: int):
        self.wid = wid
        self.state = STARTING
        self.proc: Optional[mp.process.BaseProcess] = None
        self.conn = None
        self.reader: Optional[threading.Thread] = None
        self.send_lock = threading.Lock()
        self.pid: Optional[int] = None
        self.started_t = 0.0
        self.last_hb = 0.0            # parent-clock arrival time
        self.inflight: Dict[int, _Request] = {}
        # perf_counter skew vs this worker (≈0 on Linux, where
        # perf_counter is the system-wide CLOCK_MONOTONIC); sampled at
        # the ready handshake, applied when merging its trace deltas
        self.clock_offset_s = 0.0
        self.restart_times: Deque[float] = deque()
        self.backoff_s = 0.0
        self.next_restart_t = 0.0
        self.restarts = 0             # lifetime counters (stats)
        self.kills = 0
        self.replied = 0
        self.version: Optional[tuple] = None
        self.bound_model: Optional[str] = None   # rebind() routing hint
        self.chips: tuple = ()        # leased device ordinals (placement)
        # same-host shm lane (serving/shm.py): the parent-created ring
        # pair for THIS process occupancy; shm_ok flips true only after
        # the child acks attach at handshake, so the lane is negotiated,
        # never assumed. spawns makes ring names unique per occupancy.
        self.shm_req = None           # parent→child ring (parent writes)
        self.shm_res = None           # child→parent ring (parent reads)
        self.shm_ok = False
        self.spawns = 0
        self.device: Optional[str] = None   # the child's, at handshake

    def hb_age_s(self, now: float) -> float:
        return now - max(self.last_hb, self.started_t)


class WorkerPool:
    """Supervised pool of worker processes behind one QueryServer
    (module docstring). Use `PooledQueryServer` unless you already own
    the QueryServer lifecycle."""

    def __init__(self, qs: QueryServer, spec: WorkerSpec, workers: int,
                 *,
                 per_worker_queue: int = 4,
                 max_redeliver: int = 1,
                 hb_timeout_s: float = 2.0,
                 frame_deadline_s: float = 30.0,
                 restart_backoff_s: float = 0.05,
                 restart_backoff_max_s: float = 2.0,
                 restart_budget: int = 5,
                 restart_window_s: float = 30.0,
                 drain_timeout_s: float = 10.0,
                 spawn_grace_s: float = 20.0,
                 chips: Optional[Sequence[int]] = None,
                 shm_transport: bool = True,
                 shm_ring_bytes: int = 0,
                 name: str = "worker_pool"):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if per_worker_queue < 1:
            raise ValueError("per_worker_queue must be >= 1")
        # chip ownership (serving/placement.ChipLeaseTable): device
        # ordinals partitioned across the slots — worker i owns chips
        # i*K..(i+1)*K-1. The supervisor fences a dead worker's chips
        # and re-leases them to the replacement; a K-chip slot counts
        # as K capacity slots (capacity_slots / slot_weights).
        self.chip_table = None
        self._chips_per_slot = 0
        if chips:
            if len(chips) % workers != 0:
                raise ValueError(
                    f"chips ({len(chips)}) must divide evenly across "
                    f"workers ({workers})")
            from nnstreamer_tpu_torch.serving.placement import ChipLeaseTable

            self.chip_table = ChipLeaseTable(chips)
            self._chips_per_slot = len(chips) // workers
        self.qs = qs
        # a traced pool runs traced workers: the child spins up its own
        # Tracer and ships deltas back over the pipe ("tr" lane)
        import dataclasses

        if getattr(qs.tracer, "active", False) and not spec.trace:
            spec = dataclasses.replace(spec, trace=True)
        # the children sharing one card split it by this count
        # (serving/worker.py's per-process memory share)
        if spec.workers != workers:
            spec = dataclasses.replace(spec, workers=workers)
        self.spec = spec
        self.name = name
        self._ring_tag = f"{name}-{next(_POOL_SEQ)}"
        self.n_workers = workers
        self.per_worker_queue = per_worker_queue
        self.max_redeliver = max(0, max_redeliver)
        self.hb_timeout_s = hb_timeout_s
        self.frame_deadline_s = frame_deadline_s
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_max_s = restart_backoff_max_s
        self.restart_budget = restart_budget
        self.restart_window_s = restart_window_s
        self.drain_timeout_s = drain_timeout_s
        self.spawn_grace_s = spawn_grace_s
        # spawn, never fork: the parent runs transport + router threads
        # (and often a CUDA context, which a fork cannot carry) —
        # forked locks/engines in the child
        # are exactly the wedge class this pool exists to survive
        self._ctx = mp.get_context("spawn")
        self._lock = threading.RLock()
        self._slots: List[_Slot] = [_Slot(i) for i in range(workers)]
        self._pending: Deque[_Request] = deque()   # awaiting (re)dispatch
        self._dispatch_evt = threading.Event()
        self._stop_evt = threading.Event()
        self._closed = False
        self._close_lock = threading.Lock()
        self._next_rid = 0
        self.epoch = 0                # bumps on every committed swap
        self.degraded = 0             # slots disabled by the circuit
        self.reoffered = 0
        # same-host shm lane (serving/shm.py): enabled pools give every
        # slot a per-spawn ring pair; payloads that fit ride shared
        # memory, everything else transparently stays on pickle+pipe
        from nnstreamer_tpu_torch.serving.shm import (
            DEFAULT_RING_BYTES, shm_supported)

        self.shm_transport = bool(shm_transport) and shm_supported()
        self.shm_ring_bytes = int(shm_ring_bytes) or DEFAULT_RING_BYTES
        self._shm_stat_lock = threading.Lock()
        self.shm_frames = 0           # records moved via shm (both dirs)
        self.shm_bytes = 0
        self.shm_fallbacks = 0        # lane bypasses (full/unattached)
        self.rebinds = 0              # committed rebind broadcasts
        self.tenant_table = None      # serving.tenancy.TenantTable
        self.last_worker_error: Optional[BaseException] = None
        self._resident_versions: Dict[str, list] = {}
        self._all_pids: List[int] = []   # every pid ever spawned
        self._router: Optional[threading.Thread] = None
        self._supervisor: Optional[threading.Thread] = None
        self._started = False

    # -- tracer ------------------------------------------------------------
    @property
    def tracer(self):
        return self.qs.tracer or NULL_TRACER

    def _event(self, wid: int, kind: str, **args) -> None:
        tr = self.tracer
        if tr.active:
            tr.record_worker_event(self.name, wid, kind,
                                   time.perf_counter(), **args)

    # -- lifecycle ---------------------------------------------------------
    def start(self, ready_timeout_s: float = 30.0) -> "WorkerPool":
        with self._lock:
            if self._started:
                return self
            self._started = True
            for slot in self._slots:
                self._spawn(slot)
        self._router = threading.Thread(
            target=self._route_loop, name=f"{self.name}-router",
            daemon=True)
        self._router.start()
        self._supervisor = threading.Thread(
            target=self._supervise_loop, name=f"{self.name}-supervisor",
            daemon=True)
        self._supervisor.start()
        self.qs.pool = self
        if ready_timeout_s:
            self.wait_ready(ready_timeout_s)
        return self

    def wait_ready(self, timeout_s: float = 30.0,
                   n: Optional[int] = None) -> bool:
        """Block until `n` workers (default: all non-disabled) are
        ready; False on timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                ready = sum(1 for s in self._slots if s.state == READY)
                want = n if n is not None else sum(
                    1 for s in self._slots if s.state != DISABLED)
            if want and ready >= want:
                return True
            time.sleep(0.01)
        return False

    def _spawn(self, slot: _Slot) -> None:
        """Start a worker in `slot` (under `_lock`)."""
        spec = self.spec
        if self.chip_table is not None:
            # (re-)lease the slot's chips: a restarted slot gets its own
            # fenced chips back first, so "worker wid owns chips i..j"
            # survives the crash
            slot.chips = self.chip_table.lease(
                slot.wid, self._chips_per_slot)
            import dataclasses

            spec = dataclasses.replace(spec, chips=slot.chips)
        slot.spawns += 1
        slot.shm_ok = False
        if self.shm_transport:
            # per-spawn ring pair with unique names: a respawned slot
            # can never attach its predecessor's (possibly half-written)
            # segments. Create failure degrades to pipe-only, silently.
            import dataclasses

            from nnstreamer_tpu_torch.serving.shm import ShmRing, ring_name

            try:
                slot.shm_req = ShmRing.create(
                    ring_name("rq", self._ring_tag, slot.wid, slot.spawns),
                    self.shm_ring_bytes)
                slot.shm_res = ShmRing.create(
                    ring_name("rs", self._ring_tag, slot.wid, slot.spawns),
                    self.shm_ring_bytes)
                spec = dataclasses.replace(
                    spec, shm_req=slot.shm_req.name,
                    shm_res=slot.shm_res.name)
            except Exception as e:
                log.warning("pool %s: shm ring create failed (%s) — "
                            "slot %d stays on pipe", self.name, e,
                            slot.wid)
                self._drop_rings(slot)
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(
            target=worker_main, args=(child_conn, spec, slot.wid),
            name=f"{self.name}-w{slot.wid}", daemon=True)
        proc.start()
        child_conn.close()            # child's end lives in the child
        slot.proc = proc
        slot.conn = parent_conn
        slot.pid = proc.pid
        slot.state = STARTING
        slot.started_t = time.monotonic()
        slot.last_hb = 0.0
        self._all_pids.append(proc.pid)
        slot.reader = threading.Thread(
            target=self._read_loop, args=(slot, parent_conn),
            name=f"{self.name}-read-w{slot.wid}", daemon=True)
        slot.reader.start()
        self._event(slot.wid, "spawn", pid=proc.pid)

    def _drop_rings(self, slot: _Slot) -> None:
        """Close AND unlink a slot's ring pair (parent is the creator,
        so the name dies here — the /dev/shm audit in the worker-kill
        drill counts on this being unconditional). Serialized against
        in-flight ring writes via send_lock."""
        with slot.send_lock:
            slot.shm_ok = False
            for ring in (slot.shm_req, slot.shm_res):
                if ring is not None:
                    ring.close()
                    ring.unlink()
            slot.shm_req = slot.shm_res = None

    # -- per-worker reader -------------------------------------------------
    def _read_loop(self, slot: _Slot, conn) -> None:
        """Drains one worker's pipe until EOF. Runs everything the
        worker managed to say before dying — which is what makes the
        post-mortem re-offer safe: a result can never race its own
        redelivery, because reaping waits for this thread."""
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                return
            tag = msg[0]
            if tag == "hb":
                slot.last_hb = time.monotonic()
            elif tag == "res":
                self._on_result(slot, msg[1], msg[2])
            elif tag == "ress":
                self._on_shm_result(slot, msg[1], msg[2], msg[3])
            elif tag == "err":
                self._on_request_error(slot, msg[1], msg[2])
            elif tag == "ready":
                slot.last_hb = time.monotonic()
                with self._lock:
                    if slot.state == STARTING:
                        slot.state = READY
                info = msg[1]
                if isinstance(info, dict) and slot.shm_req is not None:
                    if info.get("shm"):
                        slot.shm_ok = True
                    else:
                        # child couldn't attach: the lane is dead for
                        # this occupancy — reclaim the segments now
                        # rather than carrying them as ballast
                        with self._shm_stat_lock:
                            self.shm_fallbacks += 1
                        self._drop_rings(slot)
                if isinstance(info, dict):
                    slot.device = info.get("device")
                t_child = info.get("t_perf") if isinstance(info, dict) \
                    else None
                if t_child is not None:
                    # perf_counter is the system-wide CLOCK_MONOTONIC
                    # on Linux, so a small delta here is just pipe
                    # latency — only a genuinely different clock base
                    # (>1s apart) is treated as skew to correct
                    raw = time.perf_counter() - float(t_child)
                    slot.clock_offset_s = raw if abs(raw) > 1.0 else 0.0
                self._adopt_out_spec(info)
                self._event(slot.wid, "ready", pid=slot.pid)
                self._dispatch_evt.set()
            elif tag == "tr":
                tr = self.tracer
                if tr.active:
                    tr.ingest_child(
                        slot.wid, slot.pid or 0, msg[1],
                        offset_s=slot.clock_offset_s,
                        label=f"{self.name}-w{slot.wid}")
            elif tag == "swap_ack":
                with self._lock:
                    acks = self._swap_acks
                if acks is not None:
                    acks.put((slot.wid, msg[1], msg[2], msg[3]))
            elif tag == "bind_ack":
                with self._lock:
                    acks = self._bind_acks
                if acks is not None:
                    acks.put((slot.wid, msg[1], msg[2], msg[3]))
            elif tag == "fatal":
                self._note_worker_error(slot, msg[1])
            elif tag == "bye":
                return

    def _adopt_out_spec(self, info: dict) -> None:
        """First ready worker declares the pool's output spec (HELLO
        contract) unless the owner already set one. The worker's
        resident ``store://`` versions ride the same ready info — the
        mesh REGISTER ad advertises them for locality routing."""
        versions = info.get("versions")
        if isinstance(versions, dict) and versions:
            with self._lock:
                self._resident_versions = versions
        if self.qs.out_spec is not None:
            return
        dims, types = info.get("out_dims"), info.get("out_types")
        if dims:
            try:
                self.qs.out_spec = TensorsSpec.from_strings(dims, types)
            except ValueError:
                pass

    def resident_versions(self) -> Dict[str, list]:
        """{model name: [resident versions]} as the most recent ready
        worker reported them (empty for echo pools)."""
        with self._lock:
            return dict(self._resident_versions)

    def _on_result(self, slot: _Slot, rid: int, payload: bytes) -> None:
        from nnstreamer_tpu_torch.edge.wire import decode_buffer

        with self._lock:
            req = slot.inflight.pop(rid, None)
        if req is None:
            # already re-offered/shed (abandoned at drain) — the
            # admission accounting closed this request elsewhere
            return
        slot.replied += 1
        try:
            buf, _ = decode_buffer(payload)
        except ValueError as e:
            log.warning("pool %s: worker %d returned a corrupt frame "
                        "for pts=%s: %s", self.name, slot.wid,
                        req.pts, e)
            self.qs.frames.note_failed("worker_error", cls=req.cls)
            self.qs.send_busy(req.client_id, req.pts, "worker_error")
            return
        buf.meta.pop(RID_META, None)
        if req.hops:
            # merge the parent-side router hops (dispatch/reoffer) into
            # the reply's trace context, in time order: one timeline
            # per trace_id even across a redelivery
            ctx = get_trace_ctx(buf.meta)
            if ctx is not None:
                ctx["hops"].extend(req.hops)
                ctx["hops"].sort(
                    key=lambda h: h.get("t", 0.0)
                    if isinstance(h, dict) else 0.0)
        self.qs.reply(int(req.client_id), buf.with_tensors(
            buf.tensors, pts=req.pts))
        self._dispatch_evt.set()

    def _on_shm_result(self, slot: _Slot, rid: int, nbytes: int,
                       seq: int) -> None:
        """A result whose payload rode the res ring. Any ring fault
        (mismatch, torn record, ring gone) sheds exactly this request —
        the control message is still the unit of accounting, so
        conservation can't drift whatever the lane does."""
        ring = slot.shm_res
        try:
            if ring is None:
                raise ValueError("shm result with no attached ring")
            payload = ring.read_record(nbytes, seq)
        except Exception as e:
            log.warning("pool %s: worker %d shm result fault for "
                        "rid=%s: %s", self.name, slot.wid, rid, e)
            with self._lock:
                req = slot.inflight.pop(rid, None)
            if req is not None:
                self.qs.frames.note_failed("worker_error", cls=req.cls)
                self.qs.send_busy(req.client_id, req.pts, "worker_error")
                self._dispatch_evt.set()
            return
        with self._shm_stat_lock:
            self.shm_frames += 1
            self.shm_bytes += nbytes
        self._on_result(slot, rid, payload)

    def _on_request_error(self, slot: _Slot, rid: int,
                          exc_bytes: bytes) -> None:
        """Request-scoped failure: the worker survives, this one frame
        is shed with a typed BUSY."""
        with self._lock:
            req = slot.inflight.pop(rid, None)
        try:
            exc = pickle.loads(exc_bytes)
        except Exception:
            exc = StreamError("worker error (unpicklable)")
        self.last_worker_error = exc
        if req is None:
            return
        log.warning("pool %s: worker %d failed frame pts=%s: %s",
                    self.name, slot.wid, req.pts, exc)
        self.qs.frames.note_failed("worker_error", cls=req.cls)
        self.qs.send_busy(req.client_id, req.pts, "worker_error")
        self._dispatch_evt.set()

    def _note_worker_error(self, slot: _Slot, exc_bytes: bytes) -> None:
        try:
            self.last_worker_error = pickle.loads(exc_bytes)
        except Exception:
            self.last_worker_error = StreamError(
                "worker fatal error (unpicklable)")
        log.error("pool %s: worker %d fatal: %s", self.name, slot.wid,
                  self.last_worker_error)

    # -- router ------------------------------------------------------------
    def _route_loop(self) -> None:
        """Admission queue -> least-outstanding ready worker. Holds at
        most one undispatched request in hand (plus re-offers); real
        backpressure lives in the admission queue, where it turns into
        typed BUSY at the door instead of unbounded memory."""
        import queue as _queue

        while not self._stop_evt.is_set():
            req = None
            with self._lock:
                if self._pending:
                    req = self._pending.popleft()
            if req is None:
                try:
                    buf = self.qs.frames.get(timeout=0.05)
                except _queue.Empty:
                    continue
                if buf is None:       # teardown sentinel
                    continue
                req = self._admit(buf)
            if not self._dispatch(req):
                with self._lock:
                    self._pending.appendleft(req)
                # no routable worker right now: wait for a reply slot,
                # a ready worker, or teardown
                self._dispatch_evt.wait(0.05)
                self._dispatch_evt.clear()

    def set_tenants(self, table) -> None:
        """Install a `serving.tenancy.TenantTable` for tenant→model
        routing (bound-slot dispatch preference + per-class shed
        accounting on this pool's failure paths)."""
        with self._lock:
            self.tenant_table = table

    def _admit(self, buf) -> _Request:
        with self._lock:
            self._next_rid += 1
            rid = self._next_rid
            table = self.tenant_table
        client_id = buf.meta.pop("client_id", None)
        buf.meta[RID_META] = rid
        cls = buf.meta.get("_tenant_class") \
            if isinstance(buf.meta, dict) else None
        model = table.model_of(cls) if table is not None else None
        return _Request(rid, client_id, buf.pts, encode_buffer(buf),
                        traced=get_trace_ctx(buf.meta) is not None,
                        cls=cls, model=model)

    def _dispatch(self, req: _Request) -> bool:
        """Send to the least-outstanding READY worker with queue room;
        False when no worker can take it right now. A request routed to
        a model prefers slots bound to that model (rebind()); when none
        has room it falls back to any candidate — a multiplex worker
        can serve every model, a bound slot is just warmer."""
        with self._lock:
            candidates = [s for s in self._slots
                          if s.state == READY
                          and len(s.inflight) < self.per_worker_queue]
            if not candidates:
                return False
            if req.model is not None:
                bound = [s for s in candidates
                         if s.bound_model == req.model]
                if bound:
                    candidates = bound
            slot = min(candidates, key=lambda s: len(s.inflight))
            req.attempts += 1
            req.t_sent = time.monotonic()
            slot.inflight[req.rid] = req
        req.hop("dispatch", wid=slot.wid, wpid=slot.pid,
                attempt=req.attempts)
        try:
            with slot.send_lock:
                # same-host shm lane: payload into the req ring, a tiny
                # control message on the pipe; ring-full (or no lane)
                # falls back to the classic pickle+pipe send — same
                # rid, same accounting, just a fatter message
                seq = slot.shm_req.try_write(req.payload) \
                    if slot.shm_ok and slot.shm_req is not None else None
                if seq is not None:
                    slot.conn.send(("reqs", req.rid, len(req.payload),
                                    seq))
                    with self._shm_stat_lock:
                        self.shm_frames += 1
                        self.shm_bytes += len(req.payload)
                else:
                    if slot.shm_ok:
                        with self._shm_stat_lock:
                            self.shm_fallbacks += 1
                    slot.conn.send(("req", req.rid, req.payload))
        except (OSError, ValueError, BrokenPipeError):
            # worker died between pick and send: undo, let the
            # supervisor reap it; the request goes back to pending
            with self._lock:
                slot.inflight.pop(req.rid, None)
                req.attempts -= 1
            if req.hops:
                req.hops.pop()
            return False
        return True

    # -- supervisor --------------------------------------------------------
    def _supervise_loop(self) -> None:
        poll = max(0.02, min(0.25, self.hb_timeout_s / 4.0))
        while not self._stop_evt.wait(poll):
            self._scan(time.monotonic())

    def _scan(self, now: float) -> None:
        """One supervision pass: detect death/hang, reap, restart."""
        for slot in self._slots:
            with self._lock:
                state = slot.state
            if state in (STARTING, READY):
                if slot.proc is not None and not slot.proc.is_alive():
                    self._reap(slot, "exit",
                               exitcode=slot.proc.exitcode)
                    continue
                grace = self.spawn_grace_s if state == STARTING \
                    else self.hb_timeout_s
                if slot.hb_age_s(now) > grace:
                    self._kill(slot, "hb_timeout")
                    continue
                oldest = None
                with self._lock:
                    if slot.inflight:
                        oldest = min(r.t_sent
                                     for r in slot.inflight.values())
                if oldest is not None and \
                        now - oldest > self.frame_deadline_s:
                    self._kill(slot, "frame_deadline")
                    continue
            elif state == DEAD and now >= slot.next_restart_t:
                self._restart(slot, now)

    def _kill(self, slot: _Slot, cause: str) -> None:
        """Hard-stop a hung worker (SIGKILL — it is by definition not
        listening) and handle it as a death."""
        slot.kills += 1
        log.warning("pool %s: killing worker %d (pid %s): %s",
                    self.name, slot.wid, slot.pid, cause)
        self._event(slot.wid, "kill", cause=cause, pid=slot.pid)
        try:
            if slot.proc is not None:
                slot.proc.kill()
        except (OSError, ValueError):
            pass
        self._reap(slot, cause)

    def _reap(self, slot: _Slot, cause: str, exitcode=None) -> None:
        """Post-mortem: drain the reader, then re-offer or shed every
        in-flight frame so conservation holds exactly through the
        death. Runs on the supervisor thread only."""
        with self._lock:
            if slot.state not in (STARTING, READY, STOPPING):
                return
            slot.state = DEAD
        if slot.proc is not None:
            slot.proc.join(timeout=5)     # reap the zombie
        try:
            if slot.conn is not None:
                slot.conn.close()         # unblocks the reader at EOF
        except OSError:
            pass
        if slot.reader is not None:
            slot.reader.join(timeout=5)
            if slot.reader.is_alive():
                log.warning("pool %s: reader of worker %d still alive "
                            "after join — leaked", self.name, slot.wid)
        self._event(slot.wid, "exit", cause=cause, exitcode=exitcode,
                    pid=slot.pid)
        # shm reclamation: the reader has drained (no more ring reads
        # can race), the process is dead (no more ring writes) — close
        # and unlink both segments so a killed worker leaks nothing;
        # the replacement spawn creates a fresh, differently-named pair
        self._drop_rings(slot)
        if self.chip_table is not None and slot.chips:
            # the dead worker's chips go out of service until the
            # replacement process re-leases them at _spawn
            fenced = self.chip_table.fence(slot.wid)
            if fenced:
                self._event(slot.wid, "chips_fenced", chips=list(fenced))
        with self._lock:
            orphaned = list(slot.inflight.values())
            slot.inflight.clear()
            live_possible = any(s.state in (STARTING, READY)
                                for s in self._slots) or \
                self._restartable(slot, time.monotonic())
        for req in orphaned:
            if req.attempts <= self.max_redeliver and live_possible \
                    and not self._stop_evt.is_set():
                # re-offer: still `inflight` in admission accounting —
                # nothing changes until it is replied or shed
                with self._lock:
                    self._pending.appendleft(req)
                self.reoffered += 1
                req.hop("reoffer", wid=slot.wid, cause=cause,
                        attempt=req.attempts)
                self._event(slot.wid, "reoffer", pts=req.pts,
                            attempts=req.attempts)
            else:
                self.qs.frames.note_failed("worker_lost", cls=req.cls)
                self.qs.send_busy(req.client_id, req.pts, "worker_lost")
        # exponential backoff before the slot restarts
        slot.backoff_s = min(
            self.restart_backoff_max_s,
            self.restart_backoff_s * (2 ** len(slot.restart_times)))
        slot.next_restart_t = time.monotonic() + slot.backoff_s
        self._dispatch_evt.set()

    def _restartable(self, slot: _Slot, now: float) -> bool:
        while slot.restart_times and \
                now - slot.restart_times[0] > self.restart_window_s:
            slot.restart_times.popleft()
        return len(slot.restart_times) < self.restart_budget

    def _restart(self, slot: _Slot, now: float) -> None:
        """Restart a dead slot — or trip its circuit: more than
        `restart_budget` restarts inside `restart_window_s` means the
        worker is systematically dying (bad model, poisoned input,
        broken native dep); the pool degrades to fewer workers and
        says so, instead of burning CPU flapping forever."""
        if not self._restartable(slot, now):
            with self._lock:
                slot.state = DISABLED
                self.degraded += 1
            log.error(
                "pool %s: worker slot %d exceeded its restart budget "
                "(%d restarts in %.0fs) — slot DISABLED, pool degraded "
                "to %d worker(s)", self.name, slot.wid,
                self.restart_budget, self.restart_window_s,
                self.live_workers())
            self._event(slot.wid, "degraded",
                        restarts_in_window=len(slot.restart_times),
                        window_s=self.restart_window_s)
            if self.chip_table is not None and slot.chips:
                # a disabled slot surrenders its chips instead of
                # pinning them fenced forever; capacity_slots drops
                freed = self.chip_table.release(slot.wid)
                slot.chips = ()
                self._event(slot.wid, "chips_released",
                            chips=list(freed))
            return
        slot.restart_times.append(now)
        slot.restarts += 1
        with self._lock:
            self._spawn(slot)
        self._event(slot.wid, "restart", backoff_s=slot.backoff_s)

    # -- hot swap ----------------------------------------------------------
    _swap_acks = None

    def swap(self, name: str, version=None,
             timeout_s: float = 30.0) -> dict:
        """Broadcast a two-phase model hot swap to every ready worker.
        All-or-none: any prepare failure aborts everywhere and the pool
        epoch does not move (the store's epoch semantics across
        processes)."""
        import queue as _queue

        with self._lock:
            targets = [s for s in self._slots if s.state == READY]
            if not targets:
                return {"ok": False, "error": "no ready workers",
                        "epoch": self.epoch}
            acks: "_queue.Queue" = _queue.Queue()
            self._swap_acks = acks

        def phase(ph: str, slots) -> Dict[int, tuple]:
            got: Dict[int, tuple] = {}
            for s in slots:
                try:
                    with s.send_lock:
                        s.conn.send(("swap", ph, name, version))
                except (OSError, ValueError, BrokenPipeError):
                    got[s.wid] = (False, "worker died mid-swap")
            deadline = time.monotonic() + timeout_s
            while len(got) < len(slots):
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                try:
                    wid, ph_got, ok, err = acks.get(timeout=remain)
                except _queue.Empty:
                    break
                if ph_got == ph:
                    got[wid] = (ok, err)
            for s in slots:
                got.setdefault(s.wid, (False, f"no {ph} ack"))
            return got

        try:
            prep = phase("prepare", targets)
            report = {"name": name, "version": version,
                      "workers": {w: {"prepare_ok": ok, "error": err}
                                  for w, (ok, err) in prep.items()}}
            if not all(ok for ok, _ in prep.values()):
                phase("abort", targets)
                report["ok"] = False
                report["epoch"] = self.epoch
                self._event(-1, "swap_abort", model=name)
                return report
            comm = phase("commit", targets)
            for w, (ok, err) in comm.items():
                report["workers"][w]["commit_ok"] = ok
                if err:
                    report["workers"][w]["error"] = err
            report["ok"] = all(ok for ok, _ in comm.values())
            if report["ok"]:
                with self._lock:
                    self.epoch += 1
                    for s in targets:
                        s.version = (name, version)
                report["epoch"] = self.epoch
                self._event(-1, "swap_commit", model=name,
                            epoch=self.epoch)
            else:
                # a commit failure after unanimous prepare means that
                # worker is now inconsistent with its siblings: kill it
                # so the restart comes back clean
                report["epoch"] = self.epoch
                for s in targets:
                    if not comm.get(s.wid, (True, None))[0]:
                        self._kill(s, "swap_commit_failed")
            return report
        finally:
            with self._lock:
                self._swap_acks = None

    # -- replica rebinding (serving/tenancy.ScalingController) -------------
    _bind_acks = None

    def bindings(self) -> Dict[int, Optional[str]]:
        """{wid: bound model (or None)} for every ready slot — the
        ScalingController's view of the current replica assignment."""
        with self._lock:
            return {s.wid: s.bound_model for s in self._slots
                    if s.state == READY}

    @property
    def size(self) -> int:
        """Configured slot count (the scaler's allocation budget)."""
        return self.n_workers

    @property
    def capacity_slots(self) -> int:
        """Chip-weighted capacity: a slot bound to K chips serves K
        replicas' worth of traffic, so the scaler allocates against
        Σ weights, not the process count. Plain pools (no chip table)
        weigh every slot 1 — identical to `size`. DISABLED slots have
        surrendered their chips and count 0."""
        return sum(self.slot_weights().values()) or 1

    def slot_weights(self) -> Dict[int, int]:
        """{wid: capacity weight} for every non-disabled slot — chip
        count when leases exist, else 1."""
        with self._lock:
            out: Dict[int, int] = {}
            for s in self._slots:
                if s.state == DISABLED:
                    continue
                out[s.wid] = len(s.chips) if self.chip_table is not None \
                    else 1
            return out

    def rebind(self, mapping: Dict[int, Optional[str]],
               timeout_s: float = 30.0) -> dict:
        """Re-bind pool slots to models, epoch-atomically.

        `mapping` is {wid: model name or None}; slots it omits keep
        their binding. Reuses the swap broadcast's two-phase shape:
        every targeted ready worker gets prepare, any refusal (e.g. a
        multiplex worker without that model) aborts everywhere, and
        only a unanimous commit flips the parent's routing table and
        bumps the pool epoch — dispatch never sees a half-applied
        binding. A commit failure after unanimous prepare kills that
        worker (same reasoning as swap: it is now inconsistent)."""
        import queue as _queue

        with self._lock:
            targets = [s for s in self._slots
                       if s.state == READY and s.wid in mapping]
            if not targets:
                return {"ok": False, "error": "no ready workers in "
                        "mapping", "epoch": self.epoch}
            acks: "_queue.Queue" = _queue.Queue()
            self._bind_acks = acks

        def phase(ph: str, slots) -> Dict[int, tuple]:
            got: Dict[int, tuple] = {}
            for s in slots:
                try:
                    with s.send_lock:
                        s.conn.send(("bind", ph, mapping[s.wid]))
                except (OSError, ValueError, BrokenPipeError):
                    got[s.wid] = (False, "worker died mid-rebind")
            deadline = time.monotonic() + timeout_s
            while len(got) < len(slots):
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                try:
                    wid, ph_got, ok, err = acks.get(timeout=remain)
                except _queue.Empty:
                    break
                if ph_got == ph:
                    got[wid] = (ok, err)
            for s in slots:
                got.setdefault(s.wid, (False, f"no {ph} ack"))
            return got

        try:
            prep = phase("prepare", targets)
            report = {"mapping": {s.wid: mapping[s.wid]
                                  for s in targets},
                      "workers": {w: {"prepare_ok": ok, "error": err}
                                  for w, (ok, err) in prep.items()}}
            if not all(ok for ok, _ in prep.values()):
                phase("abort", targets)
                report["ok"] = False
                report["epoch"] = self.epoch
                self._event(-1, "rebind_abort")
                return report
            comm = phase("commit", targets)
            for w, (ok, err) in comm.items():
                report["workers"][w]["commit_ok"] = ok
                if err:
                    report["workers"][w]["error"] = err
            report["ok"] = all(ok for ok, _ in comm.values())
            if report["ok"]:
                with self._lock:
                    self.epoch += 1
                    self.rebinds += 1
                    for s in targets:
                        s.bound_model = mapping[s.wid]
                report["epoch"] = self.epoch
                self._event(-1, "rebind_commit", epoch=self.epoch,
                            bindings=len(targets))
            else:
                report["epoch"] = self.epoch
                for s in targets:
                    if not comm.get(s.wid, (True, None))[0]:
                        self._kill(s, "rebind_commit_failed")
            return report
        finally:
            with self._lock:
                self._bind_acks = None

    # -- introspection -----------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def live_workers(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots
                       if s.state in (STARTING, READY))

    def ready_workers(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots if s.state == READY)

    def pids(self) -> Dict[int, Optional[int]]:
        with self._lock:
            return {s.wid: s.pid for s in self._slots
                    if s.state in (STARTING, READY)}

    def all_pids_ever(self) -> List[int]:
        """Every child pid this pool ever spawned (orphan audits)."""
        with self._lock:
            return list(self._all_pids)

    def shm_segments(self) -> List[str]:
        """Names of this pool's shm segments still present in /dev/shm
        — the shm half of the orphan audit: after close() (or a reap)
        this must be empty for the affected slots, exactly like
        `all_pids_ever` must be all-dead."""
        from nnstreamer_tpu_torch.serving.shm import RING_PREFIX, shm_safe

        marker = f"_{shm_safe(self._ring_tag)}_"
        try:
            return sorted(n for n in os.listdir("/dev/shm")
                          if n.startswith(RING_PREFIX) and marker in n
                          and n.endswith(f"_{os.getpid()}"))
        except OSError:
            return []

    def kill_worker(self, wid: Optional[int] = None,
                    sig: int = signal.SIGKILL) -> Optional[int]:
        """Chaos surface: signal one live worker (default SIGKILL,
        random-ish: the first live slot when wid is None). Returns the
        pid signalled, None when no live worker."""
        with self._lock:
            live = [s for s in self._slots
                    if s.state in (STARTING, READY) and s.pid]
            if not live:
                return None
            slot = live[0] if wid is None else next(
                (s for s in live if s.wid == wid), None)
            if slot is None:
                return None
            pid = slot.pid
        os.kill(pid, sig)
        return pid

    def stats(self) -> dict:
        now = time.monotonic()
        with self._lock:
            workers = [{
                "wid": s.wid,
                "pid": s.pid,
                "state": s.state,
                "inflight": len(s.inflight),
                "hb_age_ms": round(1e3 * s.hb_age_s(now), 1),
                "restarts": s.restarts,
                "kills": s.kills,
                "replied": s.replied,
                "bound_model": s.bound_model,
                "chips": list(s.chips),
                "shm": s.shm_ok,
                "device": s.device,
            } for s in self._slots]
            return {
                "pool": {
                    "workers": self.n_workers,
                    "live": sum(1 for s in self._slots
                                if s.state in (STARTING, READY)),
                    "ready": sum(1 for s in self._slots
                                 if s.state == READY),
                    "degraded": self.degraded,
                    "restarts": sum(s.restarts for s in self._slots),
                    "kills": sum(s.kills for s in self._slots),
                    "reoffered": self.reoffered,
                    "pending": len(self._pending),
                    "epoch": self.epoch,
                    "rebinds": self.rebinds,
                    "shm_frames": self.shm_frames,
                    "shm_bytes": self.shm_bytes,
                    "shm_fallbacks": self.shm_fallbacks,
                },
                "workers": workers,
                **({"chips": self.chip_table.snapshot()}
                   if self.chip_table is not None else {}),
            }

    def extra_stats(self) -> Dict[str, Any]:
        """Flat numeric view merged into serversrc extra_stats."""
        s = self.stats()
        out = {f"pool_{k}": v for k, v in s["pool"].items()}
        for w in s["workers"]:
            p = f"worker{w['wid']}_"
            out[p + "state"] = w["state"]
            out[p + "inflight"] = w["inflight"]
            out[p + "restarts"] = w["restarts"]
            out[p + "kills"] = w["kills"]
            out[p + "hb_age_ms"] = w["hb_age_ms"]
        return out

    # -- drain / close -----------------------------------------------------
    def close(self) -> None:
        """Graceful drain (module docstring): stop admitting, finish
        in-flight within the drain budget, BUSY the rest, stop the
        children, escalate to terminate/kill, leave no orphan.
        Idempotent — a supervisor drain racing a user close is a
        no-op, not a double-shed."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        # 1. stop admitting; queued-but-undispatched frames get a
        #    typed BUSY(shutdown) while the transport is still up
        for v in self.qs.frames.shed_remaining("shutdown"):
            if v is not None:
                self.qs.send_busy(v.meta.get("client_id"), v.pts,
                                  "shutdown")
        # 2. stop the router (it may be mid-dispatch; join it) and
        #    shed whatever it still held in hand
        self._stop_evt.set()
        self._dispatch_evt.set()
        if self._router is not None:
            self._router.join(timeout=5)
        with self._lock:
            undispatched = list(self._pending)
            self._pending.clear()
        for req in undispatched:
            self.qs.frames.note_failed("shutdown", cls=req.cls)
            self.qs.send_busy(req.client_id, req.pts, "shutdown")
        # 3. drain: in-flight frames keep completing through the live
        #    reader threads until the budget expires
        deadline = time.monotonic() + self.drain_timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not any(s.inflight for s in self._slots):
                    break
            time.sleep(0.02)
        # 4. whatever outlived the budget is shed — abandoning the rid
        #    first so a late result is ignored, never double-counted
        abandoned: List[_Request] = []
        with self._lock:
            for s in self._slots:
                abandoned.extend(s.inflight.values())
                s.inflight.clear()
        for req in abandoned:
            self.qs.frames.note_failed("shutdown", cls=req.cls)
            self.qs.send_busy(req.client_id, req.pts, "shutdown")
        # 5. stop the supervisor, then the children: graceful stop
        #    first, escalate terminate -> kill; join readers
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
        for slot in self._slots:
            with self._lock:
                if slot.state in (DEAD, DISABLED) or slot.proc is None:
                    continue
                slot.state = STOPPING
            try:
                with slot.send_lock:
                    slot.conn.send(("stop",))
            except (OSError, ValueError, BrokenPipeError):
                pass
        for slot in self._slots:
            proc = slot.proc
            if proc is None:
                continue
            proc.join(timeout=2)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=2)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5)
            try:
                if slot.conn is not None:
                    slot.conn.close()
            except OSError:
                pass
            if slot.reader is not None:
                slot.reader.join(timeout=2)
            self._drop_rings(slot)
            self._event(slot.wid, "drain_stop", pid=slot.pid)
        # 6. transport down last: every owed BUSY has been sent
        self.qs.pool = None
        self.qs.stop()


class PooledQueryServer:
    """A query server whose service plane is a supervised worker pool:
    the multi-process sibling of `BatchedQueryServer` (edge/query.py).
    Same wire contract (HELLO caps, DATA/RESULT/BUSY), same admission
    accounting — plus crash isolation, restart, and drain.

    ``PooledQueryServer.echo(workers=2, service_ms=5)`` builds the
    known-capacity form the traffic harness and the chaos tests use;
    pass a full `WorkerSpec` for real pipelines.
    """

    def __init__(self, spec: WorkerSpec, *, workers: int = 2,
                 sid: int = 0, host: str = "127.0.0.1", port: int = 0,
                 max_pending: int = 64, max_inflight: int = 0,
                 shed_policy: str = "reject-newest",
                 tenants=None,
                 tracer=None, ready_timeout_s: float = 30.0,
                 **pool_kwargs):
        self.qs = QueryServer.get(sid)
        self.sid = sid
        self.qs.in_spec = TensorsSpec.from_strings(spec.dims, spec.types)
        if spec.kind == "echo":
            self.qs.out_spec = self.qs.in_spec
        self.qs.frames.configure(max_pending=max_pending,
                                 max_inflight=max_inflight,
                                 shed_policy=shed_policy)
        # tenancy: one table drives all three layers — the WFQ
        # admission front, the pool's tenant→model dispatch routing,
        # and (for multiplex workers) the spec's child-side copy
        self.tenants = tenants
        if tenants is not None:
            self.qs.frames.set_tenants(tenants)
            if spec.kind == "multiplex" and not spec.tenants:
                import dataclasses

                spec = dataclasses.replace(
                    spec, tenants=tenants.to_dict())
        if tracer is not None:
            self.qs.tracer = tracer
        self.qs.start(host, port)
        self.pool = WorkerPool(self.qs, spec, workers, **pool_kwargs)
        if tenants is not None:
            self.pool.set_tenants(tenants)
        self.pool.start(ready_timeout_s=ready_timeout_s)
        self._sig_prev: Dict[int, Any] = {}

    @classmethod
    def echo(cls, *, workers: int = 2, service_ms: float = 5.0,
             dims: str = "8:1", types: str = "float32",
             **kwargs) -> "PooledQueryServer":
        return cls(WorkerSpec(kind="echo", service_ms=service_ms,
                              dims=dims, types=types),
                   workers=workers, **kwargs)

    @property
    def port(self) -> int:
        assert self.qs.server is not None
        return self.qs.server.port

    @property
    def capacity_rps(self) -> float:
        """Aggregate known capacity (echo mode only)."""
        if self.pool.spec.kind != "echo" or \
                self.pool.spec.service_ms <= 0:
            return float("inf")
        return self.pool.n_workers * 1e3 / self.pool.spec.service_ms

    def depth_probe(self) -> int:
        return self.qs.frames.depth

    def admission_counters(self) -> dict:
        return self.qs.frames.counters()

    def stats(self) -> dict:
        out = self.pool.stats()
        out["admission"] = self.qs.frames.counters()
        return out

    def swap(self, name: str, version=None, **kw) -> dict:
        return self.pool.swap(name, version, **kw)

    def rebind(self, mapping, **kw) -> dict:
        return self.pool.rebind(mapping, **kw)

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain (serve CLI): the contract a
        process manager expects from a serving edge."""
        def handler(signum, frame):
            log.info("signal %d: draining worker pool", signum)
            self.close()
            prev = self._sig_prev.get(signum)
            if callable(prev):
                prev(signum, frame)
        for signum in (signal.SIGTERM, signal.SIGINT):
            self._sig_prev[signum] = signal.signal(signum, handler)

    def close(self) -> None:
        self.pool.close()   # idempotent; also stops the QueryServer

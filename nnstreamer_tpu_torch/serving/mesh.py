"""Multi-host serving mesh: router tier + host agents over the query wire
(the JAX package's serving/mesh.py on the port: the same wire, so a port
router fronts JAX hosts and a port host joins a JAX router).

The worker pool's supervisor (serving/pool.py) proves every invariant we
need on ONE host — crash isolation, conservation-exact redelivery,
graceful drain. This module is the horizontal generalization (the
reference's "among-device AI" layer, arXiv 2101.06371): a `MeshRouter`
fronts N *remote* worker hosts, each an ordinary query server (a
`WorkerPool`, an `EchoServer`, any HELLO/DATA/RESULT/BUSY speaker)
bridged in by a `HostAgent`.

Control plane (edge/protocol.py types 10-14), riding the SAME TCP
connection as the data plane — deliberately, so a network partition
severs both at once and one liveness mechanism covers both:

- ``T_REGISTER``: the agent joins, advertising capacity, caps, zone,
  and resident ``store://`` versions. The ack carries the router's
  lease duration and epoch.
- ``T_LEASE``: heartbeat-renewed expiry. A *silent* host — not just a
  closed connection — is detected when its lease runs out, then
  **fenced**: its in-flight frames are re-offered to surviving hosts
  (``max_redeliver`` bound) or shed as ``BUSY(host_lost)``. Renewals
  carry the host's local admission counters, giving the router a
  mesh-wide conservation view (metrics per-host labels).
- ``T_SWAP``/``T_SWAP_ACK``: two-phase model swap broadcast with
  all-or-none epoch semantics; a host that acks prepare but misses
  commit is fenced, not left inconsistent (the pool's semantics across
  machines).

Routing extends least-outstanding with locality (model residency, then
zone match, then load normalized by advertised capacity) and
typed-BUSY-aware retry: a host's BUSY for an admitted frame re-routes
it to a *different* host before the client ever sees the rejection.

Conservation is the same two invariants the pool enforces, now summed
across hosts: ``offered == admitted + rejected`` and ``admitted ==
replied + shed + depth + inflight`` hold at the router, and every
router reply maps to exactly one host reply (`stats()["hosts"]`).

Correlation: the router rewrites each frame's pts to a router-unique
rid before forwarding and restores the original on reply, so the
`HostAgent` stays a stateless byte forwarder and a host-local BUSY
(which carries only pts) is unambiguous mesh-wide. Parent-side hops
(dispatch with the host name, reoffer) are merged into the reply's
trace context exactly like the pool does — a cross-host redelivered
frame keeps ONE trace_id whose timeline shows both hosts.

Tested by traffic/netchaos.py (deterministic delay/drop/duplicate/
blackhole/slow-close proxy) and `run_against_mesh` (traffic/loadgen.py):
blackhole one host mid-flood → zero lost, conserved, recovery within
the lease budget.

On the port a router's frames are host arrays (decoded from the wire),
so its pts=rid re-encode and its replies bring nothing from a device and
count no forced sync; a pool host's CUDA results come to the host in
its own process, at its query server's reply. A host's reply and busy
counters move under the router's lock with the request they settle, so
a re-registration carries them over whole.

`HostAgent` differs from the reference in its lifecycle (noted
difference N30): it rejoins once per lost router leg (the close of a leg
it replaced itself schedules nothing), never dials or registers after
`stop()`, and `stop()` joins its rejoin thread. The reference's agent
could rejoin twice after a heal and dial during teardown, which with the
proxy's own publish-before-start made a teardown fail with "cannot join
thread before it is started".
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.edge import protocol as P
from nnstreamer_tpu_torch.edge.query import QueryServer
from nnstreamer_tpu_torch.edge.wire import decode_buffer, encode_buffer, peek_pts
from nnstreamer_tpu_torch.runtime.tracing import get_trace_ctx
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

log = get_logger("serving.mesh")

READY = "READY"
FENCED = "FENCED"

#: meta key note — the router never stores a rid in meta: the pts
#: rewrite IS the correlation (see module docstring), so a pool-backed
#: host's own RID_META cannot collide with the mesh layer.


class _MeshRequest:
    """One admitted frame in flight somewhere in the mesh. Mirrors
    pool._Request: carries the re-encoded payload (pts=rid) so a
    re-offer after a host fence needs no surviving TensorBuffer."""

    __slots__ = ("rid", "client_id", "pts", "payload", "model",
                 "attempts", "busy_hosts", "t_sent", "traced", "hops")

    def __init__(self, rid: int, client_id, pts, payload: bytes,
                 model: Optional[str] = None, traced: bool = False):
        self.rid = rid
        self.client_id = client_id
        self.pts = pts
        self.payload = payload
        self.model = model
        self.attempts = 0             # deliveries so far
        self.busy_hosts: set = set()  # hosts that BUSYed this frame
        self.t_sent = 0.0
        self.traced = traced
        # parent-side hop records (dispatch/reoffer) merged into the
        # reply's trace context — the payload is already-encoded bytes
        # here, and a fenced host's own stamps are unreachable; the
        # router's dispatch record carries the host name instead
        self.hops: List[dict] = []

    def hop(self, name: str, **extra) -> None:
        if self.traced:
            rec = {"hop": name, "t": time.perf_counter(),
                   "pid": os.getpid()}
            rec.update(extra)
            self.hops.append(rec)


class _Host:
    """One registered worker host as the router sees it."""

    def __init__(self, name: str, conn: P.Connection, ad: dict,
                 window: int):
        self.name = name
        self.conn = conn
        self.capacity_rps = float(ad.get("capacity_rps") or 0.0)
        self.zone = str(ad.get("zone") or "")
        self.versions: Dict[str, list] = dict(ad.get("versions") or {})
        self.window = window
        self.state = READY
        self.outstanding: Dict[int, _MeshRequest] = {}
        now = time.monotonic()
        self.registered_t = now
        self.lease_deadline = now     # set by the router on register
        self.fence_cause: Optional[str] = None
        self.replied = 0
        self.busies = 0
        self.remote: Dict[str, Any] = {}   # lease-carried counters


class MeshRouter:
    """Router tier fronting N registered hosts (module docstring).

    The client plane is a plain `QueryServer` — same HELLO/DATA wire,
    same bounded admission — whose transport this router owns so the
    mesh control types (REGISTER/LEASE/SWAP) share the port.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 sid: int = 0,
                 dims: str = "", types: str = "",
                 max_pending: int = 64, max_inflight: int = 0,
                 shed_policy: str = "reject-newest",
                 lease_s: float = 2.0,
                 max_redeliver: int = 1,
                 busy_retry: int = 2,
                 per_host_window: int = 32,
                 send_timeout_s: float = 5.0,
                 frame_deadline_s: float = 30.0,
                 zone: str = "",
                 tracer=None,
                 tenants=None,
                 name: str = "mesh"):
        self.name = name
        self.zone = zone
        self.lease_s = float(lease_s)
        self.max_redeliver = max(0, max_redeliver)
        self.busy_retry = max(0, busy_retry)
        self.per_host_window = max(1, per_host_window)
        self.send_timeout_s = send_timeout_s
        self.frame_deadline_s = frame_deadline_s
        self.qs = QueryServer.get(sid)
        self.sid = sid
        if dims:
            self.qs.in_spec = TensorsSpec.from_strings(dims, types)
        self.qs.frames.configure(max_pending=max_pending,
                                 max_inflight=max_inflight,
                                 shed_policy=shed_policy)
        if tenants is not None:
            self.set_tenants(tenants)
        if tracer is not None:
            self.qs.tracer = tracer
        self._lock = threading.RLock()
        self._hosts: Dict[str, _Host] = {}
        self._conn_hosts: Dict[int, _Host] = {}
        self._pending: Deque[_MeshRequest] = deque()
        self._dispatch_evt = threading.Event()
        self._stop_evt = threading.Event()
        self._closed = False
        self._close_lock = threading.Lock()
        self._next_rid = 0
        self._swap_acks = None
        self.epoch = 0                # bumps on every committed swap
        self.reoffered = 0
        self.busy_reroutes = 0
        self.stale_results = 0
        #: (monotonic t, host name, kind, detail) — fence/register
        #: timeline; `run_against_mesh` derives detection latency here
        self.events: List[tuple] = []
        # the mesh control types share the query wire: this router owns
        # the transport and lends it to the QueryServer client plane
        self.server = P.MsgServer(host, port,
                                  on_message=self._on_message,
                                  on_disconnect=self._on_disconnect)
        self.qs.server = self.server
        self._router = threading.Thread(
            target=self._route_loop, name=f"{name}-router", daemon=True)
        self._router.start()
        self._supervisor = threading.Thread(
            target=self._lease_loop, name=f"{name}-leases", daemon=True)
        self._supervisor.start()

    @property
    def port(self) -> int:
        return self.server.port

    # -- message plane -----------------------------------------------------
    def _on_message(self, conn: P.Connection, mtype: int,
                    payload: bytes) -> None:
        if mtype == P.T_REGISTER:
            self._on_register(conn, payload)
            return
        with self._lock:
            host = self._conn_hosts.get(conn.client_id)
        if host is not None:
            if mtype == P.T_LEASE:
                self._on_lease(host, payload)
            elif mtype == P.T_RESULT:
                self._on_host_result(host, payload)
            elif mtype == P.T_BUSY:
                self._on_host_busy(host, payload)
            elif mtype == P.T_SWAP_ACK:
                self._on_swap_ack(host, payload)
            return
        # client plane: HELLO handshake + DATA admission
        self.qs._on_message(conn, mtype, payload)

    def _on_disconnect(self, conn: P.Connection) -> None:
        with self._lock:
            host = self._conn_hosts.get(conn.client_id)
        if host is not None:
            self._fence(host, "conn_lost")

    # -- registration + leases ---------------------------------------------
    def _on_register(self, conn: P.Connection, payload: bytes) -> None:
        def nak(err: str) -> None:
            try:
                conn.send(P.T_REGISTER_ACK,
                          json.dumps({"ok": False, "error": err}).encode(),
                          timeout=self.send_timeout_s)
            except OSError:
                pass

        try:
            ad = json.loads(payload.decode())
            hname = str(ad["name"])
        except (ValueError, KeyError) as e:
            nak(f"bad register ad: {e}")
            return
        host_in = None
        if ad.get("dims"):
            try:
                host_in = TensorsSpec.from_strings(
                    ad["dims"], ad.get("types", ""))
            except ValueError as e:
                nak(f"bad caps in register ad: {e}")
                return
        with self._lock:
            if self.qs.in_spec is not None and host_in is not None and \
                    not self.qs.in_spec.is_compatible(host_in):
                pass_caps = False
            else:
                pass_caps = True
        if not pass_caps:
            nak("incompatible caps: host serves a different stream "
                "than this mesh routes")
            return
        with self._lock:
            old = self._hosts.get(hname)
        if old is not None and old.state == READY and old.conn is not conn:
            # a re-registration replaces the old incarnation: fence it
            # first so its in-flight frames are re-offered, not leaked
            self._fence(old, "re_registered")
        host = _Host(hname, conn, ad, self.per_host_window)
        host.lease_deadline = time.monotonic() + self.lease_s
        with self._lock:
            if old is not None:
                # per-host counters are monotone across incarnations: a
                # rejoining host keeps its totals, so the cross-host
                # conservation sum (Σ replied == router replied)
                # survives a fence + rejoin cycle
                host.replied = old.replied
                host.busies = old.busies
            if self.qs.in_spec is None and host_in is not None:
                self.qs.in_spec = host_in
            if self.qs.out_spec is None and ad.get("out_dims"):
                try:
                    self.qs.out_spec = TensorsSpec.from_strings(
                        ad["out_dims"], ad.get("out_types", ""))
                except ValueError:
                    pass
            self._hosts[hname] = host
            self._conn_hosts[conn.client_id] = host
        self.events.append((time.monotonic(), hname, "register", ""))
        log.info("mesh %s: host %s registered (capacity %.1f rps, "
                 "zone %r, %d model(s))", self.name, hname,
                 host.capacity_rps, host.zone, len(host.versions))
        try:
            conn.send(P.T_REGISTER_ACK, json.dumps({
                "ok": True, "name": hname, "lease_s": self.lease_s,
                "epoch": self.epoch}).encode(),
                timeout=self.send_timeout_s)
        except OSError:
            self._fence(host, "register_ack_failed")
            return
        self._dispatch_evt.set()

    def _on_lease(self, host: _Host, payload: bytes) -> None:
        try:
            body = json.loads(payload.decode()) if payload else {}
        except ValueError:
            body = {}
        with self._lock:
            if host.state != READY:
                ok = False
            else:
                ok = True
                host.lease_deadline = time.monotonic() + self.lease_s
                counters = body.get("counters")
                if isinstance(counters, dict):
                    host.remote = counters
        try:
            host.conn.send(P.T_LEASE, json.dumps(
                {"ok": ok, "epoch": self.epoch}).encode(),
                timeout=self.send_timeout_s)
        except OSError:
            self._fence(host, "lease_ack_failed")

    # -- host replies ------------------------------------------------------
    def _on_host_result(self, host: _Host, payload: bytes) -> None:
        rid = peek_pts(payload)
        if rid is None:
            log.warning("mesh %s: host %s returned an uncorrelatable "
                        "frame", self.name, host.name)
            return
        with self._lock:
            req = host.outstanding.pop(rid, None)
            if req is None:
                # already re-offered after a fence / shed at close — the
                # admission accounting closed this request elsewhere
                self.stale_results += 1
                return
            host.replied += 1
        try:
            buf, _ = decode_buffer(payload)
        except ValueError as e:
            log.warning("mesh %s: host %s returned a corrupt frame for "
                        "pts=%s: %s", self.name, host.name, req.pts, e)
            self.qs.frames.note_failed("host_error")
            self.qs.send_busy(req.client_id, req.pts, "host_error")
            return
        if req.hops:
            # merge the router-side hops (dispatch/reoffer) into the
            # reply's trace context, in time order: one timeline per
            # trace_id even across a cross-host redelivery
            ctx = get_trace_ctx(buf.meta)
            if ctx is not None:
                ctx["hops"].extend(req.hops)
                ctx["hops"].sort(
                    key=lambda h: h.get("t", 0.0)
                    if isinstance(h, dict) else 0.0)
        self.qs.reply(int(req.client_id),
                      buf.with_tensors(buf.tensors, pts=req.pts))
        self._dispatch_evt.set()

    def _on_host_busy(self, host: _Host, payload: bytes) -> None:
        """A host refused an admitted frame (its local admission bound,
        or its agent's forward failed). Retry on a DIFFERENT host while
        one exists; only then surface the rejection to the client."""
        try:
            body = json.loads(payload.decode())
            rid = int(body["pts"])
        except (ValueError, KeyError, TypeError):
            log.warning("mesh %s: uncorrelatable BUSY from host %s",
                        self.name, host.name)
            return
        cause = str(body.get("cause") or "busy")
        with self._lock:
            req = host.outstanding.pop(rid, None)
            if req is None:
                return
            host.busies += 1
            req.busy_hosts.add(host.name)
            alternative = any(
                h.state == READY and h.name not in req.busy_hosts
                for h in self._hosts.values())
            retry = alternative and \
                len(req.busy_hosts) <= self.busy_retry and \
                not self._stop_evt.is_set()
            if retry:
                self.busy_reroutes += 1
                self._pending.appendleft(req)
        if retry:
            req.hop("reoffer", host=host.name, cause=f"host_busy:{cause}",
                    attempt=req.attempts)
            self._dispatch_evt.set()
            return
        self.qs.frames.note_failed("host_busy")
        self.qs.send_busy(req.client_id, req.pts, f"host_busy:{cause}")
        self._dispatch_evt.set()

    def _on_swap_ack(self, host: _Host, payload: bytes) -> None:
        try:
            body = json.loads(payload.decode())
        except ValueError:
            return
        with self._lock:
            acks = self._swap_acks
        if acks is not None:
            acks.put((host.name, body.get("phase"),
                      bool(body.get("ok")), body.get("error")))

    # -- routing -----------------------------------------------------------
    def _route_loop(self) -> None:
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
                self._dispatch_evt.wait(0.05)
                self._dispatch_evt.clear()

    def _admit(self, buf) -> _MeshRequest:
        with self._lock:
            self._next_rid += 1
            rid = self._next_rid
        client_id = buf.meta.pop("client_id", None)
        model = buf.meta.get("model")
        # pts := rid before encoding — the correlation id every host
        # echoes back (results and BUSYs both), restored on reply
        wire = encode_buffer(buf.with_tensors(buf.tensors, pts=rid))
        return _MeshRequest(
            rid, client_id, buf.pts, wire,
            model=model if isinstance(model, str) else None,
            traced=get_trace_ctx(buf.meta) is not None)

    def _host_key(self, h: _Host, req: _MeshRequest):
        """Routing preference: model residency, then zone locality,
        then least-outstanding normalized by advertised capacity."""
        resident = 0 if (req.model and req.model in h.versions) else 1
        local = 0 if (self.zone and h.zone == self.zone) else 1
        weight = h.capacity_rps if h.capacity_rps > 0 else 1.0
        return (resident, local, len(h.outstanding) / weight, h.name)

    def _dispatch(self, req: _MeshRequest) -> bool:
        with self._lock:
            ready = [h for h in self._hosts.values()
                     if h.state == READY
                     and len(h.outstanding) < h.window]
            candidates = [h for h in ready
                          if h.name not in req.busy_hosts]
            if not candidates:
                # every roomy host already BUSYed this frame: retrying
                # one beats stalling the router forever
                candidates = ready
            if not candidates:
                return False
            host = min(candidates, key=lambda h: self._host_key(h, req))
            req.attempts += 1
            req.t_sent = time.monotonic()
            host.outstanding[req.rid] = req
        req.hop("dispatch", host=host.name, attempt=req.attempts)
        try:
            host.conn.send(P.T_DATA, req.payload,
                           timeout=self.send_timeout_s)
        except OSError:
            # host gone between pick and send: undo, fence, re-offer
            # through the normal path
            with self._lock:
                host.outstanding.pop(req.rid, None)
                req.attempts -= 1
            if req.hops:
                req.hops.pop()
            self._fence(host, "send_failed")
            return False
        return True

    # -- liveness ----------------------------------------------------------
    def _lease_loop(self) -> None:
        poll = max(0.02, min(0.25, self.lease_s / 4.0))
        while not self._stop_evt.wait(poll):
            now = time.monotonic()
            with self._lock:
                hosts = list(self._hosts.values())
            for h in hosts:
                with self._lock:
                    if h.state != READY:
                        continue
                    expired = now > h.lease_deadline
                    oldest = min((r.t_sent
                                  for r in h.outstanding.values()),
                                 default=None)
                if expired:
                    self._fence(h, "lease_expired")
                elif oldest is not None and \
                        now - oldest > self.frame_deadline_s:
                    # a renewing lease with wedged frames: the host is
                    # alive but not serving — fence it anyway (remote
                    # sibling of the pool's frame-deadline kill)
                    self._fence(h, "frame_deadline")

    def _fence(self, host: _Host, cause: str) -> None:
        """Cut a host out of the mesh and settle its in-flight frames:
        re-offer (≤ max_redeliver, while another host could serve) or
        shed as BUSY(host_lost). Conservation holds exactly through the
        fence — nothing ends neither-replied-nor-rejected."""
        with self._lock:
            if host.state != READY:
                return
            host.state = FENCED
            host.fence_cause = cause
            orphans = list(host.outstanding.values())
            host.outstanding.clear()
            self._conn_hosts.pop(host.conn.client_id, None)
            live_possible = any(h.state == READY
                                for h in self._hosts.values())
        self.events.append((time.monotonic(), host.name, "fence", cause))
        log.warning("mesh %s: fencing host %s (%s), %d frame(s) "
                    "in flight", self.name, host.name, cause,
                    len(orphans))
        try:
            host.conn.close()
        except OSError:
            pass
        for req in orphans:
            if req.attempts <= self.max_redeliver and live_possible \
                    and not self._stop_evt.is_set():
                # re-offer: still `inflight` in admission accounting —
                # nothing changes until it is replied or shed
                req.hop("reoffer", host=host.name, cause=cause,
                        attempt=req.attempts)
                with self._lock:
                    self._pending.appendleft(req)
                    self.reoffered += 1
            else:
                self.qs.frames.note_failed("host_lost")
                self.qs.send_busy(req.client_id, req.pts, "host_lost")
        self._dispatch_evt.set()

    # -- swap --------------------------------------------------------------
    def swap(self, name: str, version=None,
             timeout_s: float = 30.0) -> dict:
        """Two-phase model swap across every ready host. All-or-none:
        any prepare failure aborts everywhere and the mesh epoch does
        not move; a host that acked prepare but failed commit is FENCED
        (its frames re-offered) rather than left serving a version its
        siblings do not."""
        import queue as _queue

        with self._lock:
            targets = [h for h in self._hosts.values()
                       if h.state == READY]
            if not targets:
                return {"ok": False, "error": "no ready hosts",
                        "epoch": self.epoch}
            acks: "_queue.Queue" = _queue.Queue()
            self._swap_acks = acks

        def phase(ph: str, hosts) -> Dict[str, tuple]:
            got: Dict[str, tuple] = {}
            body = json.dumps({"phase": ph, "model": name,
                               "version": version,
                               "epoch": self.epoch}).encode()
            for h in hosts:
                try:
                    h.conn.send(P.T_SWAP, body,
                                timeout=self.send_timeout_s)
                except OSError:
                    got[h.name] = (False, "host died mid-swap")
            deadline = time.monotonic() + timeout_s
            while len(got) < len(hosts):
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                try:
                    hname, ph_got, ok, err = acks.get(timeout=remain)
                except _queue.Empty:
                    break
                if ph_got == ph:
                    got[hname] = (ok, err)
            for h in hosts:
                got.setdefault(h.name, (False, f"no {ph} ack"))
            return got

        try:
            prep = phase("prepare", targets)
            report = {"name": name, "version": version,
                      "hosts": {h: {"prepare_ok": ok, "error": err}
                                for h, (ok, err) in prep.items()}}
            if not all(ok for ok, _ in prep.values()):
                phase("abort", targets)
                report["ok"] = False
                report["epoch"] = self.epoch
                return report
            comm = phase("commit", targets)
            for h, (ok, err) in comm.items():
                report["hosts"][h]["commit_ok"] = ok
                if err:
                    report["hosts"][h]["error"] = err
            report["ok"] = all(ok for ok, _ in comm.values())
            if report["ok"]:
                with self._lock:
                    self.epoch += 1
                    for h in targets:
                        vs = h.versions.setdefault(name, [])
                        if version is not None and version not in vs:
                            vs.append(version)
                report["epoch"] = self.epoch
            else:
                report["epoch"] = self.epoch
                for h in targets:
                    if not comm.get(h.name, (True, None))[0]:
                        self._fence(h, "swap_commit_failed")
            return report
        finally:
            with self._lock:
                self._swap_acks = None

    # -- introspection -----------------------------------------------------
    def wait_hosts(self, n: int, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.ready_hosts() >= n:
                return True
            time.sleep(0.01)
        return False

    def ready_hosts(self) -> int:
        with self._lock:
            return sum(1 for h in self._hosts.values()
                       if h.state == READY)

    def depth_probe(self) -> int:
        return self.qs.frames.depth

    def set_tenants(self, table) -> None:
        """Install (or clear, with None) a weighted-fair `TenantTable`
        on the router's admission queue — the mesh twin of
        `PooledQueryServer(tenants=...)`. The class resolved at offer
        rides the frame's meta through the host round-trip (workers
        echo meta), so the reply settles against the right class and
        the per-class conservation books close across hosts."""
        self.qs.frames.set_tenants(table)

    def admission_counters(self) -> dict:
        return self.qs.frames.counters()

    def stats(self) -> dict:
        now = time.monotonic()
        with self._lock:
            hosts = [{
                "host": h.name,
                "state": h.state,
                "zone": h.zone,
                "capacity_rps": h.capacity_rps,
                "outstanding": len(h.outstanding),
                "replied": h.replied,
                "busies": h.busies,
                "lease_age_ms": round(1e3 * max(
                    0.0, now - (h.lease_deadline - self.lease_s)), 1),
                "fence_cause": h.fence_cause,
                "versions": dict(h.versions),
                "remote": dict(h.remote),
            } for h in self._hosts.values()]
            mesh = {
                "hosts": len(self._hosts),
                "ready": sum(1 for h in self._hosts.values()
                             if h.state == READY),
                "fenced": sum(1 for h in self._hosts.values()
                              if h.state == FENCED),
                "epoch": self.epoch,
                "reoffered": self.reoffered,
                "busy_reroutes": self.busy_reroutes,
                "stale_results": self.stale_results,
                "pending": len(self._pending),
                "lease_s": self.lease_s,
            }
        return {"mesh": mesh, "hosts": hosts,
                "admission": self.qs.frames.counters()}

    # -- drain / close -----------------------------------------------------
    def close(self) -> None:
        """Graceful drain, mirroring WorkerPool.close: stop admitting,
        BUSY the undispatched, settle in-flight against live hosts
        within a short budget, shed the rest, then transport down."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        for v in self.qs.frames.shed_remaining("shutdown"):
            if v is not None:
                self.qs.send_busy(v.meta.get("client_id"), v.pts,
                                  "shutdown")
        self._stop_evt.set()
        self._dispatch_evt.set()
        if self._router is not None:
            self._router.join(timeout=5)
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
        with self._lock:
            undispatched = list(self._pending)
            self._pending.clear()
        for req in undispatched:
            self.qs.frames.note_failed("shutdown")
            self.qs.send_busy(req.client_id, req.pts, "shutdown")
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            with self._lock:
                if not any(h.outstanding for h in self._hosts.values()):
                    break
            time.sleep(0.02)
        abandoned: List[_MeshRequest] = []
        with self._lock:
            for h in self._hosts.values():
                abandoned.extend(h.outstanding.values())
                h.outstanding.clear()
        for req in abandoned:
            self.qs.frames.note_failed("shutdown")
            self.qs.send_busy(req.client_id, req.pts, "shutdown")
        self.qs.stop()   # also closes self.server (shared transport)


class HostAgent:
    """Bridges one local query server into a mesh: dials the router,
    REGISTERs, keeps the lease alive, and forwards frames byte-for-byte
    (the router's pts=rid rewrite keeps this layer stateless). The
    registration connection IS the data channel — a partition severs
    both, so lease expiry is the single liveness truth.
    """

    def __init__(self, router_host: str, router_port: int, *,
                 name: str,
                 local_port: int,
                 local_host: str = "127.0.0.1",
                 dims: str, types: str,
                 capacity_rps: float = 0.0,
                 zone: str = "",
                 versions: Optional[Dict[str, list]] = None,
                 counters_fn: Optional[Callable[[], dict]] = None,
                 on_swap: Optional[Callable] = None,
                 connect_timeout_s: Optional[float] = None,
                 reconnect: bool = True,
                 reconnect_backoff_s: float = 0.2,
                 reconnect_backoff_max_s: float = 2.0):
        self.name = name
        self.router_host, self.router_port = router_host, router_port
        self.local_host, self.local_port = local_host, local_port
        self.dims, self.types = dims, types
        self.capacity_rps = capacity_rps
        self.zone = zone
        self.versions = dict(versions or {})
        self.counters_fn = counters_fn
        self.on_swap = on_swap
        self.connect_timeout_s = connect_timeout_s
        self.reconnect = reconnect
        self.reconnect_backoff_s = reconnect_backoff_s
        self.reconnect_backoff_max_s = reconnect_backoff_max_s
        self.lease_s = 2.0            # overwritten by REGISTER_ACK
        self.out_dims = ""
        self.out_types = ""
        self.registered = threading.Event()
        self._hello_ok = threading.Event()
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()
        self._local: Optional[P.MsgClient] = None
        self._router: Optional[P.MsgClient] = None
        self._lease_thread: Optional[threading.Thread] = None
        self._reconnector: Optional[threading.Thread] = None
        self.forwarded = 0
        self.forward_failures = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self, timeout_s: float = 10.0) -> "HostAgent":
        try:
            self._connect()
        except StreamError:
            self.stop()
            raise
        if not self.registered.wait(timeout_s):
            self.stop()
            raise StreamError(
                f"host agent {self.name}: no REGISTER_ACK from "
                f"{self.router_host}:{self.router_port} within "
                f"{timeout_s}s")
        t = threading.Thread(
            target=self._lease_loop, name=f"mesh-agent-{self.name}",
            daemon=True)
        with self._lock:
            if self._stop_evt.is_set():
                return self
            # published only once started: stop() joins what it sees
            t.start()
            self._lease_thread = t
        return self

    def _dial(self, host: str, port: int, on_message) -> P.MsgClient:
        """One leg; its close schedules a rejoin only while it is still
        one of the agent's current legs."""
        legs: List[P.MsgClient] = []
        client = P.MsgClient(
            host, port, on_message=on_message,
            on_close=lambda: self._leg_closed(legs[0] if legs else None),
            connect_timeout=self.connect_timeout_s)
        legs.append(client)
        return client

    def _connect(self) -> None:
        """Dial local backend then router, HELLO + REGISTER. Raises on
        hard failure (caller or reconnect loop handles retry)."""
        local = self._dial(self.local_host, self.local_port,
                           self._on_local)
        self._hello_ok.clear()
        local.send(P.T_HELLO, json.dumps(
            {"dims": self.dims, "types": self.types}).encode())
        if not self._hello_ok.wait(5.0):
            local.close()
            raise StreamError(
                f"host agent {self.name}: local server "
                f"{self.local_host}:{self.local_port} rejected HELLO")
        try:
            router = self._dial(self.router_host, self.router_port,
                                self._on_router)
        except StreamError:
            local.close()
            raise
        with self._lock:
            stopped = self._stop_evt.is_set()
            if not stopped:
                old_local, self._local = self._local, local
                old_router, self._router = self._router, router
        if stopped:
            for c in (router, local):
                c.close()
            raise StreamError(f"host agent {self.name}: stopped")
        for old in (old_local, old_router):
            if old is not None and old.alive:
                old.close()
        self._send_register()
        if not (local.alive and router.alive):
            # a leg died before it was current: its close scheduled
            # nothing, so the caller's retry owns it
            raise StreamError(
                f"host agent {self.name}: a leg closed while joining")

    def _send_register(self) -> None:
        self.registered.clear()
        ad = {"name": self.name, "capacity_rps": self.capacity_rps,
              "dims": self.dims, "types": self.types,
              "out_dims": self.out_dims, "out_types": self.out_types,
              "zone": self.zone, "versions": self.versions}
        with self._lock:
            router = self._router
        if router is None:
            raise StreamError(f"host agent {self.name}: stopped")
        router.send(P.T_REGISTER, json.dumps(ad).encode())

    def _leg_closed(self, client: Optional[P.MsgClient]) -> None:
        with self._lock:
            current = client is not None and \
                client in (self._local, self._router)
        if current:
            self._schedule_reconnect()

    def _schedule_reconnect(self) -> None:
        """Either leg dropped: tear down and (optionally) rejoin. The
        router side fences us on its own — this loop is how a healed
        partition turns back into a READY host."""
        if self._stop_evt.is_set() or not self.reconnect:
            return
        with self._lock:
            if self._stop_evt.is_set() or (
                    self._reconnector is not None
                    and self._reconnector.is_alive()):
                return
            self._reconnector = threading.Thread(
                target=self._reconnect_loop,
                name=f"mesh-agent-{self.name}-rejoin", daemon=True)
            self._reconnector.start()

    def _reconnect_loop(self) -> None:
        backoff = self.reconnect_backoff_s
        while not self._stop_evt.wait(backoff):
            backoff = min(backoff * 2, self.reconnect_backoff_max_s)
            try:
                self._connect()
                return
            except StreamError as e:
                log.info("host agent %s: rejoin attempt failed: %s",
                         self.name, e)

    # -- router-side messages ----------------------------------------------
    def _on_router(self, mtype: int, payload: bytes) -> None:
        if mtype == P.T_DATA:
            with self._lock:
                local = self._local
            try:
                if local is None:
                    raise StreamError("no local backend")
                local.send(P.T_DATA, payload)
                self.forwarded += 1
            except StreamError:
                self.forward_failures += 1
                self._busy_router(peek_pts(payload),
                                  "host_forward_failed")
        elif mtype == P.T_REGISTER_ACK:
            try:
                body = json.loads(payload.decode())
            except ValueError:
                return
            if body.get("ok"):
                self.lease_s = float(body.get("lease_s") or self.lease_s)
                self.registered.set()
            else:
                log.error("host agent %s: registration refused: %s",
                          self.name, body.get("error"))
        elif mtype == P.T_LEASE:
            try:
                body = json.loads(payload.decode())
            except ValueError:
                return
            if not body.get("ok"):
                # the router no longer knows us (fenced while the TCP
                # connection survived): re-register on this connection
                try:
                    self._send_register()
                except StreamError:
                    pass
        elif mtype == P.T_SWAP:
            self._handle_swap(payload)

    def _busy_router(self, rid: Optional[int], cause: str) -> None:
        with self._lock:
            router = self._router
        if router is None or rid is None:
            return
        try:
            router.send(P.T_BUSY, json.dumps(
                {"pts": rid, "cause": cause, "queue_depth": 0,
                 "retry_after_ms": 250.0}).encode())
        except StreamError:
            pass

    def _handle_swap(self, payload: bytes) -> None:
        try:
            body = json.loads(payload.decode())
            phase = body["phase"]
        except (ValueError, KeyError):
            return
        model, version = body.get("model"), body.get("version")
        ok, err = True, None
        if self.on_swap is not None:
            try:
                res = self.on_swap(phase, model, version)
                if isinstance(res, tuple):
                    ok, err = bool(res[0]), res[1]
                else:
                    ok = bool(res)
            except Exception as e:        # noqa: BLE001 — ack the error
                ok, err = False, f"{type(e).__name__}: {e}"
        if ok and phase == "commit" and version is not None:
            self.versions.setdefault(str(model), [])
            if version not in self.versions[str(model)]:
                self.versions[str(model)].append(version)
        with self._lock:
            router = self._router
        if router is None:
            return
        try:
            router.send(P.T_SWAP_ACK, json.dumps(
                {"phase": phase, "ok": ok, "error": err,
                 "name": self.name}).encode())
        except StreamError:
            pass

    # -- local-side messages -----------------------------------------------
    def _on_local(self, mtype: int, payload: bytes) -> None:
        if mtype in (P.T_RESULT, P.T_BUSY):
            with self._lock:
                router = self._router
            if router is None:
                return
            try:
                router.send(mtype, payload)
            except StreamError:
                pass                  # router gone: reconnect loop owns it
        elif mtype == P.T_HELLO_ACK:
            try:
                body = json.loads(payload.decode())
                self.out_dims = body.get("dims", "")
                self.out_types = body.get("types", "")
            except ValueError:
                pass
            self._hello_ok.set()
        elif mtype == P.T_HELLO_NAK:
            log.error("host agent %s: local server refused HELLO: %s",
                      self.name, payload.decode(errors="replace"))

    # -- lease loop --------------------------------------------------------
    def _lease_loop(self) -> None:
        """Renew at 3x the expiry rate — two consecutive losses still
        leave slack before the router fences us."""
        while not self._stop_evt.wait(max(0.05, self.lease_s / 3.0)):
            with self._lock:
                router = self._router
            if router is None or not router.alive:
                continue              # reconnect loop owns recovery
            body: Dict[str, Any] = {"name": self.name}
            if self.counters_fn is not None:
                try:
                    body["counters"] = self.counters_fn()
                except Exception:     # noqa: BLE001 — lease must not die
                    pass
            try:
                router.send(P.T_LEASE, json.dumps(body).encode())
            except StreamError:
                continue              # on_close schedules the rejoin

    def stop(self) -> None:
        with self._lock:
            self._stop_evt.set()
            lease, rejoin = self._lease_thread, self._reconnector
        for t in (lease, rejoin):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=5)
        with self._lock:
            local, self._local = self._local, None
            router, self._router = self._router, None
        for c in (router, local):
            if c is not None:
                c.close()


def pool_join(pqs, router_host: str, router_port: int, *,
              name: str, zone: str = "", **kw) -> HostAgent:
    """Join a `PooledQueryServer` to a mesh: the `serve --join` path.
    Wires the agent's ad (caps, capacity, resident versions), its lease
    counters, and a two-phase swap handler that defers the real work to
    the pool's own prepare/commit broadcast at mesh commit time — a
    commit failure then fences this host, which is exactly the
    "prepared but inconsistent" contract."""
    def on_swap(phase, model, version):
        if phase != "commit":
            return True               # validation happens pool-side
        rep = pqs.swap(model, version)
        return bool(rep.get("ok")), rep.get("error")

    spec = pqs.pool.spec
    cap = pqs.capacity_rps
    return HostAgent(
        router_host, router_port,
        name=name,
        local_port=pqs.port,
        dims=spec.dims, types=spec.types,
        capacity_rps=0.0 if cap == float("inf") else cap,
        zone=zone,
        versions=pqs.pool.resident_versions(),
        counters_fn=pqs.admission_counters,
        on_swap=on_swap,
        **kw).start()

"""Deterministic network fault injection for the query wire (the JAX
package's traffic/netchaos.py on the port: the same fault schedule for
the same seed and message sequence).

`ChaosProxy` sits between a dialing peer (a mesh `HostAgent`, a query
client) and an upstream listener (a `MeshRouter`, any `MsgServer`),
relaying whole protocol messages — it parses the ``u32 type | u32 len``
framing rather than raw bytes, so injected faults corrupt *delivery*,
never *framing* (a dropped frame is a lost message, not a desynced
stream the receiver misparses forever).

Fault model:

- ``delay_ms`` / ``jitter_ms`` — per-message latency, applied in-line
  per direction so ordering within a direction is preserved (a slow
  link, not a reordering one).
- ``drop_p`` / ``dup_p`` — per-message loss / duplication.
- ``blackhole()`` / ``heal()`` — a silent partition: both directions
  keep READING and discard (no TCP backpressure, no FIN — exactly the
  failure a lease, not a connection event, must detect). A peer's
  close during the blackhole is withheld from the other side, as a
  real partition would; ``heal()`` drops the poisoned connections so
  the dialing side's reconnect logic rejoins cleanly.
- ``slow_close(linger_s)`` — the anti-blackhole: stop *reading* while
  keeping the connection open, so the sender's kernel buffer fills and
  unbounded ``sendall`` calls wedge (what `Connection.send(timeout=)`
  exists to survive); after the linger everything closes.
- ``program(events)`` — the switches above applied on a schedule
  relative to one clock instant, so a scenario executor (rather than
  ad-hoc caller sleeps) owns WHEN faults land; applied events are
  logged for fence math and replay audits.

Determinism: every per-message decision comes from `random.Random`
streams seeded from (seed, connection index, direction) — same seed,
same traffic, same faults, byte for byte. Handshake types (HELLO,
REGISTER and their acks) are spared from drop/dup by default so a
lossy link still lets peers join; pass ``spare_types=()`` to drop
those too.

Lifecycle: a route's pump threads are started before the route is
published, `close()` stops the accept loop before it closes and joins
the routes, and no route is opened once closing began — so a peer that
dials while the proxy closes gets a refused or closed connection, never
a thread that cannot be joined (noted difference N30).
"""

from __future__ import annotations

import random
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.edge import protocol as P

log = get_logger("traffic.netchaos")

#: handshake types spared from drop/dup by default (joins survive a
#: lossy link; data-plane loss is what the mesh must absorb)
DEFAULT_SPARE_TYPES = (P.T_HELLO, P.T_HELLO_ACK, P.T_HELLO_NAK,
                       P.T_REGISTER, P.T_REGISTER_ACK)


class _Route:
    """One proxied connection: the accepted downstream socket and its
    upstream dial, plus the two pump threads."""

    def __init__(self, idx: int, down: socket.socket,
                 up: socket.socket):
        self.idx = idx
        self.down = down
        self.up = up
        self.threads: List[threading.Thread] = []
        self.closed = threading.Event()

    def close(self) -> None:
        if self.closed.is_set():
            return
        self.closed.set()
        for s in (self.down, self.up):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class ChaosProxy:
    """Message-level TCP proxy with seeded fault injection (module
    docstring). `stats()` exposes exact per-fault counters so tests can
    assert determinism, not just survival."""

    def __init__(self, upstream_host: str, upstream_port: int, *,
                 listen_host: str = "127.0.0.1", port: int = 0,
                 seed: int = 0,
                 delay_ms: float = 0.0, jitter_ms: float = 0.0,
                 drop_p: float = 0.0, dup_p: float = 0.0,
                 spare_types: Tuple[int, ...] = DEFAULT_SPARE_TYPES,
                 connect_timeout_s: Optional[float] = None):
        self.upstream = (upstream_host, upstream_port)
        self.seed = seed
        self.delay_ms = delay_ms
        self.jitter_ms = jitter_ms
        self.drop_p = drop_p
        self.dup_p = dup_p
        self.spare_types = tuple(spare_types)
        self.connect_timeout_s = connect_timeout_s \
            if connect_timeout_s is not None \
            else P.DEFAULT_CONNECT_TIMEOUT_S
        self._blackholed = threading.Event()
        self._frozen = threading.Event()   # slow_close: stop reading
        self._stopping = threading.Event()
        self._program = None               # (thread, cancel, done)
        self.program_log: List[dict] = []
        self._lock = threading.Lock()
        self._routes: List[_Route] = []
        self._next_idx = 0
        self.counters: Dict[str, int] = {
            "forwarded": 0, "dropped": 0, "duplicated": 0,
            "delayed": 0, "discarded": 0, "conns": 0}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((listen_host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self.host = listen_host
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"netchaos:{self.port}",
            daemon=True)
        self._accept_thread.start()

    # -- fault switches ----------------------------------------------------
    def blackhole(self) -> None:
        """Silent partition: traffic in both directions is read and
        discarded; no FIN crosses the proxy. Undo with `heal()`."""
        self._blackholed.set()
        log.info("netchaos:%d blackholed", self.port)

    def heal(self) -> None:
        """End the partition AND drop the poisoned connections — both
        peers see a clean close and the dialing side's reconnect logic
        takes it from there (resuming mid-stream after arbitrary loss
        would hand each peer a gap it cannot detect)."""
        self._blackholed.clear()
        with self._lock:
            routes = list(self._routes)
        for r in routes:
            r.close()
        log.info("netchaos:%d healed (%d connection(s) reset)",
                 self.port, len(routes))

    @property
    def blackholed(self) -> bool:
        return self._blackholed.is_set()

    def slow_close(self, linger_s: float = 0.5) -> None:
        """Stop draining both directions without closing, so senders
        hit TCP backpressure; close everything after `linger_s`."""
        self._frozen.set()
        log.info("netchaos:%d slow-close (linger %.2fs)", self.port,
                 linger_s)

        def finish():
            time.sleep(linger_s)
            with self._lock:
                routes = list(self._routes)
            for r in routes:
                r.close()
            self._frozen.clear()

        threading.Thread(target=finish, name="netchaos-slow-close",
                         daemon=True).start()

    # -- scheduled fault programs ------------------------------------------
    #: switch ops a program may apply; slow_close takes the linger arg
    PROGRAM_OPS = ("blackhole", "heal", "slow_close")

    def program(self, events, *, t0: Optional[float] = None) -> None:
        """Apply fault switches at scenario-clock offsets: ``events``
        is a list of ``(t_s, op)`` or ``(t_s, op, arg)`` with op in
        `PROGRAM_OPS` and t_s seconds relative to ``t0`` (a
        `time.monotonic` instant; default: now). One scheduler thread
        sleeps to each offset and flips the switch — callers stop
        hand-rolling Timer/sleep choreography and the executor
        (scenario/executor.py) owns the clock.

        Only the switches move; per-message fault decisions still come
        from the per-(seed, connection, direction) RNG streams, drawn
        for every message in fixed order — a scheduled program does not
        perturb where an existing seed places its drops.

        Applied events land in `program_log` as
        ``{"t_s", "op", "applied_monotonic"}`` rows, the ground truth
        for fence-detection math and replay audits."""
        evs = []
        for ev in events:
            if len(ev) == 2:
                t_s, op = ev
                arg = None
            elif len(ev) == 3:
                t_s, op, arg = ev
            else:
                raise ValueError(f"program event must be (t_s, op[, arg]),"
                                 f" got {ev!r}")
            if op not in self.PROGRAM_OPS:
                raise ValueError(
                    f"unknown program op {op!r}; expected one of "
                    f"{self.PROGRAM_OPS}")
            if float(t_s) < 0:
                raise ValueError(f"program offset must be >= 0, got {t_s}")
            evs.append((float(t_s), op, arg))
        evs.sort(key=lambda e: e[0])
        self.cancel_program()
        start = time.monotonic() if t0 is None else float(t0)
        cancel = threading.Event()
        done = threading.Event()

        def run():
            try:
                for t_s, op, arg in evs:
                    wait = start + t_s - time.monotonic()
                    if wait > 0 and cancel.wait(wait):
                        return
                    if cancel.is_set() or self._stopping.is_set():
                        return
                    if op == "blackhole":
                        self.blackhole()
                    elif op == "heal":
                        self.heal()
                    else:
                        self.slow_close(arg if arg is not None else 0.5)
                    with self._lock:
                        self.program_log.append({
                            "t_s": round(t_s, 3), "op": op,
                            "applied_monotonic": time.monotonic()})
            finally:
                done.set()

        t = threading.Thread(target=run, name=f"netchaos-prog:{self.port}",
                             daemon=True)
        t.start()
        with self._lock:
            self._program = (t, cancel, done)

    def cancel_program(self) -> None:
        """Stop a running program; already-applied switches stay."""
        with self._lock:
            prog, self._program = self._program, None
        if prog is None:
            return
        t, cancel, done = prog
        cancel.set()
        done.set()
        t.join(timeout=2)

    def wait_program(self, timeout_s: float = 10.0) -> bool:
        """Block until the current program applied its last event (or
        was cancelled). True if it finished within the timeout."""
        with self._lock:
            prog = self._program
        if prog is None:
            return True
        return prog[2].wait(timeout_s)

    def applied(self, op: str) -> Optional[float]:
        """Monotonic instant the program FIRST applied `op` (None if
        not yet) — e.g. the blackhole instant fence math measures from."""
        with self._lock:
            for row in self.program_log:
                if row["op"] == op:
                    return row["applied_monotonic"]
        return None

    def set_faults(self, *, delay_ms: Optional[float] = None,
                   jitter_ms: Optional[float] = None,
                   drop_p: Optional[float] = None,
                   dup_p: Optional[float] = None) -> None:
        if delay_ms is not None:
            self.delay_ms = delay_ms
        if jitter_ms is not None:
            self.jitter_ms = jitter_ms
        if drop_p is not None:
            self.drop_p = drop_p
        if dup_p is not None:
            self.dup_p = dup_p

    # -- relay -------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                down, _addr = self._sock.accept()
            except OSError:
                return
            try:
                up = socket.create_connection(
                    self.upstream, timeout=self.connect_timeout_s)
                up.settimeout(None)
            except OSError as e:
                log.warning("netchaos:%d upstream dial failed: %s",
                            self.port, e)
                try:
                    down.close()
                except OSError:
                    pass
                continue
            for s in (down, up):
                try:
                    s.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
                except OSError:
                    pass
            with self._lock:
                if self._stopping.is_set():
                    _Route(-1, down, up).close()
                    return
                idx = self._next_idx
                self._next_idx += 1
                route = _Route(idx, down, up)
                self.counters["conns"] += 1
            threads = []
            for dirn, src, dst in (("c2u", down, up),
                                   ("u2c", up, down)):
                t = threading.Thread(
                    target=self._pump, args=(route, dirn, src, dst),
                    name=f"netchaos:{self.port}:{idx}:{dirn}",
                    daemon=True)
                t.start()
                threads.append(t)
            # published only once started: close() joins what it sees
            route.threads = threads
            with self._lock:
                self._routes.append(route)

    def _pump(self, route: _Route, dirn: str, src: socket.socket,
              dst: socket.socket) -> None:
        # one RNG stream per (seed, connection, direction): decisions
        # are drawn for EVERY message in a fixed order, so fault
        # placement is reproducible independent of which faults are on
        rng = random.Random(f"{self.seed}:{route.idx}:{dirn}")
        lock = threading.Lock()
        while not self._stopping.is_set() and not route.closed.is_set():
            if self._frozen.is_set():
                time.sleep(0.01)      # slow_close: stop draining src
                continue
            try:
                msg = P.read_msg(src)
            except Exception:
                msg = None
            if msg is None:
                # src closed. During a blackhole the FIN must NOT
                # propagate — the far side keeps its half open until
                # heal(), like a real partition
                if not self._blackholed.is_set():
                    route.close()
                return
            mtype, payload = msg
            r_drop = rng.random()
            r_dup = rng.random()
            r_jit = rng.random()
            if self._blackholed.is_set():
                with self._lock:
                    self.counters["discarded"] += 1
                continue
            sparable = mtype in self.spare_types
            if self.delay_ms > 0 or self.jitter_ms > 0:
                with self._lock:
                    self.counters["delayed"] += 1
                time.sleep((self.delay_ms + self.jitter_ms * r_jit)
                           / 1e3)
            if not sparable and r_drop < self.drop_p:
                with self._lock:
                    self.counters["dropped"] += 1
                continue
            try:
                P.write_msg(dst, mtype, payload, lock)
                with self._lock:
                    self.counters["forwarded"] += 1
                if not sparable and r_dup < self.dup_p:
                    P.write_msg(dst, mtype, payload, lock)
                    with self._lock:
                        self.counters["duplicated"] += 1
            except OSError:
                if not self._blackholed.is_set():
                    route.close()
                return

    # -- introspection / lifecycle -----------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.counters)
        out["blackholed"] = int(self._blackholed.is_set())
        return out

    def close(self) -> None:
        with self._lock:
            self._stopping.set()
        self.cancel_program()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # the accept loop may be mid-dial of an upstream: once it has
        # returned, no route can appear behind this snapshot
        self._accept_thread.join(timeout=5)
        with self._lock:
            routes = list(self._routes)
        for r in routes:
            r.close()
        for r in routes:
            for t in r.threads:
                t.join(timeout=2)

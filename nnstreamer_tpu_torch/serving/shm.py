"""Same-host shared-memory ring transport for pool worker hops (the JAX
package's serving/shm.py on the port: the same ring layout and record
bytes, so a ring one package writes the other reads).

Every parent↔worker tensor hop used to pay ``pickle.dumps`` + a pipe
write + ``pickle.loads`` — fine for control traffic, a real tax when
the payload is a multi-megabyte wire frame moving twice per request.
This module gives each worker slot a pair of single-producer /
single-consumer byte rings over ``multiprocessing.shared_memory``:

- ``req`` ring: parent writes, child reads (request payloads);
- ``res`` ring: child writes, parent reads (result payloads).

The payload bytes are the *same* wire-frame bytes the pipe would have
carried (edge/wire.py — the cross-host protocol is untouched); only the
carrier changes. A tiny control message still rides the existing pipe
(``("reqs", rid, nbytes, seq)`` / ``("ress", rid, nbytes, seq)``), which
gives ordering for free: the producer finishes the ring write *before*
the pipe send, and the consumer only reads a record the pipe told it
about, so the syscall pair in the middle is the memory barrier and the
ring needs no locks at all.

Ring layout (offsets within the segment)::

    u64 write_pos   # monotonic byte count, producer-owned
    u64 read_pos    # monotonic byte count, consumer-owned
    capacity bytes of ring data  (records: SHM_REC header + payload)

Failure handling is transparency, not correctness theatre:

- ring full (or payload bigger than the ring) → the producer sends the
  whole payload on the pipe as before and counts a fallback;
- child can't attach (permissions, platform) → it acks ``shm: False``
  at handshake and both sides stay on pickle;
- worker killed → the parent's conservation story is unchanged because
  request payloads are retained parent-side for redelivery; the slot's
  rings are closed **and unlinked** at reap, and a respawn creates
  fresh uniquely-named rings, so no stale record is ever read and no
  segment outlives its slot (the worker-kill drill audits /dev/shm).
"""

from __future__ import annotations

import os
import struct
from typing import Optional

from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.edge.wire import SHM_REC, pack_shm_record, \
    unpack_shm_record

log = get_logger("serving.shm")

#: bytes of the two cursor words ahead of the ring data
_HDR = 16
_POS = struct.Struct("<Q")

#: default per-direction ring capacity (bytes); a knob on WorkerSpec
DEFAULT_RING_BYTES = 1 << 22


def shm_supported() -> bool:
    """Whether this interpreter can create POSIX shared memory at all
    (the transport self-disables rather than erroring where it can't —
    the pipe lane is always there)."""
    try:
        from multiprocessing import shared_memory  # noqa: F401
    except Exception:
        return False
    return True


class ShmRing:
    """One SPSC byte ring over one shared-memory segment.

    Exactly one process calls ``try_write`` (producer) and exactly one
    calls ``read_record`` (consumer); each cursor word has a single
    writer, which is the whole synchronization story — ordering comes
    from the pipe control message (see module docstring).
    """

    __slots__ = ("name", "capacity", "_shm", "_buf", "_owner", "_seq")

    def __init__(self, shm, capacity: int, owner: bool):
        self.name = shm.name
        self.capacity = capacity
        self._shm = shm
        self._buf = shm.buf
        self._owner = owner
        self._seq = 0

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def create(cls, name: str, capacity: int = DEFAULT_RING_BYTES
               ) -> "ShmRing":
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(
            name=name, create=True, size=_HDR + int(capacity))
        shm.buf[:_HDR] = b"\x00" * _HDR
        return cls(shm, int(capacity), owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        from multiprocessing import shared_memory

        # NOTE on the resource tracker: a spawned worker shares the
        # pool parent's tracker process, and attaching registers the
        # name there as a (deduplicated) set entry. We deliberately do
        # NOT unregister here — the parent's unlink at reap/close
        # removes the single entry cleanly, and if the whole tree dies
        # hard the tracker's exit sweep unlinks the segment instead of
        # orphaning it in /dev/shm.
        shm = shared_memory.SharedMemory(name=name, create=False)
        return cls(shm, shm.size - _HDR, owner=False)

    def close(self) -> None:
        try:
            self._buf = None
            self._shm.close()
        except Exception:
            pass

    def unlink(self) -> None:
        """Creator-side removal of the segment name. Idempotent — reap
        and close() may both land here."""
        if not self._owner:
            return
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass
        except Exception:
            pass

    # -- cursors -----------------------------------------------------------
    def _load(self, off: int) -> int:
        return _POS.unpack_from(self._buf, off)[0]

    def _store(self, off: int, val: int) -> None:
        _POS.pack_into(self._buf, off, val)

    @property
    def used(self) -> int:
        return self._load(0) - self._load(8)

    @property
    def free(self) -> int:
        return self.capacity - self.used

    # -- producer ----------------------------------------------------------
    def try_write(self, payload: bytes) -> Optional[int]:
        """Append one record; returns its seq, or ``None`` when the
        record doesn't fit (caller falls back to the pipe lane — never
        blocks, never partially writes)."""
        need = SHM_REC.size + len(payload)
        if need > self.free or self._buf is None:
            return None
        self._seq += 1
        w = self._load(0)
        self._copy_in(w, pack_shm_record(payload, self._seq))
        self._copy_in(w + SHM_REC.size, payload)
        self._store(0, w + need)
        return self._seq

    def _copy_in(self, pos: int, data: bytes) -> None:
        off = pos % self.capacity
        first = min(len(data), self.capacity - off)
        self._buf[_HDR + off:_HDR + off + first] = data[:first]
        if first < len(data):          # wrap
            rest = len(data) - first
            self._buf[_HDR:_HDR + rest] = data[first:]

    # -- consumer ----------------------------------------------------------
    def read_record(self, expect_len: int, expect_seq: int) -> bytes:
        """Pop the next record, which the pipe control message promised
        is ``(expect_len, expect_seq)``; raises ValueError on any
        mismatch (stale/torn record — the reader treats the lane as
        faulted and the request is recovered via redelivery)."""
        r = self._load(8)
        head = self._copy_out(r, SHM_REC.size)
        length, seq = unpack_shm_record(head)
        if length != expect_len or seq != expect_seq:
            raise ValueError(
                f"shm record mismatch: ring has len={length} seq={seq}, "
                f"control said len={expect_len} seq={expect_seq}")
        payload = self._copy_out(r + SHM_REC.size, length)
        self._store(8, r + SHM_REC.size + length)
        return payload

    def _copy_out(self, pos: int, n: int) -> bytes:
        off = pos % self.capacity
        first = min(n, self.capacity - off)
        out = bytes(self._buf[_HDR + off:_HDR + off + first])
        if first < n:                  # wrap
            out += bytes(self._buf[_HDR:_HDR + (n - first)])
        return out


def _hop_child(conn, ring_req: str, ring_res: str, n: int) -> None:
    """Child half of `hop_latency_ab` (spawn target — must live in an
    importable module, not the bench script): echo `n` payloads back
    over whichever lane the parent chose."""
    rq = rs = None
    if ring_req:
        rq = ShmRing.attach(ring_req)
        rs = ShmRing.attach(ring_res)
    try:
        for _ in range(n):
            if rq is not None:
                _, rid, nbytes, seq = conn.recv()
                payload = rq.read_record(nbytes, seq)
                seq2 = rs.try_write(payload)
                conn.send(("ress", rid, len(payload), seq2))
            else:
                _, rid, payload = conn.recv()
                conn.send(("res", rid, payload))
    finally:
        for ring in (rq, rs):
            if ring is not None:
                ring.close()
        conn.close()


def hop_latency_ab(payload_bytes: int = 1 << 20, n: int = 200,
                   ring_bytes: int = DEFAULT_RING_BYTES) -> dict:
    """Closed-loop same-host hop A/B: one payload round-trips
    parent↔child `n` times over (a) the pickle pipe — the payload
    inside a control tuple, ``conn.send(("req", rid, payload))``,
    exactly what pool dispatch does when the lane is off — and (b) the
    shm ring pair with the same control tuple minus the payload. Both
    lanes are the pool's real message shapes with nothing else on the
    clock. Returns per-lane round-trip p50/p99 (ms) and the pipe/shm
    speedup; `shm_ok` is the bench's "the lane earns its keep"
    verdict."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    payload = b"\xa5" * int(payload_bytes)
    out: dict = {"payload_bytes": int(payload_bytes), "round_trips": n}
    for key in ("pipe", "shm"):
        rq = rs = None
        if key == "shm":
            rq = ShmRing.create(ring_name("hq", "hopab", 0, 0),
                                ring_bytes)
            rs = ShmRing.create(ring_name("hs", "hopab", 0, 0),
                                ring_bytes)
        a, b = ctx.Pipe()
        proc = ctx.Process(
            target=_hop_child,
            args=(b, rq.name if rq else "", rs.name if rs else "",
                  n + 5))
        proc.start()
        b.close()
        lats = []
        try:
            def round_trip():
                if rq is not None:
                    seq = rq.try_write(payload)
                    a.send(("reqs", 1, len(payload), seq))
                    _, _, nbytes, seq2 = a.recv()
                    rs.read_record(nbytes, seq2)
                else:
                    a.send(("req", 1, payload))
                    a.recv()

            for _ in range(5):        # spawn + import warmup, untimed
                round_trip()
            for _ in range(n):
                t0 = time.perf_counter()
                round_trip()
                lats.append((time.perf_counter() - t0) * 1e3)
        finally:
            a.close()
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join()
            for ring in (rq, rs):
                if ring is not None:
                    ring.close()
                    ring.unlink()
        lats.sort()
        out[key + "_p50_ms"] = round(lats[len(lats) // 2], 3)
        out[key + "_p99_ms"] = round(lats[min(len(lats) - 1,
                                              int(len(lats) * 0.99))], 3)
    out["hop_speedup"] = (round(out["pipe_p50_ms"] / out["shm_p50_ms"], 2)
                          if out["shm_p50_ms"] else 0.0)
    out["shm_ok"] = out["shm_p50_ms"] <= out["pipe_p50_ms"]
    return out


#: segment-name prefix of this package's rings ("nns_" is the JAX
#: package's): a port pool and a JAX pool of the same name in one process
#: never collide on a segment name
RING_PREFIX = "nnt_"


def shm_safe(name: str) -> str:
    """Pool names may be arbitrary; segment names may not."""
    return "".join(c if c.isalnum() else "-" for c in name)[:32]


def ring_name(kind: str, pool_name: str, wid: int, spawn: int) -> str:
    """Unique-per-spawn segment name: a respawned slot never attaches
    its predecessor's ring, so a killed worker's half-written state is
    unreachable by construction. The creating pid suffixes the name so
    one host's concurrent pools (tests!) can never collide."""
    return (f"{RING_PREFIX}{kind}_{shm_safe(pool_name)}_{wid}_{spawn}_"
            f"{os.getpid()}")

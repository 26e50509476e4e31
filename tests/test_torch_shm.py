"""The same-host shared-memory lane on the port (nnstreamer_tpu_torch:
edge/wire.py's record framing, serving/shm.py, the pool's lane) against
the JAX package's, on the CPU.

- The record header: byte for byte JAX's on the same records, both
  ways, and the same refusal of a bad magic.
- `ShmRing` (JAX `tests/test_shm.py::TestShmRing`'s cases): round trip
  and seq, wrap, full ring, oversized payloads, control mismatches,
  attach/unlink, segment names; then across the packages: a port ring
  written, a JAX ring attached to the same segment reads the same
  records, and the reverse.
- The pool's lane (`TestPoolShmLane`): frames moved over the rings with
  exact conservation and every segment unlinked at close, a pipe-only
  pool, the pickle fallback when the child cannot attach (counted in
  `shm_fallbacks`, JAX's transport contract), a SIGKILL mid-flood with
  zero lost frames, zero orphan pids and zero orphan segments.
- The hop-latency A/B helper's report shape and cleanup.

The floods are JAX's own open-loop wire client (traffic/loadgen.py)
against the port's pool. No assertion reads a wall clock.
"""

import itertools
import os
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.edge import wire as jwire
from nnstreamer_tpu.serving import shm as jshm
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
from nnstreamer_tpu.traffic.loadgen import poisson_arrivals, run_open_loop
from nnstreamer_tpu_torch.edge import wire as twire
from nnstreamer_tpu_torch.edge.query import QueryServer
from nnstreamer_tpu_torch.edge.wire import SHM_REC
from nnstreamer_tpu_torch.serving.pool import PooledQueryServer, proc_alive
from nnstreamer_tpu_torch.serving.shm import (
    RING_PREFIX, ShmRing, hop_latency_ab, ring_name, shm_safe,
    shm_supported)

pytestmark = pytest.mark.skipif(not shm_supported(),
                                reason="POSIX shared memory unavailable")

_sid = itertools.count(19600)
_rid = itertools.count()


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    # spawned children inherit the environment: one BLAS thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    QueryServer.reset_all()
    torch.set_num_threads(threads)


def _ring(capacity: int) -> ShmRing:
    return ShmRing.create(ring_name("tu", "shmunit", next(_rid), 0),
                          capacity)


def _conserved(c: dict) -> bool:
    return (c["offered"] == c["admitted"] + sum(c["rejected"].values())
            and c["admitted"] == c["replied"] + sum(c["shed"].values())
            + c["depth"] + c["inflight"])


def _echo_pool(**kw):
    kw.setdefault("workers", 2)
    kw.setdefault("service_ms", 2.0)
    return PooledQueryServer.echo(sid=next(_sid), **kw)


def _drive(pqs, n, rate_hz=150.0, **kw):
    x = np.ones((8, 1), np.float32)
    return run_open_loop(
        "127.0.0.1", pqs.port, dims="8:1",
        arrivals=poisson_arrivals(rate_hz, n),
        make_frame=lambda i: JBuffer.of(x, pts=i),
        p99_budget_ms=1000.0, **kw)


def _our_segments():
    """/dev/shm entries of this process's port rings (ring_name suffixes
    the creating pid)."""
    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return []
    return sorted(n for n in names if n.startswith(RING_PREFIX)
                  and n.endswith(f"_{os.getpid()}"))


# -- record framing -----------------------------------------------------------

@pytest.mark.parametrize("payload,seq", [
    (b"", 1), (b"abc", 7), (bytes(range(256)) * 3, 2 ** 40)])
def test_shm_record_bytes_equal_jax(payload, seq):
    head = twire.pack_shm_record(payload, seq)
    assert head == jwire.pack_shm_record(payload, seq)
    assert (twire.SHM_REC_MAGIC, twire.SHM_REC.size) == \
        (jwire.SHM_REC_MAGIC, jwire.SHM_REC.size)
    assert twire.unpack_shm_record(head) == \
        jwire.unpack_shm_record(head) == (len(payload), seq)
    bad = b"\x00" * twire.SHM_REC.size
    for mod in (twire, jwire):
        with pytest.raises(ValueError, match="magic"):
            mod.unpack_shm_record(bad)


# -- ring mechanics -----------------------------------------------------------

class TestShmRing:
    def test_write_read_round_trip_and_seq(self):
        r = _ring(1024)
        try:
            for i in range(3):
                payload = bytes([i]) * (10 + i)
                seq = r.try_write(payload)
                assert seq == i + 1          # seqs are 1-based, monotone
                assert r.read_record(len(payload), seq) == payload
            assert r.used == 0               # fully drained
        finally:
            r.close()
            r.unlink()

    def test_wrap_across_capacity_boundary(self):
        cap = 128
        r = _ring(cap)
        rec = SHM_REC.size + 40
        try:
            payload = bytes(range(40))
            for _ in range(10):              # 10 * rec >> cap: many wraps
                seq = r.try_write(payload)
                assert seq is not None
                assert r.read_record(len(payload), seq) == payload
            assert 10 * rec > 4 * cap
            assert r.used == 0
        finally:
            r.close()
            r.unlink()

    def test_full_ring_refuses_then_recovers(self):
        cap = 64
        r = _ring(cap)
        try:
            p = b"x" * (cap - SHM_REC.size)  # exactly fills the ring
            seq = r.try_write(p)
            assert seq == 1
            assert r.free == 0
            assert r.try_write(b"y") is None      # full → pipe fallback
            assert r.read_record(len(p), seq) == p
            seq2 = r.try_write(b"y" * 8)          # space reclaimed
            assert seq2 == 2
            assert r.read_record(8, seq2) == b"y" * 8
        finally:
            r.close()
            r.unlink()

    def test_oversized_payload_never_partially_writes(self):
        r = _ring(64)
        try:
            assert r.try_write(b"z" * 256) is None
            assert r.used == 0               # no torn half-record
        finally:
            r.close()
            r.unlink()

    def test_control_message_mismatch_raises(self):
        r = _ring(256)
        try:
            seq = r.try_write(b"abc")
            with pytest.raises(ValueError, match="mismatch"):
                r.read_record(3, seq + 1)    # stale seq from control msg
            with pytest.raises(ValueError, match="mismatch"):
                r.read_record(2, seq)        # wrong promised length
            assert r.read_record(3, seq) == b"abc"
        finally:
            r.close()
            r.unlink()

    def test_attach_sees_creator_writes_and_unlink_removes(self):
        r = _ring(256)
        name = r.name
        other = ShmRing.attach(name)
        try:
            seq = r.try_write(b"hello")
            assert other.read_record(5, seq) == b"hello"
        finally:
            other.close()
            r.close()
            r.unlink()
        assert name not in _our_segments()

    def test_ring_names_are_legal_and_unique_per_spawn(self):
        a = ring_name("rq", "we?ird pool/name", 3, 1)
        b = ring_name("rq", "we?ird pool/name", 3, 2)
        assert a != b                        # respawn never aliases
        assert "/" not in a[1:] and " " not in a and "?" not in a
        assert shm_safe("we?ird pool/name") in a
        assert shm_safe("we?ird pool/name") == \
            jshm.shm_safe("we?ird pool/name")
        # the port's prefix keeps a same-named JAX pool's rings apart
        assert a.startswith(RING_PREFIX) and a != jshm.ring_name(
            "rq", "we?ird pool/name", 3, 1)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ring_crosses_packages(writer):
    """A ring one package creates and writes, the other attaches to the
    same segment and reads: the same records, wrap included, and the
    consumer's cursor is seen by the producer (the ring frees)."""
    mods = {"port": ShmRing, "jax": jshm.ShmRing}
    reader = "jax" if writer == "port" else "port"
    w = mods[writer].create(ring_name("xp", "cross", next(_rid), 0), 96)
    r = mods[reader].attach(w.name)
    try:
        rng = np.random.default_rng(3)
        for i in range(12):                  # 12 x (16 + 30) >> 96
            payload = rng.integers(0, 256, 30, dtype=np.uint8).tobytes()
            seq = w.try_write(payload)
            assert seq == i + 1
            assert r.read_record(len(payload), seq) == payload
            assert w.used == 0 and r.used == 0
    finally:
        r.close()
        w.close()
        w.unlink()


# -- the pool's lane ----------------------------------------------------------

class TestPoolShmLane:
    def test_lane_moves_frames_conserves_and_reclaims(self):
        pqs = _echo_pool(shm_transport=True)
        pool = pqs.pool
        try:
            rep = _drive(pqs, 40)
            assert rep["completed"] == 40 and rep["lost"] == 0
            assert _conserved(pqs.admission_counters())
            p = pool.stats()["pool"]
            assert p["shm_fallbacks"] == 0
            assert p["shm_frames"] >= 2 * rep["completed"]
            assert p["shm_bytes"] > p["shm_frames"] * 8
            assert len(pool.shm_segments()) == 2 * pool.n_workers
        finally:
            pqs.close()
        assert pool.shm_segments() == []     # unlinked at close
        assert _our_segments() == []

    def test_pipe_only_pool_counts_zero_shm(self):
        pqs = _echo_pool(shm_transport=False, workers=1)
        try:
            rep = _drive(pqs, 20)
            assert rep["completed"] == 20 and rep["lost"] == 0
            assert _conserved(pqs.admission_counters())
            p = pqs.pool.stats()["pool"]
            assert p["shm_frames"] == 0 and p["shm_bytes"] == 0
            assert pqs.pool.shm_segments() == []
        finally:
            pqs.close()

    def test_attach_failure_falls_back_to_pickle(self, monkeypatch):
        """Child can't attach (the parent handed it segment names that
        don't exist) → it acks ``shm: False`` and every hop rides the
        pickle pipe, invisibly to the caller, counted once a hello."""
        class _GhostRing:
            def __init__(self, name):
                self.name = name

            def close(self):
                pass

            def unlink(self):
                pass

            def try_write(self, payload):
                return None

        monkeypatch.setattr(
            ShmRing, "create",
            classmethod(lambda cls, name, capacity=0:
                        _GhostRing(name + "-ghost")))
        pqs = _echo_pool(shm_transport=True)
        try:
            rep = _drive(pqs, 20)
            assert rep["completed"] == 20 and rep["lost"] == 0
            assert _conserved(pqs.admission_counters())
            p = pqs.pool.stats()["pool"]
            assert p["shm_fallbacks"] >= pqs.pool.n_workers  # per hello
            assert p["shm_frames"] == 0      # nothing rode a ghost ring
        finally:
            pqs.close()
        assert _our_segments() == []


@pytest.mark.chaos
def test_worker_kill_zero_lost_zero_orphan_segments():
    """SIGKILL a worker mid-flood with the lane on: conservation exact,
    the pool recovers, zero orphan pids and zero orphan segments (the
    killed slot's rings are unlinked at reap; the respawn gets fresh
    names)."""
    pqs = _echo_pool(service_ms=5.0, max_pending=32,
                     restart_backoff_s=0.02, shm_transport=True)
    pool = pqs.pool
    killed = []

    def killer():
        # kill once the flood is under way (a request is in flight)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if pqs.admission_counters()["replied"] >= 20:
                killed.append(pool.kill_worker(0))
                return
            time.sleep(0.005)

    t = threading.Thread(target=killer)
    t.start()
    try:
        rep = _drive(pqs, 120, rate_hz=250.0, drain_timeout_s=20.0)
        t.join()
        assert killed and killed[0] is not None
        assert rep["lost"] == 0
        assert rep["completed"] + rep["rejected"] == 120
        assert _conserved(pqs.admission_counters())
        assert pool.wait_ready(20.0), pool.stats()
        p = pool.stats()["pool"]
        assert p["shm_frames"] > 0 and p["restarts"] >= 1
    finally:
        pids = pool.all_pids_ever()
        pqs.close()
    assert len(pids) == 3 and not any(proc_alive(p) for p in pids)
    assert _our_segments() == []


def test_hop_latency_ab_shape_and_cleanup():
    """Tiny run: the helper measures both lanes, reports the fields, and
    leaves no segment behind (the speedup verdict needs the card's
    host, phase 46, not a unit assert)."""
    out = hop_latency_ab(payload_bytes=4096, n=12)
    assert set(out) == {"payload_bytes", "round_trips", "pipe_p50_ms",
                        "pipe_p99_ms", "shm_p50_ms", "shm_p99_ms",
                        "hop_speedup", "shm_ok"}
    assert out["round_trips"] == 12
    assert out["payload_bytes"] == 4096
    for k in ("pipe_p50_ms", "pipe_p99_ms",
              "shm_p50_ms", "shm_p99_ms", "hop_speedup"):
        assert out[k] > 0, k
    assert isinstance(out["shm_ok"], bool)
    assert not [n_ for n_ in _our_segments() if "_hopab_" in n_]

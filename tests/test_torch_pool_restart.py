"""The port's worker pool through restarts (JAX `tests/test_pool.py`'s
circuit, orphan and redelivery cases), on the CPU.

- The restart-budget circuit disables the slot instead of flapping, and
  says so through the tracer.
- SIGKILL of one worker: recovery, and zero orphans over every pid the
  pool ever spawned; a frame redelivered after a SIGKILL keeps its trace
  id across the dead and the replacement worker.

Every flood is JAX's open-loop wire client (traffic/loadgen.py). No
assertion reads a wall clock.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
from nnstreamer_tpu.traffic.loadgen import poisson_arrivals, run_open_loop
from nnstreamer_tpu_torch.edge.query import QueryServer
from nnstreamer_tpu_torch.runtime.tracing import (
    Tracer, ensure_trace_ctx, hop_spans)
from nnstreamer_tpu_torch.serving.pool import (
    DISABLED, PooledQueryServer, proc_alive)
from nnstreamer_tpu_torch.serving.worker import WorkerSpec

pytestmark = pytest.mark.chaos

_sid = itertools.count(19400)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    # spawned children inherit the environment: one BLAS thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    QueryServer.reset_all()
    torch.set_num_threads(threads)


def _conserved(c: dict) -> bool:
    return (c["offered"] == c["admitted"] + sum(c["rejected"].values())
            and c["admitted"] == c["replied"] + sum(c["shed"].values())
            + c["depth"] + c["inflight"])


def _drive(pqs, n, rate_hz=100.0, make=None, **kw):
    x = np.ones((8, 1), np.float32)
    return run_open_loop(
        "127.0.0.1", pqs.port, dims="8:1",
        arrivals=poisson_arrivals(rate_hz, n,
                                  rng=np.random.default_rng(7)),
        make_frame=make or (lambda i: JBuffer.of(x, pts=i)),
        p99_budget_ms=kw.pop("p99_budget_ms", 250.0), **kw)


def test_restart_budget_circuit_degrades_instead_of_flapping():
    tracer = Tracer()
    pqs = PooledQueryServer(
        WorkerSpec(kind="echo", crash_after_s=0.05),
        workers=1, sid=next(_sid), tracer=tracer,
        restart_budget=2, restart_window_s=30.0,
        restart_backoff_s=0.01, ready_timeout_s=0.2)
    try:
        pool = pqs.pool
        deadline = time.monotonic() + 30
        while pool.degraded < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        st = pool.stats()
        assert st["pool"]["degraded"] == 1, st
        assert st["workers"][0]["state"] == DISABLED
        assert pool.live_workers() == 0
        # a tripped circuit stays tripped: no further restarts
        restarts = st["pool"]["restarts"]
        time.sleep(0.3)
        assert pool.stats()["pool"]["restarts"] == restarts
        wc = tracer.summary()["workers"][pool.name]
        assert wc["degraded"] == 1 and wc["restart"] >= 2
    finally:
        pqs.close()


def test_sigkill_recovers_zero_orphans_and_keeps_trace_ids():
    """Two workers, one SIGKILLed mid-flood: zero lost, back to capacity,
    and three pids ever spawned, none alive after close. A frame that
    was in flight on the dead worker is redelivered under its original
    trace id: its timeline shows both workers' dispatches."""
    tr = Tracer()
    pqs = PooledQueryServer.echo(workers=2, service_ms=15.0,
                                 sid=next(_sid), tracer=tr,
                                 max_pending=32, restart_backoff_s=0.02)
    pool = pqs.pool
    killed = []

    def killer():
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            with pool._lock:
                busy = [s.wid for s in pool._slots if s.inflight]
            if pqs.admission_counters()["replied"] >= 10 and busy:
                killed.append(pool.kill_worker(busy[0]))
                return
            time.sleep(0.002)

    x = np.ones((8, 1), np.float32)

    def mk(i):
        b = JBuffer.of(x, pts=i)
        ensure_trace_ctx(b.meta)
        return b

    t = threading.Thread(target=killer)
    t.start()
    try:
        rep = _drive(pqs, 80, rate_hz=120.0, make=mk,
                     p99_budget_ms=2000.0, drain_timeout_s=30.0)
        t.join()
        assert killed and killed[0] is not None
        assert rep["lost"] == 0
        assert rep["completed"] + rep["rejected"] == 80
        assert _conserved(pqs.admission_counters())
        assert pool.wait_ready(20.0), pool.stats()
        st = pool.stats()["pool"]
        assert st["restarts"] == 1 and st["reoffered"] >= 1
        redelivered = [(tid, hops) for _, tid, _, hops, _ in tr.requests()
                       if sum(h.get("hop") == "dispatch"
                              for h in hops) >= 2]
        assert redelivered, "no completed request carries 2 dispatches"
        for tid, hops in redelivered:
            assert "reoffer" in [h["hop"] for h in hops]
            wpids = {h.get("wpid") for h in hops
                     if h.get("hop") == "dispatch"}
            assert len(wpids) == 2, (tid, hops)
            assert hop_spans(hops)["redeliveries"] >= 1
        kinds = {k for _, _, k, _, _ in tr.worker_events()}
        assert {"exit", "reoffer", "restart"} <= kinds
    finally:
        pids = pool.all_pids_ever()
        pqs.close()
    assert len(pids) == 3             # 2 initial + 1 restart
    assert not any(proc_alive(p) for p in pids)

"""The port's worker pool under chaos (JAX `tests/test_pool.py`'s crash
and hang cases), on the CPU, held to the JAX package's pool where the
outcome is deterministic.

- A poison frame (`crash_pts`): the same seeded flood against the port's
  pool and JAX's gives the same admission counters and the same BUSY
  causes (`worker_lost` after one redelivery).
- A hang (`hang_pts`) is caught by the frame deadline, not the
  heartbeat: SIGKILL, shed, conserved; the same counters as JAX's.

The restart-budget circuit and SIGKILL recovery are in
`test_torch_pool_restart.py`.

Every flood is JAX's open-loop wire client (traffic/loadgen.py). No
assertion reads a wall clock.
"""

import itertools

import numpy as np
import pytest
import torch

from nnstreamer_tpu.edge.query import QueryServer as JQueryServer
from nnstreamer_tpu.serving.pool import PooledQueryServer as JPooled
from nnstreamer_tpu.serving.worker import WorkerSpec as JSpec
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
from nnstreamer_tpu.traffic.loadgen import poisson_arrivals, run_open_loop
from nnstreamer_tpu_torch.edge.query import QueryServer
from nnstreamer_tpu_torch.serving.pool import PooledQueryServer
from nnstreamer_tpu_torch.serving.worker import WorkerSpec

pytestmark = pytest.mark.chaos

_sid = itertools.count(19300)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    # spawned children inherit the environment: one BLAS thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    QueryServer.reset_all()
    JQueryServer.reset_all()
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


#: the admission counters that a deterministic chaos flood fixes
_EXACT = ("offered", "admitted", "replied", "rejected", "shed", "depth",
          "inflight")


def _flood(pkg, spec_kw, pool_kw, n, rate_hz):
    Pooled, Spec = {"port": (PooledQueryServer, WorkerSpec),
                    "jax": (JPooled, JSpec)}[pkg]
    pqs = Pooled(Spec(kind="echo", **spec_kw), workers=1,
                 sid=next(_sid), max_pending=32, **pool_kw)
    try:
        rep = _drive(pqs, n, rate_hz=rate_hz, drain_timeout_s=20.0)
        c = pqs.admission_counters()
        st = pqs.pool.stats()["pool"]
    finally:
        pqs.close()
    return rep, c, st


@pytest.mark.parametrize("case", ["crash", "hang"])
def test_chaos_flood_counts_as_jax(case):
    """The same seeded flood through a poison frame (it kills every
    worker that touches it: first delivery and one redelivery, then
    BUSY(worker_lost)) or a wedged frame (the worker keeps its
    heartbeat; the frame deadline SIGKILLs it, no redelivery): the
    port's pool and JAX's end with the same counters and BUSY causes."""
    if case == "crash":
        spec_kw = {"service_ms": 5.0, "crash_pts": 3}
        pool_kw = {"restart_backoff_s": 0.02}
        n, rate = 8, 50.0
    else:
        spec_kw = {"service_ms": 1.0, "hang_pts": 2}
        pool_kw = {"frame_deadline_s": 0.5, "max_redeliver": 0,
                   "per_worker_queue": 1, "restart_backoff_s": 0.02}
        n, rate = 5, 100.0
    out = {pkg: _flood(pkg, spec_kw, pool_kw, n, rate)
           for pkg in ("port", "jax")}
    (rep, c, st), (jrep, jc, jst) = out["port"], out["jax"]
    assert rep["lost"] == 0 and _conserved(c)
    assert rep["completed"] == n - 1
    assert rep["busy_causes"] == {"worker_lost": 1}
    assert (rep["completed"], rep["busy_causes"], rep["lost"]) == \
        (jrep["completed"], jrep["busy_causes"], jrep["lost"])
    assert {k: c[k] for k in _EXACT} == {k: jc[k] for k in _EXACT}
    assert c["shed"] == {"worker_lost": 1}
    if case == "crash":
        assert st["restarts"] >= 2 and jst["restarts"] >= 2
    else:
        assert st["kills"] >= 1 and jst["kills"] >= 1

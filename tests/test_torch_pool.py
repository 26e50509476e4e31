"""The supervised worker pool on the port (nnstreamer_tpu_torch:
serving/worker.py, serving/pool.py, edge/query.py's pool hook) against
the JAX package's, on the CPU: JAX `tests/test_pool.py`'s basics, swap,
drain and tracing cases with echo workers, and the two packages' pools
and clients against each other.

- Basics: a round trip with per-worker reply counters and a clean close
  (no orphan pid), the out spec adopted from the worker's hello, the
  serversrc's stats folding the pool's view in, config refusals (the
  same as JAX's), the spec's worker count filled in for the per-child
  memory share.
- Swap: the two-phase commit bumps the epoch on every worker; an
  injected prepare failure aborts all and the epoch stays.
- Drain: in-flight frames finish inside the budget; close is idempotent;
  queued frames past the budget are shed as `shutdown`, conserved.
- Tracing: worker tracers ship deltas over the heartbeat lane and merge
  into one summary and one Chrome trace with a track group per worker.
- Across the packages: a port `tensor_query_client` against a JAX
  `PooledQueryServer`, and a JAX client against the port's, return the
  frames sent, in pts order.

The floods are JAX's own open-loop wire client (traffic/loadgen.py).
No assertion reads a wall clock.
"""

import itertools
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.edge.query import QueryServer as JQueryServer
from nnstreamer_tpu.serving.pool import PooledQueryServer as JPooled
from nnstreamer_tpu.serving.pool import proc_alive as jproc_alive
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
from nnstreamer_tpu.traffic.loadgen import poisson_arrivals, run_open_loop
from nnstreamer_tpu_torch.edge.query import (
    QueryServer, TensorQueryServerSrc)
from nnstreamer_tpu_torch.runtime.tracing import Tracer, ensure_trace_ctx
from nnstreamer_tpu_torch.serving.pool import (
    PooledQueryServer, WorkerPool, proc_alive)
from nnstreamer_tpu_torch.serving.worker import WorkerSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

_sid = itertools.count(19000)


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    # spawned children inherit the environment: one BLAS thread each
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    QueryServer.reset_all()
    JQueryServer.reset_all()
    torch.set_num_threads(threads)
    mp.undo()


@pytest.fixture(scope="module")
def shared_pool(_cpu_port):
    """One 2-worker echo pool for the cases that only read it (a child's
    start is an import of torch, seconds on this host)."""
    pqs = _echo_pool()
    yield pqs
    pqs.close()


def _conserved(c: dict) -> bool:
    return (c["offered"] == c["admitted"] + sum(c["rejected"].values())
            and c["admitted"] == c["replied"] + sum(c["shed"].values())
            + c["depth"] + c["inflight"])


def _echo_pool(**kw):
    kw.setdefault("workers", 2)
    kw.setdefault("service_ms", 2.0)
    return PooledQueryServer.echo(sid=next(_sid), **kw)


def _drive(pqs, n, rate_hz=100.0, make=None, **kw):
    """Open-loop load against a live pool; returns the SLO report."""
    x = np.ones((8, 1), np.float32)
    return run_open_loop(
        "127.0.0.1", pqs.port, dims="8:1",
        arrivals=poisson_arrivals(rate_hz, n),
        make_frame=make or (lambda i: JBuffer.of(x, pts=i)),
        p99_budget_ms=kw.pop("p99_budget_ms", 250.0), **kw)


# -- basics -------------------------------------------------------------------

class TestPoolBasics:
    def test_echo_round_trip(self, shared_pool):
        pqs = shared_pool
        before = sum(w["replied"] for w in pqs.stats()["workers"])
        rep = _drive(pqs, 40)
        assert rep["completed"] == 40 and rep["lost"] == 0
        assert _conserved(pqs.admission_counters())
        st = pqs.pool.stats()
        # least-outstanding routing: per-worker reply counters exist
        # and account for every completion
        assert sum(w["replied"] for w in st["workers"]) - before == 40
        assert {w["state"] for w in st["workers"]} == {"ready"}
        # an echo child makes no device: it never picks one
        assert {w["device"] for w in st["workers"]} == {None}

    def test_out_spec_adopted_from_worker_hello(self, shared_pool):
        assert shared_pool.qs.out_spec is not None
        dims, types, _ = shared_pool.qs.out_spec.to_strings()
        assert (dims, types) == ("8:1", "float32")

    def test_serversrc_extra_stats_merge_pool_view(self, shared_pool):
        src = TensorQueryServerSrc(name="s", id=shared_pool.sid, dims="8:1")
        out = src.extra_stats()
        assert out["pool_workers"] == 2
        assert out["worker0_state"] == "ready"
        assert "worker1_restarts" in out
        # the same flat keys as JAX's pool view
        assert set(out) >= {f"pool_{k}"
                            for k in shared_pool.stats()["pool"]}

    def test_bad_config_rejected(self):
        from nnstreamer_tpu.serving.worker import WorkerSpec as JSpec

        with pytest.raises(ValueError, match="workers"):
            WorkerPool(QueryServer.get(next(_sid)), WorkerSpec(), 0)
        for kw, match in (({"kind": "wat"}, "kind"),
                          ({"kind": "pipeline"}, "pipeline"),
                          ({"kind": "multiplex"}, "tenants")):
            for Spec in (WorkerSpec, JSpec):
                with pytest.raises(ValueError, match=match):
                    Spec(**kw)
        # the port's spec carries JAX's fields, plus the pool's slot count
        import dataclasses

        jf = {f.name for f in dataclasses.fields(JSpec)}
        tf = {f.name for f in dataclasses.fields(WorkerSpec)}
        assert tf - jf == {"workers"} and jf <= tf

    def test_pool_fills_in_the_worker_count(self):
        qs = QueryServer.get(next(_sid))
        pool = WorkerPool(qs, WorkerSpec(kind="echo"), 3)
        assert pool.spec.workers == 3     # never started: nothing spawned


# -- hot swap -----------------------------------------------------------------

class TestPoolSwap:
    def test_two_phase_commit_bumps_epoch_on_all_workers(self,
                                                         shared_pool):
        epoch = shared_pool.pool.epoch
        rep = shared_pool.swap("m", 1)
        assert rep["ok"] and rep["epoch"] == epoch + 1
        assert all(w["prepare_ok"] and w["commit_ok"]
                   for w in rep["workers"].values())
        assert len(rep["workers"]) == 2

    def test_prepare_failure_aborts_all_epoch_unchanged(self):
        pqs = PooledQueryServer(
            WorkerSpec(kind="echo", service_ms=1.0,
                       swap_fail_version=9),
            workers=2, sid=next(_sid))
        try:
            assert pqs.swap("m", 1)["ok"] and pqs.pool.epoch == 1
            rep = pqs.swap("m", 9)        # injected prepare failure
            assert not rep["ok"]
            assert pqs.pool.epoch == 1    # all-or-none: did not move
            assert "injected" in rep["workers"][0]["error"]
            assert _drive(pqs, 10)["completed"] == 10
        finally:
            pqs.close()


# -- drain / close ------------------------------------------------------------

class TestPoolDrain:
    def test_close_drains_inflight_within_budget(self):
        pqs = _echo_pool(service_ms=30.0)
        qs = pqs.qs
        try:
            x = np.ones((8, 1), np.float32)
            for i in range(4):
                assert qs.frames.offer(TensorBuffer.of(x, pts=i)
                                       .with_meta(client_id=1)).admitted
            # the router dispatches them
            deadline = time.monotonic() + 10
            while qs.frames.counters()["depth"] and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            pqs.close()
        c = qs.frames.counters()
        # drained, not shed: the frames finished inside the drain budget
        assert c["replied"] == 4 and c["shed"] == {} and _conserved(c)

    def test_close_is_idempotent_and_leaves_no_orphan(self):
        pqs = _echo_pool(workers=1)
        assert _drive(pqs, 5)["completed"] == 5
        pids = pqs.pool.all_pids_ever()
        pqs.close()
        before = pqs.qs.frames.counters()
        pqs.close()                       # second close: strict no-op
        assert pqs.qs.frames.counters() == before
        assert pqs.pool.closed
        assert pids and not any(proc_alive(p) for p in pids)

    def test_close_sheds_queued_frames_as_shutdown(self):
        pqs = _echo_pool(workers=1, service_ms=200.0,
                         drain_timeout_s=0.2)
        qs = pqs.qs
        x = np.ones((8, 1), np.float32)
        for i in range(6):
            qs.frames.offer(TensorBuffer.of(x, pts=i)
                            .with_meta(client_id=1))
        pqs.close()
        c = qs.frames.counters()
        assert _conserved(c) and c["depth"] == 0 and c["inflight"] == 0
        assert c["replied"] + c["shed"].get("shutdown", 0) == 6
        assert c["shed"].get("shutdown", 0) >= 1


# -- distributed tracing across the pool --------------------------------------

def test_worker_tracers_merge_into_pool_summary():
    """Each worker's own Tracer ships deltas over the heartbeat lane; the
    parent merges them into one summary and one Chrome trace with a track
    group per worker process; the pool's lifecycle rides the tracer."""
    tr = Tracer()
    pqs = _echo_pool(service_ms=2.0, tracer=tr)
    try:
        assert pqs.pool.spec.trace           # a traced pool traces kids
        x = np.ones((8, 1), np.float32)

        def mk(i):
            b = JBuffer.of(x, pts=i)
            ensure_trace_ctx(b.meta)
            return b

        rep = _drive(pqs, 30, rate_hz=150.0, make=mk,
                     p99_budget_ms=500.0)
        assert rep["completed"] == 30 and rep["lost"] == 0
        # the heartbeat interval bounds how long a delta can lag
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            kids = tr.children()
            if kids and sum(h["count"] for n, h in tr.hists().items()
                            if "/echo" in n) >= 30:
                break
            time.sleep(0.05)
        kids = tr.children()
        assert kids, "no worker shipped a trace delta"
        assert sum(k["events_total"] for k in kids.values()) >= 30
        hists = tr.hists()
        assert any(n.startswith("w") and n.endswith("/echo")
                   for n in hists)
        assert sum(h["count"] for n, h in hists.items()
                   if "/echo" in n) == 30
        doc = tr.to_chrome_trace("pool")
        pids = {e["pid"] for e in doc["traceEvents"]}
        assert len(pids) >= 1 + len(kids)
        names = {e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("name") == "process_name"}
        assert any(n.startswith(f"{pqs.pool.name}-w") for n in names)
        # request timelines span admission -> worker -> reply
        assert any(
            {"admit", "worker_recv", "worker_done", "reply"} <=
            {h.get("hop") for h in hops}
            for _, _, _, hops, _ in tr.requests())
        wc = tr.summary()["workers"][pqs.pool.name]
        assert wc["spawn"] == 2 and wc["ready"] == 2
        assert set(tr.summary()["children"]) == {str(w) for w in kids}
    finally:
        pqs.close()
    assert tr.summary()["workers"][pqs.pool.name]["drain_stop"] == 2


# -- across the packages ------------------------------------------------------

def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 8)).astype(np.float32)
            for _ in range(n)]


def _client_run(pkg, port, frames):
    """`appsrc ! tensor_query_client ! tensor_sink` of one package
    against the server at `port` → the results in pts order."""
    nns = {"port": tnns, "jax": jnns}[pkg]
    Buffer = {"port": TensorBuffer, "jax": JBuffer}[pkg]
    pipe = nns.parse_launch(
        f"appsrc name=src dims=8:1 types=float32 ! tensor_query_client "
        f"port={port} timeout=30 ! tensor_sink name=out")
    runner = nns.PipelineRunner(pipe).start()
    for i, x in enumerate(frames):
        pipe.get("src").push(Buffer.of(x, pts=i))
    pipe.get("src").end()
    runner.wait(60)
    runner.stop()
    return pipe.get("out").results


@pytest.mark.parametrize("client,server", [("port", "jax"),
                                           ("jax", "port")])
def test_client_of_one_package_against_the_others_pool(client, server):
    frames = _frames(6, seed=3)
    Pooled = {"port": PooledQueryServer, "jax": JPooled}[server]
    alive = {"port": proc_alive, "jax": jproc_alive}[server]
    pqs = Pooled.echo(workers=2, service_ms=1.0, sid=next(_sid))
    try:
        res = _client_run(client, pqs.port, frames)
        assert [r.pts for r in res] == list(range(len(frames)))
        for r, x in zip(res, frames):
            np.testing.assert_array_equal(np.asarray(r.tensors[0]), x)
            assert "client_id" not in r.meta
        c = pqs.admission_counters()
        assert c["replied"] == len(frames) and _conserved(c)
    finally:
        pids = pqs.pool.all_pids_ever()
        pqs.close()
    assert not any(alive(p) for p in pids)

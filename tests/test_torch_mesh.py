"""The serving mesh on the port (nnstreamer_tpu_torch/serving/mesh.py and
the mesh half of traffic/loadgen.py) against the JAX package's, on the
CPU: JAX `tests/test_mesh.py`'s `TestMeshBasics`, `TestLeaseFailover`,
`TestBusyReroute`, `TestMeshSwap` and `TestMeshHarness` on the port, then
the cross-package cases — a JAX host joining the port's router and a port
host joining JAX's — `peek_pts` and the arrival processes against JAX's,
and a live router's `stats()` rendered by both packages' exposition.

The JAX tests' properties, not their timings: nothing lost, both
admission invariants at the router, Σ per-host replies = the router's,
one trace_id across a cross-host redelivery, epoch semantics. Faults
land on observed state (a host with frames in flight), every wait is a
deadline loop, and no assertion reads the wall clock. The N30 case
repeats the heal drill in one run: one rejoin per heal, nothing dialed
after stop.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.edge import QueryServer as JQueryServer
from nnstreamer_tpu.edge.wire import encode_buffer as jencode
from nnstreamer_tpu.edge.wire import peek_pts as jpeek
from nnstreamer_tpu.serving import mesh as jmesh
from nnstreamer_tpu.serving import metrics as jmetrics
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu.traffic import EchoServer as JEcho
from nnstreamer_tpu.traffic import loadgen as jload
from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.edge import QueryServer
from nnstreamer_tpu_torch.edge.wire import encode_buffer, peek_pts
from nnstreamer_tpu_torch.runtime.sync import forced_sync_count
from nnstreamer_tpu_torch.serving import metrics as tmetrics
from nnstreamer_tpu_torch.serving.mesh import HostAgent, MeshRouter
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.traffic import ChaosProxy, EchoServer
from nnstreamer_tpu_torch.traffic import loadgen as tload
from nnstreamer_tpu_torch.traffic.loadgen import (
    conservation_ok, poisson_arrivals, run_open_loop)

_sid = itertools.count(8800)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _until(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _router(**kw) -> MeshRouter:
    kw.setdefault("sid", next(_sid))
    kw.setdefault("dims", "8:1")
    kw.setdefault("types", "float32")
    return MeshRouter(**kw)


def _join_echo(router_port, name, *, service_ms=5.0, reconnect=True,
               **echo_kw):
    """EchoServer + a HostAgent registering it with the router at
    `router_port` (a router's or a chaos proxy's). → (echo, agent)."""
    echo = EchoServer(service_ms=service_ms, **echo_kw)
    agent = HostAgent(
        "127.0.0.1", router_port, name=name, local_port=echo.port,
        dims="8:1", types="float32",
        capacity_rps=1e3 / max(service_ms, 1e-3),
        connect_timeout_s=2.0, reconnect=reconnect).start()
    return echo, agent


def _flood(port, n, rate, *, seed=0, trace=True, depth_probe=None, **kw):
    x = np.zeros((8, 1), np.float32)
    return run_open_loop(
        "127.0.0.1", port, dims="8:1", types="float32",
        arrivals=poisson_arrivals(rate, n, np.random.default_rng(seed)),
        make_frame=lambda i: TensorBuffer.of(x, pts=i),
        depth_probe=depth_probe, trace=trace, **kw)


def _stop_all(*objs):
    for o in objs:
        if o is None:
            continue
        for meth in ("stop", "close"):
            fn = getattr(o, meth, None)
            if fn is not None:
                fn()
                break


def _blackhole_when_busy(router, host, proxy, timeout_s=20.0):
    """Blackhole `proxy` once `host` holds a frame in flight (so the fence
    has something to re-offer), from a thread. → the thread."""
    def watch():
        def busy():
            return any(h["host"] == host and h["outstanding"] > 0
                       for h in router.stats()["hosts"])
        if _until(busy, timeout_s):
            proxy.blackhole()

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    return t


# -- registration + routing --------------------------------------------------

@pytest.fixture(scope="module")
def two_hosts():
    """One flood of 60 frames over two echo hosts; the cases read it."""
    router = _router()
    ha = hb = aa = ab = None
    try:
        ha, aa = _join_echo(router.port, "hA")
        hb, ab = _join_echo(router.port, "hB")
        assert router.wait_hosts(2, timeout_s=10)
        syncs = forced_sync_count()
        r = _flood(router.port, 60, 200.0, depth_probe=router.depth_probe)
        yield {"router": router, "report": r, "stats": router.stats(),
               "syncs": forced_sync_count() - syncs}
    finally:
        _stop_all(aa, ab, ha, hb, router)
        QueryServer.reset_all()


class TestMeshBasics:
    def test_two_hosts_conserve_and_split_load(self, two_hosts):
        r, st = two_hosts["report"], two_hosts["stats"]
        assert r["completed"] == 60 and r["lost"] == 0
        assert r["rejected"] == 0
        c = st["admission"]
        assert conservation_ok(c)
        per_host = {h["host"]: h["replied"] for h in st["hosts"]}
        # both hosts served, and the per-host ledger sums exactly
        # to the router's replied count (cross-host conservation)
        assert set(per_host) == {"hA", "hB"}
        assert all(v > 0 for v in per_host.values())
        assert sum(per_host.values()) == c["replied"]

    def test_router_forces_no_sync(self, two_hosts):
        # the router's frames are host arrays: its pts=rid re-encode
        # and its replies bring nothing from a device
        assert two_hosts["syncs"] == 0

    def test_exposition_of_live_stats_equals_jax(self, two_hosts):
        st = two_hosts["stats"]
        port = tmetrics.render_prometheus(tmetrics.metrics_snapshot(
            admission=st["admission"], mesh=st))
        ref = jmetrics.render_prometheus(jmetrics.metrics_snapshot(
            admission=st["admission"], mesh=st))
        assert port == ref
        assert 'nns_host_replied_total{host="hA"}' in port

    def test_incompatible_host_caps_refused(self):
        router = _router(dims="8:1", types="float32")
        echo = agent = None
        try:
            echo = EchoServer(dims="4:1", service_ms=1.0)
            agent = HostAgent(
                "127.0.0.1", router.port, name="wrong",
                local_port=echo.port, dims="4:1", types="float32",
                reconnect=False)
            with pytest.raises(StreamError, match="no REGISTER_ACK"):
                agent.start(timeout_s=2.0)
            assert router.ready_hosts() == 0
        finally:
            _stop_all(agent, echo, router)
            QueryServer.reset_all()

    def test_wait_hosts_times_out_without_hosts(self):
        router = _router()
        try:
            assert not router.wait_hosts(1, timeout_s=0.2)
        finally:
            router.close()
            QueryServer.reset_all()

    def test_reregistration_replaces_incarnation_keeps_counters(self):
        router = _router()
        echo = a1 = a2 = None
        try:
            # reconnect=False: when a2 replaces this incarnation the
            # fenced a1 must not re-register and flap the name back
            echo, a1 = _join_echo(router.port, "hA", reconnect=False)
            assert router.wait_hosts(1, timeout_s=10)
            r = _flood(router.port, 10, 100.0, trace=False)
            assert r["completed"] == 10
            replied_before = router.stats()["hosts"][0]["replied"]
            assert replied_before == 10
            # same name, new connection: the old incarnation is fenced
            # and its monotone counters carry over
            a2 = HostAgent(
                "127.0.0.1", router.port, name="hA",
                local_port=echo.port, dims="8:1", types="float32").start()
            assert router.wait_hosts(1, timeout_s=10)
            st = router.stats()
            assert st["mesh"]["ready"] == 1
            assert st["hosts"][0]["replied"] == replied_before
            kinds = [(h, k) for _, h, k, _ in router.events]
            assert ("hA", "fence") in kinds
        finally:
            _stop_all(a1, a2, echo, router)
            QueryServer.reset_all()


# -- lease liveness + cross-host failover ------------------------------------

class TestLeaseFailover:
    def test_blackhole_fences_reoffers_and_keeps_one_trace(self):
        """Two hosts, one blackholed mid-flood while it holds frames:
        zero lost, conservation exact across hosts, the lease (not a
        connection event) fences it, and a redelivered frame's single
        trace shows BOTH hosts."""
        router = _router(lease_s=0.6, max_redeliver=2)
        proxy = ha = hb = aa = ab = None
        try:
            proxy = ChaosProxy("127.0.0.1", router.port, seed=3)
            ha, aa = _join_echo(proxy.port, "hA", service_ms=60.0)
            hb, ab = _join_echo(router.port, "hB", service_ms=5.0)
            assert router.wait_hosts(2, timeout_s=10)
            _blackhole_when_busy(router, "hA", proxy)
            r = _flood(router.port, 40, 120.0, drain_timeout_s=30.0,
                       depth_probe=router.depth_probe)
            assert r["completed"] == 40 and r["lost"] == 0
            assert conservation_ok(router.admission_counters())
            fences = [(h, d) for _, h, k, d in router.events
                      if k == "fence"]
            assert fences[:1] == [("hA", "lease_expired")]
            assert router.reoffered >= 1
            # the cross-host story: one trace id, both hosts on it
            ex = r.get("redelivered_examples") or []
            assert ex, "no redelivered frame carried a trace"
            assert ex[0]["hosts"] == ["hA", "hB"]
            assert len(ex[0]["trace_id"]) == 16
            st = router.stats()
            assert sum(h["replied"] for h in st["hosts"]) == \
                st["admission"]["replied"]
        finally:
            _stop_all(aa, ab, proxy, ha, hb, router)
            QueryServer.reset_all()

    def test_heal_lets_the_host_rejoin(self):
        router = _router(lease_s=0.5)
        proxy = echo = agent = None
        try:
            proxy = ChaosProxy("127.0.0.1", router.port, seed=1)
            echo, agent = _join_echo(proxy.port, "hA")
            assert router.wait_hosts(1, timeout_s=10)
            proxy.blackhole()
            assert _until(lambda: router.ready_hosts() == 0), \
                "partition never detected"
            proxy.heal()
            # the agent's reconnect loop re-dials through the healed
            # proxy and re-registers under the same name
            assert router.wait_hosts(1, timeout_s=10), \
                "host never rejoined after heal"
            st = router.stats()["hosts"][0]
            assert st["state"] == "READY" and st["host"] == "hA"
        finally:
            _stop_all(agent, proxy, echo, router)
            QueryServer.reset_all()

    def test_heal_repeated_rejoins_once_each_and_stops_clean(self):
        """N30: one rejoin per heal (the close of the local leg a rejoin
        replaced schedules nothing), nothing dialed after stop(), and the
        proxy's close joins every route."""
        rounds = 3
        router = _router(lease_s=0.3)
        proxy = echo = agent = None
        try:
            proxy = ChaosProxy("127.0.0.1", router.port, seed=1)
            echo, agent = _join_echo(proxy.port, "hA")
            assert router.wait_hosts(1, timeout_s=10)
            for k in range(rounds):
                legs = (agent._local, agent._router)
                proxy.blackhole()
                assert _until(lambda: router.ready_hosts() == 0)
                proxy.heal()
                assert router.wait_hosts(1, timeout_s=10), f"round {k}"
                assert _until(lambda: not agent._reconnector.is_alive())
                # a replaced leg's close (however late) rejoins nothing
                for leg in legs:
                    agent._leg_closed(leg)
                assert not agent._reconnector.is_alive()
                r = _flood(router.port, 4, 200.0, seed=k, trace=False)
                assert r["completed"] == 4 and r["lost"] == 0
            events = [(k, d) for _, h, k, d in router.events if h == "hA"]
            assert events == [("register", "")] + [
                ("fence", "lease_expired"), ("register", "")] * rounds
            agent.stop()
            rejoin = agent._reconnector
            assert not rejoin.is_alive()
            agent._schedule_reconnect()
            assert agent._reconnector is rejoin
            with pytest.raises(StreamError, match="stopped"):
                agent._connect()
            assert agent._local is None and agent._router is None
            conns = proxy.stats()["conns"]
            proxy.close()
            assert proxy.stats()["conns"] == conns
            assert not any(t.is_alive() for r in proxy._routes
                           for t in r.threads)
            assert conservation_ok(router.admission_counters())
        finally:
            _stop_all(agent, proxy, echo, router)
            QueryServer.reset_all()

    def test_shed_when_no_alternative_host(self):
        """One host, fenced with frames in flight, nothing to re-offer
        to: frames come back as typed BUSY(host_lost) — counted, never
        lost."""
        router = _router(lease_s=0.5, max_redeliver=2)
        proxy = echo = agent = None
        try:
            proxy = ChaosProxy("127.0.0.1", router.port, seed=2)
            echo, agent = _join_echo(proxy.port, "only", service_ms=80.0)
            assert router.wait_hosts(1, timeout_s=10)
            _blackhole_when_busy(router, "only", proxy)
            r = _flood(router.port, 12, 80.0, drain_timeout_s=20.0)
            assert r["lost"] == 0
            assert r["completed"] + r["rejected"] == 12
            assert r["rejected"] > 0
            assert r["busy_causes"].get("host_lost", 0) > 0
            c = router.admission_counters()
            assert conservation_ok(c)
            assert c["shed"].get("host_lost", 0) > 0
        finally:
            _stop_all(agent, proxy, echo, router)
            QueryServer.reset_all()


# -- typed-BUSY retry to a different host ------------------------------------

class TestBusyReroute:
    def test_host_busy_retries_on_sibling(self):
        # hA advertises a high capacity but its admission plane is
        # 1-deep and slow — the honest least-outstanding router keeps
        # offering it frames it refuses. Every typed BUSY must be
        # absorbed by re-offering to hB: the client sees zero
        # rejections.
        router = _router(busy_retry=2)
        ha = hb = aa = ab = None
        try:
            ha = EchoServer(service_ms=50.0, max_pending=1,
                            max_inflight=1)
            aa = HostAgent(
                "127.0.0.1", router.port, name="hA",
                local_port=ha.port, dims="8:1", types="float32",
                capacity_rps=500.0).start()   # the lie under test
            hb, ab = _join_echo(router.port, "hB", service_ms=5.0,
                                max_pending=64)
            assert router.wait_hosts(2, timeout_s=10)
            r = _flood(router.port, 30, 150.0, drain_timeout_s=20.0)
            assert r["completed"] == 30 and r["lost"] == 0
            assert r["rejected"] == 0
            st = router.stats()
            assert st["mesh"]["busy_reroutes"] >= 1, \
                "no BUSY ever rerouted — the fixture is vacuous"
            assert conservation_ok(router.admission_counters())
        finally:
            _stop_all(aa, ab, ha, hb, router)
            QueryServer.reset_all()


# -- two-phase swap ----------------------------------------------------------

class _SwapHost:
    """EchoServer + agent with a scriptable on_swap hook."""

    def __init__(self, router, name, results=None):
        self.calls = []
        self.results = dict(results or {})
        self.echo = EchoServer(service_ms=1.0)
        # reconnect=False: a host fenced by a failed commit must STAY
        # fenced for the assertion, not quietly re-register
        self.agent = HostAgent(
            "127.0.0.1", router.port, name=name,
            local_port=self.echo.port, dims="8:1", types="float32",
            versions={"m": [0]}, on_swap=self._on_swap,
            reconnect=False).start()

    def _on_swap(self, phase, model, version):
        self.calls.append((phase, model, version))
        return self.results.get(phase, True)

    def stop(self):
        self.agent.stop()
        self.echo.stop()


class TestMeshSwap:
    def test_commit_bumps_epoch_on_all_ok(self):
        router = _router()
        a = b = None
        try:
            a = _SwapHost(router, "hA")
            b = _SwapHost(router, "hB")
            assert router.wait_hosts(2, timeout_s=10)
            rep = router.swap("m", 1, timeout_s=10)
            assert rep["ok"], rep
            assert rep["epoch"] == 1 and router.epoch == 1
            for h in (a, b):
                phases = [p for p, _, _ in h.calls]
                assert phases == ["prepare", "commit"]
                assert h.agent.versions["m"] == [0, 1]
            st = router.stats()
            assert all(1 in h["versions"]["m"] for h in st["hosts"])
            assert st["mesh"]["epoch"] == 1
        finally:
            _stop_all(a, b, router)
            QueryServer.reset_all()

    def test_prepare_failure_aborts_everywhere_nobody_fenced(self):
        router = _router()
        a = b = None
        try:
            a = _SwapHost(router, "hA")
            b = _SwapHost(router, "hB",
                          results={"prepare": (False, "no space")})
            assert router.wait_hosts(2, timeout_s=10)
            rep = router.swap("m", 1, timeout_s=10)
            assert not rep["ok"]
            assert rep["hosts"]["hB"]["error"] == "no space"
            assert router.epoch == 0
            # all-or-none: the healthy host saw prepare then abort,
            # never commit — and stays READY
            assert [p for p, _, _ in a.calls] == ["prepare", "abort"]
            assert router.ready_hosts() == 2
        finally:
            _stop_all(a, b, router)
            QueryServer.reset_all()

    def test_commit_failure_fences_the_divergent_host(self):
        router = _router()
        a = b = None
        try:
            a = _SwapHost(router, "hA")
            b = _SwapHost(router, "hB",
                          results={"commit": (False, "load failed")})
            assert router.wait_hosts(2, timeout_s=10)
            rep = router.swap("m", 1, timeout_s=10)
            assert not rep["ok"]
            assert router.epoch == 0, \
                "epoch must not move on a failed commit"
            # the host that acked prepare but failed commit would be
            # serving a different version than its siblings: fenced
            st = {h["host"]: h for h in router.stats()["hosts"]}
            assert st["hB"]["state"] == "FENCED"
            assert st["hB"]["fence_cause"] == "swap_commit_failed"
            assert st["hA"]["state"] == "READY"
        finally:
            _stop_all(a, b, router)
            QueryServer.reset_all()

    def test_swap_without_hosts_keeps_the_epoch(self):
        router = _router()
        try:
            rep = router.swap("m", 1, timeout_s=1)
            assert rep == {"ok": False, "error": "no ready hosts",
                           "epoch": 0}
        finally:
            router.close()
            QueryServer.reset_all()


# -- the chaos harness over real pool hosts ----------------------------------

class TestMeshHarness:
    def test_pool_blackhole_smoke(self, caplog):
        """2 subprocess pool hosts behind one router, one blackholed
        mid-flood: everything the full flood gates on, at a size that
        fits the tier-1 clock. N31: the two same-named pools of one
        process each get their own shm rings (no pipe fallback)."""
        from nnstreamer_tpu_torch.traffic import run_against_mesh

        caplog.set_level("WARNING")
        r = run_against_mesh(hosts=2, workers_per_host=1, n=40,
                             service_ms=10.0, load_x=1.2, seed=0,
                             lease_s=0.8, max_redeliver=2)
        assert r["lost"] == 0 and r["conserved"]
        assert r["completed"] + r["rejected"] == 40
        # the lease fenced the partitioned host after the blackhole
        assert r["fence_detect_s"] is not None
        assert r["perhost_replied_sum"] == r["admission"]["replied"]
        assert r["orphans"] == []
        ex = r.get("redelivered_examples") or []
        assert ex and len(ex[0]["hosts"]) == 2, \
            "no frame was redelivered across hosts with one trace id"
        assert len({e["trace_id"] for e in ex}) == len(ex)
        assert "shm ring create failed" not in caplog.text


# -- the port against the JAX package ----------------------------------------

def test_cross_package_hosts_and_routers():
    """A JAX host (HostAgent + EchoServer) joins the port's router, and a
    port host joins JAX's router: one wire, each flood conserved."""
    j_echo = j_agent = t_router = None
    t_echo = t_agent = j_router = None
    try:
        t_router = _router()
        j_echo = JEcho(service_ms=2.0)
        j_agent = jmesh.HostAgent(
            "127.0.0.1", t_router.port, name="jax-host",
            local_port=j_echo.port, dims="8:1", types="float32",
            capacity_rps=500.0, connect_timeout_s=2.0).start()
        assert t_router.wait_hosts(1, timeout_s=10)
        r = _flood(t_router.port, 20, 200.0, trace=False)
        assert r["completed"] == 20 and r["lost"] == 0
        c = t_router.admission_counters()
        assert conservation_ok(c)
        assert t_router.stats()["hosts"][0]["replied"] == c["replied"]

        j_router = jmesh.MeshRouter(sid=next(_sid), dims="8:1",
                                    types="float32")
        t_echo, t_agent = _join_echo(j_router.port, "port-host",
                                     service_ms=2.0)
        assert j_router.wait_hosts(1, timeout_s=10)
        r = _flood(j_router.port, 20, 200.0, trace=False)
        assert r["completed"] == 20 and r["lost"] == 0
        c = j_router.admission_counters()
        assert conservation_ok(c)
        assert j_router.stats()["hosts"][0]["replied"] == c["replied"]
    finally:
        _stop_all(j_agent, t_agent, j_echo, t_echo, t_router, j_router)
        QueryServer.reset_all()
        JQueryServer.reset_all()


def test_peek_pts_matches_jax_on_random_frames():
    rng = np.random.default_rng(7)
    for i in range(40):
        pts = None if i % 5 == 0 else int(rng.integers(0, 2 ** 62))
        x = rng.standard_normal(int(rng.integers(1, 9))).astype(np.float32)
        frame = encode_buffer(TensorBuffer.of(x, pts=pts))
        assert frame == jencode(JBuf.of(x, pts=pts))
        assert peek_pts(frame) == jpeek(frame) == pts
        cut = frame[:int(rng.integers(0, 24))]
        assert peek_pts(cut) == jpeek(cut)
        junk = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        assert peek_pts(junk) == jpeek(junk)


@pytest.mark.parametrize("seed", [0, 3])
def test_arrivals_match_jax(seed):
    def both(fn_t, fn_j, *a, **kw):
        got = fn_t(*a, rng=np.random.default_rng(seed), **kw)
        ref = fn_j(*a, rng=np.random.default_rng(seed), **kw)
        np.testing.assert_array_equal(got, ref)
        return got

    t = both(tload.poisson_arrivals, jload.poisson_arrivals, 120.0, 64)
    assert len(t) == 64 and np.all(np.diff(t) > 0)
    both(tload.bursty_arrivals, jload.bursty_arrivals, 64,
         rate_high_hz=300.0, rate_low_hz=20.0)
    for pattern in ("poisson", "bursty"):
        np.testing.assert_array_equal(
            tload._arrivals_for(pattern, 80.0, 32,
                                np.random.default_rng(seed)),
            jload._arrivals_for(pattern, 80.0, 32,
                                np.random.default_rng(seed)))
    with pytest.raises(ValueError):
        tload._arrivals_for("diurnal", 80.0, 4, np.random.default_rng(0))

"""Tenancy and admission on the port (nnstreamer_tpu_torch:
serving/tenancy.py, traffic/admission.py, models/probe.py) against the
JAX package's, on the CPU.

- Tenant names, tables, weighted-fair admission, the policy-change
  purges and the residency LRU: the JAX package's cases on the port's
  copies.
- The same scripted sequence of offers, gets, completions and
  reconfigurations, under one stand-in monotonic clock, fed to JAX's
  AdmissionQueue and to the port's: every decision (admitted, cause,
  victims, queue depth, retry-after) and every counter snapshot equal.
- ModelResidency over real torch backends (the probe models): eviction
  releases a backend's graphs and verdicts, and the next invoke is never
  wrong.
- ScalingController plans over the JAX tests' stub pool equal JAX's.
"""

import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.serving import tenancy as jten
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
from nnstreamer_tpu.traffic import admission as jadm
from nnstreamer_tpu.traffic.loadgen import _tenant_conservation_ok
from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
from nnstreamer_tpu_torch.serving.store import reset_store
from nnstreamer_tpu_torch.serving.tenancy import (
    CLASS_META, INVALID_CLASS, TENANT_META, ModelResidency,
    ScalingController, TenantClass, TenantTable, validate_tenant_name)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.traffic import admission as tadm
from nnstreamer_tpu_torch.traffic.admission import (
    DEADLINE_META, AdmissionQueue)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    reset_store()
    yield
    reset_store()
    torch.set_num_threads(threads)


def _buf(i, tenant=None, Buffer=TensorBuffer):
    b = Buffer.of(np.ones((8, 1), np.float32), pts=i)
    if tenant is not None:
        b = b.with_meta(**{TENANT_META: tenant})
    return b


def _table(**weights) -> TenantTable:
    return TenantTable([TenantClass(n, weight=w)
                        for n, w in weights.items()])


# -- tenant names / table -----------------------------------------------------

class TestTenantNames:
    def test_valid_charset(self):
        for name in ("a", "A-b_9", "x" * 64, "team-a", "0"):
            assert validate_tenant_name(name)

    def test_invalid_refused(self):
        for name in ("", "x" * 65, "a b", "a/b", "tenant!", "Ω", None,
                     42, "a\n"):
            assert not validate_tenant_name(name)
            assert jten.validate_tenant_name(name) is \
                validate_tenant_name(name)

    @pytest.mark.parametrize("kw", [
        dict(name="bad name"), dict(name="a", weight=0.0),
        dict(name="a", weight=float("nan")), dict(name="a", deadline_ms=0.0),
        dict(name="a", max_pending=0)])
    def test_tenant_class_validates_eagerly(self, kw):
        with pytest.raises(ValueError):
            TenantClass(**kw)
        with pytest.raises(ValueError):
            jten.TenantClass(**kw)


class TestTenantTable:
    SPEC = {"default": "team-a",
            "tenants": [
                {"name": "team-a", "weight": 2.0, "model": "m1"},
                {"name": "team-b", "model": "m2"},
                {"name": "team-c", "model": "m1"},
            ]}

    def test_from_dict_and_routing(self):
        t = TenantTable.from_dict(self.SPEC)
        assert t.class_of("team-b").name == "team-b"
        assert t.class_of("stranger").name == "team-a"
        assert t.class_of(None).name == "team-a"
        assert t.model_of("team-b") == "m2"
        assert t.model_of(None) == "m1"
        assert t.models() == ["m1", "m2"]
        t2 = TenantTable.from_dict(t.to_dict())
        assert sorted(t2.names()) == sorted(t.names())
        assert t.to_dict() == jten.TenantTable.from_dict(self.SPEC).to_dict()

    def test_duplicate_tenant_rejected(self):
        with pytest.raises(ValueError):
            TenantTable([TenantClass("a"), TenantClass("a")])


# -- weighted-fair admission --------------------------------------------------

class TestWFQAdmission:
    def _queue(self, table, **kw):
        kw.setdefault("max_pending", 64)
        q = AdmissionQueue(**kw)
        q.set_tenants(table)
        return q

    def test_dequeue_follows_weights(self):
        q = self._queue(_table(a=3.0, b=1.0))
        for i in range(12):
            assert q.offer(_buf(i, "a")).admitted
        for i in range(12, 18):
            assert q.offer(_buf(i, "b")).admitted
        order = []
        for _ in range(12):
            item = q.get(timeout=1.0)
            order.append(item.meta[CLASS_META])
            q.note_replied(cls=item.meta[CLASS_META])
        for k in (4, 8, 12):
            assert abs(order[:k].count("a") - 3 * k / 4) <= 1, order
        assert _tenant_conservation_ok(q.counters())

    def test_bad_tenant_refused_and_charged_to_invalid_class(self):
        q = self._queue(_table(a=1.0))
        d = q.offer(_buf(0, "not a name!"))
        assert not d.admitted and d.cause == "bad_tenant"
        c = q.counters()
        inv = c["classes"][INVALID_CLASS]
        assert inv["rejected"] == {"bad_tenant": 1}
        assert c["rejected"] == {"bad_tenant": 1}
        assert _tenant_conservation_ok(c)

    def test_over_share_sheds_own_class_only(self):
        q = self._queue(_table(a=1.0, b=1.0), max_pending=6,
                        shed_policy="reject-oldest")
        assert q.offer(_buf(0, "a")).admitted
        assert q.offer(_buf(1, "a")).admitted
        d = q.offer(_buf(2, "a"))
        assert d.admitted and [v.pts for v in d.victims] == [0]
        assert d.victim_cause == "tenant_over_share"
        assert q.offer(_buf(3, "b")).admitted
        c = q.counters()
        assert c["classes"]["b"]["shed"] == {}
        assert _tenant_conservation_ok(c)

    def test_global_full_never_displaces_another_class(self):
        t = TenantTable([TenantClass("a", max_pending=5),
                         TenantClass("b", max_pending=5)])
        q = self._queue(t, max_pending=2, shed_policy="reject-oldest")
        assert q.offer(_buf(0, "a")).admitted
        assert q.offer(_buf(1, "a")).admitted
        d = q.offer(_buf(2, "b"))
        assert not d.admitted and d.cause == "queue_full" and not d.victims
        assert _tenant_conservation_ok(q.counters())

    def test_sentinel_bypasses_admission(self):
        q = self._queue(_table(a=1.0))
        q.put_nowait(None)
        assert q.offer(_buf(0, "a")).admitted
        assert q.get(timeout=1.0) is None
        assert q.get(timeout=1.0).pts == 0
        c = q.counters()
        assert c["offered"] == 1 and c["admitted"] == 1


class TestConfigurePolicyChange:
    def test_switch_to_deadline_drop_purges_expired_legacy(self):
        q = AdmissionQueue(max_pending=8, shed_policy="reject-newest")
        for i in range(3):
            assert q.offer(_buf(i).with_meta(**{DEADLINE_META: 1.0})).admitted
        assert q.offer(_buf(3)).admitted
        time.sleep(0.01)
        victims = q.configure(shed_policy="deadline-drop")
        assert sorted(v.pts for v in victims) == [0, 1, 2]
        c = q.counters()
        assert c["shed"] == {"deadline": 3} and c["depth"] == 1

    def test_same_policy_reconfigure_is_noop(self):
        q = AdmissionQueue(max_pending=8, shed_policy="deadline-drop")
        assert q.offer(_buf(0).with_meta(**{DEADLINE_META: 1.0})).admitted
        time.sleep(0.01)
        assert q.configure(shed_policy="deadline-drop") == []
        assert q.configure(max_pending=16) == []
        assert q.counters()["depth"] == 1


# -- the same script through both packages' queues ---------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _tenant_table(mod):
    return mod.TenantTable([
        mod.TenantClass("a", weight=3.0, deadline_ms=40.0),
        mod.TenantClass("b", weight=1.0, max_pending=3),
        mod.TenantClass("c", weight=1.0)], default="c")


#: (op, args): offer (pts, tenant, deadline_ms or None), get, reply,
#: fail (cause), advance (seconds), configure (kwargs), shed (cause)
SCRIPT = (
    [("offer", (i, "a", None)) for i in range(5)]
    + [("offer", (5 + i, "b", 25.0)) for i in range(5)]
    + [("offer", (10, "zz", None)), ("offer", (11, "bad name", None)),
       ("advance", 0.01), ("get",), ("get",), ("reply",), ("advance", 0.02),
       ("reply",), ("get",), ("fail", "dispatch_error")]
    + [("offer", (20 + i, "c", None)) for i in range(6)]
    + [("advance", 0.05), ("configure", {"shed_policy": "deadline-drop"}),
       ("offer", (40, "a", 5.0)), ("advance", 0.01),
       ("offer", (41, "b", None)), ("get",), ("get",), ("reply",),
       ("advance", 0.003), ("reply",),
       ("configure", {"shed_policy": "reject-oldest", "max_pending": 4}),
       ("offer", (50, "c", None)), ("offer", (51, "c", None)),
       ("offer", (52, "a", None)), ("get",), ("advance", 0.004),
       ("reply",), ("offer", (53, "b", None)), ("shed", "shutdown"),
       ("offer", (60, "a", None))]
)


def _run_script(adm, ten, Buffer, tenancy: bool, policy: str):
    q = adm.AdmissionQueue(max_pending=8, max_inflight=12,
                           shed_policy=policy)
    if tenancy:
        q.set_tenants(_tenant_table(ten))
    log, taken = [], []
    for op in SCRIPT:
        kind = op[0]
        if kind == "offer":
            pts, tenant, dl = op[1]
            meta = {}
            if tenant is not None:
                meta["tenant"] = tenant
            if dl is not None:
                meta["deadline_ms"] = dl
            d = q.offer(Buffer.of(np.ones((8, 1), np.float32), pts=pts)
                        .with_meta(**meta), now=time.monotonic())
            log.append(("offer", d.admitted, d.cause, d.queue_depth,
                        round(d.retry_after_ms, 6),
                        [v.pts for v in d.victims if v is not None],
                        d.victim_cause))
        elif kind == "get":
            item = q.get(timeout=0)
            taken.append(item)
            log.append(("get", item.pts,
                        item.meta.get("_tenant_class")))
        elif kind == "reply":
            item = taken.pop(0)
            q.note_replied(cls=item.meta.get("_tenant_class"))
        elif kind == "fail":
            item = taken.pop(0)
            q.note_failed(op[1], cls=item.meta.get("_tenant_class"))
        elif kind == "advance":
            time.monotonic.t += op[1]
        elif kind == "configure":
            log.append(("configure", sorted(
                v.pts for v in q.configure(**op[1]) if v is not None)))
        elif kind == "shed":
            log.append(("shed", sorted(
                v.pts for v in q.shed_remaining(op[1]) if v is not None)))
        log.append(("counters", q.counters()))
    return log


@pytest.mark.parametrize("tenancy", [False, True], ids=["legacy", "tenants"])
@pytest.mark.parametrize("policy",
                         ["reject-newest", "reject-oldest", "deadline-drop"])
def test_admission_decides_as_jax(monkeypatch, tenancy, policy):
    runs = []
    for adm, ten, Buffer in ((jadm, jten, JBuffer),
                             (tadm, __import__(
                                 "nnstreamer_tpu_torch.serving.tenancy",
                                 fromlist=["x"]), TensorBuffer)):
        monkeypatch.setattr(time, "monotonic", _Clock())
        runs.append(_run_script(adm, ten, Buffer, tenancy, policy))
    theirs, ours = runs
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a == b, (i, SCRIPT[min(i // 2, len(SCRIPT) - 1)], a, b)
    assert any(e[0] == "offer" and not e[1] for e in ours)


# -- model residency (LRU) ----------------------------------------------------

class _FakeBackend:
    def __init__(self, nbytes=100):
        self.entries = 0
        self.nbytes = nbytes
        self._full_bytes = nbytes
        self.released = 0

    def compile(self, n=2):
        self.entries = n
        self.nbytes = self._full_bytes

    def jit_cache_size(self):
        return self.entries

    def resident_bytes(self):
        return self.nbytes

    def release_compiled(self):
        n, self.entries = self.entries, 0
        self.nbytes = 0
        self.released += 1
        return n


class TestModelResidency:
    def test_lru_evicts_coldest_not_current(self):
        r = ModelResidency(max_models=2)
        backends = {}
        for name in ("a", "b", "c"):
            backends[name] = _FakeBackend()
            r.register(name, backends[name])
        for name in ("a", "b"):
            backends[name].compile()
            r.touch(name)
        backends["c"].compile()
        assert r.touch("c") == ["a"]
        assert backends["a"].entries == 0 and backends["a"].released == 1
        st = r.stats()
        assert st["jit_evictions"] == 1 and st["entries_evicted"] == 2
        backends["a"].compile()
        assert r.touch("a") == ["b"]

    def test_bytes_bound_and_unbounded(self):
        r = ModelResidency(max_bytes=250)
        for name in ("a", "b", "c"):
            be = _FakeBackend(nbytes=100)
            r.register(name, be)
            be.compile()
        assert r.touch("c") == ["a"]
        r = ModelResidency()
        for i in range(5):
            be = _FakeBackend()
            r.register(f"m{i}", be)
            be.compile()
            assert r.touch(f"m{i}") == []

    def test_real_backends_evict_and_serve_right(self):
        """Three probe models on torch backends, room for one with live
        builds: each switch evicts the previous one's verdicts, and every
        answer stays the model's own arithmetic."""
        want = {"probe_scale": lambda x: x * 2.0,
                "probe_negate": lambda x: -x,
                "probe_offset": lambda x: x + 10.0}
        r = ModelResidency(max_models=1)
        bes = {}
        for name in want:
            b = TorchBackend()
            b.open({"model": f"store://{name}", "accelerator": "cpu"})
            bes[name] = b
            r.register(name, b)
        x = np.arange(24, dtype=np.float32).reshape(3, 8, 1)
        try:
            for _round in range(2):
                for name, fn in want.items():
                    out = bes[name].invoke_batched((x,), 3,
                                                   keepdims=(False,))
                    np.testing.assert_array_equal(np.asarray(out[0]), fn(x))
                    r.touch(name)
                    assert bes[name].jit_cache_size() == 1
            st = r.stats()
            assert st["jit_evictions"] >= 5
            assert sum(b.jit_cache_size() for b in bes.values()) == 1
            assert all(b.resident_bytes() in (0, 4) for b in bes.values())
        finally:
            for b in bes.values():
                b.close()


# -- scaling controller -------------------------------------------------------

class _StubPool:
    def __init__(self, n=4):
        self.n = n
        self._b = {i: None for i in range(n)}
        self.calls = []

    @property
    def size(self):
        return self.n

    def bindings(self):
        return dict(self._b)

    def rebind(self, mapping, **kw):
        self.calls.append(dict(mapping))
        self._b.update(mapping)
        return {"ok": True}


class _StubTracer:
    def __init__(self, rates):
        self.rates = rates

    def tenant_summary(self):
        return {t: {"count": 10, "rate_hz": r, "p50_ms": 1.0,
                    "p99_ms": 2.0} for t, r in self.rates.items()}


RATES = [{"a": 30.0, "b": 10.0}, {"a": 30.0, "b": 10.0},
         {"a": 5.0, "b": 50.0}, {}, {"a": 1.0, "b": 1.0, "c": 9.0},
         {"a": 0.0, "b": 0.0}]


@pytest.mark.parametrize("slots", [2, 4, 7])
def test_scaling_plans_match_jax(slots):
    spec = {"tenants": [{"name": "a", "model": "m1"},
                        {"name": "b", "model": "m2"},
                        {"name": "c", "model": "m3"}]}
    logs = []
    for mod in (jten, __import__("nnstreamer_tpu_torch.serving.tenancy",
                                 fromlist=["x"])):
        pool = _StubPool(slots)
        ctrl = mod.ScalingController(pool, mod.TenantTable.from_dict(spec),
                                     _StubTracer({}), interval_s=999.0)
        ticks = []
        for rates in RATES:
            ctrl.tracer = _StubTracer(rates)
            ticks.append(ctrl.tick())
        logs.append((ticks, pool.calls, ctrl.stats()))
    assert logs[1][:2] == logs[0][:2]
    assert {k: logs[1][2][k] for k in ("decisions", "rebinds")} == \
        {k: logs[0][2][k] for k in ("decisions", "rebinds")}


class TestScalingController:
    def _ctrl(self, rates, n=4):
        table = TenantTable.from_dict({"tenants": [
            {"name": "a", "model": "m1"}, {"name": "b", "model": "m2"}]})
        pool = _StubPool(n)
        return ScalingController(pool, table, _StubTracer(rates),
                                 interval_s=999.0), pool

    def test_tick_allocates_slots_by_traffic(self):
        ctrl, pool = self._ctrl({"a": 30.0, "b": 10.0})
        assert ctrl.tick()
        counts = {}
        for m in pool.bindings().values():
            counts[m] = counts.get(m, 0) + 1
        assert counts == {"m1": 3, "m2": 1}

    def test_no_demand_no_decision(self):
        ctrl, pool = self._ctrl({})
        assert not ctrl.tick() and not pool.calls

    def test_start_stop_thread(self):
        ctrl, _ = self._ctrl({"a": 1.0})
        ctrl.start()
        t = ctrl._thread
        try:
            assert t is not None and t.daemon
        finally:
            ctrl.stop()
        assert not t.is_alive()

"""The SLO autotuner on the port (nnstreamer_tpu_torch/serving/autotune.py)
against the JAX package's, on the CPU: JAX `tests/test_autotune.py`'s
spec, guardrail, deadline, bucket, hints and observability cases, each
run on both packages under the same fake clock and sensors, with the
port's audit sequence and stats equal to JAX's; then `stage_bucket` on a
real port backend (the actuator the bucket stage calls).

JAX's `TestClosedLoopRamp` drives `traffic/loadgen.run_autotune_ramp`
on a live echo server: tests/test_torch_loadgen.py runs it on the port;
the live loop also runs under `serve --slo`
(tests/test_torch_serve_cli.py) and chip_smoke phase 45.
Every controller test drives tick() with an injected clock: no sleeps.
"""

import json

import numpy as np
import pytest
import torch

from nnstreamer_tpu.runtime import tracing as jtr
from nnstreamer_tpu.serving import autotune as ja
from nnstreamer_tpu.serving import metrics as jm
from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
from nnstreamer_tpu_torch.runtime import tracing as ttr
from nnstreamer_tpu_torch.serving import autotune as ta
from nnstreamer_tpu_torch.serving import metrics as tm
from nnstreamer_tpu_torch.serving.store import get_store, reset_store
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

pytestmark = pytest.mark.autotune

PKGS = {"port": (ta, ttr, tm), "jax": (ja, jtr, jm)}


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    reset_store()
    yield
    reset_store()
    torch.set_num_threads(threads)


# -- fakes (shared by both packages' controllers) -----------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeAdmission:
    def __init__(self, max_pending=64, ewma=None, depth=0,
                 depth_peak=0, shed_policy="reject-newest"):
        self.max_pending = max_pending
        self.ewma = ewma
        self.depth = depth
        self.depth_peak = depth_peak
        self.shed_policy = shed_policy
        self.configured = []
        self.victims_next = []

    def counters(self):
        return {"max_pending": self.max_pending,
                "ewma_reply_s": self.ewma,
                "depth": self.depth,
                "depth_peak": self.depth_peak,
                "shed_policy": self.shed_policy}

    def configure(self, max_pending=None, **kw):
        self.configured.append(max_pending)
        self.max_pending = max_pending
        v, self.victims_next = self.victims_next, []
        return v


class FakeProps(dict):
    def __init__(self, *a, events=None, **kw):
        super().__init__(*a, **kw)
        self.events = events if events is not None else []

    def __setitem__(self, k, v):
        self.events.append(("set", k, v))
        super().__setitem__(k, v)


class FakeBatch:
    def __init__(self, max_latency_ms=4.0, max_batch=16, stats=None,
                 events=None):
        self.name = "batch0"
        self.props = FakeProps(
            {"max_latency_ms": max_latency_ms, "max_batch": max_batch},
            events=events)
        self._stats = stats or {}

    def extra_stats(self):
        return dict(self._stats)


class FakeBackend:
    def __init__(self, hist, events=None):
        self.batch_size_hist = dict(hist)
        self.events = events if events is not None else []

    def stage_bucket(self, nb):
        self.events.append(("stage", nb))
        return True


class FakeFilter:
    def __init__(self, backend):
        self.backend = backend


class FakeTracer:
    active = True

    def __init__(self, p99_ms=None, tenant=None):
        self.p99_ms = p99_ms
        self.tenant = tenant or {}
        self.records = []

    def tenant_summary(self):
        return dict(self.tenant)

    def interlatency(self):
        if self.p99_ms is None:
            return {}
        return {"el": {"p99_ms": self.p99_ms}}

    def record_autotune(self, name, knob, t, **args):
        self.records.append((name, knob, dict(args)))


def _both(scenario):
    """Run `scenario(autotune_module)` for each package; the results
    (audit, stats, and whatever the scenario returns) must be equal —
    the same decisions in the same order."""
    out = {k: scenario(mods[0]) for k, mods in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def _settle(tuner):
    st = tuner.stats()
    return tuner.audit(), {k: v for k, v in st.items() if k != "name"}


# -- SLOSpec / KnobRange validation ------------------------------------------

class TestSLOSpecValidation:
    def test_roundtrip_and_accessors(self):
        d = {"p99_budget_ms": 90, "goodput_floor_rps": 50,
             "tenants": {"acme": {"p99_budget_ms": 50}, "free": 200},
             "knobs": {"max_pending": {"min": 4, "max": 256}}}
        spec = ta.SLOSpec.from_dict(d)
        assert spec.p99_budget_ms == 90.0
        assert spec.tenant_budget_ms("acme") == 50.0
        assert spec.tenant_budget_ms("free") == 200.0
        assert spec.tenant_budget_ms("unknown") == 90.0
        assert spec.knob_range("max_pending") == \
            ta.KnobRange("max_pending", 4.0, 256.0)
        assert spec.knob_range("max_batch") is \
            ta.DEFAULT_KNOB_RANGES["max_batch"]
        assert ta.SLOSpec.from_dict(spec.to_dict()) == spec
        assert spec.to_dict() == ja.SLOSpec.from_dict(d).to_dict()
        assert ta.LITTLE_MARGIN == ja.LITTLE_MARGIN
        assert {k: (r.lo, r.hi) for k, r in
                ta.DEFAULT_KNOB_RANGES.items()} == \
            {k: (r.lo, r.hi) for k, r in ja.DEFAULT_KNOB_RANGES.items()}

    def test_from_json(self, tmp_path):
        p = tmp_path / "slo.json"
        p.write_text(json.dumps({"p99_budget_ms": 25}))
        assert ta.SLOSpec.from_json(str(p)).p99_budget_ms == 25.0

    @pytest.mark.parametrize("d", [
        [], {}, {"p99_budget_ms": 0}, {"p99_budget_ms": -5},
        {"p99_budget_ms": float("nan")}, {"p99_budget_ms": float("inf")},
        {"p99_budget_ms": True}, {"p99_budget_ms": "90"},
        {"p99_budget_ms": 90, "goodput_floor_rps": -1},
        {"p99_budget_ms": 90, "tenants": ["acme"]},
        {"p99_budget_ms": 90, "tenants": {"bad name!": 50}},
        {"p99_budget_ms": 90, "tenants": {"acme": 0}},
        {"p99_budget_ms": 90, "tenants": {"acme": {}}},
        {"p99_budget_ms": 90, "knobs": {"warp_factor":
                                        {"min": 1, "max": 9}}},
        {"p99_budget_ms": 90, "knobs": {"max_pending": {"min": 8}}},
        {"p99_budget_ms": 90, "knobs": {"max_pending":
                                        {"min": 64, "max": 8}}},
    ])
    def test_malformed_specs_fail_eagerly_as_jax(self, d):
        with pytest.raises(ValueError) as te:
            ta.SLOSpec.from_dict(d)
        with pytest.raises(ValueError) as je:
            ja.SLOSpec.from_dict(d)
        assert str(te.value) == str(je.value)

    def test_knob_range_clamp(self):
        r = ta.KnobRange("max_pending", 4, 64)
        assert r.clamp(1) == 4 and r.clamp(999) == 64
        assert r.clamp(32) == 32
        with pytest.raises(ValueError, match="min 64.* max 8"):
            ta.KnobRange("max_pending", 64, 8)
        with pytest.raises(ValueError):
            ta.KnobRange("max_pending", float("nan"), 8)


# -- the guardrail ladder ------------------------------------------------------

def _tuner(m, adm, clock, slo=None, **kw):
    return m.AutoTuner(slo or m.SLOSpec(p99_budget_ms=60), admission=adm,
                       now=clock, **kw)


class TestGuardrails:
    def test_littles_law_convergence_then_hysteresis_hold(self):
        def sc(m):
            adm = FakeAdmission(max_pending=64, ewma=0.005)
            clock = FakeClock()
            tuner = _tuner(m, adm, clock)
            for _ in range(9):
                tuner.tick()
                clock.advance(10.0)
            return adm.configured, _settle(tuner)

        configured, (audit, st) = _both(sc)
        assert configured == [32, 16, 8, 6]
        assert st["decisions"]["max_pending"]["applied"] == 4
        assert st["decisions"]["max_pending"]["hysteresis"] >= 5
        assert [r["new"] for r in audit] == [32.0, 16.0, 8.0, 6.0]

    def test_hysteresis_bounds_flapping_sensor(self):
        def sc(m):
            adm = FakeAdmission(max_pending=6, ewma=0.0048)
            clock = FakeClock()
            tuner = _tuner(m, adm, clock)
            for i in range(20):
                adm.ewma = 0.0048 if i % 2 == 0 else 0.0052
                tuner.tick()
                clock.advance(10.0)
            return adm.configured, _settle(tuner)

        configured, (audit, st) = _both(sc)
        assert configured == [] and audit == []
        assert st["applied_total"] == 0
        assert st["decisions"]["max_pending"]["hysteresis"] == 20
        assert st["audit_total"] == 0

    def test_cooldown_blocks_back_to_back_moves(self):
        def sc(m):
            adm = FakeAdmission(max_pending=64, ewma=0.005)
            clock = FakeClock()
            tuner = _tuner(m, adm, clock, cooldown_s=5.0)
            seen = []
            for dt in (0.0, 1.0, 10.0):
                clock.advance(dt)
                tuner.tick()
                seen.append(list(adm.configured))
            return seen, _settle(tuner)

        seen, (_, st) = _both(sc)
        assert seen == [[32], [32], [32, 16]]
        assert st["decisions"]["max_pending"]["cooldown"] == 1

    def test_dry_run_applies_nothing(self):
        def sc(m):
            adm = FakeAdmission(max_pending=64, ewma=0.005)
            clock = FakeClock()
            tuner = _tuner(m, adm, clock, dry_run=True)
            for _ in range(4):
                tuner.tick()
                clock.advance(10.0)
            return adm.configured, adm.max_pending, _settle(tuner)

        configured, mp, (audit, st) = _both(sc)
        assert configured == [] and mp == 64
        assert st["dry_run"] is True
        assert st["applied_total"] == 0 and st["dry_run_total"] == 4
        assert all(r["outcome"] == "dry_run" for r in audit)

    def test_step_is_bounded_and_clamped_to_declared_range(self):
        def sc(m):
            adm = FakeAdmission(max_pending=64, ewma=10.0)
            clock = FakeClock()
            spec = m.SLOSpec.from_dict({
                "p99_budget_ms": 60,
                "knobs": {"max_pending": {"min": 16, "max": 128}}})
            tuner = _tuner(m, adm, clock, slo=spec)
            for _ in range(3):
                tuner.tick()
                clock.advance(10.0)
            return adm.configured, _settle(tuner)

        configured, _ = _both(sc)
        assert configured == [32, 16]

    def test_audit_ring_wraps_with_exact_accounting(self):
        def sc(m):
            adm = FakeAdmission(max_pending=64, ewma=0.02)
            clock = FakeClock()
            tuner = _tuner(m, adm, clock, cooldown_s=0.0, audit_size=4)
            for i in range(10):
                adm.ewma = 0.02 if i % 2 == 0 else 0.002
                tuner.tick()
                clock.advance(1.0)
            return adm.configured, _settle(tuner)

        configured, (audit, st) = _both(sc)
        assert len(configured) == 10
        assert (st["audit_total"], st["audit_len"],
                st["audit_dropped"]) == (10, 4, 6)
        assert st["decisions"]["max_pending"]["applied"] == 10
        assert [r["new"] for r in audit] == \
            [float(v) for v in configured[-4:]]

    def test_shrink_victims_routed_to_callback(self):
        def sc(m):
            adm = FakeAdmission(max_pending=64, ewma=0.005)
            adm.victims_next = ["v1", "v2"]
            got_victims, got_applied = [], []
            tuner = _tuner(m, adm, FakeClock(),
                           on_victims=got_victims.extend,
                           on_apply=got_applied.append)
            tuner.tick()
            return got_victims, got_applied

        victims, applied = _both(sc)
        assert victims == ["v1", "v2"]
        assert [r["knob"] for r in applied] == ["max_pending"]
        assert applied[0]["evidence"]["ewma_reply_s"] == 0.005

    def test_actuation_failure_is_an_error_outcome(self):
        class Broken(FakeAdmission):
            def configure(self, **kw):
                raise RuntimeError("boom")

        def sc(m):
            tuner = _tuner(m, Broken(max_pending=64, ewma=0.005),
                           FakeClock())
            tuner.tick()
            return _settle(tuner)

        audit, st = _both(sc)
        assert st["decisions"]["max_pending"]["error"] == 1
        assert audit[-1]["outcome"] == "error"


# -- batch deadline -----------------------------------------------------------

@pytest.mark.parametrize("p99,stats,cur,want", [
    (90.0, {}, 8.0, 4.0),                             # budget threatened
    (30.0, {"batches_out": 10, "occupancy_avg": 2.0}, 4.0, 6.0),
    (60.0, {"batches_out": 10, "occupancy_avg": 2.0}, 4.0, 4.0),  # band
    (None, {}, 4.0, 4.0),                             # no tracer signal
])
def test_batch_deadline_as_jax(p99, stats, cur, want):
    def sc(m):
        el = FakeBatch(max_latency_ms=cur, max_batch=16, stats=stats)
        tuner = m.AutoTuner(m.SLOSpec(p99_budget_ms=100),
                            batch_elements=(el,),
                            tracer=FakeTracer(p99_ms=p99)
                            if p99 is not None else None,
                            now=FakeClock())
        recs = tuner.tick()
        return el.props["max_latency_ms"], recs, _settle(tuner)

    got, recs, _ = _both(sc)
    assert got == want
    if got != cur:
        (rec,) = recs
        assert rec["knob"] == "batch_deadline_ms"
        assert rec["target"] == "batch0"
    else:
        assert recs == []


# -- bucket refinement --------------------------------------------------------

class TestBucketRefinement:
    def test_refines_to_observed_pow2_staging_before_flip(self):
        def sc(m):
            events = []
            el = FakeBatch(max_batch=16, events=events)
            be = FakeBackend({3: 50}, events=events)
            clock = FakeClock()
            tuner = m.AutoTuner(m.SLOSpec(p99_budget_ms=100),
                                batch_elements=(el,),
                                filters=(FakeFilter(be),), now=clock)
            tuner.tick()
            clock.advance(10.0)
            tuner.tick()
            clock.advance(10.0)
            last = tuner.tick()
            return events, el.props["max_batch"], last, _settle(tuner)

        events, mb, last, _ = _both(sc)
        assert events == [("stage", 8), ("set", "max_batch", 8),
                          ("stage", 4), ("set", "max_batch", 4)]
        assert mb == 4 and last == []

    @pytest.mark.parametrize("hist", [{32: 50}, {3: 7}])
    def test_shrink_only_and_needs_signal(self, hist):
        def sc(m):
            el = FakeBatch(max_batch=16)
            tuner = m.AutoTuner(m.SLOSpec(p99_budget_ms=100),
                                batch_elements=(el,),
                                filters=(FakeFilter(FakeBackend(hist)),),
                                now=FakeClock())
            return tuner.tick(), el.props["max_batch"]

        assert _both(sc) == ([], 16)


# -- advisory hints -----------------------------------------------------------

class TestHints:
    def test_scale_up_proposed_under_goodput_floor(self):
        def sc(m):
            adm = FakeAdmission(max_pending=8, ewma=0.1, depth=4,
                                depth_peak=8)
            clock = FakeClock()
            tuner = m.AutoTuner(
                m.SLOSpec(p99_budget_ms=1600, goodput_floor_rps=50),
                admission=adm, now=clock)
            first = [r for r in tuner.tick() if r["knob"] == "pool_slots"]
            clock.advance(10.0)
            second = [r for r in tuner.tick()
                      if r["knob"] == "pool_slots"]
            return first, second, adm.configured, _settle(tuner)

        first, second, configured, (_, st) = _both(sc)
        (rec,) = first
        assert rec["outcome"] == "proposed" and rec["new"] == "scale_up"
        assert second == [] and configured == []
        assert st["proposed_total"] == 1
        assert st["hints"] == {"pool_slots": "scale_up"}

    def test_shed_policy_proposed_when_budget_missed_at_saturation(self):
        def sc(m):
            adm = FakeAdmission(max_pending=8, ewma=None, depth=8,
                                depth_peak=8)
            tuner = m.AutoTuner(m.SLOSpec(p99_budget_ms=100),
                                admission=adm,
                                tracer=FakeTracer(p99_ms=150.0),
                                now=FakeClock())
            return tuner.tick(), adm.configured

        (rec,), configured = _both(sc)
        assert rec["knob"] == "shed_policy"
        assert rec["outcome"] == "proposed"
        assert (rec["old"], rec["new"]) == \
            ("reject-newest", "reject-oldest")
        assert configured == []


# -- tracer + metrics surfaces ------------------------------------------------

class TestObservability:
    def test_decisions_land_on_the_tracer(self):
        def sc(m, tr):
            adm = FakeAdmission(max_pending=64, ewma=0.005)
            tuner = m.AutoTuner(m.SLOSpec(p99_budget_ms=60),
                                admission=adm, tracer=tr, now=FakeClock())
            tuner.tick()
            return ([(n, k, a) for n, k, _t, a in tr.autotune_events()],
                    tr.autotune_counts(), tr.summary()["autotune"])

        got = sc(ta, ttr.Tracer())
        assert got == sc(ja, jtr.Tracer())
        events, counts, summ = got
        ((name, knob, args),) = events
        assert (name, knob) == ("autotune", "max_pending")
        assert args["outcome"] == "applied"
        assert (args["old"], args["new"]) == (64.0, 32.0)
        assert counts == summ == {"max_pending": {"applied": 1}}

    def test_tracer_ring_wraps_with_exact_counts(self):
        out = []
        for tr in (ttr.Tracer(), jtr.Tracer()):
            for i in range(1030):
                tr.record_autotune("autotune", "max_pending", float(i),
                                   old=1, new=2, outcome="applied")
            out.append((len(tr.autotune_events()), tr.autotune_counts()))
        assert out[0] == out[1] == \
            (1030 - 256, {"max_pending": {"applied": 1030}})

    def test_null_tracer_is_a_no_op(self):
        ttr.NULL_TRACER.record_autotune("autotune", "max_pending", 0.0,
                                        old=1, new=2, outcome="applied")
        assert ttr.NULL_TRACER.autotune_counts() == {}

    def test_metrics_snapshot_exports_autotune_series(self):
        texts = []
        for m, met in ((ta, tm), (ja, jm)):
            adm = FakeAdmission(max_pending=64, ewma=0.005)
            tuner = m.AutoTuner(m.SLOSpec(p99_budget_ms=60,
                                          goodput_floor_rps=10),
                                admission=adm, now=FakeClock())
            tuner.tick()
            series = met.metrics_snapshot(autotune=tuner.stats())
            texts.append(met.render_prometheus(series))
        assert texts[0] == texts[1]
        by_name = {s["name"]: s for s in tm.metrics_snapshot(
            autotune=_port_stats())}
        assert by_name["nns_autotune_applied_total"]["samples"] == \
            [({}, 1.0)]
        dec = by_name["nns_autotune_decisions_total"]["samples"]
        assert ({"knob": "max_pending", "outcome": "applied"}, 1.0) in dec
        knob = dict((lbl["knob"], v) for lbl, v in
                    by_name["nns_autotune_knob"]["samples"])
        assert knob["max_pending"] == 32.0
        assert by_name["nns_autotune_dry_run"]["samples"] == [({}, 0.0)]

    def test_metrics_snapshot_renders_before_any_decision(self):
        tuner = ta.AutoTuner(ta.SLOSpec(p99_budget_ms=60), now=FakeClock())
        series = tm.metrics_snapshot(autotune=tuner.stats())
        by_name = {s["name"]: s for s in series}
        assert by_name["nns_autotune_decisions_total"]["samples"] == \
            [({"knob": "none", "outcome": "none"}, 0.0)]
        tm.render_prometheus(series)


def _port_stats():
    adm = FakeAdmission(max_pending=64, ewma=0.005)
    tuner = ta.AutoTuner(ta.SLOSpec(p99_budget_ms=60), admission=adm,
                         now=FakeClock())
    tuner.tick()
    return tuner.stats()


# -- stage_bucket on a real port backend --------------------------------------

def _backend(model):
    b = TorchBackend()
    b.open({"model": model, "accelerator": "cpu"})
    b.set_input_info(TensorsSpec.from_strings("8:1", "float32"))
    return b


def test_stage_bucket_runs_and_registers_the_bucket():
    """Before any micro-batch there is no signature: False. After one
    batched invoke (n 3 → bucket 4), staging bucket 8 runs it once on
    zeros and registers it under invoke_batched's keys; the autotuner's
    bucket stage stages through it before it flips max_batch; a store
    handle's bucket lands on the entry's record (swap prewarm and the
    manifest replay it)."""
    b = _backend("zoo://probe_scale")
    assert b.stage_bucket(8) is False
    x = np.arange(24, dtype=np.float32).reshape(3, 8)
    out = b.invoke_batched((x,), 3)
    np.testing.assert_array_equal(out[0].numpy(), x * 2)
    assert ("dynb", 4, (4, 8)) in b.bucket_shapes
    assert b.stage_bucket(8) is True
    assert ("dynb", 8, (8, 8)) in b.bucket_shapes
    assert b.stage_bucket(3) is True           # next pow2: 4, served
    assert b.batch_size_hist == {3: 1}         # staging serves no frame

    get_store().register("st", "zoo://probe_scale?scale=3")
    s = _backend("store://st")
    s.invoke_batched((x,), 3)
    assert s.stage_bucket(2) is True
    entry = get_store().entry("st")
    ver = entry.resolve_version(None)
    assert ("dynb", 2, ((2, 8), "float32")) in entry.buckets(ver)

    events = []
    el = FakeBatch(max_batch=16, events=events)

    class Spy:
        def __init__(self, be):
            self.be = be
            self.batch_size_hist = {3: 50}

        def stage_bucket(self, nb):
            ok = self.be.stage_bucket(nb)
            events.append(("stage", nb, ok))
            return ok

    tuner = ta.AutoTuner(ta.SLOSpec(p99_budget_ms=100),
                         batch_elements=(el,),
                         filters=(FakeFilter(Spy(b)),), now=FakeClock())
    tuner.tick()
    assert events == [("stage", 8, True), ("set", "max_batch", 8)]


def test_stage_bucket_error_is_logged_and_false():
    """A model that refuses the batched shape: stage_bucket logs and
    returns False, and the bucket stays unstaged (the controller's
    contract, not a device fallback)."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle

    def fn(params, x):
        if x.shape[0] > 4:
            raise RuntimeError("no batches past 4")
        return x + 1

    b = _backend(ModelBundle(fn=fn, params={}, name="cap4"))
    x = np.ones((3, 8), np.float32)
    b.invoke_batched((x,), 3)
    assert b.stage_bucket(8) is False
    assert not any(k[:2] == ("dynb", 8) for k in b.bucket_shapes)

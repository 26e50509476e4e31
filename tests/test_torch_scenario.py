"""The scenario engine on the port (nnstreamer_tpu_torch/scenario/)
against the JAX package's, on the CPU.

The same specs and seeds give JAX's numbers exactly: validation errors,
the builtin catalog (`to_dict()`), `derive_seed` / `sub_seed`,
`compile_arrivals` for every builtin, the property checker's verdicts on
hand-built violating scrapes, and `shrink`'s minimal spec; a spec JSON
either package wrote loads in the other. Then live drills on echo worlds,
as JAX `tests/test_scenario.py` runs them: `smoke_pool` with all four
invariants and a matching replay, tenant classes scraped per class,
`kill_pool` (chaos), and the mesh drills (marked mesh and slow, as JAX's
`TestExecutorMesh`). A drill that fails mid-flood cancels its fault
timers and leaves no worker behind; `scenario shrink` of a passing spec
exits 1.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

import nnstreamer_tpu.scenario as jscn
from nnstreamer_tpu_torch.edge import QueryServer
from nnstreamer_tpu_torch.scenario import (
    ARRIVAL_KINDS, FAULT_KINDS, INVARIANTS, TOPOLOGY_KINDS,
    ArrivalProgram, FaultProgram, ScenarioSLO, ScenarioSpec,
    ShrinkBudgetExceeded, Topology, builtin_specs, check_result,
    check_scrape, compile_arrivals, derive_seed, replay_scenario,
    run_scenario, shrink)
from nnstreamer_tpu_torch.scenario import executor as texec
from nnstreamer_tpu_torch.serving.pool import proc_alive


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # pool children
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    QueryServer.reset_all()
    torch.set_num_threads(threads)


def _spec(mod=None, **kw):
    """JAX `tests/test_scenario.py`'s base spec, built by `mod`'s
    classes (the port's by default)."""
    m = mod or __import__("nnstreamer_tpu_torch.scenario",
                          fromlist=["x"])
    base = dict(
        name="t", seed=5,
        topology=m.Topology(kind="pool", workers=2, service_ms=2.0),
        arrivals=(m.ArrivalProgram(kind="constant", n=10, rate_x=0.5),))
    base.update(kw)
    return m.ScenarioSpec(**base)


# -- the spec -----------------------------------------------------------------

def test_catalog_constants_equal_jax():
    assert (ARRIVAL_KINDS, FAULT_KINDS, TOPOLOGY_KINDS, INVARIANTS) == \
        (jscn.ARRIVAL_KINDS, jscn.FAULT_KINDS, jscn.TOPOLOGY_KINDS,
         jscn.INVARIANTS)


@pytest.mark.parametrize("name", sorted(jscn.builtin_specs()))
def test_builtins_equal_jax(name):
    ours, theirs = builtin_specs()[name], jscn.builtin_specs()[name]
    assert ours.to_dict() == theirs.to_dict()
    assert ours.to_json() == theirs.to_json()
    assert ours.size() == theirs.size()
    assert ours.topology.capacity_rps == theirs.topology.capacity_rps
    assert list(builtin_specs()) == list(jscn.builtin_specs())


@pytest.mark.parametrize("name", sorted(jscn.builtin_specs()))
def test_json_loads_across_packages(name):
    theirs = jscn.builtin_specs()[name]
    ours = ScenarioSpec.from_json(theirs.to_json())
    assert ours == builtin_specs()[name]
    assert ours.to_json() == theirs.to_json()
    back = jscn.ScenarioSpec.from_json(ours.to_json(indent=None))
    assert back == theirs


@pytest.mark.parametrize("root,labels", [
    (7, ("arrival", "a0")), (7, ("fault", "f2")), (0, ()),
    (-3, ("netchaos",)), (2 ** 62, ("arrival", "flood", 3)),
    (1337, ("fault", "f0"))])
def test_derive_seed_equals_jax(root, labels):
    ours = derive_seed(root, *labels)
    assert ours == jscn.derive_seed(root, *labels)
    assert 0 <= ours < 2 ** 63
    spec = dataclasses.replace(builtin_specs()["composed_storm"],
                               seed=root)
    jspec = dataclasses.replace(jscn.builtin_specs()["composed_storm"],
                                seed=root)
    assert spec.sub_seed(*labels) == jspec.sub_seed(*labels) == ours


#: bad spec dicts, each refused by both packages with the same message
_BAD = {
    "arrival_kind": lambda d: d["arrivals"][0].update(kind="sawtooth"),
    "arrival_n": lambda d: d["arrivals"][0].update(n=0),
    "arrival_n_bool": lambda d: d["arrivals"][0].update(n=True),
    "arrival_rate": lambda d: d["arrivals"][0].update(rate_x=-1),
    "arrival_low_x": lambda d: d["arrivals"][0].update(low_x=1.5),
    "arrival_ramp_s": lambda d: d["arrivals"][0].update(ramp_s=0),
    "arrival_tenant": lambda d: d["arrivals"][0].update(tenant="9bad"),
    "arrival_typo": lambda d: d["arrivals"][0].update(typo_key=1),
    "arrivals_empty": lambda d: d.update(arrivals=[]),
    "arrivals_missing": lambda d: d.pop("arrivals"),
    "fault_kind": lambda d: d.update(faults=[{"kind": "meteor",
                                              "at_s": 0.1}]),
    "fault_at": lambda d: d.update(faults=[{"kind": "worker_kill",
                                            "at_s": -1}]),
    "fault_kills": lambda d: d.update(faults=[{"kind": "worker_kill",
                                               "at_s": 0, "kills": 0}]),
    "fault_host": lambda d: d.update(faults=[{"kind": "worker_kill",
                                              "at_s": 0, "host": 3}]),
    "net_fault_on_pool": lambda d: d.update(faults=[{"kind": "blackhole",
                                                     "at_s": 0.1}]),
    "swaps": lambda d: d.update(faults=[{"kind": "swap_storm",
                                         "at_s": 0, "swaps": 0}]),
    "flood_tenant": lambda d: d.update(faults=[{"kind": "tenant_flood",
                                                "at_s": 0, "n": 3}]),
    "flood_n": lambda d: d.update(faults=[{"kind": "tenant_flood",
                                           "at_s": 0, "tenant": "x"}]),
    "dup_labels": lambda d: d["arrivals"].append(dict(d["arrivals"][0])),
    "topology_kind": lambda d: d.update(topology={"kind": "cloud"}),
    "pool_hosts": lambda d: d.update(topology={"kind": "pool",
                                               "hosts": 2}),
    "shed_policy": lambda d: d.update(topology={"shed_policy": "drop"}),
    "max_redeliver": lambda d: d.update(topology={"max_redeliver": -1}),
    "tenant_cfg": lambda d: d.update(topology={"tenants": {"a": 3}}),
    "undeclared_tenant": lambda d: (
        d.update(topology={"tenants": {"paid": {}}}),
        d["arrivals"][0].update(tenant="ghost")),
    "slo_shed": lambda d: d.update(slo={"max_shed_rate": 2}),
    "slo_budget": lambda d: d.update(slo={"p99_budget_ms": 0}),
    "top_key": lambda d: d.update(extra=1),
    "no_seed": lambda d: d.pop("seed"),
    "seed_type": lambda d: d.update(seed="7"),
    "name": lambda d: d.update(name="has space"),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_validation_errors_equal_jax(case):
    d = json.loads(_spec().to_json())
    _BAD[case](d)
    with pytest.raises(ValueError) as ours:
        ScenarioSpec.from_dict(d)
    with pytest.raises(ValueError) as theirs:
        jscn.ScenarioSpec.from_dict(d)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError):
        ScenarioSpec.from_json("{not json")


def test_labels_by_position_and_size():
    spec = builtin_specs()["composed_storm"]
    assert [a.label for a in spec.arrivals] == ["a0", "a1"]
    assert [f.label for f in spec.faults] == ["f0", "f1", "f2"]
    one = _spec(faults=(FaultProgram(kind="worker_kill", at_s=0.1),))
    assert one.size() == 1 + 1 + 10
    assert spec.size() == jscn.builtin_specs()["composed_storm"].size()


# -- arrivals -----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jscn.builtin_specs()))
def test_compile_arrivals_equals_jax(name):
    a, o, seg = compile_arrivals(builtin_specs()[name])
    ja, jo, jseg = jscn.compile_arrivals(jscn.builtin_specs()[name])
    assert np.array_equal(a, ja) and o == jo and seg == jseg
    assert np.all(np.diff(a) >= 0)


def test_compile_arrivals_every_kind_equals_jax():
    def build(m):
        return m.ScenarioSpec(
            name="kinds", seed=31,
            topology=m.Topology(kind="pool", workers=2, service_ms=3.0,
                                tenants={"a": {}, "b": {"weight": 2.0}}),
            arrivals=tuple(
                m.ArrivalProgram(kind=k, n=25, rate_x=0.3, tenant="a"
                                 if i % 2 else None, start_s=0.1 * i)
                for i, k in enumerate(m.ARRIVAL_KINDS)),
            faults=(m.FaultProgram(kind="tenant_flood", at_s=0.2,
                                   tenant="b", n=15, rate_x=0.2),))
    a, o, seg = compile_arrivals(build(__import__(
        "nnstreamer_tpu_torch.scenario", fromlist=["x"])))
    ja, jo, jseg = jscn.compile_arrivals(build(jscn))
    assert np.array_equal(a, ja) and o == jo and seg == jseg
    assert len(a) == 25 * len(ARRIVAL_KINDS) + 15


# -- the checker --------------------------------------------------------------

def _clean_admission(n=10):
    return {"offered": n, "admitted": n, "replied": n,
            "rejected": {}, "shed": {}, "depth": 0, "inflight": 0}


def _classes(paid=6, free=4):
    row = lambda n: {"offered": n, "admitted": n, "replied": n,  # noqa
                     "rejected": {}, "shed": {}, "depth": 0,
                     "inflight": 0}
    return {"paid": row(paid), "free": row(free)}


_HOPS = ("admit", "dequeue", "dispatch", "worker_recv", "worker_done",
         "reply")


def _traces(n, hops=_HOPS):
    return {i: {"id": f"t{i}", "hops": [{"hop": h} for h in hops]}
            for i in range(n)}


#: scrapes, clean and broken one invariant at a time (JAX's test cases
#: and more), each with an optional SLO
_SCRAPES = {
    "clean": ({}, None),
    "offered_leak": ({"admission": dict(_clean_admission(), offered=12)},
                     None),
    "settle_leak": ({"admission": dict(_clean_admission(), replied=9)},
                    None),
    "class_sums": ({"admission": dict(_clean_admission(),
                                      classes=_classes(6, 3))}, None),
    "class_own_books": ({"admission": dict(
        _clean_admission(), classes={
            **_classes(), "paid": dict(_classes()["paid"],
                                       admitted=5)})}, None),
    "perhost": ({"perhost_replied_sum": 9}, None),
    "orphans": ({"orphans": [4242, 4343]}, None),
    "missing_hop": ({"traces": _traces(10, _HOPS[:3] + ("reply",))},
                    None),
    "missing_context": ({"traces": _traces(9)}, None),
    "traces_clean": ({"traces": _traces(10)}, None),
    "slo_lost": ({"report": {"lost": 3}}, "zero_lost"),
    "slo_recovered": ({"report": {"lost": 0}}, "recovered"),
    "slo_shed": ({"report": {"lost": 0, "shed_rate": 0.5}}, "shed"),
    "slo_p99": ({"report": {"lost": 0, "latency_ms": {"p99": 300.0}}},
                "p99"),
    "everything": ({"admission": dict(_clean_admission(), offered=11,
                                      replied=8),
                    "orphans": [1], "traces": _traces(3),
                    "perhost_replied_sum": 2, "report": {"lost": 1}},
                   "zero_lost"),
}


def _slo(mod, which):
    kw = {"zero_lost": {}, "recovered": {"require_recovered": True},
          "shed": {"max_shed_rate": 0.1},
          "p99": {"enforce_p99": True, "p99_budget_ms": 250.0}}[which]
    return mod.ScenarioSLO(**kw)


@pytest.mark.parametrize("case", sorted(_SCRAPES))
def test_check_scrape_verdicts_equal_jax(case):
    over, slo = _SCRAPES[case]
    scrape = {"admission": _clean_admission(), "orphans": [],
              "completed": 10, "report": {"lost": 0}}
    scrape.update(over)
    ours = check_scrape(scrape, slo=_slo(
        __import__("nnstreamer_tpu_torch.scenario", fromlist=["x"]), slo)
        if slo else None)
    theirs = jscn.check_scrape(scrape, slo=_slo(jscn, slo) if slo else None)
    assert ours == theirs
    assert ours["ok"] == (case in ("clean", "traces_clean"))
    assert set(ours["invariants"]) == set(INVARIANTS)
    with pytest.raises(ValueError, match="admission"):
        check_scrape({"orphans": []})


def test_violation_dumps_a_flight_bundle_with_the_spec(tmp_path):
    from nnstreamer_tpu_torch.runtime.flightrec import (
        FlightRecorder, load_bundle)

    spec = _spec()
    c = dict(_clean_admission(), offered=99)
    result = {"scenario": spec.name, "seed": spec.seed,
              "spec": spec.to_dict(), "admission": c, "orphans": [],
              "report": {"completed": 10}}
    rec = FlightRecorder(str(tmp_path), cooldown_s=0.0)
    v = check_result(result, spec, recorder=rec)
    assert not v["ok"] and v.get("flight_bundle")
    cause = load_bundle(v["flight_bundle"])["cause"]["cause"]
    assert cause["scenario_spec"] == spec.to_dict()
    assert cause["violations"] == v["violations"]
    jv = jscn.check_result(result, _spec(jscn))
    assert jv == {k: v[k] for k in ("ok", "invariants", "violations")}


# -- the shrinker -------------------------------------------------------------

_PREDICATES = {
    "f0": lambda s: any(f.label == "f0" for f in s.faults),
    "f1_and_a1": lambda s: any(f.label == "f1" for f in s.faults)
    and any(a.label == "a1" for a in s.arrivals),
    "load_over_50": lambda s: sum(a.n for a in s.arrivals) > 50,
    "always": lambda s: True,
    "flood_alone": lambda s: any(f.kind == "tenant_flood"
                                 for f in s.faults),
}


@pytest.mark.parametrize("pred", sorted(_PREDICATES))
@pytest.mark.parametrize("name", ["composed_storm", "kill_pool"])
def test_shrink_gives_jax_minimal_spec(pred, name):
    fails = _PREDICATES[pred]
    spec, jspec = builtin_specs()[name], jscn.builtin_specs()[name]
    if not fails(spec):
        with pytest.raises(ValueError, match="does not fail"):
            shrink(spec, fails)
        with pytest.raises(ValueError, match="does not fail"):
            jscn.shrink(jspec, fails)
        return
    try:
        jm, jst = jscn.shrink(jspec, fails)
    except ValueError as e:
        # JAX's ddmin may try a spec with no arrival program left (a
        # tenant_flood fault keeps the load) that the spec refuses: the
        # port refuses it with the same message (ROADMAP N33)
        with pytest.raises(ValueError) as ours:
            shrink(spec, fails)
        assert str(ours.value) == str(e)
        return
    m, st = shrink(spec, fails)
    assert m.to_json() == jm.to_json() and st == jst
    assert fails(m) and st["final_size"] <= st["initial_size"]
    for a in m.arrivals:                # survivors keep their seeds
        assert m.sub_seed("arrival", a.label) == \
            spec.sub_seed("arrival", a.label)


def test_shrink_budget_and_memo_as_jax():
    spec = builtin_specs()["composed_storm"]
    with pytest.raises(ShrinkBudgetExceeded):
        shrink(spec, _PREDICATES["f0"], max_runs=2)
    calls = []

    def fails(s):
        calls.append(s.to_json())
        return True

    _, st = shrink(_spec(), fails)
    assert st["runs"] == len(calls) == len(set(calls))
    _, jst = jscn.shrink(_spec(jscn), lambda s: True)
    assert st == jst


# -- live drills (echo worlds) ------------------------------------------------

class TestExecutorPool:
    def test_smoke_pool_all_invariants_and_replay(self):
        r = run_scenario(builtin_specs()["smoke_pool"])
        assert r["check"]["ok"], r["check"]["violations"]
        assert all(r["check"]["invariants"].values())
        assert r["totals"]["lost"] == 0
        assert r["totals"]["replied"] == r["totals"]["offered"] == 40
        assert r["orphans"] == []
        assert len(r["report"]["traces"]) == 40
        r2 = replay_scenario(r)
        assert r2["replay_match"], r2.get("replay_diff")

    def test_tenant_classes_scraped_per_class(self):
        spec = _spec(
            topology=Topology(kind="pool", workers=2, service_ms=2.0,
                              tenants={"paid": {"weight": 2.0},
                                       "free": {"weight": 1.0}}),
            arrivals=(
                ArrivalProgram(kind="constant", n=12, rate_x=0.3,
                               tenant="paid"),
                ArrivalProgram(kind="poisson", n=8, rate_x=0.1,
                               tenant="free"),
            ))
        r = run_scenario(spec)
        assert r["check"]["ok"], r["check"]["violations"]
        classes = r["admission"]["classes"]
        assert classes["paid"]["replied"] == 12
        assert classes["free"]["replied"] == 8
        assert r["report"]["groups"]["paid"]["completed"] == 12

    @pytest.mark.chaos
    def test_kill_pool_recovers_and_conserves(self):
        spec = builtin_specs()["kill_pool"]
        r = run_scenario(spec)
        assert r["check"]["ok"], r["check"]["violations"]
        assert r["report"]["recovered"]
        (kill,) = r["fault_log"]["kills"]
        (entry,) = kill["schedule"]
        assert entry["pid"] is not None
        # the victim is JAX's choice for the same spec and seed
        rng = np.random.default_rng(spec.sub_seed("fault", "f0"))
        assert entry["wid"] == int(rng.integers(0, 3))
        assert r["totals"]["lost"] == 0

    def test_failed_flood_cancels_fault_timers_and_closes(
            self, monkeypatch):
        spec = _spec(faults=(
            FaultProgram(kind="swap_storm", at_s=30.0, swaps=3,
                         interval_s=1.0),
            FaultProgram(kind="worker_kill", at_s=40.0)))
        seen = {}
        real = texec._build_world

        def build(s):
            front, world, table = real(s)
            seen["front"] = front
            return front, world, table

        def boom(*a, **kw):
            raise RuntimeError("flood failed")

        before = {t for t in threading.enumerate()}
        monkeypatch.setattr(texec, "_build_world", build)
        monkeypatch.setattr(texec, "run_open_loop", boom)
        with pytest.raises(RuntimeError, match="flood failed"):
            run_scenario(spec)
        timers = [t for t in threading.enumerate()
                  if t not in before and isinstance(t, threading.Timer)]
        assert timers == []
        pids = seen["front"].pool.all_pids_ever()
        assert pids and not any(proc_alive(p) for p in pids)


@pytest.mark.mesh
@pytest.mark.slow
class TestExecutorMesh:
    def test_flash_mesh_blackhole_heal_zero_lost(self):
        r = run_scenario(builtin_specs()["flash_mesh"])
        assert r["check"]["ok"], r["check"]["violations"]
        assert r["totals"]["lost"] == 0
        assert r["report"]["recovered"]
        log = r["fault_log"]["proxies"]["0"]
        assert [e["op"] for e in log] == ["blackhole", "heal"]
        assert r["perhost_replied_sum"] == r["totals"]["replied"]

    def test_composed_storm_acceptance(self):
        r = run_scenario(builtin_specs()["composed_storm"])
        assert r["check"]["ok"], r["check"]["violations"]
        assert all(r["check"]["invariants"].values())
        assert r["totals"]["lost"] == 0
        assert r["report"]["recovered"]
        assert {"paid", "free"} <= set(r["admission"]["classes"])
        assert len(r["fault_log"]["swaps"]) == 4
        r2 = replay_scenario(r)
        assert r2["replay_match"], r2.get("replay_diff")


def test_scenario_shrink_cli_refuses_a_passing_spec(monkeypatch, capsys,
                                                   tmp_path):
    """`scenario shrink` of a spec that holds every invariant: one live
    run, nothing to shrink, exit 1 (JAX's)."""
    from nnstreamer_tpu_torch.__main__ import main

    spec = ScenarioSpec(
        name="tiny", seed=1,
        topology=Topology(kind="pool", workers=1, service_ms=1.0),
        arrivals=(ArrivalProgram(kind="constant", n=5, rate_x=0.2),))
    f = tmp_path / "tiny.json"
    f.write_text(spec.to_json())
    assert main(["scenario", "shrink", str(f), "--max-runs", "2"]) == 1
    assert "does not fail" in capsys.readouterr().err

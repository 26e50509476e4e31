"""The rest of the load generator on the port (nnstreamer_tpu_torch/
traffic/loadgen.py) against the JAX package's, on the CPU.

Exact equality with JAX for one seed: the diurnal and flash-crowd arrival
shapes, `merge_tenant_arrivals`, and `schedule_worker_kills`' plan (the
victim `wid` drawn from the rng in JAX's order). `tenant_conservation_ok`
gives JAX's verdicts on the same counter dicts, hand-broken ones
included. Then the drills: `run_against_echo` under capacity replays
through `replay_report` to equal totals; a small `run_multitenant`
conserves per class; `run_against_pool` with one SIGKILL conserves,
recovers and leaves no orphan; JAX `tests/test_autotune.py`'s
`TestClosedLoopRamp` on the port; the `traffic` subcommand's pool modes
(`--workers` with a kill and `--trace-out`, `--tenants`). Behaviour and
books, not timings.
"""

import json
import threading

import numpy as np
import pytest
import torch

from nnstreamer_tpu.traffic import loadgen as jload
from nnstreamer_tpu_torch.traffic import loadgen as tload
from nnstreamer_tpu_torch.traffic import (
    conservation_ok, diurnal_arrivals, flash_crowd_arrivals,
    merge_tenant_arrivals, replay_report, run_against_echo,
    run_against_pool, run_autotune_ramp, run_multitenant,
    schedule_worker_kills, tenant_conservation_ok)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # pool children
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# -- arrivals, merges and kill plans: JAX's numbers ---------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("kw", [
    dict(peak_hz=200.0, trough_hz=20.0),
    dict(peak_hz=50.0, trough_hz=50.0, period_s=0.5),
    dict(peak_hz=1000.0, trough_hz=1.0, period_s=9.0)])
def test_diurnal_arrivals_equal_jax(seed, kw):
    ours = diurnal_arrivals(300, rng=np.random.default_rng(seed), **kw)
    theirs = jload.diurnal_arrivals(300, rng=np.random.default_rng(seed),
                                    **kw)
    assert np.array_equal(ours, theirs)
    assert np.all(np.diff(ours) > 0)


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("kw", [
    dict(base_hz=10.0, peak_hz=400.0, ramp_at_s=0.5),
    dict(base_hz=30.0, peak_hz=30.0, ramp_at_s=0.0, ramp_s=0.1),
    dict(base_hz=5.0, peak_hz=90.0, ramp_at_s=2.0, ramp_s=3.0)])
def test_flash_crowd_arrivals_equal_jax(seed, kw):
    ours = flash_crowd_arrivals(300, rng=np.random.default_rng(seed), **kw)
    theirs = jload.flash_crowd_arrivals(
        300, rng=np.random.default_rng(seed), **kw)
    assert np.array_equal(ours, theirs)


def test_default_rng_and_refusals_as_jax():
    assert np.array_equal(
        diurnal_arrivals(40, peak_hz=9.0, trough_hz=3.0),
        jload.diurnal_arrivals(40, peak_hz=9.0, trough_hz=3.0))
    assert np.array_equal(
        flash_crowd_arrivals(40, base_hz=3.0, peak_hz=9.0, ramp_at_s=1.0),
        jload.flash_crowd_arrivals(40, base_hz=3.0, peak_hz=9.0,
                                   ramp_at_s=1.0))
    bad = [(diurnal_arrivals, jload.diurnal_arrivals,
            dict(peak_hz=1.0, trough_hz=2.0)),
           (diurnal_arrivals, jload.diurnal_arrivals,
            dict(peak_hz=2.0, trough_hz=0.0)),
           (diurnal_arrivals, jload.diurnal_arrivals,
            dict(peak_hz=2.0, trough_hz=1.0, period_s=0.0)),
           (flash_crowd_arrivals, jload.flash_crowd_arrivals,
            dict(base_hz=5.0, peak_hz=1.0, ramp_at_s=0.0)),
           (flash_crowd_arrivals, jload.flash_crowd_arrivals,
            dict(base_hz=1.0, peak_hz=5.0, ramp_at_s=-1.0)),
           (flash_crowd_arrivals, jload.flash_crowd_arrivals,
            dict(base_hz=1.0, peak_hz=5.0, ramp_at_s=0.0, ramp_s=0.0))]
    for ours, theirs, kw in bad:
        with pytest.raises(ValueError) as a:
            ours(5, **kw)
        with pytest.raises(ValueError) as b:
            theirs(5, **kw)
        assert str(a.value) == str(b.value)


def test_merge_tenant_arrivals_equal_jax():
    rng = np.random.default_rng(4)
    schedules = {"paid": np.cumsum(rng.exponential(0.01, 50)),
                 "free": np.cumsum(rng.exponential(0.03, 20)),
                 "batch": np.arange(1, 11) * 0.05}   # exact ties too
    a, o = merge_tenant_arrivals(schedules)
    ja, jo = jload.merge_tenant_arrivals(schedules)
    assert np.array_equal(a, ja) and o == jo
    assert len(a) == 80 and np.all(np.diff(a) >= 0)
    assert {k: o.count(k) for k in schedules} == \
        {"paid": 50, "free": 20, "batch": 10}


class _StandInPool:
    """Records kill_worker calls; slot 1 is 'already dead' (None), which
    sends the kill to any live worker, as the real pool would."""

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()

    def kill_worker(self, wid):
        with self.lock:
            self.calls.append(wid)
        return None if wid == 1 else 1000 + (wid or 0)


@pytest.mark.parametrize("seed,workers,kills", [
    (0, 2, 1), (3, 4, 5), (11, 3, 3), (99, 1, 2)])
def test_schedule_worker_kills_plan_equals_jax(seed, workers, kills):
    plans = []
    for fn in (schedule_worker_kills, jload.schedule_worker_kills):
        rng = np.random.default_rng(seed)
        rng.exponential(1.0, size=7)     # arrivals drawn first, as the
        sched, timers = fn(_StandInPool(), workers=workers, rng=rng,
                           kill_at_s=0.4, kills=kills, stagger_s=0.1)
        for t in timers:                 # drills do before their kills
            t.cancel()
        plans.append(([(e["t_s"], e["wid"]) for e in sched],
                      rng.integers(0, 1 << 30)))
    assert plans[0] == plans[1]
    assert len(plans[0][0]) == kills
    assert [t for t, _ in plans[0][0]] == \
        [round(0.4 + k * 0.1, 3) for k in range(kills)]


def test_schedule_worker_kills_fires_and_falls_back():
    pool = _StandInPool()
    sched, timers = schedule_worker_kills(
        pool, workers=2, rng=np.random.default_rng(5), kill_at_s=0.0,
        kills=4, stagger_s=0.0)
    assert all(t.daemon for t in timers)
    for t in timers:
        t.start()
    for t in timers:
        t.join(5)
    assert not any(t.is_alive() for t in timers)
    for e in sched:
        # a dead slot (1) retries on any live worker: kill_worker(None)
        assert e["pid"] == (1000 if e["wid"] == 1 else 1000 + e["wid"])
    assert pool.calls.count(None) == sum(e["wid"] == 1 for e in sched)


# -- conservation verdicts ----------------------------------------------------

def _books(**over):
    c = {"offered": 10, "admitted": 9, "replied": 6,
         "rejected": {"queue_full": 1}, "shed": {"deadline": 1},
         "depth": 1, "inflight": 1}
    c.update(over)
    return c


def _classes():
    return {
        "paid": {"offered": 6, "admitted": 6, "replied": 4,
                 "rejected": {}, "shed": {"deadline": 1}, "depth": 1,
                 "inflight": 0},
        "free": {"offered": 4, "admitted": 3, "replied": 2,
                 "rejected": {"queue_full": 1}, "shed": {}, "depth": 0,
                 "inflight": 1}}


def _broken(name, **edits):
    """Clean books with class `name`'s counters edited."""
    c = _books(classes=_classes())
    c["classes"][name].update(edits)
    return c


@pytest.mark.parametrize("case,counters", [
    ("clean", _books()),
    ("clean_classes", _books(classes=_classes())),
    ("no_classes_key", _books(classes={})),
    ("offered_leak", _books(offered=11)),
    ("settle_leak", _books(replied=5)),
    # one class's own books break
    ("class_offered", _broken("paid", offered=7)),
    ("class_settle", _broken("free", replied=3)),
    # each class closes on its own, but the classes no longer sum to
    # the global books
    ("class_sum_offered", _broken("paid", offered=7, admitted=7,
                                  replied=5)),
    ("class_sum_rejected", _broken("free", offered=5,
                                   rejected={"queue_full": 2})),
    ("class_sum_depth", _broken("paid", depth=2, replied=3)),
    ("class_sum_shed", _broken("free", shed={"deadline": 1}, replied=1)),
    ("class_sum_inflight", _broken("free", inflight=0, replied=3)),
])
def test_tenant_conservation_verdicts_equal_jax(case, counters):
    ours = tenant_conservation_ok(counters)
    assert ours == jload.tenant_conservation_ok(counters)
    assert ours == (case.startswith("clean") or case == "no_classes_key")
    assert conservation_ok(counters) == jload.conservation_ok(counters)
    assert tload._tenant_conservation_ok is tenant_conservation_ok
    assert tload._conservation_ok is conservation_ok


# -- the drills ---------------------------------------------------------------

def test_echo_run_replays_to_equal_totals():
    r1 = run_against_echo(pattern="poisson", load_x=0.3, n=40,
                          service_ms=1.0, seed=9)
    assert r1["seed"] == 9 and r1["schedule"]["kind"] == "echo"
    assert r1["schedule"]["p99_budget_ms"] == (16 + 2) * 1.0
    r2 = replay_report(r1)
    # under capacity with the same seed the ledger reproduces exactly
    assert r2["completed"] == r1["completed"] == 40
    assert r2["lost"] == r1["lost"] == 0
    for k in ("offered", "admitted", "replied"):
        assert r2["admission"][k] == r1["admission"][k] == 40
    assert not r1["server_crashed"] and conservation_ok(r1["admission"])


def test_echo_overload_and_deadline_drop_lose_nothing():
    r = run_against_echo(pattern="bursty", load_x=3.0, n=120,
                         service_ms=4.0, max_pending=4,
                         shed_policy="deadline-drop", seed=2)
    assert r["lost"] == 0 and r["offered"] == 120
    assert r["completed"] + r["rejected"] == 120
    assert conservation_ok(r["admission"])
    with pytest.raises(ValueError, match="poisson\\|bursty"):
        run_against_echo(pattern="sawtooth", n=2)


def test_replay_report_refuses_reports_without_a_block():
    for bad in ({"seed": 1}, {"schedule": {"kind": "echo"}},
                {"seed": 1, "schedule": {"n": 3}},
                {"seed": 1, "schedule": "echo"}):
        with pytest.raises(ValueError, match="replayable"):
            replay_report(bad)
        with pytest.raises(ValueError, match="replayable"):
            jload.replay_report(bad)
    with pytest.raises(ValueError, match="unknown schedule kind"):
        replay_report({"seed": 1, "schedule": {"kind": "meteor"}})
    assert set(tload._REPLAY_RUNNERS) == set(jload._REPLAY_RUNNERS)


def test_multitenant_conserves_per_class():
    r = run_multitenant(
        tenants={"paid": {"weight": 3.0}, "free": {"weight": 1.0}},
        n_per_tenant={"paid": 30, "free": 30},
        rate_hz={"paid": 150.0, "free": 150.0},
        workers=1, service_ms=4.0, max_pending=8, seed=5)
    assert r["lost"] == 0 and r["offered"] == 60
    assert r["conserved"]
    classes = r["admission"]["classes"]
    assert {"paid", "free"} <= set(classes)
    assert sum(st["offered"] for st in classes.values()) == 60
    for name, g in r["groups"].items():
        st = classes[name]
        assert g["offered"] == st["offered"] == 30
        assert g["completed"] + g["rejected"] == 30
        assert g["completed"] == st["replied"]
    assert r["schedule"]["kind"] == "multitenant"
    with pytest.raises(ValueError, match="nonzero"):
        run_multitenant(tenants={"a": {}}, n_per_tenant={"a": 0},
                        rate_hz={"a": 1.0})


@pytest.mark.chaos
def test_pool_kill_conserves_recovers_and_leaves_no_orphan():
    r = run_against_pool(n=120, service_ms=10.0, workers=2, load_x=1.2,
                         kills=1, seed=3, max_pending=32,
                         p99_budget_ms=400.0)
    assert r["lost"] == 0
    assert r["conserved"]
    assert r["recovered"], r["pool"]
    assert r["orphans"] == []
    (kill,) = r["kill_schedule"]
    assert kill["pid"] is not None
    # the plan is JAX's for the same seed (the arrivals drawn first)
    rng = np.random.default_rng(3)
    arrivals = jload._arrivals_for("poisson", 1.2 * 200.0, 120, rng)
    sched, _ = jload.schedule_worker_kills(
        None, workers=2, rng=rng,
        kill_at_s=float(arrivals[len(arrivals) // 2]), kills=1)
    assert (kill["t_s"], kill["wid"]) == (sched[0]["t_s"], sched[0]["wid"])
    assert r["schedule"]["kill_at_s"] == sched[0]["t_s"]
    assert r["pool"]["pool"]["restarts"] >= 1


class TestClosedLoopRamp:
    def test_tuned_ramp_zero_lost_with_audited_decisions(self):
        """Overload ramp against a real echo server with the tuner bound
        to the live admission queue: every request resolves, the books
        close exactly after every applied knob change, and every applied
        decision is in the audit ring."""
        r = run_autotune_ramp(ramp=(1.5, 2.5), n_per_step=60,
                              service_ms=4.0, static_max_pending=64,
                              tick_interval_s=0.05, cooldown_s=0.1,
                              seed=3)
        assert r["lost"] == 0 and not r["server_crashed"]
        assert r["conservation_final"]
        assert r["conservation_after_apply"], \
            "tuner never applied a decision — loop not closed"
        assert all(r["conservation_after_apply"])
        st = r["autotune"]
        assert st["applied_total"] >= 1
        assert r["admission"]["max_pending"] < 64   # it shrank the queue
        in_ring = [a for a in r["audit"] if a["outcome"] == "applied"]
        assert len(in_ring) == st["applied_total"]
        assert st["audit_dropped"] == 0

    def test_dry_run_ramp_changes_no_knob(self):
        """The same overload produces decisions, but the live queue's
        max_pending never moves off the hand-set value."""
        r = run_autotune_ramp(ramp=(1.5, 2.5), n_per_step=60,
                              service_ms=4.0, static_max_pending=64,
                              tick_interval_s=0.05, cooldown_s=0.1,
                              dry_run=True, seed=3)
        assert r["lost"] == 0 and not r["server_crashed"]
        assert r["conservation_final"]
        st = r["autotune"]
        assert st["applied_total"] == 0
        assert st["dry_run_total"] >= 1
        assert r["admission"]["max_pending"] == 64
        assert r["schedule"]["kind"] == "autotune_ramp"


def _cli_json(capsys, argv):
    """main(argv) in this process → (exit code, the report it printed,
    stderr)."""
    from nnstreamer_tpu_torch.__main__ import main

    rc = main(argv)
    cap = capsys.readouterr()
    return rc, (json.loads(cap.out) if cap.out.strip() else None), cap.err


@pytest.mark.chaos
def test_traffic_cli_pool_modes(monkeypatch, capsys, tmp_path):
    """--workers with a kill and --trace-out, then --tenants 2: both
    spawn echo pools (children inherit OMP_NUM_THREADS=1)."""
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    trace = tmp_path / "t.json"
    rc, rep, err = _cli_json(capsys, [
        "traffic", "--workers", "2", "--kill-at", "0.05", "--kills", "1",
        "--requests", "60", "--load-x", "1.0", "--service-ms", "5",
        "--max-pending", "64", "--trace-out", str(trace), "--json"])
    assert rc == 0 and rep["lost"] == 0 and rep["conserved"]
    assert rep["orphans"] == [] and rep["kill_schedule"][0]["pid"]
    assert "traceEvents" in json.loads(trace.read_text())
    rc, rep, _ = _cli_json(capsys, [
        "traffic", "--tenants", "2", "--workers", "1", "--requests", "40",
        "--service-ms", "4", "--flood", "2", "--json"])
    assert rc == 0 and rep["lost"] == 0 and rep["conserved"]
    assert set(rep["groups"]) == {"t0", "t1"}
    assert _cli_json(capsys, ["traffic", "--tenants", "1"])[0] == 2

"""Adversarial scenario engine: composable seeded world drills (the JAX
package's scenario/ on the port).

Every robustness harness in this repo — worker-kill chaos, mesh
partition floods, tenant storms, swap drills — is a hand-written
composition of the same primitives. This package makes the
composition declarative and replayable:

- spec.py     — `ScenarioSpec`: arrival programs × fault programs ×
                topology × SLO, JSON round-trippable, every random
                choice derived from ONE root seed (`sub_seed`).
- executor.py — compiles a spec into a live world (real subprocess
                pool or multi-host mesh) and runs it open-loop;
                `replay_scenario` re-runs from the embedded spec and
                compares the quiesce ledgers.
- checker.py  — ONE property checker for the four standing invariants
                (front-door conservation, settlement, zero orphans,
                trace completeness) from one scrape; violations dump a
                `scenario_violation` flight-recorder bundle with the
                failing spec embedded.
- shrink.py   — deterministic ddmin: bisect fault and arrival
                programs (sub-seeds pinned to surviving labels) down
                to a minimal still-failing repro.

The worlds are echo worlds, as in the JAX package: echo worker pools
(`PooledQueryServer.echo`) and echo mesh hosts, no model. The same spec
and seed give the JAX package's arrival traces, kill plans and shrinks.

CLI: ``python -m nnstreamer_tpu_torch scenario run|replay|shrink|list``.
"""

from nnstreamer_tpu_torch.scenario.checker import (
    INVARIANTS, check_result, check_scrape)
from nnstreamer_tpu_torch.scenario.executor import (
    compile_arrivals, replay_scenario, run_scenario)
from nnstreamer_tpu_torch.scenario.shrink import (
    ShrinkBudgetExceeded, shrink)
from nnstreamer_tpu_torch.scenario.spec import (
    ARRIVAL_KINDS, FAULT_KINDS, TOPOLOGY_KINDS, ArrivalProgram,
    FaultProgram, ScenarioSLO, ScenarioSpec, Topology, derive_seed)


def builtin_specs() -> "dict[str, ScenarioSpec]":
    """The shipped drill catalog (``scenario list`` / ``scenario run
    NAME``). Rates are sized UNDER capacity — with zero rejects and
    zero sheds the quiesce ledger is seed-determined, so replay can
    demand bit-equal totals even through faults."""
    smoke = ScenarioSpec(
        name="smoke_pool", seed=7,
        topology=Topology(kind="pool", workers=2, service_ms=2.0),
        arrivals=(ArrivalProgram(kind="constant", n=40, rate_x=0.5),))
    kill = ScenarioSpec(
        name="kill_pool", seed=11,
        topology=Topology(kind="pool", workers=3, service_ms=4.0),
        arrivals=(ArrivalProgram(kind="poisson", n=150, rate_x=0.4),),
        faults=(FaultProgram(kind="worker_kill", at_s=0.1, kills=1),),
        slo=ScenarioSLO(require_recovered=True))
    flash = ScenarioSpec(
        name="flash_mesh", seed=23,
        topology=Topology(kind="mesh", hosts=2, workers=1,
                          service_ms=5.0, max_pending=128,
                          lease_s=0.5, max_redeliver=3),
        arrivals=(ArrivalProgram(kind="flash_crowd", n=200,
                                 rate_x=0.4, ramp_at_s=0.4,
                                 ramp_s=0.3),),
        faults=(FaultProgram(kind="blackhole", at_s=0.3, host=0,
                             heal_after_s=0.8),),
        slo=ScenarioSLO(require_recovered=True))
    composed = ScenarioSpec(
        name="composed_storm", seed=1337,
        topology=Topology(
            kind="mesh", hosts=2, workers=1, service_ms=5.0,
            max_pending=256, lease_s=0.5, max_redeliver=3,
            tenants={"paid": {"weight": 3.0},
                     "free": {"weight": 1.0}}),
        arrivals=(
            ArrivalProgram(kind="flash_crowd", n=240, rate_x=0.35,
                           tenant="paid", ramp_at_s=0.6, ramp_s=0.4),
            ArrivalProgram(kind="poisson", n=80, rate_x=0.1,
                           tenant="free"),
        ),
        faults=(
            FaultProgram(kind="blackhole", at_s=0.5, host=0,
                         heal_after_s=0.8),
            FaultProgram(kind="swap_storm", at_s=0.3, swaps=4,
                         interval_s=0.15),
            FaultProgram(kind="tenant_flood", at_s=0.8,
                         tenant="free", rate_x=0.1, n=60),
        ),
        slo=ScenarioSLO(require_recovered=True))
    return {s.name: s for s in (smoke, kill, flash, composed)}


__all__ = [
    "ARRIVAL_KINDS",
    "ArrivalProgram",
    "FAULT_KINDS",
    "FaultProgram",
    "INVARIANTS",
    "ScenarioSLO",
    "ScenarioSpec",
    "ShrinkBudgetExceeded",
    "TOPOLOGY_KINDS",
    "Topology",
    "builtin_specs",
    "check_result",
    "check_scrape",
    "compile_arrivals",
    "derive_seed",
    "replay_scenario",
    "run_scenario",
    "shrink",
]

"""Production serving edge: admission control, open-loop traffic and
network chaos (the counterpart of the JAX package's traffic/).

- admission.py — bounded admission queue with typed rejection (wire
  BUSY), shed policies (reject-newest | reject-oldest | deadline-drop),
  weighted-fair tenant classes, and exhaustive per-cause accounting
  (nothing is ever silently lost).
- loadgen.py   — open-loop Poisson / bursty / diurnal / flash-crowd load
  harness with a latency-SLO report: goodput at a p99 budget, shed
  rate, queue-depth timeline. `run_against_echo`, `run_against_pool`
  (SIGKILLs mid-flood), `run_autotune_ramp`, `run_multitenant` /
  `noisy_neighbor_drill` (per-tenant isolation), `run_against_mesh` (a
  multi-host MeshRouter partitioned mid-flood); `replay_report` re-runs
  any of them from its report.
- netchaos.py  — deterministic seeded network fault injection
  (delay/drop/duplicate/blackhole/slow-close) at message granularity,
  between any two query-wire peers.

Surfaces: `tensor_query_serversrc` admission properties (max_pending /
max_inflight / shed_policy), `tensor_query_client` BUSY backpressure
through the element error-policy machinery, `python -m
nnstreamer_tpu_torch traffic` and `mesh`.
"""

from nnstreamer_tpu_torch.traffic.admission import (
    DEADLINE_META, SHED_POLICIES, AdmissionDecision, AdmissionQueue)
from nnstreamer_tpu_torch.traffic.loadgen import (
    EchoServer, MeshWorld, bursty_arrivals, conservation_ok,
    diurnal_arrivals, flash_crowd_arrivals, merge_tenant_arrivals,
    noisy_neighbor_drill, poisson_arrivals, replay_report,
    run_against_echo, run_against_mesh, run_against_pool,
    run_autotune_ramp, run_multitenant, run_open_loop,
    schedule_worker_kills, tenant_conservation_ok)
from nnstreamer_tpu_torch.traffic.netchaos import ChaosProxy

__all__ = [
    "AdmissionDecision",
    "AdmissionQueue",
    "ChaosProxy",
    "DEADLINE_META",
    "SHED_POLICIES",
    "EchoServer",
    "MeshWorld",
    "bursty_arrivals",
    "conservation_ok",
    "diurnal_arrivals",
    "flash_crowd_arrivals",
    "merge_tenant_arrivals",
    "noisy_neighbor_drill",
    "poisson_arrivals",
    "replay_report",
    "run_against_echo",
    "run_against_mesh",
    "run_against_pool",
    "run_autotune_ramp",
    "run_multitenant",
    "run_open_loop",
    "schedule_worker_kills",
    "tenant_conservation_ok",
]

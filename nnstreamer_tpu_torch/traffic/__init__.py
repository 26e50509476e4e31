"""Production serving edge: admission control, open-loop traffic and
network chaos (the counterpart of the JAX package's traffic/).

- admission.py — bounded admission queue with typed rejection (wire
  BUSY), shed policies (reject-newest | reject-oldest | deadline-drop),
  weighted-fair tenant classes, and exhaustive per-cause accounting
  (nothing is ever silently lost).
- loadgen.py   — open-loop Poisson / bursty (Markov-modulated on/off)
  load harness with a latency-SLO report, the `EchoServer`, and
  `run_against_mesh`, which floods a multi-host MeshRouter while a host
  is partitioned mid-flood. The rest of the JAX module (the other
  arrival shapes, the echo, pool, autotune and multitenant drills,
  replay) is not ported yet.
- netchaos.py  — deterministic seeded network fault injection
  (delay/drop/duplicate/blackhole/slow-close) at message granularity,
  between any two query-wire peers.

Surfaces: `tensor_query_serversrc` admission properties (max_pending /
max_inflight / shed_policy), `tensor_query_client` BUSY backpressure
through the element error-policy machinery, `python -m
nnstreamer_tpu_torch mesh`.
"""

from nnstreamer_tpu_torch.traffic.admission import (
    DEADLINE_META, SHED_POLICIES, AdmissionDecision, AdmissionQueue)
from nnstreamer_tpu_torch.traffic.loadgen import (
    EchoServer, MeshWorld, bursty_arrivals, conservation_ok,
    poisson_arrivals, run_against_mesh, run_open_loop)
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
    "poisson_arrivals",
    "run_against_mesh",
    "run_open_loop",
]

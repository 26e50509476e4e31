"""Production serving edge: admission control (the counterpart of the
JAX package's traffic/).

- admission.py — bounded admission queue with typed rejection (wire
  BUSY), shed policies (reject-newest | reject-oldest | deadline-drop),
  weighted-fair tenant classes, and exhaustive per-cause accounting
  (nothing is ever silently lost).

Surfaces: `tensor_query_serversrc` admission properties (max_pending /
max_inflight / shed_policy), `tensor_query_client` BUSY backpressure
through the element error-policy machinery. The JAX package's open-loop
load generator and network chaos proxy (loadgen.py, netchaos.py) are not
ported yet, so this package exports only the admission queue.
"""

from nnstreamer_tpu_torch.traffic.admission import (
    DEADLINE_META, SHED_POLICIES, AdmissionDecision, AdmissionQueue)

__all__ = [
    "AdmissionDecision",
    "AdmissionQueue",
    "DEADLINE_META",
    "SHED_POLICIES",
]

"""Meshes and everything sharded over them (counterpart of the JAX
package's parallel/). The port drives every shard from one process (or,
across processes, each process its own devices' shards), placing each
shard's tensors on its logical device; a JAX collective becomes copies
between devices (counted by `mesh.Moves`) and sums on a home device.

Modules:
- mesh.py           — logical-device meshes, param rules, placement
- train.py          — the train step, on one device or sharded (dp × tp)
- ring_attention.py — sequence-parallel attention over sp
- pipeline.py       — GPipe-style pipeline parallelism over pp
- moe.py            — expert-parallel mixture-of-experts over ep
- dispatch.py       — batch dispatch, one device or dp-sharded
- multihost.py      — one global mesh across processes (torch.distributed)
- dryrun.py         — one step of each sharded path on n logical devices
"""

from nnstreamer_tpu_torch.parallel.mesh import (
    MeshSpec,
    make_mesh,
    shard_params,
    sharding_for,
)
from nnstreamer_tpu_torch.parallel.moe import init_moe_params, moe_apply
from nnstreamer_tpu_torch.parallel.pipeline import (
    pipeline_apply, stack_stage_params)
from nnstreamer_tpu_torch.parallel.train import TrainState, make_train_step

__all__ = [
    "MeshSpec",
    "make_mesh",
    "shard_params",
    "sharding_for",
    "TrainState",
    "make_train_step",
    "pipeline_apply",
    "stack_stage_params",
    "init_moe_params",
    "moe_apply",
]

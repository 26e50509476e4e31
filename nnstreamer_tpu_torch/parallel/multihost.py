"""Multi-host scale-out: one global mesh across processes (counterpart of
the JAX package's parallel/multihost.py), on `torch.distributed`.

JAX joins one runtime (`jax.distributed.initialize`) after which
`jax.devices()` spans every host and XLA routes the collectives. The
port joins a `torch.distributed` process group instead:

- `initialize` reads COORDINATOR_ADDRESS (``host:port``), NUM_PROCESSES
  and PROCESS_ID as JAX's does; with no coordinator it returns False and
  the process stays alone. The backend is named, never guessed: the
  argument, else ``[parallel] backend`` (env
  NNSTREAMER_TPU_TORCH_PARALLEL_BACKEND), ``nccl`` by default. ``gloo``
  runs only where it is asked for (the CPU; two processes on one card,
  which NCCL refuses).
- `global_mesh` lays every process's logical devices
  (serving/placement.visible_devices, the same number in each) out in
  process order; `Mesh.processes` says which process drives each, and
  a process runs only its own (parallel/train.py's sharded step runs the
  dp shards of its devices and all-reduces the rest).
- `host_local_batch` wraps this process's rows of a global batch
  (`GlobalBatch`: each process feeds only its shard, as JAX's
  `host_local_array_to_global_array`); `fetch_replicated` brings a
  global value to every process as numpy (a `GlobalBatch`'s rows
  all-gathered in process order, anything else as it is: replicated).
- `all_reduce` sums a tensor over the processes, differentiably (the
  sharded step's BN statistics); `all_reduce_` in place (its gradient,
  its loss). With ``gloo`` a CUDA tensor crosses through host memory,
  where gloo reduces it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.core.config import get_config
from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.parallel.mesh import AXES, Mesh, MeshSpec

log = get_logger("parallel.multihost")

BACKENDS = ("nccl", "gloo")


def _dist():
    import torch.distributed as dist

    return dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the process group (torch.distributed.init_process_group over
    ``tcp://<coordinator_address>``). Arguments default from the
    standard env (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID).
    Returns True if a multi-process group was joined, False for the
    single-process fallback (no coordinator configured). Call once,
    before any device use."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    num_processes = num_processes if num_processes is not None else (
        int(os.environ["NUM_PROCESSES"])
        if "NUM_PROCESSES" in os.environ else None)
    process_id = process_id if process_id is not None else (
        int(os.environ["PROCESS_ID"])
        if "PROCESS_ID" in os.environ else None)
    if coordinator_address is None and num_processes is None:
        log.info("single-process runtime (no coordinator configured)")
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise PipelineError(
            "multihost.initialize needs the coordinator address, the "
            "number of processes and this process's id (COORDINATOR_"
            "ADDRESS, NUM_PROCESSES, PROCESS_ID)")
    backend = (backend or get_config().get("parallel", "backend")
               or "nccl").strip().lower()
    if backend not in BACKENDS:
        raise PipelineError(
            f"[parallel] backend {backend!r}: use one of {BACKENDS}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise PipelineError(
            "[parallel] backend nccl needs a CUDA device; on the CPU ask "
            "for gloo (backend='gloo' or NNSTREAMER_TPU_TORCH_PARALLEL_"
            "BACKEND=gloo)")
    dist = _dist()
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    log.info("joined the process group: process %d/%d, backend %s",
             dist.get_rank(), dist.get_world_size(), backend)
    return True


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(spec: MeshSpec = MeshSpec()) -> Mesh:
    """A ("dp", "pp", "tp", "ep", "sp") mesh over every process's logical
    devices, process after process. This process's entries are its own
    devices; another's stand for that process's devices (the same kind
    and order), driven there. Keep ``tp`` within a process (the sharded
    step gathers a tp-split leaf on one process's devices); put ``dp``
    across processes, whose collective (the gradient's sum) amortizes
    the hop."""
    from nnstreamer_tpu_torch.serving.placement import visible_devices

    local = visible_devices()
    world = process_count()
    shape = spec.resolve(len(local) * world)
    n = int(np.prod(shape))
    devices = np.empty(n, dtype=object)
    devices[:] = [local[i % len(local)] for i in range(n)]
    procs = np.arange(n) // len(local)
    return Mesh(devices.reshape(shape), AXES, processes=procs)


@dataclass
class GlobalBatch:
    """This process's rows of a batch sharded over `axis` of a global
    mesh."""

    local: torch.Tensor
    mesh: Mesh
    axis: str = "dp"

    @property
    def shape(self):
        return (self.local.shape[0] * process_count(),) + \
            tuple(self.local.shape[1:])


def host_local_batch(mesh: Mesh, *arrays, axis_name: str = "dp"):
    """Per-process input arrays → `GlobalBatch`es sharded over
    `axis_name`: each process feeds only its rows."""
    from nnstreamer_tpu_torch.tensor.dtypes import host_tensor

    out = tuple(GlobalBatch(a if isinstance(a, torch.Tensor)
                            else host_tensor(np.asarray(a)), mesh, axis_name)
                for a in arrays)
    return out[0] if len(out) == 1 else out


class _AllReduce(torch.autograd.Function):
    """Sum over the processes; the backward sums the gradient the same
    way (each process's part of the loss reaches every process's
    input)."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone())


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over every process, differentiable. One process:
    `t`."""
    return t if process_count() == 1 else _AllReduce.apply(t)


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over every process in place (with ``gloo``, a CUDA tensor
    through host memory, where gloo reduces it)."""
    if process_count() == 1:
        return t
    dist = _dist()
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()  # nnlint: disable=NNL002 gloo reduces host tensors: a staging copy for the collective
        dist.all_reduce(host)
        return t.copy_(host)
    dist.all_reduce(t)
    return t


def fetch_replicated(x) -> np.ndarray:
    """A global value on every process as numpy: a `GlobalBatch`'s rows
    gathered from every process in process order (tiled: no leading
    process axis); a tensor or array, already the same everywhere, as
    it is."""
    from nnstreamer_tpu_torch.runtime.sync import to_numpy

    if not isinstance(x, GlobalBatch):
        return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    local = x.local
    if process_count() == 1:
        return to_numpy(local)
    dist = _dist()
    send = local.cpu() if dist.get_backend() == "gloo" else local  # nnlint: disable=NNL002 gloo gathers host tensors: a staging copy for the collective
    parts = [torch.empty_like(send) for _ in range(process_count())]
    dist.all_gather(parts, send.contiguous())
    return to_numpy(torch.cat(parts))

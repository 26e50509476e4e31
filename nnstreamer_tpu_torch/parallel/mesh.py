"""Device meshes (counterpart of the JAX package's parallel/mesh.py).

A `Mesh` is an object array of logical devices (the `torch.device` each
runs on, from serving/placement.visible_devices) with one name per axis,
and `.shape` by axis name as JAX's has. The port runs a mesh program
from one process: the code that takes a mesh (parallel/ring_attention,
serving/sharding) reads the devices along the axes it works over and
places each shard's tensors on its device itself.

Axes, as in the JAX package:

- ``dp`` — data parallel (the batch dim);
- ``pp`` — pipeline parallel (model stages);
- ``tp`` — tensor parallel (feature dims of the weights);
- ``ep`` — expert parallel;
- ``sp`` — sequence parallel (ring attention).

The param rules (`default_param_rules`, `shard_params`) wait for the
dense sharded path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from nnstreamer_tpu_torch.core.errors import PipelineError

AXES = ("dp", "pp", "tp", "ep", "sp")


@dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: sizes per logical axis; -1 = absorb the
    rest."""

    dp: int = -1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int, int]:
        sizes = {"dp": self.dp, "pp": self.pp, "tp": self.tp,
                 "ep": self.ep, "sp": self.sp}
        wild = [a for a, s in sizes.items() if s == -1]
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if n_devices % max(1, fixed) != 0:
            raise PipelineError(
                f"mesh {sizes} does not divide {n_devices} devices")
        if len(wild) > 1:
            raise PipelineError("at most one mesh axis may be -1")
        if wild:
            sizes[wild[0]] = n_devices // fixed
        if math.prod(sizes.values()) > n_devices:
            raise PipelineError(
                f"mesh {sizes} needs {math.prod(sizes.values())} devices but "
                f"only {n_devices} are visible")
        return tuple(sizes[a] for a in AXES)


class Mesh:
    """An object array of logical devices with named axes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise PipelineError(
                f"mesh of {arr.ndim} dims needs as many axis names, got "
                f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def along(self, axis: str, at: Optional[Dict[str, int]] = None) -> list:
        """The devices along `axis`, every other axis at its index in `at`
        (0 where `at` does not name it)."""
        if axis not in self.axis_names:
            raise PipelineError(
                f"mesh has no axis {axis!r}; axes {self.axis_names}")
        at = at or {}
        idx = tuple(slice(None) if name == axis else int(at.get(name, 0))
                    for name in self.axis_names)
        return list(self.devices[idx])


def make_mesh(spec: MeshSpec = MeshSpec(), devices=None) -> Mesh:
    """A ("dp", "pp", "tp", "ep", "sp") mesh over the given devices, or
    over every logical device (serving/placement.visible_devices), in
    ordinal order with sp innermost."""
    if devices is None:
        from nnstreamer_tpu_torch.serving.placement import visible_devices

        devices = visible_devices()
    devices = list(devices)
    shape = spec.resolve(len(devices))
    arr = np.asarray(devices[:math.prod(shape)], dtype=object)
    return Mesh(arr.reshape(shape), AXES)

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

Param rules (`default_param_rules`, `spec_for_path`, `shard_params`,
`param_specs`): a rule is (pattern, spec), the first rule whose pattern
is a substring of a leaf's path wins, and a spec names per dim the mesh
axis that dim is split over (None: whole), as a JAX PartitionSpec does.
A leaf's path is its state-dict name for an ``nn.Module`` (dotted:
``stem.weight``) and its keys joined by ``/`` for a dict or list tree,
as the JAX package spells tree paths (``classifier/w``), so the JAX
rules apply to trees that keep the JAX layout. Torch conv weights are
OIHW where JAX's are HWIO, so "split O" is dim 0 here and the last dim
there; the Dense weight is (out, in) here and (in, out) there.
`_clip_spec` replicates a dim the mesh axis does not divide, as JAX's;
a spec written for more dims than the leaf has does not apply at all
(JAX truncates it, which under HWIO drops the O split of a lower-rank
leaf). A placed leaf is its per-device slices along the split dim, in
device order (`shard_params`).

A mesh that spans processes (parallel/multihost.global_mesh) holds
every process's logical devices; `processes` says which process drives
each, and a process runs only its own. A copy between two logical
devices is counted by `Moves` (the handoff a second card would make,
as `staging_transfers` counts a backend's, ROADMAP N27), whether or not
the two share a card.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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
    """An object array of logical devices with named axes.

    `ordinals` numbers the devices in mesh order (a copy between two
    positions is a handoff even on one card); `processes` names the
    process that drives each (all 0 in one process)."""

    def __init__(self, devices, axis_names: Sequence[str], processes=None):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise PipelineError(
                f"mesh of {arr.ndim} dims needs as many axis names, got "
                f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.ordinals = np.arange(arr.size).reshape(arr.shape)
        self.processes = (np.zeros(arr.shape, dtype=int) if processes is None
                          else np.asarray(processes, dtype=int)
                          .reshape(arr.shape))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def along(self, axis: str, at: Optional[Dict[str, int]] = None) -> list:
        """The devices along `axis`, every other axis at its index in `at`
        (0 where `at` does not name it)."""
        return list(self.devices[self._line(axis, at)])

    def ordinals_along(self, axis: str,
                       at: Optional[Dict[str, int]] = None) -> List[int]:
        """The ordinals of `along`'s devices."""
        return [int(o) for o in self.ordinals[self._line(axis, at)]]

    def processes_along(self, axis: str,
                        at: Optional[Dict[str, int]] = None) -> List[int]:
        """The process that drives each of `along`'s devices."""
        return [int(p) for p in self.processes[self._line(axis, at)]]

    def _line(self, axis: str, at: Optional[Dict[str, int]]) -> tuple:
        if axis not in self.axis_names:
            raise PipelineError(
                f"mesh has no axis {axis!r}; axes {self.axis_names}")
        at = at or {}
        return tuple(slice(None) if name == axis else int(at.get(name, 0))
                     for name in self.axis_names)


class Moves:
    """Copies between logical devices, counted: `to(t, dev, src, dst)` is
    ``t.to(dev, non_blocking=True)`` (no copy where the two share a card:
    the tensor is read where it lies, as ring_attention's rotations are),
    counted when ordinals `src` and `dst` differ. Thread-safe: the
    sharded train step's shard threads share one."""

    def __init__(self):
        self.count = 0
        self._lock = threading.Lock()

    def to(self, t, dev, src: int, dst: int):
        if src != dst:
            with self._lock:
                self.count += 1
        return t.to(dev, non_blocking=True)


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


# -- param rules: leaf path pattern → spec -------------------------------------

#: a spec: per dim, the mesh axis it is split over or None (whole); the
#: empty spec replicates
Spec = Tuple[Optional[str], ...]


def default_param_rules() -> Sequence[Tuple[str, Spec]]:
    """Megatron-style rules for the zoo's conv models (the JAX package's
    rules under the port's names): a conv splits its output channels
    over ``tp`` (dim 0 of OIHW), the classifier its input features
    (dim 1 of the (out, in) Dense weight: row-parallel), BN vectors and
    biases stay whole. The JAX spellings follow for dict trees kept in
    the JAX layout."""
    return (
        (".scale", ()),                        # BN vectors: replicate
        (".mean", ()),
        (".var", ()),
        ("classifier.weight", (None, "tp")),   # (out, in): row-parallel
        ("classifier.bias", ()),
        ("heatmap.weight", ("tp", None, None, None)),
        ("offset.weight", ("tp", None, None, None)),
        (".weight", ("tp", None, None, None)),  # conv OIHW: split O
        ("bn/", ()),
        ("classifier/w", ("tp", None)),
        ("classifier/b", ()),
        ("conv/w", (None, None, None, "tp")),
        ("heatmap/w", (None, None, None, "tp")),
        ("offset/w", (None, None, None, "tp")),
        ("", ()),                              # default: replicate
    )


def spec_for_path(path_s: str, rules: Sequence[Tuple[str, Spec]]) -> Spec:
    for pat, spec in rules:
        if pat in path_s:
            return tuple(spec)
    return ()


def _axis_size(mesh: Mesh, ax) -> int:
    if isinstance(ax, tuple):
        return math.prod(mesh.shape[a] for a in ax)
    return mesh.shape[ax]


def _clip_spec(spec: Spec, ndim: int, shape, mesh: Mesh) -> Spec:
    """Drop axis annotations that do not divide their dim (tiny test
    models): sharding never changes what is computed. A spec longer
    than the leaf's rank does not apply (the leaf is replicated)."""
    if len(spec) > ndim:
        return (None,) * ndim
    entries = list(spec) + [None] * (ndim - len(spec))
    return tuple(ax if ax is None or dim % _axis_size(mesh, ax) == 0
                 else None for dim, ax in zip(shape, entries))


def param_leaves(params) -> List[Tuple[str, Any]]:
    """(path, tensor) of every leaf: an nn.Module's parameters and
    buffers by state-dict name, a (nested) dict/list/tuple tree's tensors
    and arrays by their ``/``-joined keys."""
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict(keep_vars=True).items())
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        elif isinstance(node, torch.Tensor) or hasattr(node, "shape"):
            out.append(("/".join(path), node))

    walk(params, [])
    return out


def param_specs(params, mesh: Mesh,
                rules: Optional[Sequence[Tuple[str, Spec]]] = None
                ) -> Dict[str, Spec]:
    """{leaf path: the clipped spec `shard_params` places it by}."""
    rules = rules if rules is not None else default_param_rules()
    return {path: _clip_spec(spec_for_path(path, rules), len(leaf.shape),
                             tuple(leaf.shape), mesh)
            for path, leaf in param_leaves(params)}


@dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (JAX's NamedSharding): `spec` names per dim the
    axis of `mesh` the dim is split over."""

    mesh: Mesh
    spec: Spec


def sharding_for(mesh: Mesh, spec: Spec) -> Sharding:
    return Sharding(mesh, tuple(spec))


def split_dim(spec: Spec) -> Optional[int]:
    """The one dim a spec splits, or None for a replicated leaf."""
    dims = [i for i, ax in enumerate(spec) if ax is not None]
    return dims[0] if dims else None


def shard_params(params, mesh: Mesh, axis: str = "tp",
                 rules: Optional[Sequence[Tuple[str, Spec]]] = None,
                 at: Optional[Dict[str, int]] = None) -> Dict[str, dict]:
    """Place every leaf by its rule over the devices along `axis` (the
    other axes at `at`, as `Mesh.along`): {path: {"spec", "dim",
    "parts"}} where a split leaf's parts are its contiguous slices along
    `dim`, slice i on device i, and a replicated leaf is one whole copy
    on the axis's first device (one controller needs one). Leaves are
    copied (`torch.Tensor.to`), never aliased."""
    devs = mesh.along(axis, at)
    specs = param_specs(params, mesh, rules)
    placed: Dict[str, dict] = {}
    for path, leaf in param_leaves(params):
        t = leaf.detach() if isinstance(leaf, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(leaf))
        spec = specs[path]
        dim = split_dim(spec)
        if dim is None:
            parts = [t.to(devs[0], copy=True)]
        else:
            parts = [c.to(d, copy=True).contiguous() for c, d in
                     zip(torch.chunk(t, len(devs), dim=dim), devs)]
        placed[path] = {"spec": spec, "dim": dim, "parts": parts}
    return placed


def rebuild_tree(tree, full: Dict[str, torch.Tensor], path=()):
    """`tree` (dict/list/tuple of leaves) with every leaf replaced by
    ``full[<its /-joined path>]`` (`param_leaves`' paths)."""
    if isinstance(tree, dict):
        return {k: rebuild_tree(v, full, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild_tree(v, full, path + (str(i),))
                          for i, v in enumerate(tree))
    return full.get("/".join(path), tree)


class FnCall(torch.nn.Module):
    """``fn(module, *xs)`` as a module of its own: `torch.func.
    functional_call` swaps whole leaves in under the ``m.`` prefix (a
    module's params held elsewhere, serving/sharding.py and
    parallel/train.py)."""

    def __init__(self, fn, module: torch.nn.Module):
        super().__init__()
        self.fn = fn
        self.m = module

    def forward(self, *xs):
        return self.fn(self.m, *xs)

"""Serialized params format (.npz) for zoo / python-defined models — the
JAX package's modelio/params_io.py, with the weights bridge on both
sides so the two packages read each other's files.

The reference's tensor_filter loads weight *files* per framework; for
models defined in this framework (the zoo), the equivalent is an `.npz`
archive holding the params pytree plus a JSON header naming the
architecture that rebuilds the forward fn:

    save_params("m.npz", "zoo://mobilenet_v2?width=1.0", bundle.params)
    ... tensor_filter model=m.npz ...

The stored tree is always the JAX package's layout (HWIO convs, (in,
out) denses, numpy leaves). `save_params` takes the port's params — an
``nn.Module`` of the zoo, or the transformer's params dict — and writes
that layout through the bridge's inverse (models/bridge.JAX_TREE); a
JAX-layout tree of numpy leaves is written as it is. `load_model` builds
the arch from the port's zoo and loads the stored tree into it through
the bridge (models/bridge.PORT_LOADER). An arch with no bridge raises a
`BackendError` naming it. Pytree structure (nested dict/list/tuple with
array leaves) is preserved exactly.
"""

from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np

from nnstreamer_tpu_torch.core.errors import BackendError

_FORMAT = "nnstreamer-tpu-params-v1"


def _flatten(tree: Any, out: list) -> Any:
    """Structure skeleton with leaves replaced by param indices."""
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _flatten(v, out) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {"__kind__": kind, "items": [_flatten(v, out) for v in tree]}
    if tree is None:
        return {"__kind__": "none"}
    idx = len(out)
    out.append(np.asarray(tree))
    return {"__kind__": "leaf", "index": idx}


def _unflatten(skel: Any, leaves: list) -> Any:
    kind = skel["__kind__"]
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in skel["items"].items()}
    if kind == "list":
        return [_unflatten(v, leaves) for v in skel["items"]]
    if kind == "tuple":
        return tuple(_unflatten(v, leaves) for v in skel["items"])
    if kind == "none":
        return None
    return leaves[skel["index"]]


def arch_name(arch: str) -> str:
    """The zoo model an arch reference names ("zoo://name?args")."""
    if not arch.startswith("zoo://"):
        return arch
    return arch[len("zoo://"):].partition("?")[0]


def _is_port_params(params: Any) -> bool:
    import torch

    if isinstance(params, torch.nn.Module):
        return True
    if isinstance(params, dict):
        return any(_is_port_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return any(_is_port_params(v) for v in params)
    return isinstance(params, torch.Tensor)


def _bridge(table: dict, arch: str):
    fn = table.get(arch_name(arch))
    if fn is None:
        raise BackendError(
            f"no weights bridge for arch {arch!r}: .npz params files carry "
            f"the JAX package's layout, which the port maps for "
            f"{sorted(table)} only")
    return fn


def save_params(path: str, arch: str, params: Any) -> None:
    """Write params + the arch reference that rebuilds the forward fn.
    The port's params (a zoo module, or a params dict of tensors) go
    through the bridge's inverse into the JAX layout first."""
    if _is_port_params(params):
        from nnstreamer_tpu_torch.models.bridge import JAX_TREE

        params = _bridge(JAX_TREE, arch)(params)
    leaves: list = []
    skel = _flatten(params, leaves)
    meta = json.dumps({"format": _FORMAT, "arch": arch, "tree": skel})
    arrays = {f"p{i}": a for i, a in enumerate(leaves)}
    np.savez(path, __meta__=np.frombuffer(meta.encode(), np.uint8), **arrays)


def load_params(path: str) -> Tuple[str, Any]:
    """→ (arch reference, params pytree in the JAX layout, numpy leaves)."""
    with np.load(path, allow_pickle=False) as z:
        if "__meta__" not in z:
            raise BackendError(
                f"{path!r} is not a {_FORMAT} archive (no __meta__ header); "
                f"write it with nnstreamer_tpu_torch.modelio.save_params")
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("format") != _FORMAT:
            raise BackendError(
                f"{path!r}: unknown params format {meta.get('format')!r}")
        leaves = [z[f"p{i}"] for i in range(_count_leaves(meta["tree"]))]
    return meta["arch"], _unflatten(meta["tree"], leaves)


def load_model(path: str):
    """An `.npz` params file → a ModelBundle: the arch built by the
    port's zoo, the stored tree loaded into it through the bridge."""
    from nnstreamer_tpu_torch.models.bridge import PORT_LOADER
    from nnstreamer_tpu_torch.models.zoo import build_model

    arch, tree = load_params(path)
    loader = _bridge(PORT_LOADER, arch)
    if not arch.startswith("zoo://"):
        raise BackendError(f"{path!r}: arch {arch!r} is not a zoo://"
                           f" reference")

    bundle = build_model(arch[len("zoo://"):])
    try:
        bundle.params = loader(bundle.params, tree)
    except (KeyError, RuntimeError, TypeError) as e:
        raise BackendError(
            f"{path!r}: the stored params do not fit arch {arch!r}: "
            f"{e}") from None
    bundle.name = f"{os.path.basename(path)}({arch})"
    return bundle


def _count_leaves(skel: Any) -> int:
    kind = skel["__kind__"]
    if kind == "dict":
        return sum(_count_leaves(v) for v in skel["items"].values())
    if kind in ("list", "tuple"):
        return sum(_count_leaves(v) for v in skel["items"])
    return 1 if kind == "leaf" else 0

"""Model zoo registry.

`zoo://<name>[?k=v&k2=v2]` references resolve here. Builders register on
import of their module and return `backends.torch_backend.ModelBundle`s.
Registration also seeds the model store, so ``store://<name>`` serves
its default build as version ``@0``.
"""

from __future__ import annotations

import importlib
import threading
from typing import Callable, Dict, List, Optional
from urllib.parse import parse_qsl

from nnstreamer_tpu_torch.core.errors import BackendError

_builders: Dict[str, Callable] = {}
_lock = threading.Lock()
_BUILTIN_MODULES = ("mobilenet_v2", "ssd_mobilenet", "posenet", "lstm",
                    "transformer", "audio_classifier", "probe")


def register_model(name: str):
    """`@register_model("mobilenet_v2")` on a builder(**kwargs)->ModelBundle."""
    def deco(fn):
        with _lock:
            prev = _builders.get(name)
            if prev is not None and prev is not fn:
                raise BackendError(
                    f"zoo model {name!r} is already registered (builder "
                    f"{prev.__module__}.{prev.__qualname__})")
            _builders[name] = fn
        # lazy import: the store resolves zoo refs through this module
        from nnstreamer_tpu_torch.serving.store import get_store

        get_store().seed_zoo(name, fn)
        return fn
    return deco


def builder(name: str) -> Optional[Callable]:
    """The registered builder of `name`, or None."""
    _load_builtins()
    with _lock:
        return _builders.get(name)


def list_models() -> List[str]:
    _load_builtins()
    with _lock:
        return sorted(_builders)


def build_model(ref: str):
    """Build a bundle from a zoo reference (name + optional ?query args)."""
    _load_builtins()
    name, _, query = ref.partition("?")
    kwargs = {k.replace("-", "_"): _coerce(v) for k, v in parse_qsl(query)}
    with _lock:
        builder = _builders.get(name)
    if builder is None:
        raise BackendError(
            f"no zoo model named {name!r}; available: {list_models()}")
    try:
        return builder(**kwargs)
    except TypeError as e:
        raise BackendError(f"bad zoo model arguments in {ref!r}: {e}") from e


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def _load_builtins() -> None:
    for mod in _BUILTIN_MODULES:
        importlib.import_module(f"nnstreamer_tpu_torch.models.{mod}")

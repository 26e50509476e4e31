"""Subplugin registries (reference: gst/nnstreamer/nnstreamer_subplugin.c).

One name→object table per plugin kind. The port owns its own `registry`
instance, so the JAX package and the port can both register
``tensor_filter`` and the rest in one process.
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Callable, Dict, List, Optional

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.log import get_logger

log = get_logger("registry")


class PluginKind(enum.Enum):
    ELEMENT = "element"
    FILTER = "filter"        # model-execution backends
    DECODER = "decoder"      # tensor→media decoders
    CONVERTER = "converter"  # media→tensor converters


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._tables: Dict[PluginKind, Dict[str, Any]] = {
            k: {} for k in PluginKind}

    def register(self, kind: PluginKind, name: str, obj: Any = None):
        """Register `obj` under (kind, name); usable as a decorator.
        Re-registration replaces the entry."""
        if obj is None:
            def deco(o):
                self.register(kind, name, o)
                return o
            return deco
        with self._lock:
            if name in self._tables[kind]:
                log.warning("replacing %s plugin %r", kind.value, name)
            self._tables[kind][name] = obj
        return obj

    def unregister(self, kind: PluginKind, name: str) -> bool:
        with self._lock:
            return self._tables[kind].pop(name, None) is not None

    def get(self, kind: PluginKind, name: str) -> Any:
        obj = self.find(kind, name)
        if obj is None:
            raise PipelineError(
                f"no {kind.value} plugin named {name!r}; registered "
                f"{kind.value}s: {self.names(kind) or '(none)'}. Register "
                f"one with registry.register(PluginKind.{kind.name}, "
                f"{name!r}, obj)")
        return obj

    def find(self, kind: PluginKind, name: str) -> Optional[Any]:
        with self._lock:
            return self._tables[kind].get(name)

    def names(self, kind: PluginKind) -> List[str]:
        with self._lock:
            return sorted(self._tables[kind])


#: the port's process-wide registry (separate from the JAX package's)
registry = Registry()


def register_element(name: str) -> Callable:
    """Class decorator: `@register_element("tensor_converter")`."""
    return registry.register(PluginKind.ELEMENT, name)

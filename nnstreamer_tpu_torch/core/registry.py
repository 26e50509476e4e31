"""Subplugin registries (reference: gst/nnstreamer/nnstreamer_subplugin.c).

One name→object table per plugin kind. The port owns its own `registry`
instance, so the JAX package and the port can both register
``tensor_filter`` and the rest in one process.

Python-module loading takes the place of dlopen: a miss scans the
config's plugin paths (``$NNSTREAMER_TPU_TORCH_PLUGINS``, then ``[common]
plugin_paths``) once and imports every ``*.py`` there; importing a plugin
module registers it (the constructor-self-registration analog). The
modules are named under the port's own prefix
(``nnstreamer_tpu_torch_plugin_<hash>``), and the JAX package reads
``$NNSTREAMER_TPU_PLUGINS``: a path set for one package loads no plugin
into the other (ROADMAP N19).
"""

from __future__ import annotations

import enum
import importlib.util
import sys
import threading
from typing import Any, Callable, Dict, List, Optional

from nnstreamer_tpu_torch.core.config import get_config
from nnstreamer_tpu_torch.core.errors import ConfigError, PipelineError
from nnstreamer_tpu_torch.core.log import get_logger

log = get_logger("registry")


class PluginKind(enum.Enum):
    ELEMENT = "element"
    FILTER = "filter"        # model-execution backends
    DECODER = "decoder"      # tensor→media decoders
    CONVERTER = "converter"  # media→tensor converters
    TRAINER = "trainer"      # the reference's reserved trainer slot


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._tables: Dict[PluginKind, Dict[str, Any]] = {
            k: {} for k in PluginKind}
        self._scanned = False

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
            # lazy path scan (the g_module_open-on-demand analog)
            self._scan_plugin_paths()
            obj = self.find(kind, name)
        if obj is None:
            raise PipelineError(
                f"no {kind.value} plugin named {name!r}; registered "
                f"{kind.value}s: {self.names(kind) or '(none)'}. Register "
                f"one with registry.register(PluginKind.{kind.name}, "
                f"{name!r}, obj) or add its module directory to [common] "
                f"plugin_paths / $NNSTREAMER_TPU_TORCH_PLUGINS.")
        return obj

    def find(self, kind: PluginKind, name: str) -> Optional[Any]:
        with self._lock:
            return self._tables[kind].get(name)

    def names(self, kind: PluginKind) -> List[str]:
        with self._lock:
            return sorted(self._tables[kind])

    # -- module scanning ---------------------------------------------------
    def _scan_plugin_paths(self) -> None:
        with self._lock:
            if self._scanned:
                return
            self._scanned = True
        for path in get_config().plugin_paths():
            if not path.is_dir():
                log.warning("plugin path %s does not exist", path)
                continue
            for mod_file in sorted(path.glob("*.py")):
                self.load_module(str(mod_file))

    def load_module(self, path: str) -> None:
        """Import a plugin module by file path; importing registers it."""
        mod_name = f"nnstreamer_tpu_torch_plugin_{abs(hash(path)):x}"
        if mod_name in sys.modules:
            return
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or spec.loader is None:
            raise ConfigError(f"cannot load plugin module {path}")
        module = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = module
        try:
            spec.loader.exec_module(module)
            log.info("loaded plugin module %s", path)
        except Exception:
            del sys.modules[mod_name]
            raise

    def rescan(self) -> None:
        """Scan the plugin paths again (after the paths changed)."""
        with self._lock:
            self._scanned = False
        self._scan_plugin_paths()


#: the port's process-wide registry (separate from the JAX package's)
registry = Registry()


def register_element(name: str) -> Callable:
    """Class decorator: `@register_element("tensor_converter")`."""
    return registry.register(PluginKind.ELEMENT, name)

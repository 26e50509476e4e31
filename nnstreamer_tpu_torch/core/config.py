"""Layered configuration (reference: gst/nnstreamer/nnstreamer_conf.c).

Priority, highest first:

1. Environment: ``NNSTREAMER_TPU_TORCH_<GROUP>_<KEY>`` (e.g.
   ``NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR=cpu``).
2. Ini file: path from ``NNSTREAMER_TPU_TORCH_CONF``, else
   ``~/.config/nnstreamer_tpu_torch.ini``.
3. Built-in defaults.

The port's prefix differs from the JAX package's, so one process can
configure both packages independently.
"""

from __future__ import annotations

import configparser
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional

from nnstreamer_tpu_torch.core.errors import ConfigError

ENV_PREFIX = "NNSTREAMER_TPU_TORCH_"
CONF_ENV = "NNSTREAMER_TPU_TORCH_CONF"

_DEFAULTS: Dict[str, Dict[str, str]] = {
    "common": {
        # directories whose *.py files are imported on a registry miss
        # (core/registry.py); ${NNSTREAMER_TPU_TORCH_PLUGINS} comes first
        "plugin_paths": "",
    },
    "filter": {
        "default_backend": "torch",
        # where a filter runs when its accelerator= property is empty.
        # The card is the default; the CPU runs only when asked for
        # (accelerator=cpu on the filter, or this key set to "cpu").
        "accelerator": "cuda",
    },
    "runtime": {
        "queue_capacity": "4",       # per-link buffer queue depth
        # bounded async-dispatch window: unresolved device results a
        # DEVICE_RESIDENT element may have in flight before its worker
        # syncs the oldest; 0 = sync after every dispatch
        "max_inflight": "8",
        # scheduler-level chain fusion: run linear chains of cheap
        # single-in/single-out elements in one worker thread (direct
        # call-through, no channel hop per element)
        "chain_fusion": "1",
        # device segments (graph/optimize.fuse_segments): before transform
        # fusion, filter → transform → filter runs collapse into the
        # upstream head filter, whose backend runs every member model in
        # one invoke (one CUDA graph in a compiled window)
        "device_segments": "1",
        # policy-handled errors in a row, with no successful process()
        # anywhere in the pipeline, before the run escalates to failure
        # (0 = never)
        "max_consecutive_errors": "100",
        # the stall watchdog: an element inside process()/flush() longer
        # than stall_budget_s, or an input queue at capacity longer than
        # queue_stall_budget_s (empty = stall_budget_s), is flagged;
        # watchdog_action warn | fail
        "watchdog": "1",
        "stall_budget_s": "30.0",
        "queue_stall_budget_s": "",
        "watchdog_action": "warn",
        # the compiled steady-state loop (runtime/compiled_loop.py): after
        # compiled_loop_arm identical-signature frames a tensor_filter's
        # worker sweeps up to compiled_loop_window queued frames into one
        # window (one CUDA-graph replay on the card)
        "compiled_loop": "1",
        "compiled_loop_window": "8",
        "compiled_loop_arm": "4",
    },
    "build": {
        # directory the hand-written kernels are compiled into; empty =
        # build/torch_kernels beside the package
        "kernel_dir": "",
    },
    "serving": {
        # the persistent bucket manifest (serving/compile_cache.py):
        # store-served filters record every bucket they serve and replay
        # the set at the next start (opt-in); compile_cache_dir empty =
        # ~/.cache/nnstreamer_tpu_torch/manifest
        "compile_cache": "0",
        "compile_cache_dir": "",
    },
    "parallel": {
        # logical devices for sharded serving and ring attention
        # (serving/placement.visible_devices): 0 = the real devices (the
        # CUDA cards, or one CPU when [filter] accelerator is cpu); N > 0
        # = N logical devices round-robin over those, so a 4-way ring
        # runs on one card with the launches four cards would make
        "virtual_devices": "0",
        # the torch.distributed backend parallel/multihost.initialize
        # joins with: nccl, or gloo where asked for (the CPU; two
        # processes on one card)
        "backend": "nccl",
    },
}


class Config:
    def __init__(self, path: Optional[str] = None):
        self._ini: Dict[str, Dict[str, str]] = {}
        candidates = [path] if path else [
            os.environ.get(CONF_ENV),
            os.path.expanduser("~/.config/nnstreamer_tpu_torch.ini"),
        ]
        for cand in candidates:
            if cand and Path(cand).is_file():
                self._load_ini(cand)
                break

    def _load_ini(self, path: str) -> None:
        parser = configparser.ConfigParser()
        try:
            parser.read(path)
        except configparser.Error as e:
            raise ConfigError(f"failed to parse config file {path}: {e}") from e
        for section in parser.sections():
            self._ini.setdefault(section.lower(), {}).update(
                {k.lower(): v for k, v in parser.items(section)})

    def get(self, group: str, key: str,
            default: Optional[str] = None) -> Optional[str]:
        """env > ini > built-in > `default`."""
        group, key = group.lower(), key.lower()
        env = os.environ.get(f"{ENV_PREFIX}{group.upper()}_{key.upper()}")
        if env is not None:
            return env
        if key in self._ini.get(group, {}):
            return self._ini[group][key]
        return _DEFAULTS.get(group, {}).get(key, default)

    def get_int(self, group: str, key: str, default: int = 0) -> int:
        v = self.get(group, key)
        if v is None:
            return default
        try:
            return int(v)
        except ValueError:
            raise ConfigError(
                f"config [{group}] {key}={v!r} is not an integer") from None

    def get_bool(self, group: str, key: str, default: bool = False) -> bool:
        v = self.get(group, key)
        if v is None or not v.strip():
            return default
        return v.strip().lower() in ("1", "true", "yes", "on")

    def plugin_paths(self) -> List[Path]:
        """Directories scanned for plugin modules: ``$NNSTREAMER_TPU_TORCH_
        PLUGINS`` first, then ``[common] plugin_paths`` (os.pathsep-
        separated). The JAX package reads ``$NNSTREAMER_TPU_PLUGINS``, so
        a path set for one package loads nothing into the other."""
        paths: List[Path] = []
        env = os.environ.get(f"{ENV_PREFIX}PLUGINS", "")
        ini = self.get("common", "plugin_paths") or ""
        for chunk in (env, ini):
            for p in chunk.split(os.pathsep):
                if p.strip():
                    paths.append(Path(p.strip()).expanduser())
        return paths

    def get_float(self, group: str, key: str, default: float = 0.0) -> float:
        v = self.get(group, key)
        if v is None or not v.strip():
            return default
        try:
            return float(v)
        except ValueError:
            raise ConfigError(
                f"config [{group}] {key}={v!r} is not a number") from None


_global: Optional[Config] = None
_global_lock = threading.Lock()


def get_config() -> Config:
    global _global
    with _global_lock:
        if _global is None:
            _global = Config()
        return _global

"""Bucket manifest for served models (counterpart of the JAX package's
serving/compile_cache.py).

The JAX package keeps two layers: XLA's persistent executable cache
(``jax_compilation_cache_dir``), and a manifest of *what to ask for* —
every (model name, version) → the bucket set it served. The port has no
executable cache to point anywhere: PyTorch runs eagerly, and a CUDA
graph holds device addresses, so it cannot outlive its process. What
carries over is the manifest. On the next process start
``tensor_filter`` (and ``tensor_llm``) replay it at element start()
(backend ``warm_start``): each recorded bucket runs once on zeros — the
allocator's blocks, cuDNN's algorithm choice and the kernel libraries
are all set up off the hot path — and the first real buffer meets a
warm process. Graphs are captured again by the compiled windows, not
loaded.

Configured through the ``[serving]`` group in core/config.py (opt-in:
``compile_cache=1``, env ``NNSTREAMER_TPU_TORCH_SERVING_COMPILE_CACHE=1``;
``compile_cache_dir``, default ``~/.cache/nnstreamer_tpu_torch/manifest``:
the port's own directory, apart from the JAX package's). Every disk
write is best-effort — the manifest is an optimization, never a gate.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

from nnstreamer_tpu_torch.core.config import get_config
from nnstreamer_tpu_torch.core.log import get_logger

log = get_logger("serving.cache")

_lock = threading.Lock()
_enabled: Optional[bool] = None     # memoized maybe_enable verdict
_dir: Optional[str] = None

#: tensor_llm's bucket kinds (backends/llm_exec.py): prefill prompt
#: bucket, decode batch bucket, chunked-prefill chunk, ring prefill — one
#: pow2 int each, no tensor pairs
LLM_KINDS = ("prefill", "decode", "chunk", "ring")


def reset() -> None:
    """Forget the memoized enable verdict (tests re-point the config)."""
    global _enabled, _dir
    with _lock:
        _enabled = None
        _dir = None


def cache_dir() -> Optional[str]:
    return _dir if _enabled else None


def maybe_enable_compile_cache() -> bool:
    """Turn the manifest on per the ``[serving]`` config group.
    Idempotent; returns whether it is active."""
    global _enabled, _dir
    with _lock:
        if _enabled is not None:
            return _enabled
        cfg = get_config()
        if not cfg.get_bool("serving", "compile_cache", False):
            _enabled = False
            return False
        d = os.path.expanduser(
            cfg.get("serving", "compile_cache_dir")
            or "~/.cache/nnstreamer_tpu_torch/manifest")
        try:
            os.makedirs(d, exist_ok=True)
        except OSError as e:
            log.warning("bucket manifest disabled: %s", e)
            _enabled = False
            return False
        _dir = d
        _enabled = True
        log.info("bucket manifest at %s", d)
        return True


# -- bucket manifest ---------------------------------------------------------
# Layout: <cache_dir>/manifest.json =
#   {"<name>@<version>": [{"kind": "dynb"|"fix", "nb": 8,
#                          "tensors": [{"shape": [...], "dtype": "f32"}]},
#                         {"kind": "decode", "n": 8}, ...]}

def _manifest_path() -> Optional[str]:
    return os.path.join(_dir, "manifest.json") if _dir else None


def _bucket_to_json(bk: tuple) -> Optional[dict]:
    kind = bk[0]
    if kind in LLM_KINDS:
        return {"kind": kind, "n": int(bk[1])}
    if kind == "dynb":
        nb, pairs = bk[1], bk[2:]
    elif kind == "fix":
        nb, pairs = None, bk[1:]
    else:
        return None              # flexible seq/bat buckets: not replayed
    out = {"kind": kind,
           "tensors": [{"shape": list(s), "dtype": d} for s, d in pairs]}
    if nb is not None:
        out["nb"] = nb
    return out


def _bucket_from_json(obj: dict) -> Optional[tuple]:
    try:
        if obj["kind"] in LLM_KINDS:
            return (str(obj["kind"]), int(obj["n"]))
        pairs = tuple((tuple(t["shape"]), str(t["dtype"]))
                      for t in obj["tensors"])
        if obj["kind"] == "dynb":
            return ("dynb", int(obj["nb"])) + pairs
        if obj["kind"] == "fix":
            return ("fix",) + pairs
    except (KeyError, TypeError, ValueError):
        pass
    return None


def record_bucket(name: str, version: int, bucket_key: tuple) -> None:
    """Append one served bucket to the on-disk manifest (no-op when the
    manifest is off). Called once per new bucket per process (the store
    entry dedups), so the read-modify-write stays cheap."""
    if not maybe_enable_compile_cache():
        return
    jb = _bucket_to_json(bucket_key)
    if jb is None:
        return
    path = _manifest_path()
    key = f"{name}@{version}"
    with _lock:
        try:
            data: Dict[str, list] = {}
            if os.path.exists(path):
                with open(path) as f:
                    data = json.load(f)
            rows = data.setdefault(key, [])
            if jb not in rows:
                rows.append(jb)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(data, f, indent=1, sort_keys=True)
                os.replace(tmp, path)
        except Exception as e:
            log.warning("manifest write failed (%s@%d): %s",
                        name, version, e)


def manifest_buckets(name: str, version: int) -> List[tuple]:
    """The bucket set a previous process served for name@version, for
    warm-start replay. Empty when the manifest is off or unseen."""
    if not maybe_enable_compile_cache():
        return []
    path = _manifest_path()
    try:
        if not os.path.exists(path):
            return []
        with open(path) as f:
            data = json.load(f)
        rows = data.get(f"{name}@{version}", [])
        out = [_bucket_from_json(r) for r in rows]
        return [b for b in out if b is not None]
    except Exception as e:
        log.warning("manifest read failed (%s@%d): %s", name, version, e)
        return []

"""Host-sync choke point.

Every place the runtime must force device work to completion (a sink or
host decoder reading results back, `fakesink sync-device=true`, the
scheduler's in-flight window) goes through :func:`device_sync`, and
every read-back through :func:`to_host`. One call site means one way to
wait — a CUDA stream synchronize per device the tensors live on — and one
count of the *forced* syncs, the host-path tax the async dispatch exists
to avoid. Given a tracer and an element name, a forced sync is also
recorded on the tracer (`Tracer.record_forced_sync`).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from nnstreamer_tpu_torch.tensor.buffer import HostCopy
from nnstreamer_tpu_torch.tensor.dtypes import DType

_lock = threading.Lock()
_forced = 0


def forced_sync_count() -> int:
    """Process-wide number of forced host syncs since import."""
    return _forced


def _count(tracer, name) -> None:
    global _forced
    with _lock:
        _forced += 1
    if tracer is not None and tracer.active:
        tracer.record_forced_sync(name or "?", time.perf_counter())


def device_sync(tensors, tracer=None, name=None, forced: bool = True):
    """Block until the device work behind every CUDA tensor in
    ``tensors`` (a tuple, a list or one tensor) has finished.

    Free, and neither counted nor traced, when nothing in it is a CUDA
    tensor. ``forced=True`` marks a semantic sync (sink, sync latency
    mode) and is counted, and traced on ``tracer`` under element
    ``name``; ``forced=False`` marks the in-flight window's
    backpressure. Returns ``tensors`` unchanged."""
    leaves = tensors if isinstance(tensors, (tuple, list)) else (tensors,)
    devices = {t.device for t in leaves
               if isinstance(t, torch.Tensor) and t.is_cuda}
    if not devices:
        return tensors
    for dev in devices:
        # the scheduler's threads all launch on each device's current
        # (default) stream, so finishing it finishes these tensors
        torch.cuda.current_stream(dev).synchronize()
    if forced:
        _count(tracer, name)
    return tensors


def to_host(tensors, tracer=None, name=None) -> tuple:
    """Tensors (a tuple or list) → host numpy arrays. Whatever had to be
    waited for — the streams behind CUDA tensors, the events of D2H
    copies already in flight (`tensor.buffer.HostCopy`), or both — is
    one forced sync, counted and traced once. Non-tensors pass through
    unchanged."""
    waited = any(isinstance(t, torch.Tensor) and t.is_cuda
                 for t in tensors)
    device_sync(tensors, forced=False)
    copies = [t for t in tensors if isinstance(t, HostCopy)]
    for c in copies:
        c.event.synchronize()
    if waited or copies:
        _count(tracer, name)
    return tuple(to_numpy(t.host) if isinstance(t, HostCopy)
                 else to_numpy(t) if isinstance(t, torch.Tensor) else t
                 for t in tensors)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU (or finished CUDA) tensor → numpy; bfloat16 through its
    int16 bits into ml_dtypes' bfloat16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy has no bfloat16; ml_dtypes provides it when installed
        return t.view(torch.int16).numpy().view(DType.BFLOAT16.np_dtype)
    return t.numpy()

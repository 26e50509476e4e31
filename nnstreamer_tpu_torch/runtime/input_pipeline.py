"""Double-buffered host→device input staging, the JAX package's
runtime/input_pipeline.py on the port.

Staging batch N+1 while batch N computes keeps the card busy through the
transfer. Where JAX's ``jax.device_put`` is asynchronous by itself, here
a batch is copied into pinned host memory and from there to the device
on a side CUDA stream (`CopyStager`), with an event recorded behind the
copy. The consumer's side then makes its own stream wait on that event
and marks the staged tensor as used by that stream
(``Tensor.record_stream``): without the wait a kernel could read the
batch before it lands; without the mark the caching allocator, which
tracks the tensor on the copy stream, could hand its memory to the next
batch's copy while a consumer kernel still reads it (ROADMAP N17).

- `prefetch_to_device(it, depth)` — wrap any host-batch iterator; a
  background thread stages up to `depth` batches ahead and a bounded
  queue provides backpressure.
- `DeviceFeeder` — push-style variant: a producer thread calls
  `put(host_batch)` (non-blocking up to the buffer depth) and the
  compute side calls `get()`.

The device defaults to the port's (`backends.base.pick_device`: the
card, or the CPU when asked for); on the CPU a batch is staged as a copy
of itself (a CPU tensor). ``put=`` replaces the transfer with the
caller's own: whatever it returns is handed over as it is, unless it is
a `Staged`, whose event the consumer then waits on.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.tensor.dtypes import host_tensor

__all__ = ["prefetch_to_device", "DeviceFeeder", "CopyStager", "Staged"]

_STOP = object()


class Staged:
    """A batch whose copy to the device is queued on a side stream:
    `tensor` may be read on another stream only after `event`."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event: torch.cuda.Event):
        self.tensor = tensor
        self.event = event

    def take(self) -> torch.Tensor:
        """On the consumer's thread: its current stream waits for the
        copy, and the tensor is marked as used by that stream."""
        stream = torch.cuda.current_stream(self.tensor.device)
        stream.wait_event(self.event)
        self.tensor.record_stream(stream)
        return self.tensor


class CopyStager:
    """Host batch → device tensor through pinned memory on one side
    stream per stager."""

    def __init__(self, device: Any = None):
        self.device = _resolve(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, x, device: Any = None) -> Any:
        src = x if isinstance(x, torch.Tensor) else host_tensor(np.asarray(x))
        if self.stream is None:
            return src.clone()
        if src.is_cuda:
            raise ValueError(
                f"CopyStager stages host batches; got a tensor already on "
                f"{src.device}")
        pinned = src.pin_memory()
        with torch.cuda.stream(self.stream):
            dst = pinned.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return Staged(dst, done)


def _resolve(device: Any) -> torch.device:
    if device is None:
        from nnstreamer_tpu_torch.backends.base import pick_device

        return pick_device("")
    return torch.device(device)


_stagers: Dict[torch.device, CopyStager] = {}
_stagers_lock = threading.Lock()


def _default_put(x, device):
    dev = _resolve(device)
    with _stagers_lock:
        stager = _stagers.get(dev)
        if stager is None:
            stager = _stagers[dev] = CopyStager(dev)
    return stager(x)


def _taken(item):
    return item.take() if isinstance(item, Staged) else item


def prefetch_to_device(it: Iterable[Any], depth: int = 2,
                       device: Any = None,
                       put: Optional[Callable[[Any, Any], Any]] = None
                       ) -> Iterator[Any]:
    """Yield device tensors for each host batch in `it`, staging up to
    `depth` batches ahead of the consumer.

    `put(x, device)` overrides the transfer function. Exceptions from the
    source iterator or the transfer re-raise at the consumer."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    put = put or _default_put
    q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
    cancelled = threading.Event()

    def worker():
        try:
            for x in it:
                staged = put(x, device)
                # bounded put, so an abandoned consumer doesn't pin this
                # thread (and its staged device buffers) forever
                while not cancelled.is_set():
                    try:
                        q.put(staged, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if cancelled.is_set():
                    return
            item = _STOP
        except BaseException as e:      # surface at the consumer side
            item = e
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    t = threading.Thread(target=worker, name="device-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _STOP:
                return
            if isinstance(item, BaseException):
                raise item
            yield _taken(item)
    finally:
        # consumer closed the generator (break / exception): release the
        # worker and drop staged buffers
        cancelled.set()


class DeviceFeeder:
    """Push-style double buffer between a producer thread and the device
    compute loop.

    put() stages the host batch at once (the copy queued on the side
    stream) and enqueues it; it blocks only when `depth` staged batches
    are already waiting — that backpressure bounds device memory. get()
    returns the next staged batch (blocking), its copy waited for on the
    caller's stream."""

    def __init__(self, depth: int = 2, device: Any = None,
                 put: Optional[Callable[[Any, Any], Any]] = None):
        if depth < 1:
            raise ValueError(f"feeder depth must be >= 1, got {depth}")
        # one extra slot is reserved for the close() sentinel so closing
        # never blocks behind staged batches; the semaphore keeps data
        # occupancy at `depth`
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth + 1)
        self._slots = threading.BoundedSemaphore(depth)
        self._device = device
        self._put = put or _default_put
        self._closed = False
        # serializes the closed-check with the enqueue so a concurrent
        # close() cannot slip its sentinel between them
        self._lock = threading.Lock()

    def put(self, host_batch: Any, timeout: Optional[float] = None) -> None:
        if self._closed:      # cheap fast path (re-checked under lock)
            raise RuntimeError("DeviceFeeder is closed")
        if not self._slots.acquire(timeout=timeout):
            raise queue.Full("DeviceFeeder staging buffer is full")
        try:
            staged = self._put(host_batch, self._device)
            with self._lock:
                if self._closed:
                    raise RuntimeError("DeviceFeeder is closed")
                # non-blocking: _slots caps data at depth, maxsize depth+1
                self._q.put(staged)
        except BaseException:
            self._slots.release()
            raise

    def close(self) -> None:
        """Signal end of stream; get() returns None after draining."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._q.put(_STOP)  # the +1 slot is reserved for this

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        item = self._q.get(timeout=timeout)
        if item is _STOP:
            self._q.put(_STOP)      # keep returning None for late gets
            return None
        self._slots.release()
        return _taken(item)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""Batch dispatcher — frames from any number of streams coalesced into
batches on one card (counterpart of the JAX package's
parallel/dispatch.py).

Flow: submit(frame) → future; a collector thread packs up to the largest
bucket of frames (or flushes after `max_delay_ms`), pads the batch to
the smallest bucket that holds it (zero rows), runs the batched fn, and
resolves futures with per-frame outputs.

The collector/completion machinery lives in `BatchCore` (host code, the
JAX package's class): its conservation contract — counters bumped under
one lock BEFORE futures resolve, every accepted frame ending as a frame,
an error or a shutdown failure — is unchanged. What changes on the card:

- **H2D**: with a CUDA `device` the padded batch is assembled in pinned
  host memory and crosses as ONE non-blocking copy (the batcher thread
  does not wait for it).
- **D2H overlap**: each CUDA output starts its copy back at once —
  ``non_blocking`` into pinned host memory, with a CUDA event recorded
  behind it (`tensor.buffer.HostCopy`) — and the completion thread waits
  on that event, never on the whole device, before it reads. (A
  non-blocking copy into pageable memory would be read before it lands.)
  So the batcher launches batch N+1 while batch N's copy is in flight,
  the JAX package's ``copy_to_host_async`` overlap.

`Dispatcher` runs ``fn(params, x)`` on one device with buckets
``{1, bucket}``, as the JAX package's MeshDispatcher does with dp 1: a
lone closed-loop frame runs at batch 1 instead of paying the full
bucket. The mesh dispatcher over several cards waits for the port of the
rest of parallel/ (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import queue as _q
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.backends.base import pick_device
from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.runtime.sync import to_numpy
from nnstreamer_tpu_torch.tensor.buffer import HostCopy
from nnstreamer_tpu_torch.tensor.dtypes import host_tensor

log = get_logger("parallel.dispatch")


def _start_d2h(o):
    """Begin the host copy of one output: a CUDA tensor → a `HostCopy`
    (pinned, non-blocking, event behind it); anything else as is."""
    if isinstance(o, torch.Tensor) and o.is_cuda:
        return HostCopy(o)
    return o


def _host(o) -> np.ndarray:
    """A started copy → numpy, waiting on its event only."""
    if isinstance(o, HostCopy):
        o.event.synchronize()
        o = o.host
    return to_numpy(o) if isinstance(o, torch.Tensor) else np.asarray(o)


class BatchCore:
    """Collector + completion stages behind a submit() → Future API.

    `run(batch, n)` is the device computation: `batch` is the frames
    stacked and zero-padded to one of the `buckets` sizes, a torch tensor
    on `device` (on the card: one pinned H2D copy), and `n` the number
    of real frames at its front; it returns one tensor or a tuple of
    them, resolved per frame as tuples of numpy rows.

    Conservation contract: counters are bumped under `_lock` BEFORE
    futures resolve, so a caller that observed its result and then read
    stats() always sees its own frame counted; every accepted frame ends
    in exactly one of frames / errors / shutdown-failed.

    The JAX package's queue bound (`capacity`), raw payloads and fenced
    `abort` serve its replica placement (serving/placement.py), not
    ported yet, and come with it.
    """

    def __init__(self, run: Callable[[Any, int], Any],
                 buckets: Sequence[int], max_delay_s: float, *,
                 device: torch.device, name: str = "dispatch"):
        self._run = run
        self.buckets = sorted({int(b) for b in buckets})
        if not self.buckets or self.buckets[0] < 1:
            raise StreamError(f"bad bucket set {buckets!r}")
        self.max_delay = max_delay_s
        self.device = device
        self.name = name
        self._pending: List[Tuple[Any, Future]] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._shutdown_done = False
        # counters — mutated under _lock; read via stats() for a
        # consistent snapshot
        self.frames = 0
        self.batches = 0
        self.errors = 0
        self._outstanding = 0
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()
        # completion stage: started read-backs queue here and a second
        # thread waits on them and resolves the futures, so the batcher
        # launches batch N+1 while batch N's D2H is in flight (bounded:
        # at most a few batches in flight on the card)
        self._done_q: "_q.Queue" = _q.Queue(maxsize=4)
        self._completer = threading.Thread(target=self._complete_loop,
                                           name=f"{name}-complete",
                                           daemon=True)
        self._completer.start()

    # -- client API --------------------------------------------------------
    def submit(self, frame) -> Future:
        """frame: single-sample array (no batch dim or batch=1)."""
        fut: Future = Future()
        with self._lock:
            if self._stop:
                raise StreamError(f"{self.name}: dispatcher is shut down")
            self._outstanding += 1
            self._pending.append((frame, fut))
        self._wake.set()
        return fut

    def stats(self) -> dict:
        """Consistent counter snapshot (one lock hold — the counters are
        incremented together under _lock, so frames/batches never tear
        mid-batch)."""
        with self._lock:
            return {"frames": self.frames, "batches": self.batches,
                    "errors": self.errors,
                    "outstanding": self._outstanding}

    def shutdown(self, cause: str = "shut down") -> None:
        # idempotent: a second shutdown (supervisor drain racing a user
        # close) must not double-join or enqueue a second sentinel
        with self._lock:
            if self._shutdown_done:
                return
            self._shutdown_done = True
            self._stop = True
        self._wake.set()
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            log.warning("dispatcher: batcher thread %s still alive after "
                        "30s join at shutdown — thread leaked",
                        self._thread.name)
        # the batcher normally drains _pending before exiting; if it died
        # or wedged, fail the leftovers with a typed error instead of
        # leaving callers blocked on futures nobody will resolve
        with self._lock:
            leftover = self._pending
            self._pending = []
            self._outstanding -= len(leftover)
            self.errors += len(leftover)
        for _, fut in leftover:
            if not fut.done():
                fut.set_exception(StreamError(
                    f"{self.name}: {cause} before the frame was "
                    f"dispatched"))
        # bounded sentinel enqueue: if the completion stage is wedged its
        # queue may be full — shutdown must still return
        try:
            self._done_q.put(None, timeout=10)
        except _q.Full:
            log.warning("dispatcher completion queue wedged at shutdown")
        self._completer.join(timeout=10)
        if self._completer.is_alive():
            log.warning("dispatcher: completer thread %s still alive after "
                        "10s join at shutdown — thread leaked",
                        self._completer.name)

    # -- batcher loop ------------------------------------------------------
    def _loop(self) -> None:
        bucket = self.buckets[-1]
        while True:
            self._wake.wait(timeout=0.1)
            with self._lock:
                if self._stop and not self._pending:
                    return
                have = len(self._pending)
            if have == 0:
                self._wake.clear()
                continue
            if have < bucket:
                # linger briefly for more frames, then flush what we have
                time.sleep(self.max_delay)
            with self._lock:
                take = self._pending[:bucket]
                del self._pending[: len(take)]
                if not self._pending:
                    self._wake.clear()
            if take:
                self._run_batch(take)

    @staticmethod
    def _squeeze(f) -> np.ndarray:
        """Accept samples with or without a leading batch=1 dim."""
        f = np.asarray(f)
        return f[0] if f.ndim > 1 and f.shape[0] == 1 else f

    def _batch(self, frames: List[np.ndarray], tgt: int) -> torch.Tensor:
        """The frames stacked and zero-padded to `tgt` rows: on a CUDA
        device assembled in pinned host memory and sent in one
        non-blocking copy, on the CPU a host tensor."""
        n = len(frames)
        shape = (tgt,) + frames[0].shape
        dev = self.device
        if dev.type == "cuda":
            first = host_tensor(frames[0])
            host = torch.empty(shape, dtype=first.dtype, pin_memory=True)
            for i, f in enumerate(frames):
                host[i].copy_(host_tensor(f))
            host[n:].zero_()
            return host.to(dev, non_blocking=True)
        batch = torch.zeros(shape, dtype=host_tensor(frames[0]).dtype)
        for i, f in enumerate(frames):
            batch[i].copy_(host_tensor(f))
        return batch.to(dev)

    def _run_batch(self, take) -> None:
        try:
            frames = [self._squeeze(f) for f, _ in take]
            n = len(frames)
            tgt = next(b for b in self.buckets if b >= n)
            out = self._run(self._batch(frames, tgt), n)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            # start every read-back now; the completion thread reads
            # them once their events are done
            self._done_q.put((tuple(_start_d2h(o) for o in outs), take, n))
        except Exception as e:  # resolve futures, never hang clients
            self._fail(take, e)

    def _fail(self, take, e: Exception) -> None:
        with self._lock:
            self.errors += len(take)
            self._outstanding -= len(take)
        for _, fut in take:
            if not fut.done():
                fut.set_exception(
                    StreamError(f"{self.name}: dispatch failed: {e}"))

    def _complete_loop(self) -> None:
        sentinel_seen = False
        while True:
            if sentinel_seen:
                # drain anything the batcher enqueued just before the
                # sentinel, then exit — no future may be left hanging
                try:
                    item = self._done_q.get_nowait()
                except _q.Empty:
                    return
            else:
                item = self._done_q.get()
            if item is None:
                sentinel_seen = True
                continue
            outs, take, n = item
            try:
                host = [_host(o) for o in outs]
                results = [tuple(h[i] for h in host)
                           for i in range(len(take))]
                # count BEFORE resolving: a caller that observed its
                # result (and then read stats()) must see these frames
                with self._lock:
                    self.frames += n
                    self.batches += 1
                    self._outstanding -= n
                for i, (_, fut) in enumerate(take):
                    fut.set_result(results[i])
            except Exception as e:
                self._fail(take, e)


class Dispatcher:
    """Batches single-frame requests onto ``fn(params, x)`` on one
    device (the JAX package's MeshDispatcher with dp 1).

    `fn` must accept a leading batch dim and return a tensor or a tuple;
    `device` comes from `backends.base.pick_device` (the card unless the
    CPU is asked for). A partial flush pads up to the SMALLEST bucket of
    ``{1, bucket}`` that fits it."""

    def __init__(self, fn: Callable, params, *, device=None,
                 bucket: int = 8, max_delay_ms: float = 2.0):
        self.device = device if isinstance(device, torch.device) \
            else pick_device(device or "")
        self.bucket = int(bucket)
        self.max_delay = max_delay_ms / 1e3
        self._fn = fn
        self._params = params
        self._core = BatchCore(self._exec, sorted({1, self.bucket}),
                               self.max_delay, device=self.device,
                               name="dispatch")

    def _exec(self, batch: torch.Tensor, n: int):
        with torch.inference_mode():
            return self._fn(self._params, batch)

    # -- client API --------------------------------------------------------
    def submit(self, frame) -> Future:
        """frame: single-sample array (no batch dim or batch=1)."""
        return self._core.submit(frame)

    @property
    def buckets(self) -> List[int]:
        return list(self._core.buckets)

    @property
    def frames(self) -> int:
        return self._core.frames

    @property
    def batches(self) -> int:
        return self._core.batches

    def stats(self) -> dict:
        return self._core.stats()

    def shutdown(self) -> None:
        self._core.shutdown()

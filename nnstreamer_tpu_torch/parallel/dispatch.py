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

`MeshDispatcher` runs ``fn(params, x)`` over the ``dp`` devices of a
mesh with buckets ``{dp, bucket}`` (a lone closed-loop frame pays dp
rows, not the bucket). JAX traces one program whose batch is split over
dp; the port drives the shards from one process: batch rows i·k to
(i+1)·k go to shard i's device (a counted copy, `mesh.Moves`), run there
against the params copied to that device, and the outputs come back to
the first shard's device in shard order, where BatchCore reads them
into pinned host memory. `Dispatcher` is the one-device case (buckets
``{1, bucket}``).
"""

from __future__ import annotations

import copy
import queue as _q
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence, Tuple

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

    `capacity` bounds the queue: submit() raises a typed StreamError once
    `outstanding` (accepted but unresolved frames) reaches it, so a slow
    device backpressures its callers (0 = unbounded).

    `raw=True` switches the payload from stackable frames to opaque
    invocation payloads: no squeeze, stack or pad; `run(items, n)` gets
    the payload list as is and returns one output tuple per item, each
    resolved as a tuple of numpy arrays (the replica path of
    serving/placement.py routes whole filter invocations). `abort` fails
    the queued payloads at once and shuts down (a fenced replica).

    Conservation contract: counters are bumped under `_lock` BEFORE
    futures resolve, so a caller that observed its result and then read
    stats() always sees its own frame counted; every accepted frame ends
    in exactly one of frames / errors / shutdown-failed.
    """

    def __init__(self, run: Callable[[Any, int], Any],
                 buckets: Sequence[int], max_delay_s: float, *,
                 device: Optional[torch.device] = None,
                 capacity: int = 0, raw: bool = False,
                 name: str = "dispatch"):
        self._run = run
        self.buckets = sorted({int(b) for b in buckets})
        if not self.buckets or self.buckets[0] < 1:
            raise StreamError(f"bad bucket set {buckets!r}")
        self.max_delay = max_delay_s
        self.device = device if device is not None else torch.device("cpu")
        self.capacity = int(capacity)
        self.raw = bool(raw)
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
            if self.capacity and self._outstanding >= self.capacity:
                raise StreamError(
                    f"{self.name}: queue full "
                    f"({self._outstanding}/{self.capacity} outstanding)")
            self._outstanding += 1
            self._pending.append((frame, fut))
        self._wake.set()
        return fut

    @property
    def outstanding(self) -> int:
        """Frames accepted but not yet resolved (queued and in flight):
        the least-outstanding router's load signal."""
        with self._lock:
            return self._outstanding

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
        if self.raw:
            self._run_raw(take)
            return
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

    def _run_raw(self, take) -> None:
        """Raw payloads: one output tuple per payload, no stack or pad;
        the same overlapped read-back (each CUDA output's copy starts
        here, the completion thread reads it)."""
        n = len(take)
        try:
            outs = self._run([p for p, _ in take], n)
            if len(outs) != n:
                raise StreamError(
                    f"raw run returned {len(outs)} results for {n} "
                    f"payloads")
            started = [tuple(_start_d2h(o) for o in per_item)
                       for per_item in outs]
            self._done_q.put((started, take, n))
        except Exception as e:
            self._fail(take, e)

    def abort(self, cause: str = "aborted") -> None:
        """Fence-style teardown: fail every queued payload at once (the
        device is gone; draining would lie), let a batch already launched
        complete, then shut down. The caller re-routes the failed
        payloads to surviving replicas."""
        with self._lock:
            if self._shutdown_done:
                return
            self._stop = True    # refuse new submits before draining
            doomed = self._pending
            self._pending = []
            self.errors += len(doomed)
            self._outstanding -= len(doomed)
        for _, fut in doomed:
            if not fut.done():
                fut.set_exception(StreamError(f"{self.name}: {cause}"))
        self.shutdown(cause)

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
                if self.raw:
                    results = [tuple(_host(o) for o in per_item)
                               for per_item in outs]
                else:
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


class MeshDispatcher:
    """Batches single-frame requests onto ``fn(params, x)`` sharded over
    the `batch_axis` devices of `mesh`.

    fn(params, x) must accept a leading batch dim and return a tensor or
    a tuple; `bucket` is the largest batch (it must divide over the
    axis). The params are copied to every shard's device once (the first
    shard's without a copy where they already lie there); `set_params`
    copies a new tree the same way and swaps it in with one assignment,
    so a batch already collected runs on the params it started with."""

    def __init__(self, fn: Callable, params, mesh, *,
                 bucket: int = 8, max_delay_ms: float = 2.0,
                 batch_axis: str = "dp"):
        from nnstreamer_tpu_torch.parallel.mesh import Moves

        n = mesh.shape[batch_axis]
        if bucket % n != 0:
            raise StreamError(
                f"bucket {bucket} must be divisible by mesh axis "
                f"{batch_axis!r} size {n}"
            )
        self.mesh = mesh
        self.bucket = int(bucket)
        self.max_delay = max_delay_ms / 1e3
        self.devices = mesh.along(batch_axis)
        self.ordinals = mesh.ordinals_along(batch_axis)
        self.device = self.devices[0]
        self.moves = Moves()
        self._fn = fn
        self._shard_batches = [0] * n
        self._placed = self._place(params)
        self._core = BatchCore(self._exec, sorted({n, self.bucket}),
                               self.max_delay, device=self.device,
                               name="mesh-dispatch" if n > 1 else "dispatch")

    def _place(self, params) -> list:
        """The params on every shard's device: shard 0's as
        `params_copy_to` gives them (no copy where they lie there), every
        other shard's a copy of its own, counted."""
        from nnstreamer_tpu_torch.backends.torch_backend import (
            params_copy_to)

        if params is None:
            return [None] * len(self.devices)
        home = params_copy_to(params, self.device)
        self.moves.count += len(self.devices) - 1
        return [home] + [_copied(home, dev) for dev in self.devices[1:]]

    def _exec(self, batch: torch.Tensor, n: int):
        placed = self._placed         # read once: the batch keeps these
        devs, ords = self.devices, self.ordinals
        k = batch.shape[0] // len(devs)
        outs = []
        with torch.inference_mode():
            for i, (dev, o) in enumerate(zip(devs, ords)):
                x = self.moves.to(batch[i * k:(i + 1) * k], dev, ords[0], o)
                out = self._fn(placed[i], x)
                outs.append(out if isinstance(out, (tuple, list)) else (out,))
                self._shard_batches[i] += 1
            if len(outs) == 1:
                return outs[0]
            return tuple(
                torch.cat([self.moves.to(o[j], self.device, ords[i], ords[0])
                           for i, o in enumerate(outs)])
                for j in range(len(outs[0])))

    # -- client API --------------------------------------------------------
    def submit(self, frame) -> Future:
        """frame: single-sample array (no batch dim or batch=1)."""
        return self._core.submit(frame)

    def infer(self, frame, timeout: Optional[float] = 30.0):
        return self.submit(frame).result(timeout)

    def set_params(self, params) -> None:
        """Swap the model parameters (hot swap): copied to every shard's
        device, then one reference assignment. Batches already collected
        keep the params they were dispatched with; shapes must match the
        old tree."""
        self._placed = self._place(params)

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
        """BatchCore's counters, the batches each shard ran (in shard
        order) and the copies between logical devices so far."""
        out = self._core.stats()
        out["shard_batches"] = list(self._shard_batches)
        out["transfers"] = self.moves.count
        return out

    def shutdown(self) -> None:
        self._core.shutdown()


def _copied(params, device: torch.device):
    """A copy of a model's params on `device` (a module deep-copied, a
    tree's every tensor), even where they already lie there."""
    if isinstance(params, torch.nn.Module):
        return copy.deepcopy(params).to(device).eval()
    if isinstance(params, torch.Tensor):
        return params.detach().to(device, copy=True)
    if isinstance(params, dict):
        return {k: _copied(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_copied(v, device) for v in params)
    return params


class Dispatcher(MeshDispatcher):
    """Batches single-frame requests onto ``fn(params, x)`` on one
    device (the JAX package's MeshDispatcher with dp 1).

    `fn` must accept a leading batch dim and return a tensor or a tuple;
    `device` comes from `backends.base.pick_device` (the card unless the
    CPU is asked for). A partial flush pads up to the SMALLEST bucket of
    ``{1, bucket}`` that fits it."""

    def __init__(self, fn: Callable, params, *, device=None,
                 bucket: int = 8, max_delay_ms: float = 2.0):
        from nnstreamer_tpu_torch.parallel.mesh import Mesh

        device = device if isinstance(device, torch.device) \
            else pick_device(device or "")
        super().__init__(fn, params, Mesh(np.array([device], dtype=object),
                                          ("dp",)),
                         bucket=bucket, max_delay_ms=max_delay_ms)

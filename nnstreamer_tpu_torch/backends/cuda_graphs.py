"""CUDA graphs for the compiled windows: capture, replay, and the launch
counts a replay adds.

The port's counterpart of the JAX package's jitted K-step ``lax.scan``
is one CUDA graph per window key, captured from the per-frame (per-step)
path itself and replayed with one launch (`TorchBackend.invoke_window`,
`PagedLLMExecutor.decode_multi`). This module owns what every capture
shares:

- **One capture at a time** in the process (`_capture_lock`):
  ``torch.cuda.graph`` synchronises the device and empties the caching
  allocator on entry, which must not cut into another thread's capture.
- **Capture mode** ``thread_local`` (`CAPTURE_MODE`): the scheduler's
  other threads keep launching, allocating (``cudaMalloc`` when the
  caching allocator grows, pinned host buffers for read-backs) and
  reading back while one filter captures; under ``global`` any of those
  calls from another thread would invalidate the capture. The capturing
  thread itself still may make no unsafe call.
- **Launch counts**: every kernel wrapper counts through `count_launch`.
  Outside a capture that adds one to the wrapper's counters; inside a
  capture on this thread it adds one to the capture's `Tally` instead,
  since a captured launch runs only when the graph replays, and
  `Graph.run` adds the tally at every replay. Nothing is counted twice.
- **Buffers a captured launch reads through a baked address** (the paged
  decode kernel's workspace and tickets) are held by the graph
  (`count_launch(..., keep=...)`), so a cache that replaces them cannot
  free memory a graph still replays into.

- **One cache of graphs per backend or executor** (`GraphCache`): the
  graphs of the model version it holds, keyed by window, with one memory
  pool and one side stream, so the graphs of several window sizes share
  their activations; the keys whose capture failed, with the error, so
  a later window raises at once. A new version drops them all and takes
  a fresh pool: PyTorch refuses to capture again into a pool whose
  graphs are all gone while it still holds blocks, such as the capture
  stream's cuBLAS workspace. A backend serving a ``store://`` model
  keeps one cache for each live version (current and canary), so the
  windows of two versions in turns each replay their own graphs.

A window's static inputs are allocated outside the graph's pool; its
outputs live in the pool and are cloned by the caller before they
leave, since the next replay overwrites them. A failed capture raises
`BackendError` naming what was captured and the CUDA error; nothing
runs eagerly in its place.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from nnstreamer_tpu_torch.core.errors import BackendError

#: cudaStreamCaptureMode of every capture (see the module docstring)
CAPTURE_MODE = "thread_local"

_tls = threading.local()
_capture_lock = threading.Lock()
#: told ``(wrapper name, n)`` of every launch `count_launch` counts, when
#: set (`observe_launches`)
_observer: Optional[Callable[[str, int], None]] = None


def observe_launches(fn: Optional[Callable[[str, int], None]]) -> None:
    """Report every counted launch to ``fn(kernel, n)`` as well — at the
    launch outside a capture, and n at each replay of a graph that holds
    n — or stop reporting with None. A pool worker child passes its
    tracer's `record_launches`, so the parent reads the child's launches
    from the shipped trace deltas."""
    global _observer
    _observer = fn


class Tally:
    """What one capture recorded: kernel launches by (wrapper, counter
    name), and the buffers its launches read or write by address."""

    __slots__ = ("launches", "keep")

    def __init__(self):
        self.launches: Dict[Tuple[Any, str], int] = {}
        self.keep: list = []

    def add(self) -> None:
        """One replay: each captured launch ran once more."""
        for (fn, attr), n in self.launches.items():
            setattr(fn, attr, getattr(fn, attr) + n)
            if attr == "launches" and _observer is not None:
                _observer(fn.__name__, n)


def count_launch(fn, *counters: str, keep: Sequence[Any] = ()) -> None:
    """One launch of the kernel wrapper `fn`: +1 on ``fn.launches`` and on
    each counter named in `counters` (the variant counts) — or, while this
    thread captures a graph, +1 in the capture's tally, which every replay
    adds. `keep`: buffers the launch reads through their address, held by
    the graph being captured (outside a capture nothing holds them). The
    observer, if any, hears of each counted launch."""
    tally = getattr(_tls, "tally", None)
    if tally is None:
        fn.launches += 1
        for attr in counters:
            setattr(fn, attr, getattr(fn, attr) + 1)
        if _observer is not None:
            _observer(fn.__name__, 1)
        return
    for attr in ("launches",) + counters:
        key = (fn, attr)
        tally.launches[key] = tally.launches.get(key, 0) + 1
    tally.keep.extend(keep)


class Graph:
    """One captured body with its static buffers.

    `run(inputs)` copies `inputs` into the static inputs, replays once on
    the current stream, adds the captured launches to the wrappers'
    counters and returns the static outputs (valid until the next
    replay). `keep` holds what the captured launches read by address
    (parameters, workspaces); `seconds` is the capture's host time."""

    __slots__ = ("graph", "inputs", "outputs", "tally", "keep", "seconds")

    def __init__(self, graph, inputs, outputs, tally: Tally, keep,
                 seconds: float):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.tally, self.keep, self.seconds = tally, keep, seconds

    def run(self, inputs: Sequence[torch.Tensor]):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.graph.replay()
        self.tally.add()
        return self.outputs


def capture(body: Callable[..., Any], inputs: Sequence[torch.Tensor], *,
            what: str, pool=None, stream=None, keep: Sequence[Any] = (),
            graph=None, context=None) -> Graph:
    """Capture ``body(*inputs)`` into a CUDA graph → `Graph`.

    `inputs` become the graph's static inputs (allocate them outside
    `pool`); `pool` and `stream` are the caller's graph pool and side
    stream; `keep` what the graph must hold (the params it bakes in). The
    body must have run eagerly once at these shapes before (lazy
    initialisation, library handles). `graph` and `context` replace the
    CUDA graph and ``torch.cuda.graph(...)`` — a stand-in for the tests
    of the bookkeeping. Raises `BackendError` naming `what` and the
    error."""
    if graph is None:
        graph = torch.cuda.CUDAGraph()
    tally = Tally()
    with _capture_lock:
        t0 = time.perf_counter()
        _tls.tally = tally
        try:
            if context is None:
                context = torch.cuda.graph(graph, pool=pool, stream=stream,
                                           capture_error_mode=CAPTURE_MODE)
            with context:
                outputs = body(*inputs)
        except Exception as e:
            raise BackendError(
                f"CUDA graph capture of {what} failed: "
                f"{type(e).__name__}: {e}") from e
        finally:
            _tls.tally = None
        seconds = time.perf_counter() - t0
    return Graph(graph, tuple(inputs), outputs, tally,
                 tuple(keep) + tuple(tally.keep), seconds)


class GraphCache:
    """The CUDA graphs of one backend or executor, for one model version.

    `use(version)` at a window boundary: a version other than the one
    held drops every graph and remembered failure and the pool with them
    (each graph holds the params it baked in until then), so a graph is
    only ever found for the version it was captured from. `get(key)` →
    the graph or None, and raises the remembered error of a key whose
    capture failed. `capture(key, ...)` captures, remembers, counts
    (`captures`, `capture_seconds`) and returns the graph. Only the
    thread that runs the windows calls these."""

    def __init__(self):
        self.version: Hashable = None
        self.graphs: Dict[Hashable, Graph] = {}
        self.failed: Dict[Hashable, str] = {}
        self.captures = 0
        self.capture_seconds: list = []
        self._pool = None
        self._stream = None

    def use(self, version: Hashable) -> bool:
        """Hold `version`; True when that dropped another version's."""
        if version == self.version:
            return False
        self.graphs.clear()
        self.failed.clear()
        self._pool = None
        self.version = version
        return True

    def drop(self) -> None:
        """Drop every graph, remembered failure and the pool, keeping the
        version held and the capture counts (a release under memory
        pressure, or a version leaving a backend's live set)."""
        self.graphs.clear()
        self.failed.clear()
        self._pool = None

    def get(self, key: Hashable) -> Optional[Graph]:
        failed = self.failed.get(key)
        if failed is not None:
            raise BackendError(failed)
        return self.graphs.get(key)

    def capture(self, key: Hashable, body: Callable[..., Any],
                inputs: Sequence[torch.Tensor], *, what: str,
                keep: Sequence[Any] = ()) -> Graph:
        """Capture ``body`` on static copies of `inputs` (see `capture`)
        into this cache's pool, on its side stream."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._stream is None:
            self._stream = torch.cuda.Stream(inputs[0].device)
        static = [torch.empty_like(t) for t in inputs]
        try:
            g = capture(body, static, pool=self._pool, stream=self._stream,
                        keep=keep, what=what)
        except BackendError as e:
            self.failed[key] = str(e)
            raise
        self.graphs[key] = g
        self.captures += 1
        self.capture_seconds.append(g.seconds)
        return g

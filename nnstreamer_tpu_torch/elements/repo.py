"""tensor_repo — out-of-band buffer repository for feedback loops.

Reference parity: gsttensor_reposink.c / gsttensor_reposrc.c /
gsttensor_repo.c — a global slot-indexed repository passing buffers
outside the link graph, the sanctioned way to build cycles (RNN/LSTM
state, tests/nnstreamer_repo_{rnn,lstm}). The pipeline DAG stays acyclic;
the repo closes the loop.

Semantics: reposink writes its input buffer into slot N; reposrc reads
slot N, emitting one buffer per read. reposrc must produce the *first*
buffer itself (the loop has no data yet): host zeros shaped by
dims/types — the recurrent-state initializer. Every later buffer is what
the sink was given, by reference: behind a filter the state stays a
tensor on the card, and the loop makes no host sync of its own.

`REPO` is the port's own module-global table (the JAX package keeps
another). Teardown never leaves a thread waiting: the sink's put gives
up when the pipeline stops, and the source's `interrupt()` and the
sink's `stop()` put a `None` sentinel that ends `generate()`.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from fractions import Fraction
from typing import Dict, Iterator

import numpy as np

from nnstreamer_tpu_torch.core.errors import PipelineError, StreamError
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import (
    PropDef, SinkElement, SourceElement, StreamSpec)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec


class _Repo:
    """Global slot table (gsttensor_repo.c analog)."""

    def __init__(self):
        self._slots: Dict[int, _queue.Queue] = {}
        self._lock = threading.Lock()

    def slot(self, idx: int) -> _queue.Queue:
        with self._lock:
            if idx not in self._slots:
                self._slots[idx] = _queue.Queue(maxsize=16)
            return self._slots[idx]

    def reset(self) -> None:
        with self._lock:
            self._slots.clear()


REPO = _Repo()


@register_element("tensor_repo_sink")
class TensorRepoSink(SinkElement):
    ELEMENT_NAME = "tensor_repo_sink"
    PROPS = {
        "slot": PropDef(int, 0, "repository slot index"),
        "put_timeout": PropDef(float, 10.0,
                               "seconds to wait for a free slot entry"),
    }

    def render(self, buf: TensorBuffer) -> None:
        slot = self.props["slot"]
        q = REPO.slot(slot)
        # bounded, stop-aware wait: a pipeline tearing down (e.g. another
        # element failed) must not leave this worker parked the full
        # timeout on a slot nobody will ever drain
        deadline = time.monotonic() + self.props["put_timeout"]
        while True:
            try:
                q.put(buf, timeout=0.2)
                return
            except _queue.Full:
                if self._stop_evt is not None and self._stop_evt.is_set():
                    raise StreamError(
                        f"tensor_repo_sink {self.name}: pipeline stopping "
                        f"while waiting on full repo slot {slot}") from None
                if time.monotonic() >= deadline:
                    raise StreamError(
                        f"tensor_repo_sink {self.name}: repo slot {slot} "
                        f"still full after {self.props['put_timeout']:.1f}s "
                        f"— is the matching tensor_repo_src consuming, and "
                        f"is the feedback loop making progress?") from None

    def stop(self) -> None:
        # wake a blocked reposrc at teardown
        try:
            REPO.slot(self.props["slot"]).put_nowait(None)
        except _queue.Full:
            pass


@register_element("tensor_repo_src")
class TensorRepoSrc(SourceElement):
    """Reads slot N. Emits `initial` zero-buffers first to prime the loop,
    then one buffer per reposink write, until `count` total buffers."""

    ELEMENT_NAME = "tensor_repo_src"
    PROPS = {
        "slot": PropDef(int, 0),
        "dims": PropDef(str, None, "state tensor dims (zeros initializer)"),
        "types": PropDef(str, "float32"),
        "initial": PropDef(int, 1, "number of priming zero-buffers"),
        "count": PropDef(int, 0, "total buffers to emit; 0 = until stopped"),
        "rate": PropDef(str, "0/1"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._stop = threading.Event()

    def start(self) -> None:
        # purge stale buffers / teardown sentinels a previous run left in
        # this slot, so every pipeline run starts from a clean loop state
        q = REPO.slot(self.props["slot"])
        while True:
            try:
                q.get_nowait()
            except _queue.Empty:
                break

    def output_spec(self) -> StreamSpec:
        if not self.props["dims"]:
            raise PipelineError(
                f"tensor_repo_src {self.name}: dims= is required (shapes "
                f"the priming zero-state)")
        return TensorsSpec.from_strings(
            self.props["dims"], self.props["types"],
            rate=Fraction(self.props["rate"]))

    def interrupt(self) -> None:
        self._stop.set()
        try:
            REPO.slot(self.props["slot"]).put_nowait(None)
        except _queue.Full:
            pass

    def generate(self) -> Iterator[TensorBuffer]:
        spec: TensorsSpec = self.out_specs[0]
        emitted = 0
        count = self.props["count"]
        for _ in range(self.props["initial"]):
            zeros = tuple(np.zeros(t.shape, t.dtype.np_dtype)
                          for t in spec.tensors)
            yield TensorBuffer(tensors=zeros, pts=0)
            emitted += 1
            if count and emitted >= count:
                return
        q = REPO.slot(self.props["slot"])
        while not self._stop.is_set():
            item = q.get()
            if item is None:
                return
            yield item
            emitted += 1
            if count and emitted >= count:
                return

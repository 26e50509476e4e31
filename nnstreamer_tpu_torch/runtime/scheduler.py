"""Push-model streaming scheduler, per-frame mode.

One worker thread per element with a bounded input channel per element —
the analog of GStreamer's streaming threads plus queues. Every link is
double-buffered, so a filter's device work overlaps upstream conversion.

- Sources run a pump thread iterating `generate()`.
- Every buffer goes to `Element.process(pad, buf)`; emissions are routed
  by (element, src_pad) → link → destination channel.
- EOS: one sentinel per pad; when all sink pads of an element saw EOS,
  its `flush()` drains, then EOS cascades.
- Errors: any exception in a worker stops the pipeline and re-raises
  from `wait()` (fail loud, never hang).
- Backpressure: bounded channels block the producer ([runtime]
  queue_capacity).
- Async dispatch window ([runtime] max_inflight): a DEVICE_RESIDENT
  element's worker passes its outputs on while their device work is
  still queued, and syncs the oldest once more than max_inflight are in
  flight. Sinks and host decoders are the pipeline's sync points; EOS
  drains the window before it propagates.
- Timers: a worker bounds its channel wait by its element's
  `next_deadline()` and fires `on_timer()` when it passes with no input
  (tensor_llm runs one serving step per fire). An element with no
  deadline waits on its channel exactly as before.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.core.config import get_config
from nnstreamer_tpu_torch.core.errors import PipelineError, StreamError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.graph.pipeline import Element, Link, Pipeline, SourceElement
from nnstreamer_tpu_torch.runtime.channel import CLOSED, TIMED_OUT, Channel
from nnstreamer_tpu_torch.runtime.sync import device_sync
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

log = get_logger("runtime")


class _EOSType:
    def __repr__(self):
        return "EOS"


#: end-of-stream sentinel
EOS = _EOSType()


class PipelineRunner:
    """Runs a negotiated pipeline: one worker thread per element."""

    def __init__(self, pipeline: Pipeline, queue_capacity: Optional[int] = None,
                 optimize: bool = True, max_inflight: Optional[int] = None):
        self.pipeline = pipeline
        self._optimize = optimize
        cfg = get_config()
        self._cap = max(1, queue_capacity
                        or cfg.get_int("runtime", "queue_capacity", 4))
        if max_inflight is None:
            max_inflight = cfg.get_int("runtime", "max_inflight", 8)
        self._max_inflight = max(0, max_inflight)
        self._queues: Dict[str, Channel] = {}
        self._threads: List[threading.Thread] = []
        self._stop_evt = threading.Event()
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._started = False
        self._route: Dict[Tuple[str, int], Link] = {}

    def start(self) -> "PipelineRunner":
        if self._started:
            raise PipelineError("runner already started")
        pipe = self.pipeline
        if not pipe._negotiated:
            if self._optimize:
                from nnstreamer_tpu_torch.graph.optimize import fuse_transforms

                fuse_transforms(pipe)
            pipe.negotiate()
        for e in pipe.elements.values():
            e.start()
        for l in pipe.links:
            self._route[(l.src.name, l.src_pad)] = l
        for e in pipe.elements.values():
            if isinstance(e, SourceElement):
                t = threading.Thread(target=self._pump, args=(e,),
                                     name=f"src:{e.name}", daemon=True)
            else:
                self._queues[e.name] = Channel(self._cap)
                t = threading.Thread(target=self._work, args=(e,),
                                     name=f"elem:{e.name}", daemon=True)
            self._threads.append(t)
        self._started = True
        for t in self._threads:
            t.start()
        return self

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every element finished (EOS fully propagated)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._threads:
            while t.is_alive():
                if deadline is not None and time.monotonic() >= deadline:
                    self.stop()
                    raise StreamError(
                        f"pipeline {self.pipeline.name!r} did not finish "
                        f"within {timeout}s (thread {t.name} still running)"
                    ) from self._error
                if self._error is not None:
                    # a worker failed: the rest are being torn down; give
                    # them a bounded grace instead of hanging the caller
                    self.stop()
                    t.join(5.0)
                    break
                t.join(0.2)
        if self._error is not None:
            raise StreamError(
                f"pipeline {self.pipeline.name!r} failed: {self._error}"
            ) from self._error

    def stop(self) -> None:
        """Request teardown; safe to call multiple times."""
        self._stop_evt.set()
        for e in self.pipeline.elements.values():
            if isinstance(e, SourceElement):
                try:
                    e.interrupt()
                except Exception:
                    log.exception("error interrupting %s", e.name)
        for ch in self._queues.values():
            ch.close()
        for e in self.pipeline.elements.values():
            try:
                e.stop()
            except Exception:  # teardown must not mask the first error
                log.exception("error stopping %s", e.name)

    def run(self, timeout: Optional[float] = None) -> None:
        self.start()
        try:
            self.wait(timeout)
        finally:
            self.stop()

    def _fail(self, elem: Element, exc: BaseException) -> None:
        with self._error_lock:
            if self._error is None:
                self._error = exc
        log.error("element %s failed: %s", elem.name, exc)
        self._stop_evt.set()
        for ch in self._queues.values():
            ch.close()

    def _emit(self, elem: Element, src_pad: int, item) -> None:
        link = self._route.get((elem.name, src_pad))
        if link is None:
            raise PipelineError(
                f"element {elem.name} emitted on unlinked src pad {src_pad}")
        if self._queues[link.dst.name].put((link.dst_pad, item)) is None \
                and item is not EOS:
            log.debug("teardown dropped a buffer from %s -> %s (pts=%s)",
                      elem.name, link.dst.name, getattr(item, "pts", None))

    def _broadcast_eos(self, elem: Element) -> None:
        for l in self.pipeline.links_from(elem):
            self._emit(elem, l.src_pad, EOS)

    def _pump(self, src: SourceElement) -> None:
        try:
            for buf in src.generate():
                if self._stop_evt.is_set():
                    break
                self._emit(src, 0, buf)
            self._broadcast_eos(src)
        except Exception as e:
            self._fail(src, e)

    def _work(self, elem: Element) -> None:
        ch = self._queues[elem.name]
        n_pads = max(1, len(self.pipeline.links_to(elem)))
        eos_pads = set()
        window = deque() if elem.DEVICE_RESIDENT else None
        try:
            while not self._stop_evt.is_set():
                # deadline-aware wait: the channel wait ends at the
                # element's next deadline, so a timer element wakes up
                # without input; no deadline = a plain blocking get
                deadline = elem.next_deadline()
                if deadline is not None and time.perf_counter() >= deadline:
                    for sp, b in elem.on_timer():
                        self._emit(elem, sp, b)
                    continue
                msg, _ = ch.get(deadline)
                if msg is CLOSED:  # teardown wakeup
                    return
                if msg is TIMED_OUT:  # deadline due: fire on the next turn
                    continue
                pad, item = msg
                if item is EOS:
                    eos_pads.add(pad)
                    if len(eos_pads) >= n_pads:
                        for sp, b in elem.flush():
                            self._emit(elem, sp, b)
                        # nothing behind the EOS is still unresolved
                        while window:
                            device_sync(window.popleft(), forced=False)
                        self._broadcast_eos(elem)
                        return
                    continue
                for sp, b in elem.process(pad, item):
                    self._emit(elem, sp, b)
                    if window is not None and isinstance(b, TensorBuffer) \
                            and b.on_device:
                        window.append(b.tensors)
                while window and len(window) > self._max_inflight:
                    device_sync(window.popleft(), forced=False)
        except Exception as e:
            self._fail(elem, e)


def run_pipeline(pipeline: Pipeline, timeout: Optional[float] = None,
                 optimize: bool = True) -> None:
    """Negotiate (with transform fusion by default), run to EOS, tear
    down. The gst-launch behavior."""
    PipelineRunner(pipeline, optimize=optimize).run(timeout)

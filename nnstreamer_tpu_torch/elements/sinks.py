"""Sink elements.

Reference parity: gsttensor_sink.c (appsink-like `new-data`/`eos` signals
with signal-rate limiting :56-109,168-171), fakesink, and filesink (the
reference test pipelines' standard result capture — e.g.
tests/nnstreamer_filter_deepview_rt/runTest.sh writes the decoded label
with `filesink location=class.out.log`).

`tensor_sink to_host=true` (the default) is the pipeline's one D2H point:
its forced sync is counted and traced under the sink. With
`to_host=false` the results stay where they arrived — CUDA tensors stay
on the card, unsynced. signal-rate reads the module's `_monotonic` clock,
so a test can drive it.
"""

from __future__ import annotations

import threading
import time
from typing import List

import numpy as np

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import PropDef, SinkElement, prop_bool
from nnstreamer_tpu_torch.runtime.sync import device_sync
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

#: signal-rate's clock (time.monotonic; a test may replace it)
_monotonic = time.monotonic


@register_element("tensor_sink")
class TensorSink(SinkElement):
    """Collects buffers into `.results` and fires a `new_data(buffer)`
    callback.

    signal-rate (signals/sec, 0 = every buffer) rate-limits the callback
    as the reference's signal-rate property does; collection into
    `.results` is never throttled (appsink pull analog). max-results
    keeps only the newest N.
    """

    WANTS_HOST = True
    ELEMENT_NAME = "tensor_sink"
    PROPS = {
        "new_data": PropDef(lambda s: s, None, "callback(buffer) (programmatic)"),
        "signal_rate": PropDef(int, 0, "max callbacks/sec, 0=all"),
        "collect": PropDef(prop_bool, True, "keep buffers in .results"),
        "max_results": PropDef(int, 0, "cap .results length, 0=unbounded"),
        "to_host": PropDef(prop_bool, True, "D2H-sync buffers at the sink"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.results: List[TensorBuffer] = []
        self._lock = threading.Lock()
        self._last_signal = 0.0
        self.eos = threading.Event()

    def render(self, buf: TensorBuffer) -> None:
        if self.props["to_host"]:
            buf = buf.to_host(self._tracer, self.name)
        with self._lock:
            if self.props["collect"]:
                self.results.append(buf)
                cap = self.props["max_results"]
                if cap and len(self.results) > cap:
                    del self.results[: len(self.results) - cap]
        cb = self.props["new_data"]
        if cb is not None:
            rate = self.props["signal_rate"]
            now = _monotonic()
            if not rate or (now - self._last_signal) >= 1.0 / rate:
                self._last_signal = now
                cb(buf)

    def flush(self):
        self.eos.set()
        return []


@register_element("filesink")
class FileSink(SinkElement):
    """Writes each buffer's raw bytes to a file (gst filesink analog).

    Text streams (e.g. the image_labeling decoder's label output) land
    as readable text; tensor streams land as their raw little-endian
    bytes — the same thing gst filesink would write, so the reference's
    golden-file test recipes (`filesink location=class.out.log` →
    compare) port verbatim. `append=false` (default) truncates at
    negotiation, before any buffer flows."""

    WANTS_HOST = True
    ELEMENT_NAME = "filesink"
    PROPS = {
        "location": PropDef(str, None, "output file path"),
        "append": PropDef(prop_bool, False, "append instead of truncate"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if not self.props["location"]:
            raise PipelineError(
                f"filesink {self.name}: location= is required")
        self._fh = None
        self.count = 0

    def negotiate(self, in_specs):
        # open (and truncate) at pipeline start, like gst filesink at
        # state change — a run that produces zero buffers must not
        # leave a previous run's output behind a passing golden compare
        self._handle()
        return super().negotiate(in_specs)

    def _handle(self):
        if self._fh is None:
            mode = "ab" if self.props["append"] else "wb"
            self._fh = open(self.props["location"], mode)
        return self._fh

    def render(self, buf: TensorBuffer) -> None:
        fh = self._handle()
        for t in buf.to_host(self._tracer, self.name).tensors:
            fh.write(np.asarray(t).tobytes())
        fh.flush()
        self.count += 1

    def flush(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        return []


@register_element("fakesink")
class FakeSink(SinkElement):
    """Discards everything; `sync-device=true` waits for each buffer's
    device work first (for timing runs)."""

    ELEMENT_NAME = "fakesink"
    PROPS = {
        "sync_device": PropDef(prop_bool, False,
                               "wait for device tensors (timing runs)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.count = 0

    def render(self, buf: TensorBuffer) -> None:
        if self.props["sync_device"]:
            device_sync(buf.tensors, self._tracer, self.name)
        self.count += 1

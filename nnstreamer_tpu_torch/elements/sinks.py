"""Sink elements (gsttensor_sink.c appsink-like collection, fakesink)."""

from __future__ import annotations

import threading
from typing import List

from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import PropDef, SinkElement, prop_bool
from nnstreamer_tpu_torch.runtime.sync import device_sync
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer


@register_element("tensor_sink")
class TensorSink(SinkElement):
    """Collects buffers (as host numpy) into `.results` and fires a
    `new_data(buffer)` callback per buffer."""

    ELEMENT_NAME = "tensor_sink"
    PROPS = {
        "new_data": PropDef(lambda s: s, None, "callback(buffer) (programmatic)"),
        "collect": PropDef(prop_bool, True, "keep buffers in .results"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.results: List[TensorBuffer] = []
        self._lock = threading.Lock()
        self.eos = threading.Event()

    def render(self, buf: TensorBuffer) -> None:
        # the single D2H point of the pipeline; its forced sync is
        # counted and traced under this element
        buf = buf.to_host(self._tracer, self.name)
        if self.props["collect"]:
            with self._lock:
                self.results.append(buf)
        cb = self.props["new_data"]
        if cb is not None:
            cb(buf)

    def flush(self):
        self.eos.set()
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

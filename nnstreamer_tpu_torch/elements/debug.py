"""tensor_debug — passthrough stream introspection.

Reference parity: gsttensor_debug.c — prints caps/meta of passing
buffers. Here it logs the negotiated spec and a per-buffer summary
(shape/dtype/pts/device residency) through the framework logger, with
`output=console|log` and a `capture` deque for tests, bounded by
`capture-limit` so a long-running pipeline cannot grow it without bound.
`verbose=true` adds min/max/mean per tensor, which reads a device tensor
back (a forced sync, counted and traced like any read-back).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Sequence

import numpy as np

from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import Element, Emission, PropDef, StreamSpec, prop_bool
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

log = get_logger("elements.debug")


@register_element("tensor_debug")
class TensorDebug(Element):
    ELEMENT_NAME = "tensor_debug"
    PROPS = {
        "output": PropDef(str, "log", "log|console"),
        "verbose": PropDef(prop_bool, False, "include value stats"),
        "capture": PropDef(prop_bool, False, "record lines in .lines"),
        "capture_limit": PropDef(int, 1000,
                                 "max captured lines kept (oldest dropped)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        limit = max(1, int(self.props["capture_limit"]))
        self.lines: Deque[str] = deque(maxlen=limit)
        self.buffers_seen = 0
        self._captured_total = 0

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        self._say(f"{self.name}: negotiated {in_specs[0]}")
        return [in_specs[0]]

    def _say(self, line: str) -> None:
        if self.props["capture"]:
            self.lines.append(line)
            self._captured_total += 1
        if self.props["output"] == "console":
            print(line)
        else:
            log.info("%s", line)

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        self.buffers_seen += 1
        desc = repr(buf)
        if self.props["verbose"]:
            stats = []
            for a in buf.to_host(self._tracer, self.name).tensors:
                a = np.asarray(a)
                if a.dtype.kind in "fiu" and a.size:
                    stats.append(f"min={a.min():.4g} max={a.max():.4g} "
                                 f"mean={a.mean():.4g}")
                else:
                    stats.append("-")
            desc += " [" + "; ".join(stats) + "]"
        self._say(f"{self.name}: {desc}")
        return [(0, buf)]

    def extra_stats(self) -> dict:
        return {
            "buffers_seen": self.buffers_seen,
            "captured_lines": len(self.lines),
            "capture_dropped": self._captured_total - len(self.lines),
        }

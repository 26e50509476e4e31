"""tensor_fault — deterministic fault injection for robustness testing.

A passthrough element to splice anywhere. Faults are *seeded* — the same
seed and stream give the same fault frames, in this port and in the JAX
package alike (the same `np.random.default_rng(seed)` draw per buffer),
so a failing chaos run is replayable.

Modes:
- ``raise``          raise FaultInjected (exercises error-policy paths)
- ``corrupt``        cast tensors to a wrong dtype (breaks downstream
                     dtype expectations)
- ``corrupt-shape``  flatten tensors to 1-D (breaks shape expectations)
- ``delay``          sleep ``delay-ms`` before passing through
                     (exercises the watchdog stall budget; stop-aware)
- ``drop``           swallow the buffer (emits nothing)

Fault frames are picked by ``period`` (every Nth buffer, deterministic)
or ``probability`` (seeded RNG), capped by ``max-faults``. Host (numpy)
and device (torch) tensors are corrupted alike.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.core.errors import FaultInjected, PipelineError
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import Element, Emission, PropDef, StreamSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType

_MODES = ("raise", "corrupt", "corrupt-shape", "delay", "drop")


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    """The torch dtype of numpy dtype `dt`: a stream dtype's from the
    port's table (bfloat16 included, which `torch.from_numpy` refuses),
    any other (bool, complex) as `torch.from_numpy` maps it."""
    try:
        return DType.from_np(dt).torch_dtype
    except ValueError:
        return torch.from_numpy(np.zeros(0, dt)).dtype


@register_element("tensor_fault")
class TensorFault(Element):
    ELEMENT_NAME = "tensor_fault"
    # a passthrough: a micro-batched stream flows through untouched
    # (faults then apply per coalesced buffer, not per frame)
    ACCEPTS_DYN_BATCH = True
    PROPS = {
        "mode": PropDef(str, "raise", "|".join(_MODES)),
        "probability": PropDef(float, 0.0, "per-buffer fault probability"),
        "period": PropDef(int, 0, "fault every Nth buffer (0 = off)"),
        "seed": PropDef(int, 0, "RNG seed (probability mode)"),
        "delay_ms": PropDef(float, 100.0, "sleep for mode=delay"),
        "max_faults": PropDef(int, 0, "stop injecting after N (0 = no cap)"),
        "corrupt_dtype": PropDef(str, "uint8", "target dtype for mode=corrupt"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._rng = np.random.default_rng(self.props["seed"])
        self._frame = 0
        self.injected = 0
        self.passed = 0

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        mode = self.props["mode"]
        if mode not in _MODES:
            self.fail_negotiation(
                f"unknown mode {mode!r}; expected one of {'|'.join(_MODES)}")
        if self.props["probability"] < 0 or self.props["probability"] > 1:
            self.fail_negotiation(
                f"probability={self.props['probability']} outside [0, 1]")
        return [in_specs[0]]

    def _should_fault(self) -> bool:
        if self.props["max_faults"] and self.injected >= self.props["max_faults"]:
            return False
        period = self.props["period"]
        if period > 0:
            return self._frame % period == 0
        p = self.props["probability"]
        return p > 0 and self._rng.random() < p

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        self._frame += 1
        if not self._should_fault():
            self.passed += 1
            return [(pad, buf)]
        self.injected += 1
        mode = self.props["mode"]
        if mode == "raise":
            raise FaultInjected(
                f"tensor_fault {self.name}: injected failure on buffer "
                f"#{self._frame} (pts={buf.pts}, seed={self.props['seed']})")
        if mode == "drop":
            return []
        if mode == "delay":
            # stop-aware sleep: teardown mid-delay wakes at once (the
            # runner installs _stop_evt; standalone use sleeps)
            delay = self.props["delay_ms"] / 1e3
            if self._stop_evt is not None:
                self._stop_evt.wait(delay)
            else:
                time.sleep(delay)
            self.passed += 1
            return [(pad, buf)]
        if mode == "corrupt":
            try:
                dt = np.dtype(self.props["corrupt_dtype"])
            except TypeError:
                raise PipelineError(
                    f"tensor_fault {self.name}: bad corrupt-dtype "
                    f"{self.props['corrupt_dtype']!r}") from None
            bad = tuple(t.to(_torch_dtype(dt)) if isinstance(t, torch.Tensor)
                        else np.asarray(t).astype(dt) for t in buf.tensors)
        else:  # corrupt-shape
            bad = tuple(t.reshape(-1) for t in buf.tensors)
        return [(pad, buf.with_tensors(bad))]

    def extra_stats(self) -> dict:
        return {"faults_injected": self.injected,
                "buffers_passed": self.passed}

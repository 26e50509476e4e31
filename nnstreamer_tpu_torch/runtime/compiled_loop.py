"""Steady-state detector for the scheduler's compiled multi-step loop
(counterpart of the JAX package's runtime/compiled_loop.py).

A pipeline in steady state — the same tensor signature frame after
frame, as a camera or an open-loop benchmark produces — pays the same
host work on every frame. After the detector arms, the scheduler sweeps
the frames already queued on a tensor_filter's channel into one window
(`TensorFilter.process_window` → `TorchBackend.invoke_window`); on the
card the backend runs the window as one replay of a CUDA graph captured
from the per-frame path (backends/cuda_graphs.py), where the JAX package
runs one jitted K-step ``lax.scan``.

Entry and exit are guarded, never speculative:

- the detector arms only after ``arm_after`` consecutive frames with an
  identical signature (shapes + dtypes + dyn-batch count);
- any divergence drops straight back to per-frame mode with the cause
  accounted (``shape``, ``error``, ``swap``, ``timer``, ``eos``) and
  stats reconciled exactly; a window that fails re-runs its frames
  through the per-frame path so error policies land on the precise
  frame that faulted;
- EOS drains whatever partial window was collected, then cascades.

This module is host-only: signatures, arming, and the bail ledger.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

#: bail causes, in the order report() prints them
BAIL_CAUSES = ("shape", "error", "swap", "timer", "eos")


def frame_signature(buf) -> Optional[Tuple]:
    """Steady-state identity of one frame: per-tensor (shape, dtype) plus
    the dynamic-batch row count when present. Two frames with equal
    signatures run the same captured graph; a signature change is a
    window bail. Reads only ``.shape``/``.dtype`` of numpy arrays and
    torch tensors alike — never the data, so a CUDA tensor is never
    synchronised on the scheduler's hot path."""
    try:
        tensors = buf.tensors
    except Exception:
        return None           # non-tensor payloads never enter a window
    rows = []
    for t in tensors:
        dt = getattr(t, "dtype", None)
        shape = getattr(t, "shape", None)
        if dt is None or shape is None:   # dtype-less payload: per frame
            return None
        rows.append((tuple(shape), str(dt)))
    sig: Tuple = tuple(rows)
    dyn = buf.meta.get("dyn_batch") if isinstance(buf.meta, dict) else None
    if isinstance(dyn, dict) and "n" in dyn:
        sig = sig + (("dyn_n", int(dyn["n"])),)
    return sig


class SteadyStateDetector:
    """Arms after ``arm_after`` consecutive identical-signature frames.

    One detector per (runner, element). ``observe()`` is on the hot
    path — a tuple compare and an int bump, nothing else.
    """

    __slots__ = ("arm_after", "_sig", "_streak")

    def __init__(self, arm_after: int = 4):
        self.arm_after = max(1, int(arm_after))
        self._sig: Optional[Tuple] = None
        self._streak = 0

    def observe(self, sig: Optional[Tuple]) -> bool:
        """Feed one frame's signature; True when armed (this frame
        extends an identical streak of >= arm_after)."""
        if sig is None:
            self._sig, self._streak = None, 0
            return False
        if sig == self._sig:
            self._streak += 1
        else:
            self._sig, self._streak = sig, 1
        return self._streak >= self.arm_after

    @property
    def armed(self) -> bool:
        return self._streak >= self.arm_after

    @property
    def signature(self) -> Optional[Tuple]:
        return self._sig

    def reset(self) -> None:
        self._sig, self._streak = None, 0


class LoopStats:
    """Per-element compiled-loop ledger the scheduler owns.

    ``entries`` counts windows entered, ``steps`` frames that went
    through a window (``steps / buffers`` is the compiled share report()
    prints), ``bails`` armed windows that fell back, by cause.
    """

    __slots__ = ("entries", "steps", "bails")

    def __init__(self):
        self.entries = 0
        self.steps = 0
        self.bails: Dict[str, int] = {}

    def bail(self, cause: str) -> None:
        self.bails[cause] = self.bails.get(cause, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        return {"loop_entries": self.entries,
                "compiled_steps": self.steps,
                "loop_bails": dict(self.bails)}

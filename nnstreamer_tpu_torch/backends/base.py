"""Filter backend interface.

Reference parity: the `GstTensorFilterFramework` vtable
(include/nnstreamer_plugin_api_filter.h:273 — open/close/invoke/
getModelInfo). `invoke` takes and returns tuples of arrays (numpy or
torch.Tensor); a backend returns device tensors so downstream elements
stay on the device. `fuse(pre, post)` hands the backend the elementwise
chains next to it in the graph, so they run on the device with the model.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from nnstreamer_tpu_torch.core.config import get_config
from nnstreamer_tpu_torch.core.errors import BackendError, CircuitOpenError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.core.registry import PluginKind, registry
from nnstreamer_tpu_torch.runtime.tracing import NULL_TRACER
from nnstreamer_tpu_torch.tensor.buffer import coalesce
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

log = get_logger("backend")

ArrayTuple = Tuple[Any, ...]
ElementwiseFn = Callable[[ArrayTuple], ArrayTuple]


def pick_device(accelerator: str = "") -> torch.device:
    """The device a backend runs on (counterpart of the JAX package's
    `XLABackend._pick_device`).

    `accelerator` is the filter's property: "cuda", "cuda:<i>" or "cpu".
    Empty means the port-wide default, config key [filter] accelerator
    (env NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR), which is "cuda". The
    CPU runs only when asked for by name: with no CUDA device this raises
    instead of carrying on quietly on the CPU. With ``[parallel]
    virtual_devices`` set, the index of "cuda:<i>" (and "cpu:<i>") is a
    logical ordinal (serving/placement.py) and resolves to the device it
    maps onto.
    """
    accel = (accelerator or get_config().get("filter", "accelerator")
             or "cuda").strip().lower()
    kind, _, idx = accel.partition(":")
    if kind in ("cuda", "cpu") and idx.isdigit() \
            and get_config().get_int("parallel", "virtual_devices", 0) > 0:
        from nnstreamer_tpu_torch.serving.placement import device_of

        dev = device_of(int(idx))
        if dev.type != kind:
            raise BackendError(
                f"accelerator={accel!r}: logical device {idx} is on "
                f"{dev}, not {kind} ([filter] accelerator decides where "
                f"the logical devices live)")
        return dev
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise BackendError(
            f"accelerator={accelerator!r} is not a device of this port; "
            f"use cuda, cuda:<index> or cpu")
    if not torch.cuda.is_available():
        raise BackendError(
            f"accelerator={accel!r} but no CUDA device is visible "
            f"(torch.cuda.is_available() is False). To run on the CPU, ask "
            f"for it: accelerator=cpu on the tensor_filter, or "
            f"NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR=cpu")
    i = int(idx) if idx else 0
    if i >= torch.cuda.device_count():
        raise BackendError(
            f"accelerator={accel!r} but only {torch.cuda.device_count()} "
            f"CUDA device(s) are visible")
    return torch.device("cuda", i)


class FilterBackend:
    """One model-execution engine instance (per tensor_filter element)."""

    BACKEND_NAME: str = ""
    #: tracing hooks — the owning tensor_filter hands down the session
    #: tracer and its element name at start(), so the backend records
    #: invoke spans on the element's track when tracer.active
    tracer = NULL_TRACER
    trace_name: str = ""
    #: invoke exceptions seen by the owning tensor_filter (its stats'
    #: backend_invoke_failures; breaker short-circuits are not counted —
    #: the backend was never touched)
    invoke_failures: int = 0

    def version_stats(self) -> Dict[int, dict]:
        """Per-version serving counters of a store-bound backend
        ({version: {invokes, errors, p95_us}}); empty otherwise.
        tensor_filter's extra_stats surfaces them for canary
        comparisons."""
        return {}

    def warm_start(self) -> int:
        """Off-hot-path warm-up, called by the owning element's start():
        a store-bound backend replays its persistent bucket manifest here
        (serving/compile_cache.py). → buckets run; the default runs
        none."""
        return 0

    def open(self, props: Dict[str, Any]) -> None:
        """Load the model described by element properties (fw->open)."""
        raise NotImplementedError

    def close(self) -> None:
        pass

    def get_model_info(self) -> Tuple[Optional[TensorsSpec], Optional[TensorsSpec]]:
        """→ (input spec, output spec); either may be None if the model
        adapts to the negotiated input (fw->getModelInfo)."""
        raise NotImplementedError

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        """Fix the input spec for adaptive models → resulting output spec."""
        raise BackendError(
            f"backend {self.BACKEND_NAME!r} does not support dynamic input "
            f"reconfiguration; set the model's input dimensions explicitly")

    def fuse(self, pre: Optional[ElementwiseFn],
             post: Optional[ElementwiseFn]) -> bool:
        """Offer pre/post elementwise chains to run with the model. True
        if absorbed (the element then skips host-side application)."""
        return False

    def invoke(self, tensors: ArrayTuple) -> ArrayTuple:
        """Run the model on one frame's tensors (the hot loop): `run`,
        recorded as one backend "invoke" span on the owning element's
        track when the tracer is active. The span is host time — staging
        and the launches; PyTorch runs eagerly, so there is no compile
        step to mark, where the JAX package's XLA backend marks a
        bucket's first jit."""
        tr = self.tracer
        if not tr.active:
            return self.run(tensors)
        t0 = time.perf_counter()
        out = self.run(tensors)
        tr.backend_span(self.trace_name or self.BACKEND_NAME, "invoke", t0,
                        time.perf_counter())
        return out

    def run(self, tensors: ArrayTuple) -> ArrayTuple:
        """The backend's invoke proper (see `invoke`)."""
        raise NotImplementedError

    def invoke_flexible(self, regions: Sequence[Any]) -> Sequence[Any]:
        """Run the model over a FLEXIBLE buffer's variable-shape regions
        (tensor_crop output), one output per region. Default: one invoke
        per region; the torch backend batches same-shape regions."""
        return [self.invoke((r,))[0] for r in regions]

    def invoke_batched(self, tensors: ArrayTuple, n: int,
                       keepdims: Sequence[bool] = ()) -> ArrayTuple:
        """Run the model over a micro-batch (tensor_batch upstream): each
        input carries `n` frames on axis 0 — concatenated where the
        per-frame leading dim is 1 (keepdims[j] True), stacked on a new
        axis otherwise. Outputs come back batched by the same rule.

        Default: one invoke per frame on a `t[i:i+1]` / `t[i]` view, the
        outputs restacked — right for any backend. The torch backend
        overrides it with one padded call per power-of-two bucket."""
        frames_out = []
        for i in range(n):
            frame = tuple(
                t[i:i + 1] if (j < len(keepdims) and keepdims[j]) else t[i]
                for j, t in enumerate(tensors))
            frames_out.append(self.invoke(frame))
        return restack_frames(frames_out)

    def reload(self, model: Any) -> None:
        raise BackendError(
            f"backend {self.BACKEND_NAME!r} does not support model reload")


def restack_frames(frames_out: Sequence[ArrayTuple]) -> ArrayTuple:
    """Per-frame invoke outputs → batched wire format: per output k,
    concatenated on axis 0 where the per-frame result's leading dim is 1,
    else stacked on a new axis (tensor_batch's rule on the input side, so
    tensor_unbatch splits by rank alone). Device tensors stay on their
    device."""
    out = []
    for k in range(len(frames_out[0])):
        rows = [f[k] for f in frames_out]
        out.append(coalesce(rows, len(rows[0].shape) >= 1
                            and rows[0].shape[0] == 1))
    return tuple(out)


class CircuitBreaker:
    """Consecutive-failure circuit breaker around backend invokes:

    - **closed** (normal): invokes pass through; `threshold` consecutive
      failures open the circuit.
    - **open**: `guard()` raises CircuitOpenError without touching the
      backend, so the owning tensor_filter's error policy serves the
      degrade/skip path at queue speed instead of stacking failures on a
      dead backend. After `cooldown_s` the next guard() half-opens.
    - **half-open**: exactly one probe invoke passes through — success
      closes the circuit, failure re-opens it with a fresh cooldown.

    Driven by the single worker thread of the owning element, so state
    transitions need no lock. `clock` is injectable for deterministic
    tests.
    """

    def __init__(self, threshold: int, cooldown_s: float,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, got "
                             f"{threshold}")
        self.threshold = threshold
        self.cooldown_s = max(0.0, cooldown_s)
        self._clock = clock
        self.state = "closed"            # closed | open | half_open
        self._failures = 0               # consecutive, current streak
        self._opened_at = 0.0
        # observability counters (tensor_filter extra_stats)
        self.opened_count = 0
        self.short_circuited = 0
        self.probes = 0
        self.recoveries = 0

    def guard(self, owner: str = "backend") -> None:
        """Call before an invoke. Raises CircuitOpenError while the
        circuit is open and cooling down; moves open → half_open once
        the cooldown has elapsed (the caller's next invoke is the
        probe)."""
        if self.state == "closed":
            return
        if self.state == "open":
            waited = self._clock() - self._opened_at
            if waited < self.cooldown_s:
                self.short_circuited += 1
                raise CircuitOpenError(
                    f"{owner}: circuit open after {self._failures} "
                    f"consecutive backend failures; cooling down "
                    f"({self.cooldown_s - waited:.2f}s of "
                    f"{self.cooldown_s:.2f}s left) — serving the "
                    f"fallback/skip path")
            self.state = "half_open"
            self.probes += 1
            log.info("%s: circuit half-open — probing backend", owner)
        # half_open: let exactly this invoke through as the probe

    def record_success(self) -> None:
        if self.state != "closed":
            self.recoveries += 1
            log.info("circuit closed — probe invoke succeeded")
        self.state = "closed"
        self._failures = 0

    def record_failure(self) -> None:
        self._failures += 1
        if self.state == "half_open" or (
                self.state == "closed" and self._failures >= self.threshold):
            self.state = "open"
            self._opened_at = self._clock()
            self.opened_count += 1
            log.warning("circuit opened after %d consecutive backend "
                        "failure(s); cooling down %.2fs",
                        self._failures, self.cooldown_s)

    def stats(self) -> Dict[str, Any]:
        return {"state": self.state,
                "consecutive_failures": self._failures,
                "opened": self.opened_count,
                "short_circuited": self.short_circuited,
                "probes": self.probes,
                "recoveries": self.recoveries}


def register_backend(*names: str):
    """Class decorator registering a FilterBackend under each name."""
    def deco(cls):
        cls.BACKEND_NAME = names[0]
        for name in names:
            registry.register(PluginKind.FILTER, name, cls)
        return cls
    return deco


def get_backend(name: str) -> FilterBackend:
    return registry.get(PluginKind.FILTER, name)()

"""tensor_filter — the model-execution element, per-frame path.

Reference parity: gst/nnstreamer/tensor_filter/tensor_filter.c +
tensor_filter_common.c: backend open at negotiation, model-info-driven
negotiation (set-input-info for adaptive models), invoke error
propagation. Input/output overrides, combinations, batching and the
other JAX-package properties wait for later slices.

- `framework=` picks the backend (torch, alias xla; pallas for the
  hand-written kernels); empty means [filter] default_backend (torch).
- **Fusion**: `set_fusion()` receives the programs of adjacent
  tensor_transform elements removed by graph/optimize.py; an accepting
  backend runs them on the device. A refusing backend gets them applied
  here, so results never depend on fusion.
- `shared_tensor_filter_key`: filters with the same key hold one
  backend model on one device (torch backend; open takes a holder, close
  drops it, the last close frees it). Each filter keeps its own fused
  chains.
- Invoke does not wait for the device: outputs flow downstream as tensors
  whose work may still be queued.
- **Circuit breaker** (`breaker_threshold`, `breaker_cooldown_ms`):
  after that many consecutive invoke failures the circuit opens and
  invokes short-circuit with CircuitOpenError for the cooldown, then one
  half-open probe decides recovery (backends/base.CircuitBreaker). Pair
  it with error-policy=skip or degrade.
- At start() the runner's tracer is handed to the backend, whose invoke
  spans then land on this element's track.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from nnstreamer_tpu_torch.backends import pallas_backend, torch_backend  # noqa: F401 (register)
from nnstreamer_tpu_torch.backends.base import (
    CircuitBreaker, FilterBackend, get_backend)
from nnstreamer_tpu_torch.core.config import get_config
from nnstreamer_tpu_torch.core.errors import (
    BackendError, CircuitOpenError, PipelineError)
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.elements.decoder import aux_on
from nnstreamer_tpu_torch.graph.optimize import chain_fn, transfer_spec
from nnstreamer_tpu_torch.graph.pipeline import Element, Emission, PropDef, StreamSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer


@register_element("tensor_filter")
class TensorFilter(Element):
    ELEMENT_NAME = "tensor_filter"
    DEVICE_RESIDENT = True
    #: its own worker thread is what overlaps its launches with upstream
    #: conversion, so it never joins a fused chain
    CHAIN_FUSABLE = False
    PROPS = {
        "framework": PropDef(str, "", "backend name (torch|xla|pallas)"),
        "model": PropDef(lambda s: s, None, "model reference (backend-specific)"),
        "accelerator": PropDef(str, "", "device: cuda, cuda:<i> or cpu "
                                        "(empty: [filter] accelerator)"),
        "shared_tensor_filter_key": PropDef(
            str, "", "share one device model across filters with this key"),
        "breaker_threshold": PropDef(
            int, 0, "consecutive invoke failures to open the circuit (0=off)"),
        "breaker_cooldown_ms": PropDef(
            float, 1000.0, "open-circuit cooldown before the probe invoke"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.backend: Optional[FilterBackend] = None
        self._pre: Optional[Callable] = None   # fused pre chain
        self._post: Optional[Callable] = None
        self._pre_programs: list = []
        self._post_programs: list = []
        self._fused_in_backend = False
        self._fused_decoder = None             # device-decode subplugin
        self._decoder_aux = None               # its constants, on device
        self._breaker: Optional[CircuitBreaker] = None

    # -- fusion (called by graph/optimize.py) ------------------------------
    def set_fusion(self, pre_programs, post_programs) -> None:
        """Absorb removed transform elements' compiled programs."""
        self._pre_programs = pre_programs or []
        self._post_programs = post_programs or []
        self._pre = chain_fn(self._pre_programs)
        self._post = chain_fn(self._post_programs)

    def set_decoder_fusion(self, sub) -> None:
        """Absorb a downstream `tensor_decoder device=true` subplugin: its
        device_decode runs right after the model (+ post transforms), so
        only the compact result leaves the device."""
        self._fused_decoder = sub
        base_post = self._post

        def post(tensors):
            if base_post is not None:
                tensors = base_post(tensors)
            return tuple(sub.device_decode(tuple(tensors), self._decoder_aux))

        self._post = post

    # -- negotiation / backend open ---------------------------------------
    def _framework_name(self) -> str:
        return (self.props["framework"]
                or get_config().get("filter", "default_backend") or "torch")

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        fw = self._framework_name()
        try:
            self.backend = get_backend(fw)
        except PipelineError as e:
            self.fail_negotiation(str(e))
        try:
            self.backend.open(dict(self.props))
        except BackendError as e:
            self.fail_negotiation(f"backend {fw!r} failed to open model: {e}")
        if self._pre is not None or self._post is not None:
            self._fused_in_backend = self.backend.fuse(self._pre, self._post)

        model_in, model_out = self.backend.get_model_info()
        # what the model itself sees after any fused pre-chain
        model_sees = transfer_spec(self._pre_programs, spec)
        if model_in is not None and not model_in.is_compatible(model_sees):
            self.fail_negotiation(
                f"model expects input {model_in} but receives {model_sees}"
                + (f" (= {spec} after fused pre-transforms)"
                   if self._pre_programs else "")
                + ". Fix the upstream pipeline (converter/transform dims)")
        if model_out is None:
            try:
                model_out = self.backend.set_input_info(model_sees)
            except BackendError as e:
                self.fail_negotiation(str(e))
        model_out = transfer_spec(self._post_programs, model_out)
        if self._fused_decoder is not None:
            try:
                model_out = self._fused_decoder.device_negotiate(model_out)
            except (ValueError, PipelineError) as e:
                self.fail_negotiation(
                    f"fused device decoder rejected model output "
                    f"{model_out}: {e}")
            self._decoder_aux = aux_on(self._fused_decoder.device_aux(),
                                       self.backend.device)
        return [model_out.with_rate(spec.rate)]

    def start(self) -> None:
        # a test may pre-install a breaker with an injected clock; build
        # one here only if the props ask for it and none exists yet
        if self._breaker is None and self.props["breaker_threshold"] > 0:
            self._breaker = CircuitBreaker(
                self.props["breaker_threshold"],
                self.props["breaker_cooldown_ms"] / 1e3)
        if self.backend is not None:
            self.backend.tracer = self._tracer
            self.backend.trace_name = self.name

    def stop(self) -> None:
        if self.backend is not None:
            self.backend.close()

    def extra_stats(self) -> dict:
        """Backend and breaker counters merged into this element's
        stats() row."""
        out = {}
        for k in ("invoke_failures", "staging_transfers", "staging_elided"):
            v = getattr(self.backend, k, None)
            if v is not None:
                out["backend_" + k] = v
        if self._breaker is not None:
            for k, v in self._breaker.stats().items():
                out["breaker_" + k] = v
        return out

    def _invoke_guarded(self, inputs):
        """One backend invoke through the circuit breaker (when
        configured). A short-circuit raises CircuitOpenError without
        touching the backend and without counting as a new failure; the
        element's error policy decides what it means."""
        br = self._breaker
        if br is None:
            return self.backend.invoke(inputs)
        br.guard(self.name)
        try:
            out = self.backend.invoke(inputs)
        except Exception:
            br.record_failure()
            raise
        br.record_success()
        return out

    # -- hot loop ----------------------------------------------------------
    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        inputs = buf.tensors
        if self._pre is not None and not self._fused_in_backend:
            inputs = self._pre(inputs)
        try:
            outputs = self._invoke_guarded(inputs)
        except CircuitOpenError:
            raise   # keep the type — error policies never retry these
        except Exception as e:
            self.backend.invoke_failures += 1
            raise BackendError(
                f"tensor_filter {self.name}: invoke failed on frame "
                f"pts={buf.pts}: {e}") from e
        if self._post is not None and not self._fused_in_backend:
            outputs = self._post(outputs)
        return [(0, buf.with_tensors(outputs))]

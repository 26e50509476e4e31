"""Kernel filter backend — hand-written kernels as tensor_filter models,
registered under the JAX package's framework name ``pallas`` so
``framework=pallas model=normalize_u8`` runs verbatim.

Registration:

    @register_pallas_filter("my_norm", out_like=lambda spec: spec)
    def my_norm(tensors):
        return (kernels.normalize_u8(tensors[0]),)

`out_like` maps the input TensorsSpec to the output spec; omit it to have
the backend run the function once on zeros to learn the output spec.
Host numpy inputs are staged to the device in their own dtype (a uint8
frame crosses as 1 byte per element) and the kernel runs there.

With the session tracer active each invoke is one backend "invoke" span
(`FilterBackend.invoke`); there is no "compile" span: the kernel
library is built at its first launch (backends/cuda_build.py), inside
that first invoke span.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from nnstreamer_tpu_torch.backends.base import (
    ArrayTuple, ElementwiseFn, FilterBackend, pick_device, register_backend)
from nnstreamer_tpu_torch.backends.torch_backend import stage, to_tuple
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec


@dataclass
class _KernelEntry:
    fn: Callable[[ArrayTuple], ArrayTuple]
    out_like: Optional[Callable[[TensorsSpec], TensorsSpec]] = None


_kernels: Dict[str, _KernelEntry] = {}
# RLock: _builtins() holds it across check-then-register, and
# register_pallas_filter re-acquires it on the same thread
_lock = threading.RLock()


def register_pallas_filter(name: str, out_like=None):
    """Decorator registering kernel `fn(tensors)->tensors` as a filter."""
    def deco(fn):
        with _lock:
            _kernels[name] = _KernelEntry(fn=fn, out_like=out_like)
        return fn
    return deco


def _builtins() -> None:
    """Register the stock kernels lazily."""
    from nnstreamer_tpu_torch.backends import kernels

    with _lock:
        if "normalize_u8" in _kernels:
            return

        def norm_spec(spec: TensorsSpec) -> TensorsSpec:
            return TensorsSpec(tensors=tuple(
                TensorInfo(t.shape, DType.FLOAT32) for t in spec.tensors),
                rate=spec.rate)

        register_pallas_filter("normalize_u8", out_like=norm_spec)(
            lambda ts: tuple(kernels.normalize_u8(t) for t in ts))


@register_backend("pallas")
class KernelBackend(FilterBackend):
    def __init__(self):
        self._entry: Optional[_KernelEntry] = None
        self._name = ""
        self._pre: Optional[ElementwiseFn] = None
        self._post: Optional[ElementwiseFn] = None
        self.device: Optional[torch.device] = None

    def open(self, props: Dict[str, Any]) -> None:
        _builtins()
        self.device = pick_device(props.get("accelerator") or "")
        model = props.get("model")
        if callable(model):
            self._entry = _KernelEntry(fn=model)
            self._name = getattr(model, "__name__", "callable")
            return
        with _lock:
            entry = _kernels.get(model)
        if entry is None:
            raise BackendError(
                f"no pallas filter named {model!r} registered; available: "
                f"{sorted(_kernels)} (register with @register_pallas_filter)")
        self._entry = entry
        self._name = str(model)

    def get_model_info(self):
        return None, None  # adapts to the negotiated input

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        if self._entry.out_like is not None:
            return self._entry.out_like(in_spec)
        zeros = tuple(torch.zeros(t.shape, dtype=t.dtype.torch_dtype,
                                  device=self.device) for t in in_spec.tensors)
        try:
            out = to_tuple(self._entry.fn(zeros))
        except Exception as e:
            raise BackendError(
                f"pallas filter {self._name!r} rejected input {in_spec}: {e}"
            ) from e
        return TensorsSpec(tensors=tuple(
            TensorInfo(tuple(o.shape), DType.of(o)) for o in out),
            rate=in_spec.rate)

    def fuse(self, pre, post) -> bool:
        self._pre, self._post = pre, post
        return True

    def run(self, tensors: ArrayTuple) -> ArrayTuple:
        ts, _ = stage(tensors, self.device)
        with torch.inference_mode():
            if self._pre is not None:
                ts = self._pre(ts)
            out = to_tuple(self._entry.fn(tuple(ts)))
            if self._post is not None:
                out = to_tuple(self._post(out))
        return out

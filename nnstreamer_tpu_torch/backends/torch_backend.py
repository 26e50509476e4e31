"""Torch backend — the model-execution engine (counterpart of the JAX
package's backends/xla.py), registered as ``torch`` and as ``xla`` so
reference pipeline strings run verbatim.

A model is a callable ``fn(params, *inputs) -> outputs`` plus its params
(an ``nn.Module``, a dict of tensors, or None). Sources of models:

- the in-repo model zoo (``model=zoo://mobilenet_v2``) — models/zoo.py
- a `ModelBundle` or a callable passed programmatically to the element

Filters with the same `shared_tensor_filter_key` hold one model on one
device (the reference's shared-tensor-filter-key,
tensor_filter_common.c:2911-3046): the first open builds it and moves
its params there, later opens take a holder, the last close frees it.
Every holder must ask for the same model and device.

The backend runs eagerly on its device (`pick_device`). Fused pre/post
chains run on the device around the model, after staging, so a uint8
frame crosses to the device as uint8. `invoke` returns without waiting
for the device; the sink or host decoder that reads the result is the
sync point.

With the session tracer active each invoke is one backend "invoke" span
(`FilterBackend.invoke`); there is no "compile" span: nothing compiles.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from nnstreamer_tpu_torch.backends.base import (
    ArrayTuple, ElementwiseFn, FilterBackend, pick_device, register_backend)
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.tensor.dtypes import DType, host_tensor
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

log = get_logger("backend.torch")


@dataclass
class ModelBundle:
    """A loadable model: function + params + optional fixed specs."""

    fn: Callable[..., Any]            # fn(params, *inputs) -> output(s)
    params: Any = None                # nn.Module | dict of tensors | None
    in_spec: Optional[TensorsSpec] = None
    out_spec: Optional[TensorsSpec] = None
    name: str = ""


@dataclass
class _SharedEntry:
    """One model held on one device by every filter sharing its key."""

    bundle: ModelBundle
    params: Any
    device: torch.device
    model_ref: Optional[str]
    holders: int = 0


_shared_models: Dict[str, _SharedEntry] = {}
_shared_lock = threading.Lock()


def to_tuple(x) -> Tuple:
    if isinstance(x, tuple):
        return x
    if isinstance(x, list):
        return tuple(x)
    return (x,)


def params_to(params, device: torch.device):
    """Move a model's params to `device`: an nn.Module in place (and into
    eval mode), a (nested) dict of tensors by copy."""
    if isinstance(params, torch.nn.Module):
        return params.to(device).eval()
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params


def stage(arrs, device: torch.device) -> Tuple[ArrayTuple, int]:
    """Move inputs to `device`, skipping tensors already there. Host
    numpy crosses in its own dtype (a uint8 frame stays 1 byte/element).
    → (staged tensors, number of transfers made)."""
    staged = []
    transfers = 0
    for a in arrs:
        if isinstance(a, torch.Tensor) and a.device == device:
            staged.append(a)
            continue
        t = a if isinstance(a, torch.Tensor) else host_tensor(a)
        staged.append(t.to(device, non_blocking=True))
        transfers += 1
    return tuple(staged), transfers


@register_backend("torch", "xla")
class TorchBackend(FilterBackend):
    def __init__(self):
        self._bundle: Optional[ModelBundle] = None
        self._params = None
        self._shared: Optional[_SharedEntry] = None
        self._shared_key = ""
        self._pre: Optional[ElementwiseFn] = None
        self._post: Optional[ElementwiseFn] = None
        self.device: Optional[torch.device] = None
        # inputs that were already on the device skip the copy
        self.staging_transfers = 0
        self.staging_elided = 0

    def open(self, props: Dict[str, Any]) -> None:
        model = props.get("model")
        if model is None:
            raise BackendError(
                "framework=torch requires model=<zoo://name | ModelBundle | "
                "callable>")
        self.device = pick_device(props.get("accelerator") or "")
        key = props.get("shared_tensor_filter_key") or ""
        if key:
            self._open_shared(key, model)
            return
        self._bundle = self._resolve(model)
        self._params = params_to(self._bundle.params, self.device)
        log.info("opened model %s on %s", self._bundle.name or model,
                 self.device)

    def _open_shared(self, key: str, model) -> None:
        ref = model if isinstance(model, str) else None
        with _shared_lock:
            entry = _shared_models.get(key)
            if entry is None:
                bundle = self._resolve(model)
                entry = _SharedEntry(bundle, params_to(bundle.params,
                                                       self.device),
                                     self.device, ref)
                _shared_models[key] = entry
            elif entry.device != self.device:
                raise BackendError(
                    f"shared-tensor-filter-key {key!r} is held on "
                    f"{entry.device} but this filter asked for "
                    f"{self.device}; use a different key per device")
            elif ref is not None and entry.model_ref is not None \
                    and ref != entry.model_ref:
                raise BackendError(
                    f"shared-tensor-filter-key {key!r} already holds model "
                    f"{entry.model_ref!r}; this filter asked for {ref!r} "
                    f"(same key, same model)")
            entry.holders += 1
            self._shared, self._shared_key = entry, key
            self._bundle, self._params = entry.bundle, entry.params
        log.info("opened shared model key=%s holders=%d on %s", key,
                 entry.holders, self.device)

    def _resolve(self, model) -> ModelBundle:
        if isinstance(model, ModelBundle):
            return model
        if isinstance(model, str) and model.startswith("zoo://"):
            from nnstreamer_tpu_torch.models.zoo import build_model

            return build_model(model[len("zoo://"):])
        if callable(model):
            return ModelBundle(fn=lambda params, *xs: model(*xs),
                               in_spec=getattr(model, "in_spec", None),
                               out_spec=getattr(model, "out_spec", None),
                               name=getattr(model, "__name__", "callable"))
        raise BackendError(
            f"unrecognized model reference {model!r} for framework=torch; "
            f"expected zoo://<name>, a ModelBundle, or a callable")

    def close(self) -> None:
        """Drop this filter's hold on its model (idempotent)."""
        if self._shared is not None:
            with _shared_lock:
                self._shared.holders -= 1
                if self._shared.holders <= 0:
                    _shared_models.pop(self._shared_key, None)
            self._shared = None
        self._params = None

    def get_model_info(self):
        return self._bundle.in_spec, self._bundle.out_spec

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        """Infer the model's output spec by running the bare model once on
        zeros of `in_spec` on the target device (fused chains do not take
        part: `in_spec` is already what the model sees)."""
        zeros = [torch.zeros(t.shape, dtype=t.dtype.torch_dtype,
                             device=self.device) for t in in_spec.tensors]
        try:
            with torch.inference_mode():
                out = to_tuple(self._bundle.fn(self._params, *zeros))
        except Exception as e:
            raise BackendError(
                f"model {self._bundle.name!r} does not accept input "
                f"{in_spec}: {e}") from e
        return TensorsSpec(tensors=tuple(
            TensorInfo(tuple(o.shape), DType.of(o)) for o in out))

    def fuse(self, pre: Optional[ElementwiseFn],
             post: Optional[ElementwiseFn]) -> bool:
        self._pre, self._post = pre, post
        return True

    def run(self, tensors: ArrayTuple) -> ArrayTuple:
        xs, transfers = stage(tensors, self.device)
        self.staging_transfers += transfers
        self.staging_elided += len(xs) - transfers
        with torch.inference_mode():
            if self._pre is not None:
                xs = self._pre(xs)
            out = to_tuple(self._bundle.fn(self._params, *xs))
            if self._post is not None:
                out = to_tuple(self._post(out))
        return out

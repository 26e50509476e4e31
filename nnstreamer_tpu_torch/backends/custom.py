"""Custom python-callable backend (the custom-easy analog), the JAX
package's backends/custom.py on the port.

Reference parity: include/tensor_filter_custom_easy.h
(`NNS_custom_easy_register` — register an in-process function + fixed
in/out info under a name, then `framework=custom-easy model=<name>`), and
tensor_filter_custom.c for loading user code by path.

Two ways to name a model:
- a registered name (``register_custom_easy("scaler", fn, in_spec,
  out_spec)`` → ``framework=custom model=scaler``);
- a python path ``pkg.module:callable`` imported on open; the callable
  may carry ``in_spec``/``out_spec``/``infer_out`` attributes.

The callable gets the frame's tensors where they are: CUDA tensors stay
on the card (after a filter there), host arrays stay numpy (from a
converter). Nothing is staged and nothing is synced here, so a callable
written in torch ops runs on the card in the filter's thread. What it
returns goes downstream as it is: numpy outputs stay host arrays (no
copy), and the next filter on the card stages them as it stages any host
frame. The JAX package hands its callable jax arrays, which numpy reads
implicitly; a CUDA tensor does not turn into numpy by itself, so a
callable that wants host arrays calls ``.cpu()`` (ROADMAP N16).

A callable that declares no output spec is probed once, at negotiation,
with zero tensors on the filter's device (its ``accelerator``, as
`pick_device` reads it), where the JAX package probes with numpy zeros:
a callable written in torch ops then negotiates, and the spec follows
torch's type promotion (uint8 × 0.5 is float32; numpy makes float64).
Every frame's outputs are then held to that spec, so a callable whose
host-array frames promote otherwise fails loud instead of emitting what
it did not negotiate. A callable that must see host arrays declares
``out_spec`` or ``infer_out``.
"""

from __future__ import annotations

import importlib
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from nnstreamer_tpu_torch.backends.base import (
    ArrayTuple, FilterBackend, pick_device, register_backend)
from nnstreamer_tpu_torch.backends.torch_backend import to_tuple
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec


@dataclass
class _CustomEntry:
    fn: Callable[[ArrayTuple], ArrayTuple]
    in_spec: Optional[TensorsSpec]
    out_spec: Optional[TensorsSpec]
    #: optional: out spec as a function of in spec (adaptive models)
    infer_out: Optional[Callable[[TensorsSpec], TensorsSpec]] = None


_table: Dict[str, _CustomEntry] = {}
_table_lock = threading.Lock()


def register_custom_easy(
    name: str,
    fn: Callable[[ArrayTuple], ArrayTuple],
    in_spec: Optional[TensorsSpec] = None,
    out_spec: Optional[TensorsSpec] = None,
    infer_out: Optional[Callable[[TensorsSpec], TensorsSpec]] = None,
) -> Callable:
    """Register `fn` as an invokable model under `name`.

    `fn` maps a tuple of arrays to a tuple of arrays (or one array).
    Specs may be omitted for passthrough-shaped models, or `infer_out`
    given for adaptive ones."""
    with _table_lock:
        _table[name] = _CustomEntry(fn, in_spec, out_spec, infer_out)
    return fn


def unregister_custom_easy(name: str) -> bool:
    with _table_lock:
        return _table.pop(name, None) is not None


@register_backend("custom")
class CustomBackend(FilterBackend):
    #: no device of its own: the callable runs where its tensors are
    device = None

    def __init__(self):
        self._entry: Optional[_CustomEntry] = None
        self._model_name = ""
        self._accelerator = ""
        #: the probed output spec every frame is held to (None when the
        #: callable declares its own)
        self._probed: Optional[TensorsSpec] = None

    def open(self, props: Dict[str, Any]) -> None:
        self._accelerator = props.get("accelerator", self._accelerator)
        model = props.get("model")
        if not model:
            raise BackendError(
                "framework=custom requires model=<registered name or "
                "python path 'pkg.module:callable'>")
        self._model_name = model
        with _table_lock:
            entry = _table.get(model)
        if entry is None and ":" in model:
            entry = self._load_python_path(model)
        if entry is None:
            with _table_lock:
                names = sorted(_table)
            raise BackendError(
                f"no custom model {model!r}; registered: {names or '(none)'}. "
                f"Use register_custom_easy() or a 'pkg.module:callable' path.")
        self._entry = entry

    def _load_python_path(self, path: str) -> _CustomEntry:
        mod_name, _, attr = path.partition(":")
        try:
            fn = getattr(importlib.import_module(mod_name), attr)
        except (ImportError, AttributeError) as e:
            raise BackendError(f"cannot load custom model {path!r}: {e}") from e
        return _CustomEntry(fn, getattr(fn, "in_spec", None),
                            getattr(fn, "out_spec", None),
                            getattr(fn, "infer_out", None))

    def get_model_info(self):
        assert self._entry is not None, "open() not called"
        return self._entry.in_spec, self._entry.out_spec

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        assert self._entry is not None
        self._probed = None
        if self._entry.infer_out is not None:
            return self._entry.infer_out(in_spec)
        if self._entry.out_spec is not None:
            return self._entry.out_spec
        # no declared output spec: probe the callable once with zero
        # tensors on the filter's device (custom fns must be
        # side-effect-free or declare out_spec / infer_out)
        dev = pick_device(self._accelerator)
        probe = tuple(torch.zeros(t.shape, dtype=t.dtype.torch_dtype,
                                  device=dev) for t in in_spec.tensors)
        try:
            out = self.run(probe)
        except Exception as e:
            raise BackendError(
                f"custom model {self._model_name!r} declares no output spec "
                f"and probing it with zero tensors {in_spec} on {dev} "
                f"failed: {e}. Register it with out_spec= or infer_out= "
                f"instead.") from e
        self._probed = TensorBuffer.of(*out).spec()
        return self._probed

    def run(self, tensors: ArrayTuple) -> ArrayTuple:
        assert self._entry is not None
        out = to_tuple(self._entry.fn(tuple(tensors)))
        if self._probed is not None:
            self._check_probed(out)
        return out

    def _check_probed(self, out: ArrayTuple) -> None:
        """Each output's shape and dtype = the probed spec's."""
        want = self._probed.tensors
        got = TensorBuffer.of(*out).spec().tensors
        if len(got) != len(want) or any(
                (g.shape, g.dtype) != (w.shape, w.dtype)
                for g, w in zip(got, want)):
            raise BackendError(
                f"custom model {self._model_name!r} emitted {list(got)} but "
                f"negotiated {list(want)} from its probe with zero tensors "
                f"(its frames' type promotes otherwise, e.g. host arrays "
                f"where the probe had tensors); register it with out_spec= "
                f"or infer_out=")

    def reload(self, model: Any) -> None:
        self.open({"model": model})

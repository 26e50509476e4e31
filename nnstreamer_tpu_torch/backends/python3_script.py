"""python3 scripted-filter backend, the JAX package's
backends/python3_script.py on the port.

Reference parity: `ext/nnstreamer/tensor_filter/tensor_filter_python3.cc`
(embeds CPython, loads a user script defining ``class CustomFilter``)
and its API shim module `nnstreamer_python` (TensorShape). The host
language here is Python, so "embedding" reduces to importing the script
file.

Script contract (reference `nnstreamer_python` module semantics):
- ``import nnstreamer_python as nns`` — provided by this module's shim
  (`TensorShape(dims, np_type)`; dims are reference-order, i.e.
  innermost-first, and `getDims()` returns the mutable list).
- ``class CustomFilter`` with either static shapes
  (``getInputDim``/``getOutputDim`` → [TensorShape]) or adaptive
  (``setInputDim(in_dims) -> [TensorShape]``), plus
  ``invoke([flat np arrays]) -> [np arrays]``.
- ``custom=...`` on the filter element is passed verbatim as the single
  constructor argument, as the reference does.

Scripts read flat host arrays: a frame of CUDA tensors comes to the host
in one counted forced sync (runtime/sync.to_host over the whole tuple),
not one per tensor. The outputs are host arrays; the next filter on the
card stages them as it stages any host frame.

The shim is this package's own `nnstreamer_python` module object: a
script loaded by the port binds it at import, so the JAX package
installing its shim later does not touch the port's scripts.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import threading
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from nnstreamer_tpu_torch.backends.base import (
    ArrayTuple, FilterBackend, register_backend)
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.runtime.sync import to_host
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec


class TensorShape:
    """Reference `nnstreamer_python.TensorShape`: innermost-first dims +
    numpy type; `getDims()` returns the mutable list (scripts edit it in
    place — the reference's scaler.py does)."""

    def __init__(self, dims, np_type=np.uint8):
        self._dims = [int(d) for d in dims]
        self._type = np.dtype(np_type)

    def getDims(self) -> List[int]:
        return self._dims

    def getType(self) -> np.dtype:
        return self._type

    def __repr__(self):
        return f"TensorShape({self._dims}, {self._type})"


_shim = types.ModuleType("nnstreamer_python")
_shim.TensorShape = TensorShape


def _install_shim() -> None:
    """Make `import nnstreamer_python` resolve to this package's shim,
    as the reference's embedded interpreter provides it."""
    sys.modules["nnstreamer_python"] = _shim


def _shape_to_spec(shapes: List[TensorShape]) -> TensorsSpec:
    infos = []
    for ts in shapes:
        if not isinstance(ts, TensorShape):
            raise BackendError(
                f"python3 script returned {type(ts).__name__}, expected "
                f"nnstreamer_python.TensorShape")
        # reference dims are innermost-first; shapes here are row-major
        infos.append(TensorInfo(tuple(reversed(ts.getDims())),
                                DType.from_np(np.dtype(ts.getType()))))
    return TensorsSpec(tensors=tuple(infos))


def _spec_to_shapes(spec: TensorsSpec) -> List[TensorShape]:
    return [TensorShape(list(reversed(t.shape)), t.dtype.np_dtype)
            for t in spec.tensors]


_load_lock = threading.Lock()
_script_seq = 0


def load_script_class(path: str, class_name: str):
    """Import a reference-contract script file and return its user class
    (CustomFilter / CustomConverter / CustomDecoder). Shared by the
    python3 filter backend and the scripted converter/decoder
    (elements/script_codec.py)."""
    global _script_seq

    if not isinstance(path, str) or not path.endswith(".py"):
        raise BackendError(
            f"python3 script must be a path ending .py, got {path!r}")
    if not os.path.isfile(path):
        raise BackendError(f"python3 script {path!r} does not exist")
    with _load_lock:
        _install_shim()
        _script_seq += 1
        spec = importlib.util.spec_from_file_location(
            f"_nns_torch_py3_script_{_script_seq}", path)
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        except Exception as e:
            raise BackendError(
                f"python3 script {path!r} failed to import: "
                f"{type(e).__name__}: {e}") from e
    cls = getattr(mod, class_name, None)
    if cls is None:
        raise BackendError(
            f"python3 script {path!r} defines no {class_name} class "
            f"(the reference contract: 'DO NOT CHANGE CLASS NAME')")
    return cls


@register_backend("python3")
class Python3ScriptBackend(FilterBackend):
    """Loads `model=<path>.py`, instantiates CustomFilter(custom_args)."""

    #: no device of its own: scripts run on the host
    device = None

    def __init__(self):
        self._filter = None
        self._out_spec: Optional[TensorsSpec] = None
        self._in_spec: Optional[TensorsSpec] = None
        self._path = ""
        self._custom = ""

    def open(self, props: Dict[str, Any]) -> None:
        path = props.get("model")
        if not isinstance(path, str) or not path.endswith(".py"):
            raise BackendError(
                "framework=python3 requires model=<script path ending "
                ".py> (reference tensor_filter_python3 contract)")
        cls = load_script_class(path, "CustomFilter")
        custom = props.get("custom") or ""
        args = (custom,) if custom else ()
        try:
            self._filter = cls(*args)
        except Exception as e:
            raise BackendError(
                f"python3 script {path!r}: CustomFilter{args} raised "
                f"{type(e).__name__}: {e}") from e
        self._path = path
        self._custom = custom
        self._in_spec = None
        self._out_spec = None

    def get_model_info(self) -> Tuple[Optional[TensorsSpec],
                                      Optional[TensorsSpec]]:
        f = self._filter
        assert f is not None, "open() not called"
        if hasattr(f, "getInputDim") and hasattr(f, "getOutputDim"):
            return (_shape_to_spec(f.getInputDim()),
                    _shape_to_spec(f.getOutputDim()))
        return None, None           # adaptive: setInputDim drives it

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        f = self._filter
        assert f is not None
        if not hasattr(f, "setInputDim"):
            _, outs = self.get_model_info()
            if outs is None:
                raise BackendError(
                    f"python3 script {self._path!r} has neither "
                    f"getInputDim/getOutputDim nor setInputDim")
            self._out_spec = outs
            return outs
        out = f.setInputDim(_spec_to_shapes(in_spec))
        if out is None:
            raise BackendError(
                f"python3 script {self._path!r}: setInputDim rejected "
                f"input {in_spec}")
        self._in_spec = in_spec
        self._out_spec = _shape_to_spec(out)
        return self._out_spec

    def run(self, tensors: ArrayTuple) -> ArrayTuple:
        f = self._filter
        assert f is not None
        # the whole frame to the host in ONE counted sync (free when the
        # frame is on the host already); the reference hands scripts
        # flat arrays of the negotiated dtype
        host = to_host(tuple(tensors), self.tracer,
                       self.trace_name or "python3")
        out = f.invoke([np.ravel(t) for t in host])
        if out is None:
            raise BackendError(
                f"python3 script {self._path!r}: invoke returned None")
        if self._out_spec is None:
            self._out_spec = self.get_model_info()[1]
        specs = self._out_spec.tensors if self._out_spec is not None else ()
        shaped = []
        for i, arr in enumerate(out):
            arr = np.asarray(arr)  # nnlint: disable=NNL002 script ABI returns host lists/ndarrays, never device tensors
            if i < len(specs):
                arr = arr.reshape(specs[i].shape).astype(
                    specs[i].dtype.np_dtype, copy=False)
            shaped.append(arr)
        return tuple(shaped)

    def reload(self, model: Any) -> None:
        # carry the custom= constructor args across the swap, and re-drive
        # the adaptive negotiation the old instance had
        in_spec = self._in_spec
        self.open({"model": model, "custom": self._custom})
        if in_spec is not None:
            self.set_input_info(in_spec)

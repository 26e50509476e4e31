"""Filter backend interface.

Reference parity: the `GstTensorFilterFramework` vtable
(include/nnstreamer_plugin_api_filter.h:273 — open/close/invoke/
getModelInfo). `invoke` takes and returns tuples of arrays (numpy or
torch.Tensor); a backend returns device tensors so downstream elements
stay on the device. `fuse(pre, post)` hands the backend the elementwise
chains next to it in the graph, so they run on the device with the model.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from nnstreamer_tpu_torch.core.config import get_config
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.core.registry import PluginKind, registry
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

ArrayTuple = Tuple[Any, ...]
ElementwiseFn = Callable[[ArrayTuple], ArrayTuple]


def pick_device(accelerator: str = "") -> torch.device:
    """The device a backend runs on (counterpart of the JAX package's
    `XLABackend._pick_device`).

    `accelerator` is the filter's property: "cuda", "cuda:<i>" or "cpu".
    Empty means the port-wide default, config key [filter] accelerator
    (env NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR), which is "cuda". The
    CPU runs only when asked for by name: with no CUDA device this raises
    instead of carrying on quietly on the CPU.
    """
    accel = (accelerator or get_config().get("filter", "accelerator")
             or "cuda").strip().lower()
    kind, _, idx = accel.partition(":")
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
        """Run the model on one frame's tensors (the hot loop)."""
        raise NotImplementedError


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

"""SingleShot — pipeline-less model invocation.

Reference parity: `GTensorFilterSingle` (gst/nnstreamer/tensor_filter/
tensor_filter_single.c, class hdr :67-82) — the object the ML C-API uses
to run one model without a pipeline: same backend open/info/invoke
protocol, no pads. This is the "model runner" surface for applications
that just want `invoke()`.

    runner = SingleShot(model="zoo://mobilenet_v2", framework="torch")
    out, = runner.invoke(frame)          # frame: numpy array or tensor
    runner.set_fusion(pre=..., post=...) # optional fused chains
    runner.close()

`framework` names a backend of the port's registry: ``torch`` (also
registered as ``xla``, so the JAX package's default runs verbatim),
``pallas``, ``custom`` or ``python3``. The backend runs on the card unless ``accelerator=cpu`` (or
NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR=cpu) asks for the CPU, and
`invoke` returns its tensors without waiting for the device.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

# importing the backends registers them
import nnstreamer_tpu_torch.backends.custom  # noqa: F401
import nnstreamer_tpu_torch.backends.pallas_backend  # noqa: F401
import nnstreamer_tpu_torch.backends.python3_script  # noqa: F401
import nnstreamer_tpu_torch.backends.torch_backend  # noqa: F401
from nnstreamer_tpu_torch.backends.base import get_backend
from nnstreamer_tpu_torch.core.errors import BackendError, PipelineError
from nnstreamer_tpu_torch.tensor.info import TensorsSpec


class SingleShot:
    def __init__(self, model: Any, framework: str = "xla",
                 accelerator: str = "", custom: str = "",
                 input_spec: Optional[TensorsSpec] = None):
        self.backend = get_backend(framework)
        self.backend.open({
            "model": model,
            "accelerator": accelerator,
            "custom": custom,
        })
        self._in_spec, self._out_spec = self.backend.get_model_info()
        if input_spec is not None:
            self.set_input_info(input_spec)
        elif self._in_spec is not None and self._out_spec is None:
            self._out_spec = self.backend.set_input_info(self._in_spec)

    # -- info (getTensorsInfo analogs) -------------------------------------
    @property
    def input_info(self) -> Optional[TensorsSpec]:
        return self._in_spec

    @property
    def output_info(self) -> Optional[TensorsSpec]:
        return self._out_spec

    def set_input_info(self, spec: TensorsSpec) -> TensorsSpec:
        """Reconfigure for a new input shape (setInputDimension analog)."""
        self._in_spec = spec
        self._out_spec = self.backend.set_input_info(spec)
        return self._out_spec

    def set_fusion(self, pre=None, post=None) -> None:
        """Fuse elementwise pre/post fns into the model computation."""
        absorbed = self.backend.fuse(pre, post)
        if not absorbed:
            raise BackendError(
                f"backend {type(self.backend).BACKEND_NAME!r} cannot fuse; "
                f"apply the chains manually around invoke()")

    # -- hot path ----------------------------------------------------------
    def invoke(self, *tensors) -> Tuple[Any, ...]:
        if self._in_spec is None and not tensors:
            raise PipelineError("invoke() needs at least one input tensor")
        return self.backend.invoke(tuple(tensors))

    def reload(self, model: Any) -> None:
        self.backend.reload(model)

    def close(self) -> None:
        self.backend.close()

    def __enter__(self) -> "SingleShot":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

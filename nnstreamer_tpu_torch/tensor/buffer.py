"""TensorBuffer — the unit of data flowing through a pipeline.

Reference parity: a GstBuffer holding up to 16 tensor memories plus
PTS/duration (tensor_typedef.h:216-223). Payloads are arrays: numpy on the
host path, `torch.Tensor` once a filter has staged them on its device.
Elements pass references, never copies. A buffer downstream of a filter
keeps its tensors on the device until a sink or host decoder calls
`to_host()`, so a converter→filter→decoder chain makes one H2D and one
D2H transfer per frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorInfo, TensorsSpec


def is_device_tensor(x) -> bool:
    """A tensor a backend holds: a `torch.Tensor` on CUDA, or on the CPU
    device when the caller chose the CPU. Host payloads are numpy."""
    return isinstance(x, torch.Tensor)


@dataclass
class TensorBuffer:
    tensors: Tuple[Any, ...]              # numpy arrays or torch.Tensors
    pts: Optional[int] = None             # presentation time, ns
    duration: Optional[int] = None        # ns
    format: TensorFormat = TensorFormat.STATIC
    meta: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.tensors = tuple(self.tensors)

    @classmethod
    def of(cls, *arrays, pts: Optional[int] = None, **kw) -> "TensorBuffer":
        return cls(tensors=tuple(arrays), pts=pts, **kw)

    def spec(self) -> TensorsSpec:
        """Runtime type of this buffer (for validation against negotiation)."""
        infos = tuple(TensorInfo(shape=tuple(t.shape), dtype=DType.of(t))
                      for t in self.tensors)
        return TensorsSpec(tensors=infos, format=self.format)

    @property
    def on_device(self) -> bool:
        return any(is_device_tensor(t) for t in self.tensors)

    def to_host(self) -> "TensorBuffer":
        """Materialize all tensors as numpy (the one D2H point per frame),
        through the runtime's host-sync choke point."""
        if not self.on_device:
            return self
        from nnstreamer_tpu_torch.runtime.sync import to_host

        return replace(self, tensors=to_host(self.tensors),
                       meta=dict(self.meta))

    def with_tensors(self, tensors: Sequence[Any], **kw) -> "TensorBuffer":
        """New buffer with same timing, copied meta, different payload."""
        kw.setdefault("meta", dict(self.meta))
        return replace(self, tensors=tuple(tensors), **kw)

    def with_meta(self, **meta) -> "TensorBuffer":
        merged = dict(self.meta)
        merged.update(meta)
        return replace(self, meta=merged)

    def __repr__(self) -> str:
        shapes = ",".join(f"{DType.of(t).type_name}{list(t.shape)}"
                          for t in self.tensors)
        where = "dev" if self.on_device else "host"
        return f"TensorBuffer({shapes} @{self.pts} {where})"


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

import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.tensor.dtypes import DType, host_tensor
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorInfo, TensorsSpec


class HostCopy:
    """A device→host copy in flight: a pinned host tensor the copy was
    queued into, and a CUDA event recorded behind it on the tensor's
    stream. The pinned memory must not be read before the event is done
    (runtime/sync.to_host waits on it). `shape`/`dtype` are the tensor's."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(t.device))

    @property
    def shape(self):
        return self.host.shape

    @property
    def dtype(self):
        return self.host.dtype


def on_one_side(arrays) -> list:
    """The JAX package's `_xp` rule for joining arrays: all host arrays
    stay numpy; once one is a torch tensor, every one becomes a tensor on
    that tensor's device (host arrays through `host_tensor`, which reads
    bfloat16). A device tensor never moves to the host; tensors on two
    devices raise."""
    first = next((a for a in arrays if isinstance(a, torch.Tensor)), None)
    if first is None:
        return list(arrays)
    out = []
    for a in arrays:
        if not isinstance(a, torch.Tensor):
            a = host_tensor(np.asarray(a)).to(first.device)
        elif a.device != first.device:
            raise PipelineError(
                f"cannot join tensors on {first.device} and {a.device}; "
                f"route them to one device first")
        out.append(a)
    return out


def concatenate(arrays, axis: int):
    """np.concatenate or torch.cat, by `on_one_side`'s rule."""
    arrays = on_one_side(arrays)
    if isinstance(arrays[0], torch.Tensor):
        return torch.cat(arrays, dim=axis)
    return np.concatenate(arrays, axis=axis)


def coalesce(rows: Sequence, keep: bool):
    """Rows → one array: concatenated on axis 0 where `keep` (per-row
    leading dim 1), else stacked on a new axis 0, by `on_one_side`'s
    rule."""
    if keep:
        return concatenate(rows, 0)
    rows = on_one_side(rows)
    if isinstance(rows[0], torch.Tensor):
        return torch.stack(rows, dim=0)
    return np.stack(rows, axis=0)


def is_device_tensor(x) -> bool:
    """A tensor a backend holds: a `torch.Tensor` on CUDA, or on the CPU
    device when the caller chose the CPU, or a D2H copy still in flight.
    Host payloads are numpy."""
    return isinstance(x, (torch.Tensor, HostCopy))


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

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def subset(self, indices: Sequence[int]) -> "TensorBuffer":
        """Pick tensors by index (tensor_demux's tensorpick)."""
        if any(i < 0 or i >= self.num_tensors for i in indices):
            raise IndexError(
                f"tensor index out of range: buffer has {self.num_tensors} "
                f"tensors, requested {list(indices)}")
        return replace(self, tensors=tuple(self.tensors[i] for i in indices),
                       meta=dict(self.meta))

    def spec(self) -> TensorsSpec:
        """Runtime type of this buffer (for validation against negotiation)."""
        infos = tuple(TensorInfo(shape=tuple(t.shape), dtype=DType.of(t))
                      for t in self.tensors)
        return TensorsSpec(tensors=infos, format=self.format)

    def matches(self, spec: TensorsSpec) -> bool:
        """This buffer's runtime type is compatible with `spec`."""
        return self.spec().is_compatible(spec)

    @property
    def on_device(self) -> bool:
        return any(is_device_tensor(t) for t in self.tensors)

    def to_host(self, tracer=None, name=None) -> "TensorBuffer":
        """Materialize all tensors as numpy (the one D2H point per frame),
        through the runtime's host-sync choke point; the forced sync is
        traced on `tracer` under element `name` when given."""
        if not self.on_device:
            return self
        from nnstreamer_tpu_torch.runtime.sync import to_host

        return replace(self, tensors=to_host(self.tensors, tracer, name),
                       meta=dict(self.meta))

    def prefetch_host(self) -> "TensorBuffer":
        """Start the D2H copy of every CUDA tensor without waiting: a new
        buffer holding `HostCopy`s (pinned memory and an event each) in
        their place. A later to_host() waits only for what is still in
        flight. A plain `.to("cpu", non_blocking=True)` would not do:
        into pageable memory it is synchronous."""
        if not any(isinstance(t, torch.Tensor) and t.is_cuda
                   for t in self.tensors):
            return self
        return replace(self, tensors=tuple(
            HostCopy(t) if isinstance(t, torch.Tensor) and t.is_cuda else t
            for t in self.tensors), meta=dict(self.meta))

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


def now_ns() -> int:
    """Monotonic nanoseconds (the buffers' timestamp clock)."""
    return time.monotonic_ns()

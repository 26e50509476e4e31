"""Data-driven control elements. For now tensor_crop; tensor_if and
tensor_rate come later.

tensor_crop (the reference's gsttensor_crop.c) crops regions out of a
raw tensor stream by a second stream of crop geometry. Its output is
FLEXIBLE: the region sizes vary from buffer to buffer, so a filter
after it needs `invoke-dynamic=true` (or a tensor_resize between).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import Element, Emission, PropDef, StreamSpec
from nnstreamer_tpu_torch.runtime.sync import to_host
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec


@register_element("tensor_crop")
class TensorCrop(Element):
    """Sink pad 0: raw tensors; sink pad 1: crop info, per frame a tensor
    of shape (num_regions, 4) holding [x, y, w, h] (gsttensor_crop.c:18-33).
    A raw and an info buffer pair up when their pts lie within
    `lateness` ns of each other (:87); the older of two that do not is
    dropped. Regions are views of the raw tensor, so a CUDA frame is
    cropped on the card."""

    ELEMENT_NAME = "tensor_crop"
    NUM_SINK_PADS = 2
    # two-pad fan-in: chain fusion is single-in/single-out only
    CHAIN_FUSABLE = False
    PROPS = {
        "lateness": PropDef(int, 33_000_000, "max |pts_raw - pts_info| ns"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._raw: List[TensorBuffer] = []
        self._info: List[TensorBuffer] = []

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        raw = self.expect_tensors(in_specs[0], 0)
        self.expect_tensors(in_specs[1], 1)
        if raw.num_tensors != 1:
            self.fail_negotiation(
                f"tensor_crop takes a single-tensor raw stream, got "
                f"{raw.num_tensors} tensors (demux first)")
        t = raw.tensors[0]
        if len(t.shape) < 2:
            self.fail_negotiation(
                f"crop input must be at least rank-2 (spatial); got {t}")
        return [TensorsSpec(tensors=raw.tensors, format=TensorFormat.FLEXIBLE,
                            rate=raw.rate)]

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        (self._raw if pad == 0 else self._info).append(buf)
        out: List[Emission] = []
        lateness = self.props["lateness"]
        while self._raw and self._info:
            raw, info = self._raw[0], self._info[0]
            if abs((raw.pts or 0) - (info.pts or 0)) > lateness:
                # drop the older of the two and retry
                if (raw.pts or 0) < (info.pts or 0):
                    self._raw.pop(0)
                else:
                    self._info.pop(0)
                continue
            self._raw.pop(0)
            self._info.pop(0)
            out.append((0, self._crop(raw, info)))
        return out

    def _crop(self, raw: TensorBuffer, info: TensorBuffer) -> TensorBuffer:
        t = raw.tensors[0]
        geom = info.tensors[0]
        if isinstance(geom, torch.Tensor):
            (geom,) = to_host((geom,), self._tracer, self.name)
        regions = np.asarray(geom).reshape(-1, 4).astype(np.int64)
        # spatial dims: (..., H, W, C) at rank >= 3, else (H, W)
        h_ax = t.ndim - 3 if t.ndim >= 3 else 0
        w_ax = h_ax + 1
        H, W = t.shape[h_ax], t.shape[w_ax]
        crops = []
        for x, y, w, h in regions:
            x0, y0 = max(0, int(x)), max(0, int(y))
            x1, y1 = min(W, x0 + int(w)), min(H, y0 + int(h))
            sl = [slice(None)] * t.ndim
            sl[h_ax] = slice(y0, y1)
            sl[w_ax] = slice(x0, x1)
            crops.append(t[tuple(sl)])
        return TensorBuffer(tensors=tuple(crops), pts=raw.pts,
                            format=TensorFormat.FLEXIBLE)

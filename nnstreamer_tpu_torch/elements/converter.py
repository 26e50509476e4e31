"""tensor_converter — media→tensor ingress (video frames and tensor
passthrough; reference gsttensor_converter.c video branch :1046). A video
frame (H, W, C) becomes a (1, H, W, C) uint8 tensor."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.media import VideoSpec
from nnstreamer_tpu_torch.graph.pipeline import Element, Emission, StreamSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec


@register_element("tensor_converter")
class TensorConverter(Element):
    ELEMENT_NAME = "tensor_converter"

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = in_specs[0]
        if isinstance(spec, VideoSpec):
            h, w, c = spec.frame_shape
            if not (h and w):
                self.fail_negotiation(
                    "video input needs fixed width/height before conversion")
            return [TensorsSpec.of(TensorInfo((1, h, w, c), DType.UINT8),
                                   rate=spec.rate)]
        if isinstance(spec, TensorsSpec):
            return [spec]  # tensor passthrough
        self.fail_negotiation(f"no conversion for input stream {spec}")

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        spec = self.in_specs[0]
        if not isinstance(spec, VideoSpec):
            return [(0, buf)]
        frame = np.asarray(buf.tensors[0])
        if frame.shape != spec.frame_shape:
            raise PipelineError(
                f"tensor_converter {self.name}: video frame shape "
                f"{frame.shape} != negotiated {spec.frame_shape}")
        return [(0, buf.with_tensors((frame[None, ...],)))]

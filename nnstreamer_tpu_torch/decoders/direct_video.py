"""direct_video decoder — uint8 tensor → raw video frames (the JAX
package's decoders/direct_video.py).

Reference parity: ext/nnstreamer/tensor_decoder/tensordec-directvideo.c
(377 LoC): 1/3/4-channel uint8 tensors become GRAY8/RGB/BGRx video.
Row-major (H, W, C) tensors map directly; option1 may force the format.
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.elements.decoder import DecoderSubplugin, register_decoder
from nnstreamer_tpu_torch.graph.media import VideoSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

_BY_CHANNELS = {1: "GRAY8", 3: "RGB", 4: "RGBA"}


@register_decoder("direct_video")
class DirectVideo(DecoderSubplugin):
    def init(self, props: dict) -> None:
        self.force_format = props.get("option1", "") or None

    def negotiate(self, in_spec: TensorsSpec) -> VideoSpec:
        if in_spec.num_tensors != 1:
            raise ValueError(
                f"expects one video tensor, got {in_spec.num_tensors}")
        t = in_spec.tensors[0]
        if t.dtype != DType.UINT8:
            raise ValueError(
                f"direct_video needs uint8 input, got {t.dtype.type_name} "
                f"(insert tensor_transform mode=typecast option=uint8)")
        shape = t.shape
        if len(shape) == 4 and shape[0] == 1:
            shape = shape[1:]
        if len(shape) == 2:
            shape = shape + (1,)
        if len(shape) != 3 or shape[-1] not in _BY_CHANNELS:
            raise ValueError(
                f"cannot interpret shape {t.shape} as (H, W, C) video with "
                f"C in {sorted(_BY_CHANNELS)}")
        h, w, c = shape
        fmt = self.force_format or _BY_CHANNELS[c]
        return VideoSpec(width=w, height=h, format=fmt, rate=in_spec.rate)

    def decode(self, buf: TensorBuffer) -> TensorBuffer:
        t = np.asarray(buf.tensors[0])
        if t.ndim == 4 and t.shape[0] == 1:
            t = t[0]
        if t.ndim == 2:
            t = t[..., None]
        return buf.with_tensors((np.ascontiguousarray(t),))

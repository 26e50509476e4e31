"""PoseNet — single-person pose estimation (zoo://posenet), the JAX
package's models/posenet.py in PyTorch.

MobileNetV2 read at its stride-16 map (the map entering the last
stride-2 block), a 1x1 conv+BN projection to 256 channels, then 1x1
heatmap and offset heads: heatmaps (N, h, w, 17) through a sigmoid and
offsets (N, h, w, 34), both f32, NHWC at the public face. At 257² the
map is 17² (TF SAME pads: odd sizes round up at every stride 2).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nnstreamer_tpu_torch.models import layers as L
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, make_divisible
from nnstreamer_tpu_torch.models.zoo import register_model

NUM_KEYPOINTS = 17
#: maps up to and including the stride-16 one (MobileNetV2.features)
_STRIDE16_MAPS = 4


class PoseNet(nn.Module):
    """``forward(x)``: x (N, H, W, 3) NHWC float → (heatmaps (N, h, w, 17)
    sigmoid f32, offsets (N, h, w, 34) f32) at output stride 16."""

    def __init__(self, width: float = 1.0, dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.backbone = MobileNetV2(width, dtype=dtype, generator=generator)
        chead = 256
        self.proj = L.ConvBN(make_divisible(96 * width), chead, 1,
                             generator=generator)
        self.heatmap = L.Conv(chead, NUM_KEYPOINTS, 1, generator=generator)
        self.offset = L.Conv(chead, 2 * NUM_KEYPOINTS, 1, generator=generator)

    def forward(self, x: torch.Tensor):
        h16 = self.backbone.features(x.to(self.dtype).permute(0, 3, 1, 2),
                                     n_maps=_STRIDE16_MAPS)[-1]
        h = self.proj(h16)
        # the sigmoid in the compute dtype, then f32, as the JAX model does
        heat = torch.sigmoid(self.heatmap(h)).to(torch.float32)
        off = self.offset(h).to(torch.float32)
        return (heat.permute(0, 2, 3, 1).contiguous(),
                off.permute(0, 2, 3, 1).contiguous())


@register_model("posenet")
def build(width: float = 1.0, input_size: int = 257, batch: int = 1,
          dtype: str = "bfloat16", seed: int = 0):
    """Zoo builder: random weights from a seeded torch.Generator. The
    output spec is left to negotiation (one run on zeros)."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    gen = torch.Generator().manual_seed(seed)
    model = PoseNet(width, DType.from_name(dtype).torch_dtype,
                    generator=gen).eval()
    return ModelBundle(
        fn=lambda m, x: m(x), params=model,
        in_spec=TensorsSpec.of(
            TensorInfo((batch, input_size, input_size, 3), DType.FLOAT32)),
        out_spec=None, name="posenet_mnv2")

"""MobileNetV2 — the flagship classification model (zoo://mobilenet_v2).

Sandler et al. 2018 inverted residuals, width-multiplier aware, f32
params with bf16 compute by default, 1001 classes (background +
ImageNet) — the JAX package's models/mobilenet_v2.py in PyTorch. The
public layout stays the JAX one: input NHWC, logits (N, classes) f32.
Inside, the module runs NCHW.

Training (tensor_trainer): `init_params` builds the module in f32 as
the trainer's zoo:// resolution needs it, and `loss_fn` is the mean
softmax cross-entropy of the train-mode forward (BN on batch statistics,
models/layers.batch_norm_train), as the JAX module's.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from nnstreamer_tpu_torch.models import layers as L
from nnstreamer_tpu_torch.models.zoo import register_model

# (expansion t, out channels c, repeats n, first stride s) — the paper's
# table 2 / standard 1.0 config
INVERTED_RESIDUAL_CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def make_divisible(v: float, divisor: int = 8) -> int:
    """Round channel counts the MobileNet way (multiples of 8)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, t: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = cin * t
        self.stride = stride
        self.residual = stride == 1 and cin == cout
        self.expand = (L.ConvBN(cin, hidden, 1, generator=generator)
                       if t != 1 else None)
        self.depthwise = L.ConvBN(hidden, hidden, 3, stride=stride,
                                  groups=hidden, generator=generator)
        self.project = L.ConvBN(hidden, cout, 1, act=False,
                                generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.expand(x, train) if self.expand is not None else x
        h = self.project(self.depthwise(h, train), train)
        return h + x if self.residual else h


class MobileNetV2(nn.Module):
    """``forward(x)``: x NHWC float, normalized to roughly [-1, 1] →
    logits (N, num_classes) in f32, computed in `dtype`;
    ``forward(x, features_only=True)`` → the `features` maps, NHWC;
    ``forward(x, train=True)`` → logits with BN on the batch's statistics
    (the stored mean and var untouched), computed in ``dtype=`` when
    given."""

    def __init__(self, width: float = 1.0, num_classes: int = 1001,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        stem_out = make_divisible(32 * width)
        self.stem = L.ConvBN(3, stem_out, 3, stride=2, generator=generator)
        blocks = []
        cin = stem_out
        for t, c, n, s in INVERTED_RESIDUAL_CFG:
            cout = make_divisible(c * width)
            for i in range(n):
                blocks.append(InvertedResidual(cin, cout, t, s if i == 0 else 1,
                                               generator=generator))
                cin = cout
        self.blocks = nn.ModuleList(blocks)
        head_out = make_divisible(1280 * max(1.0, width))
        self.head = L.ConvBN(cin, head_out, 1, generator=generator)
        self.classifier = L.Dense(head_out, num_classes, generator=generator)

    def features(self, h: torch.Tensor,
                 n_maps: Optional[int] = None) -> List[torch.Tensor]:
        """NCHW input in the compute dtype → the map entering every
        stride-2 block, then the head's output (the JAX package's
        ``features_only``): at 300² the last two are the 19² map of
        96·width channels and the 10² head. NCHW, compute dtype.
        `n_maps` stops once that many maps are collected (PoseNet reads
        only the stride-16 map; XLA drops the rest as dead code)."""
        h = self.stem(h)
        feats = []
        for block in self.blocks:
            if block.stride == 2:
                feats.append(h)
                if len(feats) == n_maps:
                    return feats
            h = block(h)
        feats.append(self.head(h))
        return feats

    def forward(self, x: torch.Tensor, features_only: bool = False,
                train: bool = False, dtype: Optional[torch.dtype] = None):
        h = x.to(dtype or self.dtype).permute(0, 3, 1, 2)   # NHWC → NCHW
        if features_only:
            return [f.permute(0, 2, 3, 1) for f in self.features(h)]
        h = self.stem(h, train)
        for block in self.blocks:
            h = block(h, train)
        h = L.global_avg_pool(self.head(h, train))
        return self.classifier(h).to(torch.float32)


def init_params(*, width: float = 1.0, num_classes: int = 1001,
                seed: int = 0) -> MobileNetV2:
    """A trainable f32 MobileNetV2 from a seeded torch.Generator (the
    port's counterpart of the JAX param tree)."""
    gen = torch.Generator().manual_seed(seed)
    return MobileNetV2(width, num_classes, torch.float32, generator=gen)


def loss_fn(params: MobileNetV2, x: torch.Tensor, labels: torch.Tensor, *,
            width: float = 1.0, dtype: torch.dtype = torch.bfloat16):
    """Softmax cross-entropy of the train-mode forward, the batch's mean
    (`width` is the module's own; kept for the JAX signature)."""
    logp = F.log_softmax(params(x, train=True, dtype=dtype), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


@register_model("mobilenet_v2")
def build(width: float = 1.0, num_classes: int = 1001, input_size: int = 224,
          batch: int = 1, dtype: str = "bfloat16", seed: int = 0):
    """Zoo builder: random weights from a seeded torch.Generator."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    gen = torch.Generator().manual_seed(seed)
    model = MobileNetV2(width, num_classes, DType.from_name(dtype).torch_dtype,
                        generator=gen).eval()
    return ModelBundle(
        fn=lambda m, x: m(x), params=model,
        in_spec=TensorsSpec.of(
            TensorInfo((batch, input_size, input_size, 3), DType.FLOAT32)),
        out_spec=TensorsSpec.of(TensorInfo((batch, num_classes), DType.FLOAT32)),
        name=f"mobilenet_v2_{width}")

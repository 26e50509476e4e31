"""SSD-MobileNetV2 object detector (zoo://ssd_mobilenet) — the JAX
package's models/ssd_mobilenet.py in PyTorch.

Outputs per frame: loc deltas (N, A, 4) [ty, tx, th, tw] and class logits
(N, A, num_classes), f32, for A = 1917 anchors at 300² — the TF-SSD
anchor grid the bounding_boxes decoder generates in-code
(`generate_anchors`, no box-priors file).

The module runs NCHW inside. The heads' outputs are permuted to NHWC
before the reshape to (N, -1, 4): anchors are ordered (y, x, anchor) as
in the JAX package and as `generate_anchors` lays them out; a reshape of
the NCHW map would scramble them without an error.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from nnstreamer_tpu_torch.models import layers as L
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, make_divisible
from nnstreamer_tpu_torch.models.zoo import register_model

# feature-map grid sizes for 300x300 input and anchors per cell — yields
# the canonical 1917-anchor layout (19²·3 + (10²+5²+3²+2²+1)·6)
GRIDS_300 = ((19, 3), (10, 6), (5, 6), (3, 6), (2, 6), (1, 6))
SCALES = (0.2, 0.35, 0.5, 0.65, 0.8, 0.95, 1.0)
ASPECTS = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)
BOX_CODER = (10.0, 10.0, 5.0, 5.0)  # ty, tx, th, tw scale factors


def generate_anchors(grids=GRIDS_300) -> np.ndarray:
    """→ (A, 4) float32 [cy, cx, h, w] in [0,1] — the box-priors analog."""
    out: List[np.ndarray] = []
    for level, (g, n_anchor) in enumerate(grids):
        s = SCALES[level]
        s_next = SCALES[level + 1]
        if n_anchor == 3:
            # first layer: reduced set {1.0 scaled-down, 2.0, 0.5}
            hw = [(0.1, 0.1),
                  (s / math.sqrt(2.0), s * math.sqrt(2.0)),
                  (s * math.sqrt(2.0), s / math.sqrt(2.0))]
        else:
            hw = [(s / math.sqrt(a), s * math.sqrt(a)) for a in ASPECTS]
            hw.append((math.sqrt(s * s_next), math.sqrt(s * s_next)))
        ys, xs = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        cy = ((ys + 0.5) / g).reshape(-1)
        cx = ((xs + 0.5) / g).reshape(-1)
        per_anchor = [
            np.stack([cy, cx, np.full_like(cy, h), np.full_like(cx, w)], axis=-1)
            for h, w in hw[:n_anchor]
        ]
        # per-cell interleave (anchors of one cell contiguous) — matches
        # the heads' NHWC reshape(n, -1, 4) ordering
        lvl = np.stack(per_anchor, axis=1)  # (cells, n_anchor, 4)
        out.append(lvl.reshape(g * g * n_anchor, 4))
    return np.concatenate(out, axis=0).astype(np.float32)


def decode_boxes(loc, anchors):
    """SSD box-coder decode: deltas + priors → (ymin, xmin, ymax, xmax).
    numpy arrays in, numpy out (the host decoder); torch tensors in,
    torch out on their device (the device decoders)."""
    ty, tx, th, tw = (loc[..., 0] / BOX_CODER[0], loc[..., 1] / BOX_CODER[1],
                      loc[..., 2] / BOX_CODER[2], loc[..., 3] / BOX_CODER[3])
    acy, acx, ah, aw = (anchors[..., 0], anchors[..., 1],
                        anchors[..., 2], anchors[..., 3])
    xp = torch if isinstance(loc, torch.Tensor) else np
    cy = ty * ah + acy
    cx = tx * aw + acx
    h = ah * xp.exp(th)
    w = aw * xp.exp(tw)
    if xp is torch:
        return torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                           dim=-1)
    return np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], axis=-1)


class Extra(nn.Module):
    """SSD extra layer: 1x1 squeeze to cout/2, then 3x3 stride 2 to cout."""

    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.squeeze = L.ConvBN(cin, cout // 2, 1, generator=generator)
        self.conv = L.ConvBN(cout // 2, cout, 3, stride=2, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.squeeze(x))


class SSDMobileNetV2(nn.Module):
    """``forward(x)``: x (N, 300, 300, 3) NHWC float → (loc (N, A, 4),
    logits (N, A, num_classes)), both f32, computed in `dtype`."""

    def __init__(self, num_classes: int = 91, width: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.backbone = MobileNetV2(width, dtype=dtype, generator=generator)
        head_in = [make_divisible(96 * width),          # stride-16 map (19²)
                   make_divisible(1280 * max(1.0, width)),
                   512, 256, 256, 128]
        extras, cin = [], head_in[1]
        for cout in head_in[2:]:
            extras.append(Extra(cin, cout, generator))
            cin = cout
        self.extras = nn.ModuleList(extras)
        self.loc_heads = nn.ModuleList(
            L.Conv(c, n * 4, 3, generator=generator)
            for (_, n), c in zip(GRIDS_300, head_in))
        self.cls_heads = nn.ModuleList(
            L.Conv(c, n * num_classes, 3, generator=generator)
            for (_, n), c in zip(GRIDS_300, head_in))

    def forward(self, x: torch.Tensor):
        n = x.shape[0]
        feats = self.backbone.features(x.to(self.dtype).permute(0, 3, 1, 2))
        levels = [feats[-2], feats[-1]]
        h = feats[-1]
        for extra in self.extras:
            h = extra(h)
            levels.append(h)
        locs, clss = [], []
        for lvl, lh, ch in zip(levels, self.loc_heads, self.cls_heads):
            # NCHW → NHWC first: anchors ordered (y, x, anchor)
            locs.append(lh(lvl).permute(0, 2, 3, 1).reshape(n, -1, 4))
            clss.append(ch(lvl).permute(0, 2, 3, 1).reshape(
                n, -1, self.num_classes))
        return (torch.cat(locs, dim=1).to(torch.float32),
                torch.cat(clss, dim=1).to(torch.float32))


@register_model("ssd_mobilenet")
def build(num_classes: int = 91, width: float = 1.0, input_size: int = 300,
          batch: int = 1, dtype: str = "bfloat16", seed: int = 0):
    """Zoo builder: random weights from a seeded torch.Generator."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.core.errors import BackendError
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    if input_size != 300:
        raise BackendError(
            "zoo://ssd_mobilenet ships the canonical 300x300 anchor grid "
            "(1917 anchors); input_size must be 300")
    gen = torch.Generator().manual_seed(seed)
    model = SSDMobileNetV2(num_classes, width,
                           DType.from_name(dtype).torch_dtype,
                           generator=gen).eval()
    n_anchors = int(generate_anchors().shape[0])
    return ModelBundle(
        fn=lambda m, x: m(x), params=model,
        in_spec=TensorsSpec.of(
            TensorInfo((batch, input_size, input_size, 3), DType.FLOAT32)),
        out_spec=TensorsSpec.of(
            TensorInfo((batch, n_anchors, 4), DType.FLOAT32, name="loc"),
            TensorInfo((batch, n_anchors, num_classes), DType.FLOAT32,
                       name="scores")),
        name="ssd_mobilenet_v2")

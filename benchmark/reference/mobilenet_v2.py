"""MobileNetV2 (Sandler et al., arXiv:1801.04381, Table 2; TF-slim's
`mobilenet_v2_1.0_224`) in plain PyTorch, float32.

Layout: NHWC uint8 frames in; the stream's normalisation
(x − 127.5) / 127.5 in float32; TF "SAME" padding (a stride-2 conv at an
even size pads 0 before and 1 after); each conv followed by inference
batch norm ``(y − mean) · rsqrt(var + eps) · scale + bias`` (eps 1e-3, as
TF-slim) and ReLU6, except the projection; a residual where stride is 1
and channels match; 1x1 head conv, global average pool, dense
classifier with bias; logits (N, classes) float32.

Parameters are a flat dict of tensors under the names `param_shapes`
lists (``stem.weight``, ``blocks.3.depthwise.scale``, ...): conv weights
(out, in/groups, k, k), the classifier (classes, channels).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.cost.mobilenet_v2 import make_divisible
from benchmark.reference.precision import operand

#: per conv unit: weight then the four batch-norm vectors
BN_KEYS = ("scale", "bias", "mean", "var")


def _units(cfg: dict) -> List[Tuple[str, int, int, int, int, int, bool]]:
    """(name, k, cin, cout, groups, stride, relu6) of every conv unit."""
    width = float(cfg["width_multiplier"])
    units = []
    cin = make_divisible(int(cfg["first_channels"]) * width)
    units.append(("stem", 3, 3, cin, 1, 2, True))
    i = 0
    for t, c, n, s in cfg["inverted_residual_setting"]:
        cout = make_divisible(c * width)
        for r in range(n):
            stride = s if r == 0 else 1
            hidden = cin * t
            if t != 1:
                units.append((f"blocks.{i}.expand", 1, cin, hidden, 1, 1,
                              True))
            units.append((f"blocks.{i}.depthwise", 3, hidden, hidden, hidden,
                          stride, True))
            units.append((f"blocks.{i}.project", 1, hidden, cout, 1, 1,
                          False))
            cin = cout
            i += 1
    last = make_divisible(int(cfg["last_channels"]) * max(1.0, width))
    units.append(("head", 1, cin, last, 1, 1, True))
    return units


def param_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, in a fixed order; kind is
    ``conv`` (fan-in = shape[1]·k·k), ``scale``, ``bias``, ``mean``,
    ``var``, ``dense`` or ``dense_bias``."""
    out = []
    cin_last = None
    for name, k, cin, cout, g, _, _ in _units(cfg):
        out.append((f"{name}.weight", (cout, cin // g, k, k), "conv"))
        for key in BN_KEYS:
            out.append((f"{name}.{key}", (cout,), key))
        cin_last = cout
    ncls = int(cfg["num_classes"])
    out.append(("classifier.weight", (ncls, cin_last), "dense"))
    out.append(("classifier.bias", (ncls,), "dense_bias"))
    return out


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    pads = []
    for n in (x.shape[3], x.shape[2]):      # W then H, as F.pad wants
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _unit(params, name, x, k, g, s, act, eps, precision):
    w = operand(params[f"{name}.weight"].float(), (1, 2, 3), precision)
    xin = operand(x, (1, 2, 3), precision)
    y = F.conv2d(_same_pad(xin, k, s), w, stride=s, groups=g)
    sc, b, m, v = (params[f"{name}.{key}"].float().view(1, -1, 1, 1)
                   for key in BN_KEYS)
    y = (y - m) * (torch.rsqrt(v + eps) * sc) + b
    return y.clamp(0.0, 6.0) if act else y


def forward(params: Dict[str, torch.Tensor], frames: torch.Tensor,
            cfg: dict, precision: str = "f32") -> torch.Tensor:
    """uint8 NHWC frames → logits (N, classes) float32."""
    eps = float(cfg["bn_eps"])
    x = (frames.to(torch.float32) - 127.5) / 127.5
    x = x.permute(0, 3, 1, 2)
    block_in = x
    for name, k, _, _, g, s, act in _units(cfg):
        if name.endswith(".expand") or (
                name.endswith(".depthwise") and
                name.replace(".depthwise", ".expand") + ".weight"
                not in params):
            block_in = x                  # a block starts here
        x = _unit(params, name, x, k, g, s, act, eps, precision)
        if name.endswith(".project") and block_in.shape == x.shape:
            x = x + block_in              # stride 1, same channels
    x = x.mean(dim=(2, 3))
    w = operand(params["classifier.weight"].float(), (1,), precision)
    return operand(x, (1,), precision) @ w.t() + \
        params["classifier.bias"].float()

"""NN layers for the model zoo, in PyTorch.

Functions on NCHW tensors with OIHW weights, and the `ConvBN` module built
from them. Each keeps the JAX package's arithmetic (models/layers.py):

- conv2d pads like TF "SAME": the total pad is
  max((ceil(n/s) - 1)*s + k - n, 0), split floor-before / rest-after, so
  a stride-2 conv at an even size pads 0 before and 1 after. torch's
  padding="same" refuses stride > 1, so uneven pads go through F.pad.
- batch_norm (inference) is ``(x - mean) * (rsqrt(var + eps) * scale) +
  bias`` with eps 1e-3; the factor is computed in f32 and every operand is
  cast to the activation's dtype, as the JAX layer does.
- batch_norm_train (training) takes mean and biased var of the batch
  over N, H and W in f32 in their place, and writes no running
  statistics back: JAX's `conv_bn` drops the batch statistics, so the
  stored mean and var never change under training.
- relu6 is a clip to [0, 6].
- Params stay f32; the forward casts weights and input to the compute
  dtype at each op.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """TF SAME padding of one spatial dim → (before, after)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           groups: int = 1, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NCHW conv with OIHW weights and TF SAME padding."""
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    (pt, pb) = same_pads(x.shape[2], w.shape[2], stride)
    (pl, pr) = same_pads(x.shape[3], w.shape[3], stride)
    if pt == pb and pl == pr:
        return F.conv2d(x, w, stride=stride, padding=(pt, pl), groups=groups)
    x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(x, w, stride=stride, groups=groups)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor,
               eps: float = BN_EPS) -> torch.Tensor:
    """Inference BN over the channel dim (1) of an NCHW tensor."""
    inv = torch.rsqrt(var + eps) * scale
    shape = (1, -1, 1, 1)
    dt = x.dtype
    return ((x - mean.to(dt).view(shape)) * inv.to(dt).view(shape)
            + bias.to(dt).view(shape))


#: per thread: the reduction `batch_stats` installs (None: this shard's
#: rows are the whole batch)
_STATS = threading.local()


@contextmanager
def batch_stats(reduce: Callable[[torch.Tensor, int], torch.Tensor]):
    """Within, batch_norm_train on this thread takes each statistic
    through ``reduce(sums, count)``: `sums` the (C,) f32 per-channel sum
    over this shard's elements, `count` their number a channel → the
    mean over every shard's elements, on this shard's device."""
    prev = getattr(_STATS, "reduce", None)
    _STATS.reduce = reduce
    try:
        yield
    finally:
        _STATS.reduce = prev


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = BN_EPS) -> torch.Tensor:
    """Train-mode BN over the channel dim (1) of an NCHW tensor: the
    batch's f32 mean and biased variance over N, H and W (``jnp.mean``,
    ``jnp.var``) stand in for the stored statistics. Under `batch_stats`
    both are the global batch's: the sums, then the sums of squares
    about the global mean, reduced over the shards."""
    xf = x.float()
    reduce = getattr(_STATS, "reduce", None)
    if reduce is None:
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
    else:
        n = xf.numel() // xf.shape[1]
        mean = reduce(xf.sum(dim=(0, 2, 3)), n)
        var = reduce((xf - mean.view(1, -1, 1, 1)).square().sum(
            dim=(0, 2, 3)), n)
    return batch_norm(x, scale, bias, mean, var, eps)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW → NC mean over spatial dims."""
    return x.mean(dim=(2, 3))


def kaiming_init_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """sqrt(2/fan_in) * truncated normal on [-2, 2] (the JAX zoo's init)."""
    std = math.sqrt(2.0 / max(1, fan_in))
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def xavier_uniform(shape: Tuple[int, int],
                   generator: torch.Generator) -> torch.Tensor:
    """f32 (in, out) dense weight, uniform on ±sqrt(6/(in+out)) (the JAX
    zoo's xavier_init for a 2-D shape)."""
    limit = math.sqrt(6.0 / max(1, shape[0] + shape[1]))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


class ConvBN(nn.Module):
    """Conv (SAME) + BN (+ relu6) — the MobileNet building unit.
    ``groups == cin == cout`` is depthwise (weights (C, 1, kh, kw)).
    ``forward(x, train=True)`` normalizes by the batch's statistics
    (batch_norm_train) and leaves `mean` and `var` as they are."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 groups: int = 1, act: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.groups, self.act = stride, groups, act
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        kaiming_init_(self.weight.data, k * k * (cin // groups), generator)
        self.scale = nn.Parameter(torch.ones(cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("mean", torch.zeros(cout))
        self.register_buffer("var", torch.ones(cout))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = conv2d(x, self.weight, stride=self.stride, groups=self.groups,
                   dtype=x.dtype)
        if train:
            y = batch_norm_train(y, self.scale, self.bias)
        else:
            y = batch_norm(y, self.scale, self.bias, self.mean, self.var)
        return relu6(y) if self.act else y


class Conv(nn.Module):
    """Bias-free conv (SAME), stride 1, in the input's dtype: the SSD and
    PoseNet heads (the JAX package's ``init_conv`` + ``conv2d``)."""

    def __init__(self, cin: int, cout: int, k: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        kaiming_init_(self.weight.data, k * k * cin, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, dtype=x.dtype)


class Dense(nn.Module):
    """``x @ w.T + b`` in the input's dtype; weight (cout, cin) as
    nn.Linear keeps it. The bias is added after the product is rounded,
    as the JAX layer's ``x @ w + b``."""

    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        limit = math.sqrt(6.0 / (cin + cout))  # xavier uniform
        self.weight = nn.Parameter(torch.empty(cout, cin))
        nn.init.uniform_(self.weight.data, -limit, limit, generator=generator)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return F.linear(x, self.weight.to(dt)) + self.bias.to(dt)

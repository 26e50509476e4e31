"""1-D conv audio classifier (zoo://audio_classifier) — the audio family,
the JAX package's models/audio_classifier.py in PyTorch.

Per-window standardization (mean and population std, as ``jnp.std``) →
stacked stride-4 conv1d blocks with TF "SAME" padding → ReLU → global
mean pool → linear head. ``F.conv1d`` refuses ``padding="same"`` at
stride > 1, so each block pads explicitly as XLA does: a total of
``max((ceil(T/4) - 1)·4 + K - T, 0)``, ``total // 2`` on the left and
the rest on the right (uneven at some windows: (3, 4) at T 1001).

Params: ``{"blocks": [{"w": (Cout, Cin, K), "b": (Cout,)}], "head_w":
(C, num_classes), "head_b"}`` — JAX's conv weights are WIO (K, Cin,
Cout); models/bridge.audio_classifier_params transposes them once.

Pipeline shape (tests/test_streaming_models.py):
    audiotestsrc ! tensor_converter frames-per-tensor=<window> !
    tensor_transform mode=typecast option=float32 !
    tensor_filter model=zoo://audio_classifier?window=<window> !
    tensor_sink

`loss_fn` trains it through tensor_trainer: the mean cross-entropy of
one-hot labels against the log-softmax, as JAX's.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.models import layers as L
from nnstreamer_tpu_torch.models.zoo import register_model

KERNEL = 8
STRIDE = 4


def init_params(*, channels: int = 32, n_blocks: int = 3,
                num_classes: int = 12, seed: int = 0,
                **_) -> Dict[str, Any]:
    """Random f32 params from a seeded torch.Generator (xavier uniform on
    the JAX shapes' fans, zero biases). `**_` absorbs pass-through kwargs
    (tensor_trainer's width): the conv stack is window-agnostic."""
    gen = torch.Generator().manual_seed(seed)
    blocks = []
    cin = 1
    for _ in range(n_blocks):
        limit = math.sqrt(6.0 / (KERNEL * cin + KERNEL * channels))
        w = torch.empty(channels, cin, KERNEL).uniform_(-limit, limit,
                                                        generator=gen)
        blocks.append({"w": w, "b": torch.zeros(channels)})
        cin = channels
    return {"blocks": blocks,
            "head_w": L.xavier_uniform((channels, num_classes), gen),
            "head_b": torch.zeros(num_classes)}


def apply(params, x: torch.Tensor, *, dtype: torch.dtype = torch.float32):
    """x: (B, T) or (B, T, 1) waveform → (B, num_classes) f32 logits."""
    if x.dim() == 2:
        x = x[..., None]
    h = x.to(dtype)
    mu = h.mean(dim=1, keepdim=True)
    sd = h.std(dim=1, keepdim=True, correction=0) + 1e-5
    h = ((h - mu) / sd).transpose(1, 2)                  # (B, 1, T)
    for blk in params["blocks"]:
        w = blk["w"].to(dtype)
        lo, hi = L.same_pads(h.shape[-1], w.shape[-1], STRIDE)
        h = F.conv1d(F.pad(h, (lo, hi)), w, stride=STRIDE)
        h = F.relu(h + blk["b"].to(dtype)[None, :, None])
    pooled = h.mean(dim=2)                               # (B, C)
    return (pooled @ params["head_w"].to(dtype)
            + params["head_b"].to(dtype)).float()


def loss_fn(params, x: torch.Tensor, y: torch.Tensor, *,
            dtype: torch.dtype = torch.float32, **_):
    """Mean cross-entropy: one-hot labels times the log-softmax."""
    logits = apply(params, x, dtype=dtype)
    onehot = F.one_hot(y.long(), logits.shape[-1]).to(logits.dtype)
    return -(onehot * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


@register_model("audio_classifier")
def build(window: int = 1024, channels: int = 32, n_blocks: int = 3,
          num_classes: int = 12, batch: int = 1, dtype: str = "float32",
          seed: int = 0):
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    cdtype = DType.from_name(dtype).torch_dtype
    params = init_params(channels=channels, n_blocks=n_blocks,
                         num_classes=num_classes, seed=seed)
    # the stream unit is ONE converter window (window, 1), the shape
    # `tensor_converter frames-per-tensor=<window>` emits; batch > 1
    # takes stacked windows (batch, window, 1)
    if batch == 1:
        def fn(params, x):
            return apply(params, x[None], dtype=cdtype)[0]

        in_spec = TensorsSpec.of(
            TensorInfo((window, 1), DType.FLOAT32, name="wave"))
        out_spec = TensorsSpec.of(
            TensorInfo((num_classes,), DType.FLOAT32, name="logits"))
    else:
        def fn(params, x):
            return apply(params, x, dtype=cdtype)

        in_spec = TensorsSpec.of(
            TensorInfo((batch, window, 1), DType.FLOAT32, name="wave"))
        out_spec = TensorsSpec.of(
            TensorInfo((batch, num_classes), DType.FLOAT32, name="logits"))
    return ModelBundle(fn=fn, params=params, in_spec=in_spec,
                       out_spec=out_spec, name="audio_classifier")

"""Streaming LSTM (zoo://lstm) — the recurrent-state use case, the JAX
package's models/lstm.py in PyTorch.

The cell's (h, c) state flows through the pipeline as tensors; pair it
with tensor_repo_src/sink to close the loop:

    tensor_repo_src (state) ─┐
    appsrc (x)              ─┴→ tensor_mux → tensor_filter(zoo://lstm)
                                 → tensor_demux ┬→ outputs
                                                └→ tensor_repo_sink

Model signature: fn(params, x, h, c) → (y, h', c') with x (B, D_in),
h/c (B, D_hidden). One fused weight per input for the four gates, in the
JAX layout: ``wx`` (d_in, 4h), ``wh`` (h, 4h), used as ``x @ wx``, the
gates split i, f, g, o in that order; the forget gate is
``sigmoid(f + 1.0)``, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from nnstreamer_tpu_torch.models import layers as L
from nnstreamer_tpu_torch.models.zoo import register_model


def init_params(*, d_in: int = 32, d_hidden: int = 64,
                seed: int = 0) -> Dict[str, Any]:
    """Random f32 params from a seeded torch.Generator (xavier uniform,
    zero bias). `jax.random` cannot be reproduced here: parity runs load
    the JAX package's params through models/bridge.lstm_params."""
    gen = torch.Generator().manual_seed(seed)
    return {
        "wx": L.xavier_uniform((d_in, 4 * d_hidden), gen),
        "wh": L.xavier_uniform((d_hidden, 4 * d_hidden), gen),
        "b": torch.zeros(4 * d_hidden),
    }


def apply(params, x, h, c, *, dtype: torch.dtype = torch.float32):
    x, h, c = x.to(dtype), h.to(dtype), c.to(dtype)
    z = x @ params["wx"].to(dtype) + h @ params["wh"].to(dtype) \
        + params["b"].to(dtype)
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    y = h_new.float()
    return y, y, c_new.float()


@register_model("lstm")
def build(d_in: int = 32, d_hidden: int = 64, batch: int = 1,
          dtype: str = "float32", seed: int = 0):
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    cdtype = DType.from_name(dtype).torch_dtype
    params = init_params(d_in=d_in, d_hidden=d_hidden, seed=seed)

    def fn(params, x, h, c):
        return apply(params, x, h, c, dtype=cdtype)

    in_spec = TensorsSpec.of(
        TensorInfo((batch, d_in), DType.FLOAT32, name="x"),
        TensorInfo((batch, d_hidden), DType.FLOAT32, name="h"),
        TensorInfo((batch, d_hidden), DType.FLOAT32, name="c"),
    )
    out_spec = TensorsSpec.of(
        TensorInfo((batch, d_hidden), DType.FLOAT32, name="y"),
        TensorInfo((batch, d_hidden), DType.FLOAT32, name="h"),
        TensorInfo((batch, d_hidden), DType.FLOAT32, name="c"),
    )
    return ModelBundle(fn=fn, params=params, in_spec=in_spec,
                       out_spec=out_spec, name="lstm")

"""Known-answer probe models (zoo://probe_scale | probe_negate |
probe_offset), the counterpart of the JAX package's models/probe.py: the
multi-tenant and canary test fixtures.

Three distinct models sharing one input contract (``(8, 1) float32``,
the serving tests' frame shape) whose outputs are exactly predictable
from the input: ``scale * x``, ``-x`` and ``x + offset``. Whichever
model — or version — served a frame shows in its numbers, so a routing
error, a stale graph after an eviction, or a swap leaking into another
tenant's traffic is wrong arithmetic instead of silent corruption.

Each builder is parametric (``zoo://probe_scale?scale=3``), so the same
zoo name yields distinguishable *versions* for hot-swap and canary
tests: register ``probe_scale`` at another scale as a second version and
a swap flips the answer by a known factor.
"""

from __future__ import annotations

import torch

from nnstreamer_tpu_torch.models.zoo import register_model

_ROWS = 8  # the serving tests' canonical 8:1 float32 frame


def _bundle(fn, params, name: str, rows: int):
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    spec = TensorsSpec.of(TensorInfo((rows, 1), DType.FLOAT32, name="x"))
    return ModelBundle(fn=fn, params=params, in_spec=spec,
                       out_spec=spec, name=name)


@register_model("probe_scale")
def build_scale(scale: float = 2.0, rows: int = _ROWS):
    params = {"scale": torch.tensor(scale, dtype=torch.float32)}

    def fn(params, x):
        return x * params["scale"]

    return _bundle(fn, params, "probe_scale", rows)


@register_model("probe_negate")
def build_negate(rows: int = _ROWS):
    def fn(params, x):
        return -x

    return _bundle(fn, None, "probe_negate", rows)


@register_model("probe_offset")
def build_offset(offset: float = 10.0, rows: int = _ROWS):
    params = {"offset": torch.tensor(offset, dtype=torch.float32)}

    def fn(params, x):
        return x + params["offset"]

    return _bundle(fn, params, "probe_offset", rows)

"""Rounding helpers of the references."""

from __future__ import annotations

import torch

#: largest finite float8 e4m3 value
FP8_MAX = 448.0


def no_tf32() -> None:
    """float32 products in float32: TF32 off for matmuls and convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """`x` (float32) rounded to float8 e4m3 with one scale per slice
    that `dims` reduces over (the absolute maximum maps to 448), back in
    float32."""
    amax = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def operand(x: torch.Tensor, dims, precision: str) -> torch.Tensor:
    """A product's operand in the reference's precision."""
    if precision == "f32":
        return x
    if precision == "fp8":
        return fp8(x, dims)
    raise ValueError(f"unknown reference precision {precision!r}")

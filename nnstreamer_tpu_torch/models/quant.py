"""W8A8 quantized matmul path for the transformer (counterpart of the JAX
package's models/quant.py).

Weights are quantized per output channel (symmetric int8, one f32 scale
per column), activations per row at run time (dynamic symmetric int8:
one amax and scale per row, the `quantize_rows` kernel), the product runs
int8 × int8 → int32, and the int32 sums are rescaled in f32. Norms,
embeddings, rope and attention stay in the activation dtype; only the
projections change.

The int8 product is `torch._int_mm`: on the card cuBLASLt's int8 tensor
cores, on the CPU an exact integer product. On the card it needs more
than 16 rows and a depth and width that are multiples of 8, so
`w8a8_matmul` pads with zero rows and columns (zeros add nothing to an
integer sum) and slices the result back: a decode step's 1-8 rows and a
vocabulary of 61 run as the JAX package runs them. The int8 weight is
read column-major: with a row-major weight cuBLASLt takes a generic int8
kernel 4.9× slower at 16384×1024×3072 on the H100 (chip_smoke.py phase
15), so `quantize_weight`
returns that layout and `int_mm_operands` copies any other weight to it.

How fast W8A8 is on the H100 against bf16 is measured by chip_smoke.py
(PERF.md), not carried over from the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

#: torch._int_mm's rules on CUDA: rows > 16; depth and width multiples of 8
_INT_MM_MIN_ROWS, _INT_MM_MULTIPLE = 17, 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def quantize_weight(w, axis: int = 1):
    """Symmetric per-output-channel int8 quantization of a 2-D weight →
    (int8 like w, f32 scales). `axis` is the OUTPUT dim (scales broadcast
    over it on dequant): (1, N) for the default."""
    w = torch.as_tensor(w, dtype=torch.float32)
    amax = w.abs().amax(dim=1 - axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return column_major(q), scale


def column_major(w_q: torch.Tensor) -> torch.Tensor:
    """The same (K, N) matrix stored column-major (strides (1, K)): the
    layout the card's int8 product reads fast."""
    return w_q.t().contiguous().t()


def quantize_transformer(params: Dict[str, Any]) -> Dict[str, Any]:
    """Float transformer params → W8A8 params: every large matmul weight
    (wqkv/wo/wi/wd/head) becomes int8 plus ``<name>_scale`` (1, N) f32;
    norms and the embedding stay float."""
    out: Dict[str, Any] = {"embed": params["embed"], "ln_f": params["ln_f"],
                           "blocks": []}
    for blk in params["blocks"]:
        qblk = {"ln1": blk["ln1"], "ln2": blk["ln2"]}
        for name in ("wqkv", "wo", "wi", "wd"):
            qblk[name], qblk[f"{name}_scale"] = quantize_weight(blk[name])
        out["blocks"].append(qblk)
    out["head"], out["head_scale"] = quantize_weight(params["head"])
    return out


def int_mm_operands(x_q: torch.Tensor, w_q: torch.Tensor):
    """The operands of torch._int_mm on the card: x_q zero-padded to more
    than 16 rows, and both to a depth and width that are multiples of 8;
    the weight column-major. The product's top-left (M, N) block is
    x_q @ w_q."""
    m, k = x_q.shape
    n = w_q.shape[1]
    mp = _round_up(max(m, _INT_MM_MIN_ROWS), _INT_MM_MULTIPLE)
    kp, np_ = _round_up(k, _INT_MM_MULTIPLE), _round_up(n, _INT_MM_MULTIPLE)
    if (mp, kp) != (m, k):
        x_q = F.pad(x_q, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        w_q = F.pad(w_q, (0, np_ - n, 0, kp - k))
    if w_q.stride() != (1, kp):
        w_q = column_major(w_q)
    return x_q, w_q


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) × int8 (K, N) → int32 (M, N), exact. On the card the
    operands go through `int_mm_operands` and the result is sliced back;
    on the CPU torch._int_mm takes any shape."""
    if not x_q.is_cuda:
        return torch._int_mm(x_q, w_q)
    m, n = x_q.shape[0], w_q.shape[1]
    return torch._int_mm(*int_mm_operands(x_q, w_q))[:m, :n]


def w8a8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """(…, K) f32/bf16 × int8 (K, N) → (…, N) f32: per-row activation
    quantization (`quantize_rows`), the int8 product, then the rescale
    ``acc * x_scale * w_scale`` left to right in f32, as the JAX
    package's."""
    from nnstreamer_tpu_torch.backends.kernels import quantize_rows

    lead = x.shape[:-1]
    x_q, x_scale = quantize_rows(x.reshape(-1, x.shape[-1]))
    acc = int8_matmul(x_q, w_q)
    # int32 × f32 promotes to f32: acc.float() * x_scale bit for bit,
    # without a separate pass that converts acc
    out = acc * x_scale * w_scale.reshape(1, -1)
    return out.reshape(*lead, out.shape[-1])


def apply_seq_w8a8(params_q, ids, *, n_heads: int = 4, attn: str = "auto",
                   dtype: torch.dtype = torch.float32):
    """Full-sequence forward with W8A8 projections — the quantized twin of
    `transformer.apply_seq`: (B, S) int → (B, S, vocab) f32 logits.
    ``attn="pallas"`` (or ``"auto"`` when S % 128 == 0) runs the flash
    kernel on q/k/v cast to bf16; otherwise the reference attention.
    `dtype` is the activation dtype between the products."""
    from nnstreamer_tpu_torch.backends.kernels import flash_attention
    from nnstreamer_tpu_torch.models import transformer as T
    from nnstreamer_tpu_torch.parallel.ring_attention import (
        reference_attention)

    b, s = ids.shape
    x = params_q["embed"][ids].to(dtype)
    pos = torch.arange(s, device=ids.device)
    use_pallas = attn == "pallas" or (attn == "auto" and s % 128 == 0)
    for blk in params_q["blocks"]:
        h = T.rmsnorm(x, blk["ln1"].to(dtype))
        qkv = w8a8_matmul(h, blk["wqkv"], blk["wqkv_scale"]).to(dtype)
        d = x.shape[-1]
        hd = d // n_heads
        kv_dim = (qkv.shape[-1] - d) // 2
        n_kv = kv_dim // hd
        q = qkv[..., :d].reshape(b, s, n_heads, hd)
        k = qkv[..., d:d + kv_dim].reshape(b, s, n_kv, hd)
        v = qkv[..., d + kv_dim:].reshape(b, s, n_kv, hd)
        q, k = T.rope(q, pos), T.rope(k, pos)
        k, v = T._expand_kv(k, n_heads), T._expand_kv(v, n_heads)
        if use_pallas:
            attn_out = flash_attention(q.to(torch.bfloat16),
                                       k.to(torch.bfloat16),
                                       v.to(torch.bfloat16), causal=True)
        else:
            attn_out = reference_attention(q, k, v, causal=True)
        attn_out = attn_out.reshape(b, s, -1).to(dtype)
        x = x + w8a8_matmul(attn_out, blk["wo"], blk["wo_scale"]).to(dtype)
        h = T.rmsnorm(x, blk["ln2"].to(dtype))
        gate, up = w8a8_matmul(h, blk["wi"],
                               blk["wi_scale"]).to(dtype).chunk(2, dim=-1)
        x = x + w8a8_matmul(F.silu(gate) * up, blk["wd"],
                            blk["wd_scale"]).to(dtype)
    x = T.rmsnorm(x, params_q["ln_f"].to(dtype))
    return w8a8_matmul(x, params_q["head"], params_q["head_scale"])


def apply_step_w8a8(params_q, ids, k_cache, v_cache, pos, *,
                    n_heads: int = 4, dtype: torch.dtype = torch.bfloat16):
    """One streaming decode step with W8A8 projections — the quantized
    twin of `transformer.apply_step`, sharing its body
    (`transformer._step_impl`); only the five projections differ."""
    from nnstreamer_tpu_torch.models.transformer import _step_impl

    def proj(store, name, x):
        return w8a8_matmul(x, store[name], store[f"{name}_scale"]).to(dtype)

    return _step_impl(params_q, ids, k_cache, v_cache, pos, n_heads, dtype,
                      proj)

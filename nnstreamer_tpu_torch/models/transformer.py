"""Decoder-only transformer (zoo://transformer) — the LLM serving model
(counterpart of the JAX package's models/transformer.py).

Pre-RMSNorm, rotary position embeddings, multi-head (or grouped-query)
causal attention, SwiGLU MLP. Params are a plain dict in the JAX
package's layout, so the bridge is a copy (models/bridge.py):
``{"embed": (vocab, d), "blocks": [{"ln1", "wqkv": (d, d + 2·kv_dim),
"wo", "ln2", "wi": (d, 2·d_ff), "wd": (d_ff, d)}], "ln_f", "head":
(d, vocab)}`` — dense weights (in, out), used as ``x @ w``.

Attention here keeps the JAX formulation exactly: f32 einsums
("bqhd,bkhd->bhqk" / "bhqk,bkhd->bqhd"), an additive −1e30 mask and a
softmax in f32, so masked positions contribute exactly 0.0. That is what
lets the paged serving engine (llm/) equal `generate` token for token.
`apply_seq_kv` is the serving engine's prefill path; `apply_seq` is the
full-sequence forward, its attention the flash kernel
(``attn="pallas"``), the reference softmax (``attn="xla"``) or, with a
mesh, ring attention over its devices. Its W8A8 twin is
`models/quant.apply_seq_w8a8`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.models import layers as L
from nnstreamer_tpu_torch.models.zoo import register_model

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * w


def rope_freqs(d: int, device=None) -> torch.Tensor:
    """Rotary frequencies 1 / 10000^(i/half), f32, as the JAX formula."""
    half = d // 2
    return 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                           device=device) / half))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D); pos: (S,) absolute positions."""
    ang = pos.float()[:, None] * rope_freqs(x.shape[-1], x.device)[None, :]
    return _rotate(x, torch.cos(ang)[None, :, None, :],
                   torch.sin(ang)[None, :, None, :])


def init_params(*, d_model: int = 64, n_heads: int = 4, n_layers: int = 2,
                d_ff: Optional[int] = None, vocab: int = 256,
                n_kv_heads: Optional[int] = None,
                seed: int = 0) -> Dict[str, Any]:
    """Random f32 params from a seeded torch.Generator (xavier uniform
    dense weights, unit norms). ``n_kv_heads < n_heads`` = grouped-query
    attention. `jax.random` cannot be reproduced here: parity runs load
    the JAX package's params through models/bridge.py."""
    gen = torch.Generator().manual_seed(seed)
    d_ff = d_ff or 4 * d_model
    n_kv = n_kv_heads or n_heads
    if n_heads % n_kv:
        raise ValueError(f"n_heads={n_heads} not divisible by "
                         f"n_kv_heads={n_kv}")
    kv_dim = (d_model // n_heads) * n_kv
    blocks = []
    for _ in range(n_layers):
        blocks.append({
            "ln1": torch.ones(d_model),
            "wqkv": L.xavier_uniform((d_model, d_model + 2 * kv_dim), gen),
            "wo": L.xavier_uniform((d_model, d_model), gen),
            "ln2": torch.ones(d_model),
            "wi": L.xavier_uniform((d_model, 2 * d_ff), gen),  # gate+up
            "wd": L.xavier_uniform((d_ff, d_model), gen),
        })
    return {
        "embed": L.xavier_uniform((vocab, d_model), gen),
        "blocks": blocks,
        "ln_f": torch.ones(d_model),
        "head": L.xavier_uniform((d_model, vocab), gen),
    }


def _mlp(blk, x, dtype):
    gate, up = (x @ blk["wi"].to(dtype)).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ blk["wd"].to(dtype)


def _qkv(blk, x, n_heads, dtype):
    """Project to q (n_heads) and k/v (n_kv heads, read off the weight
    shape)."""
    b, s, d = x.shape
    hd = d // n_heads
    kv_dim = (blk["wqkv"].shape[1] - d) // 2
    n_kv = kv_dim // hd
    qkv = x @ blk["wqkv"].to(dtype)
    q = qkv[..., :d].reshape(b, s, n_heads, hd)
    k = qkv[..., d:d + kv_dim].reshape(b, s, n_kv, hd)
    v = qkv[..., d + kv_dim:].reshape(b, s, n_kv, hd)
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, n_kv, D) → (B, S, n_heads, D) by group repetition (head h
    reads kv head h // group)."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // n_kv, dim=2)


def attend(q, kc, vc, mask, n_heads: int, dtype):
    """The shared cached-attention formulation: f32 einsums, −1e30 mask,
    f32 softmax. q (B, Sq, H, D); kc/vc (B, Sk, n_kv, D); mask
    broadcastable to (B, H, Sq, Sk) → (B, Sq, H, D) in `dtype`."""
    hd = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _expand_kv(kc, n_heads).float()) * hd ** -0.5
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        _expand_kv(vc, n_heads).float()).to(dtype)


def apply_seq(params, ids: torch.Tensor, *, n_heads: int = 4,
              dtype: torch.dtype = torch.float32, mesh=None,
              sp_axis: str = "sp", attn: str = "auto"):
    """Full-sequence forward: (B, S) int → (B, S, vocab) f32 logits.

    With a `mesh` (parallel.mesh.Mesh), attention runs as ring attention
    over its `sp_axis` devices (the sequence split across them, K/V
    rotating; `parallel.ring_attention`, block_impl "auto"); everything
    else runs on the params' device. Without, `attn` picks the attention:
    "pallas" = the flash-attention kernel
    (`backends.kernels.flash_attention`, which raises on an S its blocks
    do not divide), "xla" = the reference softmax
    (`parallel.ring_attention.reference_attention`), "auto" = pallas when
    S % 128 == 0, else xla."""
    from nnstreamer_tpu_torch.backends.kernels import flash_attention
    from nnstreamer_tpu_torch.parallel.ring_attention import (
        reference_attention, ring_attention)

    b, s = ids.shape
    x = params["embed"][ids].to(dtype)
    pos = torch.arange(s, device=ids.device)
    use_pallas = attn == "pallas" or (attn == "auto" and s % 128 == 0)
    for blk in params["blocks"]:
        h = rmsnorm(x, blk["ln1"].to(dtype))
        q, k, v = _qkv(blk, h, n_heads, dtype)
        q, k = rope(q, pos), rope(k, pos)
        k, v = _expand_kv(k, n_heads), _expand_kv(v, n_heads)
        if mesh is not None:
            out = ring_attention(q, k, v, mesh=mesh, axis=sp_axis,
                                 causal=True)
        elif use_pallas:
            out = flash_attention(q, k, v, causal=True)
        else:
            out = reference_attention(q, k, v, causal=True)
        x = x + out.reshape(b, s, -1) @ blk["wo"].to(dtype)
        h = rmsnorm(x, blk["ln2"].to(dtype))
        x = x + _mlp(blk, h, dtype)
    x = rmsnorm(x, params["ln_f"].to(dtype))
    return (x @ params["head"].to(dtype)).float()


def apply_seq_kv(params, ids: torch.Tensor, *, n_heads: int = 4,
                 dtype: torch.dtype = torch.float32):
    """Full-sequence forward that also returns every layer's rope'd K/V:
    (B, S) int → (logits (B, S, vocab) f32, k (L, B, S, n_kv, D),
    v (L, B, S, n_kv, D)). The prefill path of the serving engine, with
    `_step_impl`'s attention formulation."""
    b, s = ids.shape
    x = params["embed"][ids].to(dtype)
    pos = torch.arange(s, device=ids.device)
    causal = (pos[None, :] <= pos[:, None])[None, None]     # (1,1,Sq,Sk)
    ks, vs = [], []
    for blk in params["blocks"]:
        h = rmsnorm(x, blk["ln1"].to(dtype))
        q, k, v = _qkv(blk, h, n_heads, dtype)
        q, k = rope(q, pos), rope(k, pos)
        ks.append(k)
        vs.append(v)
        attn = attend(q, k, v, causal, n_heads, dtype)
        x = x + attn.reshape(b, s, -1) @ blk["wo"].to(dtype)
        h = rmsnorm(x, blk["ln2"].to(dtype))
        x = x + _mlp(blk, h, dtype)
    x = rmsnorm(x, params["ln_f"].to(dtype))
    logits = (x @ params["head"].to(dtype)).float()
    return logits, torch.stack(ks), torch.stack(vs)


def init_cache(*, batch: int = 1, max_len: int = 128, d_model: int = 64,
               n_heads: int = 4, n_layers: int = 2,
               n_kv_heads: Optional[int] = None, device=None):
    """Dense f32 KV ring: k/v (L, B, max_len, n_kv, D) and pos, a (1,)
    int32 tensor."""
    hd = d_model // n_heads
    n_kv = n_kv_heads or n_heads
    shape = (n_layers, batch, max_len, n_kv, hd)
    return (torch.zeros(shape, device=device),
            torch.zeros(shape, device=device),
            torch.zeros((1,), dtype=torch.int32, device=device))


def _step_impl(params, ids, k_cache, v_cache, pos, n_heads, dtype, proj):
    """One decode step over the dense ring. `proj(store, name, x)` is the
    one projection matmul (dense ``x @ w`` here). The ring slot is
    written in place: the returned caches are the ones passed in."""
    b = ids.shape[0]
    max_len = k_cache.shape[2]
    p = int(pos[0])
    slot = p % max_len
    x = params["embed"][ids[:, 0]][:, None, :].to(dtype)      # (B,1,D)
    pvec = torch.tensor([p], device=ids.device)
    mask = (torch.arange(max_len, device=ids.device)
            <= min(p, max_len - 1))[None, None, None, :]
    for li, blk in enumerate(params["blocks"]):
        h = rmsnorm(x, blk["ln1"].to(dtype))
        d = x.shape[-1]
        hd = d // n_heads
        qkv = proj(blk, "wqkv", h)
        kv_dim = (qkv.shape[-1] - d) // 2
        n_kv = kv_dim // hd
        q = qkv[..., :d].reshape(b, 1, n_heads, hd)
        k = qkv[..., d:d + kv_dim].reshape(b, 1, n_kv, hd)
        v = qkv[..., d + kv_dim:].reshape(b, 1, n_kv, hd)
        q, k = rope(q, pvec), rope(k, pvec)
        k_cache[li, :, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[li, :, slot] = v[:, 0].to(v_cache.dtype)
        attn = attend(q, k_cache[li], v_cache[li], mask, n_heads, dtype)
        x = x + proj(blk, "wo", attn.reshape(b, 1, -1))
        h = rmsnorm(x, blk["ln2"].to(dtype))
        gate, up = proj(blk, "wi", h).chunk(2, dim=-1)
        x = x + proj(blk, "wd", F.silu(gate) * up)
    x = rmsnorm(x, params["ln_f"].to(dtype))
    logits = proj(params, "head", x[:, 0]).float()
    return logits, k_cache, v_cache, torch.tensor(
        [p + 1], dtype=torch.int32, device=pos.device)


def apply_step(params, ids, k_cache, v_cache, pos, *, n_heads: int = 4,
               dtype: torch.dtype = torch.float32):
    """One streaming decode step: ids (B, 1) + cache → (logits (B, vocab)
    f32, k_cache, v_cache, pos + 1). A true ring: past max_len the
    window slides."""
    def proj(store, name, x):
        return x @ store[name].to(dtype)

    return _step_impl(params, ids, k_cache, v_cache, pos, n_heads, dtype,
                      proj)


@torch.inference_mode()
def generate(params, prompt_ids, n_tokens: int, *, n_heads: int = 4,
             max_len: int = 128, temperature: float = 0.0, top_k: int = 0,
             seed: int = 0, dtype: torch.dtype = torch.float32):
    """Autoregressive sampling: prompt (B, P) int → (B, P + n_tokens)
    int32 on the params' device. temperature 0 is greedy argmax (first
    maximum, as the JAX package's); otherwise softmax sampling from a
    seeded torch.Generator, optionally top-k truncated (its draws differ
    from jax.random's)."""
    dev = params["embed"].device
    prompt_ids = torch.as_tensor(prompt_ids, dtype=torch.int64, device=dev)
    d_model = params["embed"].shape[1]
    hd = d_model // n_heads
    n_kv = (params["blocks"][0]["wqkv"].shape[1] - d_model) // 2 // hd
    b, plen = prompt_ids.shape
    if plen == 0:
        raise ValueError("generate() needs a non-empty prompt (the model "
                         "has no BOS convention to start from)")
    top_k = min(top_k, params["head"].shape[1])
    kc, vc, pos = init_cache(batch=b, max_len=max_len, d_model=d_model,
                             n_heads=n_heads, n_layers=len(params["blocks"]),
                             n_kv_heads=n_kv, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for t in range(plen - 1):
        _, kc, vc, pos = apply_step(params, prompt_ids[:, t:t + 1], kc, vc,
                                    pos, n_heads=n_heads, dtype=dtype)
    cur = prompt_ids[:, plen - 1]
    out = [prompt_ids]
    for _ in range(n_tokens):
        logits, kc, vc, pos = apply_step(params, cur[:, None], kc, vc, pos,
                                         n_heads=n_heads, dtype=dtype)
        if temperature <= 0:
            cur = torch.argmax(logits, dim=-1)
        else:
            lg = logits / temperature
            if top_k > 0:
                kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
                lg = torch.where(lg < kth, torch.full_like(lg, NEG_INF), lg)
            cur = torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                    generator=gen)[:, 0]
        out.append(cur[:, None])
    return torch.cat(out, dim=1).to(torch.int32)


@register_model("transformer")
def build(d_model: int = 64, n_heads: int = 4, n_layers: int = 2,
          vocab: int = 256, max_len: int = 128, batch: int = 1,
          n_kv_heads: int = 0, dtype: str = "float32", seed: int = 0):
    """Streaming-decode bundle: (ids, k_cache, v_cache, pos) → (logits,
    k_cache, v_cache, pos). tensor_llm reads only its params."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    cdtype = DType.from_name(dtype).torch_dtype
    n_kv = n_kv_heads or n_heads
    params = init_params(d_model=d_model, n_heads=n_heads,
                         n_layers=n_layers, vocab=vocab, n_kv_heads=n_kv,
                         seed=seed)
    cshape = (n_layers, batch, max_len, n_kv, d_model // n_heads)

    def fn(params, ids, k_cache, v_cache, pos):
        return apply_step(params, ids, k_cache, v_cache, pos,
                          n_heads=n_heads, dtype=cdtype)

    in_spec = TensorsSpec.of(
        TensorInfo((batch, 1), DType.INT32, name="ids"),
        TensorInfo(cshape, DType.FLOAT32, name="k_cache"),
        TensorInfo(cshape, DType.FLOAT32, name="v_cache"),
        TensorInfo((1,), DType.INT32, name="pos"),
    )
    out_spec = TensorsSpec.of(
        TensorInfo((batch, vocab), DType.FLOAT32, name="logits"),
        TensorInfo(cshape, DType.FLOAT32, name="k_cache"),
        TensorInfo(cshape, DType.FLOAT32, name="v_cache"),
        TensorInfo((1,), DType.INT32, name="pos"),
    )
    return ModelBundle(fn=fn, params=params, in_spec=in_spec,
                       out_spec=out_spec, name="transformer")

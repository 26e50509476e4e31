"""Paged prefill / decode-step math — the torch reference of the serving
engine (counterpart of the JAX package's llm/paged_model.py, its "xla"
path).

Parity contract: at temperature 0 the paged engine's tokens equal
`transformer.generate`'s token for token. The functions here mirror
`transformer._step_impl`'s cached attention exactly — the same f32
einsum pair, the same −1e30 additive mask, softmax in f32 — over a KV
axis *gathered* through block tables. Masked slots (padding, unwritten
or stale) get exactly 0.0 weight, and 0.0 times any finite stale value
is 0.0, so gathering ``max_blocks * block_size`` slots changes no bit of
the surviving terms.

The layer stack is written once (`decode_layers`, `chunk_layers`) and
takes its attention as an argument: the reference functions below pass
the gathered einsum, the kernel twins in backends/paged_attn.py pass the
CUDA kernels, so the two paths can differ only in attention.

Pool writes happen in place (``index_put_`` on the pool tensors), and
each function returns the pools it was given, so call sites keep the
JAX functions' shape. Duplicate scatter targets are harmless: only
padding rows write the scratch block, and no live row's mask reaches it.

Shapes:
- k/v pool: (L, num_blocks, block_size, n_kv, hd) — PagedKVCache
- prefill: ids (1, S_b) padded prompt; per-position (block, offset)
  scatter targets (padding → the scratch block)
- decode: one token per row; block tables (B_b, max_blocks) and
  positions (B_b,) (padding rows → scratch)
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.models.transformer import (
    _rotate, apply_seq_kv, attend, rmsnorm, rope, rope_freqs)

#: attention(q, layer) → (B, S, n_heads, hd) in the activation dtype;
#: q (B, S, n_heads, hd) is rope'd and the layer's pools hold this
#: call's K/V writes
Attention = Callable[[torch.Tensor, int], torch.Tensor]


def _proj(store, name, x, dtype):
    """One projection matmul, quant-aware: a store version whose params
    carry ``<name>_scale`` (models/quant.quantize_transformer) goes
    through the W8A8 path (`quantize_rows` + int8 product + rescale);
    float params keep ``x @ w``, so the float parity is untouched."""
    if f"{name}_scale" in store:
        from nnstreamer_tpu_torch.models.quant import w8a8_matmul

        return w8a8_matmul(x, store[name], store[f"{name}_scale"]).to(dtype)
    return x @ store[name].to(dtype)


def _mlp_paged(blk, x, dtype):
    """SwiGLU MLP through `_proj` (the twin of `transformer._mlp`)."""
    gate, up = _proj(blk, "wi", x, dtype).chunk(2, dim=-1)
    return _proj(blk, "wd", F.silu(gate) * up, dtype)


def _rope_rows(x, pos):
    """Rotary embedding with a PER-ROW position: x (B, 1, H, D), pos
    (B,). Row b equals rope(x[b:b+1], pos[b:b+1])."""
    ang = pos.float()[:, None] * rope_freqs(x.shape[-1], x.device)[None, :]
    return _rotate(x, torch.cos(ang)[:, None, None, :],
                   torch.sin(ang)[:, None, None, :])


def _split_qkv(blk, h, n_heads, dtype):
    b, s, d = h.shape
    hd = d // n_heads
    qkv = _proj(blk, "wqkv", h, dtype)
    kv_dim = (qkv.shape[-1] - d) // 2
    n_kv = kv_dim // hd
    return (qkv[..., :d].reshape(b, s, n_heads, hd),
            qkv[..., d:d + kv_dim].reshape(b, s, n_kv, hd),
            qkv[..., d + kv_dim:].reshape(b, s, n_kv, hd))


def _block_tail(blk, x, attn, dtype):
    """Attention output projection, residual, MLP, residual."""
    b, s = attn.shape[:2]
    x = x + _proj(blk, "wo", attn.reshape(b, s, -1), dtype)
    h = rmsnorm(x, blk["ln2"].to(dtype))
    return x + _mlp_paged(blk, h, dtype)


def paged_prefill(params, ids, blk_idx, blk_off, k_pool, v_pool, last_idx,
                  *, n_heads=4, dtype=torch.float32):
    """Bucketed prompt prefill: full-sequence forward + KV scatter.

    ids (1, S_b) — the prompt padded to its pow2 bucket; blk_idx/blk_off
    (S_b,) — per-position pool write targets (padding → scratch);
    last_idx — index of the final real prompt token. Returns
    (last-token logits (vocab,), k_pool, v_pool)."""
    logits, ks, vs = apply_seq_kv(params, ids, n_heads=n_heads, dtype=dtype)
    k_pool[:, blk_idx, blk_off] = ks[:, 0].to(k_pool.dtype)
    v_pool[:, blk_idx, blk_off] = vs[:, 0].to(v_pool.dtype)
    return logits[0, last_idx], k_pool, v_pool


def decode_layers(params, cur, tables, pos, k_pool, v_pool,
                  attention: Attention, *, n_heads, dtype):
    """The decode step's layer stack with `attention` plugged in.
    Returns logits (B, vocab) f32; the pools are written in place."""
    b = cur.shape[0]
    block_size = k_pool.shape[2]
    write_blk = tables[torch.arange(b, device=tables.device),
                       pos // block_size]
    write_off = pos % block_size
    x = params["embed"][cur][:, None, :].to(dtype)          # (B,1,D)
    for li, blk in enumerate(params["blocks"]):
        h = rmsnorm(x, blk["ln1"].to(dtype))
        q, k, v = _split_qkv(blk, h, n_heads, dtype)
        q, k = _rope_rows(q, pos), _rope_rows(k, pos)
        k_pool[li, write_blk, write_off] = k[:, 0].to(k_pool.dtype)
        v_pool[li, write_blk, write_off] = v[:, 0].to(v_pool.dtype)
        x = _block_tail(blk, x, attention(q, li), dtype)
    x = rmsnorm(x, params["ln_f"].to(dtype))
    return _proj(params, "head", x[:, 0], dtype).float()


def chunk_layers(params, ids, pos0: int, blk_idx, blk_off, k_pool, v_pool,
                 last_idx, attention: Attention, *, n_heads, dtype):
    """One prompt chunk's layer stack with `attention` plugged in.
    Returns the last real token's logits (vocab,) f32."""
    c = ids.shape[1]
    pos = pos0 + torch.arange(c, device=ids.device)
    x = params["embed"][ids].to(dtype)                      # (1,C,D)
    for li, blk in enumerate(params["blocks"]):
        h = rmsnorm(x, blk["ln1"].to(dtype))
        q, k, v = _split_qkv(blk, h, n_heads, dtype)
        q, k = rope(q, pos), rope(k, pos)
        k_pool[li, blk_idx, blk_off] = k[0].to(k_pool.dtype)
        v_pool[li, blk_idx, blk_off] = v[0].to(v_pool.dtype)
        x = _block_tail(blk, x, attention(q, li), dtype)
    x = rmsnorm(x, params["ln_f"].to(dtype))
    return _proj(params, "head", x[0, last_idx][None, :], dtype).float()[0]


def _gather(pool_l, table, rows: int):
    """One layer's pool blocks through `table` → (rows, kv_len, n_kv,
    hd)."""
    g = pool_l[table]
    return g.reshape(rows, -1, *g.shape[-2:])


def paged_decode_step(params, cur, tables, pos, k_pool, v_pool,
                      *, n_heads=4, dtype=torch.float32):
    """One decode step for a bucketed batch over the paged pool.

    cur (B_b,) current tokens; tables (B_b, max_blocks) block tables;
    pos (B_b,) write positions. Returns (logits (B_b, vocab) f32,
    k_pool, v_pool). Mirrors `transformer._step_impl` with the cache
    gathered through the tables, per-row positions and no ring wrap."""
    b = cur.shape[0]
    kv_len = tables.shape[1] * k_pool.shape[2]
    # attend over positions <= pos[b] (the inclusive window of
    # _step_impl's `arange(max_len) <= p`)
    mask = (torch.arange(kv_len, device=pos.device)[None, None, None, :]
            <= pos[:, None, None, None])

    def attention(q, li):
        return attend(q, _gather(k_pool[li], tables, b),
                      _gather(v_pool[li], tables, b), mask, n_heads, dtype)

    logits = decode_layers(params, cur, tables, pos, k_pool, v_pool,
                           attention, n_heads=n_heads, dtype=dtype)
    return logits, k_pool, v_pool


def paged_prefill_chunk(params, ids, pos0: int, blk_idx, blk_off, table,
                        k_pool, v_pool, last_idx,
                        *, n_heads=4, dtype=torch.float32):
    """One prompt chunk for a single sequence — the torch reference for
    chunked prefill.

    ids (1, C_b) — the chunk padded to its bucket; pos0 — absolute
    position of its first token; blk_idx/blk_off (C_b,) — pool write
    targets (padding → scratch); table (max_blocks,) — the sequence's
    block table, through which attention reads everything written so
    far, this chunk's own writes included; last_idx — the final real
    token. Query p attends slots holding positions <= p, so chunked ==
    unchunked up to float reassociation. Padding rows compute, write the
    scratch block, and their logits are never read.

    Returns (last-token logits (vocab,) f32, k_pool, v_pool)."""
    c = ids.shape[1]
    kv_len = table.shape[0] * k_pool.shape[2]
    pos = pos0 + torch.arange(c, device=ids.device)
    mask = (torch.arange(kv_len, device=ids.device)[None, None, None, :]
            <= pos[None, None, :, None])

    def attention(q, li):
        return attend(q, _gather(k_pool[li], table, 1),
                      _gather(v_pool[li], table, 1), mask, n_heads, dtype)

    logits = chunk_layers(params, ids, pos0, blk_idx, blk_off, k_pool,
                          v_pool, last_idx, attention, n_heads=n_heads,
                          dtype=dtype)
    return logits, k_pool, v_pool

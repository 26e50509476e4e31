"""Attention references (counterpart of the JAX package's
parallel/ring_attention.py).

Only `reference_attention` is ported: the single-card ground truth, and
the ``attn="xla"`` arm of `transformer.apply_seq`. The ring itself —
the sequence sharded over cards, K/V blocks rotating between them, and
its `flash_block_update` kernel — waits for the multi-GPU slice.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False) -> torch.Tensor:
    """(B, S, H, D) attention with the whole row's softmax: scores in f32
    (inputs widened, as JAX's f32-preferred einsum), −1e30 above the
    diagonal when causal, p cast to v's dtype before the product with v,
    the result in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)

"""A Mistral-layout decoder (arXiv:2310.06825; `mistralai/Mistral-7B-v0.1`
config.json) in plain PyTorch, float32: pre-RMSNorm, rotary position
embeddings (rotate-half form, theta from the configuration), grouped-
query causal attention (head h reads kv head h // (heads / kv_heads)),
SwiGLU MLP, final RMSNorm and an untied head.

Departures, stated in the configuration file: RMSNorm's eps is the
configuration's ``served_rms_norm_eps`` (1e-6, what the served program
fixes; published 1e-5), and attention is full causal, which equals the
published 4,096-token sliding window for every sequence of at most 4,096
positions.

Parameters are a dict of tensors: ``embed`` (vocab, d), ``blocks`` a
list of {``ln1``, ``wqkv`` (d, q + 2·kv), ``wo`` (q, d), ``ln2``, ``wi``
(d, 2·ff) with the gate in the first half, ``wd`` (ff, d)}, ``ln_f``,
``head`` (d, vocab); products are ``x @ w``. The weights may be held in
bfloat16: each layer is upcast to float32 when it is reached, so the
reference fits beside what is already on the card.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from benchmark.cost.transformer import dims
from benchmark.reference.precision import operand

#: query heads per attention pass (bounds the (heads, S, S) scores)
HEAD_GROUP = 8


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) at positions 0..S-1, rotate-half form."""
    s, _, hd = x.shape
    half = hd // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    return operand(x, (-1,), precision) @ operand(w, (0,), precision)


def _attention(q, k, v, precision: str) -> torch.Tensor:
    """Causal attention: q (S, H, hd), k/v (S, kv, hd) → (S, H·hd)."""
    s, h, hd = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    out = torch.empty(s, h, hd, device=q.device)
    for h0 in range(0, h, HEAD_GROUP):
        sl = slice(h0, h0 + HEAD_GROUP)
        qh = operand(q[:, sl].transpose(0, 1), (-1,), precision)
        kh = operand(k[:, sl].transpose(0, 1), (-1,), precision)
        vh = operand(v[:, sl].transpose(0, 1), (-2,), precision)
        sc = qh @ kh.transpose(1, 2) * hd ** -0.5
        sc = sc.masked_fill(~causal, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out[:, sl] = (operand(p, (-1,), precision) @ vh).transpose(0, 1)
    return out.reshape(s, h * hd)


def _layer(blk: dict, x: torch.Tensor, cfg: dict, precision: str):
    m = dims(cfg)
    eps = float(cfg["served_rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    qd, kvd = m["h"] * m["hd"], m["kv"] * m["hd"]
    h = rmsnorm(x, blk["ln1"], eps)
    qkv = _mm(h, blk["wqkv"], precision)
    s = x.shape[0]
    q = rope(qkv[:, :qd].reshape(s, m["h"], m["hd"]), theta)
    k = rope(qkv[:, qd:qd + kvd].reshape(s, m["kv"], m["hd"]), theta)
    v = qkv[:, qd + kvd:].reshape(s, m["kv"], m["hd"])
    x = x + _mm(_attention(q, k, v, precision), blk["wo"], precision)
    h = rmsnorm(x, blk["ln2"], eps)
    gate, up = _mm(h, blk["wi"], precision).chunk(2, dim=-1)
    return x + _mm(F.silu(gate) * up, blk["wd"], precision)


@torch.no_grad()
def logits_at(params: dict, seqs: Sequence[torch.Tensor],
              rows: Sequence[torch.Tensor], cfg: dict,
              precisions: Sequence[str] = ("f32",)
              ) -> List[List[torch.Tensor]]:
    """Full forward of each token sequence in `seqs` (1-D int tensors on
    the weights' device) → for each precision, for each sequence, the
    float32 logits (len(rows[i]), vocab) at the positions `rows[i]`.
    One pass over the layers serves every sequence and precision: each
    layer's weights are upcast to float32 once."""
    def f32(t):
        return t.to(torch.float32)

    emb = params["embed"]
    states = {p: [f32(emb[s.long()]) for s in seqs] for p in precisions}
    for blk in params["blocks"]:
        b32 = {k: f32(v) for k, v in blk.items()}
        for p in precisions:
            states[p] = [_layer(b32, x, cfg, p) for x in states[p]]
        del b32
    eps = float(cfg["served_rms_norm_eps"])
    ln_f, head = f32(params["ln_f"]), f32(params["head"])
    out = {}
    for p in precisions:
        out[p] = [_mm(rmsnorm(x[r.long()], ln_f, eps), head, p)
                  for x, r in zip(states[p], rows)]
    return [out[p] for p in precisions]

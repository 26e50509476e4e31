"""Operations and bytes of a dense pre-norm decoder (the Mistral layout:
grouped-query attention, SwiGLU MLP, untied head) and of the port's two
paged attention kernels, from a configuration file's published keys.

Counting rules (the roofline rule of the benchmark):
- a matrix product of (m, k) by (k, n) is 2·m·k·n operations;
- attention of one query row over `ctx` keys is 4·heads·head_dim·ctx
  (QKᵀ and PV), softmax and masking not counted;
- only live rows and live context count, never a bucket's padding;
- bytes are each input read once and each output written once, at the
  configuration's activation width (`act_bytes`, bf16 = 2), K and V at
  that width too whatever the pool holds.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple


def dims(cfg: dict) -> dict:
    d = int(cfg["hidden_size"])
    h = int(cfg["num_attention_heads"])
    hd = int(cfg.get("head_dim") or d // h)
    return {"d": d, "h": h, "hd": hd,
            "kv": int(cfg.get("num_key_value_heads") or h),
            "ff": int(cfg["intermediate_size"]),
            "layers": int(cfg["num_hidden_layers"]),
            "vocab": int(cfg["vocab_size"])}


def layer_matmul_params(cfg: dict) -> int:
    """Weights one token multiplies in one layer: q, k, v, o, gate, up,
    down."""
    m = dims(cfg)
    d, qd, kvd = m["d"], m["h"] * m["hd"], m["kv"] * m["hd"]
    return d * (qd + 2 * kvd) + qd * d + 3 * d * m["ff"]


def params_count(cfg: dict) -> int:
    """Every parameter: layers (with their two norms), embedding, final
    norm and the untied head."""
    m = dims(cfg)
    per_layer = layer_matmul_params(cfg) + 2 * m["d"]
    return (m["layers"] * per_layer + 2 * m["vocab"] * m["d"] + m["d"])


def attn_flops_row(cfg: dict, ctx: int) -> int:
    """One query row of one layer over `ctx` keys."""
    m = dims(cfg)
    return 4 * m["h"] * m["hd"] * int(ctx)


def token_flops(cfg: dict, ctx: int, head: bool = True) -> int:
    """One token through every layer at context `ctx` (itself included),
    and through the head when `head`."""
    m = dims(cfg)
    f = m["layers"] * (2 * layer_matmul_params(cfg)
                       + attn_flops_row(cfg, ctx))
    if head:
        f += 2 * m["d"] * m["vocab"]
    return f


def chunks(plen: int, chunk: int) -> List[Tuple[int, int]]:
    """(pos0, length) of the prefill calls of a `plen`-token prompt:
    one call when `chunk` is 0 or the prompt fits, else `chunk`-token
    pieces."""
    plen = int(plen)
    if chunk <= 0 or plen <= chunk:
        return [(0, plen)]
    return [(p, min(chunk, plen - p)) for p in range(0, plen, chunk)]


def prefill_flops(cfg: dict, pos0: int, c: int) -> int:
    """A prefill call of `c` tokens at positions pos0.. : every token
    through the layers, the head once (only the last token's logits are
    needed)."""
    m = dims(cfg)
    lin = c * m["layers"] * 2 * layer_matmul_params(cfg)
    att = m["layers"] * prefill_attn(cfg, pos0, c)[0]
    return lin + att + 2 * m["d"] * m["vocab"]


def decode_attn(cfg: dict, ctx: int, block_size: int,
                act_bytes: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of the paged decode kernel for ONE row of ONE
    layer attending `ctx` keys: K and V of ctx tokens, q in, out, the
    live table entries and the position."""
    m = dims(cfg)
    ctx = int(ctx)
    kv_bytes = 2 * ctx * m["kv"] * m["hd"] * act_bytes
    qo_bytes = 2 * m["h"] * m["hd"] * act_bytes
    table = 4 * -(-ctx // int(block_size)) + 4
    return attn_flops_row(cfg, ctx), kv_bytes + qo_bytes + table


def prefill_attn(cfg: dict, pos0: int, c: int, block_size: int = 16,
                 act_bytes: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of the paged prefill kernel for one chunk of
    ONE layer: `c` causal query rows at positions pos0..pos0+c-1 over the
    pos0 + c keys written so far."""
    m = dims(cfg)
    pos0, c = int(pos0), int(c)
    keys = c * pos0 + c * (c + 1) // 2
    flops = 4 * m["h"] * m["hd"] * keys
    nbytes = (2 * (pos0 + c) * m["kv"] * m["hd"] * act_bytes
              + 2 * c * m["h"] * m["hd"] * act_bytes
              + 4 * -(-(pos0 + c) // int(block_size)))
    return flops, nbytes


def sum_decode(cfg: dict, ctxs: Iterable[int], block_size: int
               ) -> Tuple[int, int]:
    """Every layer's decode kernel work for the rows at contexts
    `ctxs` (one entry per decoded token)."""
    layers = dims(cfg)["layers"]
    f = b = 0
    for ctx in ctxs:
        df, db = decode_attn(cfg, ctx, block_size)
        f += df
        b += db
    return layers * f, layers * b


def sum_prefill(cfg: dict, calls: Iterable[Tuple[int, int]],
                block_size: int) -> Tuple[int, int]:
    """Every layer's prefill kernel work for the (pos0, c) calls."""
    layers = dims(cfg)["layers"]
    f = b = 0
    for pos0, c in calls:
        pf, pb = prefill_attn(cfg, pos0, c, block_size)
        f += pf
        b += pb
    return layers * f, layers * b

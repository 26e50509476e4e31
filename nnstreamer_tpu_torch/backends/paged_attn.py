"""Paged attention kernels — the counterpart of the JAX package's
backends/pallas_paged.py.

Two hand-written CUDA kernels in ``csrc/paged_attn.cu`` read K/V straight
from the paged pool through block tables, so the gathered cache never
exists in device memory:

- ``paged_decode_attn`` — one decode step of one layer: q (B, n_heads,
  hd) against pool blocks ``tables[b, j]``, mask ``kv_pos <= pos[b]``,
  blocks past ``pos[b]`` skipped; out (B, n_heads, hd) f32. Each row's
  walk is split over the KV axis (`decode_plan`): the splits of a (row,
  kv head) fold their partials in the same launch, through a workspace
  and tickets that the wrapper keeps per device and stream (a CUDA graph
  that captures a launch holds the pair it captured).
- ``paged_prefill_attn`` — causal attention of one prefill chunk of one
  layer: q (n_heads, S_c, hd) starting at absolute ``pos0``, through one
  sequence's table (max_blocks,), mask ``pos0 + row >= kv_pos``; out
  (n_heads, S_c, hd) f32. Its products run on the tensor cores as split
  TF32 (three TF32 products per f32 product), which keeps f32 accuracy.

Each has a wrapper that counts its launches, and a plain torch version
(``*_plain``: gather the table's blocks, −1e30 mask, f32 softmax, product
with V). A CUDA tensor launches the kernel or the call raises; a CPU
tensor — the device the caller chose — takes the plain version. Nothing
falls back. The wrapper launches on the current stream (through a
`cuda_build.Launcher`), so the pool writes queued before it on that
stream land before the kernel reads.

``paged_flash_decode_step`` and ``paged_flash_prefill_chunk`` are the
layer-stack twins of llm/paged_model.py's reference functions: they
share its layer stack and differ only in the attention they plug in.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from nnstreamer_tpu_torch.backends.cuda_build import Launcher, raw_stream
from nnstreamer_tpu_torch.backends.cuda_graphs import count_launch
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.llm.paged_model import chunk_layers, decode_layers
from nnstreamer_tpu_torch.models.transformer import attend

#: q dtypes the kernels take, by the launcher's type code
_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: largest pool block the kernels tile (a tile is up to 64 keys of whole
#: blocks)
MAX_BLOCK_SIZE = 64

#: decode: warps per CTA and most table blocks one split stages (as
#: csrc/paged_attn.cu's kDecWarps and kDecMaxTable), CTAs aimed at per
#: SM (a short row's splits past its position return at once)
DECODE_WARPS, DECODE_MAX_TABLE, DECODE_CTAS_PER_SM = 4, 4096, 8
#: decode: padded query group x 128-dim head chunks a lane's registers hold
DECODE_MAX_GROUP_CHUNKS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_DECODE = Launcher("paged_attn.cu", "nns_paged_decode",
                   [_P, _I, _P, _P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _I,
                    _I, _I, _I, _I, _I, _L, _L, _L, ctypes.c_float],
                   "paged_decode_attn")
_PREFILL = Launcher("paged_attn.cu", "nns_paged_prefill",
                    [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L,
                     _L, _L, ctypes.c_float], "paged_prefill_attn")


# -- plain torch versions -----------------------------------------------------

def paged_decode_attn_plain(q, k_pool_l, v_pool_l, tables, pos):
    """Plain torch version of the decode kernel: gather every table
    block, mask ``kv_pos <= pos[b]`` with −1e30, softmax in f32, product
    with V → (B, n_heads, hd) f32."""
    b, n_heads, _ = q.shape
    kv_len = tables.shape[1] * k_pool_l.shape[1]
    mask = (torch.arange(kv_len, device=q.device)[None, None, None, :]
            <= pos[:, None, None, None])
    kc = k_pool_l[tables].reshape(b, kv_len, *k_pool_l.shape[2:])
    vc = v_pool_l[tables].reshape(b, kv_len, *v_pool_l.shape[2:])
    return attend(q[:, None], kc, vc, mask, n_heads, torch.float32)[:, 0]


def paged_prefill_attn_plain(q, k_pool_l, v_pool_l, table, pos0: int):
    """Plain torch version of the prefill kernel: gather the table's
    blocks, mask ``pos0 + row >= kv_pos`` with −1e30, softmax in f32,
    product with V → (n_heads, S_c, hd) f32."""
    n_heads, s_c, _ = q.shape
    kv_len = table.shape[0] * k_pool_l.shape[1]
    pos = int(pos0) + torch.arange(s_c, device=q.device)
    mask = (torch.arange(kv_len, device=q.device)[None, None, None, :]
            <= pos[None, None, :, None])
    kc = k_pool_l[table].reshape(1, kv_len, *k_pool_l.shape[2:])
    vc = v_pool_l[table].reshape(1, kv_len, *v_pool_l.shape[2:])
    out = attend(q.transpose(0, 1)[None], kc, vc, mask, n_heads,
                 torch.float32)
    return out[0].transpose(0, 1)


# -- CUDA launches -------------------------------------------------------------

def _check_pools(what, q, k_pool_l, v_pool_l, n_heads):
    if q.dtype not in _Q_CODE:
        raise BackendError(
            f"{what} kernel takes float32 or bfloat16 q, got {q.dtype}")
    for name, pool in (("k_pool", k_pool_l), ("v_pool", v_pool_l)):
        if pool.dtype != torch.float32 or pool.device != q.device:
            raise BackendError(
                f"{what} kernel takes a float32 {name} on {q.device}, got "
                f"{pool.dtype} on {pool.device}")
        if pool.dim() != 4 or pool.stride(-1) != 1:
            raise BackendError(
                f"{what} kernel takes one layer's {name} (num_blocks, "
                f"block_size, n_kv, hd) with a contiguous last dim, got "
                f"shape {tuple(pool.shape)} strides {pool.stride()}")
    if k_pool_l.shape != v_pool_l.shape or \
            k_pool_l.stride() != v_pool_l.stride():
        raise BackendError(f"{what}: k and v pools differ in shape or "
                           f"strides")
    bs, n_kv, hd = k_pool_l.shape[1:]
    if q.shape[-1] != hd or n_heads % n_kv:
        raise BackendError(
            f"{what}: q heads {n_heads} x {q.shape[-1]} do not fit the "
            f"pool's {n_kv} kv heads x {hd}")
    # the kernels copy pool rows 16 bytes at a time (cp.async)
    if hd % 4 or bs > MAX_BLOCK_SIZE or k_pool_l.data_ptr() % 16 or \
            v_pool_l.data_ptr() % 16 or any(st % 4 for st in
                                             k_pool_l.stride()[:3]):
        raise BackendError(
            f"{what} kernel needs head_dim a multiple of 4, block_size <= "
            f"{MAX_BLOCK_SIZE} and 16-byte aligned pool rows; got head_dim "
            f"{hd}, block_size {bs}, strides {k_pool_l.stride()}")


class DecodePlan(NamedTuple):
    """How the decode kernel splits a launch: the query group padded to a
    power of two (``gp``), 128-dim head chunks a lane holds (``vpl``),
    keys a warp takes per batch (``kb``), splits per (row, kv head) and
    table blocks per split (``bps``), floats of one split's partial
    (``gp``, ``vpl``, ``kb`` and ``part_floats`` as the kernel's
    DecodeCfg has them)."""
    gp: int
    vpl: int
    kb: int
    splits: int
    bps: int
    part_floats: int


def decode_plan(batch: int, n_heads: int, n_kv: int, hd: int, bs: int,
                mb: int, sms: int) -> DecodePlan:
    """The decode kernel's layout for these shapes on a card of `sms` SMs.
    It never reads ``pos`` (that would synchronise every step): splits
    come from the table width `mb` and ``batch * n_kv`` against
    DECODE_CTAS_PER_SM CTAs an SM, each split at least two batches a warp
    (fewer, longer splits fold faster where a long row walks alone);
    where ``batch * n_kv`` fills that alone, one split (unless the table
    outgrows DECODE_MAX_TABLE blocks)."""
    g = n_heads // n_kv
    gp = 1 << (g - 1).bit_length()
    vpl = -(-hd // 128)
    if hd > 256 or gp * vpl > DECODE_MAX_GROUP_CHUNKS:
        raise BackendError(
            f"paged_decode_attn kernel holds a lane's share of q and acc "
            f"for the query group in registers: head_dim <= 256 and "
            f"next_pow2(n_heads / n_kv) * ceil(head_dim / 128) <= "
            f"{DECODE_MAX_GROUP_CHUNKS}; got {n_heads} heads on {n_kv} kv "
            f"heads, head_dim {hd}")
    kb = 8 if vpl == 1 and gp <= 2 else 4
    splits = max(1, -(-DECODE_CTAS_PER_SM * sms // (batch * n_kv)))
    bps = max(-(-mb // splits), -(-2 * DECODE_WARPS * kb // bs))
    bps = min(bps, DECODE_MAX_TABLE)
    return DecodePlan(gp, vpl, kb, -(-mb // bps), bps,
                      gp * 128 * vpl + -(-2 * gp // 4) * 4)


#: (device index, batch, n_heads, n_kv, hd, bs, mb) → DecodePlan
_plans: Dict[tuple, DecodePlan] = {}
#: (device index, stream) → (workspace f32, tickets int32): the tickets are
#: zeroed once here and left 0 by every launch; a stream never shares them
_workspaces: Dict[Tuple[int, int], tuple] = {}


def _decode_plan_on(index: int, *shape) -> DecodePlan:
    key = (index, *shape)
    plan = _plans.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        plan = _plans[key] = decode_plan(*shape, sms)
    return plan


def _decode_workspace(device, stream: int, floats: int, tickets: int):
    key = (device.index, stream)
    ws, tk = _workspaces.get(key, (None, None))
    if ws is not None and ws.numel() >= floats and tk.numel() >= tickets:
        return ws, tk
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
    if tk is None or tk.numel() < tickets:
        tk = torch.zeros(max(tickets, 1), dtype=torch.int32, device=device)
    _workspaces[key] = (ws, tk)
    return ws, tk


def _int32_on(what, t, device, ndim):
    if t.dtype != torch.int32 or t.device != device or t.dim() != ndim:
        raise BackendError(
            f"{what} takes int32 {ndim}-D block tables/positions on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _paged_decode_cuda(q, k_pool_l, v_pool_l, tables, pos):
    b, n_heads, hd = q.shape
    _check_pools("paged_decode_attn", q, k_pool_l, v_pool_l, n_heads)
    tables = _int32_on("paged_decode_attn", tables, q.device, 2)
    pos = _int32_on("paged_decode_attn", pos, q.device, 1)
    if tables.shape[0] != b or pos.shape[0] != b:
        raise BackendError(
            f"paged_decode_attn: {b} q rows but tables {tuple(tables.shape)}"
            f" and pos {tuple(pos.shape)}")
    q = q.contiguous()
    if q.data_ptr() % 16:          # the kernel reads q 16 (f32) or 8 bytes
        q = q.clone()
    out = torch.empty((b, n_heads, hd), dtype=torch.float32, device=q.device)
    _, bs, n_kv, _ = k_pool_l.shape
    sb, ss, sh, _ = k_pool_l.stride()
    mb = tables.shape[1]
    index = q.device.index
    plan = _decode_plan_on(index, b, n_heads, n_kv, hd, bs, mb)
    stream = raw_stream(index)
    floats = b * n_kv * plan.splits * plan.part_floats
    ws, tk = _decode_workspace(q.device, stream, floats, b * n_kv)
    _DECODE(index, q.data_ptr(), _Q_CODE[q.dtype], k_pool_l.data_ptr(),
            v_pool_l.data_ptr(), tables.data_ptr(), pos.data_ptr(),
            out.data_ptr(), ws.data_ptr(), ws.numel(), tk.data_ptr(),
            tk.numel(), b, n_heads, n_kv, hd, bs, mb, plan.splits, plan.bps,
            sb, ss, sh, hd ** -0.5, stream=stream)
    # a graph capturing this launch holds the workspace and tickets it
    # bakes in, so replacing them here never frees what it replays into
    count_launch(paged_decode_attn, keep=(ws, tk))
    return out


def _paged_prefill_cuda(q, k_pool_l, v_pool_l, table, pos0):
    n_heads, s_c, hd = q.shape
    _check_pools("paged_prefill_attn", q, k_pool_l, v_pool_l, n_heads)
    table = _int32_on("paged_prefill_attn", table, q.device, 1)
    q = q.contiguous()
    out = torch.empty((n_heads, s_c, hd), dtype=torch.float32,
                      device=q.device)
    _, bs, n_kv, _ = k_pool_l.shape
    sb, ss, sh, _ = k_pool_l.stride()
    _PREFILL(q.device.index, q.data_ptr(), _Q_CODE[q.dtype],
             k_pool_l.data_ptr(), v_pool_l.data_ptr(), table.data_ptr(),
             out.data_ptr(), n_heads, n_kv, s_c, hd, bs, table.shape[0],
             int(pos0), sb, ss, sh, hd ** -0.5)
    count_launch(paged_prefill_attn)
    return out


# -- wrappers -----------------------------------------------------------------

def _plain_device(what, q):
    if q.device.type != "cpu":
        raise BackendError(f"{what} runs on cuda or cpu tensors, got "
                           f"{q.device}")


def paged_decode_attn(q, k_pool_l, v_pool_l, tables, pos):
    """Paged attention for one decode step of one layer.

    q (B, n_heads, hd) f32/bf16 — the step's rope'd queries; k/v_pool_l
    (num_blocks, block_size, n_kv, hd) f32 — ONE layer's pool, already
    holding this step's writes; tables (B, max_blocks) int32; pos (B,)
    int32. Returns (B, n_heads, hd) f32. A CUDA tensor runs the
    hand-written kernel; a CPU tensor runs the plain version."""
    if q.is_cuda:
        return _paged_decode_cuda(q, k_pool_l, v_pool_l, tables, pos)
    _plain_device("paged_decode_attn", q)
    return paged_decode_attn_plain(q, k_pool_l, v_pool_l, tables, pos)


def paged_prefill_attn(q, k_pool_l, v_pool_l, table, pos0: int):
    """Causal paged attention for one prefill chunk of one layer.

    q (n_heads, S_c, hd) f32/bf16 — the chunk's rope'd queries (S_c the
    padded chunk bucket); k/v_pool_l one layer's pool with the chunk's
    K/V already written; table (max_blocks,) int32; pos0 the chunk's
    absolute start. Returns (n_heads, S_c, hd) f32. A CUDA tensor runs
    the hand-written kernel; a CPU tensor runs the plain version."""
    if q.is_cuda:
        return _paged_prefill_cuda(q, k_pool_l, v_pool_l, table, pos0)
    _plain_device("paged_prefill_attn", q)
    return paged_prefill_attn_plain(q, k_pool_l, v_pool_l, table, pos0)


#: kernel launches made by this process (each wrapper counts its own)
paged_decode_attn.launches = 0
paged_prefill_attn.launches = 0


# -- layer-stack twins --------------------------------------------------------

def paged_flash_decode_step(params, cur, tables, pos, k_pool, v_pool,
                            *, n_heads=4, dtype=torch.float32):
    """Twin of `paged_model.paged_decode_step` with the attention from
    `paged_decode_attn` (one launch per layer)."""
    def attention(q, li):
        return paged_decode_attn(q[:, 0], k_pool[li], v_pool[li], tables,
                                 pos)[:, None].to(dtype)

    logits = decode_layers(params, cur, tables, pos, k_pool, v_pool,
                           attention, n_heads=n_heads, dtype=dtype)
    return logits, k_pool, v_pool


def paged_flash_prefill_chunk(params, ids, pos0: int, blk_idx, blk_off,
                              table, k_pool, v_pool, last_idx,
                              *, n_heads=4, dtype=torch.float32):
    """Twin of `paged_model.paged_prefill_chunk` with the attention from
    `paged_prefill_attn` (one launch per layer)."""
    def attention(q, li):
        out = paged_prefill_attn(q[0].transpose(0, 1), k_pool[li],
                                 v_pool[li], table, pos0)
        return out.transpose(0, 1)[None].to(dtype)

    logits = chunk_layers(params, ids, pos0, blk_idx, blk_off, k_pool,
                          v_pool, last_idx, attention, n_heads=n_heads,
                          dtype=dtype)
    return logits, k_pool, v_pool

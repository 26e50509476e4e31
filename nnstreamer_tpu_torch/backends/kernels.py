"""Hand-written kernels for streaming hot ops (counterpart of the JAX
package's backends/pallas_ops.py).

- ``normalize_u8`` — a frame of any stream dtype → ``(x - mean) *
  (1/std)`` in f32, bf16, f16 or f64; the converter+transform ingest path
  in one pass. CUDA C++ in ``csrc/normalize.cu``.
- ``quantize_rows`` — (M, K) f32/bf16 → int8 (M, K) and f32 scales
  (M, 1), symmetric per row: the activation half of every W8A8
  projection. CUDA C++ in ``csrc/quantize_rows.cu``.
- ``flash_attention`` — (B, S, H, D) attention with an online softmax,
  causal or not, f32 or bf16: the full-sequence forward's attention.
  Two CUDA C++ kernels, picked by dtype (`flash_variant`): bf16 on the
  tensor cores in ``csrc/flash_attn_tc.cu``, f32 on the CUDA cores in
  ``csrc/flash_attn.cu``; each serves both TPU paths (K/V resident and
  K/V streamed).
- ``clamp_scale`` — ``clip(x, lo, hi) * scale + offset`` in x's dtype:
  the transform ``clamp`` step. CUDA C++ in ``csrc/clamp_scale.cu``.
- ``flash_block_update`` — one ring-attention step: q continues its
  online softmax over one incoming K/V block, the (m, l, acc) carry
  updated in place (`flash_carry_init`, `flash_carry_finalize` beside
  it). Two CUDA C++ kernels, picked by dtype as flash's are
  (`flash_block_variant`): bf16 on the tensor cores in
  ``csrc/flash_attn_tc.cu``, f32 on the CUDA cores in
  ``csrc/flash_attn.cu`` (the f32 flash kernel's tile code).

Each kernel has three parts here: the wrapper, which launches the CUDA
kernel for a CUDA tensor and counts the launch (`cuda_graphs.count_launch`:
a launch captured into a CUDA graph counts at each replay); its plain torch version,
which repeats the kernel's arithmetic; and the dispatch between them,
which takes the plain version only for a tensor on the CPU — the device
the caller chose. A CUDA tensor goes to the kernel or the call raises.
Every launch goes through a `cuda_build.Launcher`, bound at its first
call.
"""

from __future__ import annotations

import ctypes
import math
import struct
from typing import Dict

import torch

from nnstreamer_tpu_torch.backends.cuda_build import Launcher
from nnstreamer_tpu_torch.backends.cuda_graphs import count_launch
from nnstreamer_tpu_torch.core.errors import BackendError

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                  ctypes.c_float)


def _dispatch(what: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version); any other device raises."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise BackendError(f"{what} runs on cuda or cpu tensors, got "
                           f"{x.device}")
    return False


# -- normalize: (x - mean) * (1/std) ---------------------------------------

#: input and output dtypes the CUDA kernel takes, by the launcher's type
#: codes: every dtype a tensor stream carries in, every float out
_NORM_IN = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3,
            torch.float32: 4, torch.int32: 5, torch.uint32: 6,
            torch.int64: 7, torch.uint64: 8, torch.float16: 9,
            torch.bfloat16: 10, torch.float64: 11}
_NORM_OUT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
             torch.float64: 3}
_NARROW_INTS = (torch.uint8, torch.int8, torch.uint16, torch.int16)
_NORMALIZE = Launcher("normalize.cu", "nns_normalize",
                      [_P, _I, _P, _I, _L, _F, _F], "normalize_u8")


def normalize_u8_plain(x: torch.Tensor, mean: float = 127.5,
                       std: float = 127.5,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain torch version of the normalize kernel: narrow ints widen to
    int32, then f32; ``(x - mean) * inv_std`` in f32; cast to out_dtype."""
    inv_std = 1.0 / float(std)
    if x.dtype in _NARROW_INTS:
        x = x.to(torch.int32)
    x = x.to(torch.float32)
    return ((x - float(mean)) * inv_std).to(out_dtype)


def _normalize_u8_cuda(x: torch.Tensor, mean: float, std: float,
                       out_dtype: torch.dtype) -> torch.Tensor:
    in_code = _NORM_IN.get(x.dtype)
    if in_code is None:
        raise BackendError(
            f"normalize_u8 kernel takes {sorted(str(d) for d in _NORM_IN)} "
            f"input, got {x.dtype}")
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    _NORMALIZE(x.device.index, x.data_ptr(), in_code, y.data_ptr(),
               _NORM_OUT[out_dtype], x.numel(), mean, 1.0 / std)
    count_launch(normalize_u8)
    return y


def normalize_u8(x: torch.Tensor, mean: float = 127.5, std: float = 127.5,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A frame of any stream dtype (uint8 on the main path) → normalized
    `out_dtype` (a float dtype), same shape. A CUDA tensor runs the
    hand-written kernel; a CPU tensor runs the plain version. Any other
    `out_dtype` raises on both."""
    if out_dtype not in _NORM_OUT:
        raise BackendError(
            f"normalize_u8 writes {sorted(str(d) for d in _NORM_OUT)}, not "
            f"{out_dtype}")
    if _dispatch("normalize_u8", x):
        return _normalize_u8_cuda(x, float(mean), float(std), out_dtype)
    return normalize_u8_plain(x, mean, std, out_dtype)


#: kernel launches made by this process (the wrapper counts each one)
normalize_u8.launches = 0


# -- quantize_rows: per-row symmetric int8 ---------------------------------

_FLOAT_CODE = {torch.float32: 0, torch.bfloat16: 1}


#: 1/127 rounded to f32. The JAX kernel's ``amax / 127.0`` is compiled by
#: XLA as a product with this reciprocal (a division by a constant
#: becomes a multiply), so the scale is ``amax * _INV_127`` in the kernel,
#: here and in CUDA alike; ``x / scale`` stays a true division.
_INV_127 = 1.0 / 127.0


def quantize_rows_plain(x: torch.Tensor):
    """Plain torch version of the quantize_rows kernel (the counterpart of
    `_quantize_rows_xla`): ``amax = max|x|`` per row in f32, ``scale =
    amax / 127`` as the JAX kernel computes it (``amax * f32(1/127)``; 1
    where amax is 0), ``q = clip(round(x / scale), ±127)`` with round
    half to even. → (int8 (M, K), f32 (M, 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * _INV_127, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


#: the longest row the kernel takes: a block's 227 KB of shared memory
#: less the shared-memory path's own 32 bytes
_QUANT_MAX_ROW_BYTES = 227 * 1024 - 32


_QUANTIZE = Launcher("quantize_rows.cu", "nns_quantize_rows",
                     [_P, _I, _L, _P, _P, _I, _I], "quantize_rows")
_QUANTIZE_LAYOUT = Launcher(
    "quantize_rows.cu", "nns_quantize_rows_layout",
    [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "quantize_rows_layout", stream=False)


def quantize_rows_layout(k: int, dtype: torch.dtype, aligned: bool = True):
    """The path the CUDA launcher takes for rows of `k` values of `dtype`
    (16-byte aligned rows and output where `aligned`): ("registers",
    vectors a lane, warps a row) or ("shared memory", 0, 0). Builds the
    kernel's library; for reports on the card."""
    nv, wpr = ctypes.c_int(), ctypes.c_int()
    reg = _QUANTIZE_LAYOUT.function()(
        _FLOAT_CODE[dtype], k, int(aligned), ctypes.byref(nv),
        ctypes.byref(wpr))
    return ("registers", nv.value, wpr.value) if reg else \
        ("shared memory", 0, 0)


def _quantize_rows_cuda(x: torch.Tensor):
    if x.dim() != 2 or x.dtype not in _FLOAT_CODE:
        raise BackendError(
            f"quantize_rows kernel takes a 2-D float32 or bfloat16 matrix, "
            f"got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    if k == 0 or k * x.element_size() > _QUANT_MAX_ROW_BYTES:
        raise BackendError(
            f"quantize_rows kernel holds a row in registers or shared "
            f"memory: K={k} {x.dtype} must be 1 .. "
            f"{_QUANT_MAX_ROW_BYTES // x.element_size()}")
    # the kernel reads row r at x + r * stride(0): rows must not overlap
    # (an expanded or broadcast view is copied first)
    if x.stride(1) != 1 or (m > 1 and x.stride(0) < k):
        x = x.contiguous()
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    _QUANTIZE(x.device.index, x.data_ptr(), _FLOAT_CODE[x.dtype],
              x.stride(0) if m > 1 else k, q.data_ptr(), scale.data_ptr(), m,
              k)
    count_launch(quantize_rows)
    return q, scale


def quantize_rows(x: torch.Tensor):
    """(M, K) f32/bf16 → (int8 (M, K), f32 scales (M, 1)): symmetric
    per-row dynamic quantization in one pass, any M. A CUDA tensor runs
    the hand-written kernel (bit for bit the plain version); a CPU tensor
    runs the plain version."""
    if _dispatch("quantize_rows", x):
        return _quantize_rows_cuda(x)
    return quantize_rows_plain(x)


quantize_rows.launches = 0


# -- clamp_scale: clip(x, lo, hi) * scale + offset ---------------------------

#: launcher type codes: floats, and integers (a pure clamp)
_CLAMP_FLOAT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.float64: 3}
_CLAMP_INT = {torch.uint8: 4, torch.int8: 5, torch.uint16: 6,
              torch.int16: 7, torch.int32: 8, torch.int64: 9}
#: dims the CUDA kernel unravels on its strided path
_CLAMP_MAX_DIMS = 8
#: a strided tensor's sizes and strides, as the launcher reads them
_CLAMP_DIMS = ctypes.c_int64 * _CLAMP_MAX_DIMS
_D = ctypes.c_double
_CLAMP = Launcher("clamp_scale.cu", "nns_clamp_scale",
                  [_P, _P, _I, _L, _I, _P, _P, _I, _D, _D, _D, _D, _I,
                   ctypes.c_longlong, ctypes.c_longlong], "clamp_scale")


class _ClampArgs:
    """The bounds, scale and offset as the kernel uses them for one dtype.

    Floats: each rounded to x's dtype through f32, as JAX rounds a
    weak-typed Python float (f64 keeps them as they are); ``fold_add``
    when the offset is +0.0, whose add XLA folds away (so -0.0 survives).
    Integers: only a pure clamp (scale 1, offset 0; the JAX kernel stores
    its f32 result into an integer output and refuses), to the bounds
    rounded inward — ceil(lo), floor(hi) — and saturated to the dtype.
    ``code`` is the launcher's type code."""

    def __init__(self, dtype: torch.dtype, lo, hi, scale, offset):
        if dtype not in _CLAMP_FLOAT and dtype not in _CLAMP_INT:
            raise BackendError(
                f"clamp_scale takes {sorted(str(d) for d in (*_CLAMP_FLOAT, *_CLAMP_INT))}"
                f", not {dtype}")
        lo, hi, scale, offset = (float(v) for v in (lo, hi, scale, offset))
        if math.isnan(lo) or math.isnan(hi):
            raise BackendError(f"clamp_scale bounds must be numbers, got "
                               f"{lo}:{hi}")
        self.is_int = dtype in _CLAMP_INT
        self.code = _CLAMP_INT[dtype] if self.is_int else _CLAMP_FLOAT[dtype]
        self.ilo = self.ihi = 0
        if self.is_int:
            if scale != 1.0 or offset != 0.0:
                raise BackendError(
                    f"clamp_scale on {dtype} is a pure clamp: scale must "
                    f"be 1 and offset 0, got {scale} and {offset}")
            info = torch.iinfo(dtype)

            def inward(v, rnd):
                v = rnd(v) if math.isfinite(v) else v
                return int(min(max(v, info.min), info.max))

            self.ilo, self.ihi = inward(lo, math.ceil), inward(hi, math.floor)
        elif dtype != torch.float64:
            lo, hi, scale, offset = (
                torch.tensor(v, dtype=torch.float32).to(dtype).item()
                for v in (lo, hi, scale, offset))
        self.lo, self.hi, self.scale, self.offset = lo, hi, scale, offset
        self.fold_add = offset == 0.0 and math.copysign(1.0, offset) > 0


#: (dtype, the four values' bits) → _ClampArgs: a stream's clamp passes
#: the same values every frame, and rounding them costs four tensor round
#: trips; the bits key keeps -0.0 apart from +0.0
_clamp_args_made: Dict[tuple, _ClampArgs] = {}


def _clamp_args(dtype: torch.dtype, lo, hi, scale, offset) -> _ClampArgs:
    key = (dtype, struct.pack("4d", lo, hi, scale, offset))
    a = _clamp_args_made.get(key)
    if a is None:
        a = _ClampArgs(dtype, lo, hi, scale, offset)
        if len(_clamp_args_made) >= 256:
            _clamp_args_made.clear()
        _clamp_args_made[key] = a
    return a


def _round_sum(p: torch.Tensor, offset: float,
               out_dtype: torch.dtype) -> torch.Tensor:
    """``p + offset`` rounded once into `out_dtype`, from a `p` (an exact
    product) at least 2 bits wider than it: the sum is rounded to odd in
    p's dtype, which the final rounding cannot then round again wrongly.
    Round to odd: the sum's rounding error is recovered (TwoSum); if it is
    nonzero and the rounded sum's last bit is even, the sum moves one ulp
    toward the error."""
    s = p + offset
    bb = s - p
    err = (p - (s - bb)) + (offset - bb)
    bits = torch.int64 if s.dtype == torch.float64 else torch.int32
    even = (s.view(bits) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(out_dtype)


def clamp_scale_plain(x: torch.Tensor, lo: float, hi: float,
                      scale: float = 1.0, offset: float = 0.0) -> torch.Tensor:
    """Plain torch version of the clamp_scale kernel, bit for bit (NaN
    positions aside, whose payloads the card and the CPU set differently):
    clip with NaN kept and -0.0 below +0.0; then f32 one rounding of
    ``clip * scale + offset`` (an FMA), f16 one rounding of the exact
    value, bf16 the product rounded and then the f32 sum rounded, f64
    two roundings; an integer input is a pure inward-rounded clamp."""
    a = _clamp_args(x.dtype, lo, hi, scale, offset)
    if a.is_int:
        return x.to(torch.int64).clamp(a.ilo, a.ihi).to(x.dtype)
    comp = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(comp)
    lo_t = torch.tensor(a.lo, dtype=comp, device=x.device)
    hi_t = torch.tensor(a.hi, dtype=comp, device=x.device)
    c = torch.where((xf < lo_t) | ((xf == lo_t) & torch.signbit(xf)), lo_t, xf)
    c = torch.where((c > hi_t) | ((c == hi_t) & ~torch.signbit(c)), hi_t, c)
    if x.dtype == torch.float32:
        if a.fold_add:
            return c * a.scale
        return _round_sum(c.double() * a.scale, a.offset, torch.float32)
    if x.dtype == torch.float16:
        prod = c * a.scale                  # exact in f32: 11 x 11 bits
        if a.fold_add:
            return prod.to(torch.float16)
        return _round_sum(prod, a.offset, torch.float16)
    if x.dtype == torch.bfloat16:
        prod = (c * a.scale).to(torch.bfloat16)
        if a.fold_add:
            return prod
        return (prod.float() + a.offset).to(torch.bfloat16)
    prod = c * a.scale
    return prod if a.fold_add else prod + a.offset


def _clamp_scale_cuda(x: torch.Tensor, a: _ClampArgs) -> torch.Tensor:
    contiguous = x.is_contiguous()
    if not contiguous and x.dim() > _CLAMP_MAX_DIMS:
        x = x.contiguous()
        contiguous = True
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    # the launcher reads sizes and strides only for a strided x
    sizes = strides = None
    if not contiguous:
        sizes, strides = _CLAMP_DIMS(*x.shape), _CLAMP_DIMS(*x.stride())
    _CLAMP(x.device.index, x.data_ptr(), y.data_ptr(), a.code, x.numel(),
           x.dim(), sizes, strides, contiguous, a.lo, a.hi, a.scale,
           a.offset, a.fold_add, a.ilo, a.ihi)
    count_launch(clamp_scale)
    return y


def clamp_scale(x: torch.Tensor, lo: float, hi: float, scale: float = 1.0,
                offset: float = 0.0) -> torch.Tensor:
    """``clip(x, lo, hi) * scale + offset`` in x's dtype, any shape and
    strides (the output is contiguous). A CUDA tensor runs the
    hand-written kernel; a CPU tensor runs the plain version."""
    a = _clamp_args(x.dtype, lo, hi, scale, offset)
    if _dispatch("clamp_scale", x):
        return _clamp_scale_cuda(x, a)
    return clamp_scale_plain(x, lo, hi, scale, offset)


clamp_scale.launches = 0


# -- flash attention ---------------------------------------------------------

#: masked score, and the level at or below which p is forced to 0
#: (pallas_ops._online_softmax_update)
_MASKED, _MASKED_BELOW, _L_FLOOR = -1e30, -1e29, 1e-20
#: largest head dim the CUDA kernels tile
FLASH_MAX_HEAD_DIM = 256
#: flash kernels by variant
_FLASH_ARGS = [_P] * 4 + [_I] * 4 + [_L] * 12 + [_F, _I]
_FLASH_KERNELS = {
    "tc": Launcher("flash_attn_tc.cu", "nns_flash_attn_tc", _FLASH_ARGS,
                   "flash_attention (tc kernel)"),
    "simt": Launcher("flash_attn.cu", "nns_flash_attn", _FLASH_ARGS,
                     "flash_attention (simt kernel)")}


def flash_variant(dtype: torch.dtype, head_dim: int,
                  what: str = "flash_attention") -> str:
    """The CUDA kernel that takes a flash call: ``"tc"`` for bf16 (both
    products on the tensor cores, bf16 in, f32 sums, as the MXU) and
    ``"simt"`` for f32 (f32 FMAs on the CUDA cores: TF32 tensor-core
    products would not hold the f32 tolerance). Raises BackendError for
    what neither takes: another dtype, a head dim above 256, or a row
    that is not a multiple of 16 bytes."""
    if dtype not in _FLOAT_CODE:
        raise BackendError(
            f"{what} kernel takes float32 or bfloat16, got {dtype}")
    if head_dim <= 0 or (head_dim * dtype.itemsize) % 16 or \
            head_dim > FLASH_MAX_HEAD_DIM:
        raise BackendError(
            f"{what} kernel needs head_dim * itemsize a multiple "
            f"of 16 bytes and head_dim <= {FLASH_MAX_HEAD_DIM}; got "
            f"head_dim {head_dim} {dtype}")
    return "tc" if dtype == torch.bfloat16 else "simt"


def flash_block_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel that takes a ring step, by the flash rule
    (`flash_variant`): ``"tc"`` for bf16 (``nns_flash_block_tc_kernel``,
    tensor cores), ``"simt"`` for f32 (``nns_flash_block_kernel``, CUDA
    cores); raises for what neither takes."""
    return flash_variant(dtype, head_dim, "flash_block_update")


def _auto_block(s: int, want: int) -> int:
    """Largest power-of-two block <= `want` that divides `s` (>= 8), as
    the JAX package picks its flash blocks."""
    b = min(want, s)
    while b > 8 and s % b:
        b //= 2
    return b


def _check_flash_blocks(s: int, block_q: int, block_k: int) -> None:
    """JAX's shape contract for flash_attention: S divisible by the
    blocks (explicit, or the largest power of two <= 512 dividing S).
    The CUDA kernel's own 64 x 64 tiles mask a ragged edge themselves;
    the contract is kept so both packages accept the same shapes."""
    bq = min(block_q or _auto_block(s, 512), s)
    bk = min(block_k or _auto_block(s, 512), s)
    if s % bq or s % bk:
        raise ValueError(
            f"flash_attention needs seq len {s} divisible by block sizes "
            f"({bq}, {bk}); pad the sequence upstream")


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          q_start: int = 0):
    """Plain torch version of the flash kernel: the whole row's masked
    softmax in f32 with the kernel's semantics — scores ``(q·k) *
    D**-0.5`` in f32, masked scores −1e30 and their p forced to 0, l
    floored at 1e-20, p cast to v's dtype before the product (f32 sums) —
    → (B, Sq, H, D) in q's dtype. `q_start` is the absolute position of
    q's first row (a slice of rows checked against full K/V)."""
    s_q, s_k, d = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    if causal:
        rows = q_start + torch.arange(s_q, device=q.device)
        mask = rows[:, None] >= torch.arange(s_k, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, _MASKED))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if causal:
        p = torch.where(s <= _MASKED_BELOW, torch.zeros_like(p), p)
    l = p.sum(dim=-1).clamp_min(_L_FLOOR)               # (B, H, Sq)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def _flash_operand(t: torch.Tensor) -> torch.Tensor:
    """A view the kernel can read with cp.async: innermost dim contiguous,
    16-byte aligned base and (b, s, h) strides; otherwise a contiguous
    copy (same values — layout, not arithmetic)."""
    item = t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            (st * item) % 16 for n, st in zip(t.shape[:3], t.stride()[:3])
            if n > 1):
        t = t.contiguous()
    return t


def _strides(t: torch.Tensor):
    return [st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3])]


def _flash_attention_cuda(q, k, v, causal: bool):
    b, s, h, d = q.shape
    variant = flash_variant(q.dtype, d)
    if b > 65535 or h > 65535:
        raise BackendError(f"flash_attention kernel: batch {b} or heads {h} "
                           f"above 65535")
    q, k, v = (_flash_operand(t) for t in (q, k, v))
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    _FLASH_KERNELS[variant](
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, s, h, d, *_strides(q), *_strides(k),
        *_strides(v), *_strides(out), d ** -0.5, bool(causal))
    count_launch(flash_attention, f"launches_{variant}")
    return out


def flash_attention(q, k, v, *, causal: bool = False, block_q: int = 0,
                    block_k: int = 0):
    """Fused attention for (B, S, H, D) tensors (K/V already expanded to
    H heads for GQA), scale D**-0.5, output in q's dtype. Raises
    ValueError where the JAX package's flash_attention refuses the shape
    (S not divisible by the explicit or automatic blocks). A CUDA tensor
    runs the hand-written kernel of its dtype (`flash_variant`); a CPU
    tensor runs the plain version."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise BackendError(
            f"flash_attention takes q, k, v of one (B, S, H, D) shape and "
            f"dtype, got {tuple(q.shape)} {q.dtype}, {tuple(k.shape)} "
            f"{k.dtype}, {tuple(v.shape)} {v.dtype}")
    _check_flash_blocks(q.shape[1], block_q, block_k)
    if _dispatch("flash_attention", q):
        return _flash_attention_cuda(q, k, v, causal)
    return flash_attention_plain(q, k, v, causal=causal)


#: kernel launches made by this process, in all and by variant
flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_simt = 0


# -- flash_block_update: one ring-attention step ------------------------------

def flash_carry_init(bh: int, sq: int, d: int, device=None):
    """Fresh (m, l, acc) carry for `flash_block_update`: m (BH, Sq) at
    −1e30, l (BH, Sq) and acc (BH, Sq, D) at 0, all f32. (The JAX
    package's m and l repeat each row over 8 sublanes for the TPU; here
    they are plain (BH, Sq).)"""
    return (torch.full((bh, sq), _MASKED, dtype=torch.float32, device=device),
            torch.zeros((bh, sq), dtype=torch.float32, device=device),
            torch.zeros((bh, sq, d), dtype=torch.float32, device=device))


def flash_carry_finalize(l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """acc / max(l, 1e-20) → the attention output (BH, Sq, D) f32."""
    return acc / l.clamp_min(_L_FLOOR)[..., None]


def _flat_rows(t: torch.Tensor) -> torch.Tensor:
    """(BH, S, D) as it is; (B, H, S, D) → (B·H, S, D)."""
    return t if t.dim() == 3 else t.reshape(-1, *t.shape[-2:])


def flash_block_update_plain(q, k_blk, v_blk, m, l, acc, *, q_offset: int,
                             k_offset: int, causal: bool):
    """Plain torch version of the ring-step kernel, over the whole block
    at once: scores ``(q·k) * D**-0.5`` in f32; when causal, −1e30 where
    ``q_offset + row < k_offset + col`` and p forced to 0 there; then
    ``m' = max(m, rowmax)``, ``l' = l·exp(m − m') + Σp``, ``acc' =
    acc·exp(m − m') + p·v`` with p cast to v's dtype first and summed in
    f32. A causal block wholly above the diagonal is skipped, as the
    kernel skips it. The carry is updated in place and returned."""
    sq, sk, d = q.shape[-2], k_blk.shape[-2], q.shape[-1]
    if causal and q_offset + sq - 1 < k_offset:
        return m, l, acc
    qf, kf, vf = (_flat_rows(t) for t in (q, k_blk, v_blk))
    s = torch.einsum("bqd,bkd->bqk", qf.float(), kf.float()) * d ** -0.5
    if causal:
        rows = q_offset + torch.arange(sq, device=q.device)
        cols = k_offset + torch.arange(sk, device=q.device)
        s = torch.where(rows[:, None] >= cols[None, :], s,
                        torch.full_like(s, _MASKED))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = torch.where(s <= _MASKED_BELOW, torch.zeros_like(p), p)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bqk,bkd->bqd", p.to(vf.dtype).float(), vf.float())
    m.copy_(m_new)
    l.copy_(l_new)
    acc.copy_(acc_new)
    return m, l, acc


#: ring-step kernels by variant; the CUDA-core launcher also takes a
#: dtype code (0 f32, 1 bf16) after the carry
_FLASH_BLOCK_KERNELS = {
    "tc": Launcher("flash_attn_tc.cu", "nns_flash_block_tc",
                   [_P] * 6 + [_I] * 5 + [_L] * 9 + [_F] + [_I] * 3,
                   "flash_block_update (tc kernel)"),
    "simt": Launcher("flash_attn.cu", "nns_flash_block",
                     [_P] * 6 + [_I] * 6 + [_L] * 9 + [_F] + [_I] * 3,
                     "flash_block_update (simt kernel)")}


def _flash_block_launch(variant: str, q, k, v, m, l, acc, q_offset: int,
                        k_offset: int, causal: bool) -> None:
    """Launch one ring-step kernel, ``"tc"`` (bf16) or ``"simt"`` (f32,
    or bf16 on the CUDA cores); counts nothing. The wrapper takes the
    variant of q's dtype (`flash_block_variant`); a direct ``"simt"``
    call on bf16 is only a reading beside the tensor-core kernel."""
    d = q.shape[-1]
    bh = m.shape[0]
    if bh > 65535:
        raise BackendError(f"flash_block_update kernel: BH {bh} above 65535")
    heads = 1 if q.dim() == 3 else q.shape[1]

    def strides(t):
        """(b, s, h) element strides: a 3-D (BH, S, D) tensor reads row bh
        at bh * stride(0) (heads 1), a 4-D (B, H, S, D) one at b *
        stride(0) + h * stride(1)."""
        t = _flash_operand(t.unsqueeze(1) if t.dim() == 3 else t)
        sb, sh, ss = (st if n > 1 else 0
                      for n, st in zip(t.shape[:3], t.stride()[:3]))
        return t, (sb, ss, sh)

    (q, qs), (k, ks), (v, vs) = (strides(t) for t in (q, k, v))
    code = () if variant == "tc" else (_FLOAT_CODE[q.dtype],)
    _FLASH_BLOCK_KERNELS[variant](
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), *code, bh, heads,
        q.shape[2], k.shape[2], d, *qs, *ks, *vs, d ** -0.5, bool(causal),
        int(q_offset), int(k_offset))


def _flash_block_cuda(q, k, v, m, l, acc, q_offset: int, k_offset: int,
                      causal: bool):
    variant = flash_block_variant(q.dtype, q.shape[-1])
    _flash_block_launch(variant, q, k, v, m, l, acc, q_offset, k_offset,
                        causal)
    count_launch(flash_block_update, f"launches_{variant}")
    return m, l, acc


#: the JAX package's ring-step blocks: it refuses an Sq or Sk that
#: min(128, S) does not divide, and so does the port (the CUDA kernels'
#: own tiles take any S)
_RING_BLOCK = 128


def flash_block_update(q, k_blk, v_blk, m, l, acc, *, q_offset: int,
                       k_offset: int, causal: bool):
    """One ring-attention step: q attends one incoming K/V block and
    carries the online softmax on in (m, l, acc), updated in place and
    returned.

    q (BH, Sq, D) and k_blk, v_blk (BH, Sk, D), or all three (B, H, S, D)
    — BH = B·H, so the ring's transposed views of (B, S, H, D) shards are
    read through their strides, not copied; one dtype, f32 or bf16. m, l
    (BH, Sq) and acc (BH, Sq, D): contiguous f32 on q's device.
    `q_offset`/`k_offset` are the global positions of q's first row and
    the block's first key (they place the causal mask). Raises ValueError
    where the JAX package's kernel refuses the shape (Sq, Sk not divisible
    by min(128, S)). A CUDA tensor runs the hand-written kernel of its
    dtype (`flash_block_variant`); a CPU tensor runs the plain
    version."""
    if q.dim() not in (3, 4) or k_blk.dim() != q.dim() or \
            k_blk.shape != v_blk.shape or \
            k_blk.shape[:-2] != q.shape[:-2] or \
            k_blk.shape[-1] != q.shape[-1] or \
            k_blk.dtype != q.dtype or v_blk.dtype != q.dtype or \
            k_blk.device != q.device or v_blk.device != q.device:
        raise BackendError(
            f"flash_block_update takes q (BH, Sq, D) and k, v (BH, Sk, D) "
            f"(or (B, H, S, D)) of one dtype on one device, got "
            f"{tuple(q.shape)} {q.dtype} {q.device}, {tuple(k_blk.shape)} "
            f"{k_blk.dtype} {k_blk.device}, {tuple(v_blk.shape)} "
            f"{v_blk.dtype} {v_blk.device}")
    sq, sk, d = q.shape[-2], k_blk.shape[-2], q.shape[-1]
    bh = math.prod(q.shape[:-2])
    for name, t, shape in (("m", m, (bh, sq)), ("l", l, (bh, sq)),
                           ("acc", acc, (bh, sq, d))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != q.device:
            raise BackendError(
                f"flash_block_update carry {name} must be a contiguous f32 "
                f"{shape} tensor on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    bq, bk = min(_RING_BLOCK, sq), min(_RING_BLOCK, sk)
    if sq % bq or sk % bk:
        raise ValueError(
            f"flash_block_update needs Sq={sq}, Sk={sk} divisible by "
            f"({bq}, {bk})")
    if _dispatch("flash_block_update", q):
        return _flash_block_cuda(q, k_blk, v_blk, m, l, acc, q_offset,
                                 k_offset, causal)
    return flash_block_update_plain(q, k_blk, v_blk, m, l, acc,
                                    q_offset=q_offset, k_offset=k_offset,
                                    causal=causal)


#: kernel launches made by this process, in all and by variant
flash_block_update.launches = 0
flash_block_update.launches_tc = 0
flash_block_update.launches_simt = 0

"""The port's paged attention (nnstreamer_tpu_torch/backends/paged_attn.py
and llm/paged_model.py) against the JAX package's Pallas paged kernels
and XLA paged reference.

The JAX side runs `pallas_paged.paged_decode_attn`/`paged_prefill_attn`
in interpret mode, as tests/test_paged_kernels.py does on the CPU. The
port's side runs on CPU tensors, so its wrappers take the plain torch
versions: a CUDA kernel has no CPU mode, and chip_smoke.py holds the CUDA
kernels to these plain versions on the card.

Inputs are numpy-seeded and shared; the pool geometry is the JAX
tests' (L2, NB16, BS8, NKV2, HD16, MB4). Tolerance 1e-5 absolute on
attention outputs and logits (f32 on both sides; the two frameworks sum
in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends import pallas_paged as jpp
from nnstreamer_tpu.llm import paged_model as jpm
from nnstreamer_tpu.models.transformer import init_params
from nnstreamer_tpu_torch.backends import paged_attn as tpa
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.llm import paged_model as tpm
from nnstreamer_tpu_torch.models import bridge

TOL = 1e-5
L, NB, BS, NKV, HD, MB = 2, 16, 8, 2, 16, 4     # pool geometry
N_HEADS = 4


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's bridged copy)."""
    jp = init_params(vocab=61, d_model=64, n_layers=L, n_heads=N_HEADS,
                     n_kv_heads=NKV, seed=3)
    return jp, bridge.transformer_params(
        jax.tree_util.tree_map(np.asarray, jp))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(a, b, tol=TOL):
    err = float(np.max(np.abs(_np(a) - _np(b))))
    assert err <= tol, err


# -- the kernels: plain torch vs the Pallas kernels in interpret mode ------

#: name → (tables, pos): holes and out-of-order blocks, staggered rows
#: (one at a block boundary), pow2 padding rows all on scratch
DECODE_CASES = {
    "holey-staggered-padded": ([[3, 9, 0, 0], [7, 0, 0, 0], [0] * 4,
                                [0] * 4], [12, 5, 0, 0]),
    "block-boundary": ([[5, 11, 0, 0]], [BS]),
    "out-of-order-deep": ([[14, 2, 9, 4], [6, 1, 0, 0]],
                          [4 * BS - 1, BS + 3]),
    "last-slot-every-row": ([[14, 2, 9, 4], [5, 11, 3, 7], [0] * 4],
                            [4 * BS - 1, 4 * BS - 1, 0]),
}


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_pallas(case, qdtype):
    tables, pos = DECODE_CASES[case]
    tables = np.asarray(tables, np.int32)
    pos = np.asarray(pos, np.int32)
    b = tables.shape[0]
    q = _rand((b, N_HEADS, HD), 1)
    kp, vp = _rand((NB, BS, NKV, HD), 2), _rand((NB, BS, NKV, HD), 3)
    jq = jnp.asarray(q).astype(qdtype)
    ref = jpp.paged_decode_attn(jq, jnp.asarray(kp), jnp.asarray(vp),
                                jnp.asarray(tables), jnp.asarray(pos))
    tq = torch.from_numpy(q).to(getattr(torch, qdtype))
    before = tpa.paged_decode_attn.launches
    got = tpa.paged_decode_attn(tq, torch.from_numpy(kp),
                                torch.from_numpy(vp),
                                torch.from_numpy(tables),
                                torch.from_numpy(pos))
    assert got.dtype == torch.float32 and got.shape == (b, N_HEADS, HD)
    assert tpa.paged_decode_attn.launches == before   # CPU: no launch
    _close(got, ref)


#: name → (S_c, pos0, table): one chunk from 0, later chunks of a
#: multi-chunk prefill (pos0 > 0), a chunk padded past the table
PREFILL_CASES = {
    "first-chunk": (16, 0, [3, 9, 0, 0]),
    "second-chunk": (8, 8, [2, 6, 13, 0]),
    "third-chunk-odd-start": (8, 19, [2, 6, 13, 5]),
    "padded-past-table": (32, 0, [4, 0, 0, 0]),
}


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_plain_matches_pallas(case, qdtype):
    s_c, pos0, table = PREFILL_CASES[case]
    table = np.asarray(table, np.int32)
    q = _rand((N_HEADS, s_c, HD), 4)
    kp, vp = _rand((NB, BS, NKV, HD), 5), _rand((NB, BS, NKV, HD), 6)
    ref = jpp.paged_prefill_attn(jnp.asarray(q).astype(qdtype),
                                 jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(table), pos0)
    before = tpa.paged_prefill_attn.launches
    got = tpa.paged_prefill_attn(
        torch.from_numpy(q).to(getattr(torch, qdtype)),
        torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), pos0)
    assert got.dtype == torch.float32 and got.shape == (N_HEADS, s_c, HD)
    assert tpa.paged_prefill_attn.launches == before
    _close(got, ref)


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, N_HEADS, HD), device="meta")
    pool = torch.zeros((NB, BS, NKV, HD), device="meta")
    with pytest.raises(BackendError, match="cuda or cpu"):
        tpa.paged_decode_attn(q, pool, pool, torch.zeros((1, MB)),
                              torch.zeros(1))
    with pytest.raises(BackendError, match="cuda or cpu"):
        tpa.paged_prefill_attn(q[0][:, None].expand(N_HEADS, 8, HD),
                               pool, pool, torch.zeros(MB), 0)


# -- the layer stacks on bridged params --------------------------------------

def _jpools():
    z = jnp.zeros((L, NB, BS, NKV, HD), jnp.float32)
    return z, z


def _tpools():
    return (torch.zeros((L, NB, BS, NKV, HD)),
            torch.zeros((L, NB, BS, NKV, HD)))


def _targets(n, blocks, s_b, pos0=0):
    """Per-position (block, offset) scatter targets; padding → scratch."""
    bi = np.zeros(s_b, np.int32)
    bo = ((pos0 + np.arange(s_b)) % BS).astype(np.int32)
    for j in range(n):
        bi[j] = blocks[(pos0 + j) // BS]
    return bi, bo


def _table(blocks):
    t = np.zeros(MB, np.int32)
    t[:len(blocks)] = blocks
    return t


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 60, size=n).astype(
        np.int32)


def _prefill_both(params, prompt, blocks, jpools, tpools):
    """Whole-prompt prefill on both sides (the reference path)."""
    jp, tp = params
    n = len(prompt)
    s_b = max(8, 1 << (n - 1).bit_length())
    ids = np.pad(prompt, (0, s_b - n))[None, :]
    bi, bo = _targets(n, blocks, s_b)
    jl, jk, jv = jpm.paged_prefill(jp, jnp.asarray(ids), jnp.asarray(bi),
                                   jnp.asarray(bo), *jpools, n - 1)
    tl, tk, tv = tpm.paged_prefill(tp, torch.from_numpy(ids),
                                   torch.from_numpy(bi),
                                   torch.from_numpy(bo), *tpools, n - 1)
    return (jl, tl), (jk, jv), (tk, tv)


@pytest.mark.parametrize("flavor", ["xla", "pallas"])
def test_decode_step_matches_jax(params, flavor):
    """Two live rows at different depths over holey tables, plus pow2
    padding rows on scratch; then a second step over the updated pools.
    The port's reference (xla) and kernel twin (pallas) both hold to
    JAX's paged_decode_step, logits and live pool blocks."""
    jp, tp = params
    fn = tpm.paged_decode_step if flavor == "xla" \
        else tpa.paged_flash_decode_step
    jpools, tpools = _jpools(), _tpools()
    (jl, tl), jpools, tpools = _prefill_both(params, _prompt(12, 1), [3, 9],
                                             jpools, tpools)
    _close(tl, jl)
    _, jpools, tpools = _prefill_both(params, _prompt(5, 2), [7], jpools,
                                      tpools)
    tabs = np.zeros((4, MB), np.int32)
    tabs[0, :2] = [3, 9]
    tabs[1, 0] = 7
    for cur, pos in (([17, 23, 0, 0], [12, 5, 0, 0]),
                     ([9, 11, 0, 0], [13, 6, 0, 0])):
        cur, pos = np.asarray(cur, np.int32), np.asarray(pos, np.int32)
        ref, *jpools = jpm.paged_decode_step(
            jp, jnp.asarray(cur), jnp.asarray(tabs), jnp.asarray(pos),
            *jpools)
        got, *tpools = fn(tp, torch.from_numpy(cur), torch.from_numpy(tabs),
                          torch.from_numpy(pos), *tpools)
        _close(got[:2], ref[:2])
        for j, t in zip(jpools, tpools):
            _close(t[:, 1:], j[:, 1:])   # scratch takes padding garbage


@pytest.mark.parametrize("flavor", ["xla", "pallas"])
def test_chunk_matches_jax_full_prefill(params, flavor):
    """One chunk covering the prompt == JAX's apply_seq_kv prefill, logits
    and pool contents: the bridge that lets the chunk family replace the
    whole-prompt prefill for the kernel path."""
    jp, tp = params
    fn = tpm.paged_prefill_chunk if flavor == "xla" \
        else tpa.paged_flash_prefill_chunk
    prompt, n, s_b = _prompt(12, 5), 12, 16
    ids = np.pad(prompt, (0, s_b - n))[None, :]
    bi, bo = _targets(n, [3, 9], s_b)
    ref, jk, _ = jpm.paged_prefill(jp, jnp.asarray(ids), jnp.asarray(bi),
                                   jnp.asarray(bo), *_jpools(), n - 1)
    got, tk, _ = fn(tp, torch.from_numpy(ids), 0, torch.from_numpy(bi),
                    torch.from_numpy(bo), torch.from_numpy(_table([3, 9])),
                    *_tpools(), n - 1)
    _close(got, ref)
    _close(tk[:, 1:], jk[:, 1:])


@pytest.mark.parametrize("flavor", ["xla", "pallas"])
def test_chunked_prefill_matches_jax_unchunked(params, flavor):
    """Three 8-token chunks through holey blocks == JAX's one 24-token
    prefill: later chunks attend earlier chunks' pool KV through the
    table, with a positional causal mask."""
    jp, tp = params
    fn = tpm.paged_prefill_chunk if flavor == "xla" \
        else tpa.paged_flash_prefill_chunk
    prompt, blocks = _prompt(24, 6), [2, 6, 13]
    (ref, _), _, _ = _prefill_both(params, prompt, blocks, _jpools(),
                                   _tpools())
    tab = torch.from_numpy(_table(blocks))
    tpools = _tpools()
    for c0 in range(0, 24, 8):
        seg = prompt[c0:c0 + 8]
        bi, bo = _targets(len(seg), blocks, 8, pos0=c0)
        out, *tpools = fn(tp, torch.from_numpy(seg[None, :]), c0,
                          torch.from_numpy(bi), torch.from_numpy(bo), tab,
                          *tpools, len(seg) - 1)
    _close(out, ref)


def test_chunk_padded_tail_hits_scratch_only(params):
    """A short chunk padded to its bucket leaves every live block
    untouched beyond its real tokens: padding writes only scratch."""
    _, tp = params
    prompt = _prompt(3, 7)
    bi, bo = _targets(3, [4], 8)
    _, kp, _ = tpa.paged_flash_prefill_chunk(
        tp, torch.from_numpy(np.pad(prompt, (0, 5))[None, :]), 0,
        torch.from_numpy(bi), torch.from_numpy(bo),
        torch.from_numpy(_table([4])), *_tpools(), 2)
    assert float(kp[:, 4, 3:].abs().max()) == 0.0
    live = torch.ones(NB, dtype=torch.bool)
    live[[0, 4]] = False
    assert float(kp[:, live].abs().max()) == 0.0


# -- W8A8 params ----------------------------------------------------------------

@pytest.fixture(scope="module")
def qparams(params):
    """(JAX W8A8 params, the port's bridged copy) of the same model."""
    from nnstreamer_tpu.models.quant import quantize_transformer

    jq = quantize_transformer(params[0])
    return jq, bridge.transformer_params(
        jax.tree_util.tree_map(np.asarray, jq))


def _quant_close(got, ref):
    """W8A8 tolerance: a few-ulp float difference between the frameworks
    can flip one activation across an int8 rounding boundary, moving a
    logit by about one quantization step — 1e-3 * max |ref|, and the
    same argmax."""
    got, ref = _np(got), _np(ref)
    err = float(np.max(np.abs(got - ref)))
    assert err <= 1e-3 * float(np.max(np.abs(ref))), err
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("flavor", ["xla", "pallas"])
def test_quantized_chunk_and_decode_match_jax(qparams, flavor):
    """W8A8 params through one prompt chunk and one decode step: the
    port's reference (xla) and kernel twin (pallas) against JAX's
    paged_prefill_chunk / paged_decode_step on the same quantized params
    (tests/test_paged_kernels.py's quantized parity case), logits and the
    live pool blocks."""
    jq, tq = qparams
    chunk = tpm.paged_prefill_chunk if flavor == "xla" \
        else tpa.paged_flash_prefill_chunk
    step = tpm.paged_decode_step if flavor == "xla" \
        else tpa.paged_flash_decode_step
    prompt = _prompt(10, 8)
    ids = np.pad(prompt, (0, 6))[None, :]
    bi, bo = _targets(10, [3, 8], 16)
    tab = _table([3, 8])
    jchunk, jstep = (jax.jit(f, static_argnames=("n_heads", "dtype"))
                     for f in (jpm.paged_prefill_chunk, jpm.paged_decode_step))
    ref, jk, jv = jchunk(
        jq, jnp.asarray(ids), jnp.int32(0), jnp.asarray(bi), jnp.asarray(bo),
        jnp.asarray(tab), *_jpools(), 9)
    launches = tpa.paged_prefill_attn.launches
    got, tk, tv = chunk(tq, torch.from_numpy(ids), 0, torch.from_numpy(bi),
                        torch.from_numpy(bo), torch.from_numpy(tab),
                        *_tpools(), 9)
    _quant_close(got, ref)
    _close(tk[:, 1:], jk[:, 1:], 1e-3)
    tabs = np.array([[3, 8, 0, 0]], np.int32)
    cur, pos = np.array([21], np.int32), np.array([10], np.int32)
    refd = jstep(jq, jnp.asarray(cur), jnp.asarray(tabs), jnp.asarray(pos),
                 jk, jv)[0]
    gotd = step(tq, torch.from_numpy(cur), torch.from_numpy(tabs),
                torch.from_numpy(pos), tk, tv)[0]
    _quant_close(gotd, refd)
    assert tpa.paged_prefill_attn.launches == launches   # CPU: no launch


# -- the prefill kernel's numerical design, emulated -------------------------
#
# The CUDA prefill kernel takes both products on the tensor cores as split
# TF32: each f32 operand x is split into hi = tf32(x) and lo = tf32(x -
# hi), and a.b is lo_a.hi_b + hi_a.lo_b + hi_a.hi_b with f32 sums. A CUDA
# kernel cannot run here, so the arithmetic is emulated in torch: TF32
# rounding is cvt.rna's, the f32 mantissa rounded to 10 bits (to nearest,
# ties away from zero) on the int32 view. The emulation splits the keys
# as the kernel's four key warps do (8 keys of each 32-key tile, each
# with its own m/l/acc) and combines their partials as the kernel does.
# It must hold
# the plain version within phase 7's rule (1e-5 * max|plain| + 1e-6) on
# phase 7's prefill shapes; a single-TF32 control (one product of the
# rounded operands) must not, which shows the rule has teeth.

PAGED_REL, PAGED_ABS = 1e-5, 1e-6
#: the kernel's tile and key split
TILE_KEYS, KEY_WARPS = 32, 4


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_mm(a, b):
    """a @ b as split TF32 (the kernel's three products)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _single_mm(a, b):
    """a @ b as one TF32 product (the control)."""
    return _tf32(a) @ _tf32(b)


def _prefill_design(q, k_pool_l, v_pool_l, table, pos0, mm):
    """The prefill kernel's arithmetic with products `mm`: each key warp's
    softmax partial (m, l, acc) over its 8 keys of every 32-key tile
    (taken over all of them at once: the kernel's tile-by-tile recurrence
    differs only in the order of its f32 sums), then the warps' partials
    folded in order → (n_heads, S_c, hd) f32."""
    n_heads, s_c, hd = q.shape
    n_kv = k_pool_l.shape[2]
    kc, vc = (p[table].reshape(-1, n_kv, hd).repeat_interleave(
        n_heads // n_kv, dim=1).transpose(0, 1) for p in (k_pool_l, v_pool_l))
    key = torch.arange(kc.shape[1])
    qf = q.float()
    rows = pos0 + torch.arange(s_c)
    parts = []
    for kw in range(KEY_WARPS):
        keys = key[(key % TILE_KEYS) // 8 == kw]
        s = mm(qf, kc[:, keys].transpose(1, 2)) * hd ** -0.5
        s = torch.where(keys[None, None, :] <= rows[None, :, None], s,
                        torch.full_like(s, -1e30))
        m = s.amax(-1)
        p = torch.where(s <= -1e29, torch.zeros_like(s),
                        torch.exp(s - m[..., None]))
        parts.append((m, p.sum(-1), mm(p, vc[:, keys])))
    m, l, acc = parts[0]
    for m_p, l_p, acc_p in parts[1:]:
        m_new = torch.maximum(m, m_p)
        c_own, c_part = torch.exp(m - m_new), torch.exp(m_p - m_new)
        l = l * c_own + l_p * c_part
        acc = acc * c_own[..., None] + acc_p * c_part[..., None]
        m = m_new
    return acc / l.clamp_min(1e-20)[..., None]


def _phase7_pools(n_kv):
    """Phase 7's prefill inputs at its shapes (block 16, hd 128, a holey
    96-block table of a 1535-token sequence), from a smaller pool."""
    rng = np.random.default_rng(1)
    nb, bs, hd = 129, 16, 128
    pools = [torch.from_numpy(rng.standard_normal(
        (nb, bs, n_kv, hd)).astype(np.float32)) for _ in range(2)]
    table = torch.from_numpy(
        rng.permutation(np.arange(1, nb))[:1535 // bs + 1].astype(np.int32))
    return pools, table


def _design_err(n_kv, qdtype, s_c, pos0, mm):
    pools, table = _phase7_pools(n_kv)
    q = torch.from_numpy(np.random.default_rng(s_c + pos0).standard_normal(
        (8, s_c, 128)).astype(np.float32)).to(getattr(torch, qdtype))
    ref = tpa.paged_prefill_attn_plain(q, *pools, table, pos0)
    got = _prefill_design(q, *pools, table, pos0, mm)
    err = (got - ref).abs().max().item()
    return err, PAGED_REL * ref.abs().max().item() + PAGED_ABS


#: phase 7's prefill chunks: (S_c, pos0)
PHASE7_CHUNKS = [(512, 0), (512, 1024), (64, 1000), (8, 0)]


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_kv", [8, 2])
@pytest.mark.parametrize("s_c,pos0", PHASE7_CHUNKS)
def test_split_tf32_prefill_design_holds_plain(s_c, pos0, n_kv, qdtype):
    err, lim = _design_err(n_kv, qdtype, s_c, pos0, _split_mm)
    assert err <= lim, (err, lim)


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_c,pos0", [(512, 1024), (8, 0)])
def test_single_tf32_control_exceeds_limit(s_c, pos0, qdtype):
    err, lim = _design_err(8, qdtype, s_c, pos0, _single_mm)
    assert err > lim, (err, lim)


def test_tf32_rounding_is_rna():
    """10 explicit mantissa bits, to nearest, ties away from zero."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 * 0.99,
                      one + 1.5 * ulp, 3.0e-39], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp,
                         _tf32(torch.tensor([3.0e-39])).item()])
    assert torch.equal(_tf32(x), want)
    ties = x[[0, 1, 3]]                  # hi + lo holds these exactly
    hi = _tf32(ties)
    assert torch.equal(hi + _tf32(ties - hi), ties)


# -- the decode kernel's split walk, emulated ---------------------------------
#
# The CUDA decode kernel splits each row's walk over the KV axis: split s
# of a (row, kv head) takes table blocks s * bps .. s * bps + bps - 1 (the
# plan of `paged_attn.decode_plan`), its four warps take batches of KB
# keys in turn (warp w: batches w, w + 4, ...), each with its own online
# softmax (m, l, acc); the warps' partials fold into the split's, and the
# live splits' partials fold in split order (M = max m, weights
# e^(m - M)). A row with one live split writes out directly; a split past
# pos returns. The emulation repeats that order of operations in torch
# (the dot products and the p.v sums in another f32 order than the
# kernel's shuffles). It must hold the plain version within phase 7's
# rule on phase 7's decode shapes, and JAX's Pallas kernel in interpret
# mode within 1e-5 at the test geometry; a control that folds the splits
# without the e^(m - M) weights must not.

DECODE_WARPS = tpa.DECODE_WARPS


def _fold(m, l, acc, dim, weighted=True):
    """Fold partials along `dim` (m, l: (..., g); acc: (..., g, hd))."""
    mx = m.amax(dim, keepdim=True)
    c = torch.exp(m - mx) if weighted else torch.ones_like(m)
    return (mx.squeeze(dim), (l * c).sum(dim),
            (acc * c[..., None]).sum(dim))


def _decode_split_design(q, k_pool_l, v_pool_l, tables, pos, bps, kb,
                         weighted=True):
    """The decode kernel's arithmetic → (B, n_heads, hd) f32."""
    b_n, n_heads, hd = q.shape
    _, bs, n_kv, _ = k_pool_l.shape
    mb = tables.shape[1]
    g = n_heads // n_kv
    scale = hd ** -0.5
    out = torch.zeros((b_n, n_heads, hd))
    for b in range(b_n):
        p = int(pos[b])
        nblk = 0 if p < 0 else min(mb, p // bs + 1)
        nlive = -(-nblk // bps)
        n_s = max(nlive, 1)
        qf = q[b].float().reshape(n_kv, g, hd)
        key0 = torch.arange(n_s) * bps * bs                       # (S,)
        key1 = key0 + (torch.clamp(nblk - torch.arange(n_s) * bps, 0, bps)
                       * bs)
        m = torch.full((n_s, DECODE_WARPS, n_kv, g), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros((n_s, DECODE_WARPS, n_kv, g, hd))
        steps = -(-bps * bs // (DECODE_WARPS * kb))
        for t in range(steps):
            batch = t * DECODE_WARPS + torch.arange(DECODE_WARPS)   # (W,)
            key = (key0[:, None, None] + batch[None, :, None] * kb
                   + torch.arange(kb)[None, None, :])             # (S,W,KB)
            inside = key < key1[:, None, None]
            blk = torch.where(inside, tables[b][(key // bs).clamp(max=mb - 1)],
                              torch.zeros_like(key))
            slot = key % bs
            kr = torch.where(inside[..., None, None], k_pool_l[blk, slot],
                             torch.zeros(()))                     # (S,W,KB,kv,hd)
            vr = torch.where(inside[..., None, None], v_pool_l[blk, slot],
                             torch.zeros(()))
            s = torch.einsum("hgd,swkhd->swhgk", qf, kr) * scale
            valid = (inside & (key <= p))[:, :, None, None, :]
            s = torch.where(valid, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            e = torch.where(s <= -1e29, torch.zeros_like(s),
                            torch.exp(s - m_new[..., None]))
            l = l * corr + e.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("swhgk,swkhd->swhgd",
                                                       e, vr)
            m = m_new
        m, l, acc = _fold(m, l, acc, 1)                     # the warps
        if nlive > 1:
            m, l, acc = _fold(m[:nlive], l[:nlive], acc[:nlive], 0, weighted)
        else:
            m, l, acc = m[0], l[0], acc[0]
        out[b] = (acc / l.clamp_min(1e-20)[..., None]).reshape(n_heads, hd)
    return out


def _phase7_decode(n_kv, rows, qdtype):
    """Phase 7's decode inputs at its shapes (8 heads, block 16, hd 128, a
    128-block table), from a smaller pool: rows at the given depths,
    padding rows (depth None) on block 0 at pos 0."""
    rng = np.random.default_rng(n_kv + len(rows))
    nb, bs, hd, mb = 129, 16, 128, 128
    pools = [torch.from_numpy(rng.standard_normal(
        (nb, bs, n_kv, hd)).astype(np.float32)) for _ in range(2)]
    tables = np.zeros((len(rows), mb), np.int32)
    for b, depth in enumerate(rows):
        if depth is not None:
            n = depth // bs + 1
            tables[b, :n] = rng.permutation(np.arange(1, nb))[:n]
    pos = np.array([d or 0 for d in rows], np.int32)
    q = torch.from_numpy(rng.standard_normal(
        (len(rows), 8, hd)).astype(np.float32)).to(getattr(torch, qdtype))
    return q, pools, torch.from_numpy(tables), torch.from_numpy(pos)


def _split_keys(batch, n_kv):
    plan = tpa.decode_plan(batch, 8, n_kv, 128, 16, 128, sms=132)
    return plan, plan.bps * 16


def _phase7_rows(n_kv):
    """Phase 7's decode row sets: the staggered B8 rows with two padding
    rows, one long row alone, and B4 rows on split boundaries (the last
    key of split 0, the first of split 1, the first of split 3, the
    table's last slot)."""
    split = _split_keys(4, n_kv)[1]
    return {"B8": (1535, 16, 700, 63, 1000, 3, None, None),
            "B1-pos1567": (1567,),
            "B4-boundaries": (split - 1, split, 3 * split, 2047)}


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_kv", [8, 2])
@pytest.mark.parametrize("rows", ["B8", "B1-pos1567", "B4-boundaries"])
def test_split_decode_design_holds_plain(rows, n_kv, qdtype):
    depths = _phase7_rows(n_kv)[rows]
    q, pools, tables, pos = _phase7_decode(n_kv, depths, qdtype)
    plan, _ = _split_keys(len(depths), n_kv)
    ref = tpa.paged_decode_attn_plain(q, *pools, tables, pos)
    got = _decode_split_design(q, *pools, tables, pos, plan.bps, plan.kb)
    err = (got - ref).abs().max().item()
    assert err <= PAGED_REL * ref.abs().max().item() + PAGED_ABS, err


def test_split_decode_control_exceeds_limit():
    """Folding the splits' partials without their e^(m - M) weights
    misses the rule by far: the fold's weights are what the test sees."""
    q, pools, tables, pos = _phase7_decode(8, (1567,), "float32")
    plan, _ = _split_keys(1, 8)
    ref = tpa.paged_decode_attn_plain(q, *pools, tables, pos)
    got = _decode_split_design(q, *pools, tables, pos, plan.bps, plan.kb,
                               weighted=False)
    err = (got - ref).abs().max().item()
    assert err > PAGED_REL * ref.abs().max().item() + PAGED_ABS, err


def test_decode_plan_splits_by_sms_and_width():
    """The serving shape (B 8 x 8 kv heads) and one long row each split
    the 128-block table; a batch that fills the card alone walks whole
    rows; a split holds at least two batches a warp; past the register
    limit the plan raises."""
    serving = tpa.decode_plan(8, 8, 8, 128, 16, 128, sms=132)
    assert (serving.splits, serving.bps, serving.kb) == (16, 8, 8)
    long_row = tpa.decode_plan(1, 8, 8, 128, 16, 128, sms=132)
    assert (long_row.splits, long_row.bps) == (32, 4)
    assert tpa.decode_plan(256, 8, 8, 128, 16, 128, sms=132).splits == 1
    gqa = tpa.decode_plan(8, 8, 2, 128, 16, 128, sms=132)
    assert (gqa.gp, gqa.kb, gqa.bps * 16) == (4, 4, 32)
    assert tpa.decode_plan(1, 4, 4, 256, 16, 128, sms=132).vpl == 2
    with pytest.raises(BackendError, match="head_dim <= 256"):
        tpa.decode_plan(1, 8, 1, 256, 16, 128, sms=132)
    with pytest.raises(BackendError, match="head_dim <= 256"):
        tpa.decode_plan(1, 4, 4, 320, 16, 128, sms=132)


#: the design against the Pallas kernel: (tables, pos, bps) at the test
#: geometry, with splits of 1 or 2 blocks: rows on a split boundary (the
#: last key of split 0, the first of split 1), a row whose later splits
#: hold no live key, a row past its table (pos < 0 gives 0), padding rows
DESIGN_CASES = {
    "boundaries-bps1": ([[3, 9, 0, 0], [7, 2, 0, 0], [0] * 4, [0] * 4],
                        [BS - 1, BS, 0, 0], 1),
    "dead-splits-bps1": ([[14, 2, 9, 4], [6, 0, 0, 0]], [4 * BS - 1, 3], 1),
    "boundaries-bps2": ([[5, 11, 3, 0], [12, 1, 8, 4]],
                        [2 * BS - 1, 2 * BS], 2),
    "negative-pos": ([[5, 11, 0, 0], [3, 0, 0, 0]], [-1, 4], 1),
}


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_heads", [4, 8])
@pytest.mark.parametrize("case", sorted(DESIGN_CASES))
def test_split_decode_design_matches_pallas(case, n_heads, qdtype):
    tables, pos, bps = DESIGN_CASES[case]
    tables = np.asarray(tables, np.int32)
    pos = np.asarray(pos, np.int32)
    b = tables.shape[0]
    q = _rand((b, n_heads, HD), 11)
    kp, vp = _rand((NB, BS, NKV, HD), 12), _rand((NB, BS, NKV, HD), 13)
    ref = jpp.paged_decode_attn(jnp.asarray(q).astype(qdtype),
                                jnp.asarray(kp), jnp.asarray(vp),
                                jnp.asarray(tables), jnp.asarray(pos))
    kb = 8 if n_heads // NKV <= 2 else 4
    got = _decode_split_design(torch.from_numpy(q).to(getattr(torch, qdtype)),
                               torch.from_numpy(kp), torch.from_numpy(vp),
                               torch.from_numpy(tables),
                               torch.from_numpy(pos), bps, kb)
    _close(got, ref)

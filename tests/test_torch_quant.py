"""The port's W8A8 path (nnstreamer_tpu_torch/models/quant.py and the
quantize_rows kernel's plain version) against the JAX package's
models/quant.py.

The JAX side runs `pallas_ops.quantize_rows` in interpret mode, as
tests/test_quant.py does on the CPU. The port's side runs on CPU tensors,
so its wrapper takes the plain torch version: a CUDA kernel has no CPU
mode, and chip_smoke.py holds the CUDA kernel to the plain version on the
card, bit for bit.

Tolerances: the row quantizer, the weight quantizer and one W8A8 product
are exact (integer sums and the same f32 operations in the same order on
both sides), so they are compared bit for bit. The forward and the decode
step chain many products: a float difference of a few ulps between the
frameworks (rmsnorm, rope, softmax sum in other orders) can flip one
activation across an int8 rounding boundary, which moves a logit by about
one quantization step. Logits are held within 1e-3 * max |ref| and the
greedy tokens must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends import pallas_ops as jops
from nnstreamer_tpu.models import quant as jq
from nnstreamer_tpu.models import transformer as jt
from nnstreamer_tpu_torch.backends import kernels
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import quant as tq
from nnstreamer_tpu_torch.models import transformer as tt

REL = 1e-3        # forward / decode logits, relative to max |ref|
D, H, L, V = 64, 4, 2, 64     # tests/test_quant.py's model


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _bridge(tree):
    return bridge.transformer_params(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def params():
    """(JAX W8A8 params, the port's bridged copy)."""
    jpq = jq.quantize_transformer(jt.init_params(d_model=D, n_heads=H,
                                                 n_layers=L, vocab=V))
    return jpq, _bridge(jpq)


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def _rows(shape, seed=5, zero_row=None):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if zero_row is not None:
        x[zero_row] = 0.0
    return x


# -- quantize_rows ------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((48, 128), "float32"), ((5, 128), "float32"), ((48, 128), "bfloat16"),
    ((3, 100), "float32")], ids=["48x128", "5x128", "48x128-bf16",
                                 "3x100-ragged-k"])
def test_quantize_rows_plain_matches_jax(shape, dtype):
    """Bit for bit against the Pallas kernel in interpret mode: the int8
    rows and the f32 scales, an all-zero row (scale 1, q 0) included."""
    x = jnp.asarray(_rows(shape, zero_row=min(2, shape[0] - 1))).astype(dtype)
    jqx, jsx = jops.quantize_rows(x)
    before = kernels.quantize_rows.launches
    q, s = kernels.quantize_rows(torch.from_numpy(
        np.array(x.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert kernels.quantize_rows.launches == before       # CPU: no launch
    assert q.dtype == torch.int8 and tuple(q.shape) == shape
    assert s.dtype == torch.float32 and tuple(s.shape) == (shape[0], 1)
    assert np.array_equal(q.numpy(), np.asarray(jqx))
    assert _bits_equal(s.numpy(), jsx)
    zero = min(2, shape[0] - 1)
    assert float(s[zero, 0]) == 1.0 and int(q[zero].abs().max()) == 0


#: one case on each path of the CUDA launcher (csrc/quantize_rows.cu,
#: reg_layout; chip_smoke.py phase 11 prints the path each shape takes
#: and holds the kernel to the plain version bit for bit): rows in
#: registers over 4 or 16 warps with 1, 2 or 8 vectors a lane, and the
#: shared-memory path for K not a multiple of the vector width and for
#: rows past the register path; M 1 on both K
QUANT_PATHS = {
    "registers-bf16-K1024": (8, 1024, "bfloat16"),
    "registers-f32-K1024": (8, 1024, "float32"),
    "registers-bf16-K4096": (8, 4096, "bfloat16"),
    "registers-f32-K4096": (8, 4096, "float32"),
    "registers-8-vectors-f32-K12288": (3, 12288, "float32"),
    "shared-f32-K1001-ragged": (5, 1001, "float32"),
    "shared-bf16-K1003-ragged": (5, 1003, "bfloat16"),
    "shared-f32-K20000-long": (2, 20000, "float32"),
    "M1-bf16-K1024": (1, 1024, "bfloat16"),
    "M1-f32-K4096": (1, 4096, "float32"),
}


@pytest.mark.parametrize("case", sorted(QUANT_PATHS))
def test_quantize_rows_launcher_paths_match_jax(case):
    """Bit for bit against the Pallas kernel in interpret mode at each
    path's shape: rows of magnitudes e^-4 .. e^4 and an all-zero row."""
    m, k, dtype = QUANT_PATHS[case]
    rng = np.random.default_rng(k + m)
    x = rng.standard_normal((m, k)) * np.exp(rng.uniform(-4, 4, (m, 1)))
    if m > 1:
        x[m // 2] = 0.0
    x = jnp.asarray(x.astype(np.float32)).astype(dtype)
    jqx, jsx = jops.quantize_rows(x)
    q, s = kernels.quantize_rows(torch.from_numpy(
        np.array(x.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert np.array_equal(q.numpy(), np.asarray(jqx))
    assert _bits_equal(s.numpy(), jsx)


def test_quantize_rows_refuses_other_devices():
    with pytest.raises(BackendError, match="cuda or cpu"):
        kernels.quantize_rows(torch.zeros((2, 8), device="meta"))


# -- weights, the product ------------------------------------------------------

def test_quantize_weight_matches_jax():
    w = np.random.default_rng(0).normal(0, 0.5, (64, 96)).astype(np.float32)
    w[:, 5] = 0.0                                   # all-zero column
    jw, js = jq.quantize_weight(jnp.asarray(w))
    q, s = tq.quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and tuple(s.shape) == (1, 96)
    assert q.stride() == (1, 64)              # column-major, as _int_mm reads
    assert np.array_equal(q.numpy(), np.asarray(jw))
    assert _bits_equal(s.numpy(), js)


def test_quantize_transformer_matches_jax(params):
    """The port quantizing bridged float params == JAX's W8A8 tree
    bridged: the same keys, int8 weights equal, scales bit-equal."""
    jpq, tpq = params
    fp = jt.init_params(d_model=D, n_heads=H, n_layers=L, vocab=V)
    got = tq.quantize_transformer(_bridge(fp))
    assert set(got) == set(tpq) and set(got["blocks"][0]) == set(
        tpq["blocks"][0])
    pairs = [(got[k], tpq[k]) for k in ("embed", "ln_f", "head",
                                        "head_scale")]
    pairs += [(g[k], t[k]) for g, t in zip(got["blocks"], tpq["blocks"])
              for k in t]
    for g, t in pairs:
        assert g.dtype == t.dtype and g.shape == t.shape
        if g.dtype == torch.int8:
            assert torch.equal(g, t)
        else:
            assert _bits_equal(g.numpy(), t.numpy())


@pytest.mark.parametrize("m", [48, 5, 1])
def test_w8a8_matmul_matches_jax(m):
    """One W8A8 product, bit for bit: the same int8 operands, an exact
    integer sum, and the same rescale order."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (m, 128)).astype(np.float32)
    w = rng.normal(0, 0.2, (128, 61)).astype(np.float32)   # vocab-like N
    jw, js = jq.quantize_weight(jnp.asarray(w))
    ref = np.asarray(jq.w8a8_matmul(jnp.asarray(x), jw, js))
    got = tq.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(
        np.asarray(jw)), torch.from_numpy(np.asarray(js)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, 61)
    assert _bits_equal(got.numpy(), ref)


@pytest.mark.parametrize("m,k,n", [(1, 64, 61), (8, 1024, 512),
                                   (5, 12, 7)])
def test_int_mm_operands_pad_to_the_card_rules(m, k, n):
    """The padding the card's torch._int_mm needs (rows > 16, depth and
    width multiples of 8, a column-major weight) leaves the product's
    (M, N) block exact. Run here with the CPU's _int_mm."""
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    xp, wp = tq.int_mm_operands(x, w)
    assert xp.shape[0] > 16 and xp.shape[1] % 8 == 0 and wp.shape[1] % 8 == 0
    assert wp.stride() == (1, wp.shape[0])
    got = torch._int_mm(xp, wp)[:m, :n]
    assert torch.equal(got, x.int() @ w.int())


# -- the forward and the decode step ---------------------------------------------

def _within(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), err
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("attn", ["xla", "pallas"])
def test_apply_seq_w8a8_matches_jax(params, attn):
    """tests/test_quant.py's forward (d 64, 4 heads, 2 layers, B 2, S 64)
    on both attention arms; the pallas arm runs JAX's flash kernel in
    interpret mode and the port's plain flash version, both on bf16
    q/k/v."""
    jpq, tpq = params
    ids = np.random.default_rng(2).integers(0, V, (2, 64), np.int32)
    ref = jq.apply_seq_w8a8(jpq, jnp.asarray(ids), n_heads=H, attn=attn)
    before = (kernels.quantize_rows.launches, kernels.flash_attention.launches)
    got = tq.apply_seq_w8a8(tpq, torch.from_numpy(ids).long(), n_heads=H,
                            attn=attn)
    assert (kernels.quantize_rows.launches,
            kernels.flash_attention.launches) == before
    _within(got, ref)


def test_apply_step_w8a8_matches_jax(params):
    """A teacher-forced greedy rollout of 6 decode steps (f32
    activations): every step's logits against JAX's, the next input the
    JAX argmax fed to both."""
    jpq, tpq = params
    b, max_len = 2, 16
    jkc, jvc, jpos = jt.init_cache(batch=b, max_len=max_len, d_model=D,
                                   n_heads=H, n_layers=L)
    tkc, tvc, tpos = tt.init_cache(batch=b, max_len=max_len, d_model=D,
                                   n_heads=H, n_layers=L)
    ids = np.random.default_rng(3).integers(0, V, (b, 1)).astype(np.int32)
    step = jax.jit(jq.apply_step_w8a8, static_argnames=("n_heads", "dtype"))
    for _ in range(6):
        ref, jkc, jvc, jpos = step(jpq, jnp.asarray(ids), jkc, jvc, jpos,
                                   n_heads=H, dtype=jnp.float32)
        got, tkc, tvc, tpos = tq.apply_step_w8a8(
            tpq, torch.from_numpy(ids).long(), tkc, tvc, tpos, n_heads=H,
            dtype=torch.float32)
        _within(got, ref)
        assert int(tpos[0]) == int(jpos[0])
        ids = np.asarray(ref).argmax(-1).astype(np.int32)[:, None]

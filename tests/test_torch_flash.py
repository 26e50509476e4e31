"""The port's flash attention (nnstreamer_tpu_torch/backends/kernels.py,
its plain version), reference attention and full-sequence forward
(`transformer.apply_seq`) against the JAX package's.

The JAX side runs `pallas_ops.flash_attention` in interpret mode, as
tests/test_pallas.py does on the CPU, at that file's shapes and block
sizes. The port's side runs on CPU tensors, so its wrapper takes the
plain torch version (the whole row's masked softmax): a CUDA kernel has
no CPU mode, and chip_smoke.py holds the CUDA kernel to the plain version
on the card.

Tolerance 2e-4 (rtol and atol, f32), as tests/test_pallas.py holds the
Pallas kernel to its reference: the online softmax rescales its running
sums block by block where the plain version normalises once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends import pallas_ops as jops
from nnstreamer_tpu.models import transformer as jt
from nnstreamer_tpu.parallel import ring_attention as jra
from nnstreamer_tpu_torch.backends import kernels
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import transformer as tt
from nnstreamer_tpu_torch.parallel import ring_attention as tra

TOL = 2e-4


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _qkv(b=2, s=64, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


#: name → (S, causal, block_q, block_k): tests/test_pallas.py's cases
FLASH_CASES = {
    "full": (64, False, 32, 32),
    "causal": (64, True, 32, 32),
    "causal-split-loop": (64, True, 16, 8),       # n_kb = 8: two loops
    "causal-misaligned-diagonal": (128, True, 8, 16),
    "causal-auto-blocks-s640": (640, True, 0, 0),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas(case):
    s, causal, bq, bk = FLASH_CASES[case]
    q, k, v = _qkv(s=s, h=2 if s < 640 else 1)
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal, block_q=bq, block_k=bk)
    before = kernels.flash_attention.launches
    got = kernels.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal, block_q=bq, block_k=bk)
    assert kernels.flash_attention.launches == before     # CPU: no launch
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    _close(got, want)


def test_flash_plain_q_start_slices_rows():
    """The plain version's `q_start` (chip_smoke.py checks the long-S
    kernel on a slice of query rows) equals the same rows of the whole."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(s=64))
    whole = kernels.flash_attention_plain(q, k, v, causal=True)
    part = kernels.flash_attention_plain(q[:, 40:], k, v, causal=True,
                                         q_start=40)
    torch.testing.assert_close(part, whole[:, 40:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("s,bq,bk", [(48, 32, 32), (1001, 0, 0)],
                         ids=["uneven-blocks", "no-block-divides"])
def test_flash_refuses_what_jax_refuses(s, bq, bk):
    q, k, v = _qkv(s=s)
    with pytest.raises(ValueError, match="divisible"):
        jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             block_q=bq, block_k=bk)
    with pytest.raises(ValueError, match="divisible"):
        kernels.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                block_q=bq, block_k=bk)


def test_flash_refuses_other_devices_and_mismatched_operands():
    meta = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(BackendError, match="cuda or cpu"):
        kernels.flash_attention(meta, meta, meta)
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(BackendError, match="one"):
        kernels.flash_attention(q, q[:, :, :1], q)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(causal):
    q, k, v = _qkv(s=32)
    want = jra.reference_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=causal)
    got = tra.reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal)
    _close(got, want, 1e-5)


# -- the full-sequence forward ------------------------------------------------

@pytest.fixture(scope="module")
def params():
    """tests/test_pallas.py's forward: d 32, 2 heads, 2 layers, vocab 64
    (JAX params, the port's bridged copy)."""
    jp = jt.init_params(d_model=32, n_heads=2, n_layers=2, vocab=64)
    return jp, bridge.transformer_params(
        jax.tree_util.tree_map(np.asarray, jp))


@pytest.mark.parametrize("attn", ["pallas", "xla"])
def test_apply_seq_matches_jax(params, attn):
    jp, tp = params
    ids = np.random.default_rng(0).integers(0, 64, (1, 128)).astype(np.int32)
    want = jt.apply_seq(jp, jnp.asarray(ids), n_heads=2, attn=attn)
    got = tt.apply_seq(tp, torch.from_numpy(ids).long(), n_heads=2,
                       attn=attn)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 128, 64)
    _close(got, want)


@pytest.mark.parametrize("s,flash", [(128, True), (96, False)])
def test_apply_seq_auto_takes_flash_on_128_blocks(params, monkeypatch, s,
                                                  flash):
    """attn="auto" takes the flash kernel when S % 128 == 0, else the
    reference attention, as the JAX package's."""
    calls = []
    real = kernels.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(kernels, "flash_attention", spy)
    ids = torch.zeros((1, s), dtype=torch.long)
    tt.apply_seq(params[1], ids, n_heads=2)
    assert len(calls) == (2 if flash else 0)


def test_apply_seq_mesh_waits_for_multi_gpu(params):
    """A mesh runs the attention as a ring over its devices
    (tests/test_torch_ring.py holds it to JAX's); anything but a
    parallel.mesh.Mesh is refused by name."""
    with pytest.raises(BackendError, match="Mesh"):
        tt.apply_seq(params[1], torch.zeros((1, 8), dtype=torch.long),
                     n_heads=2, mesh=object())


# -- the bf16 tensor-core kernel: its variant and its numerical design -------

@pytest.mark.parametrize("dtype,d,variant", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 24, "tc"), (torch.bfloat16, 256, "tc"),
    (torch.float32, 128, "simt"), (torch.float32, 16, "simt"),
    (torch.float32, 4, "simt")])
def test_flash_variant_by_dtype(dtype, d, variant):
    """bf16 → the tensor-core kernel, f32 → the CUDA-core kernel."""
    assert kernels.flash_variant(dtype, d) == variant


@pytest.mark.parametrize("dtype,d", [
    (torch.float16, 128), (torch.bfloat16, 12), (torch.float32, 6),
    (torch.bfloat16, 264), (torch.float32, 0)])
def test_flash_variant_refuses_what_no_kernel_takes(dtype, d):
    with pytest.raises(BackendError):
        kernels.flash_variant(dtype, d)


#: chip_smoke.py phase 12's bf16 rule, element by element: |diff| <=
#: 2^-7 * |plain| + 2^-6 * (rms of plain's row over D)
FLASH_BF16_ULP, FLASH_BF16_ROW = 2 ** -7, 2 ** -6


def _flash_tc_design(q, k, v, causal):
    """The bf16 tensor-core kernel's arithmetic in torch: the head dim
    zero-padded to the kernel's 64, 128 or 256; 64-key tiles; bf16
    operands, so every product is exact in f32 and every sum is f32; l
    sums the f32 p; the P.V product takes p rounded to bf16; out =
    acc / max(l, 1e-20) rounded to bf16."""
    b, s, h, d = q.shape
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    qf, kf, vf = (torch.nn.functional.pad(t, (0, dp - d)).float()
                  .transpose(1, 2) for t in (q, k, v))      # (B, H, S, DP)
    rows = torch.arange(s)
    m = torch.full((b, h, s), -1e30)
    l = torch.zeros(b, h, s)
    acc = torch.zeros(b, h, s, dp)
    for t in range(0, s, 64):
        keys = torch.arange(t, min(t + 64, s))
        sc = qf @ kf[:, :, keys].transpose(-1, -2) * d ** -0.5
        if causal:
            sc = torch.where(keys[None, :] <= rows[:, None], sc,
                             torch.full_like(sc, -1e30))
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(sc <= -1e29, torch.zeros_like(sc),
                        torch.exp(sc - m_new[..., None]))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + \
            p.to(torch.bfloat16).float() @ vf[:, :, keys]
        m = m_new
    out = acc / l.clamp_min(1e-20)[..., None]
    return out[..., :d].transpose(1, 2).to(torch.bfloat16)


#: name → ((B, S, H, D), causal): a causal and a full case, a ragged S, and
#: head dims the kernel pads (24, 40) or takes at its other widths (64, 256)
TC_CASES = {
    "causal": ((2, 256, 2, 128), True),
    "full": ((2, 192, 2, 128), False),
    "d64-ragged-s72": ((2, 72, 2, 64), False),
    "d40-padded-s520-causal": ((1, 520, 2, 40), True),
    "d24-padded": ((2, 128, 2, 24), False),
    "d256-causal": ((1, 128, 2, 256), True),
}


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_bf16_tensor_core_design_holds_plain(case):
    shape, causal = TC_CASES[case]
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    ref = kernels.flash_attention_plain(q, k, v, causal=causal).float()
    got = _flash_tc_design(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    lim = FLASH_BF16_ULP * ref.abs() + FLASH_BF16_ROW * rms
    ratio = ((got.float() - ref).abs() / lim).max().item()
    assert ratio <= 1.0, ratio

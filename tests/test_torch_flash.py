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

"""The port's ring attention (nnstreamer_tpu_torch/parallel/ring_attention,
the `flash_block_update` step in backends/kernels.py, parallel/mesh.py)
and `transformer.apply_seq(mesh=...)` against the JAX package's.

The JAX side runs `pallas_ops.flash_block_update` in interpret mode and
its rings on the 8-device virtual CPU mesh (tests/conftest.py), as
tests/test_parallel.py does. The port's side runs on CPU tensors over
8 logical devices (``[parallel] virtual_devices=8`` on the CPU), so the
kernel wrapper takes its plain version: a CUDA kernel has no CPU mode,
and chip_smoke.py holds the CUDA kernel to the plain version on the
card.

Tolerances: the plain step against JAX's kernel 1e-5 (f32; one block's
softmax, the sums in another order); the rings and the forward 2e-4, as
tests/test_parallel.py holds JAX's rings to its reference.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends import pallas_ops as jops
from nnstreamer_tpu.models import transformer as jt
from nnstreamer_tpu.parallel import MeshSpec as JMeshSpec
from nnstreamer_tpu.parallel import make_mesh as j_make_mesh
from nnstreamer_tpu.parallel import ring_attention as jra
from nnstreamer_tpu_torch.backends import kernels
from nnstreamer_tpu_torch.core.errors import BackendError, PipelineError
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import transformer as tt
from nnstreamer_tpu_torch.parallel import ring_attention as tra
from nnstreamer_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh

STEP_TOL = 1e-5
RING_TOL = 2e-4


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", "8")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- the ring step: flash_block_update ---------------------------------------

def _jax_step(q, k, v, carry, q_off, k_off, causal):
    """JAX's kernel (interpret mode) on the port's (BH, Sq) carry: m and
    l repeated over its 8 sublanes in, row 0 out."""
    m, l, a = carry
    rep = [jnp.asarray(np.repeat(x[:, None, :], 8, axis=1)) for x in (m, l)]
    jm, jl, ja = jops.flash_block_update(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *rep, jnp.asarray(a),
        q_offset=q_off, k_offset=k_off, causal=causal)
    return np.asarray(jm)[:, 0], np.asarray(jl)[:, 0], np.asarray(ja)


def _port_step(q, k, v, carry, q_off, k_off, causal):
    m, l, a = (torch.from_numpy(x.copy()) for x in carry)
    before = kernels.flash_block_update.launches
    out = kernels.flash_block_update(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        m, l, a, q_offset=q_off, k_offset=k_off, causal=causal)
    assert kernels.flash_block_update.launches == before   # CPU: no launch
    assert out[0] is m and out[1] is l and out[2] is a      # in place
    return m.numpy(), l.numpy(), a.numpy()


def _started_carry(bh, sq, d, seed):
    """A carry one non-causal step in (finite m, l > 0)."""
    m, l, a = (x.numpy() for x in kernels.flash_carry_init(bh, sq, d))
    q, k, v = (_rand((bh, sq, d), seed + i) for i in range(3))
    return _port_step(q, k, v, (m, l, a), 0, 0, False)


#: name → (BH, Sq, Sk, q_offset, k_offset, causal): the cases of
#: chip_smoke.py phase 20 at small sizes
STEP_CASES = {
    "full": (4, 32, 32, 0, 0, False),
    "causal-diagonal": (4, 32, 32, 32, 32, True),
    "causal-below": (3, 32, 32, 64, 0, True),
    "causal-above": (3, 32, 32, 0, 32, True),
    "offsets-not-64-multiples": (2, 48, 48, 37, 21, True),
    "sq-ne-sk": (2, 16, 48, 40, 24, True),
    "sq-ne-sk-full": (2, 64, 16, 0, 0, False),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_flash_block_plain_matches_pallas(case):
    bh, sq, sk, q_off, k_off, causal = STEP_CASES[case]
    d = 16
    carry = _started_carry(bh, sq, d, seed=10)
    q = _rand((bh, sq, d), 1)
    k, v = _rand((bh, sk, d), 2), _rand((bh, sk, d), 3)
    want = _jax_step(q, k, v, carry, q_off, k_off, causal)
    got = _port_step(q, k, v, carry, q_off, k_off, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=STEP_TOL, atol=STEP_TOL)
    if case == "causal-above":
        # a block wholly above the diagonal leaves the carry bit for bit
        for g, w, c in zip(got, want, carry):
            assert np.array_equal(g, c) and np.array_equal(w, c)


def test_flash_block_chain_from_init_matches_pallas():
    """Four causal ring steps from `flash_carry_init` (the shard at
    position 1 of a 4-way ring), compared after `flash_carry_finalize`."""
    bh, sl, d = 2, 16, 16
    q = _rand((bh, sl, d), 4)
    blocks = [(_rand((bh, sl, d), 5 + i), _rand((bh, sl, d), 9 + i))
              for i in range(4)]
    m, l, a = (x.numpy() for x in kernels.flash_carry_init(bh, sl, d))
    jc = tc = (m, l, a)
    for step in range(4):
        src = (1 - step) % 4
        k, v = blocks[src]
        jc = _jax_step(q, k, v, jc, sl, src * sl, True)
        tc = _port_step(q, k, v, tc, sl, src * sl, True)
    want = np.asarray(jops.flash_carry_finalize(
        jnp.asarray(np.repeat(jc[1][:, None], 8, axis=1)),
        jnp.asarray(jc[2])))
    got = kernels.flash_carry_finalize(torch.from_numpy(tc[1]),
                                       torch.from_numpy(tc[2])).numpy()
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL)


def test_flash_block_reads_the_rings_strided_view():
    """q/k/v as (B, H, S, D) views of (B, S, H, D) tensors (the ring's
    transposes, not copied) equal the contiguous (BH, S, D) call."""
    b, h, s, d = 2, 2, 32, 16
    q, k, v = (torch.from_numpy(_rand((b, s, h, d), i)) for i in range(3))
    flat = [t.transpose(1, 2).reshape(b * h, s, d) for t in (q, k, v)]
    c1 = kernels.flash_carry_init(b * h, s, d)
    c2 = kernels.flash_carry_init(b * h, s, d)
    kernels.flash_block_update(*(t.transpose(1, 2) for t in (q, k, v)),
                               *c1, q_offset=s, k_offset=0, causal=True)
    kernels.flash_block_update(*flat, *c2, q_offset=s, k_offset=0,
                               causal=True)
    for x, y in zip(c1, c2):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_flash_block_refuses_what_jax_refuses():
    """JAX's shape contract (Sq, Sk divisible by min(128, S)) and the
    carry's layout."""
    q = torch.zeros((2, 192, 16))
    kv = torch.zeros((2, 64, 16))
    m, l, a = kernels.flash_carry_init(2, 192, 16)
    with pytest.raises(ValueError, match="divisible"):
        jops.flash_block_update(
            jnp.zeros((2, 192, 16)), jnp.zeros((2, 64, 16)),
            jnp.zeros((2, 64, 16)), jnp.zeros((2, 8, 192)),
            jnp.zeros((2, 8, 192)), jnp.zeros((2, 192, 16)),
            q_offset=0, k_offset=0, causal=False)
    with pytest.raises(ValueError, match="divisible"):
        kernels.flash_block_update(q, kv, kv, m, l, a, q_offset=0,
                                   k_offset=0, causal=False)
    q = torch.zeros((2, 64, 16))
    m, l, a = kernels.flash_carry_init(2, 64, 16)
    with pytest.raises(BackendError, match="carry m"):
        kernels.flash_block_update(q, kv, kv, m[:, ::2], l, a, q_offset=0,
                                   k_offset=0, causal=False)
    with pytest.raises(BackendError, match="one dtype"):
        kernels.flash_block_update(q, kv.double(), kv, m, l, a,
                                   q_offset=0, k_offset=0, causal=False)
    with pytest.raises(BackendError, match="one device"):
        kernels.flash_block_update(q, kv.to("meta"), kv, m, l, a,
                                   q_offset=0, k_offset=0, causal=False)


# -- the bf16 tensor-core ring step: its variant and its numerical design ------

@pytest.mark.parametrize("dtype,d,variant", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 40, "tc"), (torch.bfloat16, 256, "tc"),
    (torch.float32, 128, "simt"), (torch.float32, 4, "simt")])
def test_flash_block_variant_by_dtype(dtype, d, variant):
    """bf16 → the tensor-core ring kernel, f32 → the CUDA-core one."""
    assert kernels.flash_block_variant(dtype, d) == variant


@pytest.mark.parametrize("dtype,d", [
    (torch.float16, 128), (torch.bfloat16, 12), (torch.float32, 6),
    (torch.bfloat16, 264), (torch.float32, 0)])
def test_flash_block_variant_refuses_what_flash_refuses(dtype, d):
    for pick in (kernels.flash_variant, kernels.flash_block_variant):
        with pytest.raises(BackendError):
            pick(dtype, d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_block_cpu_counts_no_launch(dtype):
    """A CPU tensor takes the plain version: no launch in all or in
    either variant."""
    q = torch.from_numpy(_rand((2, 64, 16), 40)).to(dtype)
    carry = kernels.flash_carry_init(2, 64, 16)
    counts = (kernels.flash_block_update.launches,
              kernels.flash_block_update.launches_tc,
              kernels.flash_block_update.launches_simt)
    kernels.flash_block_update(q, q, q, *carry, q_offset=64, k_offset=0,
                               causal=True)
    assert (kernels.flash_block_update.launches,
            kernels.flash_block_update.launches_tc,
            kernels.flash_block_update.launches_simt) == counts
    assert torch.isfinite(carry[2]).all()


# The CUDA kernel (csrc/flash_attn_tc.cu) cannot run here, so its order of
# operations is emulated in torch: tiles of TK keys, each split over KW key
# warps (TK / KW keys each) with their own (m, l, acc) — key warp 0 from
# the carry, the others from flash_carry_init's values — folded in kw
# order after the walk; m natural, each exponent one FFMA s * (scale *
# log2 e) - m * log2 e (emulated in f64, rounded once), corr and the fold
# factors 2^((m_old - m_new) * log2 e); masked scores -inf; l sums the f32
# p; P.V takes p rounded to bf16. The kernel's skips (a CTA above the
# diagonal, key tiles past a CTA's last row) only drop fully masked work,
# which leaves every value as it is, so the emulation walks every tile.
# It must hold JAX's Pallas kernel (interpret mode) under chip_smoke.py
# phase 12's bf16 rule for the output, and m and l under phase 20's f32
# rule; a row with no live key keeps its carry bit for bit.

#: chip_smoke.py phase 12's bf16 rule: |diff| <= 2^-7 * |ref| + 2^-6 * row
#: rms; phase 20's f32 rule for m and l: 1e-5 * max|ref| + 1e-6
FLASH_BF16_ULP, FLASH_BF16_ROW = 2 ** -7, 2 ** -6
CARRY_REL, CARRY_ABS = 1e-5, 1e-6
LOG2E = np.float32(1.4426950408889634)
#: the kernel's layouts: name → (key warps, keys per tile)
TC_LAYOUTS = {"wide": (1, 64), "split": (8, 128)}


def _ring_tc_design(q, k, v, carry, q_off, k_off, causal, layout):
    """The tensor-core ring step's arithmetic on (BH, S, D) bf16 q, k, v
    and an f32 (m, l, acc) carry → the new carry (copies)."""
    kw_n, tk = TC_LAYOUTS[layout]
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    scale = np.float32(d ** -0.5)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float64)
    qf, kf = q.float(), k.float()
    rows = q_off + torch.arange(sq)
    parts = []
    for kw in range(kw_n):
        if kw == 0:
            m, l, acc = (t.clone() for t in carry)
        else:
            m, l, acc = kernels.flash_carry_init(q.shape[0], sq, d)
        for t0 in range(0, sk, tk):
            keys = torch.arange(t0 + kw * tk // kw_n,
                                min(t0 + (kw + 1) * tk // kw_n, sk))
            if keys.numel() == 0:
                continue
            s = qf @ kf[:, keys].transpose(1, 2)               # raw dots
            if causal:
                live = (k_off + keys)[None, :] <= rows[:, None]
                s = torch.where(live, s, torch.full_like(s, -math.inf))
            m_new = torch.maximum(m, s.amax(-1) * scale)
            corr = torch.exp2((m - m_new) * LOG2E)
            neg = -(m_new * LOG2E)
            p = torch.exp2((s.double() * sl2 + neg.double()[..., None])
                           .float())
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + \
                p.to(torch.bfloat16).float() @ v[:, keys].float()
            m = m_new
        parts.append((m, l, acc))
    m, l, acc = parts[0]
    for m_p, l_p, acc_p in parts[1:]:
        m_new = torch.maximum(m, m_p)
        c_own = torch.exp2((m - m_new) * LOG2E)
        c_part = torch.exp2((m_p - m_new) * LOG2E)
        l = l * c_own + l_p * c_part
        acc = acc * c_own[..., None] + acc_p * c_part[..., None]
        m = m_new
    return m, l, acc


def _bf16(shape, seed):
    return torch.from_numpy(_rand(shape, seed)).to(torch.bfloat16)


def _jax_step_bf16(q, k, v, carry, q_off, k_off, causal):
    """JAX's Pallas kernel (interpret mode) on bf16 q, k, v."""
    m, l, a = (np.asarray(t) for t in carry)
    rep = [jnp.asarray(np.repeat(x[:, None, :], 8, axis=1)) for x in (m, l)]
    qj, kj, vj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    jm, jl, ja = jops.flash_block_update(
        qj, kj, vj, *rep, jnp.asarray(a), q_offset=q_off, k_offset=k_off,
        causal=causal)
    return (torch.from_numpy(np.asarray(jm)[:, 0].copy()),
            torch.from_numpy(np.asarray(jl)[:, 0].copy()),
            torch.from_numpy(np.asarray(ja).copy()))


def _assert_rules(got, want):
    """Output (acc / l) under the bf16 rule, m and l under the f32 one."""
    for g, w in zip(got[:2], want[:2]):
        lim = CARRY_REL * w.abs().max().item() + CARRY_ABS
        assert (g - w).abs().max().item() <= lim
    out, ref = (kernels.flash_carry_finalize(c[1], c[2]) for c in (got, want))
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    lim = FLASH_BF16_ULP * ref.abs() + FLASH_BF16_ROW * rms
    ratio = ((out - ref).abs() / lim).max().item()
    assert ratio <= 1.0, ratio


#: name → (Sq, Sk, q_offset, k_offset, causal, rows with no live key)
TC_STEP_CASES = {
    "full": (256, 256, 0, 0, False, 0),
    # rows 0 .. 39 meet no live key, inside computed tiles of both
    # layouts (the split layout's 32-row CTA 32 .. 63 too)
    "diagonal-dead-rows": (128, 128, 0, 40, True, 40),
    "offsets-not-64-multiples": (256, 128, 37, 100, True, 63),
}


@functools.lru_cache(maxsize=None)
def _tc_step_case(case):
    sq, sk, q_off, k_off, causal, _ = TC_STEP_CASES[case]
    bh, d = 2, 64
    carry = _started_carry(bh, sq, d, seed=50)
    carry = tuple(torch.from_numpy(x) for x in carry)
    q = _bf16((bh, sq, d), 51)
    k, v = _bf16((bh, sk, d), 52), _bf16((bh, sk, d), 53)
    return q, k, v, carry, _jax_step_bf16(q, k, v, carry, q_off, k_off,
                                           causal)


@pytest.mark.parametrize("layout", sorted(TC_LAYOUTS))
@pytest.mark.parametrize("case", sorted(TC_STEP_CASES))
def test_tc_ring_design_holds_pallas(case, layout):
    sq, sk, q_off, k_off, causal, dead = TC_STEP_CASES[case]
    q, k, v, carry, want = _tc_step_case(case)
    got = _ring_tc_design(q, k, v, carry, q_off, k_off, causal, layout)
    _assert_rules(got, want)
    # a row that meets no live key keeps its carry bit for bit, in the
    # design, in JAX's kernel and in the port's plain version
    plain = [t.clone() for t in carry]
    kernels.flash_block_update_plain(q, k, v, *plain, q_offset=q_off,
                                     k_offset=k_off, causal=causal)
    for g, w, p_, c in zip(got, want, plain, carry):
        for t in (g, w, p_):
            assert torch.equal(t[:, :dead].view(torch.int32),
                               c[:, :dead].view(torch.int32))


#: the chain's inputs: q and four 128-key shards (BH 2, D 64)
CHAIN_SL = 128


def _chain_inputs():
    bh, d = 2, 64
    q = _bf16((bh, CHAIN_SL, d), 60)
    blocks = [(_bf16((bh, CHAIN_SL, d), 61 + i),
               _bf16((bh, CHAIN_SL, d), 65 + i)) for i in range(4)]
    return q, blocks


def _chain(step_fn):
    """Four causal steps from flash_carry_init for the shard at position
    1 of a 4-way ring; blocks above the diagonal are skipped, as the
    wrapper's plain version and the kernel skip them."""
    q, blocks = _chain_inputs()
    carry = kernels.flash_carry_init(q.shape[0], CHAIN_SL, q.shape[2])
    for step in range(4):
        src = (1 - step) % 4
        if 2 * CHAIN_SL - 1 < src * CHAIN_SL:
            continue
        carry = step_fn(q, *blocks[src], carry, CHAIN_SL, src * CHAIN_SL,
                        True)
    return carry


@functools.lru_cache(maxsize=None)
def _jax_chain():
    return _chain(_jax_step_bf16)


@pytest.mark.parametrize("layout", sorted(TC_LAYOUTS))
def test_tc_ring_design_chain_from_init_holds_pallas(layout):
    """The chain compared after finalize."""
    got = _chain(lambda *a: _ring_tc_design(*a, layout))
    _assert_rules(got, _jax_chain())


# -- the mesh -------------------------------------------------------------------

def test_mesh_resolves_like_jax():
    for spec in ((-1, 2, 1), (2, 2, 2), (1, 1, 8)):
        dp, tp, sp = spec
        mesh = make_mesh(MeshSpec(dp=dp, tp=tp, sp=sp))
        jmesh = j_make_mesh(JMeshSpec(dp=dp, tp=tp, sp=sp))
        assert mesh.shape == dict(jmesh.shape)
        assert mesh.size == 8
    assert make_mesh(MeshSpec(dp=2, sp=4)).along("sp", {"dp": 1}) == \
        [torch.device("cpu")] * 4
    with pytest.raises(PipelineError, match="at most one"):
        MeshSpec(dp=-1, tp=-1).resolve(8)
    with pytest.raises(PipelineError, match="does not divide"):
        MeshSpec(dp=3, tp=2).resolve(8)


# -- the ring ---------------------------------------------------------------------

#: name → (dp, sp, B, S, causal): the port's both arms per case
RING_CASES = {
    "sp8-full": (1, 8, 2, 64, False),
    "sp4-causal": (1, 4, 1, 64, True),
    "dp2xsp4-causal": (2, 4, 4, 32, True),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_attention_matches_jax(eight_cpu_devices, case):
    dp, sp, b, s, causal = RING_CASES[case]
    q, k, v = (_rand((b, s, 2, 16), 20 + i) for i in range(3))
    batch_axis = "dp" if dp > 1 else None
    jmesh = j_make_mesh(JMeshSpec(dp=dp, tp=1, sp=sp))
    want = np.asarray(jax.jit(lambda q, k, v: jra.ring_attention(
        q, k, v, mesh=jmesh, causal=causal, block_impl="xla",
        batch_axis=batch_axis))(*(jnp.asarray(x) for x in (q, k, v))))
    np.testing.assert_allclose(
        want, np.asarray(jra.reference_attention(
            *(jnp.asarray(x) for x in (q, k, v)), causal=causal)),
        rtol=RING_TOL, atol=RING_TOL)
    mesh = make_mesh(MeshSpec(dp=dp, tp=1, sp=sp))
    before = kernels.flash_block_update.launches
    for impl in ("xla", "pallas", "auto"):
        got = tra.ring_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 mesh=mesh, causal=causal, block_impl=impl,
                                 batch_axis=batch_axis)
        assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RING_TOL,
                                   atol=RING_TOL)
    assert kernels.flash_block_update.launches == before


def test_ring_attention_pallas_block_matches_jax(eight_cpu_devices):
    """Both packages' kernel arms (JAX's in interpret mode, the port's
    plain step) on tests/test_parallel.py's geometry."""
    q, k, v = (_rand((1, 64, 2, 16), 30 + i) for i in range(3))
    jmesh = j_make_mesh(JMeshSpec(dp=1, tp=1, sp=4))
    mesh = make_mesh(MeshSpec(dp=1, tp=1, sp=4))
    for causal in (False, True):
        want = np.asarray(jax.jit(lambda q, k, v: jra.ring_attention(
            q, k, v, mesh=jmesh, causal=causal, block_impl="pallas"))(
                *(jnp.asarray(x) for x in (q, k, v))))
        got = tra.ring_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 mesh=mesh, causal=causal,
                                 block_impl="pallas")
        np.testing.assert_allclose(got.numpy(), want, rtol=RING_TOL,
                                   atol=RING_TOL)


def test_ring_attention_refusals():
    q = torch.zeros((2, 30, 2, 16))
    with pytest.raises(BackendError, match="Mesh"):
        tra.ring_attention(q, q, q, mesh=object())
    mesh = make_mesh(MeshSpec(dp=1, sp=8))
    with pytest.raises(BackendError, match="divide"):
        tra.ring_attention(q, q, q, mesh=mesh)
    with pytest.raises(BackendError, match="block_impl"):
        tra.ring_attention(q, q, q, mesh=mesh, block_impl="triton")
    with pytest.raises(BackendError, match="divide"):
        tra.ring_attention(q[:1, :16], q[:1, :16], q[:1, :16],
                           mesh=make_mesh(MeshSpec(dp=2, sp=4)),
                           batch_axis="dp")


# -- the forward --------------------------------------------------------------------

def test_apply_seq_mesh_matches_jax(eight_cpu_devices):
    """tests/test_parallel.py's long-context forward (d 32, 4 heads, 2
    layers, vocab 64, S 32 over sp 8): the port's apply_seq(mesh=) against
    JAX's on bridged params, and against the port without a mesh."""
    jp = jt.init_params(d_model=32, n_heads=4, n_layers=2, vocab=64)
    tp = bridge.transformer_params(jax.tree_util.tree_map(np.asarray, jp))
    ids = np.random.default_rng(0).integers(0, 64, (1, 32)).astype(np.int32)
    jmesh = j_make_mesh(JMeshSpec(dp=1, sp=8))
    want = np.asarray(jax.jit(lambda p, i: jt.apply_seq(
        p, i, n_heads=4, mesh=jmesh))(jp, jnp.asarray(ids)))
    mesh = make_mesh(MeshSpec(dp=1, sp=8))
    tids = torch.from_numpy(ids).long()
    got = tt.apply_seq(tp, tids, n_heads=4, mesh=mesh)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 32, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=RING_TOL,
                               atol=RING_TOL)
    np.testing.assert_allclose(
        got.numpy(), tt.apply_seq(tp, tids, n_heads=4).numpy(),
        rtol=RING_TOL, atol=RING_TOL)
    assert isinstance(mesh, Mesh) and mesh.shape["sp"] == 8

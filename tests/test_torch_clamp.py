"""clamp_scale and the transform's clamp/stand modes: the port against the
JAX package on the CPU.

- `clamp_scale_plain` (the CUDA kernel's plain version) against the JAX
  package's Pallas `clamp_scale` in interpret mode, bit for bit (NaN
  positions compared, not their payloads): f32, bf16 and f16; scale and
  offset off identity, an offset of exactly +0.0 and -0.0, bounds that
  the dtype cannot hold, lo == hi, NaN, +-inf and -0.0, and data spread
  over 60 binades (where one rounding and two differ).
- Integers: the JAX kernel refuses them (it stores its f32 result into
  an integer output); the port keeps the dtype and clamps to the bounds
  rounded inward, which is also what the negotiated spec of the JAX
  transform says. The JAX host path returns float64 instead: a fault of
  the reference, pinned by `test_integer_clamp_keeps_dtype`.
- tensor_transform mode=clamp and mode=stand, host and fused into a
  filter, against the JAX transform; a framework=pallas clamp filter in
  both packages. stand's host path is the JAX mode's own numpy (equal);
  fused, both sides reduce in f32 in their own order: within 1e-5 on
  O(1) outputs.
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends import pallas_ops
from nnstreamer_tpu.backends.pallas_backend import \
    register_pallas_filter as jax_register
from nnstreamer_tpu.backends.xla import ModelBundle as JBundle
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu_torch.backends import kernels
from nnstreamer_tpu_torch.backends.pallas_backend import \
    register_pallas_filter as port_register
from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle as TBundle
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer as TBuf

BF16 = ml_dtypes.bfloat16
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (BF16, torch.bfloat16),
          "float16": (np.float16, torch.float16)}
SPECIAL = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-30, -1e-30, 3.0, -3.0]
#: (lo, hi, scale, offset)
CASES = {
    "affine": (-1.3, 2.7, 1.1, 0.3),
    "identity": (-1.0, 1.0, 1.0, 0.0),
    "scale-only": (-5.0, 5.0, -2.5, 0.0),
    "offset-only": (-5.0, 5.0, 1.0, 0.125),
    "negative-zero-offset": (-5.0, 5.0, 3.0, -0.0),
    "unrepresentable-bounds": (-1.00390625000001, 1.0004882812500002,
                               0.1, 1e-7),
    "lo-equals-hi": (0.5, 0.5, 2.0, 0.0),
    "signed-zero-bounds": (-0.0, 0.0, 1.0, 0.0),
    "wide-spread": (-1e9, 1e9, 3.0000001, 1e-7),
    "big-offset": (-1e9, 1e9, 1e-5, 12345.678),
}


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16)
    return t.contiguous().numpy()


def assert_bits_equal(got: np.ndarray, ref: np.ndarray) -> None:
    """Equal bit patterns; NaNs only in the same places."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    nan_g = np.isnan(got.astype(np.float32))
    nan_r = np.isnan(ref.astype(np.float32))
    np.testing.assert_array_equal(nan_g, nan_r)
    width = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
    bits = width[got.dtype.itemsize]
    np.testing.assert_array_equal(got[~nan_g].view(bits),
                                  ref[~nan_r].view(bits))


def data(np_dtype, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    spread = 30 if np_dtype != np.float16 else 12
    x = rng.standard_normal(n) * np.exp2(rng.integers(-spread, spread, n))
    x = np.concatenate([np.asarray(SPECIAL), x.astype(np.float32)])
    with np.errstate(over="ignore"):
        return x.astype(np_dtype)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_bit_for_bit(dtype, case):
    np_dt, _ = DTYPES[dtype]
    lo, hi, scale, offset = CASES[case]
    x = data(np_dt)
    ref = np.asarray(pallas_ops.clamp_scale(jnp.asarray(x), lo, hi, scale,
                                            offset))
    got = to_numpy(kernels.clamp_scale_plain(to_torch(x), lo, hi, scale,
                                             offset))
    assert_bits_equal(got, ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wrapper_on_cpu_is_plain_and_counts_no_launch(dtype):
    np_dt, _ = DTYPES[dtype]
    x = to_torch(data(np_dt, n=4087).reshape(-1, 16)[:, 3:11])  # strided
    assert not x.is_contiguous()
    before = kernels.clamp_scale.launches
    got = kernels.clamp_scale(x, -2.0, 2.0, 0.5, 0.25)
    assert kernels.clamp_scale.launches == before
    ref = kernels.clamp_scale_plain(x.contiguous(), -2.0, 2.0, 0.5, 0.25)
    assert_bits_equal(to_numpy(got), to_numpy(ref))


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16", "uint16",
                                   "int32", "int64"])
def test_integer_clamp_keeps_dtype(dtype):
    info = np.iinfo(dtype)
    rng = np.random.default_rng(1)
    x = rng.integers(info.min, info.max, 999, dtype=dtype, endpoint=True)
    lo, hi = -20.5, 100.5
    with pytest.raises(ValueError):   # the JAX kernel refuses integers
        pallas_ops.clamp_scale(jnp.asarray(x), lo, hi)
    got = to_numpy(kernels.clamp_scale(torch.from_numpy(x), lo, hi))
    want = np.clip(x.astype(np.int64), max(info.min, math.ceil(lo)),
                   math.floor(hi)).astype(dtype)
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got, want)


def test_integer_affine_and_unknown_dtype_raise():
    x = torch.arange(10, dtype=torch.uint8)
    with pytest.raises(BackendError, match="pure clamp"):
        kernels.clamp_scale(x, 0.0, 5.0, 2.0, 0.0)
    with pytest.raises(BackendError, match="bool"):
        kernels.clamp_scale(x.bool(), 0.0, 1.0)
    with pytest.raises(BackendError, match="numbers"):
        kernels.clamp_scale(x.float(), math.nan, 1.0)


# -- the transform's clamp and stand modes ---------------------------------

def _run(pkg, buf_cls, desc, frames, model=None, optimize=True):
    pipe = pkg.parse_launch(desc)
    if model is not None:
        pipe.get("f").set_props(model=model)
    runner = pkg.PipelineRunner(pipe, optimize=optimize).start()
    src = pipe.get("src")
    for i, f in enumerate(frames):
        src.push(buf_cls.of(f, pts=i))
    src.end()
    runner.wait(120)
    runner.stop()
    return [np.asarray(b.tensors[0]) for b in pipe.get("out").results]


def _frames(np_dtype, shape=(1, 16, 16, 3), n=2):
    rng = np.random.default_rng(3)
    return [(rng.standard_normal(shape) * 2).astype(np_dtype)
            for _ in range(n)]


def _double_bundles():
    """The same model in both packages: x * 2 (exact), f32."""
    return (JBundle(fn=lambda p, x: x * 2.0, name="double"),
            TBundle(fn=lambda p, x: x * 2.0, name="double"))


TRANSFORMS = {
    "clamp": "tensor_transform mode=clamp option=-1.25:0.75",
    "stand": "tensor_transform mode=stand option=default",
    "stand-per-channel": "tensor_transform mode=stand "
                         "option=default:per-channel",
    "dc-average": "tensor_transform mode=stand option=dc-average",
}


@pytest.mark.parametrize("mode", sorted(TRANSFORMS))
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_transform_host_matches_jax(mode, dtype):
    np_dt, _ = DTYPES[dtype]
    frames = _frames(np_dt)
    desc = (f"appsrc name=src dims=3:16:16:1 types={dtype} ! "
            f"{TRANSFORMS[mode]} ! tensor_sink name=out")
    ref = _run(jnns, JBuf, desc, frames)
    got = _run(tnns, TBuf, desc, frames)
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("mode", sorted(TRANSFORMS))
def test_transform_fused_into_filter_matches_jax(mode):
    frames = _frames(np.float32)
    desc = ("appsrc name=src dims=3:16:16:1 types=float32 ! "
            f"{TRANSFORMS[mode]} ! tensor_filter name=f ! "
            "tensor_sink name=out")
    jb, tb = _double_bundles()
    ref = _run(jnns, JBuf, desc, frames, jb)
    got = _run(tnns, TBuf, desc, frames, tb)
    before = kernels.clamp_scale.launches
    for r, g in zip(ref, got):
        if mode == "clamp":      # exact on both sides
            np.testing.assert_array_equal(g, r)
        else:                    # f32 reductions in two orders
            np.testing.assert_allclose(g, r, atol=1e-5, rtol=0)
    assert kernels.clamp_scale.launches == before   # CPU: plain version


def test_clamp_of_integer_stream_keeps_negotiated_dtype():
    frames = [np.arange(48, dtype=np.uint8).reshape(1, 4, 4, 3) * 5]
    desc = ("appsrc name=src dims=3:4:4:1 types=uint8 ! "
            "tensor_transform mode=clamp option=10.5:100.5 ! "
            "tensor_sink name=out")
    (got,) = _run(tnns, TBuf, desc, frames)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.clip(frames[0], 11, 100))
    # the JAX host path leaves the negotiated uint8 spec for float64
    (ref,) = _run(jnns, JBuf, desc, frames)
    assert ref.dtype == np.float64


def test_pallas_clamp_filter_matches_jax():
    jax_register("clamp_affine_test")(
        lambda ts: tuple(pallas_ops.clamp_scale(t, -1.5, 1.5, 2.0, -0.5)
                         for t in ts))
    port_register("clamp_affine_test")(
        lambda ts: tuple(kernels.clamp_scale(t, -1.5, 1.5, 2.0, -0.5)
                         for t in ts))
    frames = _frames(np.float32)
    desc = ("appsrc name=src dims=3:16:16:1 types=float32 ! tensor_filter "
            "framework=pallas model=clamp_affine_test ! tensor_sink name=out")
    ref = _run(jnns, JBuf, desc, frames)
    got = _run(tnns, TBuf, desc, frames)
    for r, g in zip(ref, got):
        assert_bits_equal(g, r)


@pytest.mark.parametrize("option", ["1.0", "2.0:1.0", "a:b"])
def test_bad_clamp_option_raises(option):
    from nnstreamer_tpu_torch.core.errors import PipelineError
    from nnstreamer_tpu_torch.elements.transform import TransformProgram

    with pytest.raises(PipelineError):
        TransformProgram("clamp", option)

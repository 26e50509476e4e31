"""The port's kernel module (nnstreamer_tpu_torch/backends/kernels.py)
against the JAX package's Pallas kernels.

The JAX side runs the Pallas kernel in interpret mode, as its own tests
do on the CPU. The port's side runs its plain torch version: a CUDA
kernel has no CPU mode, so the kernel itself is held to the plain version
on the card by chip_smoke.py. Tolerance: none — the f32 and bf16 outputs
must match bit for bit (same f32 arithmetic, multiply by the f32
reciprocal, round-to-nearest-even bf16 cast).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends import pallas_ops
from nnstreamer_tpu_torch.backends import cuda_build, kernels
from nnstreamer_tpu_torch.core.errors import BackendError


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


_IN = {
    "uint8": (np.uint8, jnp.uint8),
    "int8": (np.int8, jnp.int8),
    "uint16": (np.uint16, jnp.uint16),
    "int16": (np.int16, jnp.int16),
    "float32": (np.float32, jnp.float32),
}
_OUT = {"float32": (torch.float32, jnp.float32),
        "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _frame(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return (rng.standard_normal(shape) * 100).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, endpoint=True,
                        dtype=dtype)


def _port_out(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


@pytest.mark.parametrize("out", sorted(_OUT))
@pytest.mark.parametrize("in_name", sorted(_IN))
@pytest.mark.parametrize("shape", [(1, 224, 224, 3), (1001,), (7, 13, 3)],
                         ids=["frame", "odd1001", "odd7x13x3"])
def test_normalize_plain_matches_pallas(in_name, out, shape):
    x = _frame(_IN[in_name][0], shape)
    t_out, j_out = _OUT[out]
    ref = np.asarray(pallas_ops.normalize_u8(jnp.asarray(x),
                                             out_dtype=j_out)).astype(np.float32)
    got = _port_out(kernels.normalize_u8(torch.from_numpy(x),
                                         out_dtype=t_out))
    assert got.shape == x.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mean,std", [(0.0, 1.0), (100.0, 3.0), (-7.25, 0.1)])
def test_normalize_plain_matches_pallas_mean_std(mean, std):
    x = _frame(np.uint8, (5, 33, 3), seed=1)
    ref = np.asarray(pallas_ops.normalize_u8(jnp.asarray(x), mean, std))
    got = kernels.normalize_u8(torch.from_numpy(x), mean, std).numpy()
    np.testing.assert_array_equal(got, ref)


def test_normalize_misaligned_slice_matches_pallas():
    base = _frame(np.uint8, (1 + 224 * 3,), seed=2)
    x = base[1:]                     # starts one byte past the allocation
    ref = np.asarray(pallas_ops.normalize_u8(jnp.asarray(x)))
    got = kernels.normalize_u8(torch.from_numpy(base)[1:]).numpy()
    np.testing.assert_array_equal(got, ref)


def test_cpu_tensor_takes_plain_path_and_counts_no_launch():
    before = kernels.normalize_u8.launches
    kernels.normalize_u8(torch.zeros(4, dtype=torch.uint8))
    assert kernels.normalize_u8.launches == before


def test_other_device_raises_instead_of_falling_back():
    x = torch.zeros(4, dtype=torch.uint8, device="meta")
    with pytest.raises(BackendError, match="cuda or cpu"):
        kernels.normalize_u8(x)


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_HOME",
                        str(tmp_path / "no-cuda-either"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_BUILD_KERNEL_DIR",
                       str(tmp_path / "kernels"))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    with pytest.raises(BackendError, match="nvcc not found"):
        cuda_build.find_nvcc()
    with pytest.raises(BackendError, match="does not fall back"):
        cuda_build.load("normalize.cu", {})
    assert not (tmp_path / "kernels").exists() or not any(
        (tmp_path / "kernels").glob("*.so"))


def test_kernel_library_is_keyed_by_source_and_flags(monkeypatch, tmp_path):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_BUILD_KERNEL_DIR", str(tmp_path))
    a = cuda_build.library_path("normalize.cu")
    assert a.parent == tmp_path and a.name.startswith("normalize-")
    assert a == cuda_build.library_path("normalize.cu")
    assert a != cuda_build.library_path("normalize.cu", ["-O2"])


def test_default_kernel_dir_is_gitignored_build_dir(monkeypatch):
    monkeypatch.delenv("NNSTREAMER_TPU_TORCH_BUILD_KERNEL_DIR", raising=False)
    d = cuda_build.kernel_dir()
    assert d.parts[-2:] == ("build", "torch_kernels")
    assert (d.parent.parent / "nnstreamer_tpu_torch").is_dir()

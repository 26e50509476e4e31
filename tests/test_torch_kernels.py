"""The port's kernel module (nnstreamer_tpu_torch/backends/kernels.py)
against the JAX package's Pallas kernels.

The JAX side runs the Pallas kernel in interpret mode, as its own tests
do on the CPU. The port's side runs its plain torch version: a CUDA
kernel has no CPU mode, so the kernel itself is held to the plain version
on the card by chip_smoke.py. Tolerance: none — the f32 and bf16 outputs
must match bit for bit (same f32 arithmetic, multiply by the f32
reciprocal, round-to-nearest-even bf16/f16 cast).

The launch path (`cuda_build.Launcher`) is held here with stand-ins for
the C launcher and torch's CUDA hooks, and every wrapper module is read
(AST) for per-call work that the shared launch path replaced.
"""

import ast
import ctypes
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends import pallas_ops
from nnstreamer_tpu_torch.backends import cuda_build, kernels
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.tensor.dtypes import DType, host_tensor


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
        "bfloat16": (torch.bfloat16, jnp.bfloat16),
        "float16": (torch.float16, jnp.float16)}
#: the other dtypes a tensor stream carries (the JAX package runs with
#: x64 off: it narrows 64-bit integers to 32 bits and f64 to f32 on entry,
#: so 64-bit integers are drawn inside the int32 range)
_IN_WIDE = {"int32": np.int32, "uint32": np.uint32, "int64": np.int64,
            "uint64": np.uint64, "float16": np.float16,
            "bfloat16": ml_dtypes.bfloat16, "float64": np.float64}
_UINT_OF_SIZE = {2: np.uint16, 4: np.uint32, 8: np.uint64}


def _frame(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == ml_dtypes.bfloat16 or np.issubdtype(dtype, np.floating):
        return (rng.standard_normal(shape) * 100).astype(dtype)
    info = np.iinfo(dtype)
    if info.bits == 64:
        lo = max(info.min, np.iinfo(np.int32).min)
        return rng.integers(lo, np.iinfo(np.int32).max, size=shape,
                            endpoint=True).astype(dtype)
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


@pytest.mark.parametrize("out", sorted(_OUT))
@pytest.mark.parametrize("in_name", sorted(_IN_WIDE))
@pytest.mark.parametrize("shape", [(1001,), (7, 13, 3)],
                         ids=["odd1001", "odd7x13x3"])
def test_normalize_plain_matches_pallas_wide_dtypes(in_name, out, shape):
    """F4's dtypes: every other dtype a stream carries in, f16 out too —
    bit for bit (the outputs compared as their bits)."""
    x = _frame(_IN_WIDE[in_name], shape, seed=3)
    t_out, j_out = _OUT[out]
    ref = np.asarray(pallas_ops.normalize_u8(jnp.asarray(x),
                                             out_dtype=j_out))
    got = kernels.normalize_u8(host_tensor(x), out_dtype=t_out)
    assert got.dtype == t_out and tuple(got.shape) == x.shape
    got = got.view(torch.int16) if t_out == torch.bfloat16 else got
    bits = _UINT_OF_SIZE[ref.dtype.itemsize]
    np.testing.assert_array_equal(got.numpy().view(bits), ref.view(bits))


def test_normalize_kernel_tables_cover_every_stream_dtype():
    """F4 without a card: the CUDA wrapper's type tables hold every dtype
    a TensorsSpec carries that the plain version takes in, and every
    float dtype out; a non-float out dtype raises on both paths."""
    x = torch.arange(6)
    for d in DType:
        dt = d.torch_dtype
        kernels.normalize_u8_plain(x.to(dt))          # the plain path takes it
        assert dt in kernels._NORM_IN, dt
        if d.is_float:
            kernels.normalize_u8_plain(x, out_dtype=dt)
            assert dt in kernels._NORM_OUT, dt
        else:
            with pytest.raises(BackendError, match="normalize_u8 writes"):
                kernels.normalize_u8(x.to(torch.uint8), out_dtype=dt)
    codes = list(kernels._NORM_IN.values())
    assert sorted(codes) == list(range(len(DType)))
    assert sorted(kernels._NORM_OUT.values()) == [0, 1, 2, 3]


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


# -- the launch path ----------------------------------------------------------

_WRAPPER_MODULES = [Path(kernels.__file__),
                    Path(kernels.__file__).with_name("paged_attn.py")]


def _called(node: ast.Call) -> str:
    return ast.unparse(node.func)


@pytest.mark.parametrize("path", _WRAPPER_MODULES, ids=lambda p: p.name)
def test_wrappers_launch_only_through_the_shared_path(path):
    """No wrapper builds a Stream object, enters a device context, loads
    a library, imports the builder or makes a ctypes array type on its
    per-call path: a launch goes through a module-level Launcher."""
    tree = ast.parse(path.read_text())
    banned = ("torch.cuda.current_stream", "torch.cuda.device",
              "cuda_build.load", "cuda_build.check")
    launchers = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            assert _called(node) not in banned, (
                f"{path.name}:{node.lineno} calls {_called(node)}")
            if _called(node) == "Launcher":
                launchers.append(node)
    for fn in (n for n in ast.walk(tree) if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef))):
        for node in ast.walk(fn):
            assert not isinstance(node, (ast.Import, ast.ImportFrom)), (
                f"{path.name}:{node.lineno} imports inside {fn.name}")
            assert not (isinstance(node, ast.BinOp) and isinstance(
                node.op, ast.Mult) and "ctypes." in ast.unparse(node)), (
                f"{path.name}:{node.lineno} makes a ctypes array type in "
                f"{fn.name}")
            assert not (isinstance(node, ast.Call)
                        and _called(node) == "Launcher"), (
                f"{path.name}:{node.lineno} makes a Launcher per call")
    assert launchers, f"{path.name} has no Launcher"


class _Stand:
    """A stand-in C launcher: records its arguments, returns `err`."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def hooks(monkeypatch):
    """Stand-ins for torch's CUDA hooks: the thread is on device 0, each
    device's current stream is 1000 + its index; device switches are
    recorded."""
    switches = []
    monkeypatch.setattr(cuda_build, "_thread_device", lambda: 0)
    monkeypatch.setattr(cuda_build, "_raw_stream", lambda i: 1000 + i)
    monkeypatch.setattr(torch.cuda, "_exchange_device",
                        lambda i: switches.append(("to", i)) or 0)
    monkeypatch.setattr(torch.cuda, "_maybe_exchange_device",
                        lambda i: switches.append(("back", i)) or i)
    return switches


def _launcher(err):
    launcher = cuda_build.Launcher("normalize.cu", "nns_normalize",
                                   [ctypes.c_void_p, ctypes.c_int],
                                   "normalize_u8")
    launcher.fn = _Stand(err)
    launcher.error_string = lambda e: b"an illegal memory access"
    return launcher


def test_launcher_raises_with_kernel_name_on_cuda_error(hooks):
    launcher = _launcher(700)
    with pytest.raises(BackendError, match=r"^normalize_u8: CUDA error 700 "
                                           r"\(an illegal memory access\)"):
        launcher(0, 16, 3)
    assert launcher.fn.calls == [(16, 3, 1000)]      # the stream goes last
    assert hooks == []


def test_launcher_passes_stream_and_switches_device_only_when_needed(hooks):
    launcher = _launcher(0)
    launcher(0, 1, 2)
    launcher(0, 1, 2, stream=77)
    assert hooks == []
    launcher(2, 5, 6)                                  # another device
    assert launcher.fn.calls == [(1, 2, 1000), (1, 2, 77), (5, 6, 1002)]
    assert hooks == [("to", 2), ("back", 0)]
    bad = _launcher(1)
    with pytest.raises(BackendError, match="normalize_u8: CUDA error 1"):
        bad(3, 0, 0)
    assert hooks[2:] == [("to", 3), ("back", 0)]       # restored on error


def test_launcher_declares_signature_with_trailing_stream():
    launcher = cuda_build.Launcher("quantize_rows.cu", "nns_quantize_rows",
                                   [ctypes.c_void_p], "quantize_rows")
    assert launcher.argtypes == [ctypes.c_void_p, ctypes.c_void_p]
    assert launcher.fn is None                     # nothing built at import
    layout = kernels._QUANTIZE_LAYOUT
    assert layout.argtypes[-1] is not ctypes.c_void_p   # no stream

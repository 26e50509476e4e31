"""Half and bfloat16 streams through the port against the JAX package.

- A host bfloat16 array enters a filter unfused: the port stages it
  through its int16 bits (`tensor.dtypes.host_tensor`); torch.from_numpy
  refuses ml_dtypes' bfloat16.
- Arithmetic on a float16/bfloat16 tensor rounds its scalar operand to
  the tensor's dtype first, as numpy (both packages' host path) and jnp
  (the JAX device path) round a weak-typed Python float.

The filter's model is the identity, so the sink sees the transform's
output. bfloat16 chains equal the JAX package's bit for bit, fused into
the filter and not. For float16, the JAX package's fused chain rounds
once (XLA on the CPU computes the chain in f32 with f16-rounded
constants) where its host path rounds after each op; the port rounds
after each op on both paths, so it is held to the JAX host path.
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu_torch.tensor.dtypes import host_tensor

SRC = ("videotestsrc num-buffers=2 width=8 height=6 pattern=random seed=3 "
       "! tensor_converter")
TAIL = "tensor_filter name=f ! tensor_sink name=out"
CHAIN = "tensor_transform mode=arithmetic option=typecast:{},mul:0.37,add:-3.3"


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _run(pkg, desc, optimize):
    pipe = pkg.parse_launch(desc)
    pipe.get("f").set_props(model=lambda x: x)
    pkg.PipelineRunner(pipe, optimize=optimize).run(60)
    return [np.asarray(b.tensors[0]) for b in pipe.get("out").results]


def _bits(a):
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _assert_bit_equal(got, ref, dtype):
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert str(g.dtype) == str(r.dtype) == dtype
        assert g.shape == r.shape == (1, 6, 8, 3)
        np.testing.assert_array_equal(_bits(g), _bits(r))


@pytest.mark.parametrize("pipeline", ["typecast", "arithmetic"])
def test_unfused_bf16_stream_enters_filter(pipeline):
    body = ("tensor_transform mode=typecast option=bfloat16"
            if pipeline == "typecast" else CHAIN.format("bfloat16"))
    desc = f"{SRC} ! {body} ! {TAIL}"
    _assert_bit_equal(_run(tnns, desc, False), _run(jnns, desc, False),
                      "bfloat16")


@pytest.mark.parametrize("optimize", [True, False], ids=["fused", "unfused"])
def test_bf16_chain_rounds_scalars_like_jax(optimize):
    desc = f"{SRC} ! {CHAIN.format('bfloat16')} ! {TAIL}"
    _assert_bit_equal(_run(tnns, desc, optimize), _run(jnns, desc, optimize),
                      "bfloat16")


@pytest.mark.parametrize("optimize", [True, False], ids=["fused", "unfused"])
def test_f16_chain_follows_jax_host_path(optimize):
    desc = f"{SRC} ! {CHAIN.format('float16')} ! {TAIL}"
    # the JAX host path: the transform unfused, on numpy
    _assert_bit_equal(_run(tnns, desc, optimize), _run(jnns, desc, False),
                      "float16")


def test_f32_chain_unchanged_by_scalar_rounding():
    """f32 keeps computing with the f32-rounded scalar: the tensor path
    equals the Python-scalar arithmetic it replaced, bit for bit."""
    from nnstreamer_tpu_torch.elements.transform import TransformProgram

    x = np.random.default_rng(0).integers(0, 256, (4, 33)).astype(np.float32)
    prog = TransformProgram("arithmetic", "mul:0.37,add:-3.3,div:127.5")
    got = prog.apply(torch.from_numpy(x)).numpy()
    want = ((torch.from_numpy(x) * 0.37 + -3.3) / 127.5).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_host_tensor_shares_bf16_bits():
    import ml_dtypes

    a = np.array([[1.5, -2.25], [3e38, 1e-40]], ml_dtypes.bfloat16)
    t = host_tensor(a)
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
    f = np.arange(6, dtype=np.float16)[::2]      # not contiguous
    assert host_tensor(f).dtype == torch.float16
    np.testing.assert_array_equal(host_tensor(f).numpy(), f)

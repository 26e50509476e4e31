"""TorchScript (.pt) ingestion in the port
(nnstreamer_tpu_torch/modelio/torchscript.py) against the JAX package's
loader and against `torch.jit.load`, on the CPU.

Every test of `tests/test_torchscript.py` that runs without the
reference's model files is copied (the convnets, shape ops, the traced
module, multi-output, chunk / ceil avgpool, conv-transpose / upsample,
the refusals; the recurrent and attention models are in
`test_torch_torchscript_nn.py`), without wall-clock bounds. Each archive
runs through the port and through the JAX loader (jitted) on the same
seeded inputs, f32, within 1e-5·max|y| + 1e-6, and through
`torch.jit.load` at the JAX test's own tolerance. Then:

- the legacy archive (`tools/model_fixtures.write_legacy_lenet5`, the
  reference's `pytorch_lenet5.pt` layout): torch refuses it, the port
  and the JAX loader give the same uint8 softmax bit for bit;
- the recorded call list: later calls of an input signature replay it,
  bit for bit the walk, one record a signature;
- `custom=dtype=bfloat16`: labels equal the f32 run's;
- the refusals of a data-dependent branch (the JAX loader's text, also
  where JAX stops in its own `bool()`), of an unknown op and of a
  non-archive;
- in-place ops: inputs and params are never written;
- int64 indices where JAX gives int32 (ROADMAP N12);
- `framework=pytorch` and extension auto-detect through a pipeline,
  against the JAX pipeline;
- config 1's network as a traced archive (`write_torchscript_mbv2`,
  0.35 at 64²) against `zoo://mobilenet_v2`, the JAX loader and torch.
"""

import zipfile

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as F

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.core.errors import BackendError as JBackendError
from nnstreamer_tpu.modelio import load_model_file as jload
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JTensorBuffer
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio import load_model_file
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tools import model_fixtures as mf


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _port(bundle, *xs):
    return [o.numpy() for o in bundle.fn(
        bundle.params, *[torch.from_numpy(x) for x in xs])]


def _jax(path, *xs, dtype="float32"):
    jb = jload(path, compute_dtype=dtype)
    return [np.asarray(o) for o in jax.jit(
        lambda p, *a: jb.fn(p, *a))(jb.params, *xs)]


def _near(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = 1e-5 * float(np.abs(want).max()) + 1e-6
    assert float(np.abs(got - want).max()) <= tol


def _hold(path, *xs, rtol=1e-4, atol=1e-5):
    """The port's outputs against the JAX loader's (1e-5·max|y| + 1e-6)
    and torch.jit.load's (the JAX test's tolerance) → the port's."""
    got = _port(load_model_file(path), *xs)
    want = _jax(path, *xs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _near(g, w)
    with torch.no_grad():
        ref = torch.jit.load(path)(*[torch.from_numpy(x) for x in xs])
    refs = ref if isinstance(ref, (tuple, list)) else (ref,)
    assert len(refs) == len(got)
    for g, r in zip(got, refs):
        np.testing.assert_allclose(g, r.numpy(), rtol=rtol, atol=atol)
    return got


def _script(tmp_path, model, name="m.pt"):
    path = str(tmp_path / name)
    torch.jit.save(torch.jit.script(model.eval()), path)
    return path


# -- copies of tests/test_torchscript.py ---------------------------------------

class _ConvNet(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 8, 3, stride=2, padding=1)
        self.bn = tnn.BatchNorm2d(8)
        self.conv2 = tnn.Conv2d(8, 16, 3, padding=1, groups=2)
        self.fc = tnn.Linear(16 * 4 * 4, 5)

    def forward(self, x):
        x = torch.relu(self.bn(self.conv1(x)))
        x = torch.max_pool2d(self.conv2(x), 2, 2)
        x = x.reshape(x.shape[0], -1)
        return torch.log_softmax(self.fc(x), dim=1)


def _convnet():
    torch.manual_seed(0)
    net = _ConvNet().eval()
    with torch.no_grad():          # BN statistics that are not identity
        net.bn.running_mean.uniform_(-0.5, 0.5)
        net.bn.running_var.uniform_(0.5, 2.0)
    return net


def test_torch_scripted_convnet_matches_torch_and_jax(tmp_path):
    path = _script(tmp_path, _convnet())
    x = np.random.RandomState(0).randn(2, 3, 16, 16).astype(np.float32)
    _hold(path, x)


def test_torch_scripted_shape_ops_match_torch_and_jax(tmp_path):
    class Net(tnn.Module):
        def forward(self, x):
            a = x.permute(0, 2, 1)
            b = torch.cat([a, a * 2.0], dim=1)
            c = b[:, 1:5, :]
            d = F.pad(c, [1, 2], value=0.5)
            return torch.tanh(d).flatten(1)

    x = np.random.RandomState(1).randn(2, 6, 5).astype(np.float32)
    _hold(_script(tmp_path, Net()), x, rtol=1e-5, atol=1e-6)


def test_torch_traced_module_matches_torch_and_jax(tmp_path):
    torch.manual_seed(1)
    net = tnn.Sequential(
        tnn.Conv2d(1, 4, 3, padding=1), tnn.ReLU(),
        tnn.AdaptiveAvgPool2d((1, 1)), tnn.Flatten(),
        tnn.Linear(4, 3), tnn.Sigmoid()).eval()
    path = str(tmp_path / "traced.pt")
    torch.jit.save(torch.jit.trace(net, torch.zeros(1, 1, 8, 8)), path)
    x = np.random.RandomState(2).randn(1, 1, 8, 8).astype(np.float32)
    _hold(path, x)


def test_torch_multi_output_tuple(tmp_path):
    class Net(tnn.Module):
        def forward(self, x):
            return torch.mean(x, dim=1), torch.topk(x, 2, dim=1)[0]

    x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    outs = _hold(_script(tmp_path, Net()), x, rtol=1e-6, atol=0)
    assert len(outs) == 2


def test_torch_chunk_and_ceil_avgpool_match_torch_and_jax(tmp_path):
    """torch.chunk's ceil-sized split (7/3 -> [3,3,1]) and AvgPool2d
    ceil_mode+count_include_pad divisor semantics."""
    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.pool = tnn.AvgPool2d(3, stride=2, padding=1,
                                      ceil_mode=True)

        def forward(self, x):
            a, b, c = torch.chunk(x, 3, dim=1)
            return self.pool(a + b[:, :a.shape[1]]), c

    x = np.random.RandomState(4).randn(1, 7, 6, 6).astype(np.float32)
    outs = _hold(_script(tmp_path, Net()), x, rtol=1e-5, atol=1e-6)
    assert outs[1].shape == (1, 1, 6, 6)


@pytest.mark.parametrize("count_include_pad", [False, True])
def test_torch_avgpool_divisors_match_torch_and_jax(tmp_path,
                                                    count_include_pad):
    """Both divisor rules under ceil_mode, with an overhang window."""
    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.pool = tnn.AvgPool2d(3, stride=2, padding=1,
                                      ceil_mode=True,
                                      count_include_pad=count_include_pad)

        def forward(self, x):
            return self.pool(x)

    x = np.random.RandomState(14).randn(1, 2, 8, 7).astype(np.float32)
    _hold(_script(tmp_path, Net()), x, rtol=1e-5, atol=1e-6)


def test_torch_conv_transpose_and_upsample_match_torch_and_jax(tmp_path):
    """ConvTranspose2d with bias and anisotropic nearest upsampling."""
    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.up = tnn.ConvTranspose2d(6, 3, 4, stride=2, padding=1,
                                          bias=True)

        def forward(self, x):
            y = torch.relu(self.up(x))
            return F.interpolate(y, scale_factor=(2.0, 3.0),
                                 mode="nearest")

    torch.manual_seed(5)
    x = np.random.RandomState(5).randn(1, 6, 5, 7).astype(np.float32)
    _hold(_script(tmp_path, Net()), x)


@pytest.mark.parametrize("size", [(5, 9), (13, 4)])
def test_torch_bilinear_resize_matches_jax(tmp_path, size):
    """upsample_bilinear2d up in one axis and down in the other: the JAX
    lowering resizes with jax.image.resize (antialiased downsampling), the
    port with F.interpolate(antialias=True); half-pixel nearest too."""
    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.h, self.w = size

        def forward(self, x):
            a = F.interpolate(x, size=[self.h, self.w], mode="bilinear",
                              align_corners=False)
            b = F.interpolate(x, size=[self.h, self.w], mode="nearest")
            return a, b

    path = _script(tmp_path, Net())
    x = np.random.RandomState(15).randn(1, 2, 8, 7).astype(np.float32)
    got = _port(load_model_file(path), x)
    for g, w in zip(got, _jax(path, x)):
        _near(g, w)


def test_torch_unsupported_op_fails_loud(tmp_path):
    """An op outside the table raises BackendError naming the op, with
    the JAX loader's text but for the lowering's name."""
    class Net(tnn.Module):
        def forward(self, x):
            return torch.lgamma(x)

    path = _script(tmp_path, Net())
    x = np.zeros((2, 2), np.float32)
    with pytest.raises(BackendError, match="lgamma") as got:
        _port(load_model_file(path), x)
    with pytest.raises(JBackendError) as want:
        _jax(path, x)
    assert str(got.value) == str(want.value).replace(
        "the jax lowering", "the torch lowering")


def test_torch_not_an_archive_fails_loud(tmp_path):
    p = tmp_path / "junk.pt"
    p.write_bytes(b"not a zip at all")
    with pytest.raises(BackendError, match="TorchScript") as got:
        load_model_file(str(p))
    with pytest.raises(JBackendError) as want:
        jload(str(p))
    assert str(got.value) == str(want.value)


# -- the legacy archive ----------------------------------------------------------

@pytest.fixture(scope="module")
def lenet5(tmp_path_factory):
    path = tmp_path_factory.mktemp("legacy") / "lenet5.pt"
    mf.write_legacy_lenet5(path, seed=3)
    return str(path)


def _digits(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 1, 28, 28, 1)).astype(np.uint8)


def test_torch_legacy_archive_refused_by_torch(lenet5):
    """torch cannot load the legacy format, so the AST path carries it."""
    with pytest.raises(RuntimeError):
        torch.jit.load(lenet5)


def test_torch_legacy_lenet5_matches_jax_bit_for_bit(lenet5):
    b = load_model_file(lenet5)
    for x in _digits(4, 0):
        (got,) = _port(b, x)
        (want,) = _jax(lenet5, x)
        assert got.shape == (1, 10) and got.dtype == np.uint8
        assert want.dtype == np.uint8
        assert got.tobytes() == want.tobytes()


def test_torch_legacy_lenet5_bfloat16(lenet5):
    """custom=dtype=bfloat16: the labels of the f32 run; within 2 of the
    JAX loader's bf16 uint8 outputs (bf16's spacing is 1 from 128 to 255,
    and the two lowerings round their convolutions' sums in different
    orders)."""
    f32 = load_model_file(lenet5)
    bf16 = load_model_file(lenet5, compute_dtype="bfloat16")
    for x in _digits(4, 0):
        (a,) = _port(f32, x)
        (got,) = _port(bf16, x)
        (want,) = _jax(lenet5, x, dtype="bfloat16")
        assert got.dtype == want.dtype == np.uint8
        assert got.argmax() == a.argmax()
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 2


# -- the recorded call list --------------------------------------------------

def test_torch_record_replays_walk_bit_for_bit(tmp_path):
    """The first call of a signature walks and records; later calls
    replay the record: outputs bit for bit the walk's, one record a
    signature (shape, dtype, device), no record for the walk alone."""
    b = load_model_file(_script(tmp_path, _convnet()))
    fn = b.fn
    rng = np.random.RandomState(6)
    for n in (2, 3):
        for _ in range(3):
            x = torch.from_numpy(rng.randn(n, 3, 16, 16).astype(np.float32))
            walked = fn.walk(b.params, x)
            replayed = fn(b.params, x)
            assert all(torch.equal(a, c) for a, c in zip(walked, replayed))
    assert len(fn.tapes) == 2
    tape = next(iter(fn.tapes.values()))
    # conv, BN, relu, conv, pool, reshape, linear, log_softmax
    assert tape.calls == 8 and "del" in tape.source


def test_torch_record_folds_calls_without_inputs(tmp_path):
    """A mask made from constants alone is computed when the call list
    is recorded and kept; the replay runs only the calls that read an
    input or a parameter."""
    class Net(tnn.Module):
        def forward(self, x):
            m = torch.ones([4, 4]) * 2.0
            return x * m + torch.arange(4).float()

    path = _script(tmp_path, Net())
    b = load_model_file(path)
    x = np.random.RandomState(7).randn(4, 4).astype(np.float32)
    first = _port(b, x)
    again = _port(b, x)
    assert first[0].tobytes() == again[0].tobytes()
    _near(first[0], _jax(path, x)[0])
    tape = next(iter(b.fn.tapes.values()))
    assert tape.calls == 2          # mul, add: ones/mul/arange/float fold


# -- bfloat16 ------------------------------------------------------------------

@pytest.fixture(scope="module")
def mbv2_pt(tmp_path_factory):
    from nnstreamer_tpu_torch.models.mobilenet_v2 import build

    path = tmp_path_factory.mktemp("mbv2") / "mbv2.pt"
    model = build(width=0.35, input_size=64, dtype="float32", seed=0).params
    mf.write_torchscript_mbv2(model, path, input_size=64)
    return str(path), model


def _frames(n, seed, size=64):
    return np.random.default_rng(seed).normal(
        0, 1, (n, 1, size, size, 3)).astype(np.float32)


def test_torch_bfloat16_labels_equal_f32(mbv2_pt):
    """custom=dtype=bfloat16 (params stored in bf16; the traced casts to
    float32 compute in f32, as in the JAX lowering): labels equal the f32
    run's, and the JAX loader's bf16 labels."""
    path, _ = mbv2_pt
    f32 = load_model_file(path)
    bf16 = load_model_file(path, compute_dtype="bfloat16")
    assert all(v.dtype == torch.bfloat16 for v in bf16.params.values()
               if v.is_floating_point())
    for x in _frames(4, 8):
        (a,) = _port(f32, x)
        (b,) = _port(bf16, x)
        (j,) = _jax(path, x, dtype="bfloat16")
        assert a.argmax() == b.argmax() == j.argmax()
        _near(b, j)


# -- refusals and semantics ----------------------------------------------------

class _Branchy(tnn.Module):
    def forward(self, x):
        if x.sum() > 0:
            return x * 2
        return x - 1


def _unbool(path, out):
    """The archive with its `if bool(cond):` rewritten `if cond:` (a
    branch straight on a tensor, as hand-written TorchScript has it)."""
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(out, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename.endswith(".py"):
                src = data.decode()
                assert "if bool(torch.gt(" in src
                data = src.replace("if bool(torch.gt(torch.sum(x), 0)):",
                                   "if torch.gt(torch.sum(x), 0):").encode()
            zout.writestr(item, data)
    return out


def test_torch_data_dependent_branch_refused_with_jax_text(tmp_path):
    """A branch on a tensor is refused on the host, before any result,
    with the JAX loader's text: the JAX loader refuses it under jit (its
    `_host_bool`, or JAX itself inside `bool()`); eager torch would read
    the value back from the device and decide per frame."""
    path = _script(tmp_path, _Branchy())
    x = np.ones((2, 2), np.float32)
    with pytest.raises(BackendError,
                       match="data-dependent control flow") as scripted:
        _port(load_model_file(path), x)
    with pytest.raises(jax.errors.TracerBoolConversionError):
        _jax(path, x)
    bare = _unbool(path, str(tmp_path / "bare.pt"))
    with pytest.raises(BackendError) as got:
        _port(load_model_file(bare), x)
    with pytest.raises(JBackendError) as want:
        _jax(bare, x)
    assert str(got.value) == str(want.value) == str(scripted.value)


def test_torch_in_place_ops_leave_inputs_and_params_unchanged(tmp_path):
    """add_, relu_, clamp_, unsqueeze_ and mul_ (on a parameter) compute
    new tensors: the input frame and the params are never written, every
    call gives the same outputs, equal to the JAX lowering's."""
    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.bias = tnn.Parameter(torch.full((4,), 0.25))

        def forward(self, x):
            y = x.add_(1.0)
            z = torch.relu_(y)
            z = z.clamp_(0.0, 2.0)
            b = self.bias.mul_(2.0)
            return z.unsqueeze_(0) + b

    path = _script(tmp_path, Net())
    b = load_model_file(path)
    x = torch.from_numpy(
        np.random.RandomState(8).randn(3, 4).astype(np.float32))
    x0 = x.clone()
    p0 = {k: v.clone() for k, v in b.params.items()}
    outs = [b.fn(b.params, x)[0] for _ in range(3)]
    assert torch.equal(x, x0)
    assert all(torch.equal(b.params[k], v) for k, v in p0.items())
    assert all(torch.equal(o, outs[0]) for o in outs)
    _near(outs[0].numpy(), _jax(path, x0.numpy())[0])
    with torch.no_grad():           # torch writes both, once
        ref = torch.jit.load(path)(x0.clone())
    np.testing.assert_allclose(outs[0].numpy(), ref.numpy(), rtol=1e-6)


def test_torch_indices_int64_where_jax_int32(tmp_path):
    """argmax, max(dim) and topk indices: torch's int64 in the port, the
    JAX lowering's int32 (x64 off), the same values (ROADMAP N12)."""
    class Net(tnn.Module):
        def forward(self, x):
            v, i = torch.max(x, 1)
            return torch.argmax(x, 1), i, torch.topk(x, 3, 1)[1], v

    path = _script(tmp_path, Net())
    x = np.random.RandomState(9).randn(5, 7).astype(np.float32)
    got = _port(load_model_file(path), x)
    want = _jax(path, x)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == np.int64 and w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    _near(got[3], want[3])


# -- through the filter --------------------------------------------------------

def _run(nns, desc, frames, buf):
    pipe = nns.parse_launch(desc)
    runner = nns.PipelineRunner(pipe).start()
    src = pipe.get("src")
    for i, f in enumerate(frames):
        src.push(buf.of(f, pts=i))
    src.end()
    runner.wait(120)
    runner.stop()
    return [np.asarray(r.tensors[0]) for r in pipe.get("out").results]


@pytest.mark.parametrize("framework", ["pytorch", ""])
def test_torch_filter_pytorch_and_autodetect_match_jax(lenet5, framework):
    """`framework=pytorch model=x.pt` and auto-detect by extension, shapes
    from the pipeline's caps: the uint8 outputs of the JAX pipeline."""
    fw = f"framework={framework} " if framework else ""
    desc = (f"appsrc name=src dims=1:28:28:1 types=uint8 ! tensor_filter "
            f"{fw}model={lenet5} ! tensor_sink name=out")
    frames = list(_digits(3, 1))
    got = _run(tnns, desc, frames, TensorBuffer)
    want = _run(jnns, desc, frames, JTensorBuffer)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.tobytes() == w.tobytes()


def test_torch_filter_pytorch_bfloat16_custom(mbv2_pt):
    """custom=dtype=bfloat16 reaches the loader through the filter."""
    path, _ = mbv2_pt
    frames = list(_frames(2, 10))
    desc = (f"appsrc name=src dims=3:64:64:1 types=float32 ! tensor_filter "
            f"name=f framework=pytorch model={path}{{}} ! "
            f"tensor_sink name=out")
    f32 = _run(tnns, desc.format(""), frames, TensorBuffer)
    bf16 = _run(tnns, desc.format(" custom=dtype=bfloat16"), frames,
                TensorBuffer)
    assert [a.argmax() for a in f32] == [b.argmax() for b in bf16]
    assert not all(np.array_equal(a, b) for a, b in zip(f32, bf16))


# -- config 1's network --------------------------------------------------------

def test_torch_traced_mobilenet_v2_matches_zoo_jax_and_torch(mbv2_pt):
    """T's network (write_torchscript_mbv2) at 0.35, 64²: the port's
    lowering of the traced archive gives zoo://mobilenet_v2's logits (the
    module it was traced from), the JAX loader's and torch.jit.load's."""
    path, model = mbv2_pt
    for x in _frames(2, 11):
        (got,) = _hold(path, x)
        with torch.no_grad():
            zoo = model(torch.from_numpy(x)).numpy()
        _near(got, zoo)

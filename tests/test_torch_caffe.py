"""Caffe (.caffemodel), Caffe2 (init_net.pb,predict_net.pb) and UFF
(.uff) ingestion in the port (nnstreamer_tpu_torch/modelio/caffe.py,
caffe2.py, uff.py) against the JAX package's loaders, on the CPU.

The files come from `tools/model_fixtures.py`: Caffe's lenet.prototxt
(L), a CIFAR-10 ResNet pair at reduced depth (R: widths 16/32/64, one
block a stage), LeNet-5 in UFF's op set (U), and small nets written here
for the rest of each vocabulary (Caffe: grouped strided convolution,
LRN, padded AVE/MAX pooling under the CEIL-and-clip rule, global
pooling, Sigmoid/TanH, Split, the three Eltwise operations and coeffs,
Concat, Flatten, transposed InnerProduct, Dropout). Each file runs
through the port and the JAX loader on the same seeded inputs, f32,
within 1e-5·max|y| + 1e-6; then the filter (extension auto-detect, the
caffe2 pair string, `framework=caffe2` / `tensorrt` / `armnn`,
`inputname`/`outputname` on .uff) against the JAX pipeline; and the JAX
tests' refusals, without their wall-clock bounds.
"""

import jax
import numpy as np
import pytest
import torch

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


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_caffe")
    out = {"L": d / "lenet.caffemodel", "R_init": d / "init_net.pb",
           "R_predict": d / "predict_net.pb", "U": d / "lenet5.uff"}
    mf.write_caffe_lenet(out["L"], seed=1)
    mf.write_caffe2_resnet(out["R_init"], out["R_predict"], blocks=1,
                           seed=1, calib_frames=2)
    mf.write_uff_lenet(out["U"], seed=1)
    out = {k: str(v) for k, v in out.items()}
    out["R"] = f"{out['R_init']},{out['R_predict']}"
    return out


def _near(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max() + 1e-6, (err, np.abs(want).max())


def _both(path, x, **kw):
    """The port's and the JAX loader's outputs on x."""
    port, jb = load_model_file(path, **kw), jload(path, **kw)
    with torch.inference_mode():
        got = [y.numpy() for y in port.fn(port.params, torch.from_numpy(x))]
    want = [np.asarray(y) for y in jax.jit(jb.fn)(jb.params, x)]
    assert len(got) == len(want)
    return port, got, want


def _rng_x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("key", ["L", "R", "U"])
def test_torch_loaded_params_move_to_the_device(files, key):
    """Every tensor of a loaded bundle's params goes where the backend
    moves them (Caffe keeps a list of blobs a layer)."""
    from nnstreamer_tpu_torch.backends.torch_backend import params_to

    moved = params_to(load_model_file(files[key]).params,
                      torch.device("meta"))
    leaves = [v for vs in moved.values()
              for v in (vs if isinstance(vs, list) else [vs])]
    assert leaves and all(v.device.type == "meta" for v in leaves)


# -- Caffe ---------------------------------------------------------------------

def test_torch_caffe_lenet_matches_jax(files):
    port, got, want = _both(files["L"], _rng_x((1, 1, 28, 28)))
    assert port.in_spec.tensors[0].shape == (1, 1, 28, 28)
    assert port.out_spec.tensors[0].shape == (1, 10)
    _near(got[0], want[0])
    np.testing.assert_allclose(got[0].sum(), 1.0, atol=1e-5)
    # custom=batch= rewrites the Input layer's batch
    port, got, want = _both(files["L"], _rng_x((3, 1, 28, 28), 1), batch=3)
    assert port.out_spec.tensors[0].shape == (3, 10)
    _near(got[0], want[0])


def _caffe_breadth(path):
    rng = np.random.default_rng(9)

    def w(*shape):
        return rng.normal(0, 0.4, shape).astype(np.float32)

    lrn = (mf._int(1, 3) + mf._f32(2, 0.002) + mf._f32(3, 0.75)
           + mf._f32(5, 2.0))
    coeff = mf._int(1, 1) + mf._f32(2, 0.5) + mf._f32(2, -1.5)
    layers = [
        mf.caffe_input("data", (2, 4, 11, 9)),
        mf.caffe_conv("conv", "data", w(6, 2, 3, 3), w(6), stride=2, pad=1,
                      group=2),
        mf.caffe_layer("norm", "LRN", ["conv"], ["norm"],
                       params={118: lrn}),
        mf.caffe_pool("avg", "norm", 1, 3, 2, pad=1),
        mf.caffe_pool("max", "norm", 0, 2, 2, pad=1),
        mf.caffe_layer("sig", "Sigmoid", ["avg"], ["sig"]),
        mf.caffe_layer("tanh", "TanH", ["max"], ["tanh"]),
        mf.caffe_layer("split", "Split", ["sig"], ["s1", "s2"]),
        mf.caffe_layer("prod", "Eltwise", ["s1", "tanh"], ["prod"],
                       params={110: mf._int(1, 0)}),
        mf.caffe_layer("mx", "Eltwise", ["s2", "tanh"], ["mx"],
                       params={110: mf._int(1, 2)}),
        mf.caffe_layer("wsum", "Eltwise", ["prod", "mx"], ["wsum"],
                       params={110: coeff}),
        mf.caffe_layer("cat", "Concat", ["wsum", "prod"], ["cat"]),
        mf.caffe_pool("gap", "cat", 1, 1, 1, global_=True),
        mf.caffe_layer("flat", "Flatten", ["cat"], ["flat"]),
        mf.caffe_layer("ipt", "InnerProduct", ["flat"], ["ipt"],
                       [w(144, 7), w(7)],
                       {117: mf._int(1, 7) + mf._int(6, 1)}),
        mf.caffe_layer("drop", "Dropout", ["ipt"], ["ipt"]),
        mf.caffe_layer("prob", "Softmax", ["ipt"], ["prob"]),
    ]
    with open(path, "wb") as f:
        f.write(mf.caffe_net("breadth", layers))


def test_torch_caffe_layer_breadth_matches_jax(tmp_path):
    path = str(tmp_path / "breadth.caffemodel")
    _caffe_breadth(path)
    port, got, want = _both(path, _rng_x((2, 4, 11, 9), 2))
    # the outputs: every top no layer reads (the global pool and prob)
    assert [t.shape for t in port.out_spec.tensors] == \
        [w_.shape for w_ in want] == [(2, 12, 1, 1), (2, 7)]
    for g, w_ in zip(got, want):
        _near(g, w_)


def test_torch_caffe_pool_ceil_and_clip_rule():
    """Caffe pooling output sizing: CEIL, then the clip rule — the last
    window must start inside image+pad (pooling_layer.cpp). H=3,k=2,
    s=2,p=1: ceil gives 3 but the clip drops to 2."""
    from nnstreamer_tpu_torch.modelio.caffe import _pool2d

    x = torch.arange(9, dtype=torch.float32).reshape(1, 1, 3, 3)
    out = _pool2d(x, "max", (2, 2), (2, 2), (1, 1))
    assert out.shape == (1, 1, 2, 2)
    # windows: [-1..0]x[-1..0] -> 0 ; [-1..0]x[1..2] -> 2 ;
    #          [1..2]x[-1..0]  -> 6 ; [1..2]x[1..2]  -> 8
    np.testing.assert_array_equal(out[0, 0].numpy(), [[0, 2], [6, 8]])
    # no padding, divisible: plain 2x2/2 pooling unchanged
    out2 = _pool2d(torch.ones((1, 1, 4, 4)), "ave", (2, 2), (2, 2), (0, 0))
    assert out2.shape == (1, 1, 2, 2)
    np.testing.assert_allclose(out2.numpy(), 1.0)
    # AVE divides by the whole kernel, the padding included
    out3 = _pool2d(torch.ones((1, 1, 3, 3)), "ave", (2, 2), (2, 2), (1, 1))
    np.testing.assert_allclose(out3[0, 0].numpy(), [[0.25, 0.5], [0.5, 1.0]])


def test_torch_caffemodel_not_a_model_fails_loud(tmp_path):
    p = tmp_path / "junk.caffemodel"
    p.write_bytes(b"\x00\x01nope")
    with pytest.raises(Exception):
        load_model_file(str(p))


def test_torch_caffemodel_unknown_layer_fails_loud(files):
    from nnstreamer_tpu_torch.modelio.caffe import (
        lower_caffe, parse_caffemodel)

    net = parse_caffemodel(files["L"])
    net.layers[1].type = "FancyNewLayer"
    with pytest.raises(BackendError, match="FancyNewLayer"):
        lower_caffe(net)


@pytest.mark.parametrize("key", ["L", "U"])
def test_torch_compute_dtype_rejected_for_fixed_dtype_formats(files, key):
    with pytest.raises(BackendError, match="dtype"):
        load_model_file(files[key], compute_dtype="bfloat16")


# -- Caffe2 --------------------------------------------------------------------

def test_torch_caffe2_resnet_pair_matches_jax(files):
    port, got, want = _both(files["R"], _rng_x((1, 3, 32, 32)))
    assert port.in_spec.tensors[0].shape == (1, 3, 32, 32)
    assert port.out_spec.tensors[0].shape == (1, 10)
    assert port.name == "predict_net.pb"
    _near(got[0], want[0])
    assert 0.1 < got[0].max() < 0.999          # not saturated
    # SpatialBN folded at load into one scale and one shift
    assert sum(k.endswith("/bn_scale") for k in port.params) == 9
    port, got, want = _both(files["R"], _rng_x((2, 3, 32, 32), 1), batch=2)
    assert port.out_spec.tensors[0].shape == (2, 10)
    _near(got[0], want[0])


def test_torch_caffe2_pair_errors(files):
    with pytest.raises(BackendError, match="exactly"):
        load_model_file("a.pb,b.pb,c.pb")
    with pytest.raises(BackendError, match="does not exist"):
        load_model_file("/nope/i.pb,/nope/p.pb")
    with pytest.raises(BackendError, match="not consumed by caffe2"):
        load_model_file(files["R"], compute_dtype="float32")
    with pytest.raises(BackendError, match="init,predict pairs only"):
        load_model_file(files["L"], side=32)


def test_torch_caffe2_refusals_match_jax(tmp_path):
    """A Conv with a `group` arg and an op outside the set fail loud with
    the JAX lowering's text."""
    init, pred = tmp_path / "i.pb", tmp_path / "p.pb"
    w = np.ones((4, 1, 3, 3), np.float32)
    init.write_bytes(mf.caffe2_net("i", [mf.caffe2_op(
        "GivenTensorFill", [], ["w"], shape=np.asarray(w.shape, np.int64),
        values=w)]))
    for op in (mf.caffe2_op("Conv", ["data", "w"], ["y"], kernel=3,
                            group=2),
               mf.caffe2_op("Conv", ["data", "w"], ["c"], kernel=3),
               ):
        ops = [op] if b"group" in op else \
            [op, mf.caffe2_op("LeakyRelu", ["c"], ["y"])]
        pred.write_bytes(mf.caffe2_net("p", ops))
        with pytest.raises(BackendError) as got:
            load_model_file(f"{init},{pred}")
        with pytest.raises(JBackendError) as want:
            jload(f"{init},{pred}")
        assert str(got.value).replace("torch", "XLA") == str(want.value)


# -- UFF -----------------------------------------------------------------------

def test_torch_uff_lenet_matches_jax(files):
    x = _rng_x((2, 28, 28, 1))
    port, got, want = _both(files["U"], x)
    assert port.in_spec is None and port.out_spec is None
    _near(got[0], want[0])
    assert got[0].shape == (2, 10)


def test_torch_uff_structure_and_unknown_op(files):
    from nnstreamer_tpu_torch.modelio.uff import lower_uff, parse_uff

    g = parse_uff(files["U"])
    assert g.outputs == ["out"]
    assert g.nodes["in"].op == "Input"
    assert {"Conv", "Pool", "FullyConnected", "Binary", "Activation"} <= \
        {n.op for n in g.nodes.values()}
    g.nodes["relu"].op = "MysteryOp"
    m = lower_uff(g)                        # fails at the first run
    with pytest.raises(BackendError, match="MysteryOp"):
        m.fn(m.params, torch.zeros((1, 28, 28, 1)))


def test_torch_uff_inputname_outputname_binding(files):
    """The reference's tensorrt invocation uses inputname=in
    outputname=out — binding must validate and select (JAX's texts)."""
    port, got, want = _both(files["U"], _rng_x((1, 28, 28, 1), 3),
                            input_names=["in"], output_names=["out", "fc1"])
    assert [g.shape for g in got] == [(1, 10), (1, 500)]
    for g, w_ in zip(got, want):
        _near(g, w_)
    for kw, text in ((dict(output_names=["no-such-node"]), "no-such-node"),
                     (dict(input_names=["wrong"]), "Input node")):
        with pytest.raises(BackendError, match=text) as te:
            load_model_file(files["U"], **kw)
        with pytest.raises(JBackendError) as je:
            jload(files["U"], **kw)
        assert str(te.value) == str(je.value)


# -- the filter ------------------------------------------------------------------

def _outs(pkg, desc, frames):
    buf = JTensorBuffer if pkg is jnns else TensorBuffer
    pipe = pkg.parse_launch(desc)
    runner = pkg.PipelineRunner(pipe).start()
    for i, f in enumerate(frames):
        pipe.get("src").push(buf.of(f, pts=i))
    pipe.get("src").end()
    runner.wait(120)
    runner.stop()
    res = pipe.get("out").results
    assert len(res) == len(frames)
    return np.stack([np.asarray(r.tensors[0]) for r in res])


@pytest.mark.parametrize("case", ["L", "R", "U"])
def test_torch_filter_caffe_caffe2_uff_match_jax_pipeline(files, case):
    """Each file behind the reference's own transforms, extension
    auto-detected (the pair by its comma), and by the reference's
    framework names: the port's outputs are the JAX pipeline's."""
    rng = np.random.default_rng(4)
    if case == "L":       # armnn suite: (x - 127.5) / 127.5
        head = ("appsrc name=src dims=28:28:1:1 types=uint8 ! "
                "tensor_transform mode=arithmetic "
                "option=typecast:float32,add:-127.5,div:127.5")
        frames = [rng.integers(0, 256, (1, 1, 28, 28), np.uint8)
                  for _ in range(3)]
        model, fw = files["L"], "armnn"
    elif case == "R":
        head = "appsrc name=src dims=32:32:3:1 types=float32"
        frames = [_rng_x((1, 3, 32, 32), i) for i in range(3)]
        model, fw = files["R"], "caffe2"
    else:                 # tensorrt suite: 1 - x/255, inputname/outputname
        head = ("appsrc name=src dims=1:28:28:1 types=uint8 ! "
                "tensor_transform mode=arithmetic "
                "option=typecast:float32,div:-255.0,add:1")
        frames = [rng.integers(0, 256, (1, 28, 28, 1), np.uint8)
                  for _ in range(3)]
        model, fw = f"{files['U']} inputname=in outputname=out", "tensorrt"
    desc = f"{head} ! tensor_filter model={model} ! tensor_sink name=out"
    want = _outs(jnns, desc, frames)
    _near(_outs(tnns, desc, frames), want)
    desc = (f"{head} ! tensor_filter framework={fw} model={model} ! "
            f"tensor_sink name=out")
    _near(_outs(tnns, desc, frames), want)

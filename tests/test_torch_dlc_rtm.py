"""SNPE `.dlc` and DeepViewRT `.rtm` ingestion in the port
(nnstreamer_tpu_torch/modelio/dlc.py, rtm.py) against the JAX package's
loaders, on the CPU.

The files come from `tools/model_fixtures.py`: the reference's add2
containers rebuilt (y = x + 2, float32 and uint8 I/O) and MobileNetV1
0.25 (28 convs, depthwise HWCM weights with groups = C, global average
pool, reshape, softmax) at 64². Each runs through the port and the JAX
loader on the same seeded inputs: the add2 models bit for bit (x + 2
exact, the uint8 exit rounded half to even and clipped to [0, 255]),
MobileNetV1 f32 within 1e-5·max|y| + 1e-6; then the filter (extension
auto-detect, `framework=snpe` / `deepview-rt`, MobileNetV1 behind the
normalize_u8 filter) against the JAX pipeline; and the JAX tests'
structure checks and refusals that run without the reference's files.
"""

import zipfile

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.modelio import load_model_file as jload
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio import load_model_file
from nnstreamer_tpu_torch.modelio.dlc import lower_dlc, parse_dlc
from nnstreamer_tpu_torch.modelio.rtm import (
    RTMGraph, RTMLayer, lower_rtm, parse_rtm)
from nnstreamer_tpu_torch.tools import model_fixtures as mf

SIZE = 64


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dlc_rtm")
    out = {"f": d / "add2_float.dlc", "u8": d / "add2_uint8.dlc",
           "M": d / "mobilenet_v1_0.25.rtm"}
    mf.write_dlc_add2(out["f"])
    mf.write_dlc_add2(out["u8"], uint8=True)
    mf.write_rtm_mobilenet_v1(out["M"], input_size=SIZE, seed=2)
    return {k: str(v) for k, v in out.items()}


def _port(bundle, x):
    with torch.inference_mode():
        return bundle.fn(bundle.params, torch.as_tensor(x))[0].numpy()


def _jax(bundle, x):
    return np.asarray(jax.jit(bundle.fn)(bundle.params, x)[0])


# -- DLC -----------------------------------------------------------------------

def test_torch_parse_dlc_structure(files):
    g = parse_dlc(files["f"])
    assert [(lay.name, lay.type) for lay in g.layers] == [
        ("X_input", "Input"),
        ("elementwise_sum_0_const", "Const"),
        ("elementwise_sum_0", "ElementwiseBinaryOp")]
    assert g.buffer_dims["X_input"] == (1,)
    assert g.buffer_dims["ADD_TOP"] == (1,)
    np.testing.assert_array_equal(g.params["elementwise_sum_0_const"],
                                  np.asarray([2.0], np.float32))
    assert g.layers[0].attrs["input_type"] == 0
    assert parse_dlc(files["u8"]).layers[0].attrs["input_type"] == 1


@pytest.mark.parametrize("key,dtype,cases", [
    ("f", np.float32, ((0.0, 2.0), (10.0, 12.0), (1.0, 3.0), (-2.5, -0.5))),
    ("u8", np.uint8, ((0, 2), (10, 12), (1, 3), (253, 255), (254, 255))),
])
def test_torch_dlc_add2_matches_jax_bit_for_bit(files, key, dtype, cases):
    """Reference invoke00 / invoke01: x + 2 exact, float32 and uint8 I/O
    (the uint8 exit saturates at 255, as the JAX loader's)."""
    port, jb = load_model_file(files[key]), jload(files[key])
    assert port.in_spec.tensors[0].dtype.np_dtype == dtype
    assert port.out_spec.tensors[0].dtype.np_dtype == dtype
    assert port.name == jb.name
    for xin, want in cases:
        x = np.asarray([xin], dtype)
        got = _port(port, x)
        assert got.dtype == dtype and got.shape == (1,)
        assert got[0] == want
        assert got.tobytes() == _jax(jb, x).tobytes()


def test_torch_dlc_refusals(files, tmp_path):
    g = parse_dlc(files["f"])
    g.layers[2].type = "FancyNewLayer"
    with pytest.raises(BackendError, match="FancyNewLayer"):
        lower_dlc(g)
    g = parse_dlc(files["f"])
    g.buffer_dims.pop("X_input")
    with pytest.raises(BackendError, match="dims"):
        lower_dlc(g)
    g = parse_dlc(files["f"])
    g.layers[1].outputs = []
    with pytest.raises(BackendError, match="no.*outputs"):
        lower_dlc(g)
    with pytest.raises(BackendError, match="rank"):
        lower_dlc(parse_dlc(files["f"]), batch=4)
    with pytest.raises(BackendError, match="dtype"):
        load_model_file(files["f"], compute_dtype="bfloat16")


def test_torch_dlc_not_a_zip_fails_loud(tmp_path):
    p = tmp_path / "junk.dlc"
    p.write_bytes(b"\x00\x01nope")
    with pytest.raises(BackendError, match="zip"):
        parse_dlc(str(p))


def test_torch_dlc_zip_without_model_fails_loud(tmp_path):
    p = tmp_path / "empty.dlc"
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("other", b"x")
    with pytest.raises(BackendError, match="model"):
        parse_dlc(str(p))


# -- RTM -----------------------------------------------------------------------

def test_torch_parse_rtm_structure(files):
    """The reference model's structure (tests/test_rtm.py:36-52)."""
    g = parse_rtm(files["M"])
    types = [lay.type_name for lay in g.layers]
    assert types.count("Const") == 56          # 28 weights + 28 biases
    assert types.count("Conv2D") == 28         # 27 body + logits
    assert types.count("Input") == 1
    assert "Softmax" in types and "Pool" in types
    dw = next(lay for lay in g.layers
              if lay.name.endswith("Conv2d_1_depthwise/Relu6"))
    assert dw.attrs["groups"] == [8]
    w = next(lay for lay in g.layers
             if lay.name.endswith("Conv2d_1_depthwise/weights"))
    assert w.tensor.shape == (3, 3, 8, 1)      # HWCM
    inp = next(lay for lay in g.layers if lay.type_name == "Input")
    assert inp.shape == (1, SIZE, SIZE, 3)


def test_torch_rtm_mobilenet_v1_matches_jax(files):
    port, jb = load_model_file(files["M"]), jload(files["M"])
    assert port.in_spec.tensors[0].shape == (1, SIZE, SIZE, 3)
    assert port.out_spec.tensors[0].shape == (1, 1001)
    x = np.random.default_rng(0).uniform(-1, 1, (1, SIZE, SIZE, 3)) \
        .astype(np.float32)
    got, want = _port(port, x), _jax(jb, x)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got.sum(), 1.0, atol=1e-5)
    # batch= rewrites the input batch; the batch-1 Reshape follows it
    port = load_model_file(files["M"], batch=2)
    assert port.out_spec.tensors[0].shape == (2, 1001)
    x2 = np.concatenate([x, x[:, ::-1]])
    got2 = _port(port, x2)
    assert np.abs(got2[:1] - got).max() <= 1e-5 * np.abs(got).max() + 1e-6


def test_torch_rtm_padded_avg_pool_excludes_padding():
    """SAME-padded average pooling must divide each window by its VALID
    element count (TF semantics), not the full kernel size."""
    g = RTMGraph(creator="test", layers=[
        RTMLayer(index=0, name="input", type=0x01, inputs=[],
                 shape=(1, 4, 4, 1)),
        RTMLayer(index=1, name="net/AvgPool", type=0x3D, inputs=[0],
                 shape=(1, 4, 4, 1),
                 attrs={"ksize": [1, 3, 3, 1],
                        "strides": [1, 1, 1, 1],
                        "head": [0, 1, 1, 0], "tail": [0, 1, 1, 0]}),
    ])
    m = lower_rtm(g)
    x = np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1)
    y = m.fn(m.params, torch.from_numpy(x))[0].numpy()
    # manual reference: mean over valid cells only
    xp = np.pad(x[0, :, :, 0], 1, constant_values=np.nan)
    want = np.empty((4, 4), np.float32)
    for i in range(4):
        for j in range(4):
            want[i, j] = np.nanmean(xp[i:i + 3, j:j + 3])
    np.testing.assert_allclose(y[0, :, :, 0], want, rtol=1e-6)


def test_torch_rtm_refusals(files, tmp_path):
    g = parse_rtm(files["M"])
    g.layers[-1].type = 0x7777
    with pytest.raises(BackendError, match="type_0x7777"):
        lower_rtm(g)
    g = parse_rtm(files["M"])
    next(lay for lay in g.layers if lay.type_name == "Const").tensor = None
    with pytest.raises(BackendError, match="no data"):
        lower_rtm(g)
    with pytest.raises(BackendError, match="dtype"):
        load_model_file(files["M"], compute_dtype="bfloat16")
    p = tmp_path / "junk.rtm"
    p.write_bytes(b"\x00\x01nope")
    with pytest.raises(BackendError, match="RTMx"):
        parse_rtm(str(p))


# -- the filter ------------------------------------------------------------------

def test_torch_filter_dlc_and_rtm_match_jax_pipeline(files):
    """add2 through `framework=snpe` and auto-detect (x + 2 exact), and
    MobileNetV1 behind the normalize_u8 filter through `framework=
    deepview-rt`: the JAX pipeline's outputs and labels."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    for fw in ("snpe", ""):
        pipe = tnns.parse_launch(
            f"appsrc name=src dims=1 types=uint8 ! tensor_filter "
            f"{f'framework={fw} ' if fw else ''}model={files['u8']} ! "
            f"tensor_sink name=out")
        runner = tnns.PipelineRunner(pipe).start()
        for v in (0, 10, 250):
            pipe.get("src").push(TensorBuffer.of(np.asarray([v], np.uint8)))
        pipe.get("src").end()
        runner.wait(60)
        runner.stop()
        assert [int(np.asarray(r.tensors[0])[0])
                for r in pipe.get("out").results] == [2, 12, 252]
    desc = (f"videotestsrc num-buffers=3 width={SIZE} height={SIZE} "
            f"pattern=random seed=5 ! tensor_converter ! tensor_filter "
            f"framework=pallas model=normalize_u8 ! tensor_filter "
            f"{{fw}}model={files['M']} ! tensor_decoder "
            f"mode=image_labeling ! tensor_sink name=out")
    res = {}
    for pkg, fw in ((jnns, ""), (tnns, "framework=deepview-rt ")):
        pipe = pkg.parse_launch(desc.format(fw=fw))
        pkg.PipelineRunner(pipe).run(120)
        res[pkg] = pipe.get("out").results
    assert len(res[tnns]) == 3
    assert [r.meta["label_index"] for r in res[tnns]] == \
        [r.meta["label_index"] for r in res[jnns]]

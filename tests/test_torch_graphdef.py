"""TF frozen-GraphDef ingestion in the port (nnstreamer_tpu_torch/
modelio/graphdef.py) against the JAX package's loader and tensorflow, on
the CPU.

The files come from `tools/model_fixtures.py` at reduced width: config
1's MobileNetV2 (width 0.35, 64², zoo://mobilenet_v2 seed 0, BN folded)
and the speech-commands `conv` model with 8 filters, plus a graph of the
rest of the op vocabulary written here. Each runs through the port, the
JAX loader and a `tf.compat.v1` session on the same seeded inputs, f32,
within 1e-5·max|y| + 1e-6; the audio front end (DecodeWav,
AudioSpectrogram, Mfcc) against `tf.raw_ops` on a seeded WAV within
1e-4·max|y|. Then the bundle's host stage (`host_pre`, the DecodeWav
entry) through pipelines: once a frame, micro-batched (one invoke a
frame), inside compiled windows (before the copy, outputs equal to the
per-frame run's), refused on the FLEXIBLE path with the JAX package's
text; `inputname=`/`outputname=` binding; the JAX tests' refusals.
"""

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.modelio import load_model_file as jload
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JTensorBuffer
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio import load_model_file
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tools import model_fixtures as mf

tf = pytest.importorskip("tensorflow")

SIZE, FILTERS = 64, 8


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from nnstreamer_tpu_torch.models.mobilenet_v2 import build

    d = tmp_path_factory.mktemp("torch_graphdef")
    model = build(width=0.35, input_size=SIZE, dtype="float32").params
    out = {"G": d / "mbv2.pb", "S": d / "speech.pb"}
    mf.write_graphdef_mobilenet_v2(model, out["G"], input_size=SIZE)
    mf.write_speech_commands(out["S"], filters=FILTERS, seed=0)
    return {k: str(v) for k, v in out.items()}


def _near(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + 1e-6, (err, np.abs(want).max())


def _tf_run(path, feeds, out):
    gd = tf.compat.v1.GraphDef()
    with open(path, "rb") as f:
        gd.ParseFromString(f.read())
    with tf.Graph().as_default() as g:
        tf.import_graph_def(gd, name="")
        with tf.compat.v1.Session(graph=g) as sess:
            return sess.run(out, feeds)


def _port(bundle, *xs):
    with torch.inference_mode():
        return [y.numpy() for y in
                bundle.fn(bundle.params, *(torch.as_tensor(x) for x in xs))]


def _wav(seed):
    wav = mf.seeded_speech(seed)
    return wav, np.frombuffer(wav, np.int16).reshape(-1, 1)


# -- the two models against the JAX loader and tensorflow ------------------------

def test_torch_graphdef_mobilenet_v2_matches_jax_and_tf(files):
    kw = dict(input_names=["input"], output_names=["logits"])
    port, jb = load_model_file(files["G"], **kw), jload(files["G"], **kw)
    assert port.in_spec.tensors[0].shape == (1, SIZE, SIZE, 3)
    assert port.out_spec.tensors[0].shape == (1, 1001)
    x = np.random.default_rng(0).uniform(-1, 1, (1, SIZE, SIZE, 3)) \
        .astype(np.float32)
    (got,) = _port(port, x)
    _near(got, jax.jit(jb.fn)(jb.params, x)[0])
    _near(got, _tf_run(files["G"], {"input:0": x}, "logits:0"))


def test_torch_graphdef_speech_matches_jax_and_tf(files):
    kw = dict(input_names=["wav_data"], output_names=["labels_softmax"])
    port, jb = load_model_file(files["S"], **kw), jload(files["S"], **kw)
    assert port.in_spec is None and port.host_pre is not None
    assert port.out_spec.tensors[0].shape == (1, 12)
    for seed in (1, 2):
        wav, raw = _wav(seed)
        (audio,) = port.host_pre((raw,))
        assert audio.shape == (16000, 1) and audio.dtype == np.float32
        (got,) = _port(port, audio)
        (jaudio,) = jb.host_pre((raw,))
        np.testing.assert_array_equal(audio, jaudio)
        _near(got, jax.jit(jb.fn)(jb.params, jaudio)[0])
        _near(got, _tf_run(files["S"], {"wav_data:0": wav},
                           "labels_softmax:0"))


def test_torch_audio_frontend_vs_tf_kernels_and_jax():
    """The port's DecodeWav / AudioSpectrogram / Mfcc against tf.raw_ops
    and the JAX package's twins on a seeded WAV (mirrors
    test_graphdef_audio_frontend_golden_vs_tf_kernels)."""
    import jax.numpy as jnp

    from nnstreamer_tpu.modelio import graphdef as jg
    from nnstreamer_tpu_torch.modelio import graphdef as tg

    wav, _ = _wav(3)
    a_tf = tf.raw_ops.DecodeWav(contents=wav, desired_samples=16000,
                                desired_channels=1)
    audio, rate = tg.decode_wav_bytes(wav, 16000, 1)
    assert rate == int(a_tf.sample_rate) == 16000
    np.testing.assert_array_equal(audio, a_tf.audio.numpy())
    for win, hop in ((480, 160), (320, 160)):
        spec_tf = tf.raw_ops.AudioSpectrogram(
            input=audio, window_size=win, stride=hop,
            magnitude_squared=True).numpy()
        spec = tg.audio_spectrogram(torch.from_numpy(audio), win, hop,
                                    True).numpy()
        _near(spec, spec_tf, 1e-4)
        _near(spec, jg.audio_spectrogram(jnp, jnp.asarray(audio), win, hop,
                                         True), 1e-4)
        for count in (13, 40):
            kw = dict(upper_hz=4000.0, lower_hz=20.0, fb_channels=40,
                      dct_count=count)
            mf_tf = tf.raw_ops.Mfcc(
                spectrogram=spec_tf, sample_rate=16000,
                upper_frequency_limit=4000.0, lower_frequency_limit=20.0,
                filterbank_channel_count=40,
                dct_coefficient_count=count).numpy()
            got = tg.mfcc(torch.from_numpy(spec_tf), 16000, **kw).numpy()
            _near(got, mf_tf, 1e-4)
            _near(got, jg.mfcc(jnp, jnp.asarray(spec_tf), 16000, **kw), 1e-4)
    # the magnitude (not squared) spectrogram
    spec_tf = tf.raw_ops.AudioSpectrogram(
        input=audio, window_size=480, stride=160,
        magnitude_squared=False).numpy()
    _near(tg.audio_spectrogram(torch.from_numpy(audio), 480, 160,
                               False).numpy(), spec_tf, 1e-4)


def _breadth_graph(path):
    """The rest of the vocabulary: Identity-read weights, Conv2D VALID
    stride 2 and dilated SAME, depthwise with a multiplier, MaxPool and
    AvgPool SAME on odd sizes, Pad, ConcatV2, Sub/Mul/RealDiv/Relu,
    ExpandDims/Squeeze, Reshape, Mean keep_dims, MatMul transpose_b,
    Softmax, ArgMax, Cast."""
    rng = np.random.default_rng(5)
    g = mf.GraphDefWriter()
    A = mf.Attr
    g.node("x", "Placeholder", dtype=A.type(mf.DT_FLOAT),
           shape=A.shape((1, 11, 13, 3)))
    w = g.const("w", rng.normal(0, 0.3, (3, 3, 3, 4)).astype(np.float32))
    wr = g.op("w/read", "Identity", [w])
    a = g.op("conv_valid", "Conv2D", ["x", wr],
             strides=A.ints([1, 2, 2, 1]), padding="VALID")
    b = g.op("conv_dil", "Conv2D", ["x", wr], strides=A.ints([1, 1, 1, 1]),
             dilations=A.ints([1, 2, 2, 1]), padding="SAME")
    dw = g.const("dw", rng.normal(0, 0.3, (3, 3, 4, 2)).astype(np.float32))
    b = g.op("dwconv", "DepthwiseConv2dNative", [b, dw],
             strides=A.ints([1, 2, 2, 1]), padding="SAME")
    b = g.op("maxpool", "MaxPool", [b], ksize=A.ints([1, 3, 3, 1]),
             strides=A.ints([1, 1, 1, 1]), padding="SAME")
    c = g.op("avgpool", "AvgPool", [a], ksize=A.ints([1, 3, 3, 1]),
             strides=A.ints([1, 2, 2, 1]), padding="SAME")
    pads = g.const("pads", np.asarray([[0, 0], [1, 0], [0, 1], [0, 0]],
                                      np.int32))
    c = g.op("pad", "Pad", [c, pads], Tpaddings=A.type(mf.DT_INT32))
    c = g.op("relu", "Relu", [g.op("sub", "Sub", [c, g.const(
        "half", np.float32(0.5) * np.ones((1,), np.float32))])])
    b = g.op("crop", "Mul", [b, g.const("two", np.full((8,), 2.0,
                                                       np.float32))])
    axis = g.const("axis", np.asarray(3, np.int32))
    d = g.op("concat", "ConcatV2", [b, "maxpool", axis], N=2,
             Tidx=A.type(mf.DT_INT32))
    d = g.op("div", "RealDiv", [d, g.const("three", np.full(
        (16,), 3.0, np.float32))])
    m = g.op("mean", "Mean", [d, g.const("hw", np.asarray([1, 2], np.int32))],
             keep_dims=True, Tidx=A.type(mf.DT_INT32))
    m = g.op("squeeze", "Squeeze", [m], squeeze_dims=A.ints([1, 2]))
    m = g.op("expand", "ExpandDims", [m, g.const("zero", np.asarray(
        0, np.int32))], Tdim=A.type(mf.DT_INT32))
    m = g.op("flat", "Reshape", [m, g.const("shape", np.asarray(
        [1, 16], np.int32))], Tshape=A.type(mf.DT_INT32))
    fc = g.const("fc", rng.normal(0, 0.5, (5, 16)).astype(np.float32))
    logits = g.op("matmul", "MatMul", [m, fc], transpose_b=True)
    g.op("prob", "Softmax", [logits])
    g.node("label", "ArgMax", [logits, g.const("one", np.asarray(
        1, np.int32))], T=A.type(mf.DT_FLOAT), Tidx=A.type(mf.DT_INT32),
        output_type=A.type(9))
    g.node("relu_f", "Cast", [c], SrcT=A.type(mf.DT_FLOAT),
           DstT=A.type(mf.DT_INT32))
    with open(path, "wb") as f:
        f.write(g.serialize())


def test_torch_graphdef_op_breadth_matches_jax_and_tf(tmp_path):
    path = str(tmp_path / "breadth.pb")
    _breadth_graph(path)
    outs = ["prob", "label", "relu_f", "maxpool", "pad"]
    port = load_model_file(path, output_names=outs)
    jb = jload(path, output_names=outs)
    x = np.random.default_rng(6).normal(0, 1, (1, 11, 13, 3)) \
        .astype(np.float32)
    got = _port(port, x)
    want = jax.jit(jb.fn)(jb.params, x)
    ref = _tf_run(path, {"x:0": x}, [f"{o}:0" for o in outs])
    assert [o.shape for o in port.out_spec.tensors] == \
        [np.asarray(w).shape for w in ref]
    for name, g_, w, r in zip(outs, got, want, ref):
        if name in ("label", "relu_f"):         # integers: exactly
            np.testing.assert_array_equal(g_, r)
            np.testing.assert_array_equal(g_, w)
        else:
            _near(g_, w)
            _near(g_, r)


# -- binding, refusals ----------------------------------------------------------

def test_torch_graphdef_inputname_outputname_binding(files):
    """outputname picks any node (here an inner one) and orders the
    outputs; a Placeholder that is not bound, or an unknown node, fails
    loud with the JAX loader's text."""
    port = load_model_file(files["G"])
    assert [t.shape for t in port.out_spec.tensors] == [(1, 1001)]
    inner = ["relu6_0", "logits"]
    port = load_model_file(files["G"], input_names=["input"],
                           output_names=inner)
    jb = jload(files["G"], input_names=["input"], output_names=inner)
    x = np.random.default_rng(1).normal(0, 1, (1, SIZE, SIZE, 3)) \
        .astype(np.float32)
    for g_, w in zip(_port(port, x), jax.jit(jb.fn)(jb.params, x)):
        _near(g_, w)
    for kw in (dict(input_names=["nope"]), dict(output_names=["nope"])):
        with pytest.raises(BackendError) as got:
            load_model_file(files["G"], **kw)
        with pytest.raises(Exception) as want:
            jload(files["G"], **kw)
        assert str(got.value) == str(want.value)


def test_torch_graphdef_rejects_garbage(tmp_path):
    from nnstreamer_tpu_torch.modelio.graphdef import parse_graphdef

    p = tmp_path / "junk.pb"
    p.write_bytes(b"\xff\xfe definitely not a graphdef \x00\x01")
    with pytest.raises(BackendError, match="GraphDef"):
        parse_graphdef(str(p))


def test_torch_graphdef_unsupported_op_fails_loudly(files):
    """An op outside the vocabulary is named at load (the output probe
    walks the graph)."""
    from nnstreamer_tpu_torch.modelio.graphdef import (
        lower_graphdef, parse_graphdef)

    nodes = parse_graphdef(files["G"])
    next(n for n in nodes if n.op == "MatMul").op = "SomeExoticOp"
    with pytest.raises(BackendError, match="SomeExoticOp"):
        lower_graphdef(nodes, input_names=["input"], output_names=["logits"])


def test_torch_graphdef_wav_rate_and_dtype_refusals(files):
    port = load_model_file(files["S"], sample_rate=8000)
    _, raw = _wav(1)
    with pytest.raises(BackendError, match="sample rate 16000 != model rate"):
        port.host_pre((raw,))
    with pytest.raises(BackendError, match="not a RIFF/WAVE"):
        port.host_pre((np.zeros((16, 1), np.int16),))
    with pytest.raises(BackendError, match="not consumed by .pb"):
        load_model_file(files["S"], compute_dtype="float32")


# -- the host stage through pipelines ---------------------------------------------

N_WAV = 5


def _speech_desc(path, mid="", tail="", name="m", extra=""):
    return (f"appsrc name=src dims=1:16022 types=int16 ! {mid}"
            f"tensor_filter name={name} model={path} inputname=wav_data "
            f"outputname=labels_softmax{extra} ! {tail}tensor_sink name=out")


def _push_wavs(pkg, desc, n=N_WAV, **runner_kw):
    buf = JTensorBuffer if pkg is jnns else TensorBuffer
    pipe = pkg.parse_launch(desc)
    runner = pkg.PipelineRunner(pipe, **runner_kw).start()
    for i in range(n):
        pipe.get("src").push(buf.of(_wav(10 + i)[1], pts=i))
    pipe.get("src").end()
    runner.wait(120)
    runner.stop()
    res = pipe.get("out").results
    assert len(res) == n
    return pipe, runner, np.stack([np.asarray(r.tensors[0]) for r in res])


@pytest.fixture
def count_decodes(monkeypatch):
    from nnstreamer_tpu_torch.modelio import graphdef as tg

    calls = []
    real = tg.decode_wav_bytes

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tg, "decode_wav_bytes", counted)
    return calls


def test_torch_graphdef_speech_pipeline_host_stage_once_a_frame(
        files, count_decodes):
    """The reference's speech pipeline (raw WAV bytes as int16, header
    included): the host stage decodes once a frame, the outputs are the
    JAX pipeline's; with compiled windows on (the frames queue: windows
    form) the stage runs before each window's frames are staged, and the
    outputs equal the per-frame run's."""
    desc = _speech_desc(files["S"])
    n = 16
    _, _, want = _push_wavs(jnns, desc, n)
    _, _, off = _push_wavs(tnns, desc, n, compiled_loop=False)
    assert len(count_decodes) == n
    _near(off, want)
    del count_decodes[:]
    pipe, runner, on = _push_wavs(tnns, desc, n, compiled_loop=True)
    st = runner.stats()["m"]
    assert st["loop_entries"] > 0 and st["compiled_steps"] > 0, st
    assert len(count_decodes) == n
    np.testing.assert_array_equal(on, off)


def test_torch_graphdef_speech_micro_batched_runs_per_frame(
        files, count_decodes):
    """Behind tensor_batch the host stage makes the backend give way to
    one invoke a frame (no batched call), outputs equal the unbatched
    run's."""
    desc = _speech_desc(files["S"], "tensor_batch max-batch=4 "
                        "max-latency-ms=50 ! ", "tensor_unbatch ! ")
    pipe, _, got = _push_wavs(tnns, desc, compiled_loop=False)
    assert len(count_decodes) == N_WAV
    assert pipe.get("m").backend.batch_size_hist == {}
    _, _, want = _push_wavs(tnns, _speech_desc(files["S"]),
                            compiled_loop=False)
    np.testing.assert_array_equal(got, want)


def test_torch_graphdef_host_stage_refused_on_flexible(files):
    from nnstreamer_tpu.backends.xla import XLABackend
    from nnstreamer_tpu.core.errors import BackendError as JBackendError
    from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend

    props = {"model": files["S"], "inputname": "wav_data",
             "outputname": "labels_softmax"}
    raw = _wav(1)[1]
    be = TorchBackend()
    be.open(dict(props, accelerator="cpu"))
    with pytest.raises(BackendError) as got:
        be.invoke_flexible([raw])
    jb = XLABackend()
    jb.open(props)
    with pytest.raises(JBackendError) as want:
        jb.invoke_flexible([raw])
    assert str(got.value) == str(want.value)
    assert "host-side input stage" in str(got.value)
    # a window of frames: the stage runs per frame, outside any capture
    outs = be.invoke_window([(raw,)] * 3)
    one = be.invoke((raw,))
    for o in outs:
        np.testing.assert_array_equal(o[0].numpy(), one[0].numpy())
    be.close()


def test_torch_graphdef_mobilenet_pipeline_labels_match_jax(files):
    """G behind the normalize_u8 filter with inputname/outputname: the
    labels the JAX pipeline gives on the same frames."""
    src = (f"videotestsrc num-buffers=4 width={SIZE} height={SIZE} "
           f"pattern=random seed=3 ! tensor_converter ! tensor_filter "
           f"framework=pallas model=normalize_u8 ! tensor_filter "
           f"model={files['G']} inputname=input outputname=logits ! "
           f"tensor_decoder mode=image_labeling ! tensor_sink name=out")
    labels = {}
    for pkg in (jnns, tnns):
        pipe = pkg.parse_launch(src)
        pkg.PipelineRunner(pipe).run(180)
        labels[pkg] = [r.meta["label_index"]
                       for r in pipe.get("out").results]
    assert len(labels[tnns]) == 4 and labels[tnns] == labels[jnns]

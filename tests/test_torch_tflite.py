"""The port's TFLite loader (nnstreamer_tpu_torch/modelio/tflite.py,
tflite_custom.py) against tf.lite.Interpreter and the JAX package's
loader, on the CPU.

The models are built here with the installed tensorflow, as the JAX
package's tests/test_modelio.py builds them (its tests that run without
the reference checkout), and each is mirrored under the same name with a
``torch_`` prefix:

- parse: the port's `parse_tflite` gives the same graph as JAX's on every
  fixture (ops, options tables' positions, tensors, shapes, dtypes,
  quant params, buffers); a garbage or truncated file raises a
  `BackendError` naming it;
- the float lowering (f32) against the interpreter and against JAX's
  `load_model_file(..., compute_dtype="float32")`, each within atol 1e-4
  and rtol 1e-4 (the JAX tests' `_golden_vs_interpreter` rule): ~20
  elementwise/reduce/select builtins, the spatial ops, the
  TFLite_Detection_PostProcess custom op (identical detections), the
  keras LSTM's WHILE loop; a custom op with no lowering fails loudly;
- pipelines through the port's parse_launch: detect → bounding_boxes,
  pose → pose_estimation (host and device=true), raw SSD →
  mobilenet-ssd (host and compact), each against an independent numpy
  decode of the interpreter's outputs (the JAX tests' rules);
- `load_model_file` refusals.
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio import load_model_file, parse_tflite
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

tf = pytest.importorskip("tensorflow")


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _interpreter(path, builtin_only=False):
    kw = {}
    if builtin_only:
        # the JAX tests' choice: this TF build's XNNPACK delegate
        # miscomputes some strided-conv chains
        kw["experimental_op_resolver_type"] = (
            tf.lite.experimental.OpResolverType
            .BUILTIN_WITHOUT_DEFAULT_DELEGATES)
    interp = tf.lite.Interpreter(model_path=path, **kw)
    interp.allocate_tensors()
    return interp


def _interpret(path, *xs, builtin_only=False):
    interp = _interpreter(path, builtin_only)
    for d, x in zip(interp.get_input_details(), xs):
        interp.set_tensor(d["index"], x)
    interp.invoke()
    return [interp.get_tensor(d["index"])
            for d in interp.get_output_details()]


def port_run(path, *xs, **opts):
    m = load_model_file(path, **opts)
    with torch.inference_mode():
        return [t.numpy() for t in m.fn(m.params,
                                        *(torch.from_numpy(x) for x in xs))]


def jax_run(path, *xs, **opts):
    import jax
    from nnstreamer_tpu.modelio import load_model_file as jload

    m = jload(path, **opts)
    return [np.asarray(t) for t in jax.jit(m.fn)(m.params, *xs)]


def _convert_frozen(model, in_shape):
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)

    f = tf.function(lambda x: model(x),
                    input_signature=[tf.TensorSpec(in_shape, tf.float32)])
    frozen = convert_variables_to_constants_v2(f.get_concrete_function())
    conv = tf.lite.TFLiteConverter.from_concrete_functions([frozen], model)
    return conv.convert()


def _golden_vs_interpreter_and_jax(path, *xs, atol=1e-4):
    """The port's f32 outputs within atol 1e-4 / rtol 1e-4 of the
    interpreter's and of JAX's loader's."""
    ours = port_run(path, *xs, compute_dtype="float32")
    refs = _interpret(path, *xs)
    jx = jax_run(path, *xs, compute_dtype="float32")
    assert len(refs) == len(ours) == len(jx)
    for o, r, j in zip(ours, refs, jx):
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r, atol=atol, rtol=1e-4)
        np.testing.assert_allclose(o, j, atol=atol, rtol=1e-4)


# -- fixtures (built once per module) -----------------------------------------

@pytest.fixture(scope="module")
def breadth_models(tmp_path_factory):
    """tools/tflite_tf_fixtures.py's breadth models (its committed files
    are these, written with the same code)."""
    from nnstreamer_tpu_torch.tools import tflite_tf_fixtures as tff

    return tff.write_breadth(tmp_path_factory.mktemp("torch_breadth"))


@pytest.fixture(scope="module")
def built_models(tmp_path_factory):
    """A detection head ending in the TFLite_Detection_PostProcess custom
    op and a keras LSTM (a WHILE control-flow graph), built as the JAX
    tests' `built_models` builds them, by tools/tflite_tf_fixtures.py."""
    from nnstreamer_tpu_torch.tools import tflite_tf_fixtures as tff

    d = tmp_path_factory.mktemp("torch_built_tflite")
    return {"detect": tff.write_detect(d), "lstm": tff.write_lstm(d),
            "N": tff.DETECT_N, "C": tff.DETECT_C}


@pytest.fixture(scope="module")
def pose_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pose_tflite")
    K = 5
    rng_init = tf.keras.initializers.RandomNormal(stddev=0.15, seed=11)
    inp = tf.keras.Input((64, 64, 3), batch_size=1)
    x = tf.keras.layers.Conv2D(8, 3, strides=4, padding="same",
                               activation="relu",
                               kernel_initializer=rng_init)(inp)
    x = tf.keras.layers.Conv2D(16, 3, strides=2, padding="same",
                               activation="relu",
                               kernel_initializer=rng_init)(x)
    hm = tf.keras.layers.Conv2D(K, 1, activation="sigmoid",
                                kernel_initializer=rng_init,
                                name="heatmaps")(x)
    off = tf.keras.layers.Conv2D(2 * K, 1, kernel_initializer=rng_init,
                                 name="offsets")(x)
    model = tf.keras.Model(inp, [hm, off])
    path = str(d / "pose.tflite")
    open(path, "wb").write(_convert_frozen(model, (1, 64, 64, 3)))
    return {"path": path, "K": K}


@pytest.fixture(scope="module")
def raw_ssd_model(tmp_path_factory):
    from nnstreamer_tpu_torch.models.ssd_mobilenet import generate_anchors

    A = int(generate_anchors().shape[0])       # 1917
    C = 5
    d = tmp_path_factory.mktemp("torch_rawssd_tflite")
    init = tf.keras.initializers.RandomNormal(stddev=0.05, seed=13)
    inp = tf.keras.Input((8, 8, 3), batch_size=1)
    x = tf.keras.layers.Conv2D(4, 3, padding="same", activation="relu",
                               kernel_initializer=init)(inp)
    x = tf.keras.layers.Flatten()(x)
    loc = tf.keras.layers.Reshape((A, 4))(
        tf.keras.layers.Dense(A * 4, kernel_initializer=init)(x))
    logits = tf.keras.layers.Reshape((A, C))(
        tf.keras.layers.Dense(A * C, kernel_initializer=init)(x))
    model = tf.keras.Model(inp, [loc, logits])
    path = str(d / "raw_ssd.tflite")
    open(path, "wb").write(_convert_frozen(model, (1, 8, 8, 3)))
    return {"path": path, "A": A, "C": C}


@pytest.fixture(scope="module")
def writer_models(tmp_path_factory):
    """The fixture tool's files: MobileNetV2 0.35 at 64² float and uint8,
    and the WHILE counter."""
    from nnstreamer_tpu_torch.models.mobilenet_v2 import build
    from nnstreamer_tpu_torch.tools import tflite_fixture as fx

    d = tmp_path_factory.mktemp("torch_writer_tflite")
    model = build(width=0.35, input_size=64, dtype="float32").params
    fx.write_mobilenet_v2(model, d / "f.tflite", input_size=64)
    fx.write_mobilenet_v2(model, d / "q.tflite", quant=True, input_size=64,
                          calib_frames=2)
    fx.write_while_counter(d / "w.tflite")
    return {k: str(d / f"{k}.tflite") for k in ("f", "q", "w")}


# -- parse ---------------------------------------------------------------------

def _graph_fields(g):
    """Every field of a parsed graph, as comparable plain values."""
    def tensor(t):
        return (t.index, t.shape, str(t.dtype), t.name,
                None if t.buffer is None else (t.buffer.shape,
                                               t.buffer.tobytes()),
                None if t.scale is None else t.scale.tolist(),
                None if t.zero_point is None else t.zero_point.tolist(),
                t.qdim)

    def op(o):
        return (o.code, o.name, o.inputs, o.outputs, o.opts, o.custom_name,
                o.custom_options)

    return (g.inputs, g.outputs, g.path,
            [([tensor(t) for t in sg.tensors], [op(o) for o in sg.ops],
              sg.inputs, sg.outputs) for sg in g.subgraphs])


@pytest.mark.parametrize("which", [
    "elementwise", "spatial", "detect", "lstm", "pose", "raw_ssd",
    "writer_float", "writer_quant", "writer_while"])
def test_torch_parse_tflite_equals_jax(which, breadth_models, built_models,
                                       pose_model, raw_ssd_model,
                                       writer_models):
    from nnstreamer_tpu.modelio import parse_tflite as jparse

    path = {"elementwise": breadth_models["elementwise"],
            "spatial": breadth_models["spatial"],
            "detect": built_models["detect"], "lstm": built_models["lstm"],
            "pose": pose_model["path"], "raw_ssd": raw_ssd_model["path"],
            "writer_float": writer_models["f"],
            "writer_quant": writer_models["q"],
            "writer_while": writer_models["w"]}[which]
    assert _graph_fields(parse_tflite(path)) == _graph_fields(jparse(path))


@pytest.mark.parametrize("data", [b"\x00" * 64, b"junk"],
                         ids=["zeros", "short"])
def test_torch_parse_tflite_rejects_garbage(tmp_path, data):
    bad = tmp_path / "x.tflite"
    bad.write_bytes(data)
    with pytest.raises(BackendError, match="TFL3"):
        parse_tflite(str(bad))


def test_torch_parse_tflite_truncated_names_file(tmp_path, writer_models):
    """A file cut short after its identifier fails as a BackendError that
    names it (protowire.wire_context), never as a struct error."""
    data = open(writer_models["f"], "rb").read()
    bad = tmp_path / "cut.tflite"
    bad.write_bytes(data[:len(data) // 50])
    with pytest.raises(BackendError, match="cut.tflite"):
        parse_tflite(str(bad))


def test_torch_load_model_file_missing():
    with pytest.raises(BackendError, match="does not exist"):
        load_model_file("/nonexistent/model.tflite")


def test_torch_load_model_file_bad_ext(tmp_path):
    p = tmp_path / "m.weird"
    p.write_bytes(b"x")
    with pytest.raises(BackendError, match="unsupported model file"):
        load_model_file(str(p))


# -- the float lowering: breadth -------------------------------------------------

def test_torch_tflite_elementwise_reduce_select_breadth(breadth_models):
    x = np.random.default_rng(0).normal(0, 1, (2, 8)).astype(np.float32)
    _golden_vs_interpreter_and_jax(breadth_models["elementwise"], x)


def test_torch_tflite_spatial_breadth(breadth_models):
    x = np.random.default_rng(0).normal(0, 1, (1, 4, 4, 8)) \
        .astype(np.float32)
    _golden_vs_interpreter_and_jax(breadth_models["spatial"], x)


# -- custom op + control flow -------------------------------------------------

def _detection_case(N, C, n_objects, seed):
    rng = np.random.default_rng(seed)
    be = rng.normal(0, 0.5, (1, N, 4)).astype(np.float32)
    sc = rng.uniform(0, 0.25, (1, N, C + 1)).astype(np.float32)
    for i in rng.choice(N, n_objects, replace=False):
        sc[0, i, rng.integers(1, C + 1)] = rng.uniform(0.6, 0.99)
    return be, sc


def test_torch_detection_postprocess_custom_op_golden(built_models):
    """The port against the interpreter and JAX's loader on the custom-op
    model: identical detections (count, boxes, classes, scores)."""
    for trial in range(4):
        be, sc = _detection_case(built_models["N"], built_models["C"],
                                 6, 10 + trial)
        ref = _interpret(built_models["detect"], be, sc)
        ours = port_run(built_models["detect"], be, sc,
                        compute_dtype="float32")
        jx = jax_run(built_models["detect"], be, sc, compute_dtype="float32")
        nd = int(ref[3][0])
        assert int(ours[3][0]) == nd == int(jx[3][0])
        for other in (ref, jx):
            np.testing.assert_allclose(ours[0][0][:nd], other[0][0][:nd],
                                       atol=1e-4)
            np.testing.assert_array_equal(ours[1][0][:nd], other[1][0][:nd])
            np.testing.assert_allclose(ours[2][0][:nd], other[2][0][:nd],
                                       atol=1e-5)
        # the zero padding past the count, as JAX's
        np.testing.assert_array_equal(ours[2][0][nd:], jx[2][0][nd:])


def test_torch_lstm_while_loop_golden(built_models):
    """Control-flow TFLite (WHILE + cond/body subgraphs + GATHER/SPLIT/
    STRIDED_SLICE) matches the interpreter and JAX."""
    g = parse_tflite(built_models["lstm"])
    assert len(g.subgraphs) == 3          # main + while cond + body
    x = np.random.default_rng(5).normal(0, 1, (1, 8, 6)).astype(np.float32)
    ref = _interpret(built_models["lstm"], x)[0]
    ours = port_run(built_models["lstm"], x, compute_dtype="float32")[0]
    jx = jax_run(built_models["lstm"], x, compute_dtype="float32")[0]
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    np.testing.assert_allclose(ours, jx, atol=1e-5)


def test_torch_while_counter_golden(writer_models):
    """The fixture tool's WHILE counter: 5 steps of x·0.5 + 1, the counter
    out as an int32 scalar, as the interpreter gives them; and the torch
    backend's batchability verdict, taken on the meta device where the
    loop's host-read condition cannot run, comes out "not batchable"
    instead of raising."""
    x = np.random.default_rng(2).normal(0, 1, (1, 8)).astype(np.float32)
    ref = _interpret(writer_models["w"], x)
    ours = port_run(writer_models["w"], x, compute_dtype="float32")
    assert ours[0].shape == ref[0].shape and ours[1].shape == ref[1].shape
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-6)
    assert int(ours[1]) == int(ref[1]) == 5
    from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend

    be = TorchBackend()
    be.open({"model": writer_models["w"], "custom": "dtype=float32",
             "accelerator": "cpu"})
    try:
        assert be._batchable((((2, 8), torch.float32),)) is False
    finally:
        be.close()


def test_torch_custom_op_unregistered_fails_loudly(built_models):
    from nnstreamer_tpu_torch.modelio.tflite import TFLITE_CUSTOM_OPS

    saved = TFLITE_CUSTOM_OPS.pop("TFLite_Detection_PostProcess")
    try:
        m = load_model_file(built_models["detect"], compute_dtype="float32")
        be, sc = _detection_case(built_models["N"], built_models["C"], 2, 1)
        with pytest.raises(BackendError, match="no registered lowering"):
            m.fn(m.params, torch.from_numpy(be), torch.from_numpy(sc))
    finally:
        TFLITE_CUSTOM_OPS["TFLite_Detection_PostProcess"] = saved


def _push_one(desc, *tensors):
    pipe = tnns.parse_launch(desc)
    runner = tnns.PipelineRunner(pipe).start()
    pipe.get("src").push(TensorBuffer.of(*tensors))
    pipe.get("src").end()
    runner.wait(120)
    runner.stop()
    res = pipe.get("out").results
    assert len(res) == 1
    return res[0]


def test_torch_detect_decode_pipeline_correct_boxes(built_models):
    """detect → decode through the port's pipeline: the custom-op model's
    detections come out of tensor_decoder mode=bounding_boxes
    (postprocess scheme) as the boxes the interpreter finds."""
    N, C = built_models["N"], built_models["C"]
    be, sc = _detection_case(N, C, 5, 99)
    res = _push_one(
        f"appsrc name=src dims=4:{N}:1,{C + 1}:{N}:1 "
        f"types=float32,float32 ! "
        f"tensor_filter framework=tensorflow-lite "
        f"model={built_models['detect']} custom=dtype=float32 ! "
        f"tensor_decoder mode=bounding_boxes "
        f"option1=mobilenet-ssd-postprocess option3=0.5:0.5 "
        f"option4=200:200 ! tensor_sink name=out", be, sc)
    got = res.meta["boxes"]
    ref = _interpret(built_models["detect"], be, sc)
    rb, rs, nd = ref[0][0], ref[2][0], int(ref[3][0])
    keep = rs[:nd] >= 0.5
    exp = rb[:nd][keep] * 200.0
    assert len(got) == keep.sum()
    np.testing.assert_allclose(
        np.sort(got[:, :4], axis=0), np.sort(exp, axis=0), atol=0.05)


def _pose_reference_decode(hm, off, in_px=64, out_px=64):
    """Independent numpy PoseNet decode (tensordec-pose.c:845 rule), as
    the JAX tests write it."""
    h, w, k = hm.shape
    flat = hm.reshape(-1, k)
    idx = flat.argmax(0)
    ys, xs = np.unravel_index(idx, (h, w))
    score = flat[idx, np.arange(k)]
    fy = (ys + 0.5) / h + off[ys, xs, np.arange(k)] / in_px
    fx = (xs + 0.5) / w + off[ys, xs, k + np.arange(k)] / in_px
    return np.stack([fx * out_px, fy * out_px, score], axis=1)


@pytest.mark.parametrize("device", [False, True])
def test_torch_pose_pipeline_real_weights_golden(pose_model, device):
    """The converter-built pose model through tensor_filter →
    tensor_decoder mode=pose_estimation (host and device=true): the
    keypoints match an independent decode of the interpreter's outputs."""
    x = np.random.default_rng(21).normal(0, 1, (1, 64, 64, 3)) \
        .astype(np.float32)
    interp = _interpreter(pose_model["path"], builtin_only=True)
    interp.set_tensor(interp.get_input_details()[0]["index"], x)
    interp.invoke()
    outs = {tuple(o["shape"]): interp.get_tensor(o["index"])
            for o in interp.get_output_details()}
    K = pose_model["K"]
    exp = _pose_reference_decode(outs[(1, 8, 8, K)][0],
                                 outs[(1, 8, 8, 2 * K)][0])
    first = tuple(interp.get_output_details()[0]["shape"])
    combo = "" if first == (1, 8, 8, K) else "output_combination=o1,o0 "
    dev = "device=true " if device else ""
    res = _push_one(
        f"appsrc name=src dims=3:64:64:1 types=float32 ! "
        f"tensor_filter model={pose_model['path']} "
        f"custom=dtype=float32 {combo}! "
        f"tensor_decoder mode=pose_estimation {dev}option1=64:64 "
        f"option2=64:64 option4=0.0 ! tensor_sink name=out", x)
    got = (np.asarray(res.tensors[0]) if device else res.meta["keypoints"])
    assert got.shape == (K, 3)
    np.testing.assert_allclose(got, exp, atol=0.05)


def _ssd_reference_decode(loc, logits, anchors, score_thresh, iou_thresh,
                          out_px):
    """Independent numpy mobilenet-ssd decode (the JAX tests' rule)."""
    sc = 1.0 / (1.0 + np.exp(-logits))
    cls = sc[:, 1:].argmax(-1) + 1
    score = sc[np.arange(len(cls)), cls]
    keep = score >= score_thresh
    loc, cls, score, anchors = (loc[keep], cls[keep], score[keep],
                                anchors[keep])
    cy = loc[:, 0] / 10.0 * anchors[:, 2] + anchors[:, 0]
    cx = loc[:, 1] / 10.0 * anchors[:, 3] + anchors[:, 1]
    h = anchors[:, 2] * np.exp(loc[:, 2] / 5.0)
    w = anchors[:, 3] * np.exp(loc[:, 3] / 5.0)
    boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], 1)
    order = np.argsort(-score)
    chosen = []
    for i in order:
        ok = True
        for j in chosen:
            y0 = max(boxes[i, 0], boxes[j, 0])
            x0 = max(boxes[i, 1], boxes[j, 1])
            y1 = min(boxes[i, 2], boxes[j, 2])
            x1 = min(boxes[i, 3], boxes[j, 3])
            inter = max(0.0, y1 - y0) * max(0.0, x1 - x0)
            ai = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
            aj = (boxes[j, 2] - boxes[j, 0]) * (boxes[j, 3] - boxes[j, 1])
            union = ai + aj - inter
            if union > 0 and inter / union > iou_thresh:
                ok = False
                break
        if ok:
            chosen.append(i)
    det = np.concatenate(
        [boxes[chosen], score[chosen, None],
         cls[chosen, None].astype(np.float32)], axis=1)
    det[:, [0, 2]] *= out_px
    det[:, [1, 3]] *= out_px
    return det


@pytest.mark.parametrize("compact", [False, True])
def test_torch_raw_ssd_anchors_scheme_golden(raw_ssd_model, compact):
    """scheme=mobilenet-ssd on the converter-built raw SSD head (generated
    priors, decoder NMS; host and device=compact) against an independent
    numpy decode of the interpreter's outputs."""
    from nnstreamer_tpu_torch.models.ssd_mobilenet import generate_anchors

    x = np.random.default_rng(31).normal(0, 1, (1, 8, 8, 3)) \
        .astype(np.float32)
    interp = _interpreter(raw_ssd_model["path"], builtin_only=True)
    interp.set_tensor(interp.get_input_details()[0]["index"], x)
    interp.invoke()
    A, C = raw_ssd_model["A"], raw_ssd_model["C"]
    outs = {tuple(o["shape"]): interp.get_tensor(o["index"])
            for o in interp.get_output_details()}
    exp = _ssd_reference_decode(outs[(1, A, 4)][0], outs[(1, A, C)][0],
                                generate_anchors(), score_thresh=0.6,
                                iou_thresh=0.5, out_px=300)
    assert len(exp) >= 3          # the golden must actually exercise NMS
    first = tuple(interp.get_output_details()[0]["shape"])
    combo = "" if first == (1, A, 4) else "output_combination=o1,o0 "
    dev = "device=compact " if compact else ""
    res = _push_one(
        f"appsrc name=src dims=3:8:8:1 types=float32 ! "
        f"tensor_filter model={raw_ssd_model['path']} "
        f"custom=dtype=float32 {combo}! "
        f"tensor_decoder mode=bounding_boxes {dev}option1=mobilenet-ssd "
        f"option3=0.6:0.5 option4=300:300 ! tensor_sink name=out", x)
    got = res.meta["boxes"]
    assert got.shape == exp.shape
    np.testing.assert_allclose(got[np.argsort(-got[:, 4])],
                               exp[np.argsort(-exp[:, 4])], atol=0.1)


def test_torch_tflite_batch_override(writer_models):
    """custom=batch=N: the spec and the RESHAPE take the batch, slots are
    independent; the file's own batch refuses any other (the baked
    batch)."""
    m4 = load_model_file(writer_models["f"], batch=4,
                         compute_dtype="float32")
    assert m4.in_spec.tensors[0].shape == (4, 64, 64, 3)
    assert m4.out_spec.tensors[0].shape == (4, 1001)
    x1 = np.random.default_rng(3).normal(0, 0.5, (1, 64, 64, 3)) \
        .astype(np.float32)
    with torch.inference_mode():
        out4 = m4.fn(m4.params, torch.from_numpy(np.repeat(x1, 4, 0)))[0]
    out1 = port_run(writer_models["f"], x1, compute_dtype="float32")[0]
    np.testing.assert_allclose(out4.numpy(), np.repeat(out1, 4, 0),
                               atol=1e-5 * np.abs(out1).max())
    m1 = load_model_file(writer_models["f"], compute_dtype="float32")
    with pytest.raises(RuntimeError):
        m1.fn(m1.params, torch.zeros((2, 64, 64, 3)))

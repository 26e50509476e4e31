"""Model-file ingestion through the port's entry points
(nnstreamer_tpu_torch/modelio/__init__.py, params_io.py, the filter and
the torch backend), against the JAX package, on the CPU.

- `.npz` params files: the three JAX tests' mirrors (tree round trip,
  foreign archive, `model=saved.npz` running the zoo arch with the
  stored params); then both ways for each bridged arch (mobilenet_v2,
  ssd_mobilenet, posenet, transformer): a file the JAX package's
  `save_params` wrote from a JAX-layout tree gives the JAX model's
  outputs on the port, and a file the port's `save_params` wrote from
  its zoo model gives the port's outputs on the JAX model (JAX's
  `load_params` + its model's apply), within 1e-3·max (f32); an arch
  with no bridge raises naming it;
- the filter, on the writer's MobileNetV2 files (0.35 at 64²):
  `framework=tensorflow-lite model=x.tflite` (and its tensorflow1-lite,
  tensorflow2-lite, tensorflow aliases), extension auto-detect and
  `custom=dtype=int8` give the labels the
  JAX pipeline gives on the same file and frames; the float file behind
  `tensor_batch` runs one invoke a frame (its batch is baked) with
  outputs equal to the unbatched run's; the loader's refusals raise with
  their text, and a garbage file of each format of the second group and
  of `.pt` with the JAX loader's; with no card and no CPU
  request a model file's filter refuses to open;
- a `device=true` decoder after a filter with `output_combination` stays
  an element of its own (fault F6: the port fused it, and negotiation
  then refused the pipeline).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.modelio import load_params as jload_params
from nnstreamer_tpu.modelio import save_params as jsave_params
from nnstreamer_tpu_torch.core.errors import BackendError, NegotiationError
from nnstreamer_tpu_torch.modelio import (
    load_model_file, load_params, parse_loader_opts, save_params)

from test_torch_detection import random_params

SIZE, FRAMES = 64, 4
SRC = (f"videotestsrc num-buffers={FRAMES} width={SIZE} height={SIZE} "
       f"pattern=random seed=7 ! tensor_converter")
NORM = "tensor_filter framework=pallas model=normalize_u8"
LABEL = "tensor_decoder mode=image_labeling ! tensor_sink name=out"


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# -- .npz: the JAX tests' mirrors ------------------------------------------------

def test_torch_npz_roundtrip_preserves_tree(tmp_path):
    params = {"layer": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                        "b": np.zeros(3, np.int8)},
              "scales": [np.float32(1.5), np.ones(2)],
              "none_leaf": None,
              "tup": (np.uint8(7),)}
    p = str(tmp_path / "m.npz")
    save_params(p, "zoo://mobilenet_v2?width=0.35", params)
    arch, loaded = load_params(p)
    assert arch == "zoo://mobilenet_v2?width=0.35"
    assert loaded["none_leaf"] is None
    assert isinstance(loaded["tup"], tuple)
    np.testing.assert_array_equal(loaded["layer"]["w"], params["layer"]["w"])
    assert loaded["layer"]["b"].dtype == np.int8


def test_torch_npz_rejects_foreign_archive(tmp_path):
    p = str(tmp_path / "foreign.npz")
    np.savez(p, a=np.ones(3))
    with pytest.raises(BackendError, match="__meta__"):
        load_params(p)
    with pytest.raises(BackendError, match="__meta__"):
        load_model_file(p)


def test_torch_npz_model_file_runs_zoo_arch(tmp_path):
    """model=saved.npz rebuilds the zoo fn with the *stored* params."""
    from nnstreamer_tpu_torch.models.zoo import build_model

    arch = "zoo://mobilenet_v2?width=0.35&num_classes=10&dtype=float32"
    bundle = build_model(arch[len("zoo://"):])
    p = str(tmp_path / "m.npz")
    save_params(p, arch, bundle.params)
    loaded = load_model_file(p)
    assert loaded.name == f"m.npz({arch})"
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (1, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        got = loaded.fn(loaded.params, x)
        ref = bundle.fn(bundle.params, x)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_torch_npz_unbridged_arch_raises(tmp_path):
    from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2

    with pytest.raises(BackendError, match="zoo://lstm"):
        save_params(str(tmp_path / "x.npz"), "zoo://lstm",
                    MobileNetV2(0.35, num_classes=4))
    p = str(tmp_path / "y.npz")
    jsave_params(p, "pkg.module:attr", {"w": np.ones(2, np.float32)})
    with pytest.raises(BackendError, match="pkg.module:attr"):
        load_model_file(p)


# -- .npz both ways, every bridged arch --------------------------------------------

def _transformer_tree(seed=0, d=32, heads=2, layers=1, vocab=64):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])) \
            .astype(np.float32)

    return {"embed": w(vocab, d), "ln_f": np.ones(d, np.float32),
            "head": w(d, vocab),
            "blocks": [{"ln1": np.ones(d, np.float32), "wqkv": w(d, 3 * d),
                        "wo": w(d, d), "ln2": np.ones(d, np.float32),
                        "wi": w(d, 8 * d), "wd": w(4 * d, d)}
                       for _ in range(layers)]}


def _arch_case(name):
    """→ (arch, JAX-layout tree of numpy leaves, inputs, JAX apply)."""
    from nnstreamer_tpu.models import mobilenet_v2 as jm
    from nnstreamer_tpu.models import posenet as jp
    from nnstreamer_tpu.models import ssd_mobilenet as js
    from nnstreamer_tpu.models import transformer as jt

    rng = np.random.default_rng(11)
    f32 = jnp.float32
    if name == "transformer":
        arch = ("zoo://transformer?d_model=32&n_heads=2&n_layers=1&vocab=64"
                "&max_len=16")
        cache = rng.normal(0, 0.1, (1, 1, 16, 2, 16)).astype(np.float32)
        inputs = (np.asarray([[5]], np.int32), cache, cache.copy(),
                  np.asarray([3], np.int32))
        return arch, _transformer_tree(), inputs, lambda p, *xs: \
            jt.apply_step(p, *xs, n_heads=2, dtype=f32)
    init, mod, size, kw = {
        "mobilenet_v2": (jm.init_params, jm, 32,
                         dict(num_classes=10)),
        "posenet": (jp.init_params, jp, 65, {}),
        "ssd_mobilenet": (js.init_params, js, 300, {}),
    }[name]
    tree = random_params(init, width=0.35, **kw)
    q = "&".join([f"width=0.35", "dtype=float32"]
                 + [f"{k}={v}" for k, v in kw.items()]
                 + ([f"input_size={size}"] if name != "ssd_mobilenet"
                    else []))
    x = rng.normal(0, 1, (1, size, size, 3)).astype(np.float32)
    return (f"zoo://{name}?{q}", tree, (x,),
            functools.partial(mod.apply, width=0.35, dtype=f32))


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-3 * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("name", ["mobilenet_v2", "ssd_mobilenet", "posenet",
                                  "transformer"])
def test_torch_npz_files_move_both_ways(tmp_path, name):
    arch, tree, inputs, japply = _arch_case(name)
    jfn = jax.jit(japply)

    # JAX writes, the port loads
    pj = str(tmp_path / "jax.npz")
    jsave_params(pj, arch, tree)
    port = load_model_file(pj)
    with torch.inference_mode():
        got = port.fn(port.params, *(torch.from_numpy(x) for x in inputs))
    want = jfn(tree, *inputs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        _close(g.numpy(), w)

    # the port writes (from the bundle it loaded), JAX loads
    pt = str(tmp_path / "port.npz")
    save_params(pt, arch, port.params)
    arch2, tree2 = jload_params(pt)
    assert arch2 == arch
    back = jfn(tree2, *inputs)
    back = back if isinstance(back, tuple) else (back,)
    for g, w in zip(got, back):
        _close(w, g.numpy())
    # and the tree itself comes back as JAX wrote it
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree2, tree)


# -- the filter -------------------------------------------------------------------

@pytest.fixture(scope="module")
def mbv2_files(tmp_path_factory):
    from nnstreamer_tpu_torch.models.mobilenet_v2 import build
    from nnstreamer_tpu_torch.tools import tflite_fixture as fx

    d = tmp_path_factory.mktemp("torch_modelio_files")
    model = build(width=0.35, input_size=SIZE, dtype="float32").params
    fx.write_mobilenet_v2(model, d / "f.tflite", input_size=SIZE)
    fx.write_mobilenet_v2(model, d / "q.tflite", quant=True,
                          input_size=SIZE, calib_frames=2)
    return {"f": str(d / "f.tflite"), "q": str(d / "q.tflite")}


def _labels(pkg, desc, **runner_kw):
    pipe = pkg.parse_launch(desc)
    pkg.PipelineRunner(pipe, **runner_kw).run(180)
    res = pipe.get("out").results
    assert len(res) == FRAMES
    return [r.meta["label_index"] for r in res]


@pytest.fixture(scope="module")
def jax_labels(mbv2_files):
    """The JAX pipeline's labels on each file (float32 / int8)."""
    return {
        "f": _labels(jnns, f"{SRC} ! {NORM} ! tensor_filter "
                           f"model={mbv2_files['f']} custom=dtype=float32 "
                           f"! {LABEL}"),
        "q": _labels(jnns, f"{SRC} ! tensor_filter model={mbv2_files['q']} "
                           f"custom=dtype=int8 ! {LABEL}"),
    }


@pytest.mark.parametrize("how", ["tensorflow-lite", "tensorflow1-lite",
                                 "tensorflow2-lite", "tensorflow",
                                 "auto-detect"])
def test_torch_filter_tflite_labels_match_jax(mbv2_files, jax_labels, how):
    fw = "" if how == "auto-detect" else how
    desc = (f"{SRC} ! {NORM} ! tensor_filter name=m "
            f"{f'framework={fw} ' if fw else ''}"
            f"model={mbv2_files['f']} custom=dtype=float32 ! {LABEL}")
    assert _labels(tnns, desc) == jax_labels["f"]
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    assert TensorFilter(model=mbv2_files["f"],
                        framework=fw)._framework_name() == "torch"


def test_torch_filter_int8_labels_match_jax(mbv2_files, jax_labels):
    desc = (f"{SRC} ! tensor_filter framework=tensorflow-lite "
            f"model={mbv2_files['q']} custom=dtype=int8 ! {LABEL}")
    assert _labels(tnns, desc) == jax_labels["q"]


def test_torch_filter_float_file_micro_batched_runs_per_frame(mbv2_files):
    """Behind tensor_batch the float file runs one invoke a frame (its
    lowered batch is the file's 1: the batchability verdict refuses 2+),
    outputs bit for bit those of the unbatched run."""
    model = (f"tensor_filter name=m model={mbv2_files['f']} "
             f"custom=dtype=float32")
    outs = {}
    for batched in (False, True):
        mid = (f"tensor_batch max-batch=4 max-latency-ms=50 ! {NORM} ! "
               f"{model} ! tensor_unbatch" if batched else
               f"{NORM} ! {model}")
        pipe = tnns.parse_launch(f"{SRC} ! {mid} ! tensor_sink name=out")
        tnns.PipelineRunner(pipe, compiled_loop=False).run(180)
        outs[batched] = pipe.get("out").results
        be = pipe.get("m").backend
        if batched:
            assert be.batch_size_hist == {}          # no batched call
            assert be._batch_ok and not any(be._batch_ok.values())
    assert len(outs[True]) == len(outs[False]) == FRAMES
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(np.asarray(a.tensors[0]),
                                      np.asarray(b.tensors[0]))


@pytest.mark.parametrize("ext", ["pb", "pt", "uff", "caffemodel", "dlc",
                                 "rtm"])
def test_torch_formats_not_ported_raise(tmp_path, ext):
    """Every format is ported: a garbage file of each (a .pt included)
    fails loud with the JAX loader's text."""
    from nnstreamer_tpu.core.errors import BackendError as JBackendError
    from nnstreamer_tpu.modelio import load_model_file as jload_model_file

    p = tmp_path / f"m.{ext}"
    p.write_bytes(b"\x00" * 16)
    with pytest.raises(BackendError) as got:
        load_model_file(str(p))
    with pytest.raises(JBackendError) as want:
        jload_model_file(str(p))
    assert str(got.value) == str(want.value)


def test_torch_caffe2_pair_refused(tmp_path):
    from nnstreamer_tpu.core.errors import BackendError as JBackendError
    from nnstreamer_tpu.modelio import load_model_file as jload_model_file

    with pytest.raises(BackendError, match="exactly"):
        load_model_file("a.pb,b.pb,c.pb")
    with pytest.raises(BackendError, match="does not exist"):
        load_model_file("/nope/i.pb,/nope/p.pb")
    a, b = tmp_path / "i.pb", tmp_path / "p.pb"
    a.write_bytes(b"x")
    b.write_bytes(b"x")
    with pytest.raises(BackendError, match="is not a caffe2 NetDef") as got:
        load_model_file(f"{a},{b}")
    with pytest.raises(JBackendError) as want:
        jload_model_file(f"{a},{b}")
    assert str(got.value) == str(want.value)


def test_torch_loader_refusals(tmp_path, mbv2_files):
    """The JAX loader's refusals, with their text."""
    with pytest.raises(BackendError, match="apply to .pb/.uff"):
        load_model_file(mbv2_files["f"], input_names=["x"])
    with pytest.raises(BackendError, match="init,predict pairs only"):
        load_model_file(mbv2_files["f"], side=224)
    npz = str(tmp_path / "m.npz")
    save_params(npz, "zoo://mobilenet_v2?width=0.35", {"w": np.ones(2)})
    with pytest.raises(BackendError, match="not consumed by .npz"):
        load_model_file(npz, compute_dtype="float32")
    assert parse_loader_opts("batch=8, dtype=float32, quantize_output=false") \
        == {"batch": 8, "compute_dtype": "float32", "quantize_output": False}


def test_torch_model_file_filter_needs_card_or_cpu_request(monkeypatch,
                                                            mbv2_files):
    monkeypatch.delenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR",
                       raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pipe = tnns.parse_launch(
        f"{SRC} ! tensor_filter framework=tensorflow-lite "
        f"model={mbv2_files['q']} custom=dtype=int8 ! tensor_sink name=out")
    with pytest.raises(NegotiationError, match="accelerator=cpu"):
        tnns.PipelineRunner(pipe).start()


def test_torch_device_decoder_after_output_combination_stays_separate():
    """Fault F6: the fusion pass fused a device=true decoder into a filter
    with output_combination, and negotiation then refused the pipeline;
    the JAX package keeps such a decoder an element of its own. Here a
    model emitting (offsets, heatmaps) is reordered with
    output_combination=o1,o0 for the pose decoder on the device, and
    decodes as the host decoder does."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle

    rng = np.random.default_rng(3)
    heat = torch.from_numpy(rng.uniform(0, 1, (1, 5, 5, 17))
                            .astype(np.float32))
    off = torch.from_numpy(rng.normal(0, 2, (1, 5, 5, 34))
                           .astype(np.float32))
    bundle = ModelBundle(fn=lambda p, x: (off + 0 * x.sum(),
                                          heat + 0 * x.sum()),
                         name="two_outputs")
    got = {}
    for dev in ("device=true ", ""):
        pipe = tnns.parse_launch(
            "appsrc name=src dims=3:65:65:1 types=float32 ! tensor_filter "
            "name=f output_combination=o1,o0 ! tensor_decoder "
            f"name=dec mode=pose_estimation {dev}option1=65:65 "
            "option2=65:65 option4=0.0 ! tensor_sink name=out")
        pipe.get("f").set_props(model=bundle)
        runner = tnns.PipelineRunner(pipe).start()
        pipe.get("src").push(tnns.TensorBuffer.of(
            np.zeros((1, 65, 65, 3), np.float32)))
        pipe.get("src").end()
        runner.wait(60)
        runner.stop()
        assert "dec" in pipe.elements          # not fused away
        (res,) = pipe.get("out").results
        got[dev] = (np.asarray(res.tensors[0]) if dev
                    else res.meta["keypoints"])
    np.testing.assert_allclose(got["device=true "], got[""], atol=1e-4)

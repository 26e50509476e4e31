"""Pipelines A and B through the port and through the JAX package, on the
same frames and the same (bridged) MobileNetV2 parameters.

A (quick start, fused transform):
  videotestsrc ! tensor_converter ! tensor_transform mode=arithmetic
  option=typecast:float32,add:-127.5,div:127.5 ! tensor_filter
  model=zoo://mobilenet_v2 ! tensor_decoder mode=image_labeling ! tensor_sink
B (kernel path):
  videotestsrc ! tensor_converter ! tensor_filter framework=pallas
  model=normalize_u8 ! tensor_filter model=zoo://mobilenet_v2 !
  tensor_decoder mode=image_labeling ! tensor_sink

Both run at a small size (width 0.35, 64x64 frames) in f32 on the CPU,
with the filter's model= set to each package's bundle. Checks: the same
label_index per frame, logits within 1e-4 of max |logit| (the model
test's tolerance), with fusion on and off and with tensor_decoder
device=true. The transform's integer arithmetic and promotion are held
to the JAX package's TransformProgram exactly.
"""

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.elements.transform import TransformProgram as JaxProgram
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.tensor.info import TensorInfo as JInfo
from nnstreamer_tpu_torch.elements.transform import TransformProgram
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.tensor.info import TensorInfo

from test_torch_mobilenet import randomize_bn

WIDTH, SIZE, FRAMES = 0.35, 64, 3
SRC = (f"videotestsrc num-buffers={FRAMES} width={SIZE} height={SIZE} "
       f"pattern=random seed=7 ! tensor_converter")
NORM_A = ("tensor_transform mode=arithmetic "
          "option=typecast:float32,add:-127.5,div:127.5")
NORM_B = "tensor_filter framework=pallas model=normalize_u8"
MODEL = "tensor_filter name=f model=zoo://mobilenet_v2"
LABEL = "tensor_decoder mode=image_labeling"


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bundles():
    """(JAX bundle, port bundle) holding the same f32 parameters."""
    jb = jm.build(width=WIDTH, input_size=SIZE, dtype="float32", seed=0)
    params = randomize_bn(jax.tree_util.tree_map(np.asarray, jb.params),
                          seed=1)
    jb.params = params
    tb = tm.build(width=WIDTH, input_size=SIZE, dtype="float32")
    bridge.load_mobilenet_v2(tb.params, params)
    return jb, tb


def _run(pkg, desc, bundle, optimize):
    pipe = pkg.parse_launch(desc)
    pipe.get("f").set_props(model=bundle)
    pkg.PipelineRunner(pipe, optimize=optimize).run(120)
    return pipe.get("out").results


CASES = {
    "A-fused": (f"{SRC} ! {NORM_A} ! {MODEL}", True),
    "A-unfused": (f"{SRC} ! {NORM_A} ! {MODEL}", False),
    "B": (f"{SRC} ! {NORM_B} ! {MODEL}", True),
    "B-unfused": (f"{SRC} ! {NORM_B} ! {MODEL}", False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_jax(bundles, case):
    head, optimize = CASES[case]
    desc = f"{head} ! tensor_sink name=out"
    ref = _run(jnns, desc, bundles[0], optimize)
    got = _run(tnns, desc, bundles[1], optimize)
    assert len(got) == len(ref) == FRAMES
    for r, g in zip(ref, got):
        r, g = np.asarray(r.tensors[0]), g.tensors[0]
        assert isinstance(g, np.ndarray) and g.shape == r.shape == (1, 1001)
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g, r, atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_labels_match_jax(bundles, case):
    head, optimize = CASES[case]
    desc = f"{head} ! {LABEL} ! tensor_sink name=out"
    ref = _run(jnns, desc, bundles[0], optimize)
    got = _run(tnns, desc, bundles[1], optimize)
    assert [b.meta["label_index"] for b in got] == \
        [b.meta["label_index"] for b in ref]
    assert [b.meta["label"] for b in got] == [b.meta["label"] for b in ref]
    for r, g in zip(ref, got):
        assert abs(g.meta["score"] - r.meta["score"]) <= \
            1e-4 * abs(r.meta["score"])


@pytest.mark.parametrize("case", ["A-fused", "B", "B-unfused"])
def test_device_decode_matches_jax(bundles, case):
    head, optimize = CASES[case]
    desc = f"{head} ! {LABEL} device=true ! tensor_sink name=out"
    ref = _run(jnns, desc, bundles[0], optimize)
    got = _run(tnns, desc, bundles[1], optimize)
    assert len(got) == FRAMES
    for r, g in zip(ref, got):
        assert g.tensors[0].dtype == np.int32 and g.tensors[0].shape == (1,)
        np.testing.assert_array_equal(g.tensors[0], np.asarray(r.tensors[0]))


def test_fusion_removes_transform_and_decoder(bundles):
    from nnstreamer_tpu_torch.graph.optimize import fuse_transforms

    pipe = tnns.parse_launch(
        f"{SRC} ! {NORM_A} ! {MODEL} ! {LABEL} device=true ! tensor_sink "
        f"name=out")
    assert fuse_transforms(pipe) == 2
    kinds = sorted(type(e).__name__ for e in pipe.elements.values())
    assert kinds == ["TensorConverter", "TensorFilter", "TensorSink",
                     "VideoTestSrc"]


def test_filter_stages_uint8_and_elides_device_inputs(bundles):
    """The fused transform runs after staging: the frame crosses as uint8,
    and B's second filter finds its input already on the device."""
    pipe = tnns.parse_launch(f"{SRC} ! {NORM_A} ! {MODEL} ! tensor_sink "
                             f"name=out")
    pipe.get("f").set_props(model=bundles[1])
    tnns.PipelineRunner(pipe).run(60)
    backend = pipe.get("f").backend
    assert (backend.staging_transfers, backend.staging_elided) == (FRAMES, 0)
    pipe = tnns.parse_launch(f"{SRC} ! {NORM_B} ! {MODEL} ! tensor_sink "
                             f"name=out")
    pipe.get("f").set_props(model=bundles[1])
    tnns.PipelineRunner(pipe).run(60)
    backend = pipe.get("f").backend
    assert (backend.staging_transfers, backend.staging_elided) == (0, FRAMES)


_DTYPES = ["uint8", "int8", "uint16", "int16", "float32"]
_OPTIONS = ["add:10", "add:-10", "sub:3", "mul:2", "mul:-2", "mul:3,add:1",
            "add:1.5", "div:2", "typecast:float32,add:-127.5,div:127.5",
            "typecast:int16,mul:300", "add:1:2:3", "typecast:uint8,add:7"]


@pytest.mark.parametrize("option", _OPTIONS)
@pytest.mark.parametrize("dtype", _DTYPES)
def test_transform_arithmetic_matches_jax(dtype, option):
    rng = np.random.default_rng(len(option))
    if dtype == "float32":
        x = rng.uniform(-100, 100, (2, 5, 3)).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, (2, 5, 3), endpoint=True,
                         dtype=dtype)
    ref = JaxProgram("arithmetic", option).apply(np, x.copy())
    prog = TransformProgram("arithmetic", option)
    host = prog.apply(x.copy())
    dev = prog.apply(torch.from_numpy(x.copy())).numpy()
    for got in (host, dev):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert prog.out_info(TensorInfo(x.shape, dtype)).dtype.type_name == \
        JaxProgram("arithmetic", option).out_info(
            JInfo(x.shape, dtype)).dtype.type_name == str(ref.dtype)


def test_label_file_matches_jax(bundles, tmp_path):
    """option1 labels file with classes-1 entries (class 0 = background):
    both packages print the same label text per frame."""
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"label-{i}\n" for i in range(1000)))
    desc = (f"{CASES['B'][0]} ! {LABEL} option1={labels} ! tensor_sink "
            f"name=out")
    ref = _run(jnns, desc, bundles[0], True)
    got = _run(tnns, desc, bundles[1], True)
    assert [b.meta["label"] for b in got] == [b.meta["label"] for b in ref]
    for b in got:
        assert b.meta["label"] == f"label-{b.meta['label_index'] - 1}"
        assert bytes(b.tensors[0]).decode() == b.meta["label"]


def test_custom_kernel_filter_runs_on_the_filters_device():
    from nnstreamer_tpu_torch.backends.pallas_backend import (
        register_pallas_filter)

    @register_pallas_filter("test_negate_as_f32")
    def negate(tensors):
        return tuple(-t.to(torch.float32) for t in tensors)

    pipe = tnns.parse_launch(
        "videotestsrc num-buffers=2 width=8 height=4 ! tensor_converter ! "
        "tensor_filter framework=pallas model=test_negate_as_f32 ! "
        "tensor_sink name=out")
    tnns.PipelineRunner(pipe).run(60)
    out = pipe.get("out").results
    [spec] = pipe.get("out").in_specs
    assert spec.tensors[0].dtype.type_name == "float32"
    assert spec.tensors[0].shape == (1, 4, 8, 3)
    assert len(out) == 2 and out[0].tensors[0].dtype == np.float32
    assert out[0].tensors[0].max() <= 0


def test_host_sync_choke_point_ignores_cpu_tensors():
    from nnstreamer_tpu_torch.runtime.sync import device_sync, forced_sync_count

    before = forced_sync_count()
    ts = (torch.zeros(3), np.zeros(2))
    assert device_sync(ts) is ts
    assert forced_sync_count() == before


def test_to_host_brings_tensors_back_as_numpy():
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    buf = TensorBuffer.of(torch.arange(4, dtype=torch.int32),
                          torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
                          np.zeros(2, np.uint8))
    assert buf.on_device
    host = buf.to_host()
    assert not host.on_device
    a, b, c = host.tensors
    np.testing.assert_array_equal(a, [0, 1, 2, 3])
    assert str(b.dtype) == "bfloat16"
    np.testing.assert_array_equal(b.astype(np.float32), [1.5, -2.25])
    assert c is buf.tensors[2]

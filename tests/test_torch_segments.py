"""Device segments on the port (graph/optimize.fuse_segments,
TorchBackend.compose_segment, the filter's member negotiation and host
fallback, the runner's ``device_segments``) against the JAX package's
(tests/test_segments.py's pipelines, run through both packages).

The gates:

- `fuse_segments` splices the same elements as JAX's on the same
  pipeline strings, and the runner reports the same segments;
- outputs with segments on equal those with segments off bit for bit,
  and JAX's (the pipelines' models are exact in f32);
- a declined composition (a canary member, a member on another logical
  device) runs the members host side with the same bits;
- a member's failure is charged to the member (SegmentStageError);
- a member's store swap is adopted at a segment boundary, never inside;
- SEG — config 1's MobileNetV2 (width 0.35, 64², f32) cut at the pooled
  features into a backbone and a classifier store model joined by a
  typecast — composes into one segment, its compiled windows give its
  per-frame bits, and its logits are within 1e-6 of max |logit| of the
  segments-off run and of the whole zoo model. (On the CPU a filter's
  worker thread sums a matrix product in a thread-dependent order, so a
  classifier run in a thread of its own may differ in the last bit; on
  the card, chip_smoke.py phase 48 holds SEG bit for bit.)

No wall-clock assertion is copied.
"""

import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.graph.optimize import fuse_segments as j_fuse_segments
from nnstreamer_tpu.serving.store import reset_store as j_reset_store
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JTensorBuffer
from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.graph.optimize import fuse_segments
from nnstreamer_tpu_torch.models import layers as L
from nnstreamer_tpu_torch.models.zoo import build_model
from nnstreamer_tpu_torch.serving.store import reset_store
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

PKGS = {"torch": (tnns, TensorBuffer, reset_store, fuse_segments),
        "jax": (jnns, JTensorBuffer, j_reset_store, j_fuse_segments)}


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", "8")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    reset_store()
    j_reset_store()
    yield
    reset_store()
    j_reset_store()
    torch.set_num_threads(threads)


def _models(store):
    store.register("seg_m1", lambda x: (x * 2.0,))
    store.register("seg_m2", lambda x: (x + 1.0,))
    store.register("seg_m3", lambda x: (-x,))


TWO = ("appsrc name=src dims=4 types=float32 ! "
       "tensor_filter name=f1 model=store://seg_m1 ! "
       "tensor_transform name=t1 mode=arithmetic option=mul:0.5 ! "
       "tensor_filter name=f2 model=store://seg_m2 ! tensor_sink name=out")
SPLICES = [
    TWO,
    ("appsrc name=src dims=4 types=float32 ! "
     "tensor_filter name=fa model=store://seg_m1 ! "
     "tensor_filter name=fb model=store://seg_m2 ! "
     "tensor_transform name=t1 mode=arithmetic option=add:3.0 ! "
     "tensor_filter name=fc model=store://seg_m3 ! tensor_sink name=out"),
    ("appsrc name=src dims=4 types=float32 ! "
     "tensor_filter name=f1 model=store://seg_m1 ! "
     "tensor_filter name=f2 model=store://seg_m2 error-policy=skip ! "
     "tensor_sink name=out"),
    ("appsrc name=src dims=4 types=float32 ! "
     "tensor_filter name=f1 model=store://seg_m1 ! "
     "tensor_transform name=t1 mode=arithmetic option=mul:0.5 "
     "error-policy=skip ! "
     "tensor_filter name=f2 model=store://seg_m2 ! tensor_sink name=out"),
    ("appsrc name=src dims=4 types=float32 ! "
     "tensor_filter name=f1 model=store://seg_m1 ! "
     "tensor_filter name=f2 model=store://seg_m2 latency-mode=sync ! "
     "tensor_sink name=out"),
]


@pytest.mark.parametrize("desc", SPLICES)
def test_fuse_segments_splices_as_jax(desc, eight_cpu_devices):
    got = []
    for pkg, _, reset, fuse in PKGS.values():
        _models(reset())
        pipe = pkg.parse_launch(desc)
        removed = fuse(pipe)
        heads = {e.name: e.segment_name() for e in pipe.elements.values()
                 if getattr(e, "segment_name", None) and e.segment_name()}
        got.append((removed, set(pipe.elements), heads,
                    sorted((l.src.name, l.dst.name) for l in pipe.links)))
    assert got[0] == got[1]


def _run(name, desc, frames=8, **runner_kw):
    pkg, Buffer, reset, _ = PKGS[name]
    _models(reset())
    pipe = pkg.parse_launch(desc)
    runner = pkg.PipelineRunner(pipe, **runner_kw)
    runner.start()
    src, sink = pipe.get("src"), pipe.get("out")
    try:
        for i in range(frames):
            src.push(Buffer.of(np.full((4,), float(i), np.float32), pts=i))
        src.end()
        runner.wait(30)
    finally:
        runner.stop()
    return [np.asarray(b.tensors[0]) for b in sink.results], runner


def test_runner_fuses_by_default_and_reports_as_jax(eight_cpu_devices):
    out, r = _run("torch", TWO, trace=True)
    jout, jr = _run("jax", TWO, trace=True)
    assert r.device_segments() == jr.device_segments() == [
        {"head": "f1", "segment": "f1+f2", "size": 2, "composed": True}]
    st = r.stats()["f1"]
    assert (st["segment"], st["segment_size"], st["segment_composed"]) == \
        ("f1+f2", 2, 1)
    assert "f2" not in r.stats()
    rep = r.report()
    assert "device segments" in rep and "f1+f2: 2 filters, composed" in rep
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(a, b)


def test_device_segments_off_keeps_elements():
    _, r = _run("torch", TWO, device_segments=False)
    assert r.device_segments() == []
    assert "f2" in r.stats()


def test_config_knob_turns_segments_off(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_RUNTIME_DEVICE_SEGMENTS", "0")
    _, r = _run("torch", TWO)
    assert r.device_segments() == []


def test_on_equals_off_bit_for_bit_and_jax():
    on, r_on = _run("torch", TWO, frames=16)
    off, r_off = _run("torch", TWO, frames=16, device_segments=False)
    jon, _ = _run("jax", TWO, frames=16)
    assert r_on.device_segments() and not r_off.device_segments()
    assert len(on) == len(off) == 16
    for a, b, c in zip(on, off, jon):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_decline_canary_member_host_fallback_identical():
    store = reset_store()
    _models(store)
    store.register("seg_m2", lambda x: (x + 100.0,))     # v2: the canary
    desc = ("appsrc name=src dims=4 types=float32 ! "
            "tensor_filter name=f1 model=store://seg_m1 ! "
            "tensor_filter name=f2 model=store://seg_m2@2:0.01 ! "
            "tensor_sink name=out")
    pipe = tnns.parse_launch(desc)
    r = tnns.PipelineRunner(pipe).start()
    for i in range(8):
        pipe.get("src").push(TensorBuffer.of(
            np.full((4,), float(i), np.float32), pts=i))
    pipe.get("src").end()
    r.wait(30)
    r.stop()
    st = r.stats()["f1"]
    assert st["segment"] == "f1+f2" and st["segment_composed"] == 0
    vals = [float(np.asarray(b.tensors[0]).ravel()[0])
            for b in pipe.get("out").results]
    assert vals == [i * 2.0 + 1.0 for i in range(8)]


def test_decline_member_on_another_ordinal_identical():
    desc = TWO.replace("model=store://seg_m2",
                       "model=store://seg_m2 accelerator=cpu:1")
    out, r = _run("torch", desc)
    (seg,) = r.device_segments()
    assert seg["segment"] == "f1+f2" and seg["composed"] is False
    ref, _ = _run("torch", TWO, device_segments=False)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_conservation_with_upstream_faults():
    desc = ("appsrc name=src dims=4 types=float32 ! "
            "tensor_fault name=flt mode=raise probability=0.15 seed=11 "
            "error-policy=skip ! "
            "tensor_filter name=f1 model=store://seg_m1 ! "
            "tensor_filter name=f2 model=store://seg_m2 ! "
            "tensor_sink name=out")
    out, r = _run("torch", desc, frames=60)
    assert r.device_segments()
    st = r.stats()["flt"]
    assert st["errors"] > 0
    assert len(out) + st["skipped"] == 60


@pytest.mark.parametrize("composed", [True, False])
def test_member_failure_charged_to_the_member(composed):
    store = reset_store()
    armed = {"on": False}     # negotiation runs fine; the stream fails

    def boom(x):
        if armed["on"]:
            raise RuntimeError("member model exploded")
        return (x + 1.0,)

    store.register("seg_m1", lambda x: (x * 2.0,))
    store.register("seg_boom", boom)
    if not composed:
        store.register("seg_boom", boom)                 # v2, the canary
    ref = "store://seg_boom" + ("" if composed else "@2:0.5")
    pipe = tnns.parse_launch(
        "appsrc name=src dims=4 types=float32 ! "
        "tensor_filter name=f1 model=store://seg_m1 ! "
        f"tensor_filter name=f2 model={ref} ! tensor_sink name=out")
    runner = tnns.PipelineRunner(pipe)
    with pytest.raises(StreamError, match="segment member 'f2'"):
        runner.start()
        assert runner.device_segments()[0]["composed"] is composed
        armed["on"] = True
        try:
            pipe.get("src").push(TensorBuffer.of(np.ones((4,), np.float32)))
            pipe.get("src").end()
            runner.wait(30)
        finally:
            runner.stop()


def test_member_swap_adopted_at_a_segment_boundary():
    store = reset_store()
    _models(store)
    store.register("seg_m2", lambda x: (x + 100.0,))
    pipe = tnns.parse_launch(
        "appsrc name=src dims=4 types=float32 ! "
        "tensor_filter name=f1 model=store://seg_m1 ! "
        "tensor_filter name=f2 model=store://seg_m2 ! tensor_sink name=out")
    runner = tnns.PipelineRunner(pipe, trace=True)
    runner.start()
    src, sink = pipe.get("src"), pipe.get("out")
    try:
        for _ in range(8):
            src.push(TensorBuffer.of(np.ones((4,), np.float32)))
        deadline = time.monotonic() + 15
        while len(sink.results) < 8:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        store.update("seg_m2", wait_s=None)
        for _ in range(8):
            src.push(TensorBuffer.of(np.ones((4,), np.float32)))
        src.end()
        runner.wait(30)
    finally:
        runner.stop()
    vals = [float(np.asarray(b.tensors[0]).ravel()[0]) for b in sink.results]
    assert len(vals) == 16 and set(vals) == {3.0, 102.0}
    flip = vals.index(102.0)
    assert all(v == 3.0 for v in vals[:flip])
    assert all(v == 102.0 for v in vals[flip:])
    assert runner.stats()["f1"]["backend_swaps"] == 1


def test_transform_filter_transform_filter_decoder_one_element():
    store = reset_store()
    store.register("seg_m1", lambda x: (x * 2.0,))
    store.register("seg_m2", lambda x: (x + torch.arange(
        4, dtype=torch.float32),))
    pipe = tnns.parse_launch(
        "appsrc name=src dims=4 types=float32 ! "
        "tensor_transform mode=arithmetic option=add:1.0 ! "
        "tensor_filter name=f1 model=store://seg_m1 ! "
        "tensor_transform mode=arithmetic option=mul:2.0 ! "
        "tensor_filter name=f2 model=store://seg_m2 ! "
        "tensor_decoder mode=image_labeling device=true ! "
        "tensor_sink name=out")
    r = tnns.PipelineRunner(pipe).start()
    for i in range(6):
        pipe.get("src").push(TensorBuffer.of(
            np.full((4,), float(i), np.float32), pts=i))
    pipe.get("src").end()
    r.wait(30)
    r.stop()
    assert set(pipe.elements) == {"src", "f1", "out"}
    st = r.stats()["f1"]
    assert st["segment"] == "f1+f2" and st["segment_composed"] == 1
    assert all(int(np.asarray(b.tensors[0]).ravel()[0]) == 3
               for b in pipe.get("out").results)


# -- SEG: config 1's MobileNetV2 cut at the pooled features --------------------

MBV2 = "mobilenet_v2?width=0.35&input_size=64&dtype=float32"


def seg_bundles(zoo_ref: str = MBV2):
    """(backbone, classifier) bundles over one zoo MobileNetV2 module and
    its parameters: the backbone gives the pooled features in f32, the
    classifier maps them (after a typecast to the compute dtype) to
    logits, together the zoo model's forward."""
    m = build_model(zoo_ref).params

    def backbone(mod, x):
        h = x.to(mod.dtype).permute(0, 3, 1, 2)
        h = mod.stem(h)
        for block in mod.blocks:
            h = block(h)
        return L.global_avg_pool(mod.head(h)).to(torch.float32)

    def classifier(dense, h):
        return dense(h).to(torch.float32)

    return (ModelBundle(fn=backbone, params=m, name="mbv2_backbone"),
            ModelBundle(fn=classifier, params=m.classifier,
                        name="mbv2_classifier"))


SEG_MID = ("tensor_filter name=bb model=store://seg_bb ! tensor_transform "
           "mode=typecast option=float32 ! tensor_filter name=cl "
           "model=store://seg_cl")


def _seg_run(mid, frames, **runner_kw):
    store = reset_store()
    bb, cl = seg_bundles()
    store.register("seg_bb", bb)
    store.register("seg_cl", cl)
    pipe = tnns.parse_launch(
        f"appsrc name=src dims=3:64:64:1 types=uint8 ! "
        f"tensor_filter framework=pallas model=normalize_u8 ! {mid} ! "
        f"tensor_sink name=out")
    r = tnns.PipelineRunner(pipe, queue_capacity=32, **runner_kw)
    for i, f in enumerate(frames):
        pipe.get("src").push(TensorBuffer.of(f, pts=i))
    pipe.get("src").end()
    r.start()
    r.wait(120)
    r.stop()
    return [np.asarray(b.tensors[0]) for b in pipe.get("out").results], r


def test_seg_mobilenet_composes_and_matches():
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (1, 64, 64, 3), np.uint8)
              for _ in range(12)]
    on, r = _seg_run(SEG_MID, frames, compiled_loop=False)
    assert r.device_segments() == [{"head": "bb", "segment": "bb+cl",
                                    "size": 2, "composed": True}]
    win, rw = _seg_run(SEG_MID, frames)
    off, _ = _seg_run(SEG_MID, frames, device_segments=False,
                      compiled_loop=False)
    whole, _ = _seg_run(f"tensor_filter model=zoo://{MBV2}", frames,
                        compiled_loop=False)
    assert rw.stats()["bb"]["backend_window_frames"] > 0
    assert len(on) == len(win) == len(off) == len(whole) == 12
    for a, w, b, c in zip(on, win, off, whole):
        np.testing.assert_array_equal(a, w)       # windows: the same bits
        scale = float(np.abs(c).max())
        assert float(np.abs(a - b).max()) <= 1e-6 * scale
        assert float(np.abs(a - c).max()) <= 1e-6 * scale

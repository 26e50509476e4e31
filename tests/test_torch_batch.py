"""Deadline micro-batching in the port (tensor_batch / tensor_unbatch and
the torch backend's batched invokes) held to the JAX package's on the
same pipelines and inputs, on the CPU.

From tests/test_batch.py: full, partial-at-EOS and deadline flushes with
the same order, pts, meta and flush reasons as JAX (the deadline test
without its wall-clock bound), multi-stream routing, the negotiation
refusals, the per-frame spec downstream, bucketed invokes under ragged
occupancies (`bucket_shapes` equal to JAX's `compile_count`), stack
mode, a batch-rejecting model on the per-frame path; then pipeline B
micro-batched against the same string in JAX, and against itself
unbatched.
"""

import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu.elements as jel
import nnstreamer_tpu_torch as tnns
import nnstreamer_tpu_torch.elements as tel
from nnstreamer_tpu.backends.xla import XLABackend
from nnstreamer_tpu.core.errors import NegotiationError as JNegotiationError
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
from nnstreamer_tpu.tensor.dtypes import DType as JDType
from nnstreamer_tpu.tensor.info import TensorInfo as JInfo
from nnstreamer_tpu.tensor.info import TensorsSpec as JSpec
from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
from nnstreamer_tpu_torch.core.errors import NegotiationError
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

from test_torch_pipeline import bundles  # noqa: F401 (fixture)

SPEC = TensorsSpec.of(TensorInfo((1, 4), DType.FLOAT32))
JSPEC = JSpec.of(JInfo((1, 4), JDType.FLOAT32))
PKGS = {"jax": (jnns, jel, JBuffer, JSPEC), "torch": (tnns, tel, TensorBuffer,
                                                      SPEC)}


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _affine(x):
    return x * 2.0 + 1.0


def _frame(buf_cls, v, pts):
    return buf_cls.of(np.full((1, 4), float(v), np.float32), pts=pts)


def _chain(pipe, stages):
    for e in stages:
        pipe.add(e)
    for a, b in zip(stages, stages[1:]):
        pipe.link(a, b)


def _outputs(results):
    return [(o.pts, np.asarray(o.tensors[0]).tolist(),
             {k: v for k, v in o.meta.items() if k != "_trace_src_ts"})
            for o in results]


def _batch_run(kind, max_batch, max_latency_ms, frames, with_filter,
               one_at_a_time=False):
    """src ! tensor_batch ! [filter _affine] ! tensor_unbatch ! sink in
    package `kind`; frame i holds i and meta tag frame<i>. → (outputs,
    the batcher's stats)."""
    pkg, el, buf_cls, spec = PKGS[kind]
    pipe = pkg.Pipeline()
    src, sink = el.AppSrc("src", spec=spec), el.TensorSink("sink")
    mid = [el.TensorFilter("f", framework="xla", model=_affine)] \
        if with_filter else []
    _chain(pipe, [src, el.TensorBatch("b", max_batch=max_batch,
                                      max_latency_ms=max_latency_ms)]
           + mid + [el.TensorUnbatch("u"), sink])
    runner = pkg.PipelineRunner(pipe).start()
    for i in range(frames):
        buf = _frame(buf_cls, i, pts=i)
        buf.meta["tag"] = f"frame{i}"
        src.push(buf)
        if one_at_a_time:
            # wait for this frame's deadline flush before the next push
            deadline = time.monotonic() + 30
            while len(sink.results) <= i and time.monotonic() < deadline:
                time.sleep(0.005)
    src.end()
    runner.wait(60)
    runner.stop()
    return _outputs(sink.results), runner.stats()["b"]


FLUSHES = {
    # 10 frames at max-batch 4: two full flushes and a partial EOS one
    "full_and_eos": dict(max_batch=4, max_latency_ms=1000, frames=10,
                         with_filter=True),
    # fewer frames than max-batch: only EOS drains them
    "partial_at_eos": dict(max_batch=64, max_latency_ms=60000, frames=3,
                           with_filter=False),
    # each frame waits alone for its deadline (a slow source)
    "deadline": dict(max_batch=64, max_latency_ms=20, frames=4,
                     with_filter=False, one_at_a_time=True),
}


@pytest.mark.parametrize("case", sorted(FLUSHES))
def test_flushes_match_jax(case):
    ref, jst = _batch_run("jax", **FLUSHES[case])
    got, tst = _batch_run("torch", **FLUSHES[case])
    assert got == ref
    n = FLUSHES[case]["frames"]
    assert [o[0] for o in got] == list(range(n))
    for k in ("frames_in", "batches_out", "flush_full", "flush_deadline",
              "flush_eos", "occupancy_hist", "occupancy_avg"):
        assert tst[k] == jst[k], k
    if case == "full_and_eos":
        assert tst["occupancy_hist"] == {2: 1, 4: 2}
        assert (tst["flush_full"], tst["flush_eos"]) == (2, 1)
        for pts, vals, meta in got:
            assert vals == [[pts * 2.0 + 1.0] * 4]
            assert meta["tag"] == f"frame{pts}" and meta["batch_seq"] == pts
    if case == "partial_at_eos":
        assert tst["occupancy_hist"] == {3: 1} and tst["flush_full"] == 0
    if case == "deadline":
        # every frame left on its own deadline, none at EOS
        assert tst["flush_deadline"] == 4 and tst["flush_eos"] == 0
        assert tst["timer_fires"] >= 4
        assert tst["occupancy_hist"] == {1: 4}


def test_deadline_wait_is_not_a_stall():
    """A batcher waiting for its deadline is idle, not stuck: a watchdog
    with a budget far below the deadline warns about nothing."""
    pipe = tnns.Pipeline()
    src, sink = tel.AppSrc("src", spec=SPEC), tel.TensorSink("sink")
    _chain(pipe, [src, tel.TensorBatch("b", max_batch=8, max_latency_ms=300),
                  tel.TensorUnbatch("u"), sink])
    runner = tnns.PipelineRunner(pipe, watchdog=True,
                                 stall_budget_s=0.02).start()
    src.push(_frame(TensorBuffer, 1, pts=0))
    deadline = time.monotonic() + 30
    while not sink.results and time.monotonic() < deadline:
        time.sleep(0.005)
    src.end()
    runner.wait(30)
    runner.stop()
    st = runner.stats()
    assert st["b"]["flush_deadline"] == 1 and len(sink.results) == 1
    assert all(row["watchdog_warnings"] == 0 for row in st.values())


def _multi_stream(kind):
    pkg, el, buf_cls, spec = PKGS[kind]
    pipe = pkg.Pipeline()
    s0, s1 = el.AppSrc("s0", spec=spec), el.AppSrc("s1", spec=spec)
    b = el.TensorBatch("b", max_batch=4, max_latency_ms=1000)
    f = el.TensorFilter("f", framework="xla", model=_affine)
    u = el.TensorUnbatch("u")
    k0, k1 = el.TensorSink("k0"), el.TensorSink("k1")
    for e in (s0, s1, b, f, u, k0, k1):
        pipe.add(e)
    pipe.link(s0, b, dst_pad=0)
    pipe.link(s1, b, dst_pad=1)
    pipe.link(b, f)
    pipe.link(f, u)
    pipe.link(u, k0, src_pad=0)
    pipe.link(u, k1, src_pad=1)
    runner = pkg.PipelineRunner(pipe).start()
    for i in range(4):
        s0.push(_frame(buf_cls, 10 + i, pts=100 + i))
        s1.push(_frame(buf_cls, 20 + i, pts=200 + i))
    s0.end()
    s1.end()
    runner.wait(60)
    runner.stop()
    return _outputs(k0.results), _outputs(k1.results)


def test_multi_stream_routes_back_in_order():
    k0, k1 = _multi_stream("torch")
    assert (k0, k1) == _multi_stream("jax")
    assert [o[0] for o in k0] == [100, 101, 102, 103]
    assert [o[0] for o in k1] == [200, 201, 202, 203]
    for i, (_, vals, meta) in enumerate(k0):
        assert vals == [[(10 + i) * 2.0 + 1.0] * 4]
        assert meta["stream_id"] == 0 and meta["batch_seq"] == i
    assert all(meta["stream_id"] == 1 for *_, meta in k1)


@pytest.mark.parametrize("kind", ["jax", "torch"])
def test_non_batch_aware_sink_refused_at_negotiation(kind):
    pkg, el, _, spec = PKGS[kind]
    pipe = pkg.Pipeline()
    _chain(pipe, [el.AppSrc("src", spec=spec),
                  el.TensorBatch("b", max_batch=4), el.TensorSink("sink")])
    with pytest.raises((NegotiationError, JNegotiationError),
                       match="insert tensor_unbatch"):
        pipe.negotiate()


def test_non_batch_aware_transform_refused_like_jax():
    """An element that reads its spec refuses through expect_tensors,
    with the same text as the JAX package's."""
    msgs = []
    for kind in ("jax", "torch"):
        pkg, el, _, spec = PKGS[kind]
        pipe = pkg.Pipeline()
        _chain(pipe, [el.AppSrc("src", spec=spec),
                      el.TensorBatch("b", max_batch=4),
                      el.TensorTransform("t", mode="typecast",
                                         option="float16"),
                      el.TensorSink("sink")])
        with pytest.raises((NegotiationError, JNegotiationError)) as e:
            pipe.negotiate()
        msgs.append(str(e.value).split(": ", 1)[1])
    assert msgs[0] == msgs[1] and "insert tensor_unbatch" in msgs[1]


@pytest.mark.parametrize("kind", ["jax", "torch"])
def test_unbatch_requires_batched_stream(kind):
    pkg, el, _, spec = PKGS[kind]
    pipe = pkg.Pipeline()
    _chain(pipe, [el.AppSrc("src", spec=spec), el.TensorUnbatch("u"),
                  el.TensorSink("sink")])
    with pytest.raises((NegotiationError, JNegotiationError),
                       match="not micro-batched"):
        pipe.negotiate()


def test_per_frame_spec_preserved_downstream():
    pipe = tnns.Pipeline()
    b, u = tel.TensorBatch("b", max_batch=8), tel.TensorUnbatch("u")
    sink = tel.TensorSink("sink")
    _chain(pipe, [tel.AppSrc("src", spec=SPEC), b, u, sink])
    pipe.negotiate()
    assert b.out_specs[0].dyn_batch == 8
    assert b.out_specs[0].tensors == SPEC.tensors
    assert str(b.out_specs[0]).endswith("dyn_batch<=8)")
    assert u.out_specs[0].dyn_batch == 0
    assert u.out_specs[0].tensors == SPEC.tensors
    assert sink.in_specs[0].is_compatible(SPEC)
    assert not b.out_specs[0].is_compatible(SPEC)


# -- backend level ---------------------------------------------------------

def _backends(model_t, model_j, spec_t, spec_j):
    tb, jb = TorchBackend(), XLABackend()
    tb.open({"model": model_t})
    tb.set_input_info(spec_t)
    jb.open({"model": model_j})
    jb.set_input_info(spec_j)
    return tb, jb


def test_bucketed_invokes_under_ragged_occupancies():
    """Occupancies 1..8 run at most the 4 buckets {1, 2, 4, 8}: the port's
    bucket_shapes equals JAX's compile_count, and every output equals
    JAX's."""
    tb, jb = _backends(_affine, _affine, SPEC, JSPEC)
    occupancies = (3, 5, 2, 7, 1, 6, 4, 8, 3, 5)
    for n in occupancies:
        x = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
        got = tb.invoke_batched((x,), n, [True])[0]
        ref = np.asarray(jb.invoke_batched((x,), n, [True])[0])
        assert tuple(got.shape) == ref.shape == (n, 4)
        np.testing.assert_array_equal(got.numpy(), ref)
    assert len(tb.bucket_shapes) == jb.compile_count <= 4
    assert {k[1] for k in tb.bucket_shapes} == {1, 2, 4, 8}
    assert tb.batch_size_hist == {n: occupancies.count(n)
                                  for n in set(occupancies)}
    tb.close()
    jb.close()


def test_stack_mode_for_rank_without_leading_one():
    spec_t = TensorsSpec.of(TensorInfo((4,), DType.FLOAT32))
    spec_j = JSpec.of(JInfo((4,), JDType.FLOAT32))
    tb, jb = _backends(_affine, _affine, spec_t, spec_j)
    frames = np.stack([np.full(4, i, np.float32) for i in range(3)])
    got = tb.invoke_batched((frames,), 3, [False])[0]
    ref = np.asarray(jb.invoke_batched((frames,), 3, [False])[0])
    assert tuple(got.shape) == ref.shape == (3, 4)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert tb.bucket_shapes == {("dynb", 4, (4, 4))}


def test_batch_rejecting_model_runs_per_frame():
    """A model with a baked-in per-frame shape refuses the batched shape
    on the meta device and runs frame by frame (the base path), with
    JAX's outputs."""
    def rigid_t(x):
        return torch.reshape(x, (4,)) * 3.0

    def rigid_j(x):
        import jax.numpy as jnp

        return jnp.reshape(x, (4,)) * 3.0

    tb, jb = _backends(rigid_t, rigid_j, SPEC, JSPEC)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = tb.invoke_batched((x,), 3, [True])[0]
    ref = np.asarray(jb.invoke_batched((x,), 3, [True])[0])
    assert tuple(got.shape) == ref.shape == (3, 4)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert tb.bucket_shapes == set() and tb.batch_size_hist == {}


def test_batch_verdict_on_meta_for_mobilenet(bundles):  # noqa: F811
    """MobileNetV2 takes a batched input on the meta device, so B runs
    one call per micro-batch, never silently per frame; the real params
    stay where they were."""
    tb = TorchBackend()
    tb.open({"model": bundles[1]})
    sig = (((8, 64, 64, 3), torch.float32),)
    assert tb._batchable(sig) is True
    assert all(p.device.type == "cpu" for p in tb._params.parameters())
    assert all(p.device.type == "meta" for p in tb._meta.parameters())
    assert tb._batchable((((8, 64, 64), torch.float32),)) is False


def test_pipeline_batched_filter_buckets_bounded():
    pipe = tnns.Pipeline()
    src, sink = tel.AppSrc("src", spec=SPEC), tel.TensorSink("sink")
    f = tel.TensorFilter("f", framework="xla", model=_affine)
    _chain(pipe, [src, tel.TensorBatch("b", max_batch=4,
                                       max_latency_ms=1000),
                  f, tel.TensorUnbatch("u"), sink])
    runner = tnns.PipelineRunner(pipe).start()
    for i in range(7):                 # 4 full + 3 at EOS (padded to 4)
        src.push(_frame(TensorBuffer, i, pts=i))
    src.end()
    runner.wait(60)
    runner.stop()
    assert len(sink.results) == 7
    assert f.backend.bucket_shapes == {("dynb", 4, (4, 4))}
    st = runner.stats()["f"]
    assert st["backend_batch_size_hist"] == {3: 1, 4: 1}
    assert st["backend_bucket_shapes"] == 1
    assert st["invoke_throughput"] > 0    # counts frames, not batches
    rep = runner.report()
    assert "micro-batching (occupancy {frames: batches}, flush reasons):" \
        in rep
    assert "  b: 7 frames in 2 batches, occupancy {3: 1, 4: 1} avg 3.50; " \
        "flushes full=1 deadline=0 eos=1" in rep


def test_base_invoke_batched_launches_per_frame():
    """The pallas backend keeps the base invoke_batched: one normalize
    per frame, each on a contiguous t[i:i+1] view."""
    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.backends.base import get_backend

    seen = []
    be = get_backend("pallas")
    be.open({"model": lambda ts: (seen.append(ts[0].is_contiguous()),
                                  kernels.normalize_u8(ts[0]))[1:]})
    x = np.random.default_rng(0).integers(0, 256, (3, 2, 2, 3), np.uint8)
    (out,) = be.invoke_batched((x,), 3, [True])
    assert seen == [True] * 3
    np.testing.assert_array_equal(
        out.numpy(), kernels.normalize_u8_plain(torch.from_numpy(x)).numpy())


# -- pipeline B micro-batched ----------------------------------------------

WIDTH, SIZE, FRAMES = 0.35, 64, 7
SRC = (f"videotestsrc num-buffers={FRAMES} width={SIZE} height={SIZE} "
       f"pattern=random seed=7 ! tensor_converter")
BATCH = "tensor_batch max-batch=4 max-latency-ms=60000"
NORM = "tensor_filter framework=pallas model=normalize_u8"
MODEL = "tensor_filter name=f model=zoo://mobilenet_v2"
LABEL = "tensor_decoder mode=image_labeling"


def _run_b(pkg, bundle, batched: bool, label: bool):
    mid = (f"{BATCH} ! {NORM} ! {MODEL} ! tensor_unbatch" if batched
           else f"{NORM} ! {MODEL}")
    tail = f" ! {LABEL}" if label else ""
    pipe = pkg.parse_launch(f"{SRC} ! {mid}{tail} ! tensor_sink name=out")
    pipe.get("f").set_props(model=bundle)
    pkg.PipelineRunner(pipe).run(120)
    return pipe.get("out").results, pipe.get("f")


def test_pipeline_b_batched_matches_jax(bundles):  # noqa: F811
    """B with tensor_batch before the normalize filter and tensor_unbatch
    after the model, the same string in both packages: equal labels and
    logits within the f32 rule (1e-4 of max |logit|)."""
    ref, _ = _run_b(jnns, bundles[0], True, False)
    got, f = _run_b(tnns, bundles[1], True, False)
    pts = [b.pts for b in got]
    assert pts == [b.pts for b in ref] and pts == sorted(pts)
    assert len(got) == FRAMES
    for r, g in zip(ref, got):
        r, g = np.asarray(r.tensors[0]), g.tensors[0]
        assert g.shape == r.shape == (1, 1001)
        np.testing.assert_allclose(g, r, atol=1e-4 * float(np.abs(r).max()),
                                   rtol=0)
    assert f.backend.batch_size_hist == {4: 1, 3: 1}
    refl, _ = _run_b(jnns, bundles[0], True, True)
    gotl, _ = _run_b(tnns, bundles[1], True, True)
    assert [b.meta["label_index"] for b in gotl] == \
        [b.meta["label_index"] for b in refl]


def test_pipeline_b_batched_matches_unbatched(bundles):  # noqa: F811
    batched, _ = _run_b(tnns, bundles[1], True, False)
    plain, _ = _run_b(tnns, bundles[1], False, False)
    assert [b.pts for b in batched] == [b.pts for b in plain]
    for a, b in zip(batched, plain):
        a, b = a.tensors[0], b.tensors[0]
        np.testing.assert_allclose(a, b, atol=1e-5 * float(np.abs(b).max()),
                                   rtol=0)

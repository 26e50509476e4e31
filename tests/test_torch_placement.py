"""Device placement on the port (nnstreamer_tpu_torch/serving/placement.py,
the filter's ``devices=``) against the JAX package's serving/placement.py.

The port runs its replicas on logical CPU devices (``[parallel]
virtual_devices=8`` through monkeypatch, the CPU asked for); the JAX side
on the 8-device virtual CPU mesh (tests/conftest.py). The gates, the JAX
file's (tests/test_placement.py) on the same seeded numpy MLP:

- replicas at devices 1/2/4 give outputs `np.array_equal` to each other
  and within 1e-6 of JAX's (f32 products, the two frameworks sum in
  other orders); routing spreads an idle set evenly, as JAX's does;
- Σ replica invokes == frames served through a fence, a fully fenced set
  refuses with a typed error, a swap needs a store model;
- a store swap: every replica adopts one epoch and runs nothing for the
  first time after the flip (the prewarm ran it);
- the filter's ``devices=`` prop: parity with the one-device pipeline,
  conservation through a fence mid-stream, the soft declines;
- the planners: `segment_plan` and `segment_plan_tp` equal to JAX's on
  the JAX tests' cost lists, `apply_plan` pins stages to logical
  ordinals, `fuse_segments` respects the plan's cuts, a planned pipeline
  gives the unplanned one's bits with the handoff counted as a staging
  copy.

No wall-clock assertion is copied.
"""

import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.xla import ModelBundle as JaxModelBundle
from nnstreamer_tpu.serving import placement as jpl
from nnstreamer_tpu.serving import sharding as jsh
from nnstreamer_tpu.serving.store import reset_store as j_reset_store
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JTensorBuffer
from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
from nnstreamer_tpu_torch.core.errors import BackendError, StreamError
from nnstreamer_tpu_torch.graph.optimize import fuse_segments
from nnstreamer_tpu_torch.serving import placement as tpl
from nnstreamer_tpu_torch.serving.metrics import (
    metrics_snapshot, parse_prometheus, render_prometheus)
from nnstreamer_tpu_torch.serving.store import reset_store
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

DIM = 16


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


def _w(seed=3):
    return np.random.default_rng(seed).normal(size=(DIM, DIM)).astype(
        np.float32)


def _bundles(seed=3):
    """(JAX bundle, port bundle) of one MLP on the same numpy weights."""
    w = _w(seed)
    jb = JaxModelBundle(fn=lambda p, x: (x @ p["w"],), params={"w": w},
                        name="plc_mlp")
    tb = ModelBundle(fn=lambda p, x: (x @ p["w"],),
                     params={"w": torch.from_numpy(w.copy())},
                     name="plc_mlp")
    return jb, tb


def _x(rows=4):
    return np.linspace(-1, 1, rows * DIM, dtype=np.float32).reshape(rows, DIM)


def _open(n, bundle):
    return tpl.ReplicaSet.open("torch", {"model": bundle}, n, name=f"rs{n}")


# -- devices ---------------------------------------------------------------------

def test_accelerator_for_names_the_logical_ordinal():
    assert tpl.accelerator_for(3) == "cpu:3"
    assert tpl.device_of(3) == torch.device("cpu")
    with pytest.raises(BackendError, match="out of range"):
        tpl.device_of(10_000)


def test_backend_pinned_to_an_ordinal():
    _, tb = _bundles()
    from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend

    be = TorchBackend()
    be.open({"model": tb, "accelerator": tpl.accelerator_for(5)})
    try:
        assert be.device_ordinal == 5 and be.device == torch.device("cpu")
        (out,) = be.invoke((_x(),))
        assert getattr(out, "_nns_ordinal") == 5
    finally:
        be.close()


# -- replicas --------------------------------------------------------------------

def test_replica_parity_across_counts_and_with_jax(eight_cpu_devices):
    jb, tb = _bundles()
    x = _x()
    jrs = jpl.ReplicaSet.open("xla", {"model": jb, "custom": ""}, 2,
                              name="j2")
    try:
        jref = np.asarray(jrs.invoke((x,))[0])
    finally:
        jrs.close()
    ref = None
    for n in (1, 2, 4):
        rs = _open(n, tb)
        try:
            outs = [rs.invoke((x,)) for _ in range(2 * n)]
        finally:
            rs.close()
        if ref is None:
            ref = np.asarray(outs[0][0])
        for o in outs:
            np.testing.assert_array_equal(np.asarray(o[0]), ref)
    np.testing.assert_allclose(ref, jref, rtol=0, atol=1e-6)


def test_round_robin_spreads_idle_load_as_jax(eight_cpu_devices):
    jb, tb = _bundles()
    x = np.ones((1, DIM), np.float32)
    counts = []
    for rs in (jpl.ReplicaSet.open("xla", {"model": jb, "custom": ""}, 4,
                                   name="j4"), _open(4, tb)):
        try:
            for _ in range(12):
                rs.invoke((x,))
            st = rs.stats()
        finally:
            rs.close()
        counts.append(([r["invokes"] for r in st["replicas"]],
                       st["routed"], st["live"]))
    assert counts[0] == counts[1] == ([3, 3, 3, 3], 12, 4)


def test_fence_conserves_invokes_exactly():
    _, tb = _bundles()
    x = np.ones((1, DIM), np.float32)
    rs = _open(4, tb)
    try:
        for _ in range(4):
            rs.invoke((x,))
        assert rs.fence(0, "test chaos")
        assert not rs.fence(0, "twice")          # idempotent
        for _ in range(6):
            rs.invoke((x,))
        st = rs.stats()
    finally:
        rs.close()
    assert sum(r["invokes"] for r in st["replicas"]) == 10
    assert st["live"] == 3 and rs.live_replicas() == 3
    dead = next(r for r in st["replicas"] if r["device"] == 0)
    assert dead["state"] == "fenced" and not dead["up"]
    assert dead["invokes"] == 1


def test_fence_reoffers_queued_work():
    """Work queued on a replica when it is fenced re-routes to a
    survivor: every frame is answered once, Σ invokes == frames."""
    slow = ModelBundle(fn=lambda p, x: (time.sleep(0.02) or x * 2.0,),
                       name="slow")
    rs = tpl.ReplicaSet.open("torch", {"model": slow}, 2, name="re",
                             queue_cap=64)
    try:
        futs = [rs.submit((np.full((1, 4), i, np.float32),))
                for i in range(12)]
        rs.fence(1, "mid-queue")
        outs = [f.result(30) for f in futs]
        st = rs.stats()
    finally:
        rs.close()
    for i, (o,) in enumerate(outs):
        np.testing.assert_array_equal(o, np.full((1, 4), 2.0 * i))
    assert sum(r["invokes"] for r in st["replicas"]) == 12
    assert st["fences"] == 1


def test_all_fenced_rejects_typed():
    _, tb = _bundles()
    rs = _open(2, tb)
    try:
        rs.fence(0)
        rs.fence(1)
        fut = rs.submit((np.ones((1, DIM), np.float32),))
        with pytest.raises(StreamError, match="no live replica"):
            fut.result(5.0)
        assert rs.stats()["rejected"] == 1
    finally:
        rs.close()


def test_too_many_devices_names_virtual_devices():
    _, tb = _bundles()
    with pytest.raises(BackendError, match="virtual_devices"):
        _open(len(tpl.visible_devices()) + 1, tb)


def test_swap_requires_store_backing():
    _, tb = _bundles()
    rs = _open(2, tb)
    try:
        with pytest.raises(BackendError, match="store"):
            rs.swap()
    finally:
        rs.close()


def test_swap_one_epoch_no_first_run_after_the_flip():
    from nnstreamer_tpu_torch.serving.store import get_store

    store = get_store()
    store.register("plc_m", lambda x: (x * 2.0,))
    store.register("plc_m", lambda x: (x + 100.0,))     # v2
    x = np.full((4,), 3.0, np.float32)
    rs = tpl.ReplicaSet.open("torch", {"model": "store://plc_m"}, 4,
                             name="swap4")
    try:
        for _ in range(8):                               # warm every replica
            (out,) = rs.invoke((x,))
        np.testing.assert_array_equal(out, x * 2.0)
        assert len(set(rs.adopted_epochs())) == 1
        rep = rs.swap(2)
        assert rep["to_version"] == 2 and rep["handles"] == 4
        assert rep["prewarmed_buckets"] == 4
        counts_at_flip = rs.compile_counts()
        for _ in range(8):
            (out,) = rs.invoke((x,))
            np.testing.assert_array_equal(out, x + 100.0)
        assert len(set(rs.adopted_epochs())) == 1
        assert rs.compile_counts() == counts_at_flip
    finally:
        rs.close()


# -- the filter's devices= -------------------------------------------------------

PIPE = ("appsrc name=src dims=4 types=float32 ! tensor_filter name=f "
        "model=store://plc_p {extra} ! tensor_sink name=out")


def _run(pkg, Buffer, store, extra, frames=12, fence_at=None):
    store.register("plc_p", lambda x: (x * 2.0 + 1.0,))
    pipe = pkg.parse_launch(PIPE.format(extra=extra))
    runner = pkg.PipelineRunner(pipe)
    runner.start()
    src, sink, f = pipe.get("src"), pipe.get("out"), pipe.get("f")
    try:
        for i in range(frames):
            if i == fence_at:
                while len(sink.results) < fence_at:
                    time.sleep(0.005)
                assert f.replicas.fence(0, "test chaos")
            src.push(Buffer.of(np.full((4,), float(i), np.float32), pts=i))
        src.end()
        runner.wait(30)
    finally:
        runner.stop()
    return {int(b.pts): np.asarray(b.tensors[0]) for b in sink.results}, f


def test_filter_devices_parity_and_conservation_as_jax(eight_cpu_devices):
    base, _ = _run(tnns, TensorBuffer, reset_store(), "devices=0")
    got, f = _run(tnns, TensorBuffer, reset_store(), "devices=4")
    jgot, jf = _run(jnns, JTensorBuffer, j_reset_store(), "devices=4")
    assert got.keys() == base.keys() == jgot.keys()
    for pts, ref in base.items():
        np.testing.assert_array_equal(got[pts], ref)
        np.testing.assert_array_equal(got[pts], jgot[pts])
    st, jst = f.extra_stats(), jf.extra_stats()
    for k in ("replica_devices", "replica_live", "replica_invokes",
              "replica_reoffers", "replica_fences"):
        assert st[k] == jst[k], k
    assert st["replica_invokes"] == 12
    assert sum(r["invokes"] for r in st["replicas"]) == 12


def test_filter_fence_mid_stream_conserves():
    got, f = _run(tnns, TensorBuffer, reset_store(), "devices=2",
                  fence_at=6)
    assert len(got) == 12
    st = f.extra_stats()
    assert st["replica_invokes"] == 12
    assert st["replica_live"] == 1 and st["replica_fences"] == 1


@pytest.mark.parametrize("extra,why", [
    ("devices=2 accelerator=cpu:0", "accelerator"),
    ("devices=2 shared-tensor-filter-key=k", "shared"),
])
def test_soft_declines(extra, why):
    store = reset_store()
    if "shared" in extra:
        # a shared key cannot hold a store model: a plain callable
        store.register("plc_p", lambda x: (x,))
        pipe = tnns.parse_launch(
            f"appsrc name=src dims=4 types=float32 ! tensor_filter name=f "
            f"{extra} ! tensor_sink name=out")
        pipe.get("f").set_props(model=lambda x: (x * 2.0 + 1.0,))
        runner = tnns.PipelineRunner(pipe).start()
        pipe.get("src").push(TensorBuffer.of(np.ones((4,), np.float32)))
        pipe.get("src").end()
        runner.wait(30)
        runner.stop()
        f = pipe.get("f")
        got = pipe.get("out").results
    else:
        got, f = _run(tnns, TensorBuffer, store, extra)
    assert len(got) >= 1
    assert f.replicas is None
    assert why in f.extra_stats()["replica_decline"]


def test_canary_split_declines_softly_as_jax(eight_cpu_devices):
    decl = []
    for pkg, Buffer, reset in ((tnns, TensorBuffer, reset_store),
                               (jnns, JTensorBuffer, j_reset_store)):
        store = reset()
        store.register("plc_c", lambda x: (x * 2.0,))
        store.register("plc_c", lambda x: (x * 3.0,))
        pipe = pkg.parse_launch(
            "appsrc name=src dims=4 types=float32 ! tensor_filter name=f "
            "model=store://plc_c@2:0.5 devices=2 ! tensor_sink name=out")
        runner = pkg.PipelineRunner(pipe).start()
        for i in range(4):
            pipe.get("src").push(Buffer.of(np.ones((4,), np.float32), pts=i))
        pipe.get("src").end()
        runner.wait(30)
        runner.stop()
        f = pipe.get("f")
        assert f.replicas is None and len(pipe.get("out").results) == 4
        decl.append(f.extra_stats()["replica_decline"])
    assert decl[0] == decl[1]


# -- the planners ------------------------------------------------------------------

PLAN_CASES = [
    ([("a", 1.0), ("b", 3.0), ("c", 1.0), ("d", 1.0)], 2),
    ([("a", 10.0), ("b", 0.1), ("c", 0.1)], 3),
    ([(f"e{i}", 1.0) for i in range(6)], 2),
    ([("a", 0.0), ("b", 0.0)], 4),
    ([("a", 2.0), ("b", 2.0)], 2),
]

TP_CASES = [
    ([("pre", 0.1), ("big", 8.0), ("post", 0.1)], 8, 0.7),
    ([(f"e{i}", 1.0) for i in range(4)], 4, 0.7),
    ([("big", 8.0), ("small", 0.1)], 8, 0.5),
    ([("pre", 0.2), ("h1", 4.0), ("h2", 4.0)], 8, 0.7),
    ([("f", 8.0)], 8, 0.7),
]


def _plan_fields(p):
    return (p.stages, p.devices, p.stage_times_s, p.bubble_fraction,
            p.total_s, p.source, p.tp, p.report())


@pytest.mark.parametrize("costs,ndev", PLAN_CASES)
def test_segment_plan_equals_jax(costs, ndev):
    assert _plan_fields(tpl.segment_plan(costs, ndev)) == \
        _plan_fields(jpl.segment_plan(costs, ndev))


@pytest.mark.parametrize("costs,ndev,eff", TP_CASES)
def test_segment_plan_tp_equals_jax(costs, ndev, eff):
    assert tsh_supported() == jsh.SUPPORTED_SHARDS
    assert _plan_fields(tpl.segment_plan_tp(costs, ndev, tp_efficiency=eff)) \
        == _plan_fields(jpl.segment_plan_tp(costs, ndev, tp_efficiency=eff))


def tsh_supported():
    from nnstreamer_tpu_torch.serving.sharding import SUPPORTED_SHARDS

    return SUPPORTED_SHARDS


def test_planner_refusals_as_jax():
    for mod in (tpl, jpl):
        with pytest.raises(Exception, match="empty"):
            mod.segment_plan([], 2)
        with pytest.raises(Exception, match="tp_efficiency"):
            mod.segment_plan_tp([("a", 1.0)], 2, tp_efficiency=1.5)


def test_plan_from_tracer_reads_hists():
    class _T:
        active = True

        def hists(self):
            return {"a": {"sum": 8.0, "count": 1},
                    "b": {"sum": 0.1, "count": 1}}

    for mod in (tpl, jpl):
        plan = mod.plan_from_tracer(_T(), ["a", "b"], 8, tp_efficiency=0.7)
        assert plan.source == "tracer" and max(plan.tp) > 1
        assert mod.plan_from_tracer(_T(), ["a", "b"], 8).tp == []


def _three_filter_pipe(store):
    store.register("plc_s1", lambda x: (x * 2.0,))
    store.register("plc_s2", lambda x: (x + 1.0,))
    store.register("plc_s3", lambda x: (-x,))
    return tnns.parse_launch(
        "appsrc name=src dims=4 types=float32 ! "
        "tensor_filter name=s1 model=store://plc_s1 ! "
        "tensor_filter name=s2 model=store://plc_s2 ! "
        "tensor_filter name=s3 model=store://plc_s3 ! "
        "tensor_sink name=out")


def _push_and_collect(pipe, frames=10, **runner_kw):
    runner = tnns.PipelineRunner(pipe, **runner_kw)
    runner.start()
    src, sink = pipe.get("src"), pipe.get("out")
    try:
        for i in range(frames):
            src.push(TensorBuffer.of(np.full((4,), float(i), np.float32),
                                     pts=i))
        src.end()
        runner.wait(30)
    finally:
        runner.stop()
    return {int(b.pts): np.asarray(b.tensors[0])
            for b in sink.results}, runner


def test_profiled_plan_parity_and_counted_handoffs():
    base, runner = _push_and_collect(_three_filter_pipe(reset_store()),
                                     trace=True, device_segments=False)
    plan = tpl.plan_from_tracer(runner.tracer, ["s1", "s2", "s3"], 4)
    assert plan.source == "tracer"
    assert sum(len(g) for g in plan.stages) == 3
    pipe = _three_filter_pipe(reset_store())
    assert tpl.apply_plan(pipe, plan) == 3
    assert pipe.segment_plan is plan
    accels = [pipe.get(g[0]).props["accelerator"] for g in plan.stages]
    assert accels == [f"cpu:{d}" for d in plan.devices]
    seg, r = _push_and_collect(pipe)
    assert seg.keys() == base.keys()
    for pts, ref in base.items():
        np.testing.assert_array_equal(seg[pts], ref)
    st, base_st = r.stats(), runner.stats()
    heads = [g[0] for g in plan.stages]
    for i, name in enumerate(heads):
        assert pipe.get(name).backend.device_ordinal == plan.devices[i]
        # the first stage copies each host frame in; every later stage
        # copies each frame across its cut, where the unplanned run
        # passed the tensor on as it was
        assert st[name]["backend_staging_transfers"] == 10, name
        if i:
            assert base_st[name]["backend_staging_transfers"] == 0, name


def test_fuse_segments_respects_plan_cut():
    pipe = _three_filter_pipe(reset_store())
    plan = tpl.segment_plan([("s1", 1.0), ("s2", 1.0), ("s3", 1.0)], 3)
    tpl.apply_plan(pipe, plan)
    assert fuse_segments(pipe) == 0
    assert set(pipe.elements) >= {"s1", "s2", "s3"}


def test_fuse_segments_fuses_within_stage():
    pipe = _three_filter_pipe(reset_store())
    plan = tpl.segment_plan([("s1", 1.0), ("s2", 1.0), ("s3", 4.0)], 2)
    assert plan.stages == [["s1", "s2"], ["s3"]]
    tpl.apply_plan(pipe, plan)
    assert fuse_segments(pipe) == 1
    assert "s3" in pipe.elements and "s2" not in pipe.elements


def test_measured_report_reads_live_profile():
    _, runner = _push_and_collect(_three_filter_pipe(reset_store()),
                                  trace=True, device_segments=False)
    plan = tpl.plan_from_tracer(runner.tracer, ["s1", "s2", "s3"], 3)
    rep = plan.measured_report(runner.tracer)
    assert all(r["measured_s"] > 0 for r in rep["stages"])
    assert 0.0 <= rep["measured_bubble_fraction"] < 1.0


def test_replica_and_segment_series_round_trip():
    _, tb = _bundles()
    rs = _open(4, tb)
    try:
        for _ in range(10):
            rs.invoke((np.ones((1, DIM), np.float32),))
        rs.fence(3, "scrape me")
        st = rs.stats()
    finally:
        rs.close()
    plan = tpl.segment_plan([("s1", 2.0), ("s2", 1.0)], 2)
    snap = dict(replicas={"f": st}, segments={"p0": plan.report()})
    parsed = parse_prometheus(render_prometheus(metrics_snapshot(**snap)))
    inv = parsed["nns_replica_invokes_total"]["samples"]
    assert sum(inv.values()) == 10.0
    up = parsed["nns_replica_up"]["samples"]
    down = [k for k, v in up.items() if v == 0.0]
    assert len(down) == 1 and 'device="3"' in down[0]
    # the same snapshot renders the same text through JAX's exposition
    from nnstreamer_tpu.serving.metrics import (
        metrics_snapshot as j_snapshot, render_prometheus as j_render)

    assert render_prometheus(metrics_snapshot(**snap)) == \
        j_render(j_snapshot(**snap))

"""The port scheduler's host path — chain fusion, the watchdog's
bookkeeping, upstream events, the always-on stats — held to the JAX
package's on the same pipelines, on the CPU.

Ported from tests/test_hostpath.py (TestChainFusion, TestWatchdogPrune)
and tests/test_runtime.py (test_stats_report_queue_wait). Where both
packages run a pipeline, the
test builds it in both and compares `fused_chains()`, outputs (bit for
bit: host elements) and stats counters. The deadline rule runs on a
timer element defined here; the fan-out rule on tensor_demux and on a
real tee (tests/test_hostpath.py's case); chains through queue,
tensor_rate and tensor_aggregator give JAX's `fused_chains()`. Not
copied:
`test_fused_chain_cheaper_per_frame_than_unfused`, a wall-clock
comparison (chain fusion's per-frame cost is measured on the card,
chip_smoke.py phase 26), and the channel/staging/profiler tests of
modules the port does not have (tools/profile_hostpath.py, the XLA
backend's staging). TestWedgedAdmission drives the watchdog's
wedged-admission scan with a synthetic clock over a stand-in element
with `admission_counters()` (tests/test_hostpath.py's case), and over a
real tensor_query_serversrc whose service is gone, against JAX's scan on
the same script.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
from nnstreamer_tpu.elements import TensorTransform as JTransform
from nnstreamer_tpu.elements.routing import TensorDemux as JDemux
from nnstreamer_tpu.elements.sinks import TensorSink as JSink
from nnstreamer_tpu.elements.sources import AppSrc as JAppSrc
from nnstreamer_tpu.graph.pipeline import Element as JElement
from nnstreamer_tpu.runtime.scheduler import ElementStats as JStats
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu.tensor.dtypes import DType as JDType
from nnstreamer_tpu.tensor.info import TensorInfo as JInfo
from nnstreamer_tpu.tensor.info import TensorsSpec as JSpec

import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu_torch.backends import pallas_backend
from nnstreamer_tpu_torch.core.errors import StreamError, WatchdogStall
from nnstreamer_tpu_torch.elements import (
    AppSrc, TensorDemux, TensorSink, TensorTransform)
from nnstreamer_tpu_torch.graph.pipeline import Element
from nnstreamer_tpu_torch.runtime.channel import Channel
from nnstreamer_tpu_torch.runtime.scheduler import ElementStats, PipelineRunner
from nnstreamer_tpu_torch.runtime.tracing import Tracer
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

#: the two packages' classes, so one builder makes either pipeline
PKGS = {
    "jax": SimpleNamespace(nns=jnns, Transform=JTransform, Sink=JSink,
                           AppSrc=JAppSrc, Demux=JDemux, Element=JElement,
                           Buf=JBuf, DType=JDType, Info=JInfo, Spec=JSpec),
    "torch": SimpleNamespace(nns=tnns, Transform=TensorTransform,
                             Sink=TensorSink, AppSrc=AppSrc,
                             Demux=TensorDemux, Element=Element,
                             Buf=TensorBuffer, DType=DType, Info=TensorInfo,
                             Spec=TensorsSpec),
}


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _passthrough(n, policy=None):
    extra = f" error-policy={policy}" if policy else ""
    chain = " ! ".join(
        f"tensor_transform name=t{i} mode=arithmetic option=add:1.0{extra}"
        for i in range(n))
    return (f"appsrc name=in dims=4:1 types=float32 ! {chain} ! "
            f"tensor_sink name=out")


def _run_frames(pkg, p, n_frames, **runner_kw):
    ns = PKGS[pkg]
    runner = ns.nns.PipelineRunner(p, optimize=False, **runner_kw).start()
    try:
        for i in range(n_frames):
            p.get("in").push(ns.Buf.of(
                np.full((1, 4), float(i), np.float32), pts=i))
        p.get("in").end()
        runner.wait(30)
    finally:
        runner.stop()
    return runner


def _both(desc, n_frames, **runner_kw):
    """`desc` run in both packages on the same frames → {pkg: (pipe,
    runner)}."""
    out = {}
    for pkg, ns in PKGS.items():
        p = ns.nns.parse_launch(desc)
        out[pkg] = (p, _run_frames(pkg, p, n_frames, **runner_kw))
    return out


def _frames(results):
    return [(b.pts, np.asarray(b.tensors[0]).tobytes()) for b in results]


# -- chain fusion ------------------------------------------------------------

class TestChainFusion:
    def test_linear_chain_is_fused_like_jax(self):
        desc = ("appsrc name=in dims=4:1 types=float32 ! "
                "tensor_transform name=t0 mode=arithmetic option=add:1.0 ! "
                "tensor_transform name=t1 mode=arithmetic option=mul:2.0 ! "
                "tensor_transform name=t2 mode=arithmetic option=add:-3.0 ! "
                "tensor_sink name=out")
        runs = _both(desc, 5)
        (jp, jr), (tp, tr) = runs["jax"], runs["torch"]
        assert tr.fused_chains() == jr.fused_chains() == [["t0", "t1", "t2"]]
        res = tp.get("out").results
        assert len(res) == 5
        for i, b in enumerate(res):
            np.testing.assert_array_equal(
                b.tensors[0], np.full((1, 4), (i + 1) * 2 - 3, np.float32))
        assert _frames(res) == _frames(jp.get("out").results)

    @pytest.mark.parametrize("n", [2, 4])
    def test_fused_matches_unfused_output_and_stats(self, n):
        outs, stats = {}, {}
        for fused in (True, False):
            p = tnns.parse_launch(_passthrough(n))
            runner = _run_frames("torch", p, 8, chain_fusion=fused)
            assert bool(runner.fused_chains()) == fused
            outs[fused] = _frames(p.get("out").results)
            st = runner.stats()
            stats[fused] = {k: {c: d[c] for c in ("buffers", "errors",
                                                  "skipped", "dropped")}
                            for k, d in st.items()}
            for i in range(n):        # per-member attribution kept
                assert st[f"t{i}"]["buffers"] == 8
                assert st[f"t{i}"]["proctime_total_s"] > 0.0
        assert len(outs[True]) == 8
        assert outs[True] == outs[False] and stats[True] == stats[False]
        jp = jnns.parse_launch(_passthrough(n))
        _run_frames("jax", jp, 8)
        assert outs[True] == _frames(jp.get("out").results)

    def test_interlatency_traced_per_member(self):
        p = tnns.parse_launch(_passthrough(3))
        runner = _run_frames("torch", p, 6, trace=True)
        assert runner.fused_chains() == [["t0", "t1", "t2"]]
        inter = runner.tracer.interlatency()
        for name in ("t0", "t1", "t2", "out"):
            assert inter[name]["n"] == 6
        # each frame reaches t2 after t0, so every percentile is ordered
        assert inter["t2"]["p50_ms"] >= inter["t0"]["p50_ms"]
        spans = {}
        for ph, _, name, label, *_ in runner.tracer.events():
            if ph == "X" and label == "process":
                spans[name] = spans.get(name, 0) + 1
        assert spans == {"t0": 6, "t1": 6, "t2": 6, "out": 6}
        assert "fused chains" in runner.report()
        assert "t0 → t1 → t2" in runner.report()

    @pytest.mark.parametrize("pkg", ["torch", "jax"])
    def test_flush_emissions_flow_through_chain_at_eos(self, pkg):
        """A mid-chain element that withholds its last buffer until
        flush() still delivers it through the rest of the chain before
        EOS reaches the sink — in both packages alike."""
        ns = PKGS[pkg]

        class HoldLast(ns.Element):
            ELEMENT_NAME = "hold_last"

            def __init__(self, name=None):
                super().__init__(name=name)
                self._held = None

            def negotiate(self, in_specs):
                return [self.expect_tensors(in_specs[0])]

            def process(self, pad, buf):
                held, self._held = self._held, buf
                return [(0, held)] if held is not None else []

            def flush(self):
                held, self._held = self._held, None
                return [(0, held)] if held is not None else []

        pipe = ns.nns.Pipeline("holdlast")
        src = ns.AppSrc(spec=ns.Spec.of(
            ns.Info((1, 4), ns.DType.FLOAT32)), name="in")
        t0 = ns.Transform(name="t0", mode="arithmetic", option="add:1.0")
        hold = HoldLast(name="hold")
        t1 = ns.Transform(name="t1", mode="arithmetic", option="mul:2.0")
        sink = ns.Sink(name="out")
        for e in (src, t0, hold, t1, sink):
            pipe.add(e)
        for a, b in zip((src, t0, hold, t1), (t0, hold, t1, sink)):
            pipe.link(a, b)
        runner = _run_frames(pkg, pipe, 3)
        assert runner.fused_chains() == [["t0", "hold", "t1"]]
        res = sink.results
        assert len(res) == 3 and sink.eos.is_set()
        for i, b in enumerate(res):
            np.testing.assert_array_equal(
                b.tensors[0], np.full((1, 4), (i + 1) * 2, np.float32))

    def test_non_fail_policy_not_fused(self):
        runs = _both(_passthrough(3, policy="skip"), 2)
        assert runs["torch"][1].fused_chains() == \
            runs["jax"][1].fused_chains() == []

    @pytest.mark.parametrize("pkg", ["torch", "jax"])
    def test_deadline_element_not_fused(self, pkg):
        """An element with timer wakeups (next_deadline/on_timer) keeps
        its own worker: fused, it could not be woken apart from its
        chain. The transforms around it stay single (a run of one)."""
        ns = PKGS[pkg]

        class Timed(ns.Element):
            ELEMENT_NAME = "timed"

            def negotiate(self, in_specs):
                return [self.expect_tensors(in_specs[0])]

            def process(self, pad, buf):
                return [(0, buf)]

            def next_deadline(self):
                return None

            def on_timer(self):
                return []

        pipe = ns.nns.Pipeline("deadline")
        src = ns.AppSrc(spec=ns.Spec.of(
            ns.Info((1, 4), ns.DType.FLOAT32)), name="in")
        chain = [ns.Transform(name="t0", mode="arithmetic",
                              option="add:1.0"),
                 Timed(name="tm"),
                 ns.Transform(name="t1", mode="arithmetic",
                              option="add:1.0"),
                 ns.Transform(name="t2", mode="arithmetic",
                              option="add:1.0")]
        sink = ns.Sink(name="out")
        els = [src, *chain, sink]
        for e in els:
            pipe.add(e)
        for a, b in zip(els, els[1:]):
            pipe.link(a, b)
        runner = _run_frames(pkg, pipe, 4)
        assert runner.fused_chains() == [["t1", "t2"]]
        assert len(sink.results) == 4

    def test_filter_not_fused(self):
        pallas_backend.register_pallas_filter(
            "hp_ident", out_like=lambda s: s)(lambda ts: ts)
        try:
            p = tnns.parse_launch(
                "appsrc name=in dims=4:1 types=float32 ! "
                "tensor_transform name=t0 mode=arithmetic option=add:1.0 ! "
                "tensor_filter framework=pallas model=hp_ident name=f ! "
                "tensor_transform name=t1 mode=arithmetic option=add:1.0 ! "
                "tensor_sink name=out")
            runner = _run_frames("torch", p, 3)
            names = {n for chain in runner.fused_chains() for n in chain}
            assert "f" not in names   # CHAIN_FUSABLE=False opt-out
            assert p.get("f").CHAIN_FUSABLE is False
            assert len(p.get("out").results) == 3
        finally:
            pallas_backend._kernels.pop("hp_ident", None)

    def test_filter_with_fused_transforms_stays_out_of_chains(self):
        """Transform fusion first absorbs the transforms into the filter;
        the filter then never joins a chain (its CHAIN_FUSABLE=False)."""
        pallas_backend.register_pallas_filter(
            "hp_ident2", out_like=lambda s: s)(lambda ts: ts)
        try:
            p = tnns.parse_launch(
                "appsrc name=in dims=4:1 types=float32 ! "
                "tensor_transform name=t0 mode=arithmetic option=add:1.0 ! "
                "tensor_filter framework=pallas model=hp_ident2 name=f ! "
                "tensor_transform name=t1 mode=arithmetic option=add:1.0 ! "
                "tensor_sink name=out")
            runner = PipelineRunner(p).start()
            p.get("in").push(np.ones((1, 4), np.float32))
            p.get("in").end()
            runner.wait(30)
            runner.stop()
            assert set(p.elements) == {"in", "f", "out"}
            assert runner.fused_chains() == []
            np.testing.assert_array_equal(
                p.get("out").results[0].tensors[0],
                np.full((1, 4), 3.0, np.float32))
        finally:
            pallas_backend._kernels.pop("hp_ident2", None)

    @pytest.mark.parametrize("pkg", ["torch", "jax"])
    def test_fan_out_not_fused(self, pkg):
        """A demux fans out (two out-links) and the transform before it
        is a run of one: nothing fuses, both branches see the frame."""
        ns = PKGS[pkg]
        pipe = ns.nns.Pipeline("fanout")
        info = ns.Info((1, 4), ns.DType.FLOAT32)
        src = ns.AppSrc(spec=ns.Spec.of(info, info), name="in")
        t0 = ns.Transform(name="t0", mode="arithmetic", option="add:1.0")
        dm = ns.Demux(name="dm")
        s1, s2 = ns.Sink(name="o1"), ns.Sink(name="o2")
        for e in (src, t0, dm, s1, s2):
            pipe.add(e)
        pipe.link(src, t0)
        pipe.link(t0, dm)
        pipe.link(dm, s1, src_pad=0)
        pipe.link(dm, s2, src_pad=1)
        runner = ns.nns.PipelineRunner(pipe, optimize=False).start()
        try:
            x = np.ones((1, 4), np.float32)
            src.push(ns.Buf.of(x, 2 * x, pts=0))
            src.end()
            runner.wait(30)
        finally:
            runner.stop()
        assert runner.fused_chains() == []
        np.testing.assert_array_equal(s1.results[0].tensors[0], 2 * x)
        np.testing.assert_array_equal(s2.results[0].tensors[0], 3 * x)

    @pytest.mark.parametrize("pkg", ["torch", "jax"])
    def test_tee_fan_out_not_fused(self, pkg):
        """tests/test_hostpath.py's case: a tee fans out (2 out-links)
        and t0 alone is a 1-element run: nothing fuses, and both sinks
        still see the frame."""
        ns = PKGS[pkg]
        from importlib import import_module

        tee_cls = import_module(ns.nns.__name__ + ".elements.routing").Tee
        pipe = ns.nns.Pipeline("fanout")
        src = ns.AppSrc(spec=ns.Spec.of(
            ns.Info((1, 4), ns.DType.FLOAT32)), name="in")
        t0 = ns.Transform(name="t0", mode="arithmetic", option="add:1.0")
        tee = tee_cls(name="tee")
        s1, s2 = ns.Sink(name="o1"), ns.Sink(name="o2")
        for e in (src, t0, tee, s1, s2):
            pipe.add(e)
        pipe.link(src, t0)
        pipe.link(t0, tee)
        pipe.link(tee, s1, src_pad=0)
        pipe.link(tee, s2, src_pad=1)
        runner = ns.nns.PipelineRunner(pipe, optimize=False).start()
        try:
            src.push(ns.Buf.of(np.ones((1, 4), np.float32), pts=0))
            src.end()
            runner.wait(30)
        finally:
            runner.stop()
        assert runner.fused_chains() == []
        assert len(pipe.get("o1").results) == 1
        assert len(pipe.get("o2").results) == 1
        np.testing.assert_array_equal(s1.results[0].tensors[0],
                                      np.full((1, 4), 2.0, np.float32))

    @pytest.mark.parametrize("desc", [
        # queue is a pass-through member of the chain around it
        "appsrc name=in dims=4:1 types=float32 ! queue name=q0 ! "
        "tensor_transform name=t0 mode=arithmetic option=add:1.0 ! "
        "queue name=q1 ! tensor_sink name=out",
        # tensor_rate and tensor_aggregator fuse as any 1-in/1-out element
        "appsrc name=in dims=4:1 types=float32 ! "
        "tensor_transform name=t0 mode=arithmetic option=add:1.0 ! "
        "tensor_rate name=r framerate=1000000000/2 throttle=false ! "
        "tensor_aggregator name=a frames-out=2 frames-flush=1 ! "
        "tensor_transform name=t1 mode=arithmetic option=mul:2.0 ! "
        "tensor_sink name=out",
        # a tee splits two chains; the merge after it joins none
        "appsrc name=in dims=4:1 types=float32 ! queue name=q0 ! "
        "tensor_transform name=t0 mode=arithmetic option=add:1.0 ! "
        "tee name=t t. ! queue name=qa ! "
        "tensor_aggregator name=a frames-out=2 ! m.sink_0 "
        "t. ! queue name=qb ! tensor_rate name=r framerate=1000000000/2 "
        "throttle=false ! tensor_aggregator name=b frames-out=2 ! m.sink_1 "
        "tensor_merge name=m option=1 sync-mode=nosync ! queue name=qm ! "
        "tensor_sink name=out",
    ], ids=["queue", "rate-aggregator", "tee-merge"])
    def test_new_elements_fuse_like_jax(self, desc):
        runs = _both(desc, 6)
        (jp, jr), (tp, tr) = runs["jax"], runs["torch"]
        assert sorted(tr.fused_chains()) == sorted(jr.fused_chains())
        assert tr.fused_chains()
        assert _frames(tp.get("out").results) == \
            _frames(jp.get("out").results)
        assert tp.get("out").results

    def test_chain_error_attributed_to_failing_member(self):

        class Boom(Element):
            ELEMENT_NAME = "boom"

            def negotiate(self, in_specs):
                return [self.expect_tensors(in_specs[0])]

            def process(self, pad, buf):
                raise RuntimeError("chain member exploded")

        pipe = tnns.Pipeline("chainboom")
        src = AppSrc(spec=TensorsSpec.of(
            TensorInfo((1, 4), DType.FLOAT32)), name="in")
        t0 = TensorTransform(name="t0", mode="arithmetic", option="add:1.0")
        boom = Boom(name="boom")
        sink = TensorSink(name="out")
        for e in (src, t0, boom, sink):
            pipe.add(e)
        for a, b in zip((src, t0, boom), (t0, boom, sink)):
            pipe.link(a, b)
        runner = PipelineRunner(pipe, optimize=False).start()
        assert runner.fused_chains() == [["t0", "boom"]]
        src.push(TensorBuffer.of(np.ones((1, 4), np.float32), pts=0))
        src.end()
        with pytest.raises(StreamError, match="chain member exploded"):
            runner.wait(10)
        runner.stop()
        assert runner.stats()["t0"]["buffers"] == 1
        assert runner.stats()["boom"]["buffers"] == 0


# -- stats -------------------------------------------------------------------

def test_stats_report_queue_wait():
    """Per-element queue-wait counters separate starvation from slow
    elements; the stats row has the JAX package's keys."""
    pipe = tnns.parse_launch(
        "appsrc name=src dims=4:1 types=float32 ! "
        "tensor_transform mode=arithmetic option=add:1.0 name=tr ! "
        "tensor_sink name=out")
    runner = PipelineRunner(pipe, optimize=False).start()
    for i in range(6):
        pipe.get("src").push(TensorBuffer.of(
            np.ones((1, 4), np.float32), pts=i))
    pipe.get("src").end()
    runner.wait(30)
    runner.stop()
    tr = runner.stats()["tr"]
    assert tr["buffers"] == 6
    assert tr["queue_wait_max_us"] >= tr["queue_wait_avg_us"] >= 0.0
    assert tr["proctime_avg_us"] > 0.0
    assert set(tr) == set(JStats().as_dict())
    assert ElementStats.__slots__ == JStats.__slots__


def test_teardown_drop_counter():
    """A put aborted by teardown counts the lost buffer on its producer;
    a clean run drops nothing."""
    p = tnns.parse_launch(
        "videotestsrc width=4 height=4 num-buffers=40 ! "
        "tensor_converter name=conv ! tensor_sink name=out")
    sink = p.get("out")
    orig = sink.render
    gate = __import__("threading").Event()

    def crawl(buf):
        gate.wait(5.0)
        orig(buf)

    sink.render = crawl
    runner = PipelineRunner(p, queue_capacity=1).start()
    ch = runner._queues["out"]
    for _ in range(500):                # until the producer is blocked
        if ch.full():
            break
        __import__("time").sleep(0.01)
    runner.stop()
    gate.set()
    runner.wait(10)
    assert sum(d["dropped"] for d in runner.stats().values()) >= 1
    p2 = tnns.parse_launch("videotestsrc width=4 height=4 num-buffers=3 "
                           "! tensor_converter ! tensor_sink")
    r2 = PipelineRunner(p2, trace=True)
    r2.run(10)
    assert all(d["dropped"] == 0 for d in r2.stats().values())


# -- upstream events ---------------------------------------------------------

def _qos_element(ns, interval_ns):
    class QosAtStart(ns.Element):
        """Posts one QoS event upstream from start(), before any frame
        flows, so the sources' skips are deterministic."""

        ELEMENT_NAME = "qos_at_start"

        def negotiate(self, in_specs):
            return [in_specs[0]]

        def start(self):
            self.post_upstream_event({"type": "qos",
                                      "min_interval_ns": interval_ns})

        def process(self, pad, buf):
            return [(0, buf)]

    return QosAtStart


FRAME_NS = int(1e9 / 30)


class TestUpstreamQos:
    @pytest.mark.parametrize("pkg", ["torch", "jax"])
    def test_qos_routed_to_videotestsrc(self, pkg):
        ns = PKGS[pkg]
        p = ns.nns.parse_launch(
            "videotestsrc name=src width=4 height=4 num-buffers=10 ! "
            "tensor_converter name=conv ! tensor_sink name=out")
        conv, out = p.get("conv"), p.get("out")
        p.links[:] = [l for l in p.links if l.src is not conv]
        qos = p.add(_qos_element(ns, int(2.5 * FRAME_NS))(name="qos"))
        p.link(conv, qos)
        p.link(qos, out)
        ns.nns.PipelineRunner(p, optimize=False).run(30)
        # frames 0, 3, 6, 9 kept: each at least 2.5 frame times after
        # the last kept one
        assert [b.pts for b in out.results] == [0, 3 * FRAME_NS,
                                                6 * FRAME_NS, 9 * FRAME_NS]
        assert p.get("src").qos_skipped == 6

    def test_qos_walks_across_mux_and_demux(self):
        """From below a tensor_mux the event reaches both sources (each
        consumes its own copy); from one branch of a tensor_demux it
        walks back to the single source."""
        p = tnns.parse_launch(
            "videotestsrc name=a width=4 height=4 num-buffers=6 ! "
            "tensor_converter ! mx.sink_0 "
            "videotestsrc name=b width=4 height=4 num-buffers=6 ! "
            "tensor_converter ! mx.sink_1 "
            "tensor_mux name=mx sync_mode=nosync ! tensor_demux name=dm "
            "dm.src_0 ! tensor_sink name=o0 dm.src_1 ! tensor_sink name=o1")
        o0 = p.get("o0")
        (link,) = [l for l in p.links if l.dst is o0]
        p.links.remove(link)
        qos = p.add(_qos_element(PKGS["torch"], int(1.5 * FRAME_NS))(
            name="qos"))
        p.link(link.src, qos, src_pad=link.src_pad)
        p.link(qos, o0)
        runner = PipelineRunner(p, optimize=False)
        runner.run(30)
        assert p.get("a").qos_skipped == p.get("b").qos_skipped == 3
        assert p.get("a").qos_min_interval_ns == int(1.5 * FRAME_NS)
        assert len(o0.results) == len(p.get("o1").results) == 3
        assert all(d["event_errors"] == 0 for d in runner.stats().values())


# -- watchdog bookkeeping ----------------------------------------------------

class TestWatchdogPrune:
    def _runner(self, **kw):
        p = tnns.parse_launch("appsrc name=in dims=2 ! tensor_sink name=out")
        runner = PipelineRunner(p, optimize=False, watchdog=False,
                                stall_budget_s=0.5,
                                queue_stall_budget_s=0.5, **kw).start()
        p.get("in").end()
        runner.wait(10)
        runner.stop()
        return runner

    def test_stall_bookkeeping_pruned_on_recovery(self):
        runner = self._runner()
        runner._inflight["out"] = 1000.0     # a synthetic stuck process()
        assert runner._watchdog_scan(1000.9) is False
        assert runner._wd_warned_proc == {"out": 1000.0}
        assert runner.stats()["out"]["watchdog_warnings"] == 1
        assert runner._watchdog_scan(1001.5) is False    # same incident
        assert runner.stats()["out"]["watchdog_warnings"] == 1
        runner._inflight.pop("out")          # the call returned
        assert runner._watchdog_scan(1002.0) is False
        assert runner._wd_warned_proc == {}

    def test_queue_bookkeeping_pruned_on_recovery(self):
        runner = self._runner()
        ch = Channel(1)
        ch.put("wedge")                      # pinned at capacity
        runner._queues["phantom"] = ch
        assert runner._watchdog_scan(2000.0) is False
        assert runner._wd_q_full_since == {"phantom": 2000.0}
        assert runner._watchdog_scan(2000.9) is False
        assert runner._wd_warned_q == {"phantom": 2000.0}
        ch.get()                             # drained → recovered
        assert runner._watchdog_scan(2001.0) is False
        assert runner._wd_q_full_since == {} and runner._wd_warned_q == {}

    def test_stall_action_fail_escalates(self):
        runner = self._runner(watchdog_action="fail")
        runner._inflight["out"] = 10.0
        assert runner._watchdog_scan(10.9) is True
        assert isinstance(runner._error, WatchdogStall)

    def test_new_stall_of_same_element_warns_again_traced(self):
        runner = self._runner(trace=Tracer())
        runner._inflight["out"] = 1000.0
        assert runner._watchdog_scan(1000.9) is False
        runner._inflight["out"] = 1001.0     # a second stuck call
        assert runner._watchdog_scan(1001.2) is False    # within budget
        assert runner._watchdog_scan(1001.6) is False
        assert runner.stats()["out"]["watchdog_warnings"] == 2
        assert runner.tracer.watchdog_counts() == {"out": {"stall": 2}}
        wd = [e for e in runner.tracer.events() if e[3] == "watchdog_stall"]
        assert [e[2] for e in wd] == ["out", "out"]

    def test_queue_budget_defaults_to_stall_budget(self, monkeypatch):
        monkeypatch.delenv("NNSTREAMER_TPU_TORCH_RUNTIME_QUEUE_STALL_BUDGET_S",
                           raising=False)
        p = tnns.parse_launch("appsrc name=in dims=2 ! tensor_sink name=out")
        runner = PipelineRunner(p, optimize=False, watchdog=False,
                                stall_budget_s=2.0).start()
        p.get("in").end()
        runner.wait(10)
        runner.stop()
        ch = Channel(1)
        ch.put("wedge")
        runner._queues["phantom"] = ch
        assert runner._watchdog_scan(3000.0) is False
        assert runner._watchdog_scan(3001.9) is False    # under 2.0 s
        assert runner._wd_warned_q == {}
        assert runner._watchdog_scan(3002.1) is False
        assert runner._wd_warned_q == {"phantom": 3000.0}

    def test_queue_action_fail_escalates(self):
        runner = self._runner(watchdog_action="fail")
        ch = Channel(1)
        ch.put("wedge")
        runner._queues["phantom"] = ch
        assert runner._watchdog_scan(4000.0) is False
        assert runner._watchdog_scan(4000.9) is True
        assert isinstance(runner._error, WatchdogStall)
        assert "input queue of element phantom" in str(runner._error)


class TestWedgedAdmission:
    """Watchdog wedged-admission incidents: depth pinned at max_pending
    with zero reply progress for the queue stall budget."""

    @staticmethod
    def _runner(counters, pkg=tnns, Stats=ElementStats, tracer=None, **kw):
        p = pkg.parse_launch("appsrc name=in dims=2 ! tensor_sink name=out")
        runner = pkg.PipelineRunner(
            p, optimize=False, watchdog=False,
            trace=tracer if tracer is not None else Tracer(),
            stall_budget_s=0.5, queue_stall_budget_s=0.5, **kw).start()
        p.get("in").end()
        runner.wait(10)
        runner.stop()
        elem = SimpleNamespace(
            name="adm", admission_counters=lambda: dict(counters))
        runner.pipeline.elements["adm"] = elem
        runner._stats.setdefault("adm", Stats())
        return runner

    def test_warn_once_rearm_on_progress_prune_on_recovery(self):
        c = {"depth": 8, "max_pending": 8, "replied": 0}
        runner = self._runner(c)
        warns = lambda: runner.stats()["adm"]["watchdog_warnings"]
        assert runner._watchdog_scan(3000.0) is False   # arms
        assert runner._wd_adm_since == {"adm": (3000.0, 0)}
        assert warns() == 0
        assert runner._watchdog_scan(3000.9) is False   # past budget
        assert warns() == 1
        assert runner._wd_warned_adm == {"adm": 3000.0}
        wd = [e for e in runner.tracer.events()
              if e[3] == "watchdog_wedged-admission"]
        assert len(wd) == 1 and wd[0][2] == "adm"
        assert runner._watchdog_scan(3001.5) is False   # same incident
        assert warns() == 1
        c["replied"] = 3                                # progress: re-arm
        assert runner._watchdog_scan(3002.0) is False
        assert runner._wd_adm_since == {"adm": (3002.0, 3)}
        assert runner._wd_warned_adm == {}
        assert runner._watchdog_scan(3002.8) is False   # wedged again
        assert warns() == 2
        c["depth"] = 2                                  # recovery prunes
        assert runner._watchdog_scan(3003.0) is False
        assert runner._wd_adm_since == {} and runner._wd_warned_adm == {}

    def test_depth_pinned_but_replies_flowing_never_warns(self):
        c = {"depth": 8, "max_pending": 8, "replied": 0}
        runner = self._runner(c)
        assert runner._watchdog_scan(4000.0) is False
        for i, t in enumerate((4000.4, 4000.8, 4001.2, 4001.6)):
            c["replied"] = i + 1
            assert runner._watchdog_scan(t) is False
        assert runner.stats()["adm"]["watchdog_warnings"] == 0
        assert runner._wd_warned_adm == {}

    def test_action_fail_escalates_to_watchdog_stall(self):
        c = {"depth": 4, "max_pending": 4, "replied": 7}
        runner = self._runner(c, watchdog_action="fail")
        assert runner._watchdog_scan(5000.0) is False   # arms
        assert runner._watchdog_scan(5000.9) is True    # escalates
        assert isinstance(runner._error, WatchdogStall)
        assert "wedged-admission" in str(runner._error)

    def test_scan_script_matches_jax(self):
        """One counter script, one clock, both packages' scans: the same
        verdicts, bookkeeping and warning counts at every step."""
        from nnstreamer_tpu.runtime.tracing import Tracer as JTracer

        script = [(0.0, 8, 0), (0.3, 8, 0), (0.6, 8, 0), (0.9, 8, 0),
                  (1.0, 8, 2), (1.4, 8, 2), (1.6, 8, 2), (2.0, 5, 2),
                  (2.1, 8, 2), (2.7, 8, 2)]
        logs = []
        for pkg, Stats, tr in ((jnns, JStats, JTracer()),
                               (tnns, ElementStats, Tracer())):
            c = {"depth": 0, "max_pending": 8, "replied": 0}
            runner = self._runner(c, pkg=pkg, Stats=Stats, tracer=tr)
            log = []
            for t, depth, replied in script:
                c.update(depth=depth, replied=replied)
                log.append((runner._watchdog_scan(6000.0 + t),
                            dict(runner._wd_adm_since),
                            dict(runner._wd_warned_adm),
                            runner.stats()["adm"]["watchdog_warnings"]))
            logs.append(log)
        assert logs[1] == logs[0]
        assert logs[1][-1][3] == 3

    def test_real_serversrc_is_probed(self):
        """A tensor_query_serversrc whose admission queue holds
        max_pending frames nobody takes: the scan reads its counters and
        flags it."""
        from nnstreamer_tpu_torch.edge import QueryServer

        from nnstreamer_tpu_torch.edge.query import TensorQueryServerSrc

        runner = self._runner({"depth": 0, "max_pending": 1, "replied": 0})
        ssrc = TensorQueryServerSrc(name="ssrc", id=61, dims="1:8")
        runner.pipeline.elements["ssrc"] = ssrc
        runner._stats.setdefault("ssrc", ElementStats())
        q = QueryServer.get(61).frames
        try:
            q.configure(max_pending=2)
            for i in range(2):
                assert q.offer(TensorBuffer.of(
                    np.ones((8, 1), np.float32), pts=i)).admitted
            assert runner._watchdog_scan(7000.0) is False
            assert runner._watchdog_scan(7000.9) is False
            assert runner.stats()["ssrc"]["watchdog_warnings"] == 1
        finally:
            QueryServer.reset_all()

"""The port's tracer (runtime/tracing.py), the runner's stats()/report(),
tensor_debug's capture and the `trace` CLI, held to the JAX package's on
the same pipelines, on the CPU.

Ported from tests/test_tracing.py: TestTracerCore, TestChromeTrace,
TestReport, TestSchedulerAccounting, TestDebugCapture, TestCLI,
TestMergeChromeTraces, TestHistBounds. Where both packages run the same
pipeline, the test runs it in both and compares what is deterministic:
the set of trace tracks, process spans per element, summary() keys,
report() section headers, kernel_spans() counts and the LLM request
records. Times are never compared. Differences by design are asserted
and named where they show:

- the port's `framework=pallas` backend records an invoke span per
  frame, where the JAX package's Pallas backend records none;
- the port's invoke spans carry no `compile=` arg: PyTorch runs eagerly,
  there is no jit to be fresh or cached;
- on the CPU the port records no forced sync: its choke point counts
  only the waits for CUDA work, where the JAX package's counts every
  block_until_ready, CPU arrays included.

Not copied: `TestSchedulerAccounting::test_noop_tracer_overhead_smoke`,
a wall-clock bound (the tracer's cost is measured on the card,
chip_smoke.py phase 26); the tensor_batch flush markers and the XLA
bucket cache counters (their modules are not ported); TestChildShipping
(the worker pool's trace shipping, ROADMAP Queue 1 item 4c).
TestTraceContext holds the request-scoped helpers (the query edge's
trace context, hop spans) and the shed/request records to JAX's.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
from nnstreamer_tpu import register_custom_easy
from nnstreamer_tpu.__main__ import main as jax_main
from nnstreamer_tpu.backends.custom import unregister_custom_easy
from nnstreamer_tpu.llm import LLMEngine as JaxLLMEngine
from nnstreamer_tpu.models import transformer as jt
from nnstreamer_tpu.runtime import tracing as jtr
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JaxBuffer

import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu_torch.__main__ import main as port_main
from nnstreamer_tpu_torch.backends import pallas_backend
from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.llm import LLMEngine
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.runtime import tracing as ttr
from nnstreamer_tpu_torch.runtime.scheduler import PipelineRunner
from nnstreamer_tpu_torch.runtime.tracing import (
    NULL_TRACER, SOURCE_TS_META, NullTracer, Tracer, percentile)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

SLEEP_S = 0.01


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def models():
    """register(name, fn): `fn` (numpy in, numpy out) as the port's
    kernel filter (`framework=pallas`) and the JAX package's custom
    filter (`framework=custom`) under one name, output spec = input spec;
    both unregistered after the test."""
    names = []

    def register(name, fn):
        names.append(name)
        pallas_backend.register_pallas_filter(name, out_like=lambda s: s)(
            lambda ts: fn(tuple(t.numpy() for t in ts)))
        register_custom_easy(name, fn, infer_out=lambda s: s)

    yield register
    for n in names:
        pallas_backend._kernels.pop(n, None)
        unregister_custom_easy(n)


def _sleepy(ts):
    time.sleep(SLEEP_S)
    return tuple(ts)


def _run(pkg, desc, timeout=60, **kw):
    p = pkg.parse_launch(desc)
    # the scheduler bypasses off: the JAX package's device segments and
    # both packages' compiled loop (per-frame spans are compared)
    kw = {"compiled_loop": False, **kw}
    if pkg is jnns:
        kw = {"device_segments": False, **kw}
    runner = pkg.PipelineRunner(p, trace=True, **kw).start()
    try:
        runner.wait(timeout)
    finally:
        runner.stop()
    return p, runner


def _both(desc, **kw):
    """`desc` (with `{fw}` for the filter framework) traced in both
    packages → ((JAX pipe, runner), (port pipe, runner))."""
    return (_run(jnns, desc.format(fw="custom"), **kw),
            _run(tnns, desc.format(fw="pallas"), **kw))


def _spans(tracer, cat="element", label="process"):
    out = {}
    for ph, c, name, lab, *_ in tracer.events():
        if ph == "X" and c == cat and lab == label:
            out[name] = out.get(name, 0) + 1
    return out


def _tracks(doc):
    return {ev["args"]["name"] for ev in doc["traceEvents"]
            if ev["ph"] == "M" and ev["name"] == "thread_name"}


def _headers(report):
    """The report's section headers (its title and lines ending in a
    colon), without the pipeline name."""
    return [l.split(" — ")[-1] for l in report.splitlines()
            if l and not l.startswith(" ") and (l.endswith(":")
                                                or "element report" in l)]


# -- tracer core -------------------------------------------------------------

class TestTracerCore:
    def test_default_is_noop(self):
        p = tnns.parse_launch("videotestsrc width=4 height=4 num-buffers=2 "
                              "! tensor_converter ! tensor_sink")
        runner = PipelineRunner(p)
        assert runner.tracer is NULL_TRACER and runner.tracer.active is False
        runner.run(10)
        assert isinstance(runner.tracer, NullTracer)

    def test_null_tracer_has_the_jax_hook_surface(self):
        def public(cls):
            return {n for n in dir(cls) if not n.startswith("_")}

        assert public(jtr.NullTracer) <= public(NullTracer)
        # the shipping and autotune hooks: no-ops on the null tracer; a
        # fresh recording tracer ships what the JAX package's ships
        assert NULL_TRACER.ship_delta() is None
        assert Tracer().ship_delta() == jtr.Tracer().ship_delta()
        for t in (NULL_TRACER, Tracer()):
            t.ingest_child(0, 1, {})
            t.record_request("svc", "id", [], 0.0)
            t.record_autotune("svc", "knob", 0.0)
            assert t.tenant_summary() == {}
        # the compiled loop's hooks (ported): no-ops on the null tracer,
        # recorded on the recording one as the JAX package's Tracer does
        for t, j in ((NULL_TRACER, jtr.NULL_TRACER), (Tracer(), jtr.Tracer())):
            for tr in (t, j):
                tr.record_compiled_window("f", 4, 0.0, 1.0)
                tr.record_loop_bail("f", "eos", 0.0)
            assert (t.compiled_windows(), t.loop_bails()) == \
                (j.compiled_windows(), j.loop_bails())

    def test_percentile_matches_jax(self):
        vals = sorted(float(i) for i in range(1, 101))
        for p in (0, 1, 50, 95, 99, 100):
            assert percentile(vals, p) == jtr.percentile(vals, p)
        assert percentile(vals, 50) == 50.0 and percentile([], 50) == 0.0

    def test_process_spans_per_element_match_jax(self):
        desc = ("videotestsrc name=src width=4 height=4 num-buffers=6 ! "
                "tensor_converter name=conv ! tensor_sink name=out")
        (jp, jr), (tp, tr) = _both(desc)
        spans = _spans(tr.tracer)
        assert spans == {"conv": 6, "out": 6} == _spans(jr.tracer)
        for name in spans:
            starts = [e[4] for e in tr.tracer.events()
                      if e[0] == "X" and e[2] == name and e[3] == "process"]
            assert starts == sorted(starts)
        assert set(tr.tracer.summary()) == set(jr.tracer.summary())
        assert set(tr.tracer.hists()) == set(jr.tracer.hists())

    def test_interlatency_per_element(self, models):
        models("tr_sleepy", _sleepy)
        (jp, jr), (tp, tr) = _both(
            "videotestsrc width=4 height=4 num-buffers=8 ! tensor_converter "
            "name=conv ! tensor_transform name=tt mode=typecast "
            "option=float32 ! tensor_filter framework={fw} model=tr_sleepy "
            "name=filt ! tensor_sink name=out", optimize=False)
        inter = tr.tracer.interlatency()
        assert set(inter) == set(jr.tracer.interlatency())
        assert {k: v["n"] for k, v in inter.items()} == \
            {"conv": 8, "tt": 8, "filt": 8, "out": 8}
        r = inter["out"]
        assert r["p50_ms"] <= r["p95_ms"] <= r["p99_ms"] <= r["max_ms"]
        # a frame reaches the sink after the converter: ordered by design
        assert inter["conv"]["p50_ms"] <= r["p50_ms"]

    def test_source_ts_stamped_in_meta(self):
        p, runner = _run(tnns, "videotestsrc width=4 height=4 "
                               "num-buffers=2 ! tensor_converter ! "
                               "tensor_sink name=out")
        assert all(SOURCE_TS_META in b.meta for b in p.get("out").results)

    def test_queue_highwater_under_backpressure(self):
        p = tnns.parse_launch(
            "videotestsrc width=4 height=4 num-buffers=20 ! "
            "tensor_converter ! tensor_sink name=out")
        sink = p.get("out")
        orig = sink.render

        def slow_render(buf):
            time.sleep(0.005)
            orig(buf)

        sink.render = slow_render
        runner = PipelineRunner(p, queue_capacity=2, trace=True)
        runner.run(30)
        assert len(sink.results) == 20
        assert runner.tracer.queue_gauges()["out"]["peak"] >= 2
        assert runner.stats()["out"]["queue_peak"] >= 2

    def test_event_ring_is_bounded_like_jax(self):
        ours, theirs = Tracer(max_events=16), jtr.Tracer(max_events=16)
        for tr in (ours, theirs):
            for i in range(100):
                tr.instant("e", "tick", t=float(i))
        assert len(ours.events()) == 16 and ours.events_dropped == 84
        assert ours.events() == theirs.events()
        assert ours.events_dropped == theirs.events_dropped
        assert ours.total_events == theirs.total_events == 100
        assert ours.summary()["events_dropped"] == 84

    def test_event_count_exact_across_threads(self):
        """Many threads recording at once with a short switch interval:
        no event count is lost, so events_dropped stays exact."""
        import sys
        import threading

        tr = Tracer(max_events=1000)
        n_threads, per = 16, 2000
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(
                target=lambda i=i: [tr.instant(f"e{i}", "tick", t=0.0)
                                    for _ in range(per)])
                for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(interval)
        assert tr.total_events == n_threads * per
        assert len(tr.events()) == 1000
        assert tr.events_dropped == n_threads * per - 1000

    def test_hooks_record_like_jax(self):
        """The same hook calls leave the same events and read-outs."""
        ours, theirs = Tracer(), jtr.Tracer()
        for tr, buf in ((ours, TensorBuffer.of(np.zeros(2))),
                        (theirs, jnns.TensorBuffer.of(np.zeros(2)))):
            tr.source_emit("src", buf, 1.0)
            tr.enqueue("a", 3, 1.1)
            tr.dequeue("a", 2, 1.2)
            tr.record_process("a", buf, 1.2, 1.5)
            tr.record_timer("a", 1.5, 1.6)
            tr.record_flush("a", 1.6, 1.7)
            tr.record_eos("a", 1.7)
            tr.record_drop("a", 1.8)
            tr.record_error("a", "ValueError", 1.9, policy="skip", pts=3)
            tr.record_watchdog("a", "stall", 2.0, stalled_s=1.0)
            tr.backend_span("a", "invoke", 2.0, 2.1, kernel="pallas")
            tr.device_span(0, "invoke", 2.1, 2.2, element="a")
            tr.record_llm_request("llm", "r0", 2.3, n_tokens=4)
            tr.record_swap("llm", 2.35, model="m", from_version=1,
                           to_version=2, epoch=1, prewarmed=True)
            tr.record_forced_sync("a", 2.4)
            tr.record_inflight("a", 5, 2.5)
            tr.record_flight("dump", 2.6, path="x")
            tr.record_device_counter("mfu:a", 0.5, 2.7)
            tr.instant("a", "mark", t=2.8, k=1)
        assert ours.events() == theirs.events()
        for read in ("interlatency", "queue_gauges", "forced_syncs",
                     "inflight_gauges", "kernel_spans", "watchdog_counts",
                     "llm_requests", "flight_dumps", "hists",
                     "swap_events"):
            assert getattr(ours, read)() == getattr(theirs, read)(), read
        ours._t0 = theirs._t0 = 0.0      # the same time origin
        assert ours.to_chrome_trace("p") == theirs.to_chrome_trace("p")
        assert ours.summary() == theirs.summary()


# -- Chrome trace ------------------------------------------------------------

    def test_batch_flush_markers_and_batched_interlatency(self):
        """From test_tracing.py: 10 frames at max-batch 4 flush full,
        full, then at EOS; interlatency survives batch → unbatch (the
        frames' stamps ride in the dyn_batch metas), and a batched buffer
        is stamped by its oldest frame."""
        desc = ("appsrc name=in dims=4 types=float32 ! "
                "tensor_batch name=b max-batch=4 max-latency-ms=1000 ! "
                "tensor_unbatch name=u ! tensor_sink name=out")
        flushes, inters = [], []
        for pkg, buf_cls in ((jnns, JaxBuffer), (tnns, TensorBuffer)):
            p = pkg.parse_launch(desc)
            runner = pkg.PipelineRunner(p, trace=True).start()
            src = p.get("in")
            for i in range(10):
                src.push(buf_cls.of(np.full((4,), float(i), np.float32),
                                    pts=i))
            src.end()
            runner.wait(30)
            runner.stop()
            flushes.append([(name, label, args) for ph, _, name, label, _,
                            _, args in runner.tracer.events()
                            if ph == "i" and label.startswith("flush_")])
            inters.append({k: v["n"] for k, v in
                           runner.tracer.interlatency().items()})
        assert flushes[1] == flushes[0]
        labels = [l for _, l, _ in flushes[1]]
        assert labels.count("flush_full") == 2
        assert labels.count("flush_eos") == 1
        assert {a["n"] for _, _, a in flushes[1]} == {4, 2}
        assert inters[1] == inters[0]
        assert inters[1]["out"] == 10 and inters[1]["b"] == 10
        assert inters[1]["u"] == 3          # one sample a batch


class TestChromeTrace:
    def test_schema_and_one_track_per_element(self, models):
        models("tr_ident", lambda ts: tuple(ts))
        (jp, jr), (tp, tr) = _both(
            "videotestsrc name=src width=4 height=4 num-buffers=4 ! "
            "tensor_converter name=conv ! tensor_transform mode=typecast "
            "option=float32 ! tensor_filter framework={fw} model=tr_ident "
            "name=filt ! tensor_sink name=out")
        doc = json.loads(json.dumps(tr.tracer.to_chrome_trace("demo")))
        assert isinstance(doc["traceEvents"], list)
        assert doc["displayTimeUnit"] == "ms"
        tids = {}
        for ev in doc["traceEvents"]:
            assert ev["ph"] in ("M", "X", "C", "i") and "pid" in ev
            if ev["ph"] == "M" and ev["name"] == "thread_name":
                tids[ev["args"]["name"]] = ev["tid"]
            if ev["ph"] == "X":
                assert ev["ts"] >= 0.0 and ev["dur"] >= 0.0
            if ev["ph"] == "C":
                assert "depth" in ev["args"]
        assert len(set(tids.values())) == len(tids)
        assert {ev["tid"] for ev in doc["traceEvents"]
                if ev["ph"] == "X"} <= set(tids.values())
        assert set(tids) == {"src", "conv", "filt", "out"} == \
            _tracks(jr.tracer.to_chrome_trace("demo"))
        assert _spans(tr.tracer) == _spans(jr.tracer)
        # the port's kernel-filter backend records an invoke span a
        # frame; the JAX package's custom backend records none
        assert _spans(tr.tracer, "backend", "invoke") == {"filt": 4}
        assert _spans(jr.tracer, "backend", "invoke") == {}

    def test_backend_spans_on_both_filters_of_b(self):
        """Pipeline B's shape — the normalize_u8 kernel filter, then a
        model filter (a small callable here, the same in both packages),
        then the label decoder — on the same frames in both packages."""
        def model(x):                  # jnp arrays and torch tensors alike
            return x.reshape(1, -1)[:, :10] * 2.0

        desc = ("videotestsrc name=src num-buffers=3 width=8 height=8 "
                "pattern=random seed=7 ! tensor_converter name=conv ! "
                "tensor_filter framework=pallas model=normalize_u8 name=norm "
                "! tensor_filter name=model ! "
                "tensor_decoder mode=image_labeling name=dec ! "
                "tensor_sink name=out")
        runs = {}
        for pkg in (jnns, tnns):
            p = pkg.parse_launch(desc)
            p.get("model").set_props(model=model)
            kw = ({"compiled_loop": False, "device_segments": False}
                  if pkg is jnns else {"compiled_loop": False})
            runner = pkg.PipelineRunner(p, trace=True, **kw)
            runner.run(120)
            runs[pkg] = (p, runner)
        (jp, jr), (tp, tr) = runs[jnns], runs[tnns]
        assert [(b.meta["label_index"], b.meta["score"])
                for b in tp.get("out").results] == \
            [(b.meta["label_index"], b.meta["score"])
             for b in jp.get("out").results]
        assert _tracks(tr.tracer.to_chrome_trace()) == \
            _tracks(jr.tracer.to_chrome_trace()) == \
            {"src", "conv", "norm", "model", "dec", "out"}
        assert _spans(tr.tracer) == _spans(jr.tracer) == {
            "conv": 3, "norm": 3, "model": 3, "dec": 3, "out": 3}
        ours = [e for e in tr.tracer.events()
                if e[0] == "X" and e[1] == "backend"]
        theirs = [e for e in jr.tracer.events()
                  if e[0] == "X" and e[1] == "backend"]
        assert sorted(e[2] for e in ours) == ["model"] * 3 + ["norm"] * 3
        # named differences: JAX's Pallas backend records no span, and
        # its XLA spans say whether the jit was fresh or cached
        assert sorted(e[2] for e in theirs) == ["model"] * 3
        assert [e[6]["compile"] for e in theirs] == \
            ["fresh", "cached", "cached"]
        assert all(e[3] == "invoke" and e[6] is None for e in ours)
        assert tr.tracer.kernel_spans() == jr.tracer.kernel_spans() == {}
        # on the CPU: no CUDA work to wait for, no forced sync
        assert tr.tracer.forced_syncs() == {}
        st = tr.stats()
        assert st["model"]["backend_invoke_failures"] == 0
        assert st["model"]["backend_staging_elided"] == 3
        assert set(tr.tracer.inflight_gauges()) == {"norm", "model"}


# -- report ------------------------------------------------------------------

class TestReport:
    def test_report_table_and_sections_match_jax(self, models):
        models("tr_sleepy2", _sleepy)
        (jp, jr), (tp, tr) = _both(
            "videotestsrc width=4 height=4 num-buffers=4 ! tensor_converter "
            "name=conv ! tensor_transform mode=typecast option=float32 "
            "name=tt ! tensor_filter framework={fw} model=tr_sleepy2 "
            "name=filt ! tensor_sink name=out", optimize=False)
        rep = tr.report()
        for col in ("buffers", "total ms", "q.peak", "p50", "p99",
                    "(sink)"):
            assert col in rep
        assert _headers(rep) == _headers(jr.report()) == [
            "element report",
            "fused chains (one worker thread, direct call-through):",
            "queue high-water (capacity 4):",
            "interlatency source → element (ms):", "backend counters:"]
        rows = [l for l in rep.splitlines()
                if l.startswith(("filt", "out", "conv", "tt"))]
        assert rows[0].startswith("filt")   # 10 ms a frame leads

    def test_report_without_tracer_still_has_proctime(self):
        p = tnns.parse_launch("videotestsrc width=4 height=4 num-buffers=2 "
                              "! tensor_converter ! tensor_sink name=out")
        runner = PipelineRunner(p)
        runner.run(10)
        rep = runner.report()
        assert "element report" in rep and "queue high-water" in rep
        assert "interlatency" not in rep

    def test_report_robustness_and_sync_sections(self):
        tr = Tracer()
        tr.record_forced_sync("dec", 1.0)
        tr.record_inflight("model", 3, 1.0)
        tr.record_swap("llm", 1.0, model="m", from_version=1, to_version=2,
                       epoch=1, prewarmed=True)
        p = tnns.parse_launch(
            "videotestsrc width=4 height=4 num-buffers=8 ! tensor_converter "
            "! tensor_fault name=flt mode=raise period=2 error-policy=skip "
            "! tensor_sink name=out")
        runner = PipelineRunner(p, trace=tr)
        runner.run(10)
        rep = runner.report()
        assert "robustness (error-policy / watchdog counters):" in rep
        assert "flt: errors=4 retries=0 skipped=4" in rep
        assert "dec: forced_syncs=1" in rep
        assert "model: inflight_peak=3 (window 8)" in rep
        assert "model swaps (store:// epoch adoptions):" in rep
        assert "llm: m v1 → v2 epoch=1 prewarmed=True" in rep


# -- scheduler accounting ----------------------------------------------------

class TestSchedulerAccounting:
    def test_wait_timeout_chains_pending_error(self):
        def boom(ts):
            raise RuntimeError("model exploded")

        pallas_backend.register_pallas_filter(
            "tr_boom", out_like=lambda s: s)(boom)
        try:
            p = tnns.parse_launch(
                "appsrc name=in dims=4 types=float32 ! "
                "tensor_filter framework=pallas model=tr_boom ! tensor_sink")
            runner = PipelineRunner(p).start()
            p.get("in").push(np.zeros((4,), np.float32))
            deadline = time.monotonic() + 10
            while runner._error is None and time.monotonic() < deadline:
                time.sleep(0.01)
            with pytest.raises(StreamError, match="model exploded"):
                runner.wait(0.5)
            runner.stop()
        finally:
            pallas_backend._kernels.pop("tr_boom", None)


# -- tensor_debug ------------------------------------------------------------

class TestDebugCapture:
    def test_capture_bounded_and_extra_stats_match_jax(self):
        desc = ("videotestsrc width=4 height=4 num-buffers=12 ! "
                "tensor_converter ! tensor_debug name=dbg capture=true "
                "capture-limit=5 ! tensor_sink name=out")
        (jp, jr), (tp, tr) = _both(desc)
        dbg = tp.get("dbg")
        assert len(dbg.lines) == 5
        st = tr.stats()["dbg"]
        assert (st["buffers_seen"], st["captured_lines"],
                st["capture_dropped"]) == (12, 5, 8)
        assert not any("negotiated" in l for l in dbg.lines)
        keys = ("buffers_seen", "captured_lines", "capture_dropped")
        assert {k: st[k] for k in keys} == \
            {k: jr.stats()["dbg"][k] for k in keys}

    def test_verbose_value_stats(self):
        p = tnns.parse_launch(
            "appsrc name=in dims=4 types=float32 ! tensor_debug name=dbg "
            "capture=true verbose=true ! tensor_sink")
        runner = PipelineRunner(p).start()
        p.get("in").push(TensorBuffer.of(torch.arange(4.0)))
        p.get("in").end()
        runner.wait(10)
        runner.stop()
        assert "min=0 max=3 mean=1.5" in p.get("dbg").lines[-1]


# -- CLI ---------------------------------------------------------------------

CLI_DESC = ("videotestsrc name=src width=4 height=4 num-buffers=3 ! "
            "tensor_converter name=conv ! tensor_sink name=out")


class TestCLI:
    def test_trace_subcommand_writes_valid_trace(self, tmp_path, capsys):
        out = tmp_path / "trace.json"
        rc = port_main(["trace", CLI_DESC, "--out", str(out),
                        "--timeout", "30"])
        assert rc == 0
        doc = json.loads(out.read_text())
        assert doc["traceEvents"]
        captured = capsys.readouterr()
        assert "element report" in captured.out
        assert "interlatency" in captured.out
        jout = tmp_path / "jax.json"
        assert jax_main(["trace", CLI_DESC, "--out", str(jout),
                         "--timeout", "30"]) == 0
        assert _tracks(doc) == _tracks(json.loads(jout.read_text())) == \
            {"src", "conv", "out"}

    def test_trace_merge(self, tmp_path, capsys):
        paths = []
        for name in ("a", "b"):
            paths.append(tmp_path / f"{name}.json")
            assert port_main(["trace", CLI_DESC, "--out",
                              str(paths[-1])]) == 0
        merged = tmp_path / "m.json"
        assert port_main(["trace", "--merge", *map(str, paths), "--out",
                          str(merged)]) == 0
        doc = json.loads(merged.read_text())
        names = sorted(ev["args"]["name"] for ev in doc["traceEvents"]
                       if ev["ph"] == "M" and ev["name"] == "process_name")
        assert names == ["a.json/pipeline", "b.json/pipeline"]
        assert port_main(["trace", "one", "two"]) == 2

    def test_stats_flag_prints_stats_json(self, capsys):
        assert port_main([CLI_DESC, "--stats"]) == 0
        st = json.loads(capsys.readouterr().out)
        assert st["conv"]["buffers"] == 3 and st["out"]["buffers"] == 3


# -- merge -------------------------------------------------------------------

class TestMergeChromeTraces:
    def test_pid_remap_matches_jax(self):
        def mkdoc(seed):
            tr = Tracer()
            buf = TensorBuffer.of(np.ones((2,), np.float32))
            tr.record_process("router", buf, 1.0 + seed, 1.0001 + seed)
            tr.record_process("echo", buf, 2.0 + seed, 2.0002 + seed)
            doc = tr.to_chrome_trace(f"p{seed}")
            # a second process group, as a worker's track would render
            doc["traceEvents"].append({"ph": "M", "name": "process_name",
                                       "pid": 1, "tid": 0,
                                       "args": {"name": "worker0"}})
            return doc

        docs = [mkdoc(0), mkdoc(1)]
        merged = ttr.merge_chrome_traces(docs, labels=["runA", "runB"])
        assert merged == jtr.merge_chrome_traces(docs,
                                                 labels=["runA", "runB"])
        assert {e["pid"] for e in merged["traceEvents"]} == {0, 1, 2, 3}
        names = [e["args"]["name"] for e in merged["traceEvents"]
                 if e.get("name") == "process_name"]
        assert sum(n.startswith("runA/") for n in names) == 2
        assert len(merged["traceEvents"]) == \
            sum(len(d["traceEvents"]) for d in docs)


# -- histogram bounds --------------------------------------------------------

class TestHistBounds:
    def test_bounds_equal_jax(self):
        assert ttr.HIST_BOUNDS_S == jtr.HIST_BOUNDS_S
        assert ttr.HIST_BOUNDS_S[0] == pytest.approx(1e-5)
        assert ttr.HIST_BOUNDS_S[-1] == pytest.approx(10.0)
        assert list(ttr.HIST_BOUNDS_S) == sorted(ttr.HIST_BOUNDS_S)

    def test_buckets_match_jax(self):
        vals = [0.0, 1e-6, 1e-5, 3e-5, 0.001, 0.25, 9.9, 10.0, 11.0]
        ours, theirs = ttr._Hist(), jtr._Hist()
        for v in vals:
            ours.record(v)
            theirs.record(v)
        assert ours.snapshot() == theirs.snapshot()


# -- the traced LLM engine ---------------------------------------------------

def test_traced_llm_engine_matches_jax():
    """The same requests through both engines with paged_kernel=pallas
    (the JAX package's Pallas kernels in interpret mode, the port's
    plain versions on CPU tensors): equal tokens, equal kernel_spans(),
    equal compile/invoke span counts per call kind, and request records
    of the same requests and lengths."""
    jp = jt.init_params(vocab=61, d_model=32, n_layers=2, n_heads=4,
                        n_kv_heads=2, seed=0)
    tp = bridge.transformer_params(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 61, size=n).astype(np.int32)
               for n in (3, 6, 9)]
    kw = dict(n_heads=4, block_size=4, num_blocks=32, max_batch=4,
              max_len=64, paged_kernel="pallas", prefill_chunk=4)
    engines = {}
    for pkg, cls, params, tracer in ((jnns, JaxLLMEngine, jp, jtr.Tracer()),
                                     (tnns, LLMEngine, tp, Tracer())):
        eng = cls(params, tracer=tracer, **kw)
        reqs = [eng.submit(p, max_new_tokens=4, req_id=f"r{i}")
                for i, p in enumerate(prompts)]
        eng.drain()
        engines[pkg] = (eng, reqs, tracer)
    (je, jreqs, jtrc), (te, treqs, ttrc) = engines[jnns], engines[tnns]
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert ttrc.kernel_spans() == jtrc.kernel_spans()
    assert ttrc.kernel_spans()[("llm", "pallas")] == \
        te.executor.kernel_invokes["pallas"] > 0

    def kinds(tracer):
        out = {}
        for ph, cat, name, label, ts, dur, args in tracer.events():
            if cat == "backend":
                key = (label, args["what"], args.get("kernel"))
                out[key] = out.get(key, 0) + 1
        return out

    assert kinds(ttrc) == kinds(jtrc)

    def records(tracer):
        return sorted((rid, a["prompt_len"], a["n_tokens"],
                       a["finish_reason"])
                      for _, rid, _, a in tracer.llm_requests())

    assert records(ttrc) == records(jtrc) and len(records(ttrc)) == 3
    assert all(set(a) == set(b) for (*_, a), (*_, b) in
               zip(ttrc.llm_requests(), jtrc.llm_requests()))
    # named difference: the JAX package counts its CPU read-backs as
    # forced syncs; the port counts only waits for CUDA work
    assert any(k.startswith("llm:") for k in jtrc.forced_syncs())
    assert ttrc.forced_syncs() == {}


def test_store_swap_is_traced():
    """A store hot swap adopted by a traced engine lands in the tracer's
    swap records (and so in report()), as the JAX executor records it."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.models import transformer as tt
    from nnstreamer_tpu_torch.serving.store import get_store, reset_store

    dims = dict(vocab=61, d_model=32, n_layers=1, n_heads=4)
    reset_store()
    try:
        store = get_store()
        store.register("tr_swap", ModelBundle(
            fn=None, params=tt.init_params(**dims, seed=0)))
        tracer = Tracer()
        eng = LLMEngine("store://tr_swap", n_heads=4, block_size=4,
                        num_blocks=16, max_batch=2, max_len=32,
                        tracer=tracer)
        prompt = np.array([3, 44, 8], np.int32)
        eng.submit(prompt, max_new_tokens=2)
        eng.drain()
        store.register("tr_swap", ModelBundle(
            fn=None, params=tt.init_params(**dims, seed=1)))
        store.update("tr_swap")
        eng.submit(prompt, max_new_tokens=2)
        eng.drain()
    finally:
        reset_store()
    (name, _, args), = tracer.swap_events()
    assert name == "llm" and tracer.summary()["swaps"] == 1
    assert args == {"model": "tr_swap", "from_version": 1,
                    "to_version": 2, "epoch": 1, "prewarmed": True}
    assert len(tracer.llm_requests()) == 2


# -- request-scoped trace context (the query edge) ---------------------------

class TestTraceContext:
    def test_ensure_creates_once_and_reuses_id(self):
        meta = {}
        ctx = ttr.ensure_trace_ctx(meta)
        assert len(ctx["id"]) == 16 and ctx["hops"] == []
        assert ttr.ensure_trace_ctx(meta)["id"] == ctx["id"]
        assert meta[ttr.TRACE_CTX_META] is ctx
        assert ttr.TRACE_CTX_META == jtr.TRACE_CTX_META

    def test_get_never_creates_and_stamp_is_noop_without_ctx(self):
        meta = {"pts": 3}
        assert ttr.get_trace_ctx(meta) is None and meta == {"pts": 3}
        assert ttr.get_trace_ctx(None) is None
        assert ttr.get_trace_ctx({"_trace_ctx": "junk"}) is None
        assert ttr.stamp_hop(meta, "admit") is None and meta == {"pts": 3}
        assert ttr.stamp_hop("not-a-dict", "admit") is None

    def test_stamp_appends_with_extras(self):
        meta = {}
        ttr.ensure_trace_ctx(meta)
        rec = ttr.stamp_hop(meta, "dispatch", wid=1, attempt=0)
        assert rec["hop"] == "dispatch" and rec["wid"] == 1
        assert rec["pid"] > 0 and rec["t"] > 0
        assert ttr.get_trace_ctx(meta)["hops"] == [rec]

    @pytest.mark.parametrize("hops", [
        [("client_send", 1.000), ("admit", 1.001), ("dequeue", 1.003),
         ("dispatch", 1.004), ("worker_recv", 1.010),
         ("worker_done", 1.030), ("reply", 1.031)],
        [("client_send", 0.0), ("client_send", 0.050), ("admit", 0.051),
         ("dequeue", 0.052), ("dispatch", 0.053), ("reoffer", 0.080),
         ("dispatch", 0.081), ("worker_recv", 0.082),
         ("worker_done", 0.092), ("reply", 0.093)],
        [("client_send", 0.0), ("admit", 0.001), ("dispatch", 0.002, "hB"),
         ("reoffer", 0.050), ("dispatch", 0.051, "hA"),
         ("dispatch", 0.052, "hA"), ("worker_recv", 0.053),
         ("worker_done", 0.060), ("reply", 0.061)],
        [("admit", 0.0), ("reply", 0.5)],
    ], ids=["stages", "redelivery", "hosts", "partial"])
    def test_hop_spans_and_missing_hops_match_jax(self, hops):
        recs = [dict({"hop": h[0], "t": h[1]},
                     **({"host": h[2]} if len(h) > 2 else {}))
                for h in hops]
        assert ttr.hop_spans(recs) == jtr.hop_spans(recs)
        assert ttr.missing_hops(recs) == jtr.missing_hops(recs)
        assert ttr.trace_chain_complete(recs) == \
            jtr.trace_chain_complete(recs)

    def test_wire_codec_carries_nested_ctx(self):
        from nnstreamer_tpu_torch.edge.wire import (
            decode_buffer, encode_buffer)

        buf = TensorBuffer.of(np.ones((4,), np.float32), pts=7)
        ttr.ensure_trace_ctx(buf.meta)
        ttr.stamp_hop(buf.meta, "client_send", pts=7)
        out, _ = decode_buffer(encode_buffer(buf))
        ctx = ttr.get_trace_ctx(out.meta)
        assert ctx["id"] == ttr.get_trace_ctx(buf.meta)["id"]
        assert ctx["hops"][0]["hop"] == "client_send"

    def test_sheds_requests_and_tenants_match_jax(self):
        trs = (ttr.Tracer(max_events=4), jtr.Tracer(max_events=4))
        for tr in trs:                    # a tiny ring: force the wrap
            for i in range(10):
                tr.record_shed("query_server_5", "queue_full", float(i),
                               pts=i)
            tr.record_shed("query_server_5", "shutdown", 11.0)
            for i in range(6):
                hops = [{"hop": "admit", "t": 100.0 + i},
                        {"hop": "reply", "t": 100.0 + i + 0.002 * (i + 1)}]
                tr.record_request("query_server_5", f"id{i}", hops,
                                  100.0 + i + 0.002 * (i + 1),
                                  tenant="a" if i % 3 else "b")
        ours, theirs = trs
        assert ours.shed_counts() == theirs.shed_counts() == {
            "query_server_5": {"queue_full": 10, "shutdown": 1}}
        assert ours.summary()["sheds"] == ours.shed_counts()
        assert ours.summary()["requests"] == theirs.summary()["requests"] \
            == 6
        assert [r[:3] for r in ours.requests()] == \
            [r[:3] for r in theirs.requests()]
        assert ours.tenant_summary() == theirs.tenant_summary()


# -- worker shipping and the pool's merge (Queue 1 item 4c) ------------------

def _child_records(tr, Buffer, shift=0.0):
    """One worker's worth of records, fed alike to either package."""
    tr.enable_shipping()
    buf = Buffer.of(np.ones((2,), np.float32))
    buf.meta[tr_src_key(tr)] = 1.0
    for i in range(4):
        tr.record_process("echo", buf, 1.0 + i, 1.0 + i + 1e-3 * (i + 1))
    tr.record_forced_sync("sink", 2.0)
    tr.record_shed("query_server_0", "queue_full", 2.5)
    tr.enqueue("q", 3, 2.6)
    tr.record_worker_event("pool", 0, "spawn", 2.7, pid=11)
    tr.record_request("query_server_0", "abcd",
                      [{"hop": "admit", "t": 3.0},
                       {"hop": "reply", "t": 3.004}], 3.004, tenant="t")


def tr_src_key(tr):
    mod = ttr if isinstance(tr, ttr.Tracer) else jtr
    return mod.SOURCE_TS_META


def _summary_view(tr):
    s = tr.summary()
    return {k: v for k, v in s.items() if k != "interlatency"}, \
        {n: h["counts"] for n, h in tr.hists().items()}, \
        sorted(tr.interlatency())


@pytest.mark.parametrize("child,parent", [("port", "jax"), ("jax", "port")])
def test_ship_delta_crosses_packages(child, parent):
    """A payload one package's child tracer ships, the other package's
    parent ingests: the merged summary, histograms, children and events
    equal those of a parent of the child's own package, key by key; two
    ships carry deltas, never totals (the second payload holds only what
    came after the first)."""
    mods = {"port": (ttr, TensorBuffer), "jax": (jtr, JaxBuffer)}
    cmod, Buffer = mods[child]
    kid = cmod.Tracer()
    _child_records(kid, Buffer)
    first = kid.ship_delta()
    kid.record_process("echo", Buffer.of(np.ones((2,), np.float32)),
                       9.0, 9.5)
    second = kid.ship_delta()
    assert second["hists"]["echo"]["count"] == 1
    assert "worker_events" not in second and "requests" not in second
    assert kid.ship_delta() is None           # nothing new: no payload
    merged = {}
    for name, (pmod, _) in mods.items():
        par = pmod.Tracer()
        for payload in (first, second):
            par.ingest_child(0, 4242, payload, offset_s=0.5,
                             label="pool-w0")
        merged[name] = par
    ours, theirs = merged[parent], merged[child]
    assert _summary_view(ours) == _summary_view(theirs)
    assert ours.children() == theirs.children()
    assert ours.total_events == theirs.total_events
    assert ours.events_dropped == theirs.events_dropped
    assert ours.worker_events() == theirs.worker_events()
    assert [r[:3] for r in ours.requests()] == \
        [r[:3] for r in theirs.requests()]
    assert ours.summary()["children"]["0"]["label"] == "pool-w0"
    assert ours.summary()["workers"] == {"w0/pool": {"spawn": 1}}
    assert "w0/echo" in ours.hists() and \
        ours.hists()["w0/echo"]["count"] == 5
    # one process track group per worker in the Chrome export
    doc = ours.to_chrome_trace("pool")
    procs = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "process_name"}
    assert procs == {0: "pool", 1: "pool-w0 (pid 4242)"}
    assert any(e.get("pid") == 1 and e.get("ph") == "X"
               for e in doc["traceEvents"])


def test_child_ring_wrap_counts_exactly_as_jax():
    """A child whose ring wraps between ships reports its drops in the
    delta: the parent counts the 8 events it got and the 12 the child's
    ring lost, the same on both packages."""
    out = []
    for mod, Buffer in ((ttr, TensorBuffer), (jtr, JaxBuffer)):
        kid = mod.Tracer(max_events=8)
        kid.enable_shipping()
        buf = Buffer.of(np.ones((2,), np.float32))
        for i in range(20):
            kid.record_process("echo", buf, float(i), float(i) + 1e-3)
        par = mod.Tracer()
        par.ingest_child(1, 7, kid.ship_delta())
        out.append((par.total_events, par.events_dropped,
                    par.children()[1]["events_dropped"],
                    kid.events_dropped))
    assert out[0] == out[1] == (8, 12, 12, 12)


def test_child_launch_counts_ship_to_the_parent():
    """A pool child's tracer hears of every launch a kernel wrapper
    counts (`cuda_graphs.observe_launches`), one at a launch and n at
    each replay of a graph that captured n; it ships them as deltas
    beside the spans, a port parent merges them under ``w{wid}/``, and a
    JAX parent takes the same payload and merges the same summary."""
    from nnstreamer_tpu_torch.backends import cuda_graphs

    def normalize_u8():
        pass

    normalize_u8.launches = 0
    normalize_u8.launches_tc = 0
    kid = Tracer()
    kid.enable_shipping()
    cuda_graphs.observe_launches(kid.record_launches)
    try:
        cuda_graphs.count_launch(normalize_u8)
        cuda_graphs.count_launch(normalize_u8, "launches_tc")
        tally = cuda_graphs.Tally()
        tally.launches = {(normalize_u8, "launches"): 3,
                          (normalize_u8, "launches_tc"): 3}
        tally.add()
    finally:
        cuda_graphs.observe_launches(None)
    cuda_graphs.count_launch(normalize_u8)    # no observer: wrapper only
    assert normalize_u8.launches == 6 and normalize_u8.launches_tc == 4
    assert kid.kernel_launches() == {"normalize_u8": 5}
    kid.record_process("norm", TensorBuffer.of(np.ones((2,), np.float32)),
                       1.0, 1.5)
    first = kid.ship_delta()
    assert first["launches"] == {"normalize_u8": 5}
    kid.record_launches("normalize_u8", 2)
    second = kid.ship_delta()
    assert second == {"launches": {"normalize_u8": 2}}
    assert kid.ship_delta() is None
    port, jax_parent = Tracer(), jtr.Tracer()
    for par in (port, jax_parent):
        for payload in (first, second):
            par.ingest_child(3, 99, payload)
    assert port.kernel_launches() == {"w3/normalize_u8": 7}
    assert _summary_view(port) == _summary_view(jax_parent)
    assert NULL_TRACER.kernel_launches() == {}

"""The device performance plane and the flight recorder on the port
(nnstreamer_tpu_torch/runtime/devprof.py, runtime/flightrec.py, the
`flight` subcommand) against the JAX package's (tests/test_devprof.py).

The gates:

- the profiler's arithmetic (MFU against an injected peak, the CPU's
  calibrated MFU, the roofline verdict, the registry's overwrite/add
  rule) equals JAX's on the same notes, and `metrics_snapshot(devprof=)`
  renders the same text as JAX's for the same stats;
- the dispatch/sync choke point: a stamp closed by the next
  `device_sync` on the same thread, never by another thread's;
- the torch backend's first run registers the FLOPs FlopCounterMode
  counts: for MobileNetV2 (width 0.35, 64², f32) exactly the analytic
  count of its convolutions and dense layer (2 × multiply-adds), per
  frame, and K frames' worth for a window of K;
- the flight recorder: the JAX file's TestFlightRecorder and
  TestFlightCLI cases on the port's recorder, tracer and CLI.

No wall-clock assertion is copied.
"""

import json
import math
import os
import threading

import numpy as np
import pytest
import torch

from nnstreamer_tpu.runtime.devprof import DeviceProfiler as JaxProfiler
from nnstreamer_tpu.serving.metrics import (
    metrics_snapshot as j_snapshot, render_prometheus as j_render)
from nnstreamer_tpu_torch.runtime import devprof
from nnstreamer_tpu_torch.runtime.devprof import (
    DeviceProfiler, bucket_label, peak_for)
from nnstreamer_tpu_torch.runtime.flightrec import (
    FlightRecorder, list_bundles, load_bundle)
from nnstreamer_tpu_torch.runtime.sync import device_sync
from nnstreamer_tpu_torch.runtime.tracing import NULL_TRACER, Tracer
from nnstreamer_tpu_torch.serving.metrics import (
    metrics_snapshot, parse_prometheus, render_prometheus)

MBV2 = "mobilenet_v2?width=0.35&input_size=64&dtype=float32"


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    prof = devprof.get()
    prof.enable(False)
    prof.reset()


# -- the profiler's arithmetic, held to JAX's ---------------------------------------

def _notes(p):
    p.note_compile("f", "hot", seconds=0.1, flops=2e12, bytes_accessed=1e9)
    p.note_compile("f", "cold", seconds=0.1, flops=1e9, bytes_accessed=1e9)
    p.note_compile("f", "hot", seconds=0.5, flops=3e12)
    for _ in range(5):
        p.note_invoke("f", "hot", 0.040)
        p.note_invoke("f", "cold", 0.010)
    return p


def _rows(st):
    return st["jit"], [{k: v for k, v in r.items() if k != "device"}
                       for r in st["invoke"]]


@pytest.mark.parametrize("peak,bw", [(100.0, 1000.0), (0.0, 0.0)])
def test_registry_mfu_roofline_equal_jax(peak, bw):
    ours = _notes(DeviceProfiler(peak_tflops=peak, peak_hbm_gbps=bw)
                  .enable()).stats()
    theirs = _notes(JaxProfiler(peak_tflops=peak, peak_hbm_gbps=bw)
                    .enable()).stats()
    assert _rows(ours) == _rows(theirs)
    for k in ("peak_tflops", "peak_hbm_gbps", "calibration_tflops",
              "compile_seconds_total", "compiles_total"):
        assert ours[k] == theirs[k], k


def test_disabled_profiler_records_nothing():
    p = DeviceProfiler()
    p.note_compile("f", "b", seconds=1.0, flops=10.0)
    p.note_dispatch("f", "b")
    p.note_launched()
    p.sample_sync()
    p.note_invoke("f", "b", 0.5)
    st = p.stats()
    assert st["enabled"] is False
    assert st["jit"] == [] and st["invoke"] == []


def test_peak_table_is_nvidia_only_by_prefix():
    assert peak_for("NVIDIA H100 80GB HBM3") == (989.0, 3350.0)
    assert peak_for("NVIDIA H100 PCIe")[0] == 756.0
    assert peak_for("NVIDIA H100 80GB HBM3 MIG 1g.10gb")[0] == 989.0
    assert peak_for("TPU v5 lite") == (0.0, 0.0)
    assert peak_for("cpu") == (0.0, 0.0)
    assert peak_for("") == (0.0, 0.0)
    st = DeviceProfiler().enable().stats()
    assert st["platform"] == "cpu" and st["peak_tflops"] == 0.0
    assert "lower bound" in st["bytes_kind"]


def test_bucket_label_forms_as_jax():
    from nnstreamer_tpu.runtime.devprof import bucket_label as j_label

    for key in ((), ("fix", ((1, 224, 224, 3), "uint8"), "x"),
                ("dynb", 8, "y"), ("win",)):
        assert bucket_label(key) == j_label(key)


def test_dispatch_sample_closed_by_device_sync():
    prof = devprof.get()
    prof.reset()
    prof.enable(True)
    x = torch.ones(4)
    prof.note_dispatch("filt", "b")
    prof.note_launched()
    device_sync((x,), forced=True)
    (row,) = prof.stats()["invoke"]
    assert (row["filter"], row["bucket"]) == ("filt", "b")
    assert row["samples_total"] == 1
    device_sync((x,), forced=True)            # no stamp left: no sample
    assert prof.stats()["invoke"][0]["samples_total"] == 1


def test_sample_is_per_thread():
    p = DeviceProfiler().enable()
    p.note_dispatch("f", "b")
    closed = []

    def other():
        p.sample_sync()                       # no stamp on THIS thread
        closed.append(p.stats()["invoke"])

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert closed == [[]]
    p.sample_sync()
    assert p.stats()["invoke"][0]["samples_total"] == 1


def test_capture_cost_counts_flops_and_bytes():
    p = DeviceProfiler().enable()
    a = torch.ones(8, 16)
    b = torch.ones(16, 4)
    out = p.capture_cost("f", "mm", lambda: a @ b, inputs=(a, b))
    assert out.shape == (8, 4)
    (row,) = p.stats()["jit"]
    assert row["flops"] == 2 * 8 * 16 * 4
    assert row["bytes_accessed"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)


def test_model_attribution_rows_and_weakref_release():
    class Backend:
        def resident_bytes(self):
            return 1234

    p = DeviceProfiler().enable()
    be = Backend()
    p.attach_model("m", be)
    rows = [r for r in p.hbm_rows() if r["kind"] == "model:m"]
    assert rows and rows[0]["bytes"] == 1234.0
    del be
    assert not [r for r in p.hbm_rows() if r["kind"] == "model:m"]


def test_counter_tracks_reach_the_tracer():
    p = DeviceProfiler(peak_tflops=100.0).enable()
    p.note_compile("f", "b", seconds=0.1, flops=1e12)
    p.note_invoke("f", "b", 0.1)
    assert "mfu:f/b" in [n for n, _ in p.counter_tracks()]
    tr = Tracer()
    assert p.emit_counters(tr) >= 1
    evs = tr.to_chrome_trace("t")["traceEvents"]
    dev = [e for e in evs if e.get("ph") == "C" and e.get("cat") == "devprof"]
    assert dev and dev[0]["name"] == "mfu:f/b"
    assert dev[0]["args"] == {"value": pytest.approx(0.1)}


# -- exposition, held to JAX's text ------------------------------------------------

FAMILIES = ("nns_jit_flops", "nns_jit_bytes_accessed", "nns_jit_roofline_info",
            "nns_compile_seconds_total", "nns_compiles_total",
            "nns_invoke_mfu", "nns_invoke_mfu_calibrated",
            "nns_invoke_tflops", "nns_invoke_seconds_total",
            "nns_invoke_samples_total", "nns_device_hbm_bytes",
            "nns_device_hbm_headroom", "nns_device_peak_tflops",
            "nns_device_calibration_tflops")


def _plane():
    p = DeviceProfiler(peak_tflops=100.0, peak_hbm_gbps=1000.0).enable()
    p.note_compile('we"ird\\f', "b:1", seconds=0.5, flops=2e12,
                   bytes_accessed=1e9)
    for _ in range(3):
        p.note_invoke('we"ird\\f', "b:1", 0.040)
    return p


def test_metrics_text_equals_jax_for_the_same_stats():
    st = _plane().stats()
    st["hbm"] = [{"device": "cuda:0", "kind": "bytes_in_use", "bytes": 5e9},
                 {"device": "cuda:0", "kind": "bytes_limit", "bytes": 8e10}]
    st["headroom"] = [{"device": "cuda:0", "frac": 0.0625}]
    ours = render_prometheus(metrics_snapshot(devprof=st))
    assert ours == j_render(j_snapshot(devprof=st))
    parsed = parse_prometheus(ours)
    for fam in FAMILIES:
        assert fam in parsed and parsed[fam].get("help"), fam
    assert parsed["nns_invoke_seconds_total"]["type"] == "counter"


def test_counters_monotone_across_scrapes():
    p = _plane()
    s1 = parse_prometheus(render_prometheus(
        metrics_snapshot(devprof=p.stats())))
    p.note_invoke('we"ird\\f', "b:1", 0.040)
    p.note_compile('we"ird\\f', "b:1", seconds=0.1, flops=2e12)
    s2 = parse_prometheus(render_prometheus(
        metrics_snapshot(devprof=p.stats())))
    for fam in ("nns_compile_seconds_total", "nns_compiles_total",
                "nns_invoke_seconds_total", "nns_invoke_samples_total"):
        for k, v1 in s1[fam]["samples"].items():
            assert s2[fam]["samples"][k] >= v1, fam


# -- the torch backend's hooks -------------------------------------------------------

def mbv2_flops(model, size: int, batch: int = 1) -> int:
    """2 × the multiply-adds of MobileNetV2's convolutions and dense
    layer at `size`², from the module's weight shapes: a SAME conv of
    stride s maps H to ceil(H / s)."""
    flops = 0
    h = size

    def conv(unit, h):
        cout, cin_g, kh, kw = unit.weight.shape
        ho = math.ceil(h / unit.stride)
        return 2 * batch * cout * cin_g * kh * kw * ho * ho, ho

    f, h = conv(model.stem, h)
    flops += f
    for block in model.blocks:
        for unit in (block.expand, block.depthwise, block.project):
            if unit is not None:
                f, h = conv(unit, h)
                flops += f
    f, h = conv(model.head, h)
    flops += f
    cout, cin = model.classifier.weight.shape
    return flops + 2 * batch * cout * cin


def test_backend_first_run_flops_equal_the_analytic_count():
    from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend

    prof = devprof.get()
    prof.reset()
    prof.enable(True)
    be = TorchBackend()
    be.open({"model": "zoo://" + MBV2})
    x = np.zeros((1, 64, 64, 3), np.float32)
    for _ in range(3):
        device_sync(be.invoke((x,)), forced=True)
    outs = be.invoke_window([(x,)] * 4)
    device_sync([o[0] for o in outs], forced=True)
    st = prof.stats()
    want = mbv2_flops(be._params, 64)
    rows = {r["bucket"]: r for r in st["jit"]}
    assert rows["static"]["flops"] == want
    assert rows["static"]["compiles"] == 1          # one first run
    assert rows["win:4"]["flops"] == 4 * want
    params = sum(t.numel() * 4 for t in be._params.state_dict().values())
    assert rows["static"]["bytes_accessed"] == params + x.nbytes + 1001 * 4
    (inv,) = [r for r in st["invoke"] if r["bucket"] == "static"]
    assert inv["samples_total"] == 2                  # the later invokes
    assert inv["mfu"] == 0.0 and inv["achieved_tflops"] > 0
    assert any(r["kind"].startswith("model:") for r in st["hbm"])
    assert be.compile_count == 2                      # static + win:4
    be.close()


def test_profiler_off_is_the_default_and_costs_no_state():
    from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend

    prof = devprof.get()
    prof.reset()
    assert prof.enabled is False
    be = TorchBackend()
    be.open({"model": lambda x: (x * 2.0,)})
    be.invoke((np.ones((2,), np.float32),))
    assert prof.stats()["jit"] == [] and prof.stats()["invoke"] == []
    be.close()


# -- the flight recorder ---------------------------------------------------------------

def _rec(tmp_path, **kw):
    clock = [0.0]
    rec = FlightRecorder(str(tmp_path), cooldown_s=60.0,
                         clock=lambda: clock[0], **kw)
    return rec, clock


def test_steady_state_produces_no_bundle(tmp_path):
    rec, _ = _rec(tmp_path)
    ok = {"offered": 10, "replied": 7, "rejected": {"b": 1},
          "shed": {}, "depth": 1, "inflight": 1}
    for _ in range(5):
        assert rec.scan(admission=ok, p99_ms=50.0, p99_budget_ms=100.0) == []
    assert list_bundles(str(tmp_path)) == []
    assert rec.stats()["dumps_total"] == 0


def test_slo_breach_one_bundle_per_cooldown_window(tmp_path):
    rec, clock = _rec(tmp_path)
    p1 = rec.note_slo_breach(120.0, 100.0)
    assert p1 and os.path.isdir(p1)
    assert rec.note_slo_breach(130.0, 100.0) is None
    assert len(list_bundles(str(tmp_path))) == 1
    clock[0] += 61.0
    assert rec.note_slo_breach(140.0, 100.0) is not None
    assert len(list_bundles(str(tmp_path))) == 2
    st = rec.stats()
    assert st["dumps"]["slo_breach"] == 2
    assert st["suppressed"]["slo_breach"] == 1


def test_conservation_needs_two_consecutive_scans(tmp_path):
    rec, _ = _rec(tmp_path)
    bad = {"offered": 10, "replied": 5, "rejected": {}, "shed": {},
           "depth": 1, "inflight": 1}
    ok = dict(bad, replied=8)
    assert rec.scan(admission=bad) == []
    assert rec.scan(admission=ok) == []
    assert rec.scan(admission=bad) == []
    assert rec.scan(admission=bad) == ["conservation"]
    b = list_bundles(str(tmp_path))
    assert [x["kind"] for x in b] == ["conservation"]
    assert b[0]["cause"]["consecutive_scans"] == 2


def test_watermarked_triggers_baseline_first_observation(tmp_path):
    rec, _ = _rec(tmp_path)
    assert rec.scan(worker_counts={"pool": {"kill": 3}}) == []
    assert rec.scan(worker_counts={"pool": {"kill": 4}}) == ["worker_fence"]
    assert rec.scan(kernel_fallbacks=2.0) == []
    assert rec.scan(kernel_fallbacks=3.0) == ["kernel_fallback"]


def test_bundle_is_complete_and_atomic(tmp_path):
    rec, _ = _rec(tmp_path)
    tr = Tracer()
    tr.record_process("el", None, 0.0, 0.01)
    rec.attach(tracer=tr, prom=lambda: "# scrape\n", env=lambda: {"k": "v"})
    rec.tick({"gauge": 1})
    path = rec.trigger("manual", {"why": "test"})
    assert not [n for n in os.listdir(str(tmp_path)) if n.startswith(".")]
    b = load_bundle(path)
    assert b["cause"]["kind"] == "manual"
    assert b["cause"]["cause"] == {"why": "test"}
    assert b["env"] == {"k": "v"}
    assert b["metrics.prom"] == "# scrape\n"
    assert b["snapshots"][0]["snapshot"] == {"gauge": 1}
    assert any(ev.get("ph") for ev in b["trace"]["traceEvents"])
    assert [k for k, _, _ in tr.flight_dumps()] == ["manual"]


def test_failed_dump_does_not_eat_the_cooldown(tmp_path, monkeypatch):
    rec, _ = _rec(tmp_path)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(rec, "_dump", boom)
    with pytest.raises(RuntimeError):
        rec.trigger("manual", {})
    monkeypatch.undo()
    assert rec.trigger("manual", {}) is not None


def test_list_bundles_ignores_dot_and_foreign_entries(tmp_path):
    rec, _ = _rec(tmp_path)
    rec.trigger("manual", {})
    os.makedirs(str(tmp_path / ".tmp-flight-9999-manual-1"))
    os.makedirs(str(tmp_path / "not-a-bundle"))
    (tmp_path / "flight-0002-file").write_text("not a dir")
    assert [b["name"] for b in list_bundles(str(tmp_path))] == \
        ["flight-0001-manual"]


def test_autotuner_feeds_slo_breaches(tmp_path):
    from nnstreamer_tpu_torch.serving.autotune import AutoTuner, SLOSpec

    class P99Tracer:
        active = True

        def tenant_summary(self):
            return {"t0": {"p99_ms": 250.0}}

    rec, _ = _rec(tmp_path)
    tuner = AutoTuner(SLOSpec(p99_budget_ms=100.0), tracer=P99Tracer())
    rec.attach(autotune=tuner)
    assert tuner.flight is rec
    tuner.tick()
    b = list_bundles(str(tmp_path))
    assert [x["kind"] for x in b] == ["slo_breach"]
    assert b[0]["cause"]["p99_ms"] == 250.0
    tuner.tick()
    assert len(list_bundles(str(tmp_path))) == 1


def test_poll_reads_attached_tracer_counters(tmp_path):
    rec, _ = _rec(tmp_path)
    tr = Tracer()
    rec.attach(tracer=tr)
    tr.record_worker_event("pool", 0, "kill", 0.0)
    tr.record_watchdog("el", "stall", 0.0)
    assert rec.poll() == []
    tr.record_worker_event("pool", 1, "fence", 1.0)
    assert "worker_fence" in rec.poll()
    tr.record_watchdog("el", "stall", 2.0)
    assert "watchdog" in rec.poll()
    tr.record_worker_event("pool", 2, "spawn", 3.0)
    assert rec.poll() == []


def test_run_background_polls_and_closes(tmp_path):
    rec, _ = _rec(tmp_path)
    seen = threading.Event()

    def signals():
        seen.set()
        return {}

    rec.run_background(signals, interval_s=0.01)
    assert seen.wait(10)
    rec.close()
    assert rec.stats()["snapshots"] >= 1


def test_null_tracer_twins_noop():
    NULL_TRACER.record_flight("manual", 0.0, path="/x")
    NULL_TRACER.record_device_counter("mfu:f/b", 0.5, 0.0)
    assert NULL_TRACER.flight_dumps() == []


def test_flight_cli_list_and_inspect(tmp_path, capsys):
    from nnstreamer_tpu_torch.__main__ import main

    rec = FlightRecorder(str(tmp_path))
    rec.trigger("manual", {"why": "cli"})
    assert main(["flight", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "flight-0001-manual" in out and "manual" in out
    assert main(["flight", str(tmp_path), "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert rows[0]["kind"] == "manual"
    assert main(["flight", str(tmp_path),
                 "--inspect", "flight-0001-manual"]) == 0
    b = json.loads(capsys.readouterr().out)
    assert b["cause"]["cause"] == {"why": "cli"}


def test_flight_cli_empty_dir_exits_nonzero(tmp_path):
    from nnstreamer_tpu_torch.__main__ import main

    assert main(["flight", str(tmp_path)]) == 1


# -- the LLM executor under the profiler (fault F8) ---------------------------------

_LLM_PROMPTS = [np.random.default_rng(5).integers(0, 61, n).astype(np.int32)
                for n in (3, 9, 5)]


@pytest.fixture(scope="module")
def llm_params():
    """(JAX transformer params, the port's bridged copy): tests/test_llm.py's
    geometry (vocab 61, d 32, 2 layers, 4 heads, 2 kv heads)."""
    import jax

    from nnstreamer_tpu.models import transformer as jt
    from nnstreamer_tpu_torch.models import bridge

    jp = jt.init_params(vocab=61, d_model=32, n_layers=2, n_heads=4,
                        n_kv_heads=2, seed=0)
    return jp, bridge.transformer_params(
        jax.tree_util.tree_map(np.asarray, jp))


def _profiled_engine(engine_cls, prof, params, **kw):
    """Serve _LLM_PROMPTS through `engine_cls` (prewarmed) under `prof`,
    counting each note_dispatch by (filter, bucket) → (dispatch counts,
    stats(), tokens, engine)."""
    from collections import Counter

    calls = Counter()
    note = prof.note_dispatch

    def spy(filt, bucket, *a, **k):
        calls[(filt, bucket)] += 1
        return note(filt, bucket, *a, **k)

    prof.reset()
    prof.enable(True)
    prof.note_dispatch = spy
    try:
        eng = engine_cls(params, n_heads=4, block_size=4, num_blocks=32,
                         max_batch=4, max_len=64, **kw)
        eng.prewarm(16)
        reqs = [eng.submit(p, max_new_tokens=6) for p in _LLM_PROMPTS]
        eng.drain()
        st = prof.stats()
    finally:
        del prof.note_dispatch
        prof.enable(False)
    return calls, st, [list(r.tokens) for r in reqs], eng


@pytest.mark.parametrize("kw", [
    {"paged_kernel": "xla"},
    {"paged_kernel": "pallas", "prefill_chunk": 4, "decode_window": 4},
    {"paged_kernel": "xla", "decode_window": 4},
], ids=["xla", "pallas-chunked-window", "xla-window"])
def test_llm_executor_profiler_rows_equal_jax(llm_params, kw):
    """The port's PagedLLMExecutor reports to the profiler as JAX's does:
    on the same prompts and params (prewarmed, the same engine schedule),
    the same dispatch counts under the same bucket names (prefill:N,
    chunk:N, decode:N, decmulti:BxK, the warm runs under the bucket they
    warm), one first-run (jit) row per bucket JAX compiles, and a
    model:llm row of params + KV pool bytes equal to JAX's. The port
    samples every dispatch (its stamps queue per thread until the next
    device_sync); JAX keeps one stamp a thread, so a step's batched
    prefills leave it one sample — its counts are at most the port's."""
    from nnstreamer_tpu.llm import LLMEngine as JaxEngine
    from nnstreamer_tpu.runtime import devprof as jdevprof
    from nnstreamer_tpu_torch.llm import LLMEngine

    jp, tp = llm_params
    jcalls, jst, jtok, _ = _profiled_engine(JaxEngine, jdevprof.get(),
                                            dict(jp), **kw)
    calls, st, tok, eng = _profiled_engine(LLMEngine, devprof.get(), tp,
                                           **kw)
    assert tok == jtok
    assert calls == jcalls and set(calls) == {
        ("llm", r["bucket"]) for r in st["invoke"]}
    samples = {r["bucket"]: r["samples_total"] for r in st["invoke"]}
    assert samples == {b: n for (_, b), n in calls.items()}
    for r in jst["invoke"]:
        assert 0 < r["samples_total"] <= samples[r["bucket"]]
    assert [(r["filter"], r["bucket"], r["compiles"]) for r in st["jit"]] \
        == [(r["filter"], r["bucket"], r["compiles"]) for r in jst["jit"]]
    ex = eng.executor
    want = devprof.tensor_bytes(ex.params, ex.cache.k, ex.cache.v)
    assert st["hbm"] == jst["hbm"] == [
        {"device": "-", "kind": "model:llm", "bytes": float(want)}]


def test_tensor_llm_reports_every_dispatch(llm_params):
    """appsrc ! tensor_llm ! tensor_sink with the profiler on: a
    model:<element> row of the placed params plus the pool's k and v, an
    invoke row for every bucket the executor ran (warm runs included)
    with one sample per dispatch, and a first-run row for every bucket but
    the decode windows'."""
    from nnstreamer_tpu_torch import Pipeline, PipelineRunner
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.elements import AppSrc, TensorLLM, TensorSink
    from nnstreamer_tpu_torch.serving.store import get_store, reset_store
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
    from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec

    reset_store()
    get_store().register("llm_prof_t", ModelBundle(fn=None,
                                                   params=llm_params[1]))
    src = AppSrc(name="src", spec=TensorsSpec(tensors=(),
                                              format=TensorFormat.FLEXIBLE))
    llm = TensorLLM(name="gen", model="store://llm_prof_t", block_size=4,
                    num_blocks=32, max_batch=4, max_len=64, n_heads=4,
                    paged_kernel="pallas", prefill_chunk=4, prewarm=16)
    sink = TensorSink(name="sink")
    pipe = Pipeline()
    for e in (src, llm, sink):
        pipe.add(e)
    pipe.link(src, llm)
    pipe.link(llm, sink)
    prof = devprof.get()
    prof.reset()
    prof.enable(True)
    runner = PipelineRunner(pipe).start()
    try:
        for i, p in enumerate(_LLM_PROMPTS):
            src.push(TensorBuffer(tensors=(p,), pts=i, meta={"llm": {
                "request_id": f"r{i}", "max_new_tokens": 4}}))
        src.end()
        runner.wait(60)
        st = prof.stats()
        ex = llm.engine.executor
        want = devprof.tensor_bytes(ex.params, ex.cache.k, ex.cache.v)
        ran = {f"{k[0]}:{k[1]}x{k[2]}" if k[0] == "decmulti"
               else f"{k[0]}:{k[1]}" for k in ex._seen}
        dispatches = (ex.prefills + ex.chunk_prefills + ex.decode_steps
                      - ex.window_steps + ex.decode_windows
                      + llm.warm_compiles)
    finally:
        runner.stop()
        prof.enable(False)
        reset_store()
    assert len([b for b in sink.results]) > 0
    assert st["hbm"] == [{"device": "-", "kind": "model:gen",
                          "bytes": float(want)}]
    assert {r["bucket"] for r in st["invoke"]} == ran
    assert all(r["filter"] == "gen" for r in st["invoke"] + st["jit"])
    assert sum(r["samples_total"] for r in st["invoke"]) == dispatches
    assert {r["bucket"] for r in st["jit"]} == {
        b for b in ran if not b.startswith("decmulti")}

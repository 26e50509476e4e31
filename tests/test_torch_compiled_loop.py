"""The compiled steady-state loop and the LLM decode window on the port
(nnstreamer_tpu_torch: runtime/compiled_loop.py, the scheduler's window
path, tensor_filter's process_window, the torch backend's invoke_window,
the executor's decode_multi) against the JAX package's, on the CPU.

- Units: signatures, the detector and the ledger give JAX's outputs on
  the same sequences.
- The bail matrix (steady state, shape change, an error that lands on
  its frame, a window-only error, swap, timer, EOS drain, the pow2
  leftover) runs one deterministic window-capable element through each
  package's PipelineRunner; the sink order, the element's ("pf"/"win",
  pts) call log and the loop fields of stats() must equal JAX's. Each
  trace is pushed whole (with EOS) before the runner starts and the
  first process() sleeps, so the source has queued every frame when the
  first window is collected — a sleep that fills the queue, no
  wall-clock assertion.
- window_capable() gives JAX's verdict for each exclusion the port has.
- process_window on MobileNetV2 (width 0.35, input 32, f32, JAX's
  weights through models/bridge.py) is bit for bit the port's per-frame
  process, and within test_torch_mobilenet.py's 1e-4 * max|logit| of
  JAX's process_window.
- Decode-window tokens (mixed budgets; EOS mid-window) equal the port's
  per-step tokens and the JAX engine's with decode_window=8, on the
  torch reference (paged_kernel=xla) and on the kernels' plain versions
  (pallas).
- The tracer's compiled_windows()/loop_bails() and report()'s section
  equal JAX's.
- The CUDA-graph bookkeeping (backends/cuda_graphs.py) with a stand-in
  graph: a captured launch counts at each replay and never at capture,
  and what the capture was told to hold stays held; the torch backend's
  graphs belong to the model they captured, also when a reload from
  another thread lands mid-capture, and a failed capture is remembered
  until the model changes.
"""

import contextlib
import logging
import threading
import time

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.xla import ModelBundle as JModelBundle
from nnstreamer_tpu.elements import TensorFilter as JFilter
from nnstreamer_tpu.elements.sinks import TensorSink as JSink
from nnstreamer_tpu.elements.sources import AppSrc as JAppSrc
from nnstreamer_tpu.graph.pipeline import Element as JElement
from nnstreamer_tpu.llm.engine import LLMEngine as JLLMEngine
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.models import transformer as jt
from nnstreamer_tpu.runtime import compiled_loop as jcl
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
from nnstreamer_tpu.tensor.dtypes import DType as JDType
from nnstreamer_tpu.tensor.info import TensorFormat as JFormat
from nnstreamer_tpu.tensor.info import TensorInfo as JInfo
from nnstreamer_tpu.tensor.info import TensorsSpec as JSpec
from nnstreamer_tpu_torch.backends import cuda_graphs, kernels, torch_backend
from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.elements import TensorFilter as TFilter
from nnstreamer_tpu_torch.elements.sinks import TensorSink as TSink
from nnstreamer_tpu_torch.elements.sources import AppSrc as TAppSrc
from nnstreamer_tpu_torch.graph.pipeline import Element as TElement
from nnstreamer_tpu_torch.llm import LLMEngine as TLLMEngine
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.runtime import compiled_loop as tcl
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer as TBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType as TDType
from nnstreamer_tpu_torch.tensor.info import TensorFormat as TFormat
from nnstreamer_tpu_torch.tensor.info import TensorInfo as TInfo
from nnstreamer_tpu_torch.tensor.info import TensorsSpec as TSpec

#: the whole-model tolerance of test_torch_mobilenet.py: the frameworks'
#: conv kernels sum in different orders
MODEL_REL = 1e-4
#: the first process() call's sleep, long enough for the source pump to
#: queue a whole trace behind it
HEAD_START_S = 0.1


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


#: per package: Element, TensorBuffer, AppSrc, TensorSink, TensorsSpec,
#: TensorInfo, DType, the package
PKGS = {
    "jax": (JElement, JBuffer, JAppSrc, JSink, JSpec, JInfo, JDType, jnns),
    "torch": (TElement, TBuffer, TAppSrc, TSink, TSpec, TInfo, TDType, tnns),
}


# -- units ----------------------------------------------------------------

def _sig_bufs(Buffer):
    x = np.ones((4, 2), np.float32)
    bufs = [Buffer.of(x), Buffer.of(np.zeros((4, 2), np.float32)),
            Buffer.of(np.ones((4, 3), np.float32)),
            Buffer.of(np.ones((4, 2), np.int32))]
    for n in (3, 2):
        b = Buffer.of(x)
        b.meta["dyn_batch"] = {"n": n}
        bufs.append(b)
    return bufs


def test_frame_signature_matches_jax():
    j = [jcl.frame_signature(b) for b in _sig_bufs(JBuffer)]
    t = [tcl.frame_signature(b) for b in _sig_bufs(TBuffer)]
    assert t == j
    assert tcl.frame_signature(object()) is None is \
        jcl.frame_signature(object())


def test_frame_signature_of_torch_tensors_reads_no_data():
    """A torch frame's identity is its shape and dtype, as a numpy
    frame's; the data is never read (on the card that would sync)."""
    a = TBuffer.of(torch.ones(2, 3))
    b = TBuffer.of(torch.zeros(2, 3))
    c = TBuffer.of(torch.ones(2, 3, dtype=torch.float16))
    d = TBuffer.of(torch.ones(3, 2))
    assert tcl.frame_signature(a) == tcl.frame_signature(b)
    assert tcl.frame_signature(a) != tcl.frame_signature(c)
    assert tcl.frame_signature(a) != tcl.frame_signature(d)
    meta = TBuffer.of(torch.empty(2, 3, device="meta"))
    assert tcl.frame_signature(meta) == tcl.frame_signature(a)


@pytest.mark.parametrize("arm", [1, 3])
def test_detector_matches_jax(arm):
    a, b = (((2, 3), "float32"),), (((2, 4), "float32"),)
    seq = [a, a, a, b, b, None, b, b, b, a]
    outs = {}
    for name, mod in (("jax", jcl), ("torch", tcl)):
        det = mod.SteadyStateDetector(arm_after=arm)
        outs[name] = [(det.observe(s), det.armed, det.signature)
                      for s in seq]
        det.reset()
        outs[name].append((det.armed, det.signature))
    assert outs["torch"] == outs["jax"]
    assert tcl.BAIL_CAUSES == jcl.BAIL_CAUSES


def test_loop_stats_match_jax():
    snaps = []
    for mod in (jcl, tcl):
        ls = mod.LoopStats()
        ls.entries += 2
        ls.steps += 9
        for c in ("eos", "shape", "shape", "swap"):
            ls.bail(c)
        snaps.append(ls.snapshot())
    assert snaps[1] == snaps[0]


# -- the bail matrix -------------------------------------------------------

def _doubler(pkg, flaky=False):
    """A deterministic window-capable element (y = 2x) with injectable
    bail triggers, on `pkg`'s Element — the surface the scheduler probes
    on tensor_filter (window_capable / swap_pending / process_window)."""
    Element, Buffer = PKGS[pkg][:2]

    class Doubler(Element):
        ELEMENT_NAME = "test_doubler"
        CHAIN_FUSABLE = False      # a real worker thread and channel

        def __init__(self, name=None, *, sleep_s=HEAD_START_S, fail_pts=(),
                     swap_bails=0, timer_after=None, **props):
            super().__init__(name, **props)
            self.calls = []                   # ("pf", pts) | ("win", [pts])
            self._sleep = sleep_s
            self._fail_pts = set(fail_pts)
            self._swap_bails = swap_bails
            self._timer_after = timer_after
            self._done = 0
            self._boomed = not flaky

        def negotiate(self, in_specs):
            return [in_specs[0]]

        def window_capable(self):
            return True

        def swap_pending(self):
            if self._swap_bails > 0:
                self._swap_bails -= 1
                return True
            return False

        def next_deadline(self):
            if self._timer_after is not None and \
                    self._done >= self._timer_after:
                return time.perf_counter() + 60.0
            return None

        def _one(self, buf):
            return Buffer.of(np.asarray(buf.tensors[0]) * 2, pts=buf.pts)

        def process(self, pad, buf):
            self.calls.append(("pf", buf.pts))
            if buf.pts in self._fail_pts:
                raise RuntimeError(f"boom at pts {buf.pts}")
            if self._sleep:
                time.sleep(self._sleep)
                self._sleep = 0.0             # only the head-start frame
            self._done += 1
            return [(0, self._one(buf))]

        def process_window(self, pad, bufs):
            pts = [b.pts for b in bufs]
            self.calls.append(("win", pts))
            if not self._boomed:
                self._boomed = True
                raise RuntimeError("transient window fault")
            if self._fail_pts.intersection(pts):
                raise RuntimeError(f"window boom at {pts}")
            self._done += len(bufs)
            return [(0, self._one(b)) for b in bufs]

    return Doubler


def _frames(n, shape=(4, 2), dtype=np.float32, base=0):
    return [np.full(shape, base + i, dtype) for i in range(n)]


def _run_doubler(pkg, frames, *, compiled=True, arm=2, window=4,
                 expect_fail=False, trace=False, flaky=False, cls=None,
                 **kw):
    """Push `frames` (pts = index) and EOS, run to EOS → (sink results,
    element, stats row, runner). `cls` replaces the Doubler class."""
    _, Buffer, AppSrc, Sink, Spec, Info, DType, pkgmod = PKGS[pkg]
    pipe = pkgmod.Pipeline(f"cl_{pkg}")
    spec = Spec.of(Info(frames[0].shape, DType.from_name(frames[0].dtype.name)))
    src = AppSrc(spec=spec, name="src")
    dbl = (cls or _doubler(pkg, flaky))(name="d", **kw)
    sink = Sink(name="out")
    for e in (src, dbl, sink):
        pipe.add(e)
    pipe.link(src, dbl)
    pipe.link(dbl, sink)
    for i, x in enumerate(frames):
        src.push(Buffer.of(x, pts=i))
    src.end()                             # the whole trace queued first
    runner_kw = {} if compiled is None else {"compiled_loop": compiled}
    if pkg == "jax":
        runner_kw["device_segments"] = False
    r = pkgmod.PipelineRunner(pipe, compiled_loop_arm=arm,
                              compiled_loop_window=window, trace=trace,
                              queue_capacity=max(16, len(frames) + 2),
                              **runner_kw)
    r.start()
    if expect_fail:
        with pytest.raises(pkgmod.StreamError):
            r.wait(60)
    else:
        r.wait(60)
    return sink.results, dbl, r.stats().get("d", {}), r


LOOP_KEYS = ("loop_entries", "compiled_steps", "loop_bails")

#: name → (frames, run keywords), the JAX package's bail matrix
SCENARIOS = {
    "steady": (_frames(10), dict(arm=2, window=4)),
    "shape_change": (_frames(5) + _frames(1, shape=(3, 3), base=50)
                     + _frames(4, base=100), dict(arm=2, window=8)),
    "error_lands_on_frame": (_frames(10), dict(arm=2, window=4,
                                               fail_pts={3},
                                               expect_fail=True)),
    "window_only_error": (_frames(10), dict(arm=2, window=4, flaky=True)),
    "swap": (_frames(10), dict(arm=2, window=4, swap_bails=1)),
    "timer": (_frames(10), dict(arm=2, window=4, timer_after=3)),
    "eos_drain": (_frames(4), dict(arm=2, window=8)),
    "pow2_leftover": (_frames(8), dict(arm=2, window=8)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_bail_matrix_matches_jax(name):
    frames, kw = SCENARIOS[name]
    runs = {pkg: _run_doubler(pkg, frames, **kw) for pkg in ("jax", "torch")}
    (jres, jd, jst, _), (tres, td, tst, _) = runs["jax"], runs["torch"]
    assert td.calls == jd.calls
    assert {k: tst.get(k) for k in LOOP_KEYS} == \
        {k: jst.get(k) for k in LOOP_KEYS}
    if kw.get("expect_fail"):
        # delivery during the failure's teardown is best effort: an
        # in-order prefix of the frames before the faulting one
        assert [b.pts for b in tres] == list(range(len(tres)))
        assert len(tres) <= 3
        return
    assert [b.pts for b in tres] == [b.pts for b in jres] == \
        list(range(len(frames)))
    for b in tres:
        np.testing.assert_array_equal(np.asarray(b.tensors[0]),
                                      frames[b.pts] * 2)


def test_steady_state_trace_is_exact():
    """The JAX package's exact trace for 10 frames, arm 2, window 4."""
    _, d, st, _ = _run_doubler("torch", _frames(10), arm=2, window=4)
    assert d.calls == [("pf", 0), ("win", [1, 2, 3, 4]),
                       ("win", [5, 6, 7, 8]), ("pf", 9)]
    assert (st["loop_entries"], st["compiled_steps"], st["loop_bails"]) == \
        (2, 8, {"eos": 1})
    assert st["buffers"] == 10        # a window records K buffers


def test_loop_on_bit_for_bit_loop_off():
    frames = _frames(12)
    on, _, st_on, _ = _run_doubler("torch", frames, compiled=True)
    off, _, st_off, _ = _run_doubler("torch", frames, compiled=False)
    assert st_on["compiled_steps"] > 0
    assert "loop_entries" not in st_off       # the loop was never built
    assert [b.pts for b in on] == [b.pts for b in off]
    for a, b in zip(on, off):
        np.testing.assert_array_equal(np.asarray(a.tensors[0]),
                                      np.asarray(b.tensors[0]))


def test_runtime_config_turns_the_loop_off(monkeypatch):
    """[runtime] compiled_loop=false (from the environment, in each
    package's prefix) builds no loop in either runner."""
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_RUNTIME_COMPILED_LOOP", "0")
    monkeypatch.setenv("NNSTREAMER_TPU_RUNTIME_COMPILED_LOOP", "0")
    for pkg in ("jax", "torch"):
        _, d, st, _ = _run_doubler(pkg, _frames(6), compiled=None)
        assert "loop_entries" not in st
        assert all(c[0] == "pf" for c in d.calls)


def test_tracer_records_and_report_section_match_jax():
    runs = {pkg: _run_doubler(pkg, _frames(10), arm=2, window=4,
                              swap_bails=1, trace=True)
            for pkg in ("jax", "torch")}
    jr, tr = runs["jax"][3], runs["torch"][3]
    assert tr.tracer.compiled_windows() == jr.tracer.compiled_windows()
    assert tr.tracer.loop_bails() == jr.tracer.loop_bails()
    assert tr.tracer.compiled_windows()["d"]["frames"] == \
        runs["torch"][2]["compiled_steps"]

    def section(report):
        lines = report.splitlines()
        i = lines.index("compiled steady-state windows (scheduler bypass, "
                        "[runtime] compiled_loop):")
        return lines[i:i + 2]

    assert section(tr.report()) == section(jr.report())


# -- tensor_filter: window_capable, process_window ---------------------------

def _double(x):
    return x * 2


#: case → (filter properties, input spec kind, start the element)
CAPABLE_CASES = {
    "default": ({}, "static"),
    "compiled_loop_false": ({"compiled_loop": "false"}, "static"),
    "latency_sync": ({"latency_mode": "sync"}, "static"),
    "breaker": ({"breaker_threshold": 2, "error_policy": "skip"}, "static"),
    "flexible": ({"invoke_dynamic": "true"}, "flexible"),
    "dyn_batch": ({}, "dyn_batch"),
    "pallas": ({"framework": "pallas", "model": "normalize_u8"}, "u8"),
}


def _capable(pkg, props, kind):
    Spec, Info, DType = PKGS[pkg][4:7]
    Filter = JFilter if pkg == "jax" else TFilter
    fmt = JFormat if pkg == "jax" else TFormat
    props = {"model": _double, **props}
    if kind == "u8":
        spec = Spec.of(Info((1, 4, 4, 3), DType.UINT8))
    elif kind == "flexible":
        spec = Spec(tensors=(), format=fmt.FLEXIBLE)
    else:
        spec = Spec.of(Info((1, 4), DType.FLOAT32))
        if kind == "dyn_batch":
            spec = Spec(tensors=spec.tensors, dyn_batch=4)
    f = Filter(name="f", **props)
    f.negotiate([spec])
    f.start()
    try:
        return f.window_capable()
    finally:
        f.stop()


@pytest.mark.parametrize("case", sorted(CAPABLE_CASES))
def test_window_capable_matches_jax(case):
    props, kind = CAPABLE_CASES[case]
    verdict = _capable("torch", props, kind)
    assert verdict == _capable("jax", props, kind)
    assert verdict == (case == "default")


def _np_mobilenet_params(width, seed):
    """JAX MobileNetV2 params made with numpy in the tree JAX's init
    builds (its shapes from eval_shape: JAX's own init runs eagerly for
    ~15 s on the CPU): He-scaled weights, random BN statistics."""
    rng = np.random.default_rng(seed)

    def walk(p):
        if isinstance(p, dict):
            if set(p) == {"scale", "bias", "mean", "var"}:
                n = p["scale"].shape[0]
                return {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": rng.normal(0, 0.1, n).astype(np.float32),
                        "mean": rng.normal(0, 0.1, n).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v) for v in p]
        if len(p.shape) == 1:
            return rng.normal(0, 0.01, p.shape).astype(np.float32)
        fan_in = int(np.prod(p.shape[:-1]))
        return (rng.normal(size=p.shape) * np.sqrt(2.0 / fan_in)).astype(
            np.float32)

    return walk(jax.eval_shape(lambda: jm.init_params(width=width, seed=0)))


@pytest.fixture(scope="module")
def mobilenets():
    """(JAX filter, port filter) on the same f32 MobileNetV2 weights
    (width 0.35, input 32)."""
    params = _np_mobilenet_params(0.35, seed=0)
    jb = JModelBundle(
        fn=lambda p, x: jm.apply(p, x, width=0.35, dtype=np.float32),
        params=params, in_spec=JSpec.of(JInfo((1, 32, 32, 3), JDType.FLOAT32)),
        name="mobilenet_v2_0.35")
    jf = JFilter(name="f", model=jb)
    jf.negotiate([JSpec.of(JInfo((1, 32, 32, 3), JDType.FLOAT32))])
    jf.start()
    tb = tm.build(width=0.35, input_size=32, dtype="float32")
    bridge.load_mobilenet_v2(tb.params, params)
    tf = TFilter(name="f", model=tb, accelerator="cpu")
    tf.negotiate([TSpec.of(TInfo((1, 32, 32, 3), TDType.FLOAT32))])
    tf.start()
    yield jf, tf
    jf.stop()
    tf.stop()


def test_process_window_bit_for_bit_per_frame_and_near_jax(mobilenets):
    jf, tf = mobilenets
    assert tf.window_capable() and jf.window_capable()
    rng = np.random.default_rng(0)
    frames = [rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
              for _ in range(4)]
    per = [tf.process(0, TBuffer.of(x, pts=i))[0][1]
           for i, x in enumerate(frames)]
    win = [b for _, b in tf.process_window(
        0, [TBuffer.of(x, pts=i) for i, x in enumerate(frames)])]
    ref = [b for _, b in jf.process_window(
        0, [JBuffer.of(x, pts=i) for i, x in enumerate(frames)])]
    assert [b.pts for b in win] == [b.pts for b in per] == [0, 1, 2, 3]
    for p, w, r in zip(per, win, ref):
        p, w, r = p.tensors[0], w.tensors[0], np.asarray(r.tensors[0])
        assert torch.equal(p, w)
        np.testing.assert_allclose(w.numpy(), r,
                                   atol=MODEL_REL * float(np.abs(r).max()),
                                   rtol=0)
    st = tf.extra_stats()
    assert (st["backend_window_invokes"], st["backend_window_frames"],
            st["backend_window_compile_count"]) == (1, 4, 0)  # CPU: eager


def test_swap_pending_through_a_shared_key():
    """A reload through one holder of a shared key is pending on the
    other until its next per-frame invoke adopts it."""
    spec = TSpec.of(TInfo((1, 4), TDType.FLOAT32))
    filters = [TFilter(name=f"f{i}", model=_double,
                       shared_tensor_filter_key="cl-swap",
                       is_updatable="true") for i in range(2)]
    for f in filters:
        f.negotiate([spec])
        f.start()
    try:
        assert not any(f.swap_pending() for f in filters)
        filters[0].reload_model(lambda x: x * 3)
        assert not filters[0].swap_pending()
        assert filters[1].swap_pending()
        x = np.ones((1, 4), np.float32)
        out = filters[1].process(0, TBuffer.of(x))[0][1].tensors[0]
        assert not filters[1].swap_pending()
        np.testing.assert_array_equal(np.asarray(out), x * 3)
    finally:
        for f in filters:
            f.stop()


# -- the LLM decode window ---------------------------------------------------

def _llm_params():
    return jt.init_params(vocab=61, d_model=32, n_layers=2, n_heads=4,
                          n_kv_heads=2, seed=0)


@pytest.fixture(scope="module")
def llm_params():
    jp = _llm_params()
    return jp, bridge.transformer_params(
        jax.tree_util.tree_map(np.asarray, jp))


def _engine_kw(window):
    return dict(n_heads=4, block_size=4, num_blocks=32, max_batch=4,
                max_len=64, decode_window=window)


def _serve(engine, prompts, budgets, eos_id=None):
    reqs = [engine.submit(p, max_new_tokens=m, eos_id=eos_id)
            for p, m in zip(prompts, budgets)]
    engine.drain()
    return [list(r.tokens) for r in reqs], [r.finish_reason for r in reqs]


def _prompts(sizes):
    rng = np.random.default_rng(3)
    return [rng.integers(1, 60, size=s).tolist() for s in sizes]


@pytest.fixture(scope="module")
def jax_window_tokens(llm_params):
    """The JAX engine with decode_window=8: mixed budgets, and one
    request under an EOS that lands mid-window."""
    jp = llm_params[0]
    mixed = _serve(JLLMEngine(jp, **_engine_kw(8)), _prompts((5, 9, 3)),
                   [12, 7, 10])
    eos = _serve(JLLMEngine(jp, **_engine_kw(8)), _prompts((5,)), [12],
                 eos_id=7)
    return mixed, eos


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_decode_window_tokens_match_per_step_and_jax(llm_params,
                                                     jax_window_tokens,
                                                     kernel):
    tp = llm_params[1]
    (jtoks, jfin), (jeos, jeos_fin) = jax_window_tokens
    out = {}
    for window in (8, 0):
        eng = TLLMEngine(tp, paged_kernel=kernel, **_engine_kw(window))
        out[window] = _serve(eng, _prompts((5, 9, 3)), [12, 7, 10])
        st = eng.stats()
        assert (st["decode_window"], st["decode_windows"] > 0) == \
            (window, window > 0)
        assert st["executor"]["decode_windows"] == st["decode_windows"]
        assert st["executor"]["window_steps"] >= st["window_tokens"] // 3
        if window:
            assert st["window_tokens"] > 0
    assert out[8] == out[0] == (jtoks, jfin)
    assert [len(t) for t in out[8][0]] == [12, 7, 10]
    eos = {w: _serve(TLLMEngine(tp, paged_kernel=kernel, **_engine_kw(w)),
                     _prompts((5,)), [12], eos_id=7) for w in (8, 0)}
    assert eos[8] == eos[0] == (jeos, jeos_fin)


def test_engine_takes_decode_window_as_jax_does(llm_params):
    tp = llm_params[1]
    assert TLLMEngine(tp, **_engine_kw(0)).decode_window == 0
    assert TLLMEngine(tp, **_engine_kw(5)).decode_window == 5
    for pkg_engine, params in ((TLLMEngine, tp), (JLLMEngine,
                                                  llm_params[0])):
        with pytest.raises(Exception, match="decode_window must be >= 0"):
            pkg_engine(params, **_engine_kw(-1))


def test_window_len_rounds_down_and_respects_budgets(llm_params):
    eng = TLLMEngine(llm_params[1], **_engine_kw(8))
    reqs = [eng.submit(p, max_new_tokens=m)
            for p, m in zip(_prompts((5, 9)), (20, 7))]
    eng.step()                              # admit both, one decode step
    live = [r for r in eng.active if r.state == "active"]
    assert len(live) == 2
    budget = min(r.max_new_tokens - len(r.tokens) for r in live)
    assert eng._window_len(live) == 1 << (min(8, budget).bit_length() - 1)
    reqs[0].temperature = 0.5               # a sampled row: per step
    assert eng._window_len(live) == 1


# -- CUDA-graph bookkeeping, with a stand-in graph ---------------------------

class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_captured_launches_count_at_each_replay_not_at_capture():
    before = (kernels.clamp_scale.launches, kernels.flash_attention.launches,
              kernels.flash_attention.launches_tc)
    ws = torch.zeros(4)

    def body(x):
        cuda_graphs.count_launch(kernels.clamp_scale)
        cuda_graphs.count_launch(kernels.clamp_scale)
        cuda_graphs.count_launch(kernels.flash_attention, "launches_tc",
                                 keep=(ws,))
        return (x + 1,)

    stand = _StandInGraph()
    g = cuda_graphs.capture(body, [torch.zeros(3)], what="test body",
                            graph=stand, context=contextlib.nullcontext(),
                            keep=("params",))
    assert (kernels.clamp_scale.launches, kernels.flash_attention.launches,
            kernels.flash_attention.launches_tc) == before
    assert g.tally.launches == {(kernels.clamp_scale, "launches"): 2,
                                (kernels.flash_attention, "launches"): 1,
                                (kernels.flash_attention, "launches_tc"): 1}
    assert g.keep[0] == "params" and any(k is ws for k in g.keep)
    for i in range(3):
        out = g.run([torch.full((3,), float(i))])
    assert stand.replays == 3
    assert torch.equal(g.inputs[0], torch.full((3,), 2.0))
    assert (kernels.clamp_scale.launches - before[0],
            kernels.flash_attention.launches - before[1],
            kernels.flash_attention.launches_tc - before[2]) == (6, 3, 3)
    assert out is g.outputs
    # outside a capture a launch counts at once
    cuda_graphs.count_launch(kernels.clamp_scale)
    assert kernels.clamp_scale.launches - before[0] == 7


def test_failed_capture_raises_naming_what_and_holds_nothing():
    def body(x):
        cuda_graphs.count_launch(kernels.clamp_scale)
        raise RuntimeError("operation not permitted when stream is capturing")

    before = kernels.clamp_scale.launches
    with pytest.raises(BackendError, match="capture of the body failed.*"
                                           "not permitted"):
        cuda_graphs.capture(body, [torch.zeros(1)], what="the body",
                            graph=_StandInGraph(),
                            context=contextlib.nullcontext())
    assert kernels.clamp_scale.launches == before
    cuda_graphs.count_launch(kernels.clamp_scale)    # the capture is over
    assert kernels.clamp_scale.launches == before + 1


def test_graph_cache_holds_one_version():
    cache = cuda_graphs.GraphCache()
    assert cache.use(1) is True and cache.use(1) is False
    cache.graphs["k"] = "graph"
    cache.failed["bad"] = "CUDA graph capture of bad failed: E"
    cache._pool = "pool"
    assert cache.get("k") == "graph" and cache.get("other") is None
    with pytest.raises(BackendError, match="capture of bad failed"):
        cache.get("bad")
    assert cache.use(2) is True
    assert (cache.graphs, cache.failed, cache._pool, cache.version) == \
        ({}, {}, None, 2)


@pytest.fixture
def stand_in_card(monkeypatch):
    """The torch backend's card path on CPU tensors: a "cuda" device
    whose staging (of frames and params) is the identity, and captures into a stand-in graph
    whose static inputs hold the window's frames while the body runs, so
    a replay gives back what the body computed at capture (the model it
    baked in) on those frames. → the captures' static inputs, in order"""
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: "stream")
    monkeypatch.setattr(torch_backend, "stage",
                        lambda arrs, device: (tuple(arrs), 0))
    monkeypatch.setattr(torch_backend, "params_to",
                        lambda params, device: params)
    real = cuda_graphs.capture
    frames = []

    def capture(body, inputs, **kw):
        for dst, src in zip(inputs, frames[-1]):
            dst.copy_(src)
        return real(body, inputs, graph=_StandInGraph(),
                    context=contextlib.nullcontext(), **kw)

    monkeypatch.setattr(cuda_graphs, "capture", capture)

    def open_backend(bundle):
        be = torch_backend.TorchBackend()
        be.open({"model": bundle})
        be.device = torch.device("cuda")

        def window(xs):
            frames.append([x for f in xs for x in f])
            return [o[0] for o in be.invoke_window(xs)]

        return be, window

    return open_backend


def _scale_bundle(scale, hook=None):
    def fn(params, x):
        if hook is not None:
            hook()
        return (x * params,)

    return ModelBundle(fn=fn, params=torch.tensor(float(scale)),
                       name=f"x{scale}")


def test_reload_mid_capture_never_serves_the_old_model(stand_in_card):
    """A reload from another thread that lands while the worker captures
    a window: the graph bakes the model the window started with, and
    from the next window on the new model serves, never that graph."""
    state = {"reload_in": 0}
    new = _scale_bundle(3.0)

    def reload_once():
        state["reload_in"] -= 1
        if state["reload_in"] == 0:
            t = threading.Thread(target=be.reload, args=(new,))
            t.start()
            t.join()

    be, window = stand_in_card(_scale_bundle(2.0, reload_once))
    old_params = be._params
    xs = [(torch.full((1, 3), float(i + 1)),) for i in range(2)]
    want = {s: [x[0] * s for x in xs] for s in (2.0, 3.0)}
    # the warm-up runs both frames (2 calls), the capture's first call
    # of the model is the 3rd: the reload lands inside the capture
    state["reload_in"] = 3
    for got, w in zip(window(xs), want[2.0]):
        assert torch.equal(got, w)
    assert be._model[0] is new
    (g,) = be._graphs.graphs.values()
    assert g.keep[1] is old_params
    for out, w in zip(g.outputs, want[2.0]):   # both calls: the old model
        assert torch.equal(out[0], w)
    for _ in range(2):                          # eager + capture, replay
        for got, w in zip(window(xs), want[3.0]):
            assert torch.equal(got, w)
    assert be.window_compile_count == 2
    (g,) = be._graphs.graphs.values()
    assert g.keep[0] is new and g.graph.replays == 1


def test_failed_capture_is_remembered_until_the_model_changes(
        stand_in_card, monkeypatch):
    calls = []
    be, window = stand_in_card(_scale_bundle(2.0, lambda: calls.append(1)))
    staged = []
    monkeypatch.setattr(be, "_stage", lambda f: staged.append(f) or f)
    real = cuda_graphs.capture

    def refuse(body, inputs, **kw):
        raise BackendError("CUDA graph capture of the window failed: E")

    monkeypatch.setattr(cuda_graphs, "capture", refuse)
    xs = [(torch.ones(1, 3),) for _ in range(2)]
    with pytest.raises(BackendError, match="capture of the window failed"):
        window(xs)
    n_calls, n_staged = len(calls), len(staged)
    with pytest.raises(BackendError, match="capture of the window failed"):
        window(xs)                  # at once: nothing staged, nothing run
    assert (len(calls), len(staged)) == (n_calls, n_staged)
    monkeypatch.setattr(cuda_graphs, "capture", real)
    be.reload(_scale_bundle(3.0))
    for got in window(xs):          # the new model captures afresh
        assert torch.equal(got, torch.full((1, 3), 3.0))
    assert be.window_compile_count == 1 and not be._graphs.failed


def test_a_window_that_keeps_failing_warns_once(caplog):
    class WindowsFail(_doubler("torch")):
        def process_window(self, pad, bufs):
            self.calls.append(("win", [b.pts for b in bufs]))
            raise BackendError("CUDA graph capture of the window failed")

    frames = _frames(16)
    with caplog.at_level(logging.DEBUG, logger="nnstreamer_tpu_torch"):
        res, _, st, _ = _run_doubler("torch", frames, arm=2, window=4,
                                     cls=WindowsFail)
    said = [r for r in caplog.records if "re-run per frame" in r.message]
    assert st["loop_bails"]["error"] >= 2
    assert len(said) == st["loop_bails"]["error"]
    assert [r.levelno for r in said] == \
        [logging.WARNING] + [logging.DEBUG] * (len(said) - 1)
    assert [b.pts for b in res] == list(range(16))


def test_per_channel_transform_operand_made_once_per_device():
    """The per-channel operand goes to a device once, not every frame,
    and the result stays JAX's."""
    from nnstreamer_tpu.elements.transform import TransformProgram as JProg
    from nnstreamer_tpu_torch.elements.transform import (
        TransformProgram as TProg)

    opt = "typecast:float32,add:-1:-2:-3,div:2:4:8"
    x = np.random.default_rng(0).integers(0, 256, (1, 4, 4, 3), np.uint8)
    jp, tp = JProg("arithmetic", opt), TProg("arithmetic", opt)
    made = []
    real = torch.from_numpy

    def counting(a):
        made.append(a.shape)
        return real(a)

    ref = np.asarray(jp.apply(jax.numpy, x))
    outs = []
    torch.from_numpy = counting
    try:
        for _ in range(3):
            outs.append(tp.apply(torch.from_numpy(x.copy())))
    finally:
        torch.from_numpy = real
    # three frames in (one from_numpy each), the two operands made once
    assert len(made) == 3 + 2
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), ref)


def test_invoke_window_on_the_cpu_runs_the_per_frame_calls():
    b = ModelBundle(fn=lambda params, x: (x * 2, x + 1), name="two")
    f = TFilter(name="f", model=b)
    f.negotiate([TSpec.of(TInfo((1, 3), TDType.FLOAT32))])
    f.start()
    try:
        frames = [(np.full((1, 3), i, np.float32),) for i in range(4)]
        outs = f.backend.invoke_window(frames)
        assert len(outs) == 4
        for i, (a, c) in enumerate(outs):
            assert torch.equal(a, torch.full((1, 3), 2.0 * i))
            assert torch.equal(c, torch.full((1, 3), i + 1.0))
        assert (f.backend.window_invokes, f.backend.window_frames,
                f.backend.window_compile_count) == (1, 4, 0)
    finally:
        f.stop()

"""The port's fault-tolerance layer (core/errors.ErrorPolicy, the
scheduler's error policies and watchdog, backends/base.CircuitBreaker,
tensor_fault) held to the JAX package's on the same pipelines, on the CPU.

Ported from tests/test_faults.py. Where both packages run the same
pipeline string, the test runs it in both and compares what is
deterministic: outputs, the policy counters of `stats()`, the pts the
seeded fault hits. Where the JAX tests register a custom filter
(`register_custom_easy`), the port's tests register a kernel-filter
function (`register_pallas_filter`). tensor_repo's slot overflow is
held to JAX's error text (without the JAX test's elapsed-time bound).
Every error class round-trips through pickle with its state, as JAX's
(ServerBusyError's fields too); SegmentStageError comes with the device
segments (ROADMAP Queue 1 item 4e). No test asserts a
wall-clock bound; the watchdog tests use budgets far from the delays
they flag.
"""

import pickle
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
from nnstreamer_tpu.backends.base import CircuitBreaker as JaxBreaker
from nnstreamer_tpu.core.errors import ErrorPolicy as JaxPolicy
from nnstreamer_tpu.elements import TensorFault as JaxFault

import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu_torch.backends import pallas_backend
from nnstreamer_tpu_torch.backends.base import CircuitBreaker
from nnstreamer_tpu_torch.core import errors as errors_mod
from nnstreamer_tpu_torch.core.errors import (
    CircuitOpenError, ErrorPolicy, FaultInjected, PipelineError, StreamError,
    WatchdogStall)
from nnstreamer_tpu_torch.elements import (
    AppSrc, TensorFault, TensorFilter, TensorSink)
from nnstreamer_tpu_torch.graph.pipeline import Element, SourceElement
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def models():
    """register(name, fn, same_spec=False): a kernel-filter function
    (`framework=pallas model=<name>`) for the test, unregistered after
    it; `same_spec` declares output spec = input spec."""
    names = []

    def register(name, fn, same_spec=False):
        names.append(name)
        pallas_backend.register_pallas_filter(
            name, out_like=(lambda s: s) if same_spec else None)(fn)

    yield register
    for n in names:
        pallas_backend._kernels.pop(n, None)


def _wait_for(cond, timeout=10.0, what="condition"):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, f"timed out waiting: {what}"
        time.sleep(0.01)


def _run_both(desc, timeout=30, **runner_kw):
    """Run `desc` in both packages → ((JAX pipe, runner), (port pipe,
    runner))."""
    out = []
    for pkg in (jnns, tnns):
        pipe = pkg.parse_launch(desc)
        runner = pkg.PipelineRunner(pipe, **runner_kw)
        runner.run(timeout=timeout)
        out.append((pipe, runner))
    return out


def _frames(results):
    return [(b.pts, np.asarray(b.tensors[0]).tobytes()) for b in results]


POLICY_KEYS = ("buffers", "errors", "retries", "skipped", "degraded",
               "dropped", "timer_fires")


def _counters(runner, name):
    st = runner.stats()[name]
    return {k: st[k] for k in POLICY_KEYS}


# -- error-policy grammar ----------------------------------------------------

class TestErrorPolicyParse:
    def test_kinds(self):
        for k in ("fail", "skip", "degrade"):
            assert ErrorPolicy.parse(k).kind == k

    def test_retry(self):
        p = ErrorPolicy.parse("retry:3")
        assert (p.kind, p.retries, p.backoff_ms) == ("retry", 3, 10.0)
        p = ErrorPolicy.parse("retry:2:5.5")
        assert (p.retries, p.backoff_ms) == (2, 5.5)

    @pytest.mark.parametrize("text", ["fail", "skip", "degrade",
                                      "retry:4:25", "retry:2", " Skip "])
    def test_roundtrip_str_matches_jax(self, text):
        p, j = ErrorPolicy.parse(text), JaxPolicy.parse(text)
        assert str(p) == str(j)
        assert (p.kind, p.retries, p.backoff_ms) == \
            (j.kind, j.retries, j.backoff_ms)
        assert str(ErrorPolicy.parse(str(p))) == str(p)

    @pytest.mark.parametrize("bad", ["", "nope", "retry", "retry:0",
                                     "retry:x", "retry:1:-5", "retry:1:2:3"])
    def test_rejects_with_the_jax_text(self, bad):
        with pytest.raises(ValueError, match="error-policy") as ours:
            ErrorPolicy.parse(bad)
        with pytest.raises(ValueError) as theirs:
            JaxPolicy.parse(bad)
        assert str(ours.value) == str(theirs.value)

    def test_element_property(self):
        f = TensorFault(error_policy="retry:2")
        assert f.error_policy.kind == "retry"
        assert TensorFault().error_policy.kind == "fail"

    def test_unknown_prop_message_lists_common(self):
        with pytest.raises(PipelineError, match="error-policy"):
            TensorFault(no_such_prop=1)


# -- fail-fast error paths ---------------------------------------------------

class _BoomSrc(SourceElement):
    """Source that dies after its first buffer (mid-generate failure)."""

    ELEMENT_NAME = "boom_src"

    def output_spec(self):
        return TensorsSpec.from_strings("2:2", "float32")

    def generate(self):
        yield TensorBuffer.of(np.zeros((2, 2), np.float32))
        raise RuntimeError("source exploded mid-stream")


class TestFailFast:
    def test_source_raises_mid_generate(self):
        p = tnns.Pipeline("boom")
        src = p.add(_BoomSrc(name="src"))
        sink = p.add(TensorSink(name="out"))
        p.link(src, sink)
        with pytest.raises(StreamError, match="source exploded") as ei:
            tnns.run_pipeline(p, timeout=10)
        assert isinstance(ei.value.__cause__, RuntimeError)

    def test_element_raises_on_frame_k_fail_fast(self):
        p = tnns.parse_launch(
            "videotestsrc width=4 height=4 num-buffers=10 ! "
            "tensor_converter ! tensor_fault mode=raise period=3 ! "
            "tensor_sink name=out")
        with pytest.raises(StreamError, match="injected failure") as ei:
            tnns.run_pipeline(p, timeout=10)
        assert isinstance(ei.value.__cause__, FaultInjected)
        assert len(p.get("out").results) <= 2

    def test_wait_timeout_chains_root_cause(self, models):
        models("t_slowmodel", lambda ts: (time.sleep(1.5), ts)[1],
               same_spec=True)
        p = tnns.Pipeline("stuck")
        s1 = p.add(AppSrc(name="s1", spec=TensorsSpec.from_strings(
            "2:2", "float32")))
        flt = p.add(TensorFault(name="boom", mode="raise", period=1))
        k1 = p.add(TensorSink(name="k1"))
        p.link(s1, flt)
        p.link(flt, k1)
        s2 = p.add(AppSrc(name="s2", spec=TensorsSpec.from_strings(
            "2:2", "float32")))
        slow = p.add(TensorFilter(name="slow", framework="pallas",
                                  model="t_slowmodel"))
        k2 = p.add(TensorSink(name="k2"))
        p.link(s2, slow)
        p.link(slow, k2)
        runner = tnns.PipelineRunner(p).start()
        frame = TensorBuffer.of(np.zeros((2, 2), np.float32))
        s2.push(frame)          # the slow branch enters its invoke
        time.sleep(0.2)
        s1.push(frame)          # the fault branch fails at once
        try:
            with pytest.raises(StreamError,
                               match="did not finish within") as ei:
                runner.wait(timeout=0.5)
            assert "injected failure" in str(ei.value)
            assert isinstance(ei.value.__cause__, FaultInjected)
        finally:
            runner.stop()
        time.sleep(1.5)         # let the sleeping invoke drain


# -- skip / retry / degrade, both packages -----------------------------------

class TestPolicies:
    def test_skip_conservation_matches_jax(self):
        (jp, jr), (tp, tr) = _run_both(
            "videotestsrc width=4 height=4 num-buffers=20 ! "
            "tensor_converter ! tensor_fault name=flt mode=raise period=4 "
            "error-policy=skip ! tensor_sink name=out", timeout=15)
        st = tr.stats()["flt"]
        sink = tp.get("out")
        assert sink.eos.is_set()
        assert st["skipped"] == 5 and st["errors"] == st["skipped"]
        assert len(sink.results) + st["skipped"] + st["dropped"] == 20
        assert _counters(tr, "flt") == _counters(jr, "flt")
        assert _frames(sink.results) == _frames(jp.get("out").results)

    def test_retry_recovers_transient_failure(self, models):
        calls = {"n": 0}

        def flaky(ts):
            calls["n"] += 1
            if calls["n"] == 3:            # frame 3 fails its first attempt
                raise RuntimeError("transient")
            return ts

        models("t_flaky_once", flaky)
        p = tnns.parse_launch(
            "videotestsrc width=4 height=4 num-buffers=5 ! "
            "tensor_converter ! tensor_transform mode=typecast "
            "option=float32 ! tensor_filter name=f framework=pallas "
            "model=t_flaky_once error-policy=retry:2:1 ! tensor_sink "
            "name=out")
        runner = tnns.PipelineRunner(p)
        runner.run(timeout=15)
        st = runner.stats()["f"]
        assert len(p.get("out").results) == 5
        assert (st["errors"], st["retries"], st["skipped"]) == (1, 1, 0)
        assert st["backend_invoke_failures"] == 1

    def test_retry_exhausted_falls_back_to_skip_matches_jax(self):
        (jp, jr), (tp, tr) = _run_both(
            "videotestsrc width=4 height=4 num-buffers=3 ! "
            "tensor_converter ! tensor_fault name=flt mode=raise "
            "probability=1.0 error-policy=retry:2:1 ! tensor_sink name=out",
            timeout=15)
        st = tr.stats()["flt"]
        assert len(tp.get("out").results) == 0
        assert (st["skipped"], st["retries"], st["errors"]) == (3, 6, 9)
        assert tp.get("out").eos.is_set()
        assert _counters(tr, "flt") == _counters(jr, "flt")

    def test_degrade_routes_input_to_fallback_pad_matches_jax(self):
        (jp, jr), (tp, tr) = _run_both(
            "videotestsrc width=4 height=4 num-buffers=6 ! "
            "tensor_converter ! tensor_fault name=flt mode=raise period=2 "
            "error-policy=degrade flt.src_0 ! tensor_sink name=ok "
            "flt.src_1 ! tensor_sink name=fb", timeout=15)
        ok, fb = tp.get("ok"), tp.get("fb")
        assert len(ok.results) == 3 and len(fb.results) == 3
        assert tr.stats()["flt"]["degraded"] == 3
        # the fallback pad carries the *unprocessed* input spec
        assert fb.results[0].tensors[0].dtype == np.uint8
        assert tp.get("flt").out_specs[1] == tp.get("flt").in_specs[0]
        for name in ("ok", "fb"):
            assert _frames(tp.get(name).results) == \
                _frames(jp.get(name).results)
        assert _counters(tr, "flt") == _counters(jr, "flt")

    def test_degrade_requires_linked_fallback_pad(self):
        for pkg in (tnns, jnns):
            p = pkg.parse_launch(
                "videotestsrc width=4 height=4 num-buffers=2 ! "
                "tensor_converter ! tensor_fault mode=raise period=2 "
                "error-policy=degrade ! tensor_sink")
            with pytest.raises(Exception, match="fallback"):
                pkg.run_pipeline(p, timeout=10)

    def test_degrade_pad_numbering_in_link(self):
        p = tnns.Pipeline("pads")
        src = p.add(AppSrc(name="s", spec=TensorsSpec.from_strings(
            "2:2", "float32")))
        flt = p.add(TensorFault(name="f", error_policy="degrade"))
        a, b = p.add(TensorSink(name="a")), p.add(TensorSink(name="b"))
        p.link(src, flt)
        assert p.link(flt, a).src_pad == 0
        assert p.link(flt, b).src_pad == flt.fallback_src_pad == 1
        with pytest.raises(PipelineError, match="2 src pad"):
            p.link(flt, p.add(TensorSink(name="c")), src_pad=2)

    def test_policy_on_source_rejected(self):
        p = tnns.parse_launch(
            "videotestsrc num-buffers=2 error-policy=skip ! "
            "tensor_converter ! tensor_sink")
        with pytest.raises(PipelineError, match="source"):
            tnns.run_pipeline(p, timeout=10)

    def test_policied_transform_stays_out_of_filter_fusion(self, models):
        models("t_ident", lambda ts: ts, same_spec=True)
        p = tnns.parse_launch(
            "videotestsrc width=4 height=4 num-buffers=2 ! tensor_converter "
            "! tensor_transform name=t mode=typecast option=float32 "
            "error-policy=skip ! tensor_filter framework=pallas "
            "model=t_ident ! tensor_sink name=out")
        tnns.run_pipeline(p, timeout=10)
        assert "t" in p.elements and len(p.get("out").results) == 2


# -- 5% chaos to EOS, exact conservation, the seed's frames ------------------

class TestChaosAcceptance:
    @pytest.mark.parametrize("policy", ["skip", "retry:3:1"])
    def test_five_percent_raise_matches_jax(self, policy):
        (jp, jr), (tp, tr) = _run_both(
            f"videotestsrc width=4 height=4 num-buffers=100 ! "
            f"tensor_converter ! tensor_fault name=flt mode=raise "
            f"probability=0.05 seed=7 error-policy={policy} ! "
            f"tensor_sink name=out", timeout=30)
        sink = tp.get("out")
        st = tr.stats()["flt"]
        assert sink.eos.is_set()
        assert len(sink.results) + st["skipped"] + st["dropped"] == 100
        assert st["errors"] > 0
        if policy == "skip":
            assert st["skipped"] == st["errors"]
        # the same seed faults the same frames in both packages
        assert _counters(tr, "flt") == _counters(jr, "flt")
        assert [b.pts for b in sink.results] == \
            [b.pts for b in jp.get("out").results]
        assert tp.get("flt").injected == jp.get("flt").injected

    def test_skipped_pts_are_the_seeds_draws(self):
        p = tnns.parse_launch(
            "videotestsrc width=4 height=4 num-buffers=64 ! "
            "tensor_converter ! tensor_fault name=flt mode=raise "
            "probability=0.05 seed=7 error-policy=skip ! "
            "tensor_sink name=out")
        tnns.run_pipeline(p, timeout=30)
        rng = np.random.default_rng(7)
        frame_ns = int(1e9 / 30)
        want = {i * frame_ns for i in range(64) if rng.random() < 0.05}
        got = {b.pts for b in p.get("out").results}
        assert want and {i * frame_ns for i in range(64)} - got == want

    def test_escalation_on_poison_stream(self):
        for pkg in (tnns, jnns):
            p = pkg.parse_launch(
                "videotestsrc width=4 height=4 num-buffers=20 ! "
                "tensor_fault mode=raise probability=1.0 "
                "error-policy=skip ! tensor_sink")
            runner = pkg.PipelineRunner(p, max_consecutive_errors=5)
            with pytest.raises(Exception, match="consecutive errors"):
                runner.run(timeout=15)


# -- tensor_fault ------------------------------------------------------------

class TestTensorFault:
    def test_seeded_probability_matches_jax(self):
        (jp, _), (tp, _) = _run_both(
            "videotestsrc width=4 height=4 num-buffers=50 ! "
            "tensor_converter ! tensor_fault name=flt mode=drop "
            "probability=0.2 seed=42 ! tensor_sink name=out", timeout=15)
        got = (len(tp.get("out").results), tp.get("flt").injected)
        assert got == (len(jp.get("out").results), jp.get("flt").injected)
        assert got[1] > 0 and sum(got) == 50
        assert _frames(tp.get("out").results) == \
            _frames(jp.get("out").results)

    def test_max_faults_cap(self):
        (jp, jr), (tp, tr) = _run_both(
            "videotestsrc width=4 height=4 num-buffers=10 ! "
            "tensor_converter ! tensor_fault name=flt mode=drop period=2 "
            "max-faults=2 ! tensor_sink name=out", timeout=15)
        assert tp.get("flt").injected == 2
        assert len(tp.get("out").results) == 8
        assert tr.stats()["flt"]["faults_injected"] == 2
        assert tr.stats()["flt"]["buffers_passed"] == 8
        assert _frames(tp.get("out").results) == \
            _frames(jp.get("out").results)

    @pytest.mark.parametrize("mode", ["corrupt", "corrupt-shape"])
    def test_corrupt_modes_match_jax(self, mode):
        (jp, _), (tp, _) = _run_both(
            f"videotestsrc width=4 height=4 num-buffers=4 ! "
            f"tensor_converter ! tensor_transform mode=typecast "
            f"option=float32 ! tensor_fault mode={mode} period=2 "
            f"corrupt-dtype=int16 ! tensor_sink name=out", timeout=15)
        got, want = tp.get("out").results, jp.get("out").results
        assert [(b.tensors[0].shape, b.tensors[0].dtype) for b in got] == \
            [(b.tensors[0].shape, b.tensors[0].dtype) for b in want]
        assert _frames(got) == _frames(want)

    def test_corrupt_device_tensor(self):
        f = TensorFault(mode="corrupt", period=1, corrupt_dtype="int16")
        (_, b), = f.process(0, TensorBuffer.of(torch.ones(2, 3) * 2.5))
        assert b.tensors[0].dtype == torch.int16
        assert b.tensors[0].tolist() == [[2, 2, 2], [2, 2, 2]]

    def test_corrupt_bfloat16_matches_jax(self):
        """Fault F5: corrupt-dtype=bfloat16 gives bfloat16 frames, bit for
        bit the JAX package's (the port raised: torch.from_numpy refuses
        ml_dtypes' bfloat16)."""
        (jp, _), (tp, _) = _run_both(
            "videotestsrc width=4 height=4 num-buffers=2 ! "
            "tensor_converter ! tensor_fault mode=corrupt period=1 "
            "corrupt-dtype=bfloat16 ! tensor_sink name=out", timeout=15)
        got, want = tp.get("out").results, jp.get("out").results
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            g, w = g.tensors[0], np.asarray(w.tensors[0])
            assert g.shape == w.shape == (1, 4, 4, 3)
            assert str(g.dtype) == str(w.dtype) == "bfloat16"
        assert _frames(got) == _frames(want)

    def test_corrupt_device_tensor_bfloat16(self):
        f = TensorFault(mode="corrupt", period=1, corrupt_dtype="bfloat16")
        (_, b), = f.process(0, TensorBuffer.of(torch.ones(2, 3) * 2.5))
        assert b.tensors[0].dtype == torch.bfloat16
        assert b.tensors[0].tolist() == [[2.5] * 3] * 2

    def test_corrupt_shape_breaks_downstream(self, models):
        def strict(ts):
            if ts[0].ndim != 4:        # (1, 4, 4, 3) from the converter
                raise RuntimeError(f"unexpected shape {tuple(ts[0].shape)}")
            return ts

        models("t_strict_shape", strict, same_spec=True)
        p = tnns.parse_launch(
            "videotestsrc width=4 height=4 num-buffers=5 ! "
            "tensor_converter ! tensor_transform mode=typecast "
            "option=float32 ! tensor_fault mode=corrupt-shape period=2 ! "
            "tensor_filter framework=pallas model=t_strict_shape ! "
            "tensor_sink name=out")
        with pytest.raises(StreamError, match="unexpected shape"):
            tnns.run_pipeline(p, timeout=15)

    def test_bad_mode_rejected_at_negotiation(self):
        p = tnns.parse_launch(
            "videotestsrc num-buffers=1 ! tensor_converter ! "
            "tensor_fault mode=wat ! tensor_sink")
        with pytest.raises(Exception, match="unknown mode"):
            tnns.run_pipeline(p, timeout=10)

    def test_props_match_jax(self):
        assert set(TensorFault.PROPS) == set(JaxFault.PROPS)
        assert {k: d.default for k, d in TensorFault.PROPS.items()} == \
            {k: d.default for k, d in JaxFault.PROPS.items()}


# -- watchdog ----------------------------------------------------------------

class TestWatchdog:
    def test_flags_stalled_element(self):
        p = tnns.parse_launch(
            "videotestsrc width=4 height=4 num-buffers=2 ! "
            "tensor_converter ! tensor_fault name=flt mode=delay "
            "delay-ms=700 period=1 ! tensor_sink name=out")
        runner = tnns.PipelineRunner(p, stall_budget_s=0.2, trace=True)
        runner.run(timeout=30)
        st = runner.stats()["flt"]
        assert st["watchdog_warnings"] >= 1
        assert runner.tracer.watchdog_counts()["flt"]["stall"] >= 1
        assert "watchdog=" in runner.report()
        assert p.get("out").eos.is_set()       # warn only: the run ends

    def test_no_false_positives_on_fast_pipeline(self):
        p = tnns.parse_launch(
            "videotestsrc width=4 height=4 num-buffers=20 ! "
            "tensor_converter ! tensor_sink name=out")
        runner = tnns.PipelineRunner(p, stall_budget_s=5.0)
        runner.run(timeout=15)
        assert all(d["watchdog_warnings"] == 0
                   for d in runner.stats().values())

    def test_action_fail_tears_down_with_watchdog_stall(self):
        p = tnns.parse_launch(
            "videotestsrc width=4 height=4 num-buffers=4 ! "
            "tensor_converter ! tensor_fault mode=delay delay-ms=30000 "
            "period=1 ! tensor_sink")
        runner = tnns.PipelineRunner(p, stall_budget_s=0.3,
                                     watchdog_action="fail")
        with pytest.raises(StreamError, match="stall budget") as ei:
            runner.run(timeout=30)
        assert isinstance(ei.value.__cause__, WatchdogStall)

    def test_bad_action_rejected(self):
        p = tnns.parse_launch("videotestsrc num-buffers=1 ! "
                              "tensor_converter ! tensor_sink")
        with pytest.raises(PipelineError, match="watchdog_action"):
            tnns.PipelineRunner(p, watchdog_action="explode")

    def test_config_defaults_match_jax(self):
        p = tnns.parse_launch("videotestsrc num-buffers=1 ! "
                              "tensor_converter ! tensor_sink")
        j = jnns.parse_launch("videotestsrc num-buffers=1 ! "
                              "tensor_converter ! tensor_sink")
        ours, theirs = tnns.PipelineRunner(p), jnns.PipelineRunner(j)
        for attr in ("_max_consec", "_watchdog_enabled", "_stall_budget_s",
                     "_queue_stall_budget_s", "_watchdog_action",
                     "_chain_fusion", "_max_inflight", "_cap"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr

    def test_config_keys_steer_the_runner(self, monkeypatch):
        from nnstreamer_tpu_torch.core import config

        for key, value in (("MAX_CONSECUTIVE_ERRORS", "7"),
                           ("STALL_BUDGET_S", "2.5"),
                           ("WATCHDOG_ACTION", "fail"),
                           ("CHAIN_FUSION", "0"), ("WATCHDOG", "off")):
            monkeypatch.setenv(f"NNSTREAMER_TPU_TORCH_RUNTIME_{key}", value)
        monkeypatch.setattr(config, "_global", None)
        p = tnns.parse_launch("videotestsrc num-buffers=1 ! "
                              "tensor_converter ! tensor_sink")
        r = tnns.PipelineRunner(p)
        monkeypatch.setattr(config, "_global", None)
        assert (r._max_consec, r._stall_budget_s, r._queue_stall_budget_s,
                r._watchdog_action, r._chain_fusion,
                r._watchdog_enabled) == (7, 2.5, 2.5, "fail", False, False)


# -- circuit breaker ---------------------------------------------------------

class TestCircuitBreakerUnit:
    def test_state_machine_with_fake_clock(self):
        clk = [0.0]
        b = CircuitBreaker(threshold=2, cooldown_s=5.0,
                           clock=lambda: clk[0])
        assert b.state == "closed"
        b.guard("t")
        b.record_failure()
        assert b.state == "closed"
        b.record_failure()
        assert b.state == "open" and b.opened_count == 1
        with pytest.raises(CircuitOpenError, match="circuit open"):
            b.guard("t")
        assert b.short_circuited == 1
        clk[0] = 6.0
        b.guard("t")
        assert b.state == "half_open" and b.probes == 1
        b.record_failure()
        assert b.state == "open" and b.opened_count == 2
        clk[0] = 12.0
        b.guard("t")
        b.record_success()
        assert b.state == "closed" and b.recoveries == 1
        b.record_failure()
        assert b.state == "closed"

    def test_same_transitions_as_jax(self):
        script = ["g", "f", "f", "g", "t6", "g", "f", "g", "t12", "g", "s",
                  "f", "f", "g", "t20", "g", "s"]

        def run(cls):
            clk = [0.0]
            b = cls(threshold=2, cooldown_s=5.0, clock=lambda: clk[0])
            trail = []
            for op in script:
                if op == "g":
                    try:
                        b.guard("t")
                    except Exception as e:
                        trail.append(("short", str(e)))
                elif op == "f":
                    b.record_failure()
                elif op == "s":
                    b.record_success()
                else:
                    clk[0] = float(op[1:])
                trail.append((b.state, tuple(sorted(b.stats().items()))))
            return trail

        assert run(CircuitBreaker) == run(JaxBreaker)

    def test_threshold_validated(self):
        with pytest.raises(ValueError, match="threshold"):
            CircuitBreaker(threshold=0, cooldown_s=1.0)

    def test_stats_shape(self):
        s = CircuitBreaker(threshold=1, cooldown_s=1.0).stats()
        assert s["state"] == "closed"
        assert set(s) == set(JaxBreaker(threshold=1, cooldown_s=1.0).stats())


class TestCircuitBreakerInPipeline:
    def test_open_fallback_probe_recover(self, models):
        calls = {"n": 0}
        fail = {"on": True}

        def backend_fn(ts):
            calls["n"] += 1
            if fail["on"]:
                raise RuntimeError("backend down")
            return ts

        models("t_breaker_model", backend_fn, same_spec=True)
        clk = [0.0]
        p = tnns.Pipeline("breaker")
        src = p.add(AppSrc(name="src", spec=TensorsSpec.from_strings(
            "2:2", "float32")))
        flt = p.add(TensorFilter(name="f", framework="pallas",
                                 model="t_breaker_model",
                                 error_policy="skip"))
        sink = p.add(TensorSink(name="out"))
        p.link(src, flt)
        p.link(flt, sink)
        flt._breaker = CircuitBreaker(threshold=2, cooldown_s=10.0,
                                      clock=lambda: clk[0])
        runner = tnns.PipelineRunner(p).start()
        frame = TensorBuffer.of(np.ones((2, 2), np.float32))
        try:
            def st():
                return runner.stats()["f"]
            src.push(frame)                # failure 1 (invoked)
            _wait_for(lambda: st()["errors"] == 1, what="first failure")
            src.push(frame)                # failure 2 → circuit opens
            _wait_for(lambda: st()["errors"] == 2, what="circuit open")
            assert flt._breaker.state == "open" and calls["n"] == 2
            src.push(frame)                # short-circuited
            _wait_for(lambda: st()["errors"] == 3, what="short circuit")
            assert calls["n"] == 2         # backend not touched
            assert flt._breaker.short_circuited == 1
            fail["on"] = False
            clk[0] = 11.0
            src.push(frame)                # the probe recovers
            src.end()
            runner.wait(timeout=10)
        finally:
            runner.stop()
        assert len(sink.results) == 1
        d = runner.stats()["f"]
        assert d["skipped"] == 3
        assert (d["breaker_state"], d["breaker_opened"], d["breaker_probes"],
                d["breaker_recoveries"]) == ("closed", 1, 1, 1)
        assert d["backend_invoke_failures"] == 2

    def test_short_circuit_is_not_retried(self, models):
        def dead(ts):
            raise RuntimeError("dead")

        models("t_dead", dead, same_spec=True)
        p = tnns.parse_launch(
            "appsrc name=src dims=2:2 types=float32 ! tensor_filter name=f "
            "framework=pallas model=t_dead breaker-threshold=1 "
            "breaker-cooldown-ms=60000 error-policy=retry:3:0 ! "
            "tensor_sink name=out")
        runner = tnns.PipelineRunner(p).start()
        try:
            for _ in range(2):
                p.get("src").push(np.ones((2, 2), np.float32))
            p.get("src").end()
            runner.wait(timeout=10)
        finally:
            runner.stop()
        d = runner.stats()["f"]
        # frame 1: one failure opens the circuit, its retries short-
        # circuit at once (no retry of a CircuitOpenError); frame 2 too
        assert (d["errors"], d["retries"], d["skipped"]) == (3, 1, 2)
        assert d["backend_invoke_failures"] == 1
        assert d["breaker_short_circuited"] == 2

    def test_breaker_props_build_breaker(self, models):
        models("t_ok_model", lambda ts: ts, same_spec=True)
        p = tnns.parse_launch(
            "appsrc name=src dims=2:2 types=float32 ! "
            "tensor_filter name=f framework=pallas model=t_ok_model "
            "breaker-threshold=3 breaker-cooldown-ms=250 ! "
            "tensor_sink name=out")
        runner = tnns.PipelineRunner(p).start()
        try:
            flt = p.get("f")
            assert flt._breaker is not None
            assert (flt._breaker.threshold, flt._breaker.cooldown_s) == \
                (3, 0.25)
            p.get("src").end()
            runner.wait(timeout=10)
        finally:
            runner.stop()


# -- upstream event errors ---------------------------------------------------

class _BadHandler(Element):
    ELEMENT_NAME = "bad_handler"

    def negotiate(self, in_specs):
        return [in_specs[0]]

    def process(self, pad, buf):
        return [(0, buf)]

    def handle_upstream_event(self, event):
        raise RuntimeError("handler exploded")


class TestUpstreamEventErrors:
    def test_broken_handler_does_not_consume_event(self):
        p = tnns.Pipeline("events")
        src = p.add(AppSrc(name="src", spec=TensorsSpec.from_strings(
            "2:2", "float32")))
        mid = p.add(_BadHandler(name="mid"))
        sink = p.add(TensorSink(name="out"))
        p.link(src, mid)
        p.link(mid, sink)
        runner = tnns.PipelineRunner(p).start()
        try:
            sink.post_upstream_event(
                {"type": "qos", "min_interval_ns": 12345})
            assert src.qos_min_interval_ns == 12345
            assert runner.stats()["mid"]["event_errors"] == 1
            src.end()
            runner.wait(timeout=10)
        finally:
            runner.stop()
        assert "event_errors=1" in runner.report()


# -- error pickling ----------------------------------------------------------

_ERR_INSTANCES = [
    errors_mod.NNStreamerTPUError("base"),
    errors_mod.ConfigError("bad [runtime] key: workers"),
    errors_mod.NegotiationError("dims mismatch 4:1 vs 8:1"),
    errors_mod.PipelineError("unbalanced tee"),
    errors_mod.BackendError("open failed"),
    errors_mod.StreamError("flow error"),
    errors_mod.ServerBusyError(
        "server busy", queue_depth=17, retry_after_ms=12.5,
        cause="worker_lost", pts=42),
    errors_mod.FaultInjected("injected at pts=3"),
    errors_mod.WatchdogStall("element x stalled 2.0s"),
    errors_mod.CircuitOpenError("breaker open, 3 failures"),
]


class TestErrorPickling:
    @pytest.mark.parametrize(
        "exc", _ERR_INSTANCES, ids=lambda e: type(e).__name__)
    def test_round_trip_preserves_type_and_args(self, exc):
        back = pickle.loads(pickle.dumps(exc))
        assert type(back) is type(exc)
        assert back.args == exc.args and str(back) == str(exc)
        assert back.__dict__ == exc.__dict__

    def test_rich_state_survives(self):
        e = errors_mod.ServerBusyError(
            "busy", queue_depth=9, retry_after_ms=7.0, cause="shutdown",
            pts=5)
        back = pickle.loads(pickle.dumps(e))
        assert (back.queue_depth, back.retry_after_ms, back.cause,
                back.pts) == (9, 7.0, "shutdown", 5)

    def test_round_trip_matches_jax(self):
        from nnstreamer_tpu.core import errors as jerr

        e = jerr.ServerBusyError("busy", queue_depth=3, retry_after_ms=1.5,
                                 cause="deadline", pts=8)
        ours = errors_mod.ServerBusyError(
            "busy", queue_depth=3, retry_after_ms=1.5, cause="deadline",
            pts=8)
        back = pickle.loads(pickle.dumps(ours))
        assert back.__dict__ == e.__dict__ and back.args == e.args

    def test_every_public_error_class_is_covered(self):
        public = {obj for name, obj in vars(errors_mod).items()
                  if isinstance(obj, type) and issubclass(obj, Exception)
                  and not name.startswith("_")}
        assert public == {type(e) for e in _ERR_INSTANCES}

    def test_hierarchy_matches_jax(self):
        from nnstreamer_tpu.core import errors as jerr

        for e in _ERR_INSTANCES:
            name = type(e).__name__
            ours = [c.__name__ for c in type(e).__mro__]
            theirs = [c.__name__ for c in getattr(jerr, name).__mro__]
            assert ours == theirs, name


# -- repo slot overflow (stop-aware put) -------------------------------------

class TestRepoSlot:
    @pytest.mark.parametrize("stopping", [False, True])
    def test_full_slot_raises_descriptive_stream_error(self, stopping):
        """A full slot: the put gives up after put_timeout, or at once
        when the pipeline is stopping, with the JAX element's text."""
        import queue as _queue
        import threading

        from nnstreamer_tpu.core.errors import StreamError as JStreamError
        from nnstreamer_tpu.elements.repo import REPO as JREPO
        from nnstreamer_tpu.elements.repo import TensorRepoSink as JSink
        from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
        from nnstreamer_tpu_torch.elements.repo import REPO, TensorRepoSink
        from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

        texts = []
        for repo, sink_cls, buf_cls, err in (
                (JREPO, JSink, JBuf, JStreamError),
                (REPO, TensorRepoSink, TensorBuffer, StreamError)):
            repo.reset()
            sink = sink_cls(name="back", slot=77, put_timeout=0.4)
            if stopping:
                sink._stop_evt = threading.Event()
                sink._stop_evt.set()
            q = repo.slot(77)
            buf = buf_cls.of(np.zeros((2,), np.float32))
            while True:                        # fill to capacity (16)
                try:
                    q.put_nowait(buf)
                except _queue.Full:
                    break
            with pytest.raises(err, match="stopping" if stopping
                               else "slot 77") as e:
                sink.render(buf)
            texts.append(str(e.value))
            repo.reset()
        assert texts[1] == texts[0]

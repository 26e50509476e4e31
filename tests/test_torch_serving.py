"""The model store on the port's vision filter (nnstreamer_tpu_torch:
serving/store.py, serving/compile_cache.py, the torch backend's store
handle, tensor_filter's canary_seed, the `models` CLI) against the JAX
package's, on the CPU.

- `store://` grammar and the registry (aliases, @latest, builder=,
  version=, per-version stats, describe) give JAX's answers.
- Canary parity: both packages' backends serve ``store://p@2:0.25
  canary_seed=7`` over 64 frames, versions 1 and 2 `probe_scale` at
  scales 2 and 3, so each output names its version. Per frame, and with
  the frames split into the same compiled windows, the sequence of
  versions is JAX's frame for frame, and so are the per-version invoke
  and error counts. The windows a port pipeline formed (recorded from
  its backend) replayed on JAX's backend give the pipeline's sequence.
- A swap mid-stream: no torn frame, versions never go back, the report
  and stats show it; a pinned reference is immune; an incompatible
  version aborts before the flip; the swap barrier completes under
  traffic; conservation across the flip under injected faults.
- Prewarm: a prewarmed swap takes no batched-shape verdict on the hot
  path (the port's counterpart of JAX's zero recompiles); an unwarmed
  one does.
- The bucket manifest: the served buckets written, a "next process"
  replays them at warm start; its JSON rows are JAX's for the same
  buckets; off by default.

Models are the probe zoo models or tiny callables, so every version is
told apart by its output value alone.
"""

import json
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.xla import XLABackend
from nnstreamer_tpu.serving import compile_cache as jcc
from nnstreamer_tpu.serving import store as jstore
from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.serving import compile_cache
from nnstreamer_tpu_torch.serving.store import (
    get_store, parse_store_ref, reset_store)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer


def _v1(x):
    return (x * 2.0,)


def _v2(x):
    return (x * 3.0 + 10.0,)


V1 = 2.0    # value of v1 on an all-ones frame
V2 = 13.0   # value of v2 on an all-ones frame
ONES = np.ones((8, 1), np.float32)
#: the canary cell: versions 1 and 2 of `p` are probe_scale at 2 and 3
CANARY_REF = "store://p@2:0.25"
CANARY_SEED = 7
SCALE_OF = {2.0: 1, 3.0: 2}


@pytest.fixture(autouse=True)
def _fresh_store(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    store = reset_store()
    compile_cache.reset()
    jstore.reset_store()
    yield store
    reset_store()
    compile_cache.reset()
    jstore.reset_store()
    torch.set_num_threads(threads)


def _open(ref, **props):
    b = TorchBackend()
    b.open({"model": ref, "accelerator": "cpu", "canary_seed": 0, **props})
    return b


def _jopen(ref, **props):
    b = XLABackend()
    b.open({"model": ref, "accelerator": "", "canary_seed": 0, **props})
    return b


def _val(out) -> float:
    return float(np.asarray(out[0]).ravel()[0])


def _push_ones(src, n, shape=(4,)):
    for _ in range(n):
        src.push(TensorBuffer.of(np.ones(shape, np.float32)))


def _out_vals(sink):
    return [float(np.asarray(b.tensors[0]).ravel()[0]) for b in sink.results]


def _wait_for(cond, timeout=20.0, what="condition"):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, f"timed out waiting: {what}"
        time.sleep(0.01)


def _register_canary_pair():
    for st in (get_store(), jstore.get_store()):
        st.register("p", "zoo://probe_scale?scale=2")
        st.register("p", "zoo://probe_scale?scale=3")


# -- store:// reference grammar ----------------------------------------------

REFS = ["store://det", "store://det@latest", "store://det@3",
        "store://det@prod", "store://det@2:0.05", "store://det@", "zoo://det",
        "store://", "store://det@2:zzz", "store://det@2:1.5",
        "store://det@2:0", "store://det@latest:0.2"]


class TestParseStoreRef:
    @pytest.mark.parametrize("ref", REFS)
    def test_parse_matches_jax(self, ref):
        try:
            want = jstore.parse_store_ref(ref)
        except Exception as e:
            with pytest.raises(BackendError) as got:
                parse_store_ref(ref)
            assert str(got.value) == str(e)
            return
        got = parse_store_ref(ref)
        assert (got.name, got.version, got.canary_version,
                got.canary_ratio) == (want.name, want.version,
                                      want.canary_version, want.canary_ratio)

    def test_latest_and_alias(self):
        assert parse_store_ref("store://det@latest").version is None
        assert parse_store_ref("store://det@prod").version == "prod"
        r = parse_store_ref("store://det@2:0.05")
        assert (r.canary_version, r.canary_ratio, r.version) == \
            (2, 0.05, None)


# -- registry ----------------------------------------------------------------

class TestRegistry:
    def test_register_auto_versions_first_is_current(self, _fresh_store):
        store = _fresh_store
        assert store.register("det", _v1) == 1
        assert store.register("det", _v2) == 2
        assert store.entry("det").current == 1

    def test_update_default_latest(self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1)
        store.register("det", _v2)
        rep = store.update("det")
        assert (rep["from_version"], rep["to_version"]) == (1, 2)
        assert store.entry("det").current == 2
        assert store.entry("det").epoch == 1

    def test_duplicate_version_raises_naming_collision(self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1, version=3)
        with pytest.raises(BackendError, match=r"'det'@3.*immutable"):
            store.register("det", _v2, version=3)

    def test_alias_pins_and_latest_resolves(self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1)
        store.register("det", _v2)
        store.alias("det", "prod", 1)
        e = store.entry("det")
        assert e.resolve_version("prod") == 1
        assert e.resolve_version("latest") == e.resolve_version(None) == 1
        with pytest.raises(BackendError, match="no version alias"):
            e.resolve_version("staging")

    def test_alias_ref_serves_its_version(self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1)
        store.register("det", _v2)
        store.alias("det", "prod", 2)
        b = _open("store://det@prod")
        try:
            assert b.tracks_store_epoch is False
            assert _val(b.invoke((np.ones(4, np.float32),))) == V2
        finally:
            b.close()

    def test_builder_version_and_source(self, _fresh_store):
        store = _fresh_store
        built = []

        def build():
            built.append(1)
            return _v2

        assert store.register("det", builder=build, version=5,
                              source="lazy v2") == 5
        assert built == []                    # lazy until resolved
        d = store.describe("det")
        assert d["versions"][5] == {"source": "lazy v2", "built": False,
                                    "buckets": 0}
        b = _open("store://det@5")
        try:
            assert _val(b.invoke((np.ones(4, np.float32),))) == V2
            assert built == [1]
        finally:
            b.close()
        with pytest.raises(BackendError, match="exactly one"):
            store.register("det", _v1, builder=build)

    def test_unknown_name_lists_registered(self, _fresh_store):
        _fresh_store.register("det", _v1)
        with pytest.raises(BackendError, match="no model named 'nope'"):
            _fresh_store.entry("nope")

    def test_describe_matches_jax(self, _fresh_store):
        for st in (_fresh_store, jstore.get_store()):
            st.register("det", "zoo://probe_scale")
            st.register("det", "zoo://probe_negate")
            st.alias("det", "prod", 2)
            st.update("det")
            st.entry("det").record(1, 1e-3)
            st.entry("det").record(1, 2e-3, error=True)
        ours, theirs = _fresh_store.describe("det"), \
            jstore.get_store().describe("det")
        for d in (ours, theirs):
            for sw in d["swaps"]:
                sw.pop("ts")
        assert ours == theirs
        assert ours["stats"][1] == {"invokes": 2, "errors": 1,
                                    "p95_us": 1000.0}

    def test_zoo_builtin_seeds_as_version_zero(self, _fresh_store):
        e = _fresh_store.entry("mobilenet_v2")
        assert 0 in e.versions
        assert e.versions[0].source == "zoo://mobilenet_v2"
        assert _fresh_store.describe("mobilenet_v2")["versions"][0][
            "built"] is False
        from nnstreamer_tpu_torch.models.zoo import list_models

        assert {"probe_scale", "probe_negate", "probe_offset"} <= set(
            list_models())
        assert 0 in _fresh_store.entry("probe_negate").versions

    def test_store_ref_cannot_nest_as_version_source(self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1)
        store.register("indirect", "store://det")
        with pytest.raises(BackendError, match="cannot nest"):
            store.update("indirect")


# -- the probe models --------------------------------------------------------

@pytest.mark.parametrize("ref,want", [
    ("zoo://probe_scale", lambda x: x * 2.0),
    ("zoo://probe_scale?scale=3", lambda x: x * 3.0),
    ("zoo://probe_negate", lambda x: -x),
    ("zoo://probe_offset", lambda x: x + 10.0),
])
def test_probe_models_match_jax(ref, want):
    x = np.arange(8, dtype=np.float32).reshape(8, 1)
    b, jb = _open(ref), _jopen(ref)
    try:
        got = np.asarray(b.invoke((x,))[0])
        np.testing.assert_array_equal(got, np.asarray(jb.invoke((x,))[0]))
        np.testing.assert_array_equal(got, want(x))
        spec = b.get_model_info()[0]
        assert spec.to_strings() == jb.get_model_info()[0].to_strings()
    finally:
        b.close()
        jb.close()


# -- canary routing ----------------------------------------------------------

def _versions_per_frame(b, n=64):
    return [SCALE_OF[_val(b.invoke((ONES,)))] for _ in range(n)]


def _versions_windowed(b, sizes):
    """Frames split as `sizes` (1 = a per-frame invoke, K > 1 one
    compiled window of K) → each frame's version."""
    out = []
    for k in sizes:
        if k == 1:
            out.append(SCALE_OF[_val(b.invoke((ONES,)))])
        else:
            outs = b.invoke_window([(ONES,)] * k)
            out += [SCALE_OF[_val(o)] for o in outs]
    return out


#: 64 frames: per-frame invokes between windows of the scheduler's sizes
WINDOW_SIZES = [1, 1, 1, 1, 8, 8, 2, 1, 4, 8, 1, 1, 8, 4, 2, 8, 2, 1, 1, 1]


class TestCanary:
    def test_sequence_and_stats_match_jax_per_frame(self):
        _register_canary_pair()
        b = _open(CANARY_REF, canary_seed=CANARY_SEED)
        jb = _jopen(CANARY_REF, canary_seed=CANARY_SEED)
        try:
            ours, theirs = _versions_per_frame(b), _versions_per_frame(jb)
            assert ours == theirs
            assert 0 < ours.count(2) < 64
            strip = lambda vs: {v: (d["invokes"], d["errors"])
                                for v, d in vs.items()}
            assert strip(b.version_stats()) == strip(jb.version_stats())
        finally:
            b.close()
            jb.close()

    def test_sequence_and_stats_match_jax_windowed(self):
        assert sum(WINDOW_SIZES) == 64
        _register_canary_pair()
        b = _open(CANARY_REF, canary_seed=CANARY_SEED)
        jb = _jopen(CANARY_REF, canary_seed=CANARY_SEED)
        try:
            ours = _versions_windowed(b, WINDOW_SIZES)
            assert ours == _versions_windowed(jb, WINDOW_SIZES)
            # one draw a window: every window is one version
            i = 0
            for k in WINDOW_SIZES:
                assert len(set(ours[i:i + k])) == 1
                i += k
            strip = lambda vs: {v: (d["invokes"], d["errors"])
                                for v, d in vs.items()}
            assert strip(b.version_stats()) == strip(jb.version_stats())
            assert sum(d["invokes"] for d in b.version_stats().values()) \
                == 64
        finally:
            b.close()
            jb.close()

    def _pipeline_run(self, compiled_loop: bool):
        """64 frames through `tensor_filter model=store://p@2:0.25
        canary_seed=7` on the port → (versions by frame, the backend's
        calls in order: 1 a per-frame invoke, K a window)."""
        pipe = tnns.parse_launch(
            f"appsrc name=src dims=1:8 types=float32 ! tensor_filter "
            f"name=f model={CANARY_REF} canary_seed={CANARY_SEED} "
            f"compiled_loop={str(compiled_loop).lower()} ! "
            f"tensor_sink name=out")
        runner = tnns.PipelineRunner(pipe).start()
        be = pipe.get("f").backend
        calls = []
        inv, win = be.invoke, be.invoke_window

        def invoke(t):
            calls.append(1)
            return inv(t)

        def invoke_window(frames):
            calls.append(len(frames))
            return win(frames)

        be.invoke, be.invoke_window = invoke, invoke_window
        try:
            for _ in range(64):
                pipe.get("src").push(ONES)
            pipe.get("src").end()
            runner.wait(60)
        finally:
            runner.stop()
        vals = _out_vals(pipe.get("out"))
        assert len(vals) == 64 and sum(calls) == 64
        return [SCALE_OF[v] for v in vals], calls

    def test_pipeline_matches_jax_per_frame_and_windowed(self):
        import nnstreamer_tpu as jnns

        _register_canary_pair()
        jb = _jopen(CANARY_REF, canary_seed=CANARY_SEED)
        jw = _jopen(CANARY_REF, canary_seed=CANARY_SEED)
        try:
            seq, calls = self._pipeline_run(compiled_loop=False)
            assert calls == [1] * 64
            assert seq == _versions_per_frame(jb)
            # JAX's own pipeline, one invoke a frame, routes alike
            jpipe = jnns.parse_launch(
                f"appsrc name=src dims=1:8 types=float32 ! tensor_filter "
                f"model={CANARY_REF} canary_seed={CANARY_SEED} "
                f"compiled_loop=false ! tensor_sink name=out")
            jrun = jnns.PipelineRunner(jpipe).start()
            for _ in range(64):
                jpipe.get("src").push(ONES)
            jpipe.get("src").end()
            jrun.wait(60)
            jrun.stop()
            assert [SCALE_OF[v] for v in _out_vals(jpipe.get("out"))] == seq
            # with windows on: whatever windows the scheduler formed,
            # JAX's backend fed the same split routes every frame alike
            seq_w, calls_w = self._pipeline_run(compiled_loop=True)
            assert seq_w == _versions_windowed(jw, calls_w)
        finally:
            jb.close()
            jw.close()

    def test_ratio_deterministic_and_seed_dependent(self):
        _register_canary_pair()
        runs = {}
        for seed in (7, 7, 8):
            b = _open(CANARY_REF, canary_seed=seed)
            try:
                runs.setdefault(seed, []).append(
                    _versions_per_frame(b, 300))
            finally:
                b.close()
        assert runs[7][0] == runs[7][1] != runs[8][0]
        assert 0.15 < runs[7][0].count(2) / 300 < 0.35

    def test_canary_version_must_differ_from_base(self, _fresh_store):
        _fresh_store.register("det", _v1)
        with pytest.raises(BackendError, match="canary"):
            _open("store://det@1:0.25")

    def test_canary_graphs_kept_per_live_version(self):
        """Both live versions keep their own graph cache: windows that
        alternate between them never drop the other's (the card captures
        into them; here the bookkeeping), and a version leaving the live
        set takes its cache with it."""
        _register_canary_pair()
        get_store().register("p", "zoo://probe_scale?scale=4")
        b = _open(CANARY_REF, canary_seed=CANARY_SEED)
        try:
            assert sorted(b._vstates) == [1, 2]
            caches = {v: vs.graphs for v, vs in b._vstates.items()}
            _versions_windowed(b, WINDOW_SIZES)
            assert {v: vs.graphs for v, vs in b._vstates.items()} == caches
            get_store().update("p", 3)
            assert _val(b.invoke((ONES,))) in (3 * 1.0, 4.0)
            assert sorted(b._vstates) == [2, 3]
            assert b._vstates[2].graphs is caches[2]
        finally:
            b.close()


# -- hot swap mid-stream -----------------------------------------------------

class TestSwapMidStream:
    def _monotone(self, vals, n):
        assert len(vals) == n
        assert set(vals) == {V1, V2}
        flip = vals.index(V2)
        assert all(v == V1 for v in vals[:flip])
        assert all(v == V2 for v in vals[flip:])

    def test_no_torn_version_and_report(self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1)
        store.register("det", _v2)
        pipe = tnns.parse_launch(
            "appsrc name=src dims=4 types=float32 ! "
            "tensor_filter name=f model=store://det ! tensor_sink name=out")
        runner = tnns.PipelineRunner(pipe, trace=True).start()
        src, sink = pipe.get("src"), pipe.get("out")
        try:
            _push_ones(src, 10)
            _wait_for(lambda: len(sink.results) >= 10, what="v1 frames")
            rep = store.update("det")
            _push_ones(src, 10)
            src.end()
            runner.wait(30)
        finally:
            runner.stop()
        assert rep["prewarmed_buckets"] >= 1
        self._monotone(_out_vals(sink), 20)
        report = runner.report()
        assert "model swaps" in report and "v1 → v2" in report
        st = runner.stats()["f"]
        assert st["backend_v1_invokes"] == 10
        assert st["backend_v2_invokes"] == 10
        assert st["backend_swaps"] == 1

    def test_swap_with_windows_on_never_goes_back(self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1)
        store.register("det", _v2)
        pipe = tnns.parse_launch(
            "appsrc name=src dims=4 types=float32 ! "
            "tensor_filter name=f model=store://det ! tensor_sink name=out")
        runner = tnns.PipelineRunner(pipe).start()
        src, sink = pipe.get("src"), pipe.get("out")
        try:
            _push_ones(src, 40)
            _wait_for(lambda: len(sink.results) >= 5, what="first frames")
            store.update("det", wait_s=None)
            _push_ones(src, 40)
            src.end()
            runner.wait(30)
        finally:
            runner.stop()
        self._monotone(_out_vals(sink), 80)
        st = runner.stats()["f"]
        assert st["backend_v1_invokes"] + st["backend_v2_invokes"] == 80

    def test_swap_through_dyn_batch_path(self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1)
        store.register("det", _v2)
        pipe = tnns.parse_launch(
            "appsrc name=src dims=4 types=float32 ! "
            "tensor_batch max-batch=4 max-latency-ms=20 ! "
            "tensor_filter model=store://det ! tensor_unbatch ! "
            "tensor_sink name=out")
        runner = tnns.PipelineRunner(pipe).start()
        src, sink = pipe.get("src"), pipe.get("out")
        try:
            _push_ones(src, 12)
            _wait_for(lambda: len(sink.results) >= 12, what="v1 frames")
            store.update("det")
            _push_ones(src, 12)
            src.end()
            runner.wait(30)
        finally:
            runner.stop()
        self._monotone(_out_vals(sink), 24)

    def test_pinned_ref_is_immune_to_swap(self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1)
        store.register("det", _v2)
        b = _open("store://det@1")
        try:
            assert b.tracks_store_epoch is False
            store.update("det")
            assert not b.swap_pending()
            assert _val(b.invoke((np.ones(4, np.float32),))) == V1
            assert b.swap_count == 0
        finally:
            b.close()

    def test_swap_pending_until_adopted(self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1)
        store.register("det", _v2)
        b = _open("store://det")
        try:
            assert not b.swap_pending()
            store.update("det")
            assert b.swap_pending()          # the compiled loop's bail
            assert _val(b.invoke((np.ones(4, np.float32),))) == V2
            assert not b.swap_pending() and b.swap_count == 1
        finally:
            b.close()

    def test_swap_barrier_completes_under_traffic(self, _fresh_store):
        """The barrier completes while frames flow: a pusher keeps
        feeding frames until update() has returned."""
        import threading

        store = _fresh_store
        store.register("det", _v1)
        store.register("det", _v2)
        pipe = tnns.parse_launch(
            "appsrc name=src dims=4 types=float32 ! "
            "tensor_filter name=f model=store://det ! tensor_sink name=out")
        runner = tnns.PipelineRunner(pipe).start()
        src, sink = pipe.get("src"), pipe.get("out")
        done = threading.Event()

        def push():
            while not done.is_set():
                _push_ones(src, 1)
                time.sleep(0.002)

        pusher = threading.Thread(target=push)
        pusher.start()
        try:
            _wait_for(lambda: len(sink.results) >= 5, what="traffic")
            rep = store.update("det", wait_s=10.0)
        finally:
            done.set()
            pusher.join(10)
            src.end()
            runner.wait(30)
            runner.stop()
        assert rep["barrier_ok"] is True
        assert pipe.get("f").backend.adopted_epoch == rep["epoch"]
        vals = _out_vals(sink)
        assert vals[-1] == V2 and vals[0] == V1

    def test_conservation_across_flip_under_faults(self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1)
        store.register("det", _v2)
        pipe = tnns.parse_launch(
            "appsrc name=src dims=4 types=float32 ! "
            "tensor_fault name=flt mode=raise probability=0.08 seed=7 "
            "error-policy=skip ! "
            "tensor_filter model=store://det ! tensor_sink name=out")
        runner = tnns.PipelineRunner(pipe).start()
        src, sink = pipe.get("src"), pipe.get("out")
        try:
            _push_ones(src, 40)
            _wait_for(lambda: len(sink.results) >= 20, what="pre-swap flow")
            store.update("det")
            _push_ones(src, 40)
            src.end()
            runner.wait(30)
        finally:
            runner.stop()
        st = runner.stats()["flt"]
        assert len(sink.results) + st["skipped"] + st["dropped"] == 80
        assert st["errors"] > 0 and st["skipped"] == st["errors"]
        vals = _out_vals(sink)
        assert set(vals) <= {V1, V2} and V2 in vals


# -- prewarm -----------------------------------------------------------------

class TestPrewarm:
    def _serve_buckets(self, b):
        """Serve two micro-batch buckets and one fixed bucket → the value
        every frame got (all-ones input)."""
        vals = set()
        for n in (3, 6):
            out = b.invoke_batched((np.ones((n, 4), np.float32),), n,
                                   keepdims=(False,))
            vals.add(float(np.asarray(out[0])[0, 0]))
        vals.add(_val(b.invoke((np.ones(4, np.float32),))))
        assert len(vals) == 1
        return vals.pop()

    def test_prewarmed_swap_takes_no_verdict_on_the_hot_path(
            self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1)
        b = _open("store://det")
        try:
            assert self._serve_buckets(b) == V1
            store.register("det", _v2)
            rep = store.update("det")
            assert rep["prewarmed_buckets"] == 3
            v0 = b.batch_verdicts
            assert self._serve_buckets(b) == V2
            assert b.batch_verdicts == v0
            assert b.swap_count == 1
            assert sorted(b._vstates) == [2]     # v1 retired
        finally:
            b.close()

    def test_unwarmed_swap_takes_verdicts_after_the_flip(self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1)
        b = _open("store://det")
        try:
            self._serve_buckets(b)
            store.register("det", _v2)
            rep = store.update("det", prewarm=False)
            assert rep["prewarmed_buckets"] == 0
            v0 = b.batch_verdicts
            assert self._serve_buckets(b) == V2
            assert b.batch_verdicts == v0 + 2
        finally:
            b.close()

    def test_incompatible_version_aborts_before_flip(self, _fresh_store):
        store = _fresh_store
        store.register("det", _v1)
        b = _open("store://det")
        try:
            self._serve_buckets(b)

            def bad(x):
                return (x @ torch.ones(5, 5),)     # wrong shape

            store.register("det", bad)
            with pytest.raises(BackendError, match="swap aborted"):
                store.update("det")
            assert store.entry("det").current == 1
            assert self._serve_buckets(b) == V1
            assert b.swap_count == 0
        finally:
            b.close()

    def test_residency_hooks(self, _fresh_store):
        store = _fresh_store
        store.register("det", "zoo://probe_scale")
        b = _open("store://det")
        try:
            assert b.resident_bytes() == 4          # one f32 scale
            assert b.jit_cache_size() == 0
            self._serve_buckets_probe(b)
            n = b.jit_cache_size()
            assert n == 2                           # two batched verdicts
            assert b.release_compiled() == n
            assert b.jit_cache_size() == 0
            # released is never wrong: the verdicts come back
            self._serve_buckets_probe(b)
            assert b.jit_cache_size() == 2
        finally:
            b.close()

    @staticmethod
    def _serve_buckets_probe(b):
        for n in (3, 6):
            out = b.invoke_batched((np.ones((n, 8, 1), np.float32),), n,
                                   keepdims=(False,))
            assert float(np.asarray(out[0])[0, 0, 0]) == 2.0


# -- the bucket manifest -----------------------------------------------------

BUCKETS = [("fix", ((4,), "float32")),
           ("dynb", 4, ((4, 4), "float32")),
           ("dynb", 8, ((8, 224, 224, 3), "uint8"), ((8, 2), "int32")),
           ("bat", 2, (3, 4)), ("seq", (1, 4))]


class TestCompileCache:
    @pytest.mark.parametrize("bk", BUCKETS, ids=lambda b: b[0])
    def test_manifest_rows_match_jax(self, bk):
        row = compile_cache._bucket_to_json(bk)
        assert row == jcc._bucket_to_json(bk)
        if row is not None:
            assert compile_cache._bucket_from_json(row) == bk

    def test_manifest_roundtrip_and_warm_start(self, _fresh_store, tmp_path,
                                               monkeypatch):
        monkeypatch.setenv("NNSTREAMER_TPU_TORCH_SERVING_COMPILE_CACHE", "1")
        monkeypatch.setenv("NNSTREAMER_TPU_TORCH_SERVING_COMPILE_CACHE_DIR",
                           str(tmp_path))
        compile_cache.reset()
        store = _fresh_store
        store.register("det", _v1)
        b = _open("store://det")
        b.invoke_batched((np.ones((3, 4), np.float32),), 3,
                         keepdims=(False,))
        b.invoke((np.ones(4, np.float32),))
        b.close()
        with open(tmp_path / "manifest.json") as f:
            man = json.load(f)
        assert sorted(r["kind"] for r in man["det@1"]) == ["dynb", "fix"]

        # "next process": a fresh store and backend replay the manifest
        store = reset_store()
        store.register("det", _v1)
        b2 = _open("store://det")
        try:
            assert b2.warm_start() == 2
            v0 = b2.batch_verdicts
            out = b2.invoke_batched((np.ones((3, 4), np.float32),), 3,
                                    keepdims=(False,))
            assert float(np.asarray(out[0])[0, 0]) == V1
            assert b2.batch_verdicts == v0      # warm start took it
        finally:
            b2.close()

    def test_filter_start_runs_warm_start(self, _fresh_store, tmp_path,
                                          monkeypatch):
        monkeypatch.setenv("NNSTREAMER_TPU_TORCH_SERVING_COMPILE_CACHE", "1")
        monkeypatch.setenv("NNSTREAMER_TPU_TORCH_SERVING_COMPILE_CACHE_DIR",
                           str(tmp_path))
        compile_cache.reset()
        _fresh_store.register("det", "zoo://probe_scale")
        compile_cache.record_bucket("det", 1, ("fix", ((8, 1), "float32")))
        calls = []
        warm = TorchBackend.warm_start

        def spy(self):
            calls.append(warm(self))
            return calls[-1]

        monkeypatch.setattr(TorchBackend, "warm_start", spy)
        pipe = tnns.parse_launch(
            "appsrc name=src dims=1:8 types=float32 ! tensor_filter "
            "model=store://det ! tensor_sink name=out")
        runner = tnns.PipelineRunner(pipe).start()
        pipe.get("src").push(ONES)
        pipe.get("src").end()
        runner.wait(30)
        runner.stop()
        assert calls == [1]
        assert _out_vals(pipe.get("out")) == [2.0]

    def test_llm_executor_replays_its_buckets(self, _fresh_store, tmp_path,
                                              monkeypatch):
        """tensor_llm's executor records its prefill/chunk/decode buckets
        and a fresh executor on the same version replays them at warm
        start (each bucket's first run off the hot path)."""
        monkeypatch.setenv("NNSTREAMER_TPU_TORCH_SERVING_COMPILE_CACHE", "1")
        monkeypatch.setenv("NNSTREAMER_TPU_TORCH_SERVING_COMPILE_CACHE_DIR",
                           str(tmp_path))
        compile_cache.reset()
        from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
        from nnstreamer_tpu_torch.llm import LLMEngine
        from nnstreamer_tpu_torch.models import transformer as tt

        params = tt.init_params(vocab=61, d_model=32, n_layers=2, n_heads=4,
                                n_kv_heads=2, seed=0)
        _fresh_store.register("tiny_llm", ModelBundle(fn=None, params=params))
        kw = dict(n_heads=4, block_size=4, num_blocks=32, max_batch=4,
                  max_len=64)
        eng = LLMEngine("store://tiny_llm", **kw)
        eng.submit(np.array([5, 17, 33, 2, 9], np.int32), max_new_tokens=3)
        eng.drain()
        rows = json.loads((tmp_path / "manifest.json").read_text())
        kinds = sorted({r["kind"] for r in rows["tiny_llm@1"]})
        assert "decode" in kinds and len(kinds) >= 2
        fresh = LLMEngine("store://tiny_llm", **kw)
        assert fresh.executor.warm_start() == len(rows["tiny_llm@1"])
        assert fresh.executor.warm_start() == 0    # already warm

    def test_disabled_by_default(self, _fresh_store):
        assert compile_cache.maybe_enable_compile_cache() is False
        assert compile_cache.cache_dir() is None
        _fresh_store.register("det", _v1)
        b = _open("store://det")
        try:
            b.invoke((np.ones(4, np.float32),))
            assert b.warm_start() == 0
        finally:
            b.close()


# -- guard rails and the CLI -------------------------------------------------

class TestGuards:
    def test_reload_on_store_filter_points_to_update(self, _fresh_store):
        _fresh_store.register("det", _v1)
        b = _open("store://det")
        try:
            with pytest.raises(BackendError, match="ModelStore.update"):
                b.reload(_v2)
        finally:
            b.close()

    def test_shared_key_rejected(self, _fresh_store):
        _fresh_store.register("det", _v1)
        with pytest.raises(BackendError, match="shared-tensor-filter-key"):
            _open("store://det", shared_tensor_filter_key="k")

    def test_store_params_not_moved_in_place(self, _fresh_store):
        """A version's params are every handle's: a handle on another
        device copies them before it moves them."""
        lin = torch.nn.Linear(4, 4)
        from nnstreamer_tpu_torch.backends.torch_backend import (
            ModelBundle, params_copy_to)

        _fresh_store.register("lin", ModelBundle(
            fn=lambda m, x: m(x), params=lin))
        b = _open("store://lin")
        try:
            assert b._params is lin                 # same device: shared
            moved = params_copy_to(lin, torch.device("meta"))
            assert moved is not lin and lin.weight.device.type == "cpu"
        finally:
            b.close()

    def test_cli_models_list_describe_swap(self, _fresh_store, capsys):
        from nnstreamer_tpu_torch.__main__ import main

        _fresh_store.register("det", _v1)
        assert main(["models", "list"]) == 0
        out = capsys.readouterr().out
        assert "store://det" in out and "store://probe_scale" in out
        assert main(["models", "describe", "det"]) == 0
        assert '"current": 1' in capsys.readouterr().out
        assert main(["models", "swap", "det", "1"]) == 0
        assert '"to_version": 1' in capsys.readouterr().out

    def test_filter_props_include_canary_seed(self):
        from nnstreamer_tpu.elements import TensorFilter as JFilter
        from nnstreamer_tpu_torch.elements import TensorFilter as TFilter

        assert "canary_seed" in TFilter.PROPS
        assert TFilter.PROPS["canary_seed"].default == \
            JFilter.PROPS["canary_seed"].default

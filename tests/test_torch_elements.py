"""The port's routing, aggregator, control and repo elements
(nnstreamer_tpu_torch/elements/{routing,aggregator,control,repo}.py)
against the JAX package's, on the CPU.

Each copied test builds the same graph in both packages from the same
numpy inputs, keeps the JAX test's assertions on the port's run, and
holds the port's sink results to JAX's bit for bit (count, pts, dtype,
shape, bytes): the host data movement is the JAX package's. Copied from
tests/test_elements.py (merge, demux, split, tee/join, aggregator,
tensor_if and its range/fill/repeat cases, tensor_rate and its QoS
throttle, crop, the repo loop, sparse) and tests/test_pipelines.py (the
tee/queue/mux DSL pipeline, the split/merge negative cases). The repo
loop runs each package's own backend on a callable model where the JAX
test uses framework=custom (not ported yet). Not copied: wall-clock
assertions.

New here: tensor_merge in all four sync modes of `_SyncCollect` fed one
arrival sequence (element by element, no scheduler timing); tensor
inputs beside host arrays into tensor_merge, tensor_aggregator and join
(`buffer.concatenate` moves host arrays to the tensor's device, never
the reverse; all-host input stays numpy); a tee whose one branch
transforms while the other's data stays unchanged; tensor_if's
decisions on tensors (a_value and average, integer and float) equal to
the host decisions; the repo loop's teardown with a blocked source.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu.elements as jel
import nnstreamer_tpu_torch as tnns
import nnstreamer_tpu_torch.elements as tel
from nnstreamer_tpu.elements import routing as jroute
from nnstreamer_tpu.tensor import buffer as jbuffer
from nnstreamer_tpu.tensor import dtypes as jdtypes
from nnstreamer_tpu.tensor import info as jinfo
from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
from nnstreamer_tpu_torch.core.errors import (
    NegotiationError, PipelineError, StreamError)
from nnstreamer_tpu_torch.elements import routing as troute
from nnstreamer_tpu_torch.tensor import buffer as tbuffer
from nnstreamer_tpu_torch.tensor import dtypes as tdtypes
from nnstreamer_tpu_torch.tensor import info as tinfo

JAX = SimpleNamespace(nns=jnns, el=jel, Buf=jbuffer.TensorBuffer,
                      DType=jdtypes.DType, Info=jinfo.TensorInfo,
                      Spec=jinfo.TensorsSpec, Format=jinfo.TensorFormat,
                      route=jroute)
PORT = SimpleNamespace(nns=tnns, el=tel, Buf=tbuffer.TensorBuffer,
                       DType=tdtypes.DType, Info=tinfo.TensorInfo,
                       Spec=tinfo.TensorsSpec, Format=tinfo.TensorFormat,
                       route=troute)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def spec_of(P, *shapes, dtype="FLOAT32"):
    return P.Spec.of(*(P.Info(s, getattr(P.DType, dtype)) for s in shapes))


def buf(P, val, shape=(2, 2), pts=0, dtype=np.float32):
    return P.Buf.of(np.full(shape, val, dtype), pts=pts)


def run_graph(P, elements, links, pushes, timeout=30):
    """Build/run a pipeline; pushes = {src_name: [buffers]} (callables of
    P are called, so one list serves both packages)."""
    pipe = P.nns.Pipeline()
    for e in elements:
        pipe.add(e)
    for a, b, *pads in links:
        pipe.link(a, b, *(pads or []))
    runner = P.nns.PipelineRunner(pipe)
    runner.start()
    for name, bufs in pushes.items():
        src = pipe.get(name)
        for b in bufs:
            src.push(b(P) if callable(b) else b)
        src.end()
    runner.wait(timeout)
    runner.stop()
    return pipe


def host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def same_results(got, ref):
    """Sink results bit for bit: count, pts, format, meta keys, dtype,
    shape and bytes of every tensor."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.pts == r.pts
        assert g.format.name == r.format.name
        assert g.num_tensors == r.num_tensors
        for a, b in zip(g.tensors, r.tensors):
            a, b = host(a), host(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def both(case):
    """Run `case(P)` → sink results for each package; assert the port's
    equal JAX's bit for bit; → (port's, JAX's)."""
    ref = case(JAX)
    got = case(PORT)
    if isinstance(ref, dict):
        for k in ref:
            same_results(got[k], ref[k])
    else:
        same_results(got, ref)
    return got, ref


# -- merge / demux / split / tee / join -------------------------------------

def test_merge_concat_axis():
    def case(P):
        a = P.el.AppSrc(spec=spec_of(P, (2, 3)), name="a")
        b = P.el.AppSrc(spec=spec_of(P, (2, 5)), name="b")
        merge = P.el.TensorMerge(name="m", option="1", sync_mode="nosync")
        sink = P.el.TensorSink(name="s")
        run_graph(P, [a, b, merge, sink],
                  [(a, merge, 0, 0), (b, merge, 0, 1), (merge, sink)],
                  {"a": [buf(P, 1, (2, 3))], "b": [buf(P, 2, (2, 5))]})
        assert merge.out_specs[0].tensors[0].shape == (2, 8)
        return sink.results

    got, _ = both(case)
    out = got[0].tensors[0]
    assert out.shape == (2, 8)
    np.testing.assert_array_equal(out[:, :3], np.full((2, 3), 1))


def test_demux_tensorpick_reorder():
    def case(P):
        src = P.el.AppSrc(spec=spec_of(P, (1,), (2,), (3,)), name="src")
        demux = P.el.TensorDemux(name="d", tensorpick="2,0")
        s1, s2 = P.el.TensorSink(name="s1"), P.el.TensorSink(name="s2")
        three = P.Buf.of(np.zeros((1,), np.float32), np.ones((2,), np.float32),
                         np.full((3,), 2, np.float32), pts=0)
        run_graph(P, [src, demux, s1, s2],
                  [(src, demux), (demux, s1, 0, 0), (demux, s2, 1, 0)],
                  {"src": [three]})
        return {"s1": s1.results, "s2": s2.results}

    got, _ = both(case)
    assert got["s1"][0].tensors[0].shape == (3,)
    assert got["s2"][0].tensors[0].shape == (1,)


def test_split_segments():
    arr = np.arange(16, dtype=np.float32).reshape(2, 8)

    def case(P):
        src = P.el.AppSrc(spec=spec_of(P, (2, 8)), name="src")
        split = P.el.TensorSplit(name="sp", tensorseg="3:5", axis=1)
        s1, s2 = P.el.TensorSink(name="s1"), P.el.TensorSink(name="s2")
        run_graph(P, [src, split, s1, s2],
                  [(src, split), (split, s1, 0, 0), (split, s2, 1, 0)],
                  {"src": [P.Buf.of(arr, pts=0)]})
        return {"s1": s1.results, "s2": s2.results}

    got, _ = both(case)
    np.testing.assert_array_equal(got["s1"][0].tensors[0], arr[:, :3])
    np.testing.assert_array_equal(got["s2"][0].tensors[0], arr[:, 3:])


def test_split_then_merge_roundtrip():
    arr = np.arange(24, dtype=np.float32).reshape(4, 6)

    def case(P):
        src = P.el.AppSrc(spec=spec_of(P, (4, 6)), name="src")
        split = P.el.TensorSplit(name="sp", tensorseg="2:4", axis=1)
        merge = P.el.TensorMerge(name="mg", option="1", sync_mode="nosync")
        sink = P.el.TensorSink(name="s")
        run_graph(P, [src, split, merge, sink],
                  [(src, split), (split, merge, 0, 0), (split, merge, 1, 1),
                   (merge, sink)],
                  {"src": [P.Buf.of(arr, pts=0)]})
        return sink.results

    got, _ = both(case)
    np.testing.assert_array_equal(got[0].tensors[0], arr)


def test_tee_duplicates_and_join_rejoins():
    def case(P):
        src = P.el.AppSrc(spec=spec_of(P, (2,)), name="src")
        tee, j = P.el.Tee(name="t"), P.el.Join(name="j")
        sink = P.el.TensorSink(name="s")
        run_graph(P, [src, tee, j, sink],
                  [(src, tee), (tee, j, 0, 0), (tee, j, 1, 1), (j, sink)],
                  {"src": [buf(P, 5, (2,))]})
        return sink.results

    got, _ = both(case)
    assert len(got) == 2  # both branches delivered


def test_tee_branch_transform_leaves_other_branch_unchanged():
    """A tee hands both branches the same tensor object; the transform on
    one branch makes new tensors, so the other branch's data is the
    input's, on the host and for a CPU tensor alike."""
    frame = np.arange(8, dtype=np.float32).reshape(2, 4)
    desc = ("appsrc name=src dims=4:2 types=float32 ! tee name=t "
            "t. ! queue ! tensor_transform mode=arithmetic option=mul:3.0 ! "
            "tensor_sink name=scaled "
            "t. ! queue ! tensor_sink name=raw to-host=false")
    outs = {}
    for P in (JAX, PORT):
        pipe = P.nns.parse_launch(desc)
        runner = P.nns.PipelineRunner(pipe).start()
        src = pipe.get("src")
        src.push(P.Buf.of(frame.copy(), pts=0))
        if P is PORT:
            src.push(P.Buf.of(torch.from_numpy(frame.copy()), pts=1))
        src.end()
        runner.wait(30)
        runner.stop()
        outs[P.nns.__name__] = (pipe.get("scaled").results,
                                pipe.get("raw").results)
    scaled, raw = outs["nnstreamer_tpu_torch"]
    same_results(scaled[:1], outs["nnstreamer_tpu"][0])
    same_results(raw[:1], outs["nnstreamer_tpu"][1])
    for r in raw:
        np.testing.assert_array_equal(host(r.tensors[0]), frame)
    for s in scaled:
        np.testing.assert_array_equal(host(s.tensors[0]), frame * 3)
    assert isinstance(raw[1].tensors[0], torch.Tensor)


@pytest.mark.parametrize("mode,option", [
    ("nosync", ""), ("slowest", ""), ("refresh", ""), ("basepad", "0:6"),
    ("basepad", "1")])
def test_merge_sync_modes_match_jax(mode, option):
    """tensor_merge through `_SyncCollect` in each mode, one arrival
    sequence with PTS over 3 pads: the same merged tensors with the same
    PTS, element by element and at EOS."""
    arrivals = [(0, 0), (1, 5), (0, 10), (2, 3), (0, 20), (1, 18), (2, 21),
                (0, 30), (2, 29), (1, 33), (1, 40), (0, 41), (2, 45), (0, 50)]
    traces = []
    for P in (JAX, PORT):
        m = P.el.TensorMerge(name="m", option="0", sync_mode=mode,
                             sync_option=option)
        m.negotiate([spec_of(P, (1, 2))] * 3)
        out = []
        for pad, pts in arrivals:
            b = P.Buf.of(np.full((1, 2), pad * 1000 + pts, np.float32),
                         pts=pts)
            out += [("process", p, e.pts, host(e.tensors[0]).tolist())
                    for p, e in m.process(pad, b)]
        out += [("flush", p, e.pts, host(e.tensors[0]).tolist())
                for p, e in m.flush()]
        traces.append(out)
    assert traces[1] == traces[0]
    assert traces[1]


def test_merge_and_join_mixed_host_and_tensor_inputs():
    """A tensor on one pad, a host array on the other: the merge runs in
    torch on the tensor's device with the host array moved there, and
    equals JAX's all-host merge; all-host input stays numpy. join passes
    each buffer as it came."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.arange(10, dtype=np.float32).reshape(2, 5) + 100
    jm = JAX.el.TensorMerge(name="m", option="1", sync_mode="nosync")
    jm.negotiate([spec_of(JAX, (2, 3)), spec_of(JAX, (2, 5))])
    jm.process(0, JAX.Buf.of(a, pts=1))
    ((_, ref),) = jm.process(1, JAX.Buf.of(b, pts=2))
    for first, second, kind in ((a, torch.from_numpy(b), torch.Tensor),
                                (torch.from_numpy(a), b, torch.Tensor),
                                (a, b, np.ndarray)):
        m = PORT.el.TensorMerge(name="m", option="1", sync_mode="nosync")
        m.negotiate([spec_of(PORT, (2, 3)), spec_of(PORT, (2, 5))])
        m.process(0, PORT.Buf.of(first, pts=1))
        ((_, got),) = m.process(1, PORT.Buf.of(second, pts=2))
        assert isinstance(got.tensors[0], kind)
        assert got.pts == ref.pts == 2
        assert host(got.tensors[0]).tobytes() == \
            np.asarray(ref.tensors[0]).tobytes()
    # bfloat16 host array beside a bfloat16 tensor (host_tensor reads it)
    import ml_dtypes

    hb = a.astype(ml_dtypes.bfloat16)
    out = tbuffer.concatenate([hb, torch.from_numpy(b).to(torch.bfloat16)],
                              1)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out[:, :3].float().numpy(),
                                  hb.astype(np.float32))
    # join: whatever arrives goes out unchanged
    j = PORT.el.Join(name="j")
    j.negotiate([spec_of(PORT, (2, 3))] * 2)
    t = torch.from_numpy(a)
    assert j.process(0, PORT.Buf.of(a, pts=0))[0][1].tensors[0] is a
    assert j.process(1, PORT.Buf.of(t, pts=1))[0][1].tensors[0] is t


def test_concatenate_refuses_two_devices(monkeypatch):
    a, b = torch.zeros(2), torch.zeros(2)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda s: torch.device(
                            "cuda:1" if s is b else "cpu")), raising=False)
    with pytest.raises(PipelineError, match="one device"):
        tbuffer.on_one_side([a, b])


# -- aggregator --------------------------------------------------------------

def test_aggregator_tumbling_window():
    def case(P):
        src = P.el.AppSrc(spec=spec_of(P, (1, 4)), name="src")
        agg = P.el.TensorAggregator(name="agg", frames_out=3, frames_dim=0)
        sink = P.el.TensorSink(name="s")
        bufs = [P.Buf.of(np.full((1, 4), i, np.float32), pts=i)
                for i in range(7)]
        run_graph(P, [src, agg, sink], [(src, agg), (agg, sink)],
                  {"src": bufs})
        assert agg.out_specs[0].tensors[0].shape == (3, 4)
        return sink.results

    res, _ = both(case)
    assert len(res) == 2  # 7 frames → 2 windows of 3, 1 leftover dropped
    np.testing.assert_array_equal(res[0].tensors[0][:, 0], [0, 1, 2])
    np.testing.assert_array_equal(res[1].tensors[0][:, 0], [3, 4, 5])


def test_aggregator_sliding_window():
    def case(P):
        src = P.el.AppSrc(spec=spec_of(P, (1, 2)), name="src")
        agg = P.el.TensorAggregator(name="agg", frames_out=2, frames_flush=1,
                                    frames_dim=0)
        sink = P.el.TensorSink(name="s")
        bufs = [P.Buf.of(np.full((1, 2), i, np.float32), pts=i)
                for i in range(4)]
        run_graph(P, [src, agg, sink], [(src, agg), (agg, sink)],
                  {"src": bufs})
        return sink.results

    res, _ = both(case)
    # windows: [0,1] [1,2] [2,3]
    assert len(res) == 3
    np.testing.assert_array_equal(res[1].tensors[0][:, 0], [1, 2])


@pytest.mark.parametrize("fin,fout,flush", [(1, 4, 2), (2, 3, 0), (1, 2, 3)])
def test_aggregator_windows_and_rate_match_jax(fin, fout, flush):
    """Windows over frames_in/out/flush, host frames and tensor frames
    mixed (a window holding both is a tensor): each window is bit for
    bit JAX's, the negotiated rate JAX's."""
    from fractions import Fraction

    outs, rates = [], []
    for P in (JAX, PORT):
        agg = P.el.TensorAggregator(name="a", frames_in=fin, frames_out=fout,
                                    frames_flush=flush, frames_dim=0)
        (spec,) = agg.negotiate([P.Spec.of(
            P.Info((2 * fin, 3), P.DType.FLOAT32), rate=Fraction(30))])
        rates.append((spec.rate, spec.tensors[0].shape))
        out = []
        for i in range(9):
            x = np.arange(6 * fin, dtype=np.float32).reshape(2 * fin, 3) + i
            if P is PORT and i % 2:
                x = torch.from_numpy(x)
            for _, b in agg.process(0, P.Buf.of(x, pts=i)):
                out.append((b.pts, host(b.tensors[0]).tobytes()))
        outs.append(out)
    assert rates[1] == rates[0]
    assert outs[1] == outs[0] and outs[0]


# -- tensor_if ---------------------------------------------------------------

def test_tensor_if_then_else_branching():
    def case(P):
        src = P.el.AppSrc(spec=spec_of(P, (2,)), name="src")
        tif = P.el.TensorIf(name="if", compared_value="a_value",
                            compared_value_option="0:0", operator="gt",
                            supplied_value=5.0, then="passthrough",
                            else_="passthrough")
        st, se = P.el.TensorSink(name="st"), P.el.TensorSink(name="se")
        run_graph(P, [src, tif, st, se],
                  [(src, tif), (tif, st, 0, 0), (tif, se, 1, 0)],
                  {"src": [buf(P, 9, (2,), pts=0), buf(P, 1, (2,), pts=1)]})
        return {"st": st.results, "se": se.results}

    got, _ = both(case)
    assert len(got["st"]) == 1 and len(got["se"]) == 1
    np.testing.assert_array_equal(got["st"][0].tensors[0], [9, 9])
    np.testing.assert_array_equal(got["se"][0].tensors[0], [1, 1])


def test_tensor_if_average_fill_zero():
    def case(P):
        src = P.el.AppSrc(spec=spec_of(P, (4,)), name="src")
        tif = P.el.TensorIf(name="if", compared_value="average",
                            compared_value_option="0", operator="ge",
                            supplied_value=2.0, then="fill_zero",
                            else_="skip")
        sink = P.el.TensorSink(name="s")
        run_graph(P, [src, tif, sink], [(src, tif), (tif, sink)],
                  {"src": [buf(P, 3, (4,), pts=0), buf(P, 1, (4,), pts=1)]})
        return sink.results

    got, _ = both(case)
    assert len(got) == 1  # second skipped
    np.testing.assert_array_equal(got[0].tensors[0], np.zeros(4))


def test_tensor_if_custom_condition():
    def case(P):
        P.el.register_if_condition("evens",
                                   lambda b: int(b.pts or 0) % 2 == 0)
        src = P.el.AppSrc(spec=spec_of(P, (1,)), name="src")
        tif = P.el.TensorIf(name="if", compared_value="custom",
                            compared_value_option="evens")
        sink = P.el.TensorSink(name="s")
        run_graph(P, [src, tif, sink], [(src, tif), (tif, sink)],
                  {"src": [buf(P, i, (1,), pts=i) for i in range(5)]})
        return sink.results

    got, _ = both(case)
    assert len(got) == 3  # pts 0,2,4


OPS = ["eq", "ne", "gt", "ge", "lt", "le", "range_inclusive",
       "range_exclusive", "not_in_range_inclusive", "not_in_range_exclusive"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("mode", ["a_value", "average"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32])
def test_tensor_if_decisions_match_jax(op, mode, dtype):
    """All 10 operators, a_value and average, on host arrays (decided
    by the JAX element's own host code, so bit for bit) and on tensors
    (the tensor's mean in float32, values away from the threshold):
    every frame routed as JAX routes it."""
    rng = np.random.default_rng(7)
    sv = "3:6" if op.startswith(("range", "not_in")) else "4"
    frames = [rng.integers(0, 10, size=(2, 3)).astype(dtype)
              for _ in range(24)]
    frames += [np.full((2, 3), v, dtype) for v in (3, 4, 6)]
    opt = "0:4" if mode == "a_value" else "0"
    routes = []
    for P, wrap in ((JAX, None), (PORT, None), (PORT, torch.from_numpy)):
        tif = P.el.TensorIf(name="i", compared_value=mode,
                            compared_value_option=opt, operator=op,
                            supplied_value=sv, then="passthrough",
                            else_="passthrough")
        tif.negotiate([spec_of(P, (2, 3))])
        tif.out_specs = [None, None]
        r = []
        for f in frames:
            x = wrap(f) if wrap else f
            (pad, b), = tif.process(0, P.Buf.of(x))
            assert b.tensors[0] is x
            r.append(pad)
        routes.append(r)
    assert routes[1] == routes[0]
    assert routes[2] == routes[0]
    assert 0 < sum(routes[0]) < len(frames) or mode == "average"


def test_tensor_if_average_host_path_is_numpy_mean():
    """A uint8 host mean is numpy's float64 mean, so a frame averaging
    just above the threshold in float64 decides as JAX's host path."""
    f = np.array([[1, 2, 2]], np.uint8)   # mean 5/3 = 1.666...
    for P in (JAX, PORT):
        tif = P.el.TensorIf(name="i", compared_value="average",
                            compared_value_option="0", operator="gt",
                            supplied_value=repr(5 / 3 - 1e-12))
        tif.negotiate([spec_of(P, (1, 3), dtype="UINT8")])
        assert len(tif.process(0, P.Buf.of(f))) == 1


def _if_graph(P, iff, bufs, two_branches=True):
    src = P.el.AppSrc(spec=spec_of(P, (4,)), name="src")
    s_then = P.el.TensorSink(name="then_s")
    elems = [src, iff, s_then]
    links = [(src, iff), (iff, s_then, 0, 0)]
    s_else = None
    if two_branches:
        s_else = P.el.TensorSink(name="else_s")
        elems.append(s_else)
        links.append((iff, s_else, 1, 0))
    run_graph(P, elems, links, {"src": bufs})
    return s_then, s_else


def _val_buf(P, v, pts=0):
    return P.Buf.of(np.full((4,), v, np.float32), pts=pts)


def _if_both(props, vals, two_branches=True):
    out = {}
    for P in (JAX, PORT):
        s_then, s_else = _if_graph(
            P, P.el.TensorIf(name="i", **props),
            [_val_buf(P, v, i) for i, v in enumerate(vals)], two_branches)
        out[P.nns.__name__] = (s_then.results,
                               s_else.results if s_else else [])
    got, ref = out["nnstreamer_tpu_torch"], out["nnstreamer_tpu"]
    same_results(got[0], ref[0])
    same_results(got[1], ref[1])
    return got


def test_if_range_inclusive_routes_both_branches():
    t, e = _if_both(dict(compared_value="a_value",
                         compared_value_option="0:0",
                         operator="range_inclusive", supplied_value="2:5",
                         else_="passthrough"), [2, 5, 6])
    assert len(t) == 2       # 2 and 5 inclusive
    assert len(e) == 1       # 6 outside


def test_if_range_exclusive_and_not_in_range():
    t, e = _if_both(dict(operator="range_exclusive", supplied_value="2:5",
                         else_="passthrough"), [2, 3])
    assert len(t) == 1 and len(e) == 1
    t, e = _if_both(dict(operator="not_in_range_inclusive",
                         supplied_value="2:5", else_="passthrough"), [2, 9])
    assert len(t) == 1       # 9 not in [2,5]
    assert float(t[0].tensors[0][0]) == 9.0


def test_if_range_needs_two_values():
    with pytest.raises(PipelineError, match="2 supplied"):
        tel.TensorIf(name="i", operator="range_inclusive", supplied_value="3")
    with pytest.raises(PipelineError, match="lo.*hi|> hi"):
        tel.TensorIf(name="i", operator="range_inclusive",
                     supplied_value="5:2")


def test_if_fill_values_broadcast_and_per_tensor():
    t, e = _if_both(dict(operator="gt", supplied_value="10",
                         then="passthrough", else_="fill_values",
                         else_option="7.5"), [1])
    np.testing.assert_array_equal(e[0].tensors[0],
                                  np.full((4,), 7.5, np.float32))


def test_if_fill_values_wrong_count_fails():
    iff = tel.TensorIf(name="i", operator="gt", supplied_value="10",
                       else_="fill_values", else_option="1,2,3")
    with pytest.raises((PipelineError, StreamError), match="fill_values"):
        _if_graph(PORT, iff, [_val_buf(PORT, 1, 0)])


def test_if_fill_with_file(tmp_path):
    payload = np.arange(4, dtype=np.float32)
    f = tmp_path / "fill.raw"
    f.write_bytes(payload.tobytes())
    t, e = _if_both(dict(operator="gt", supplied_value="10",
                         else_="fill_with_file", else_option=str(f)), [1])
    np.testing.assert_array_equal(e[0].tensors[0], payload)


def test_if_fill_with_file_too_small(tmp_path):
    f = tmp_path / "small.raw"
    f.write_bytes(b"\x00" * 4)   # needs 16
    iff = tel.TensorIf(name="i", operator="gt", supplied_value="10",
                       else_="fill_with_file", else_option=str(f))
    with pytest.raises((PipelineError, StreamError), match="fill file"):
        _if_graph(PORT, iff, [_val_buf(PORT, 1, 0)])


def test_if_fill_with_file_missing_fails_at_build():
    with pytest.raises(PipelineError, match="cannot read"):
        tel.TensorIf(name="i", else_="fill_with_file",
                     else_option="/nonexistent/fill.raw")


def test_if_repeat_previous_no_history_skips():
    t, e = _if_both(dict(operator="gt", supplied_value="5",
                         then="repeat_previous", else_="skip"), [9, 8])
    # nothing was ever forwarded, so there is nothing to repeat
    assert len(t) == 0 and len(e) == 0


def test_if_repeat_previous_repeats_last_forwarded():
    """else=repeat_previous re-sends the last good (then) frame with the
    failing frame's PTS — the hold-last-value idiom."""
    t_res, e_res = _if_both(dict(operator="gt", supplied_value="5",
                                 then="passthrough",
                                 else_="repeat_previous"), [9, 1, 7, 2])
    assert len(t_res) == 2                           # 9, 7 pass
    assert len(e_res) == 2                           # 1, 2 repeat history
    np.testing.assert_array_equal(e_res[0].tensors[0], t_res[0].tensors[0])
    np.testing.assert_array_equal(e_res[1].tensors[0], t_res[1].tensors[0])
    assert e_res[0].pts == 1                         # current frame's PTS


def test_if_fill_actions_are_per_branch(tmp_path):
    """then and else each have their own fill material."""
    a, b = (np.full(4, 11, np.float32), np.full(4, 22, np.float32))
    fa, fb = tmp_path / "a.raw", tmp_path / "b.raw"
    fa.write_bytes(a.tobytes())
    fb.write_bytes(b.tobytes())
    t, e = _if_both(dict(operator="gt", supplied_value="5",
                         then="fill_with_file", then_option=str(fa),
                         else_="fill_with_file", else_option=str(fb)),
                    [9, 1])
    np.testing.assert_array_equal(t[0].tensors[0], a)
    np.testing.assert_array_equal(e[0].tensors[0], b)


def test_if_fill_values_bad_option_fails_at_build():
    with pytest.raises(PipelineError, match="fill_values"):
        tel.TensorIf(name="i", else_="fill_values", else_option="1,x")


def test_if_repeat_previous_rejects_tensorpick_pairing():
    iff = tel.TensorIf(name="i", operator="gt", supplied_value="5",
                       then="tensorpick", then_option="0",
                       else_="repeat_previous")
    src = tel.AppSrc(spec=spec_of(PORT, (4,)), name="src")
    s_then, s_else = tel.TensorSink(name="t"), tel.TensorSink(name="e")
    with pytest.raises(NegotiationError, match="repeat_previous cannot pair"):
        run_graph(PORT, [src, iff, s_then, s_else],
                  [(src, iff), (iff, s_then, 0, 0), (iff, s_else, 1, 0)],
                  {"src": []})


@pytest.mark.parametrize("action,option", [
    ("fill_zero", ""), ("fill_values", "2.5,-1"), ("fill_with_file", "F"),
    ("tensorpick", "1"), ("skip", ""), ("passthrough", "")])
def test_if_actions_on_tensors_keep_their_device(tmp_path, action, option):
    """Every action on a frame of two tensors: the port's output on a
    host frame is JAX's bit for bit; on a tensor frame it equals that
    and the fills are tensors on the input's device (ROADMAP N14)."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.arange(4, dtype=np.int32) - 2
    if action == "fill_with_file":
        option = str(tmp_path / "fill.raw")
        (tmp_path / "fill.raw").write_bytes(
            (np.arange(6, dtype=np.float32) * 0.5).tobytes()
            + np.arange(4, dtype=np.int32).tobytes())
    outs = []
    for P, wrap in ((JAX, None), (PORT, None), (PORT, torch.from_numpy)):
        tif = P.el.TensorIf(name="i", operator="lt", supplied_value="100",
                            then=action, then_option=option)
        tif.negotiate([P.Spec.of(P.Info((2, 3), P.DType.FLOAT32),
                                 P.Info((4,), P.DType.INT32))])
        xs = (wrap(a), wrap(b)) if wrap else (a, b)
        emitted = tif.process(0, P.Buf.of(*xs, pts=3))
        for _, out in emitted:
            for t in out.tensors:
                assert isinstance(t, torch.Tensor) == (wrap is not None)
        outs.append([(p, e.pts, [(host(t).dtype, host(t).tobytes())
                                 for t in e.tensors]) for p, e in emitted])
    assert outs[1] == outs[0]
    assert outs[2] == outs[0]


# -- tensor_rate -------------------------------------------------------------

NS = 1_000_000_000


def test_tensor_rate_downsample():
    def case(P):
        src = P.el.AppSrc(spec=spec_of(P, (1,)), name="src")
        rate = P.el.TensorRate(name="r", framerate="1/1")  # 1 fps
        sink = P.el.TensorSink(name="s")
        # 4 fps input over 2s
        bufs = [P.Buf.of(np.full((1,), i, np.float32), pts=i * NS // 4)
                for i in range(8)]
        run_graph(P, [src, rate, sink], [(src, rate), (rate, sink)],
                  {"src": bufs})
        assert rate.dropped > 0
        return sink.results

    res, _ = both(case)
    assert 2 <= len(res) <= 3
    # slot PTS are exact multiples of 1s
    assert all((b.pts % NS) == 0 for b in res)


def test_tensor_rate_upsample_duplicates():
    def case(P):
        src = P.el.AppSrc(spec=spec_of(P, (1,)), name="src")
        rate = P.el.TensorRate(name="r", framerate="4/1")
        sink = P.el.TensorSink(name="s")
        bufs = [P.Buf.of(np.full((1,), i, np.float32), pts=i * NS)
                for i in range(2)]  # 1 fps input
        run_graph(P, [src, rate, sink], [(src, rate), (rate, sink)],
                  {"src": bufs})
        return sink.results

    res, _ = both(case)
    assert len(res) >= 4  # 0..1s at 4fps


def test_tensor_rate_counts_match_jax():
    """Drops, duplicates and slot PTS over an uneven PTS sequence,
    element by element; throttle posts one QoS event."""
    pts = [0, 10, 40, 45, 260, 270, 700, 710, 720, 1500]
    outs = []
    for P in (JAX, PORT):
        r = P.el.TensorRate(name="r", framerate="100/1")
        events = []
        r.post_upstream_event = events.append
        r.negotiate([spec_of(P, (1,))])
        out = []
        for i, p in enumerate(pts):
            out += [(e.pts, float(e.tensors[0][0])) for _, e in r.process(
                0, P.Buf.of(np.full((1,), i, np.float32), pts=p * 1_000_000))]
        out += [(e.pts, float(e.tensors[0][0])) for _, e in r.flush()]
        outs.append((out, r.dropped, r.duplicated, events))
    assert outs[1] == outs[0]
    assert outs[0][1] > 0 and outs[0][2] > 0 and len(outs[0][3]) == 1


def test_rate_throttle_posts_qos_and_source_skips():
    pipe = tnns.parse_launch(
        "videotestsrc num-buffers=40 framerate=100/1 pattern=solid ! "
        "tensor_converter ! "
        "tensor_rate name=r framerate=10/1 throttle=true ! "
        "tensor_sink name=s")
    tnns.run_pipeline(pipe, timeout=60)
    src = next(e for e in pipe.elements.values()
               if e.ELEMENT_NAME == "videotestsrc")
    rate = pipe.get("r")
    # the source stopped generating frames that would be dropped: after
    # the first drop triggers QoS, generation paces at 10/1
    assert src.qos_skipped > 10
    # only the in-flight window (bounded queues) could still drop —
    # far fewer than the ~36 drops without throttle
    assert rate.dropped < 15


def test_rate_no_throttle_source_never_skips():
    pipe = tnns.parse_launch(
        "videotestsrc num-buffers=40 framerate=100/1 pattern=solid ! "
        "tensor_converter ! "
        "tensor_rate name=r framerate=10/1 throttle=false ! "
        "tensor_sink name=s")
    tnns.run_pipeline(pipe, timeout=60)
    src = next(e for e in pipe.elements.values()
               if e.ELEMENT_NAME == "videotestsrc")
    assert src.qos_skipped == 0
    assert pipe.get("r").dropped > 20


def test_rate_behind_tee_throttle_paces_every_branch():
    """throttle=true behind a tee reaches the source, so the other branch
    loses the frames too (as in JAX): throttle=false keeps them."""
    desc = ("videotestsrc num-buffers=40 framerate=100/1 pattern=solid ! "
            "tensor_converter ! tee name=t "
            "t. ! queue ! tensor_rate framerate=10/1 throttle={th} ! "
            "tensor_sink name=r "
            "t. ! queue ! tensor_sink name=all")
    counts = {}
    for th in ("true", "false"):
        pipe = tnns.parse_launch(desc.format(th=th))
        tnns.run_pipeline(pipe, timeout=60)
        counts[th] = len(pipe.get("all").results)
    assert counts["false"] == 40
    assert counts["true"] < 40


# -- crop --------------------------------------------------------------------

def test_tensor_crop_regions():
    img = np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3)
    region = np.array([[2, 1, 4, 3]], np.uint32)  # x,y,w,h

    def case(P):
        src = P.el.AppSrc(spec=spec_of(P, (8, 8, 3), dtype="UINT8"),
                          name="raw")
        info = P.el.AppSrc(spec=spec_of(P, (1, 4), dtype="UINT32"),
                           name="info")
        crop = P.el.TensorCrop(name="c")
        sink = P.el.TensorSink(name="s")
        run_graph(P, [src, info, crop, sink],
                  [(src, crop, 0, 0), (info, crop, 0, 1), (crop, sink)],
                  {"raw": [P.Buf.of(img, pts=0)],
                   "info": [P.Buf.of(region, pts=0)]})
        return sink.results

    got, _ = both(case)
    assert got[0].format.name == "FLEXIBLE"
    assert got[0].tensors[0].shape == (3, 4, 3)  # h=3, w=4
    np.testing.assert_array_equal(got[0].tensors[0], img[1:4, 2:6])


# -- repo loop ---------------------------------------------------------------

def _repo_loop(P, model, slot):
    P.el.REPO.reset()
    state = P.el.TensorRepoSrc(name="state", slot=slot, dims="4", count=4)
    xs = P.el.AppSrc(spec=spec_of(P, (4,)), name="xs")
    mux = P.el.TensorMux(name="m", sync_mode="nosync")
    f = P.el.TensorFilter(name="f", model=model)
    tee = P.el.Tee(name="t")
    back = P.el.TensorRepoSink(name="back", slot=slot)
    sink = P.el.TensorSink(name="s")
    run_graph(P, [state, xs, mux, f, tee, back, sink],
              [(state, mux, 0, 0), (xs, mux, 0, 1), (mux, f), (f, tee),
               (tee, back, 0, 0), (tee, sink, 1, 0)],
              {"xs": [buf(P, 1, (4,), pts=i) for i in range(4)]})
    return sink.results


def test_repo_feedback_loop_accumulates():
    """reposrc primes zeros; filter adds input; reposink feeds back.
    Chain: reposrc → (state) mux with appsrc → add → tee → [reposink,
    sink]. After 4 inputs the state is the running sum. Each package's
    own backend runs a callable model (JAX's framework=custom is not
    ported)."""
    from nnstreamer_tpu.backends.xla import ModelBundle as JBundle

    ref = _repo_loop(JAX, JBundle(fn=lambda p, a, b: (a + b,)), 7)
    got = _repo_loop(PORT, ModelBundle(fn=lambda p, a, b: (a + b,)), 7)
    assert [float(r.tensors[0][0]) for r in got] == [1, 2, 3, 4]
    same_results(got, ref)


def test_repo_state_stays_on_the_filter_device():
    """After the first pass the loop's state is the filter's output
    tensor: the sink gets tensors with to-host=false, and no forced sync
    is made inside the loop."""
    from nnstreamer_tpu_torch.runtime import sync

    PORT.el.REPO.reset()
    state = tel.TensorRepoSrc(name="state", slot=3, dims="4", count=3)
    xs = tel.AppSrc(spec=spec_of(PORT, (4,)), name="xs")
    mux = tel.TensorMux(name="m", sync_mode="nosync")
    f = tel.TensorFilter(name="f", model=ModelBundle(
        fn=lambda p, s, x: (0.5 * s + x,)))
    tee = tel.Tee(name="t")
    back = tel.TensorRepoSink(name="back", slot=3)
    sink = tel.TensorSink(name="s", to_host=False)
    before = sync.forced_sync_count()
    run_graph(PORT, [state, xs, mux, f, tee, back, sink],
              [(state, mux, 0, 0), (xs, mux, 0, 1), (mux, f), (f, tee),
               (tee, back, 0, 0), (tee, sink, 1, 0)],
              {"xs": [buf(PORT, 2, (4,), pts=i) for i in range(3)]})
    assert sync.forced_sync_count() == before
    vals = [r.tensors[0] for r in sink.results]
    assert all(isinstance(v, torch.Tensor) for v in vals)
    assert [float(v[0]) for v in vals] == [2.0, 3.0, 3.5]


def test_repo_teardown_unblocks_the_source():
    """A reposrc blocked on an empty slot ends when the runner stops
    (interrupt puts the sentinel) — no thread left waiting."""
    PORT.el.REPO.reset()
    state = tel.TensorRepoSrc(name="state", slot=11, dims="2", initial=1)
    got = threading.Event()
    sink = tel.TensorSink(name="s", new_data=lambda b: got.set())
    pipe = tnns.Pipeline()
    for e in (state, sink):
        pipe.add(e)
    pipe.link(state, sink)
    runner = tnns.PipelineRunner(pipe).start()
    assert got.wait(30)
    runner.stop()
    # stop() only interrupts the sources and closes the queues; it joins
    # no worker, so read the threads after a bounded wait for them
    runner.wait(30)
    assert len(sink.results) == 1
    assert not any(t.is_alive() and "state" in t.name
                   for t in threading.enumerate())
    # a sink's stop() also leaves the sentinel for a source
    back = tel.TensorRepoSink(name="b", slot=12)
    back.stop()
    assert PORT.el.REPO.slot(12).get_nowait() is None


def test_repo_sink_put_gives_up_when_stopping():
    PORT.el.REPO.reset()
    back = tel.TensorRepoSink(name="b", slot=13)
    q = PORT.el.REPO.slot(13)
    while not q.full():
        q.put_nowait(0)
    back._stop_evt = threading.Event()
    back._stop_evt.set()
    with pytest.raises(StreamError, match="pipeline stopping"):
        back.render(buf(PORT, 0, (2,)))


# -- sparse ------------------------------------------------------------------

def test_sparse_enc_dec_roundtrip():
    arr = np.zeros((4, 4), np.float32)
    arr[1, 2] = 5.0
    arr[3, 3] = -1.5

    def case(P):
        src = P.el.AppSrc(spec=spec_of(P, (4, 4)), name="src")
        enc = P.el.TensorSparseEnc(name="e")
        dec = P.el.TensorSparseDec(name="d")
        sink = P.el.TensorSink(name="s")
        run_graph(P, [src, enc, dec, sink],
                  [(src, enc), (enc, dec), (dec, sink)],
                  {"src": [P.Buf.of(arr, pts=0)]})
        assert enc.out_specs[0].format == P.Format.SPARSE
        return sink.results

    got, _ = both(case)
    np.testing.assert_array_equal(got[0].tensors[0], arr)


# -- DSL pipelines (tests/test_pipelines.py) ---------------------------------

def test_mux_demux_roundtrip_dsl():
    desc = ("videotestsrc num-buffers=2 width=4 height=4 pattern=random ! "
            "tensor_converter ! tee name=t "
            "t. ! queue ! mux.sink_0 "
            "t. ! queue ! tensor_transform mode=typecast option=uint8 ! "
            "mux.sink_1 "
            "tensor_mux name=mux sync-mode=nosync ! "
            "tensor_demux name=d tensorpick=1 ! tensor_sink name=s")
    res = {}
    for P in (JAX, PORT):
        pipe = P.nns.parse_launch(desc)
        P.nns.run_pipeline(pipe, timeout=60)
        res[P.nns.__name__] = pipe.get("s").results
    got = res["nnstreamer_tpu_torch"]
    assert len(got) == 2
    assert got[0].num_tensors == 1
    same_results(got, res["nnstreamer_tpu"])


@pytest.mark.parametrize("desc,match", [
    ("appsrc dims=4 ! tensor_split tensorseg=9 ! fakesink", "tensorseg"),
    ("appsrc dims=4 ! tensor_merge option=channel ! fakesink", "rank|axis"),
])
def test_negative_split_merge_pipelines_fail_cleanly(desc, match):
    for P in (JAX, PORT):
        with pytest.raises(Exception, match=match) as e:
            P.nns.parse_launch(desc).negotiate()
        assert type(e.value).__name__ in ("NegotiationError",
                                          "PipelineError")


def test_split_views_reach_the_model_contiguous():
    """tensor_split's segments are strided views; the filter stages a
    view already on its device contiguous (ROADMAP N15), so the model
    sees one layout per frame and in a compiled window alike, and the
    outputs equal the contiguous halves' bit for bit."""
    seen = []

    def fn(p, x):
        seen.append(x.is_contiguous())
        return (x * 2,)

    arr = np.arange(2 * 4 * 6, dtype=np.float32).reshape(2, 4, 6)
    src = tel.AppSrc(spec=spec_of(PORT, (2, 4, 6)), name="src")
    split = tel.TensorSplit(name="sp", tensorseg="2:4", axis=2)
    fa = tel.TensorFilter(name="fa", model=ModelBundle(fn=fn))
    fb = tel.TensorFilter(name="fb", model=ModelBundle(fn=fn))
    sa, sb = tel.TensorSink(name="sa"), tel.TensorSink(name="sb")
    run_graph(PORT, [src, split, fa, fb, sa, sb],
              [(src, split), (split, fa, 0, 0), (split, fb, 1, 0),
               (fa, sa), (fb, sb)],
              {"src": [lambda P: P.Buf.of(torch.from_numpy(arr), pts=0)]})
    assert seen and all(seen)
    np.testing.assert_array_equal(sa.results[0].tensors[0], arr[..., :2] * 2)
    np.testing.assert_array_equal(sb.results[0].tensors[0], arr[..., 2:] * 2)
    from nnstreamer_tpu_torch.backends.torch_backend import stage

    view = torch.from_numpy(arr)[..., 2:]
    (staged,), n = stage((view,), torch.device("cpu"))
    assert n == 0 and staged.is_contiguous()
    assert torch.equal(staged, view)
    t = torch.from_numpy(arr)
    assert stage((t,), torch.device("cpu"))[0][0] is t

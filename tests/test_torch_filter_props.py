"""tensor_filter's property set in the port held to the JAX package's on
the same pipelines and strings, on the CPU: input/output overrides,
input/output combinations (with their refusals, also on batched and
FLEXIBLE streams), latency-mode=sync, the invoke latency/throughput
stats, reload (plain and through a shared key), custom= and the loader
options that inputname/outputname reach."""

import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu.elements as jel
import nnstreamer_tpu_torch as tnns
import nnstreamer_tpu_torch.elements as tel
from nnstreamer_tpu.backends import xla as jxla
from nnstreamer_tpu.core.errors import BackendError as JBackendError
from nnstreamer_tpu.core.errors import NegotiationError as JNegotiationError
from nnstreamer_tpu.core.errors import PipelineError as JPipelineError
from nnstreamer_tpu.modelio import parse_loader_opts as jparse
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
from nnstreamer_tpu.tensor.dtypes import DType as JDType
from nnstreamer_tpu.tensor.info import TensorInfo as JInfo
from nnstreamer_tpu.tensor.info import TensorsSpec as JSpec
from nnstreamer_tpu_torch.backends import torch_backend as tb
from nnstreamer_tpu_torch.core.errors import (
    BackendError, NegotiationError, PipelineError)
from nnstreamer_tpu_torch.modelio import parse_loader_opts
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

REFUSED = (NegotiationError, PipelineError, BackendError, JNegotiationError,
           JPipelineError, JBackendError)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _affine(x):
    return x * 2.0 + 1.0


def _sum_pair(a, b):
    return (a.sum() + b.sum()) * a


PKGS = {
    "jax": (jnns, jel, JBuffer, lambda *s: JSpec.of(
        *(JInfo(x, JDType.FLOAT32) for x in s))),
    "torch": (tnns, tel, TensorBuffer, lambda *s: TensorsSpec.of(
        *(TensorInfo(x, DType.FLOAT32) for x in s))),
}
FRAMES = 3


def _frames(shapes, i):
    rng = np.random.default_rng(i)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _run(kind, shapes, batch=0, **props):
    """appsrc (tensors of `shapes`) ! [tensor_batch] ! tensor_filter
    name=f ! [tensor_unbatch] ! tensor_sink, FRAMES frames. → (outputs as
    lists, the filter, runner stats) or the refusal's text."""
    pkg, el, buf_cls, spec = PKGS[kind]
    pipe = pkg.Pipeline()
    f = el.TensorFilter("f", framework="xla", **props)
    stages = [el.AppSrc("src", spec=spec(*shapes))]
    if batch:
        stages.append(el.TensorBatch("b", max_batch=batch))
    stages.append(f)
    if batch:
        stages.append(el.TensorUnbatch("u"))
    sink = el.TensorSink("out")
    stages.append(sink)
    for e in stages:
        pipe.add(e)
    for a, b in zip(stages, stages[1:]):
        pipe.link(a, b)
    try:
        runner = pkg.PipelineRunner(pipe).start()
    except REFUSED as e:
        return str(e)
    for i in range(FRAMES):
        stages[0].push(buf_cls.of(*_frames(shapes, i), pts=i))
    stages[0].end()
    runner.wait(60)
    runner.stop()
    outs = [[np.asarray(t).tolist() for t in b.tensors]
            for b in sink.results]
    return outs, f, runner.stats()


def _both(shapes, batch=0, **props):
    return (_run("jax", shapes, batch, **props),
            _run("torch", shapes, batch, **props))


OVERRIDES = {
    "input accepted": dict(input="4:1", inputtype="float32"),
    "input dims refused": dict(input="5:1", inputtype="float32"),
    "input type refused": dict(input="4:1", inputtype="int32"),
    "output override": dict(output="4:1", outputtype="float32"),
    "output dims only": dict(output="2:2"),
}


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_overrides_match_jax(case):
    ref, got = _both([(1, 4)], model=_affine, **OVERRIDES[case])
    if isinstance(ref, str):
        assert got == ref and "override with input=/inputtype=" in got
        return
    assert got[0] == ref[0]
    assert str(got[1].out_specs[0]) == str(ref[1].out_specs[0])


COMBINATIONS = {
    "input subset": dict(model=_affine, input_combination="1"),
    "input both": dict(model=_sum_pair, input_combination="1,0"),
    "output i0,o0": dict(model=_sum_pair, output_combination="i0,o0"),
    "output o0,i1,i0": dict(model=_sum_pair,
                            output_combination="o0,i1,i0"),
    "input out of range": dict(model=_affine, input_combination="2"),
    "output i out of range": dict(model=_sum_pair,
                                  output_combination="i2"),
    "output o out of range": dict(model=_sum_pair,
                                  output_combination="o1"),
}


@pytest.mark.parametrize("case", sorted(COMBINATIONS))
def test_combinations_match_jax(case):
    ref, got = _both([(1, 4), (1, 4)], **COMBINATIONS[case])
    if isinstance(ref, str):
        assert got == ref and "out of range" in got
        return
    assert len(got[0]) == len(ref[0]) == FRAMES
    for g, r in zip(got[0], ref[0]):
        assert len(g) == len(r)
        for a, b in zip(g, r):
            np.testing.assert_allclose(a, b, rtol=1e-6)
    assert str(got[1].out_specs[0]) == str(ref[1].out_specs[0])


def test_output_combination_passes_the_input_itself():
    outs, f, _ = _run("torch", [(1, 4), (1, 4)], model=_sum_pair,
                      output_combination="i0,o0")
    for i, (inp, _) in enumerate(outs):
        assert inp == _frames([(1, 4), (1, 4)], i)[0].tolist()


@pytest.mark.parametrize("entry", ["x1", "i", "o-1", "i0,,o0"])
def test_bad_output_combination_entry_refused_like_jax(entry):
    msgs = []
    for el, err in ((jel, JPipelineError), (tel, PipelineError)):
        with pytest.raises(err) as e:
            el.TensorFilter("f", model=_affine, output_combination=entry)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "bad output-combination entry" in msgs[1]


def test_bad_input_combination_refused_like_jax():
    msgs = []
    for el, err in ((jel, JPipelineError), (tel, PipelineError)):
        with pytest.raises(err) as e:
            el.TensorFilter("f", model=_affine, input_combination="0,a")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "bad combination list" in msgs[1]


@pytest.mark.parametrize("prop", [dict(input_combination="0"),
                                  dict(output_combination="o0")])
def test_combinations_refused_on_batched_stream(prop):
    ref, got = _both([(1, 4)], batch=4, model=_affine, **prop)
    assert isinstance(got, str) and got == ref
    assert "micro-batched stream" in got


def test_combinations_refused_on_flexible_stream():
    msgs = []
    for kind in ("jax", "torch"):
        pkg, el, _, spec = PKGS[kind]
        pipe = pkg.Pipeline()
        raw = el.AppSrc("raw", spec=spec((1, 8, 8, 3)))
        info = el.AppSrc("info", spec=spec((1, 4)))
        crop = el.TensorCrop("c")
        f = el.TensorFilter("f", model=_affine, invoke_dynamic="true",
                            output_combination="o0")
        sink = el.TensorSink("s")
        for e in (raw, info, crop, f, sink):
            pipe.add(e)
        pipe.link(raw, crop, 0, 0)
        pipe.link(info, crop, 0, 1)
        pipe.link(crop, f)
        pipe.link(f, sink)
        with pytest.raises(REFUSED) as e:
            pipe.negotiate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "FLEXIBLE stream" in msgs[1]


@pytest.mark.parametrize("batch", [0, 2])
def test_sync_latency_mode_forces_one_sync_a_buffer(batch):
    ref, got = _both([(1, 4)], batch=batch, model=_affine,
                     latency_mode="sync")
    assert got[0] == ref[0]
    buffers = FRAMES if not batch else -(-FRAMES // batch)
    assert got[2]["f"]["forced_syncs"] == ref[2]["f"]["forced_syncs"] \
        == buffers


def test_invoke_latency_and_throughput_stats_like_jax():
    ref, got = _both([(1, 4)], model=_affine)
    for st in (ref[2], got[2]):
        assert st["f"]["invoke_latency_us"] > 0
        assert st["f"]["invoke_throughput"] > 0
        for name, row in st.items():
            assert ("invoke_latency_us" in row) == (name == "f")


# -- reload ----------------------------------------------------------------

def _scale(params, x):
    return x * params["w"]


def _bundle(w):
    return tb.ModelBundle(fn=_scale, params={"w": torch.tensor(w)},
                          name=f"w{w}")


def test_reload_refused_without_is_updatable():
    msgs = []
    for el, err in ((jel, JPipelineError), (tel, PipelineError)):
        f = el.TensorFilter("f", model=_affine)
        with pytest.raises(err) as e:
            f.reload_model(_affine)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "is-updatable=true" in msgs[1]


def test_reload_swaps_the_model():
    be = tb.TorchBackend()
    be.open({"model": _bundle(2.0)})
    x = np.ones((1, 3), np.float32)
    assert be.invoke((x,))[0].tolist() == [[2.0] * 3]
    be.reload(_bundle(5.0))
    assert be.invoke((x,))[0].tolist() == [[5.0] * 3]


def test_shared_key_reload_reaches_every_holder():
    """From test_dynamic_shapes.py::test_shared_key_reload_propagates_to_
    all_holders: a reload through one holder changes the other's next
    output, in both packages."""
    tb._shared_models.clear()
    jxla._shared_models.clear()
    x = np.ones((1, 2, 2, 3), np.uint8)
    results = {}
    for kind in ("jax", "torch"):
        mod = jxla if kind == "jax" else tb
        b1 = mod.XLABackend() if kind == "jax" else tb.TorchBackend()
        b2 = mod.XLABackend() if kind == "jax" else tb.TorchBackend()
        w = np.linspace(-1, 1, 15, dtype=np.float32).reshape(3, 5)
        if kind == "jax":
            import jax.numpy as jnp

            def fn(p, t):
                return jnp.sum(t.astype(jnp.float32), axis=(1, 2)) @ p["w"]
            first = jxla.ModelBundle(fn=fn, params={"w": w})
            swapped = jxla.ModelBundle(
                fn=fn, params={"w": np.zeros((3, 5), np.float32)})
        else:
            def fn(p, t):
                return t.float().sum((1, 2)) @ p["w"]
            first = tb.ModelBundle(fn=fn, params={"w": torch.from_numpy(w)})
            swapped = tb.ModelBundle(fn=fn, params={"w": torch.zeros(3, 5)})
        b1.open({"model": first, "shared_tensor_filter_key": "k2"})
        b2.open({"model": first, "shared_tensor_filter_key": "k2"})
        before = np.asarray(b2.invoke((x,))[0])
        b1.reload(swapped)
        after = np.asarray(b2.invoke((x,))[0])
        results[kind] = (before, after, np.asarray(b1.invoke((x,))[0]))
        b1.close()
        b2.close()
    for got, ref in zip(results["torch"], results["jax"]):
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert not np.allclose(results["torch"][0], results["torch"][1])
    np.testing.assert_array_equal(results["torch"][1], 0.0)
    assert tb._shared_models == {}


def test_reload_model_through_filters_sharing_a_key():
    """Two filters of one pipeline on one shared key: reload_model on
    one switches both at their next frame."""
    tb._shared_models.clear()
    shapes = [(1, 3)]
    pipe = tnns.Pipeline()
    src = tel.AppSrc("src", spec=PKGS["torch"][3](*shapes))
    f1 = tel.TensorFilter("f1", model=_bundle(2.0), is_updatable="true",
                          shared_tensor_filter_key="rk")
    f2 = tel.TensorFilter("f2", model=_bundle(2.0),
                          shared_tensor_filter_key="rk")
    sink = tel.TensorSink("out")
    for e in (src, f1, f2, sink):
        pipe.add(e)
    pipe.link(src, f1)
    pipe.link(f1, f2)
    pipe.link(f2, sink)
    runner = tnns.PipelineRunner(pipe).start()
    x = np.ones((1, 3), np.float32)
    src.push(TensorBuffer.of(x, pts=0))
    deadline = time.monotonic() + 30
    while not sink.results and time.monotonic() < deadline:
        time.sleep(0.01)
    f1.reload_model(_bundle(3.0))
    src.push(TensorBuffer.of(x, pts=1))
    src.end()
    runner.wait(30)
    runner.stop()
    vals = [np.asarray(b.tensors[0]).tolist() for b in sink.results]
    assert vals == [[[4.0] * 3], [[9.0] * 3]]


# -- custom= and the loader options ------------------------------------------

CUSTOM = ["", "batch=8,dtype=float32,quantize_output=false",
          "dynamic_spatial=true", "dynamic_spatial=0,compute_dtype=bf16",
          "inputname=a;b,outputname=c", "input_names=x,output_names=y;z",
          "side=300,sample_rate=16000", " batch = 2 , unknown=1 ,,",
          "quantize_output=YES"]


@pytest.mark.parametrize("custom", CUSTOM)
def test_parse_loader_opts_matches_jax(custom):
    assert parse_loader_opts(custom) == jparse(custom)


@pytest.mark.parametrize("custom", ["batch=x", "side=1.5",
                                    "sample_rate=fast"])
def test_parse_loader_opts_refuses_like_jax(custom):
    with pytest.raises(JBackendError) as je:
        jparse(custom)
    with pytest.raises(BackendError) as te:
        parse_loader_opts(custom)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("props", [
    dict(custom="dynamic_spatial=true,batch=4"),
    dict(inputname="in0,in1", outputname="out"),
    dict(custom="inputname=a;b,dtype=float16", inputname="x"),
])
def test_names_reach_the_loader_options_like_jax(props):
    jb = jxla.XLABackend()
    jb.open({"model": _affine, **props})
    be = tb.TorchBackend()
    be.open({"model": _affine, **props})
    assert be._loader_opts == jb._loader_opts
    assert be._dynamic_spatial == jb._dynamic_spatial

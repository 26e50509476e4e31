"""Routing (BASELINE config 4) on the port against the JAX package, on the
CPU.

- tensor_mux in all four sync modes (nosync, slowest, basepad, refresh)
  fed one arrival sequence with PTS: the same groups, in the same order,
  with the same PTS, element by element and at EOS; tensor_demux with
  `tensorpick` groups ('+').
- DSL pad references (name.sink_N, name.src_N, name.N) give the same
  links as the JAX parser.
- Pipeline C: a two-tensor uint8 appsrc → tensor_demux → per branch the
  normalize and a MobileNetV2 (width 0.35, 64², f32) sharing one model by
  `shared_tensor_filter_key` → tensor_mux nosync, built programmatically
  and as a DSL string: logits within 1e-4 of max |logit| of JAX's, the
  two filters hold one model, and closing them frees it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.xla import ModelBundle as JBundle
from nnstreamer_tpu.elements import routing as jroute
from nnstreamer_tpu.models import mobilenet_v2 as jm
from nnstreamer_tpu.tensor import info as jinfo
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu_torch.backends import torch_backend
from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle as TBundle
from nnstreamer_tpu_torch.elements import routing as troute
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.tensor import info as tinfo
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer as TBuf

from test_torch_detection import random_params

WIDTH, SIZE = 0.35, 64
NORM = ("tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5")


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _spec(mod, n_tensors, shape=(2,)):
    return mod.TensorsSpec(tensors=tuple(
        mod.TensorInfo(shape) for _ in range(n_tensors)))


#: (pad, pts) arrivals over 3 pads: uneven rates, a late pad, catch-up
ARRIVALS = [(0, 0), (1, 5), (0, 10), (2, 3), (0, 20), (1, 18), (2, 21),
            (0, 30), (2, 29), (1, 33), (1, 40), (0, 41), (2, 45), (0, 50)]
SYNC = {"nosync": "", "slowest": "", "refresh": "",
        "basepad": "0:6", "basepad-nowindow": "1"}


def _trace(mod, buf_cls, mode, option):
    mux = mod.TensorMux(name="m", sync_mode=mode.split("-")[0],
                        sync_option=option)
    mux.negotiate([_spec(_INFO[mod], 1)] * 3)
    out = []
    for pad, pts in ARRIVALS:
        buf = buf_cls.of(np.full(2, pad * 1000 + pts, np.float32), pts=pts)
        out += [("process", p, b.pts, [float(t[0]) for t in b.tensors])
                for p, b in mux.process(pad, buf)]
    out += [("flush", p, b.pts, [float(t[0]) for t in b.tensors])
            for p, b in mux.flush()]
    return out


_INFO = {jroute: jinfo, troute: tinfo}


@pytest.mark.parametrize("mode", sorted(SYNC))
def test_mux_sync_modes_match_jax(mode):
    ref = _trace(jroute, JBuf, mode, SYNC[mode])
    got = _trace(troute, TBuf, mode, SYNC[mode])
    assert got == ref
    assert len(got) > 0


@pytest.mark.parametrize("pick", ["", "0,1+2", "2,0", "1+0+2"])
def test_demux_tensorpick_matches_jax(pick):
    arrays = [np.full((1, 3), i, np.float32) for i in range(3)]
    outs = {}
    for route, info, buf_cls in ((jroute, jinfo, JBuf),
                                 (troute, tinfo, TBuf)):
        dm = route.TensorDemux(name="d", tensorpick=pick)
        specs = dm.negotiate([_spec(info, 3, (1, 3))])
        emitted = dm.process(0, buf_cls.of(*arrays, pts=7))
        outs[route] = ([[t.shape for t in s.tensors] for s in specs],
                       [(p, b.pts, [float(t[0, 0]) for t in b.tensors])
                        for p, b in emitted])
    assert outs[troute] == outs[jroute]


def test_mux_refuses_unknown_sync_mode_and_bad_basepad():
    from nnstreamer_tpu_torch.core.errors import PipelineError

    with pytest.raises(PipelineError, match="sync_mode"):
        troute.TensorMux(name="m", sync_mode="fastest").negotiate(
            [_spec(tinfo, 1)] * 2)
    with pytest.raises(PipelineError, match="basepad"):
        troute.TensorMux(name="m", sync_mode="basepad",
                         sync_option="3").negotiate([_spec(tinfo, 1)] * 2)


DSL = ("appsrc name=a dims=2 types=float32 ! mux.sink_1 "
       "appsrc name=b dims=2 types=float32 ! mux.0 "
       "tensor_mux name=mux sync_mode=nosync ! tensor_demux name=dm "
       "dm.src_1 ! tensor_sink name=o1 "
       "dm.src_0 ! tensor_sink name=o0")


def _links(pipe):
    return sorted((l.src.name, l.src_pad, l.dst.name, l.dst_pad)
                  for l in pipe.links)


def test_dsl_pad_references_match_jax():
    got = _links(tnns.parse_launch(DSL))
    assert got == _links(jnns.parse_launch(DSL))
    assert ("a", 0, "mux", 1) in got and ("b", 0, "mux", 0) in got
    assert ("dm", 1, "o1", 0) in got and ("dm", 0, "o0", 0) in got


def test_dsl_pad_reference_errors():
    from nnstreamer_tpu_torch.core.errors import PipelineError

    with pytest.raises(PipelineError, match="pad reference"):
        tnns.parse_launch("appsrc name=a dims=2 ! mux.left_0 "
                          "tensor_mux name=mux ! tensor_sink")


# -- pipeline C -----------------------------------------------------------

@pytest.fixture(scope="module")
def mobilenet():
    params = random_params(jm.init_params, width=WIDTH)
    jb = JBundle(fn=lambda p, x: jm.apply(p, x, width=WIDTH,
                                          dtype=jnp.float32),
                 params=params, name="mnv2")
    model = bridge.load_mobilenet_v2(
        tm.MobileNetV2(WIDTH, dtype=torch.float32).eval(), params)
    return jb, TBundle(fn=lambda m, x: m(x), params=model, name="mnv2")


def _composite(pkg, bundle):
    """bench.py's config-4 graph, built element by element."""
    from importlib import import_module

    el = import_module(f"{pkg.__name__}.elements")
    src_mod = import_module(f"{pkg.__name__}.elements.sources")
    info = import_module(f"{pkg.__name__}.tensor.info")
    dt = import_module(f"{pkg.__name__}.tensor.dtypes")
    pipe = pkg.Pipeline("composite")
    src = src_mod.AppSrc(spec=info.TensorsSpec.of(
        info.TensorInfo((1, SIZE, SIZE, 3), dt.DType.UINT8),
        info.TensorInfo((1, SIZE, SIZE, 3), dt.DType.UINT8)), name="src")
    demux = el.TensorDemux(name="dm")
    ta = el.TensorTransform(name="ta", mode="arithmetic",
                            option="typecast:float32,add:-127.5,div:127.5")
    tb = el.TensorTransform(name="tb", mode="arithmetic",
                            option="typecast:float32,add:-127.5,div:127.5")
    fa = el.TensorFilter(name="fa", model=bundle,
                         shared_tensor_filter_key="test-c")
    fb = el.TensorFilter(name="fb", model=bundle,
                         shared_tensor_filter_key="test-c")
    mux = el.TensorMux(name="mx", sync_mode="nosync")
    sink = el.TensorSink(name="out")
    for x in (src, demux, ta, tb, fa, fb, mux, sink):
        pipe.add(x)
    pipe.link(src, demux)
    pipe.link(demux, ta, 0, 0)
    pipe.link(demux, tb, 1, 0)
    pipe.link(ta, fa)
    pipe.link(tb, fb)
    pipe.link(fa, mux, 0, 0)
    pipe.link(fb, mux, 0, 1)
    pipe.link(mux, sink)
    return pipe


C_DSL = (f"appsrc name=src dims=3:{SIZE}:{SIZE}:1,3:{SIZE}:{SIZE}:1 "
         f"types=uint8 ! tensor_demux name=dm "
         f"dm.src_0 ! {NORM} ! tensor_filter name=fa "
         f"shared_tensor_filter_key=test-c ! mx.sink_0 "
         f"dm.src_1 ! {NORM} ! tensor_filter name=fb "
         f"shared_tensor_filter_key=test-c ! mx.sink_1 "
         f"tensor_mux name=mx sync_mode=nosync ! tensor_sink name=out")


def _frames():
    rng = np.random.default_rng(8)
    return [tuple(rng.integers(0, 256, (1, SIZE, SIZE, 3), np.uint8)
                  for _ in range(2)) for _ in range(2)]


def _run_c(pkg, buf_cls, bundle, build, watch=None):
    if build == "dsl":
        pipe = pkg.parse_launch(C_DSL)
        for f in ("fa", "fb"):
            pipe.get(f).set_props(model=bundle)
    else:
        pipe = _composite(pkg, bundle)
    runner = pkg.PipelineRunner(pipe).start()
    if watch is not None:
        watch(pipe)
    src = pipe.get("src")
    for i, (a, b) in enumerate(_frames()):
        src.push(buf_cls.of(a, b, pts=i))
    src.end()
    runner.wait(120)
    runner.stop()
    return pipe.get("out").results


@pytest.mark.parametrize("build", ["dsl", "programmatic"])
def test_pipeline_c_matches_jax_with_one_shared_model(mobilenet, build):
    held = {}

    def watch(pipe):
        fa, fb = pipe.get("fa").backend, pipe.get("fb").backend
        held["same"] = fa._params is fb._params
        held["holders"] = torch_backend._shared_models["test-c"].holders

    ref = _run_c(jnns, JBuf, mobilenet[0], build)
    got = _run_c(tnns, TBuf, mobilenet[1], build, watch)
    assert held == {"same": True, "holders": 2}
    assert "test-c" not in torch_backend._shared_models   # freed at stop
    assert len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        assert len(g.tensors) == 2
        for rt, gt in zip(r.tensors, g.tensors):
            rt = np.asarray(rt)
            assert gt.shape == rt.shape == (1, 1001)
            np.testing.assert_allclose(gt, rt, rtol=0,
                                       atol=1e-4 * np.abs(rt).max())
        # the two branches saw different frames
        assert not np.array_equal(g.tensors[0], g.tensors[1])


def test_shared_key_refuses_another_model():
    from nnstreamer_tpu_torch.core.errors import NegotiationError

    desc = ("appsrc name=src dims=3:32:32:1 types=float32 ! tensor_demux "
            "name=dm tensorpick=0,0 "
            "dm.src_0 ! tensor_filter model=zoo://mobilenet_v2?width=0.35&"
            "input_size=32 shared_tensor_filter_key=k2 ! fakesink "
            "dm.src_1 ! tensor_filter model=zoo://mobilenet_v2?width=0.5&"
            "input_size=32 shared_tensor_filter_key=k2 ! fakesink")
    pipe = tnns.parse_launch(desc)
    with pytest.raises(NegotiationError, match="same key"):
        tnns.PipelineRunner(pipe).start()
    for e in pipe.elements.values():
        e.stop()
    assert "k2" not in torch_backend._shared_models


def test_unnamed_elements_get_unique_names():
    """Default names came from id() & 0xFFFF, which two live elements can
    share (pipeline P's two unnamed transforms collided once in a run of
    these tests); they are numbered now."""
    from nnstreamer_tpu_torch.elements import TensorTransform

    elems = [TensorTransform(mode="clamp", option="0:1") for _ in range(5000)]
    assert len({e.name for e in elems}) == len(elems)

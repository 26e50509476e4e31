"""The port's script backends (nnstreamer_tpu_torch/backends/{custom,
python3_script}.py), the script codecs (elements/script_codec.py) and
plugin-path scanning (core/registry.py) against the JAX package's, on
the CPU.

- framework=custom (and its custom-easy alias): registered callables, the
  ``pkg.module:callable`` path form with spec attributes, `infer_out`,
  the zero-input probe, the repo loop of tests/test_elements.py and
  SingleShot of tests/test_runtime_extras.py, each run in both packages
  with the port's sink results bit for bit JAX's; N16 (the callable gets
  the tensors where they are, its numpy outputs pass on uncopied).
- framework=python3: the reference's scripts are absent here, so this
  file writes `passthrough.py` and `scaler.py` of its own to the script
  contract (python3_script.py:11-21) and runs the same files through
  both packages (passthrough byte identity, the scaler's nearest
  neighbour against an independent numpy decode, adaptive setInputDim,
  custom= verbatim to the constructor, the reload that keeps it); one
  to_host a frame, whatever the tensor count; invalid scripts fail loud.
- the python3 decoder and the converter's mode=custom-script: a
  CustomDecoder / CustomConverter pair of this file's own round-trips a
  frame in both packages; bytes raw_data; the invalid class.
- plugin paths: with both packages' environment variables set, each
  package loads only its own directory, under its own module prefix; a
  registry miss scans lazily; `[common] plugin_paths` from an ini.
"""

import sys
import textwrap

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu.elements as jel
import nnstreamer_tpu_torch as tnns
import nnstreamer_tpu_torch.elements as tel
from nnstreamer_tpu.backends import custom as jcustom
from nnstreamer_tpu.backends import python3_script as jpy3
from nnstreamer_tpu.core.registry import PluginKind as JKind
from nnstreamer_tpu.core.registry import registry as jregistry
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu.tensor.dtypes import DType as JDType
from nnstreamer_tpu.tensor.info import TensorInfo as JInfo
from nnstreamer_tpu.tensor.info import TensorsSpec as JSpec
from nnstreamer_tpu_torch.backends import custom as tcustom
from nnstreamer_tpu_torch.backends import python3_script as tpy3
from nnstreamer_tpu_torch.core.registry import PluginKind as TKind
from nnstreamer_tpu_torch.core.registry import registry as tregistry
from nnstreamer_tpu_torch.core.config import Config
from nnstreamer_tpu_torch.core.errors import (
    BackendError, NegotiationError, PipelineError)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def both_custom():
    """register(name, fn, ...) in both packages; unregistered after."""
    names = []

    def reg(name, *a, **kw):
        names.append(name)
        jcustom.register_custom_easy(name, *a, **kw)
        tcustom.register_custom_easy(name, *a, **kw)

    yield reg
    for n in names:
        jcustom.unregister_custom_easy(n)
        tcustom.unregister_custom_easy(n)


def host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def same_results(got, ref):
    """Sink results bit for bit: count, pts, format, dtype, shape, bytes."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.pts == r.pts and g.format.name == r.format.name
        assert g.num_tensors == r.num_tensors
        for a, b in zip(g.tensors, r.tensors):
            a, b = host(a), host(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def run_launch(nns, launch, frames, src="src", sink="out", timeout=60):
    pipe = nns.parse_launch(launch)
    runner = nns.PipelineRunner(pipe).start()
    Buf = JBuf if nns is jnns else TensorBuffer
    for i, f in enumerate(frames):
        pipe.get(src).push(Buf.of(*(f if isinstance(f, tuple) else (f,)),
                                  pts=i))
    pipe.get(src).end()
    runner.wait(timeout)
    runner.stop()
    return pipe.get(sink).results


def both_launch(launch, frames, **kw):
    ref = run_launch(jnns, launch, frames, **kw)
    got = run_launch(tnns, launch, frames, **kw)
    same_results(got, ref)
    return got, ref


# -- framework=custom ---------------------------------------------------------

@pytest.mark.parametrize("framework", ["custom", "custom-easy"])
def test_custom_registered_callable_matches_jax(both_custom, framework):
    both_custom("sc_scale", lambda ts: (ts[0] * 0.5 + ts[0].max(),))
    frames = [np.random.default_rng(i).normal(size=(2, 3)).astype(np.float32)
              for i in range(3)]
    got, _ = both_launch(
        f"appsrc name=src dims=3:2 types=float32 ! tensor_filter "
        f"framework={framework} model=sc_scale ! tensor_sink name=out",
        frames)
    np.testing.assert_array_equal(host(got[1].tensors[0]),
                                  frames[1] * 0.5 + frames[1].max())


def test_custom_python_path_with_spec_attrs(tmp_path, monkeypatch):
    """model=pkg.module:callable, its in/out specs on the callable — the
    same module file imported by each package's backend."""
    (tmp_path / "sc_user_mod.py").write_text(textwrap.dedent("""
        import numpy as np

        def twice(ts):
            return (np.asarray(ts[0]) * 2).astype(np.int32), ts[0]
        """))
    monkeypatch.syspath_prepend(str(tmp_path))
    import sc_user_mod

    sc_user_mod.twice.out_spec = None
    frames = [np.arange(6, dtype=np.int32).reshape(2, 3) + i
              for i in range(2)]
    got, _ = both_launch(
        "appsrc name=src dims=3:2 types=int32 ! tensor_filter "
        "framework=custom model=sc_user_mod:twice ! tensor_sink name=out",
        frames)
    assert got[0].num_tensors == 2
    b = tcustom.CustomBackend()
    b.open({"model": "sc_user_mod:twice"})
    sc_user_mod.twice.in_spec = TensorsSpec.of(TensorInfo((2, 3),
                                                          DType.INT32))
    b.open({"model": "sc_user_mod:twice"})
    assert b.get_model_info()[0].tensors[0].shape == (2, 3)
    with pytest.raises(BackendError, match="cannot load custom model"):
        b.open({"model": "sc_user_mod:nope"})


def test_custom_infer_out_probe_and_refusals(both_custom):
    """infer_out drives an adaptive output spec; a callable with no spec
    is probed once with zeros (numpy in JAX, tensors on the filter's
    device in the port); missing models fail loud."""
    both_custom("sc_sum_rows", lambda ts: (ts[0].sum(axis=-1),))
    jcustom.register_custom_easy(
        "sc_adapt", lambda ts: (ts[0][..., :1],),
        infer_out=lambda s: JSpec.of(JInfo(s.tensors[0].shape[:-1] + (1,),
                                           s.tensors[0].dtype)))
    tcustom.register_custom_easy(
        "sc_adapt", lambda ts: (ts[0][..., :1],),
        infer_out=lambda s: TensorsSpec.of(TensorInfo(
            s.tensors[0].shape[:-1] + (1,), s.tensors[0].dtype)))
    try:
        frames = [np.arange(8, dtype=np.float32).reshape(2, 4)]
        for model, shape in (("sc_sum_rows", (2,)), ("sc_adapt", (2, 1))):
            got, _ = both_launch(
                f"appsrc name=src dims=4:2 types=float32 ! tensor_filter "
                f"framework=custom model={model} ! tensor_sink name=out",
                frames)
            assert host(got[0].tensors[0]).shape == shape
    finally:
        jcustom.unregister_custom_easy("sc_adapt")
        tcustom.unregister_custom_easy("sc_adapt")
    b = tcustom.CustomBackend()
    with pytest.raises(BackendError, match="requires model"):
        b.open({})
    with pytest.raises(BackendError, match="no custom model"):
        b.open({"model": "sc_not_registered"})


def test_custom_tensors_stay_where_they_are(both_custom):
    """N16: the callable gets the frame's tensors where they are — a
    tensor after a torch filter arrives as that very tensor, a host array
    from the appsrc as numpy — no forced sync is made, and a numpy output
    goes downstream as the same object, uncopied."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.runtime import sync

    seen, made = [], []

    def record(ts):
        seen.append(ts[0])
        out = host(ts[0]) * 2.0
        made.append(out)
        return (out,)

    tcustom.register_custom_easy("sc_record", record)
    try:
        for upstream in ("", "tensor_filter name=m ! "):
            seen.clear()
            made.clear()
            pipe = tnns.parse_launch(
                f"appsrc name=src dims=3 types=float32 ! {upstream}"
                f"tensor_filter framework=custom model=sc_record ! "
                f"tensor_sink name=out to-host=false")
            model_out = []
            if upstream:
                pipe.get("m").set_props(model=ModelBundle(
                    fn=lambda p, a: model_out.append(a + 1) or model_out[-1]))
            runner = tnns.PipelineRunner(pipe).start()
            syncs = sync.forced_sync_count()
            pipe.get("src").push(TensorBuffer.of(np.ones(3, np.float32)))
            pipe.get("src").end()
            runner.wait(30)
            runner.stop()
            assert sync.forced_sync_count() == syncs
            res = pipe.get("out").results
            assert res[0].tensors[0] is made[-1]
            if upstream:
                assert seen[-1] is model_out[-1]
                assert isinstance(seen[-1], torch.Tensor)
            else:
                assert isinstance(seen[-1], np.ndarray)
            np.testing.assert_array_equal(made[-1], 2.0 * host(seen[-1]))
    finally:
        tcustom.unregister_custom_easy("sc_record")


def test_custom_probe_is_torch_on_the_filter_device():
    """N16's probe: a callable written in torch ops negotiates (the probe
    is zero tensors on the filter's device, not numpy), its spec follows
    torch's promotion (uint8 × 0.5 → float32, where numpy gives float64),
    and in a pipeline whose frames reach it as tensors it emits what it
    negotiated. A callable whose frames promote otherwise than its probe
    (host uint8 arrays) fails loud on the frame instead of emitting a
    dtype it did not negotiate; a callable that takes only numpy fails
    the probe and names out_spec=."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle

    seen = []

    def torch_only(ts):
        seen.append(ts[0])
        return (torch.sigmoid(ts[0] * 0.5),)

    tcustom.register_custom_easy("sc_torch_only", torch_only)
    tcustom.register_custom_easy("sc_half", lambda ts: (ts[0] * 0.5,))
    u8 = TensorsSpec.of(TensorInfo((2, 3), DType.UINT8))
    frame = np.arange(6, dtype=np.uint8).reshape(2, 3)
    try:
        b = tcustom.CustomBackend()
        b.open({"model": "sc_torch_only", "accelerator": "cpu"})
        out_spec = b.set_input_info(u8)
        assert isinstance(seen[0], torch.Tensor)
        assert seen[0].device.type == "cpu" and seen[0].dtype == torch.uint8
        assert out_spec.tensors[0].dtype == DType.FLOAT32
        assert out_spec.tensors[0].shape == (2, 3)

        pipe = tnns.parse_launch(
            "appsrc name=src dims=3:2 types=uint8 ! tensor_filter name=m ! "
            "tensor_filter name=c framework=custom model=sc_torch_only ! "
            "tensor_sink name=out")
        pipe.get("m").set_props(model=ModelBundle(fn=lambda p, a: a + 0))
        runner = tnns.PipelineRunner(pipe).start()
        pipe.get("src").push(TensorBuffer.of(frame))
        pipe.get("src").end()
        runner.wait(30)
        runner.stop()
        got = host(pipe.get("out").results[0].tensors[0])
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            got, torch.sigmoid(torch.from_numpy(frame) * 0.5).numpy())

        b = tcustom.CustomBackend()
        b.open({"model": "sc_half", "accelerator": "cpu"})
        assert b.set_input_info(u8).tensors[0].dtype == DType.FLOAT32
        assert b.run((torch.from_numpy(frame),))[0].dtype == torch.float32
        with pytest.raises(BackendError, match="negotiated"):
            b.run((frame,))
        # a numpy-only callable (ndarray.astype) does not take the probe:
        # it declares its output spec instead
        tcustom.register_custom_easy(
            "sc_numpy_only", lambda ts: (ts[0].astype(np.float32),))
        b = tcustom.CustomBackend()
        b.open({"model": "sc_numpy_only", "accelerator": "cpu"})
        with pytest.raises(BackendError, match="zero tensors"):
            b.set_input_info(u8)
    finally:
        for n in ("sc_torch_only", "sc_half", "sc_numpy_only"):
            tcustom.unregister_custom_easy(n)


def test_custom_repo_loop_matches_jax(both_custom):
    """tests/test_elements.py's repo feedback loop with framework=custom
    add_pair, in both packages: the running sum, bit for bit."""
    both_custom("sc_add_pair", lambda ts: (ts[0] + ts[1],))
    res = {}
    for nns, el, Buf, Spec, Info, F32 in (
            (jnns, jel, JBuf, JSpec, JInfo, JDType.FLOAT32),
            (tnns, tel, TensorBuffer, TensorsSpec, TensorInfo,
             DType.FLOAT32)):
        el.REPO.reset()
        state = el.TensorRepoSrc(name="state", slot=27, dims="4", count=4)
        xs = el.AppSrc(spec=Spec.of(Info((4,), F32)), name="xs")
        mux = el.TensorMux(name="m", sync_mode="nosync")
        f = el.TensorFilter(name="f", framework="custom", model="sc_add_pair")
        tee = el.Tee(name="t")
        back = el.TensorRepoSink(name="back", slot=27)
        sink = el.TensorSink(name="s")
        pipe = nns.Pipeline()
        for e in (state, xs, mux, f, tee, back, sink):
            pipe.add(e)
        for a, b, *pads in ((state, mux, 0, 0), (xs, mux, 0, 1), (mux, f),
                            (f, tee), (tee, back, 0, 0), (tee, sink, 1, 0)):
            pipe.link(a, b, *pads)
        runner = nns.PipelineRunner(pipe).start()
        for i in range(3):
            xs.push(Buf.of(np.ones(4, np.float32), pts=i))
        xs.end()
        runner.wait(30)
        runner.stop()
        res[nns] = sink.results
    same_results(res[tnns], res[jnns])
    assert [float(host(r.tensors[0])[0]) for r in res[tnns]] == [1, 2, 3]


def test_single_shot_custom_backend(both_custom):
    """tests/test_runtime_extras.py's SingleShot on framework=custom."""
    from nnstreamer_tpu_torch.single import SingleShot

    both_custom("sc_add1", lambda ts: (ts[0] + 1,))
    r = SingleShot(model="sc_add1", framework="custom",
                   input_spec=TensorsSpec.of(TensorInfo((3,), DType.FLOAT32)))
    out, = r.invoke(np.zeros((3,), np.float32))
    np.testing.assert_array_equal(host(out), [1, 1, 1])
    assert r.output_info.tensors[0].shape == (3,)
    r.close()


# -- framework=python3 --------------------------------------------------------

PASSTHROUGH = '''
import numpy as np
import nnstreamer_python as nns

D1, D2, D3, D4 = 3, 280, 40, 1


class CustomFilter(object):
    def __init__(self, *args):
        self.input_dims = [nns.TensorShape([D1, D2, D3, D4], np.uint8)]
        self.output_dims = [nns.TensorShape([D1, D2, D3, D4], np.uint8)]

    def getInputDim(self):
        return self.input_dims

    def getOutputDim(self):
        return self.output_dims

    def invoke(self, input_array):
        return input_array
'''

SCALER = '''
import numpy as np
import nnstreamer_python as nns


class CustomFilter(object):
    def __init__(self, *args):
        self.new_x, self.new_y = 0, 0
        if len(args) == 1:
            w, h = args[0].split("x")
            self.new_x, self.new_y = int(w), int(h)

    def setInputDim(self, input_dims):
        if len(input_dims) != 1:
            return None
        self.input_dims = input_dims
        dims = list(input_dims[0].getDims())
        if self.new_x > 0 and self.new_y > 0:
            dims[1], dims[2] = self.new_x, self.new_y
        self.output_dims = [nns.TensorShape(dims, input_dims[0].getType())]
        return self.output_dims

    def invoke(self, input_array):
        ind, outd = self.input_dims[0].getDims(), self.output_dims[0].getDims()
        ch, iw, ih = ind[0], ind[1], ind[2]
        ow, oh = outd[1], outd[2]
        src = input_array[0].reshape(ih, iw, ch)
        ys = [int(y * ih / oh) for y in range(oh)]
        xs = [int(x * iw / ow) for x in range(ow)]
        return [src[ys][:, xs].ravel()]
'''

TWO_IN = '''
import numpy as np
import nnstreamer_python as nns


class CustomFilter(object):
    def setInputDim(self, input_dims):
        self.out = [nns.TensorShape(list(input_dims[0].getDims()),
                                    np.float32)]
        return self.out

    def invoke(self, input_array):
        return [input_array[0].astype(np.float32) + input_array[1].sum()]
'''


@pytest.fixture
def scripts(tmp_path):
    out = {}
    for name, text in (("passthrough", PASSTHROUGH), ("scaler", SCALER),
                       ("two_in", TWO_IN)):
        p = tmp_path / f"{name}.py"
        p.write_text(text)
        out[name] = str(p)
    return out


def _nn_scale(img, out_w, out_h):
    """Independent nearest-neighbour decode (checkScaledTensor.py)."""
    _, in_h, in_w, ch = img.shape
    out = np.empty((1, out_h, out_w, ch), img.dtype)
    for y in range(out_h):
        for x in range(out_w):
            out[0, y, x] = img[0, int(y * in_h / out_h),
                               int(x * in_w / out_w)]
    return out


def test_python3_passthrough_byte_identity(scripts):
    frame = np.random.default_rng(0).integers(0, 256, (1, 40, 280, 3),
                                              np.uint8)
    got, _ = both_launch(
        f"appsrc name=src dims=3:280:40:1 types=uint8 ! tensor_filter "
        f"framework=python3 model={scripts['passthrough']} ! "
        f"tensor_sink name=out", [frame])
    np.testing.assert_array_equal(host(got[0].tensors[0]), frame)


@pytest.mark.parametrize("out_w,out_h", [(32, 24), (128, 96)])
def test_python3_scaler_adaptive_custom_arg(scripts, out_w, out_h):
    """setInputDim adapts to the input; custom= reaches the constructor
    verbatim; the output is the independent nearest-neighbour decode."""
    frame = np.random.default_rng(1).integers(0, 256, (1, 48, 64, 3),
                                              np.uint8)
    got, _ = both_launch(
        f"appsrc name=src dims=3:64:48:1 types=uint8 ! tensor_filter "
        f"framework=python3 model={scripts['scaler']} custom={out_w}x{out_h}"
        f" ! tensor_sink name=out", [frame])
    out = host(got[0].tensors[0])
    assert out.shape == (1, out_h, out_w, 3)
    np.testing.assert_array_equal(out, _nn_scale(frame, out_w, out_h))


def test_python3_reload_keeps_custom_args_and_negotiation(scripts):
    """The reload keeps custom= and re-drives setInputDim, in both."""
    x = np.random.default_rng(4).integers(0, 256, (1, 12, 16, 3), np.uint8)
    outs = []
    for mod, Spec, Info, U8 in ((jpy3, JSpec, JInfo, JDType.UINT8),
                                (tpy3, TensorsSpec, TensorInfo, DType.UINT8)):
        b = mod.Python3ScriptBackend()
        b.open({"model": scripts["scaler"], "custom": "8x6"})
        out = b.set_input_info(Spec.of(Info((1, 12, 16, 3), U8)))
        assert out.tensors[0].shape == (1, 6, 8, 3)
        y1 = np.asarray(b.invoke((x,))[0])
        b.reload(scripts["scaler"])
        y2 = np.asarray(b.invoke((x,))[0])
        np.testing.assert_array_equal(y1, y2)
        outs.append(y1)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_python3_one_host_transfer_a_frame(scripts, monkeypatch):
    """A frame of two tensors reaches the script through ONE to_host
    call (one forced sync when they are CUDA tensors), not one per
    tensor; the outputs are host arrays."""
    calls = []
    real = tpy3.to_host

    def counting(tensors, *a, **kw):
        calls.append(len(tensors))
        return real(tensors, *a, **kw)

    monkeypatch.setattr(tpy3, "to_host", counting)
    b = tpy3.Python3ScriptBackend()
    b.open({"model": scripts["two_in"]})
    b.set_input_info(TensorsSpec.of(TensorInfo((2, 3), DType.INT16),
                                    TensorInfo((4,), DType.FLOAT32)))
    xs = (torch.arange(6, dtype=torch.int16).reshape(2, 3),
          torch.ones(4))
    out, = b.invoke(xs)
    assert calls == [2]
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    np.testing.assert_array_equal(out, np.arange(6).reshape(2, 3) + 4.0)


def test_python3_invalid_scripts_fail_loud(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("x = 1\n")
    broken = tmp_path / "broken.py"
    broken.write_text("import nnstreamer_python\nraise RuntimeError('boom')\n")
    raising = tmp_path / "raising.py"
    raising.write_text("class CustomFilter:\n    def __init__(self, *a):\n"
                       "        raise ValueError('no')\n")
    b = tpy3.Python3ScriptBackend()
    with pytest.raises(BackendError, match="CustomFilter"):
        b.open({"model": str(bad)})
    with pytest.raises(BackendError, match="failed to import.*boom"):
        b.open({"model": str(broken)})
    with pytest.raises(BackendError, match="raised ValueError"):
        b.open({"model": str(raising)})
    with pytest.raises(BackendError, match="\\.py"):
        b.open({"model": "model.tflite"})
    with pytest.raises(BackendError, match="does not exist"):
        b.open({"model": str(tmp_path / "missing.py")})
    with pytest.raises(NegotiationError, match="CustomFilter"):
        tnns.parse_launch(f"appsrc dims=4 ! tensor_filter framework=python3 "
                          f"model={bad} ! fakesink").negotiate()


def test_python3_shims_stay_apart(scripts):
    """Each package's scripts see that package's TensorShape, whichever
    shim was installed last."""
    tcls = tpy3.load_script_class(scripts["passthrough"], "CustomFilter")
    jcls = jpy3.load_script_class(scripts["passthrough"], "CustomFilter")
    assert isinstance(tcls().getInputDim()[0], tpy3.TensorShape)
    assert isinstance(jcls().getInputDim()[0], jpy3.TensorShape)
    assert not isinstance(tcls().getInputDim()[0], jpy3.TensorShape)


# -- the script codecs --------------------------------------------------------

DECODER = '''
import numpy as np
import nnstreamer_python as nns


class CustomDecoder(object):
    def getOutCaps(self):
        return bytes("other/tpu-script-wire", "UTF-8")

    def decode(self, raw_data, in_info, rate_n, rate_d):
        out = [np.array([len(raw_data), rate_n, rate_d], np.uint32).tobytes()]
        for raw, info in zip(raw_data, in_info):
            dims = np.array(info.getDims(), np.uint32)
            code = np.array([np.dtype(info.getType()).num], np.uint32)
            out += [dims.tobytes(), code.tobytes(),
                    np.array([raw.size], np.uint32).tobytes(),
                    raw.tobytes()]
        return b"".join(out)
'''

CONVERTER = '''
import numpy as np
import nnstreamer_python as nns

TYPES = {np.dtype(t).num: np.dtype(t) for t in
         (np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
          np.float32, np.float64, np.int64, np.uint64)}


class CustomConverter(object):
    def convert(self, input_array):
        data = input_array[0].tobytes()
        n, rate_n, rate_d = np.frombuffer(data[:12], np.uint32)
        off, infos, raws = 12, [], []
        for _ in range(int(n)):
            dims = [int(d) for d in np.frombuffer(data[off:off + 16],
                                                   np.uint32)]
            code = int(np.frombuffer(data[off + 16:off + 20], np.uint32)[0])
            size = int(np.frombuffer(data[off + 20:off + 24], np.uint32)[0])
            off += 24
            infos.append(nns.TensorShape(dims, TYPES[code]))
            raws.append(np.frombuffer(data[off:off + size], np.uint8))
            off += size
        return infos, raws, int(rate_n), int(rate_d)
'''


@pytest.fixture
def codecs(tmp_path):
    dec, conv = tmp_path / "dec.py", tmp_path / "conv.py"
    dec.write_text(DECODER)
    conv.write_text(CONVERTER)
    return str(dec), str(conv)


def test_script_codecs_roundtrip_matches_jax(codecs):
    """tensors → CustomDecoder bytes → CustomConverter → the original
    tensors (a FLEXIBLE stream), in both packages, bit for bit."""
    dec, conv = codecs
    rng = np.random.default_rng(2)
    frames = [(rng.integers(0, 256, (1, 4, 6, 3), np.uint8),
               rng.normal(size=(2, 5)).astype(np.float32))
              for _ in range(2)]
    got, _ = both_launch(
        f"appsrc name=src dims=3:6:4:1,5:2 types=uint8,float32 ! "
        f"tensor_decoder mode=python3 option1={dec} ! tensor_converter "
        f"mode=custom-script:{conv} ! tensor_sink name=out", frames)
    for g, f in zip(got, frames):
        assert g.format.name == "FLEXIBLE"
        np.testing.assert_array_equal(host(g.tensors[0]).reshape(f[0].shape),
                                      f[0])
        np.testing.assert_array_equal(host(g.tensors[1]).reshape(f[1].shape),
                                      f[1])


def test_script_decoder_after_a_filter(codecs):
    """The decoder reads a frame of tensors (a torch filter's output) on
    the host: its bytes are those of the same values from the host."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle

    dec, _ = codecs
    pipe = tnns.parse_launch(
        f"appsrc name=src dims=4:2 types=float32 ! tensor_filter name=m ! "
        f"tensor_decoder mode=python3 option1={dec} ! tensor_sink name=out")
    pipe.get("m").set_props(model=ModelBundle(fn=lambda p, a: (a * 3.0,)))
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    runner = tnns.PipelineRunner(pipe).start()
    pipe.get("src").push(TensorBuffer.of(x))
    pipe.get("src").end()
    runner.wait(30)
    runner.stop()
    ref = run_launch(tnns, f"appsrc name=src dims=4:2 types=float32 ! "
                           f"tensor_decoder mode=python3 option1={dec} ! "
                           f"tensor_sink name=out", [x * 3.0])
    assert host(pipe.get("out").results[0].tensors[0]).tobytes() == \
        host(ref[0].tensors[0]).tobytes()


def test_converter_script_may_return_bytes_raw_data(tmp_path):
    """tests/test_python3_filter.py's bytes raw_data case on the port."""
    script = tmp_path / "bytes_conv.py"
    script.write_text(
        "import numpy as np\n"
        "import nnstreamer_python as nns\n"
        "class CustomConverter(object):\n"
        "    def convert(self, input_array):\n"
        "        data = input_array[0].tobytes()\n"
        "        info = [nns.TensorShape([len(data), 1, 1, 1],"
        " np.uint8)]\n"
        "        return info, [data], 30, 1\n")
    from nnstreamer_tpu.elements.script_codec import Python3Converter as J
    from nnstreamer_tpu_torch.elements.script_codec import Python3Converter

    frame = np.arange(12, dtype=np.uint8)
    out = Python3Converter(str(script)).convert(TensorBuffer.of(frame))
    ref = J(str(script)).convert(JBuf.of(frame))
    got = host(out.tensors[0])
    assert got.shape == (1, 1, 1, 12) == np.asarray(ref.tensors[0]).shape
    np.testing.assert_array_equal(got.ravel(), frame)
    assert out.format.name == "FLEXIBLE"
    assert out.meta["rate"] == ref.meta["rate"] == (30, 1)


def test_script_codec_refusals(tmp_path, codecs):
    dec, _ = codecs
    invalid = tmp_path / "invalid_class.py"
    invalid.write_text("class CustomConverterWrong(object):\n    pass\n")
    with pytest.raises((BackendError, PipelineError), match="CustomConverter"):
        run_launch(tnns, f"appsrc name=src dims=4 types=uint8 ! "
                         f"tensor_converter mode=custom-script:{invalid} ! "
                         f"tensor_sink name=out", [np.zeros(4, np.uint8)])
    with pytest.raises(PipelineError, match="option1"):
        tnns.parse_launch("appsrc dims=4 ! tensor_decoder mode=python3 ! "
                          "fakesink")
    from nnstreamer_tpu_torch.elements.script_codec import Python3Decoder

    d = Python3Decoder()
    d.init({"option1": dec})
    with pytest.raises(PipelineError, match="rank-5"):
        d.decode(TensorBuffer.of(np.zeros((1, 1, 1, 1, 2), np.uint8)))


# -- plugin paths -------------------------------------------------------------

PLUGIN = '''
from {pkg}.core.registry import PluginKind, registry

registry.register(PluginKind.CONVERTER, {name!r}, object)
'''


def test_plugin_paths_each_package_loads_its_own(tmp_path, monkeypatch):
    """Both environment variables set: the port scans only
    NNSTREAMER_TPU_TORCH_PLUGINS, under its own module prefix; the JAX
    package only NNSTREAMER_TPU_PLUGINS."""
    jdir, tdir = tmp_path / "jax_plugins", tmp_path / "torch_plugins"
    jdir.mkdir()
    tdir.mkdir()
    (jdir / "jplug.py").write_text(PLUGIN.format(pkg="nnstreamer_tpu",
                                                 name="sc_jax_only"))
    (tdir / "tplug.py").write_text(PLUGIN.format(pkg="nnstreamer_tpu_torch",
                                                 name="sc_torch_only"))
    monkeypatch.setenv("NNSTREAMER_TPU_PLUGINS", str(jdir))
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PLUGINS", str(tdir))
    kind_t, kind_j = TKind.CONVERTER, JKind.CONVERTER
    monkeypatch.setattr(tregistry, "_scanned", False)
    monkeypatch.setattr(jregistry, "_scanned", False)
    try:
        tregistry.rescan()
        jregistry.rescan()
        assert tregistry.find(kind_t, "sc_torch_only") is object
        assert tregistry.find(kind_t, "sc_jax_only") is None
        assert jregistry.find(kind_j, "sc_jax_only") is object
        assert jregistry.find(kind_j, "sc_torch_only") is None
        mods = {n: m for n, m in sys.modules.items()
                if n.startswith(("nnstreamer_tpu_torch_plugin_",
                                 "nnstreamer_tpu_plugin_"))}
        port = [m.__file__ for n, m in mods.items()
                if n.startswith("nnstreamer_tpu_torch_plugin_")]
        assert port == [str(tdir / "tplug.py")]
        assert str(jdir / "jplug.py") not in port
    finally:
        tregistry.unregister(kind_t, "sc_torch_only")
        jregistry.unregister(kind_j, "sc_jax_only")
        for n in [n for n, m in sys.modules.items()
                  if getattr(m, "__file__", "") in (str(tdir / "tplug.py"),
                                                    str(jdir / "jplug.py"))]:
            del sys.modules[n]


def test_plugin_scan_on_a_miss_and_from_ini(tmp_path, monkeypatch):
    """A registry miss scans the paths once (the plugin is then found by
    name in a pipeline); `[common] plugin_paths` in an ini file adds
    directories after the environment's."""
    d = tmp_path / "lazy"
    d.mkdir()
    (d / "lazy_conv.py").write_text(textwrap.dedent('''
        import numpy as np
        from nnstreamer_tpu_torch.elements.converter import (
            ConverterSubplugin, register_converter)

        @register_converter("sc_lazy_double")
        class Double(ConverterSubplugin):
            def negotiate(self, in_spec):
                return in_spec

            def convert(self, buf):
                return buf.with_tensors((np.asarray(buf.tensors[0]) * 2,))
        '''))
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PLUGINS", str(d))
    monkeypatch.setattr(tregistry, "_scanned", False)
    kind = TKind.CONVERTER
    try:
        res = run_launch(tnns, "appsrc name=src dims=3 types=float32 ! "
                               "tensor_converter mode=custom:sc_lazy_double "
                               "! tensor_sink name=out",
                         [np.arange(3, dtype=np.float32)])
        np.testing.assert_array_equal(host(res[0].tensors[0]), [0, 2, 4])
    finally:
        tregistry.unregister(kind, "sc_lazy_double")
        for n in [n for n, m in sys.modules.items()
                  if getattr(m, "__file__", "") == str(d / "lazy_conv.py")]:
            del sys.modules[n]
    ini = tmp_path / "port.ini"
    ini.write_text(f"[common]\nplugin_paths = {tmp_path / 'a'}:{tmp_path}\n")
    assert Config(str(ini)).plugin_paths() == [d, tmp_path / "a", tmp_path]

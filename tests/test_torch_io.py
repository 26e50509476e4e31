"""The port's sources, converter modes, sinks, tensor metadata, sparse
codec and SingleShot (nnstreamer_tpu_torch/elements/{sources,converter,
sinks,sparse_elements}.py, tensor/{meta,sparse}.py, single.py) against
the JAX package's, on the CPU.

- the converter: video frames-per-tensor (shapes, rate, the frames),
  the audio sample adapter (tests/test_runtime.py, tests/
  test_streaming_models.py), text and octet frames, `mode=custom:<name>`
  through `register_converter`, a missing custom-script script (the
  scripts run in tests/test_torch_scripts.py);
- tensor_src, filesrc (.npy, .npz, raw; tests/test_runtime_extras.py),
  audiotestsrc, videotestsrc's solid pattern and is-live pacing (counted
  on a controlled clock, never timed), appsrc's rate;
- tensor_sink's signal-rate (a controlled clock), max-results and
  to-host=false (CPU tensors stay tensors), filesink's bytes and its
  truncation at negotiation;
- MetaHeader and the sparse codec (tests/test_tensor_core.py), each
  frame byte for byte JAX's;
- SingleShot (tests/test_runtime_extras.py; its custom-backend case
  waits for the custom backend).

Every stream is held to the JAX package's run of the same pipeline bit
for bit.
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.graph.media import AudioSpec as JAudio
from nnstreamer_tpu.graph.media import OctetSpec as JOctet
from nnstreamer_tpu.graph.media import TextSpec as JText
from nnstreamer_tpu.tensor import meta as jmeta
from nnstreamer_tpu.tensor import sparse as jsparse
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu.tensor.dtypes import DType as JDType
from nnstreamer_tpu_torch.core.errors import BackendError, PipelineError
from nnstreamer_tpu_torch.elements import converter as tconv
from nnstreamer_tpu_torch.elements import sinks as tsinks
from nnstreamer_tpu_torch.elements import sources as tsources
from nnstreamer_tpu_torch.graph.media import AudioSpec, OctetSpec, TextSpec
from nnstreamer_tpu_torch.tensor import meta as tmeta
from nnstreamer_tpu_torch.tensor import sparse as tsparse
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import (
    MediaType, TensorFormat, TensorInfo, TensorsSpec)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def same_results(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.pts == r.pts
        assert g.num_tensors == r.num_tensors
        for a, b in zip(g.tensors, r.tensors):
            a, b = host(a), host(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def both(desc, pushes=(), props=None, sink="s"):
    """Run `desc` in both packages (pushing `pushes` into the element
    named "in" after setting `props(pkg)` on it) → (port's results,
    JAX's, port's pipe)."""
    out, pipes = {}, {}
    for nns, buf_cls in ((jnns, JBuf), (tnns, TensorBuffer)):
        pipe = nns.parse_launch(desc)
        if props is not None:
            pipe.get("in").set_props(**props(nns))
        runner = nns.PipelineRunner(pipe).start()
        if pushes or props is not None:
            src = pipe.get("in")
            for p in pushes:
                src.push(p(buf_cls) if callable(p) else p)
            src.end()
        runner.wait(60)
        runner.stop()
        out[nns.__name__] = pipe.get(sink).results
        pipes[nns.__name__] = pipe
    got, ref = out["nnstreamer_tpu_torch"], out["nnstreamer_tpu"]
    same_results(got, ref)
    return got, ref, pipes["nnstreamer_tpu_torch"]


# -- converter ---------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3])
def test_converter_video_frames_per_tensor(n):
    got, _, pipe = both(
        "videotestsrc width=4 height=4 num-buffers=7 pattern=random ! "
        f"tensor_converter name=c frames-per-tensor={n} ! "
        "tensor_sink name=s")
    assert len(got) == 7 // n
    assert got[0].tensors[0].shape == (n, 4, 4, 3)
    spec = pipe.get("c").out_specs[0]
    from fractions import Fraction

    assert spec.rate == Fraction(30, n)


def _audio(nns):
    cls = JAudio if nns is jnns else AudioSpec
    return {"spec": cls(sample_rate=8000, channels=2, sample_format="S16LE")}


def test_converter_audio_adapter():
    rng = np.random.default_rng(1)
    chunks = [rng.integers(-3000, 3000, size=(k, 2)).astype(np.int16)
              for k in (100, 100, 37, 163, 100)]
    got, _, _ = both(
        "appsrc name=in ! tensor_converter frames-per-tensor=160 ! "
        "tensor_sink name=s",
        pushes=[lambda B, c=c: B.of(c, pts=i) for i, c in enumerate(chunks)],
        props=_audio)
    # 500 samples → 3 complete 160-sample tensors, 20 dropped at EOS
    assert len(got) == 3
    assert got[0].tensors[0].shape == (160, 2)
    np.testing.assert_array_equal(
        np.concatenate([g.tensors[0] for g in got]),
        np.concatenate(chunks)[:480])


def test_converter_audio_channel_mismatch_raises():
    c = tconv.TensorConverter(name="c", frames_per_tensor=4)
    c.in_specs = [AudioSpec(channels=2)]
    c.out_specs = c.negotiate(c.in_specs)
    with pytest.raises(PipelineError, match="3 channels"):
        c.process(0, TensorBuffer.of(np.zeros((5, 3), np.int16)))


def test_audiotestsrc_through_adapter():
    for wave in ("sine", "noise"):
        got, _, _ = both(
            f"audiotestsrc num-buffers=4 samples-per-buffer=100 wave={wave} "
            "channels=2 seed=3 ! tensor_converter frames-per-tensor=160 ! "
            "tensor_sink name=s")
        # 400 samples in → 2 complete 160-sample tensors (80 dropped)
        assert len(got) == 2
        assert got[0].tensors[0].shape == (160, 2)
        assert got[0].tensors[0].dtype == np.int16
    got, _, _ = both("audiotestsrc num-buffers=2 format=F32LE "
                     "samples-per-buffer=64 ! tensor_sink name=s")
    assert got[0].tensors[0].dtype == np.float32


def _text(nns):
    return {"spec": (JText if nns is jnns else TextSpec)()}


def test_converter_text_pads_and_clips():
    texts = ["hello", "a longer line than eight", "", b"\x01\x02"]
    got, _, _ = both(
        "appsrc name=in ! tensor_converter input-dim=8 ! tensor_sink name=s",
        pushes=[lambda B, t=t: B(tensors=(np.zeros(1, np.uint8),), pts=0,
                                 meta={"text": t}) for t in texts],
        props=_text)
    assert [bytes(g.tensors[0]) for g in got] == [
        b"hello\0\0\0", b"a longer", b"\0" * 8, b"\x01\x02" + b"\0" * 6]


def _octet(nns):
    return {"spec": (JOctet if nns is jnns else OctetSpec)()}


def test_converter_octet_frames():
    vals = np.arange(6, dtype=np.float32).reshape(2, 3)
    raw = np.frombuffer(vals.tobytes(), np.uint8)
    got, _, _ = both(
        "appsrc name=in ! tensor_converter input-dim=3:2 "
        "input-type=float32 ! tensor_sink name=s",
        pushes=[lambda B: B.of(raw, pts=0)], props=_octet)
    np.testing.assert_array_equal(got[0].tensors[0], vals)
    c = tconv.TensorConverter(name="c", input_dim="3:2", input_type="float32")
    c.in_specs = [OctetSpec()]
    c.out_specs = c.negotiate(c.in_specs)
    with pytest.raises(PipelineError, match="23 bytes"):
        c.process(0, TensorBuffer.of(np.zeros(23, np.uint8)))


@pytest.mark.parametrize("spec,props,match", [
    (TextSpec(), {}, "input-dim"),
    (OctetSpec(), {"input_dim": "4"}, "input-type"),
    (AudioSpec(), {"frames_per_tensor": 0}, "frames-per-tensor"),
    (AudioSpec(), {"mode": "custom"}, "custom:<subplugin name>"),
])
def test_converter_refusals(spec, props, match):
    with pytest.raises(Exception, match=match):
        tconv.TensorConverter(name="c", **props).negotiate([spec])


def test_converter_custom_subplugin_and_script_refusal():
    @tconv.register_converter("torch_io_double")
    class Double(tconv.ConverterSubplugin):
        def negotiate(self, in_spec):
            return TensorsSpec.of(TensorInfo((3,), DType.FLOAT32))

        def convert(self, buf):
            return buf.with_tensors(
                (np.asarray(buf.tensors[0], np.float32) * 2,))

    from nnstreamer_tpu_torch.core.registry import PluginKind, registry

    try:
        pipe = tnns.parse_launch(
            "appsrc name=in dims=3 types=float32 ! "
            "tensor_converter mode=custom:torch_io_double ! "
            "tensor_sink name=s")
        runner = tnns.PipelineRunner(pipe).start()
        pipe.get("in").push(np.arange(3, dtype=np.float32))
        pipe.get("in").end()
        runner.wait(30)
        runner.stop()
        np.testing.assert_array_equal(pipe.get("s").results[0].tensors[0],
                                      [0, 2, 4])
        assert Double.NAME == "torch_io_double"
    finally:
        registry.unregister(PluginKind.CONVERTER, "torch_io_double")
    with pytest.raises(PipelineError, match="no converter plugin"):
        tnns.parse_launch("appsrc dims=3 ! tensor_converter "
                          "mode=custom:nope ! fakesink").negotiate()
    # custom-script runs a python3 CustomConverter script
    # (tests/test_torch_scripts.py); a missing one fails loud, naming it
    with pytest.raises(BackendError, match="conv.py.*does not exist"):
        tnns.parse_launch("appsrc dims=3 ! tensor_converter "
                          "mode=custom-script:conv.py ! fakesink").negotiate()


# -- sources -----------------------------------------------------------------

def test_tensor_src_arrays_and_buffers():
    arrs = [np.full((2, 2), i, np.int32) for i in range(3)]
    res = {}
    for nns in (jnns, tnns):
        from importlib import import_module

        el = import_module(nns.__name__ + ".elements")
        buf_cls = JBuf if nns is jnns else TensorBuffer
        for data in (arrs, [buf_cls.of(a, pts=10 * i)
                            for i, a in enumerate(arrs)]):
            src = el.TensorSrc(name="src", data=data, rate="5/1")
            sink = el.TensorSink(name="s")
            pipe = nns.Pipeline()
            pipe.add(src)
            pipe.add(sink)
            pipe.link(src, sink)
            nns.run_pipeline(pipe, timeout=30)
            res.setdefault(nns.__name__, []).append(sink.results)
            assert src.out_specs[0].rate == 5
    for got, ref in zip(res["nnstreamer_tpu_torch"], res["nnstreamer_tpu"]):
        same_results(got, ref)
    with pytest.raises(PipelineError, match="data="):
        tsources.TensorSrc(name="x").output_spec()


def test_filesrc_npy_and_raw(tmp_path):
    arr = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    npy = tmp_path / "frames.npy"
    np.save(npy, arr)
    res, _, _ = both(f"filesrc location={npy} ! tensor_sink name=s")
    assert len(res) == 4
    np.testing.assert_array_equal(res[2].tensors[0], arr[2])
    res, _, _ = both(f"filesrc location={npy} frames-per-file=1 ! "
                     "tensor_sink name=s")
    assert len(res) == 1 and res[0].tensors[0].shape == (4, 3, 2)

    raw = tmp_path / "frames.raw"
    raw.write_bytes(np.arange(12, dtype=np.uint8).tobytes())
    res2, _, _ = both(f"filesrc location={raw} dims=4 types=uint8 ! "
                      "tensor_sink name=s")
    assert len(res2) == 3
    np.testing.assert_array_equal(res2[0].tensors[0], [0, 1, 2, 3])


def test_filesrc_npz_loop_and_refusals(tmp_path):
    npz = tmp_path / "frames.npz"
    np.savez(npz, b=np.ones((2, 2), np.int16), a=np.zeros((2, 2), np.int16))
    res, _, _ = both(f"filesrc location={npz} ! tensor_sink name=s")
    assert [int(r.tensors[0][0, 0]) for r in res] == [0, 1]   # by key
    src = tsources.FileSrc(name="f", location=str(npz), loop=True)
    gen = src.generate()
    assert [int(next(gen).tensors[0][0, 0]) for _ in range(5)] == \
        [0, 1, 0, 1, 0]
    raw = tmp_path / "odd.raw"
    raw.write_bytes(b"\0" * 7)
    for props, match in (({}, "location="),
                         ({"location": str(tmp_path / "no.npy")}, "not found"),
                         ({"location": str(raw)}, "dims="),
                         ({"location": str(raw), "dims": "2",
                           "types": "int16"}, "multiple")):
        with pytest.raises(PipelineError, match=match):
            tsources.FileSrc(name="f", **props)


def test_filesrc_rate_paces_on_a_controlled_clock(tmp_path, monkeypatch):
    npy = tmp_path / "f.npy"
    np.save(npy, np.zeros((3, 2), np.float32))
    slept = []
    monkeypatch.setattr(tsources, "_sleep", slept.append)
    src = tsources.FileSrc(name="f", location=str(npy), rate="4/1")
    pts = [b.pts for b in src.generate()]
    assert slept == [0.25] * 3
    assert pts == [0, 250_000_000, 500_000_000]


def test_videotestsrc_solid_and_live_pacing(monkeypatch):
    got, _, _ = both("videotestsrc width=5 height=3 num-buffers=3 "
                     "pattern=solid solid-color=42 ! tensor_sink name=s")
    assert all((g.tensors[0] == 42).all() for g in got)
    slept = []
    monkeypatch.setattr(tsources, "_sleep", slept.append)
    pipe = tnns.parse_launch("videotestsrc width=2 height=2 num-buffers=5 "
                             "framerate=20/1 is-live=true ! "
                             "tensor_sink name=s")
    tnns.run_pipeline(pipe, timeout=30)
    assert slept == [0.05] * 5          # one interval a frame, kept or not
    assert len(pipe.get("s").results) == 5
    with pytest.raises(Exception, match="gradient|random|solid"):
        tnns.run_pipeline(tnns.parse_launch(
            "videotestsrc num-buffers=1 pattern=zigzag ! tensor_sink"),
            timeout=30)


def test_appsrc_rate_sets_the_stream_rate():
    from fractions import Fraction

    for nns in (jnns, tnns):
        pipe = nns.parse_launch("appsrc name=in dims=2 rate=15/2 ! "
                                "tensor_sink name=s")
        pipe.negotiate()
        assert pipe.get("in").out_specs[0].rate == Fraction(15, 2)


# -- sinks -------------------------------------------------------------------

def test_tensor_sink_signal_rate_on_a_controlled_clock(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(tsinks, "_monotonic", lambda: now[0])
    calls = []
    sink = tsinks.TensorSink(name="s", signal_rate=2,
                             new_data=lambda b: calls.append(b.pts))
    for i, t in enumerate([0.0, 0.1, 0.3, 0.5, 0.6, 1.2, 1.3]):
        now[0] = 100.0 + t
        sink.render(TensorBuffer.of(np.zeros(1), pts=i))
    assert calls == [0, 3, 5]             # ≥ 0.5 s apart
    assert len(sink.results) == 7         # collection is never throttled


def test_tensor_sink_max_results_and_to_host():
    sink = tsinks.TensorSink(name="s", max_results=4, to_host=False)
    ts = [torch.full((2,), float(i)) for i in range(7)]
    for i, t in enumerate(ts):
        sink.render(TensorBuffer.of(t, pts=i))
    assert [r.pts for r in sink.results] == [3, 4, 5, 6]
    assert all(r.tensors[0] is ts[r.pts] for r in sink.results)
    hs = tsinks.TensorSink(name="h")
    hs.render(TensorBuffer.of(ts[1], pts=1))
    assert isinstance(hs.results[0].tensors[0], np.ndarray)
    got, _, _ = both("videotestsrc num-buffers=6 width=2 height=2 ! "
                     "tensor_converter ! tensor_sink name=s max-results=2 "
                     "collect=true")
    assert [g.pts for g in got] == [4 * 33333333, 5 * 33333333]


def test_filesink_bytes_and_truncation(tmp_path):
    out = {}
    for nns in (jnns, tnns):
        path = tmp_path / f"{nns.__name__}.bin"
        path.write_bytes(b"stale output of an earlier run")
        pipe = nns.parse_launch(
            "videotestsrc num-buffers=3 width=4 height=2 pattern=random ! "
            f"tensor_converter ! filesink location={path}")
        nns.run_pipeline(pipe, timeout=30)
        out[nns.__name__] = path.read_bytes()
        # zero buffers still truncate at negotiation
        empty = tmp_path / f"{nns.__name__}.empty"
        empty.write_bytes(b"stale")
        pipe = nns.parse_launch(f"appsrc name=in dims=2 ! "
                                f"filesink location={empty}")
        runner = nns.PipelineRunner(pipe).start()
        pipe.get("in").end()
        runner.wait(30)
        runner.stop()
        assert empty.read_bytes() == b""
    assert out["nnstreamer_tpu_torch"] == out["nnstreamer_tpu"]
    assert len(out["nnstreamer_tpu"]) == 3 * 4 * 2 * 3
    app = tmp_path / "app.bin"
    app.write_bytes(b"x")
    sink = tsinks.FileSink(name="f", location=str(app), append=True)
    sink.negotiate([TensorsSpec.of(TensorInfo((2,), DType.UINT8))])
    sink.render(TensorBuffer.of(torch.tensor([7, 8], dtype=torch.uint8)))
    sink.flush()
    assert app.read_bytes() == b"x\x07\x08"
    with pytest.raises(PipelineError, match="location="):
        tsinks.FileSink(name="f")


def test_filesink_writes_labels_text(tmp_path):
    """The decoder's label text lands as readable text, as JAX's."""
    out = {}
    for nns in (jnns, tnns):
        path = tmp_path / f"{nns.__name__}.txt"
        pipe = nns.parse_launch(
            "videotestsrc num-buffers=2 width=32 height=32 ! "
            "tensor_converter ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_filter model=zoo://mobilenet_v2?width=0.35&"
            "input_size=32&dtype=float32 ! "
            f"tensor_decoder mode=image_labeling ! filesink location={path}")
        nns.run_pipeline(pipe, timeout=120)
        out[nns.__name__] = path.read_bytes()
    assert out["nnstreamer_tpu_torch"]
    assert len(out["nnstreamer_tpu_torch"]) == len(out["nnstreamer_tpu"])


# -- meta and sparse (tests/test_tensor_core.py) -----------------------------

META_CASES = [((1, 224, 224, 3), "UINT8", "VIDEO", "FLEXIBLE", 0),
              ((4, 4), "FLOAT32", "TENSOR", "SPARSE", 3),
              ((7,), "BFLOAT16", "AUDIO", "STATIC", 0),
              (tuple(range(1, 17)), "INT64", "TEXT", "FLEXIBLE", 9)]


@pytest.mark.parametrize("shape,dt,media,fmt,extra", META_CASES)
def test_meta_header_pack_equals_jax(shape, dt, media, fmt, extra):
    from nnstreamer_tpu.tensor import info as jinfo

    j = jmeta.MetaHeader(shape=shape, dtype=getattr(JDType, dt),
                         media=getattr(jinfo.MediaType, media),
                         format=getattr(jinfo.TensorFormat, fmt), extra=extra)
    t = tmeta.MetaHeader(shape=shape, dtype=getattr(DType, dt),
                         media=getattr(MediaType, media),
                         format=getattr(TensorFormat, fmt), extra=extra)
    data = t.pack() + b"payload"
    assert t.pack() == j.pack()
    assert t.header_size == j.header_size
    parsed, off = tmeta.MetaHeader.unpack(data)
    assert parsed == t and data[off:] == b"payload"


def test_meta_header_refusals_and_info_roundtrip():
    with pytest.raises(ValueError, match="magic"):
        tmeta.MetaHeader.unpack(b"\x00" * 64)
    hdr = tmeta.MetaHeader(shape=(4, 4), dtype=DType.FLOAT32).pack()
    with pytest.raises(ValueError):
        tmeta.MetaHeader.unpack(hdr[:8])
    with pytest.raises(ValueError, match="truncated"):
        tmeta.MetaHeader.unpack(hdr[:-2])
    ti = TensorInfo((7, 5), DType.INT16)
    assert tmeta.MetaHeader.for_info(ti).to_info() == ti
    with pytest.raises(ValueError, match="rank"):
        tmeta.MetaHeader(shape=(), dtype=DType.UINT8).pack()


SPARSE = [np.float32, np.int16, np.uint8, np.float64]


@pytest.mark.parametrize("dtype", SPARSE)
def test_sparse_frames_equal_jax(dtype):
    rng = np.random.default_rng(0)
    dense = (rng.random((8, 16)) * 100).astype(dtype)
    dense[rng.random((8, 16)) < 0.9] = 0
    for arr in (dense, np.zeros((3, 3), dtype), np.array(3, dtype)):
        frame = tsparse.sparse_encode(arr)
        assert frame == jsparse.sparse_encode(arr)
        out = tsparse.sparse_decode(frame)
        np.testing.assert_array_equal(out.reshape(arr.shape), arr)
        assert tsparse.sparse_nbytes(arr) == jsparse.sparse_nbytes(arr)
        assert tsparse.sparse_nbytes(arr)[0] == len(frame)


def test_sparse_size_win_and_corrupt_frames():
    dense = np.zeros((100, 100), dtype=np.float32)
    dense[0, 0] = 1
    sp, dn = tsparse.sparse_nbytes(dense)
    assert sp < dn
    hdr = tmeta.MetaHeader(shape=(2, 2), dtype=DType.FLOAT32).pack()
    with pytest.raises(ValueError, match="not a sparse"):
        tsparse.sparse_decode(hdr + b"\x00" * 16)
    sp_hdr = tmeta.MetaHeader(shape=(2, 2), dtype=DType.FLOAT32,
                              format=TensorFormat.SPARSE, extra=1)
    with pytest.raises(ValueError, match="out of range"):
        tsparse.sparse_decode(sp_hdr.pack() + np.float32(1.0).tobytes()
                              + np.uint32(100).tobytes())
    big = tmeta.MetaHeader(shape=(2, 2), dtype=DType.FLOAT32,
                           format=TensorFormat.SPARSE, extra=10 ** 6)
    with pytest.raises(ValueError, match="nnz"):
        tsparse.sparse_decode(big.pack() + b"\x00" * 64)
    giant = tmeta.MetaHeader(shape=(1 << 22, 1 << 22), dtype=DType.FLOAT32,
                             format=TensorFormat.SPARSE, extra=0)
    with pytest.raises(ValueError, match="decode limit"):
        tsparse.sparse_decode(giant.pack())
    with pytest.raises(ValueError, match="truncated"):
        tsparse.sparse_decode(sp_hdr.pack())


def test_sparse_elements_on_tensors():
    """tensor_sparse_enc reads a tensor frame back first; its wire
    frames equal JAX's for the same values."""
    from nnstreamer_tpu.elements import TensorSparseEnc as JEnc
    from nnstreamer_tpu_torch.elements import TensorSparseDec, TensorSparseEnc

    arr = np.zeros((4, 4), np.float32)
    arr[1, 2], arr[3, 3] = 5.0, -1.5
    (_, ref), = JEnc(name="e").process(0, JBuf.of(arr, pts=0))
    enc, dec = TensorSparseEnc(name="e"), TensorSparseDec(name="d")
    (_, got), = enc.process(0, TensorBuffer.of(torch.from_numpy(arr), pts=0))
    assert got.format == TensorFormat.SPARSE
    assert got.tensors[0].tobytes() == np.asarray(ref.tensors[0]).tobytes()
    (_, back), = dec.process(0, got)
    np.testing.assert_array_equal(back.tensors[0], arr)
    from nnstreamer_tpu_torch.core.errors import NegotiationError

    with pytest.raises(NegotiationError, match="STATIC"):
        enc.negotiate([TensorsSpec(tensors=(TensorInfo((4,)),),
                                   format=TensorFormat.SPARSE)])
    with pytest.raises(NegotiationError, match="SPARSE"):
        dec.negotiate([TensorsSpec.of(TensorInfo((4,)))])


# -- SingleShot --------------------------------------------------------------

def test_single_shot_runner():
    from nnstreamer_tpu_torch.single import SingleShot

    with SingleShot(
            model="zoo://mobilenet_v2?width=0.35&input_size=64&dtype=float32"
    ) as runner:
        assert runner.input_info is not None
        out, = runner.invoke(np.zeros((1, 64, 64, 3), np.float32))
        assert out.shape == (1, 1001)
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        assert runner.output_info.tensors[0].shape == (1, 1001)
    assert tnns.SingleShot is SingleShot


def test_single_shot_matches_jax_on_a_callable_model():
    from nnstreamer_tpu.backends.xla import ModelBundle as JBundle
    from nnstreamer_tpu.single import SingleShot as JSingle
    from nnstreamer_tpu.tensor import info as jinfo
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.single import SingleShot

    x = np.random.default_rng(0).standard_normal((2, 5)).astype(np.float32)
    j = JSingle(model=JBundle(fn=lambda p, a: (a * 2.0 + 1.0, a.sum(-1))),
                input_spec=jinfo.TensorsSpec.of(jinfo.TensorInfo((2, 5))))
    t = SingleShot(model=ModelBundle(fn=lambda p, a: (a * 2.0 + 1.0,
                                                      a.sum(-1))),
                   input_spec=TensorsSpec.of(TensorInfo((2, 5))))
    assert [i.shape for i in t.output_info.tensors] == \
        [i.shape for i in j.output_info.tensors]
    for g, r in zip(t.invoke(x), j.invoke(x)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    j.close()
    t.close()


def test_single_shot_callable_set_input_info_and_fusion():
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.single import SingleShot

    r = SingleShot(model=ModelBundle(fn=lambda p, a: (a + 1,)),
                   framework="torch",
                   input_spec=TensorsSpec.of(TensorInfo((3,), DType.FLOAT32)))
    assert r.output_info.tensors[0].shape == (3,)
    out, = r.invoke(np.zeros((3,), np.float32))
    np.testing.assert_array_equal(out.numpy(), [1, 1, 1])
    r.set_fusion(pre=lambda ts: tuple(t * 2 for t in ts))
    out, = r.invoke(np.ones((3,), np.float32))
    np.testing.assert_array_equal(out.numpy(), [3, 3, 3])
    r.close()
    p = SingleShot(model="normalize_u8", framework="pallas",
                   input_spec=TensorsSpec.of(TensorInfo((2, 2),
                                                        DType.UINT8)))
    out, = p.invoke(np.full((2, 2), 255, np.uint8))
    np.testing.assert_array_equal(out.numpy(), np.ones((2, 2)))
    p.close()
    with pytest.raises(PipelineError, match="no filter plugin"):
        SingleShot(model="x", framework="nope")

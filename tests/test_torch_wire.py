"""The port's wire format, wire codec, native library and ipc elements
(nnstreamer_tpu_torch/edge/wire.py, elements/{wire_codec,ipc}.py,
native/) against the JAX package's, on the CPU.

- wire frames byte for byte JAX's for every dtype (a port buffer of
  torch tensors and the same values as numpy in JAX), for meta headers
  (scalars, arrays, nested dicts, dropped values), pts none, client ids
  and FLEXIBLE frames; each package decodes the other's frames; corrupt
  frames refused (tests/test_edge.py);
- the `wire` decoder and `mode=custom:wire` converter round trip, their
  bytes JAX's;
- the native library built at first use with g++ (N18): the ring, EOS,
  back pressure and the wire validator (tests/test_native.py), a failed
  build and a missing g++ raising with the compiler's word; ipc_sink →
  ipc_src in one process, and ipc_sink in a spawned child process
  feeding ipc_src in the parent.
"""

import multiprocessing
import os
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.edge import wire as jwire
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu.tensor.info import TensorFormat as JFormat
from nnstreamer_tpu_torch import native
from nnstreamer_tpu_torch.core.errors import BackendError, StreamError
from nnstreamer_tpu_torch.edge import wire
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType, host_tensor
from nnstreamer_tpu_torch.tensor.info import TensorFormat

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ absent: the native library "
                                      "cannot be built here")


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


NP_TYPES = [np.int32, np.uint32, np.int16, np.uint16, np.int8, np.uint8,
            np.float64, np.float32, np.int64, np.uint64, np.float16,
            ml_dtypes.bfloat16]


def _values(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, shape, dtype=dt,
                            endpoint=True)
    return rng.normal(0, 100, shape).astype(dt)


@pytest.mark.parametrize("dtype", NP_TYPES,
                         ids=[np.dtype(t).name for t in NP_TYPES])
def test_wire_frames_are_jax_bytes_for_every_dtype(dtype):
    """A port buffer of torch tensors encodes to JAX's bytes for the same
    values; each package decodes the other's frame to the same values."""
    a = _values(dtype, (2, 3, 5), 1)
    b = _values(dtype, (7,), 2)
    ref = jwire.encode_buffer(JBuf.of(a, b, pts=99), client_id=3)
    got = wire.encode_buffer(TensorBuffer.of(host_tensor(a), b, pts=99),
                             client_id=3)
    assert got == ref
    out, cid = wire.decode_buffer(ref)
    back, _ = jwire.decode_buffer(got)
    assert cid == 3 and out.pts == back.pts == 99
    for x, y, z in zip(out.tensors, back.tensors, (a, b)):
        assert x.dtype == y.dtype == z.dtype
        assert x.tobytes() == np.asarray(y).tobytes() == z.tobytes()
    assert DType.from_np(out.tensors[0].dtype).name == np.dtype(
        dtype).name.upper()


@pytest.mark.parametrize("case", ["scalars", "arrays", "nested", "empty",
                                  "no_pts", "flexible", "scalar_tensor"])
def test_wire_meta_headers_are_jax_bytes(case):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    meta = {"scalars": {"label": "cat", "score": 0.75, "n": 3, "ok": True,
                        "none": None},
            "arrays": {"boxes": np.array([[1.0, 2.0, 3.0, 4.0, 0.9, 7.0]],
                                         np.float32),
                       "ids": np.arange(4, dtype=np.int64)},
            "nested": {"trace": {"hops": [{"at": 1, "el": "f"},
                                          {"at": 2, "el": "g"}]},
                       "bad": object(), "lst": [1, object(), "x"]},
            }.get(case, {})
    pts = None if case == "no_pts" else 1234567890123
    t = np.float32(5.0).reshape(()) if case == "scalar_tensor" else x
    kw = {}
    if case == "flexible":
        kw = {"format": TensorFormat.FLEXIBLE}
    jkw = {"format": JFormat.FLEXIBLE} if kw else {}
    jb = JBuf(tensors=(t,), pts=pts, meta=dict(meta), **jkw)
    tb = TensorBuffer(tensors=(torch.from_numpy(np.array(t)),), pts=pts,
                      meta=dict(meta), **kw)
    ref = jwire.encode_buffer(jb, client_id=42)
    assert wire.encode_buffer(tb, client_id=42) == ref
    out, cid = wire.decode_buffer(ref)
    assert cid == 42 and out.pts == pts and out.format.name == (
        "FLEXIBLE" if kw else "STATIC")
    if case == "arrays":
        np.testing.assert_array_equal(out.meta["boxes"], meta["boxes"])
        assert out.meta["ids"].dtype == np.int64
    if case == "nested":
        assert out.meta["trace"] == meta["trace"]
        assert "bad" not in out.meta and out.meta["lst"] == [1, "x"]


def test_wire_rejects_corrupt_frames():
    """tests/test_edge.py's corrupt-frame cases on the port."""
    buf = TensorBuffer.of(np.zeros((2, 2), np.float32))
    data = bytearray(wire.encode_buffer(buf))
    data[0] ^= 0xFF
    with pytest.raises(ValueError, match="magic"):
        wire.decode_buffer(bytes(data))
    with pytest.raises(ValueError):
        wire.decode_buffer(wire.encode_buffer(buf)[:10])
    with pytest.raises(ValueError, match="overruns"):
        wire.decode_buffer(wire.encode_buffer(buf)[:-1])


def test_wire_decoder_and_converter_roundtrip_match_jax():
    """appsrc → tensor_decoder mode=wire → tensor_converter
    mode=custom:wire → the original tensors; the decoder's bytes equal
    JAX's frame by frame, the converter's output too."""
    rng = np.random.default_rng(5)
    frames = [(rng.integers(0, 256, (1, 4, 6, 3), np.uint8),
               rng.normal(size=(3,)).astype(np.float32)) for _ in range(3)]
    launch = ("appsrc name=src dims=3:6:4:1,3 types=uint8,float32 ! "
              "tensor_decoder mode=wire ! tee name=t "
              "t. ! queue ! tensor_sink name=bytes "
              "t. ! queue ! tensor_converter mode=custom:wire ! "
              "tensor_sink name=out")
    res = {}
    for nns, Buf in ((jnns, JBuf), (tnns, TensorBuffer)):
        pipe = nns.parse_launch(launch)
        runner = nns.PipelineRunner(pipe).start()
        for i, (a, b) in enumerate(frames):
            pipe.get("src").push(Buf.of(a, b, pts=i))
        pipe.get("src").end()
        runner.wait(30)
        runner.stop()
        res[nns] = {k: pipe.get(k).results for k in ("bytes", "out")}
    for g, r in zip(res[tnns]["bytes"], res[jnns]["bytes"]):
        assert host(g.tensors[0]).tobytes() == host(r.tensors[0]).tobytes()
    got = res[tnns]["out"]
    assert [r.pts for r in got] == [0, 1, 2]
    for r, j, (a, b) in zip(got, res[jnns]["out"], frames):
        # the frame's own format rides the wire (STATIC here)
        assert r.format.name == j.format.name == "STATIC"
        np.testing.assert_array_equal(host(r.tensors[0]), a)
        np.testing.assert_array_equal(host(r.tensors[1]), b)


# -- the native library, built at first use -----------------------------------

_ring_counter = [0]


def _ring_name():
    _ring_counter[0] += 1
    return f"/nnstorch-test-{os.getpid()}-{_ring_counter[0]}"


@needs_gxx
def test_native_library_builds_at_first_use():
    """N18: the library is compiled from native/*.cc with g++ into
    build/native/, named by the sources' and flags' hash; the JAX
    package's prebuilt path is not read."""
    path = native.build()
    assert path.parent == native.ROOT / "build" / "native"
    assert path.name.startswith("libnnstpu-") and path.suffix == ".so"
    assert path == native.library_path() and path.exists()
    assert native.build() == path           # cached by hash
    assert native.require() is native.require()


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "native" / "nt_broken.cc"
    bad.parent.mkdir()
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "ROOT", tmp_path)
    monkeypatch.setattr(native, "SOURCES", (bad,))
    if shutil.which("g++") is not None:
        with pytest.raises(BackendError, match="(?s)g\\+\\+ failed.*error"):
            native.build()
        assert not native.library_path().exists()
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(BackendError, match="g\\+\\+ not found"):
        native.build()
    monkeypatch.setattr(native, "SOURCES", (tmp_path / "missing.cc",))
    with pytest.raises(BackendError, match="missing"):
        native.build()


@needs_gxx
def test_ring_roundtrip_eos_and_backpressure():
    """tests/test_native.py's ring cases on the port's library."""
    name = _ring_name()
    prod = native.ShmRing(name, create=True, capacity=1 << 12)
    try:
        cons = native.ShmRing(name, create=False)
        prod.write(b"hello")
        assert cons.read(1000) == b"hello"
        assert cons.read(timeout_ms=50) is None
        payload = bytes(range(256)) * 4
        for i in range(16):                  # wraps the 4 KiB ring
            prod.write(payload)
            assert cons.read(1000) == payload, i
        writes = 0
        with pytest.raises(StreamError, match="full|stalled"):
            for _ in range(10):
                prod.write(payload, timeout_ms=100)
                writes += 1
        assert writes >= 2
        while cons.read(50) is not None:
            pass
        prod.write(b"last")
        prod.close_write()
        assert cons.read(1000) == b"last"
        with pytest.raises(EOFError):
            cons.read(1000)
        cons.close()
    finally:
        prod.close()
    with pytest.raises(StreamError, match="producer pipeline"):
        native.ShmRing(name, create=False)


@needs_gxx
def test_native_wire_validator_agrees_with_python():
    buf = TensorBuffer.of(torch.arange(6, dtype=torch.float32).reshape(2, 3),
                          np.array([1, 2], np.uint8), pts=5)
    frame = wire.encode_buffer(buf, client_id=7)
    assert native.wire_frame_size(frame) == len(frame)
    for cut in (4, 20, len(frame) - 1):
        assert native.wire_frame_size(frame[:cut]) == 0
    assert native.wire_frame_size(b"XXXX" + frame[4:]) == -1


@needs_gxx
def test_ipc_elements_pipeline_roundtrip():
    """tests/test_native.py's in-process ipc pipeline on the port: the
    consumer sniffs its spec from the first frame."""
    from nnstreamer_tpu_torch.elements import AppSrc, IpcSink, IpcSrc, TensorSink
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    name = _ring_name()
    psrc = AppSrc(spec=TensorsSpec.of(TensorInfo((2, 2), DType.FLOAT32)),
                  name="psrc")
    isink = IpcSink(name="isink", ring=name)
    ppipe = tnns.Pipeline("prod")
    ppipe.add(psrc)
    ppipe.add(isink)
    ppipe.link(psrc, isink)
    prunner = tnns.PipelineRunner(ppipe).start()
    isrc = IpcSrc(name="isrc", ring=name)
    sink = TensorSink(name="s")
    cpipe = tnns.Pipeline("cons")
    cpipe.add(isrc)
    cpipe.add(sink)
    cpipe.link(isrc, sink)
    for i in range(4):
        psrc.push(TensorBuffer.of(np.full((2, 2), i, np.float32), pts=i))
    crunner = tnns.PipelineRunner(cpipe).start()
    psrc.end()
    prunner.wait(30)
    crunner.wait(30)
    prunner.stop()
    crunner.stop()
    assert isrc.out_specs[0].tensors[0].shape == (2, 2)
    assert [float(r.tensors[0][0, 0]) for r in sink.results] == [0, 1, 2, 3]
    assert [r.pts for r in sink.results] == [0, 1, 2, 3]
    with pytest.raises(Exception, match="ring= is required"):
        IpcSink(name="x")


def _ipc_producer(ring, n, created, done):
    """The spawned child: appsrc → ipc_sink; the ring is kept (not
    unlinked) until the parent has read everything."""
    os.environ["NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR"] = "cpu"
    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer as Buf

    pipe = nt.parse_launch(f"appsrc name=src dims=3:4:4:1 types=uint8 ! "
                           f"ipc_sink ring={ring}")
    runner = nt.PipelineRunner(pipe).start()
    created.set()
    rng = np.random.default_rng(7)
    for i in range(n):
        pipe.get("src").push(Buf.of(
            rng.integers(0, 256, (1, 4, 4, 3), np.uint8), pts=i))
    pipe.get("src").end()
    runner.wait(60)
    done.wait(60)
    runner.stop()


@needs_gxx
def test_ipc_between_two_processes():
    """ipc_sink in a spawned child process feeds ipc_src in this one:
    every frame arrives, in order, with its pts and bytes."""
    ctx = multiprocessing.get_context("spawn")
    name, n = _ring_name(), 6
    native.build()              # once, before the child asks for it
    created, done = ctx.Event(), ctx.Event()
    child = ctx.Process(target=_ipc_producer, args=(name, n, created, done))
    child.start()
    try:
        assert created.wait(120), "the child never created the ring"
        pipe = tnns.parse_launch(f"ipc_src ring={name} dims=3:4:4:1 "
                                 f"types=uint8 ! tensor_sink name=out")
        runner = tnns.PipelineRunner(pipe).start()
        runner.wait(60)
        runner.stop()
        done.set()
        child.join(60)
        assert child.exitcode == 0
    finally:
        done.set()
        if child.is_alive():
            child.kill()
    rng = np.random.default_rng(7)
    want = [rng.integers(0, 256, (1, 4, 4, 3), np.uint8) for _ in range(n)]
    res = pipe.get("out").results
    assert [r.pts for r in res] == list(range(n))
    for r, w in zip(res, want):
        np.testing.assert_array_equal(host(r.tensors[0]), w)

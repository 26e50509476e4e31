"""The port's interop codecs and gRPC elements (nnstreamer_tpu_torch/
interop/) against the JAX package's, on the CPU.

The JAX file's cases (tests/test_interop.py) run on the port, then across
the packages: the same seeded buffers (every wire dtype; static,
FLEXIBLE and SPARSE; names and rate) through both encoders — protobuf
frames byte for byte JAX's, flatbuf and flexbuf frames each parsed by the
other package's decoder — and through the stock readers (google.protobuf
over JAX's generated tensors_pb2, the flatbuffers Table API,
`flexbuffers.Loads`), which the port itself never imports. gRPC: all four
pairings port to port, a raw grpc client on either side, and a JAX
`tensor_sink_grpc` feeding a port `tensor_src_grpc` and the reverse.
"""

import ast
import struct
import sys
import threading
import time
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu.elements  # noqa: F401  (registers JAX's elements)
import nnstreamer_tpu_torch as tnns
import nnstreamer_tpu_torch.elements  # noqa: F401
from nnstreamer_tpu.interop import flatbuf_codec as jflat
from nnstreamer_tpu.interop import flexbuf_codec as jflex
from nnstreamer_tpu.interop import protobuf_codec as jproto
from nnstreamer_tpu.interop import tensors_pb2
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuf
from nnstreamer_tpu.tensor.info import TensorFormat as JFormat
from nnstreamer_tpu_torch.core.errors import PipelineError, StreamError
from nnstreamer_tpu_torch.interop import tensors_proto as pb
from nnstreamer_tpu_torch.interop.flatbuf_codec import (
    decode_flatbuf, encode_flatbuf)
from nnstreamer_tpu_torch.interop.flexbuf_codec import (
    decode_flexbuf, encode_flexbuf)
from nnstreamer_tpu_torch.interop.gst_meta import (
    pack_gst_meta, parse_gst_meta, shape_from_wire, wire_dims)
from nnstreamer_tpu_torch.interop.protobuf_codec import (
    decode_protobuf, encode_protobuf)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorFormat

from conftest import free_port  # noqa: E402 (shared helper)

PORT_INTEROP = Path(__file__).resolve().parents[1] / \
    "nnstreamer_tpu_torch" / "interop"


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# -- GstTensorMetaInfo header -------------------------------------------------

def test_gst_meta_roundtrip_preserves_rank():
    for shape in [(7,), (3, 4), (1, 8, 8, 3), (2, 1, 1, 1, 5)]:
        hdr = pack_gst_meta(shape, DType.FLOAT32)
        assert len(hdr) == 128
        out_shape, dt, fmt, _, _, off = parse_gst_meta(hdr + b"payload")
        assert out_shape == shape
        assert dt == DType.FLOAT32 and off == 128


def test_gst_meta_rejects_garbage_and_zero_dims():
    with pytest.raises(StreamError, match="version"):
        parse_gst_meta(b"\x00" * 128)
    with pytest.raises(StreamError, match="zero"):
        pack_gst_meta((0, 3), DType.UINT8)
    with pytest.raises(StreamError, match="small"):
        parse_gst_meta(b"\xde\x00\x00\x00")


def test_gst_meta_rejects_superset_tag_bytes():
    for tag in (0xFF001000, 0xFE001000, 0xDF001000):
        hdr = bytearray(pack_gst_meta((3,), DType.UINT8))
        struct.pack_into("<I", hdr, 0, tag)
        with pytest.raises(StreamError, match="version"):
            parse_gst_meta(bytes(hdr))


def test_gst_meta_header_is_jax_bytes():
    from nnstreamer_tpu.interop import gst_meta as jmeta
    from nnstreamer_tpu.tensor.dtypes import DType as JDType

    for shape, dt in [((7,), 5), ((1, 8, 8, 3), 7), ((2, 1, 1, 1, 5), 9)]:
        for fmt in (1, 2):
            assert pack_gst_meta(shape, DType(dt), TensorFormat(fmt),
                                 nnz=3) == jmeta.pack_gst_meta(
                shape, JDType(dt), JFormat(fmt), nnz=3)


def test_wire_dims_convention():
    assert wire_dims((1, 224, 224, 3)) == [3, 224, 224, 1]
    assert wire_dims((5,)) == [5, 1, 1, 1]
    assert shape_from_wire([3, 224, 224, 1]) == (224, 224, 3)
    assert shape_from_wire([5, 1, 1, 1]) == (5,)


# -- codec roundtrips on the port ---------------------------------------------

CODECS = [(encode_protobuf, decode_protobuf, "protobuf"),
          (encode_flexbuf, decode_flexbuf, "flexbuf"),
          (encode_flatbuf, decode_flatbuf, "flatbuf")]
CODEC_IDS = [c[2] for c in CODECS]


@pytest.mark.parametrize("enc,dec,name", CODECS, ids=CODEC_IDS)
def test_static_roundtrip_multi_tensor(enc, dec, name):
    buf = TensorBuffer.of(
        np.arange(24, dtype=np.float32).reshape(2, 3, 4),
        np.arange(6, dtype=np.uint8),
        np.array([1.5, -2.5], np.float64))
    out = dec(enc(buf, rate=(30, 1)))
    assert out.num_tensors == 3 and out.format == TensorFormat.STATIC
    for got, want in zip(out.tensors, buf.tensors):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("enc,dec,name", CODECS, ids=CODEC_IDS)
def test_static_leading_one_dims_canonicalize(enc, dec, name):
    buf = TensorBuffer.of(np.zeros((1, 2), np.float64))
    assert dec(enc(buf)).tensors[0].shape == (2,)


@pytest.mark.parametrize("enc,dec,name", CODECS, ids=CODEC_IDS)
def test_flexible_roundtrip_preserves_exact_shape(enc, dec, name):
    buf = TensorBuffer.of(np.ones((1, 8, 8, 3), np.uint8),
                          format=TensorFormat.FLEXIBLE)
    out = dec(enc(buf))
    assert out.tensors[0].shape == (1, 8, 8, 3)
    assert out.format == TensorFormat.FLEXIBLE


@pytest.mark.parametrize("enc,dec,name", CODECS, ids=CODEC_IDS)
def test_tensor_names_travel(enc, dec, name):
    buf = TensorBuffer.of(np.zeros(3, np.int32))
    buf.meta["tensor_names"] = {0: "logits"}
    assert dec(enc(buf)).meta["tensor_names"][0] == "logits"


@pytest.mark.parametrize("enc,dec,name", CODECS, ids=CODEC_IDS)
def test_bfloat16_rejected_with_typecast_hint(enc, dec, name):
    import ml_dtypes

    buf = TensorBuffer.of(np.zeros(4, dtype=ml_dtypes.bfloat16))
    with pytest.raises(StreamError, match="typecast"):
        enc(buf)
    with pytest.raises(StreamError, match="typecast"):
        enc(TensorBuffer.of(torch.zeros(4, dtype=torch.bfloat16)))


@pytest.mark.parametrize("dec", [decode_protobuf, decode_flexbuf,
                                 decode_flatbuf], ids=CODEC_IDS)
def test_corrupt_frames_rejected(dec):
    with pytest.raises(StreamError, match="corrupt|payload bytes"):
        dec(b"\xff" * 64)


def test_protobuf_payload_size_mismatch_rejected():
    msg = pb.Tensors(num_tensor=1, tensor=[pb.Tensor(
        type=int(DType.FLOAT32), dimension=[4, 1, 1, 1],
        data=b"\x00" * 7)])   # 4 floats need 16 bytes
    with pytest.raises(StreamError, match="payload bytes"):
        decode_protobuf(msg.SerializeToString())


@pytest.mark.parametrize("enc,dec,name", CODECS, ids=CODEC_IDS)
def test_truncated_payload_raises_stream_error(enc, dec, name):
    buf = TensorBuffer.of(np.ones((1, 8, 8, 3), np.uint8),
                          format=TensorFormat.FLEXIBLE)
    frame = enc(buf)
    for cut in (len(frame) // 2, len(frame) - 1, 7):
        with pytest.raises(StreamError):
            dec(frame[:cut])


@pytest.mark.parametrize("enc,dec,name", CODECS, ids=CODEC_IDS)
def test_torch_tensors_encode_like_numpy(enc, dec, name):
    """A buffer of (CPU) torch tensors encodes to the same frame as its
    numpy twin: host_arrays converts each tensor once."""
    arrs = [np.arange(12, dtype=np.float32).reshape(3, 4),
            np.arange(5, dtype=np.int64)]
    a = enc(TensorBuffer.of(*arrs), rate=(5, 1))
    b = enc(TensorBuffer.of(*[torch.from_numpy(x) for x in arrs]),
            rate=(5, 1))
    assert a == b


# -- across the packages ------------------------------------------------------

WIRE_DTYPES = [np.int32, np.uint32, np.int16, np.uint16, np.int8, np.uint8,
               np.float64, np.float32, np.int64, np.uint64]
RATES = [None, Fraction(0), Fraction(30), Fraction(30000, 1001), (15, 2),
         (-5, 1)]
PAIRS = {"protobuf": (encode_protobuf, decode_protobuf,
                      jproto.encode_protobuf, jproto.decode_protobuf),
         "flatbuf": (encode_flatbuf, decode_flatbuf,
                     jflat.encode_flatbuf, jflat.decode_flatbuf),
         "flexbuf": (encode_flexbuf, decode_flexbuf,
                     jflex.encode_flexbuf, jflex.decode_flexbuf)}


def seeded_arrays(seed: int):
    """One tensor of every wire dtype, shapes from a seed (full-range
    values)."""
    rng = np.random.default_rng(seed)
    out = []
    for dt in WIRE_DTYPES:
        shape = tuple(int(d) for d in rng.integers(1, 5, size=rng.integers(1, 5)))
        if np.dtype(dt).kind == "f":
            a = rng.standard_normal(shape).astype(dt)
        else:
            info = np.iinfo(dt)
            a = rng.integers(info.min, info.max, size=shape, dtype=dt,
                             endpoint=True)
        out.append(a)
    return out


def both_buffers(seed: int, fmt: int):
    arrs = seeded_arrays(seed)
    names = {0: "x", 3: "uint16 tensor", 9: "último"}
    return (arrs,
            TensorBuffer(tensors=tuple(arrs), format=TensorFormat(fmt),
                         meta={"tensor_names": names}),
            JBuf(tensors=tuple(arrs), format=JFormat(fmt),
                 meta={"tensor_names": names}), names)


def assert_same(out, arrs, fmt, names):
    assert out.num_tensors == len(arrs) and int(out.format) == fmt
    for got, want in zip(out.tensors, arrs):
        got = np.asarray(got)
        assert got.dtype == want.dtype
        if fmt:   # FLEXIBLE and SPARSE carry the exact shape
            assert got.shape == want.shape
        np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert out.meta["tensor_names"] == names


@pytest.mark.parametrize("fmt", [0, 1, 2], ids=["static", "flexible",
                                                 "sparse"])
@pytest.mark.parametrize("rate", RATES, ids=[str(r) for r in RATES])
def test_protobuf_frames_are_jax_bytes(fmt, rate):
    arrs, tb, jb, _ = both_buffers(fmt * 7 + len(str(rate)), fmt)
    assert encode_protobuf(tb, rate=rate) == jproto.encode_protobuf(
        jb, rate=rate)


@pytest.mark.parametrize("fmt", [0, 1, 2], ids=["static", "flexible",
                                                 "sparse"])
@pytest.mark.parametrize("codec", sorted(PAIRS))
def test_frames_parse_across_packages(codec, fmt):
    enc, dec, jenc, jdec = PAIRS[codec]
    for seed in range(3):
        arrs, tb, jb, names = both_buffers(100 * fmt + seed, fmt)
        rate = RATES[seed + 2]
        assert_same(jdec(enc(tb, rate=rate)), arrs, fmt, names)
        assert_same(dec(jenc(jb, rate=rate)), arrs, fmt, names)
        assert_same(dec(enc(tb, rate=rate)), arrs, fmt, names)


def test_stock_protobuf_parses_our_frames():
    arrs, tb, _, names = both_buffers(5, 1)
    msg = tensors_pb2.Tensors()
    msg.ParseFromString(encode_protobuf(tb, rate=(30, 1)))
    assert msg.num_tensor == len(arrs) and msg.format == 1
    assert (msg.fr.rate_n, msg.fr.rate_d) == (30, 1)
    assert msg.tensor[3].name == names[3]
    for t, a in zip(msg.tensor, arrs):
        assert list(t.dimension) == wire_dims(a.shape)
        assert t.data[128:] == a.tobytes()


def test_our_decoder_parses_stock_protobuf_frames():
    msg = tensors_pb2.Tensors(num_tensor=1)
    msg.fr.rate_n, msg.fr.rate_d = 15, 1
    t = msg.tensor.add()
    t.name = "ext"
    t.type = 7  # NNS_FLOAT32
    t.dimension.extend([2, 5, 1, 1])   # innermost-first
    t.data = np.arange(10, dtype=np.float32).tobytes()
    out = decode_protobuf(msg.SerializeToString())
    np.testing.assert_array_equal(
        out.tensors[0], np.arange(10, dtype=np.float32).reshape(5, 2))
    assert out.meta["tensor_names"][0] == "ext"
    # the same message through our schema: the same bytes back
    frame = msg.SerializeToString()
    assert pb.Tensors.FromString(frame).SerializeToString() == frame


def test_our_protobuf_reader_takes_unpacked_dims_and_unknown_fields():
    """FromString accepts every valid encoding, not only the canonical:
    dimension as unpacked varints, an unknown field, a repeated scalar
    (the last wins)."""
    def vi(n):
        return pb._varint(n)

    tensor = (vi(2 << 3) + vi(5) + b"".join(vi(3 << 3) + vi(d)
                                            for d in (4, 1, 1, 1))
              + vi(9 << 3) + vi(77)              # unknown field 9
              + vi(4 << 3 | 2) + vi(4) + bytes([1, 2, 3, 4]))
    frame = (vi(1 << 3) + vi(3) + vi(1 << 3) + vi(1)   # num_tensor 3, then 1
             + vi(3 << 3 | 2) + vi(len(tensor)) + tensor)
    out = decode_protobuf(frame)
    np.testing.assert_array_equal(out.tensors[0],
                                  np.array([1, 2, 3, 4], np.uint8))
    assert jproto.decode_protobuf(frame).tensors[0].tobytes() == \
        bytes([1, 2, 3, 4])


def test_stock_flexbuffers_loads_our_frames():
    from flatbuffers import flexbuffers

    arrs, tb, _, names = both_buffers(9, 1)
    frame = encode_flexbuf(tb, rate=(10, 1))
    root = flexbuffers.Loads(bytearray(frame))
    assert root["num_tensors"] == len(arrs)
    assert (root["rate_n"], root["rate_d"], root["format"]) == (10, 1, 1)
    for i, a in enumerate(arrs):
        name, ty, dims, raw = root[f"tensor_{i}"]
        assert name == names.get(i, "") and ty == int(DType.from_np(a.dtype))
        assert list(dims) == wire_dims(a.shape)
        assert bytes(raw)[128:] == a.tobytes()
    # keyed access binary-searches the map's keys: they must be sorted
    ref = flexbuffers.GetRoot(bytearray(frame)).AsMap
    assert ref["tensor_3"].AsVector[0].AsString == names[3]
    assert ref["num_tensors"].AsInt == len(arrs)


def test_our_converter_parses_stock_flexbuf_frames():
    from flatbuffers import flexbuffers

    fbb = flexbuffers.Builder()
    with fbb.Map():
        fbb.Key("num_tensors")
        fbb.UInt(1)
        fbb.Key("rate_n")
        fbb.Int(0)
        fbb.Key("rate_d")
        fbb.Int(1)
        fbb.Key("format")
        fbb.Int(0)
        fbb.Key("tensor_0")
        with fbb.Vector():
            fbb.String("")
            fbb.Int(5)  # NNS_UINT8
            fbb.TypedVectorFromElements([4, 2, 1, 1])
            fbb.Blob(np.arange(8, dtype=np.uint8).tobytes())
    out = decode_flexbuf(bytes(fbb.Finish()))
    np.testing.assert_array_equal(
        out.tensors[0], np.arange(8, dtype=np.uint8).reshape(2, 4))


def test_stock_flatbuffers_table_reads_our_frames():
    import flatbuffers
    from flatbuffers import number_types as NT
    from flatbuffers.table import Table

    buf = TensorBuffer.of(np.arange(10, dtype=np.int16).reshape(5, 2))
    raw = bytearray(encode_flatbuf(buf, rate=(24, 1)))
    tab = Table(raw, flatbuffers.encode.Get(flatbuffers.packer.uoffset,
                                            raw, 0))

    def slot(t, i):
        return t.Offset(4 + 2 * i)

    assert tab.Get(NT.Int32Flags, slot(tab, 0) + tab.Pos) == 1
    fo = slot(tab, 1)
    assert tab.Get(NT.Int32Flags, fo + tab.Pos) == 24
    assert tab.Get(NT.Int32Flags, fo + tab.Pos + 4) == 1
    ttab = Table(raw, tab.Indirect(tab.Vector(slot(tab, 2))))
    assert ttab.Get(NT.Int32Flags, slot(ttab, 1) + ttab.Pos) == 2
    do = slot(ttab, 2)
    assert [ttab.Get(NT.Uint32Flags, ttab.Vector(do) + 4 * k)
            for k in range(ttab.VectorLen(do))] == [2, 5, 1, 1]
    bo = slot(ttab, 3)
    s = ttab.Vector(bo)
    assert bytes(raw[s:s + ttab.VectorLen(bo)]) == buf.tensors[0].tobytes()


def test_codecs_import_no_stock_package():
    """The port's interop modules import neither flatbuffers nor
    google.protobuf, at any level; grpc only inside a function."""
    for path in sorted(PORT_INTEROP.glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert not n.startswith(("flatbuffers", "google")), \
                    (path.name, n)
        top = [n for node in tree.body if isinstance(node, ast.Import)
               for n in (a.name for a in node.names)]
        assert "grpc" not in top, path.name


# -- pipelines ----------------------------------------------------------------

@pytest.mark.parametrize("codec", ["protobuf", "flexbuf", "flatbuf"])
def test_pipeline_decoder_converter_roundtrip(codec):
    pipe = tnns.parse_launch(
        f"appsrc name=in dims=3:4 types=float32 ! "
        f"tensor_decoder mode={codec} ! "
        f"tensor_converter mode=custom:{codec} ! tensor_sink name=out")
    runner = tnns.PipelineRunner(pipe).start()
    src = pipe.get("in")
    frames = [np.random.default_rng(i).standard_normal((4, 3))
              .astype(np.float32) for i in range(3)]
    for f in frames:
        src.push(TensorBuffer.of(f, pts=1000))
    src.end()
    runner.wait(30)
    runner.stop()
    res = pipe.get("out").results
    assert len(res) == 3
    for got, want in zip(res, frames):
        np.testing.assert_array_equal(got.tensors[0], want)
        assert got.pts == 1000


@pytest.mark.parametrize("codec", ["protobuf", "flexbuf", "flatbuf"])
def test_pipeline_frames_are_read_by_jax_converter(codec):
    """The port's decoder output, carried as bytes, through JAX's
    converter: the logits of a port filter arrive in a JAX pipeline."""
    frames = [np.random.default_rng(i).standard_normal((2, 5))
              .astype(np.float32) for i in range(3)]
    pipe = tnns.parse_launch(
        f"appsrc name=in dims=5:2 types=float32 ! tensor_decoder "
        f"mode={codec} ! tensor_sink name=out")
    runner = tnns.PipelineRunner(pipe).start()
    for f in frames:
        pipe.get("in").push(TensorBuffer.of(f))
    pipe.get("in").end()
    runner.wait(30)
    runner.stop()
    octets = [np.asarray(b.tensors[0]) for b in pipe.get("out").results]
    jpipe = jnns.parse_launch(
        f"appsrc name=in dims={octets[0].size} types=uint8 ! "
        f"tensor_converter mode=custom:{codec} ! tensor_sink name=out")
    jr = jnns.PipelineRunner(jpipe).start()
    for o in octets:
        jpipe.get("in").push(JBuf.of(o))
    jpipe.get("in").end()
    jr.wait(30)
    jr.stop()
    got = [np.asarray(b.tensors[0]) for b in jpipe.get("out").results]
    assert len(got) == 3
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)


# -- gRPC ---------------------------------------------------------------------

def _wait(cond, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _grpc_threads():
    return {t.name for t in threading.enumerate()
            if "grpc" in t.name.lower() or t.name.endswith("-pull")}


def _push_all(pipe, runner, frames, name="src"):
    for f in frames:
        pipe.get(name).push(f)
    pipe.get(name).end()
    runner.wait(30)


INT_FRAMES = [np.array([i, i + 1, i + 2], np.int32) for i in range(5)]


def _run_pair(nns_send, nns_recv, Buf, send_desc, recv_desc, ready):
    """Start the receiving pipeline, then the sending one; push
    INT_FRAMES → the receiver's results."""
    recv = nns_recv.parse_launch(recv_desc)
    rr = nns_recv.PipelineRunner(recv).start()
    send = nns_send.parse_launch(send_desc)
    sr = nns_send.PipelineRunner(send).start()
    try:
        assert _wait(lambda: ready(send, recv))
        _push_all(send, sr, [Buf.of(f) for f in INT_FRAMES])
        sink = recv.get("out")
        if "server=true" in send_desc:
            sr.stop()          # a sink server's stop ends client streams
        assert _wait(lambda: len(sink.results) >= len(INT_FRAMES))
    finally:
        sr.stop()
        recv.get("in").interrupt()
        rr.stop()
    return [np.asarray(b.tensors[0]) for b in recv.get("out").results]


def test_grpc_sink_client_to_src_server():
    """sink(client) --SendTensors--> src(server), port to port."""
    port = free_port()
    got = _run_pair(
        tnns, tnns, TensorBuffer,
        f"appsrc name=src dims=3 types=int32 ! tensor_sink_grpc "
        f"port={port} server=false",
        f"tensor_src_grpc name=in port={port} server=true dims=3 "
        f"types=int32 ! tensor_sink name=out",
        lambda s, r: True)
    assert [g.tolist() for g in got] == [f.tolist() for f in INT_FRAMES]


def test_grpc_src_client_pulls_from_sink_server():
    """src(client) <--RecvTensors-- sink(server), port to port, the
    stream's type sniffed from the first frame."""
    port = free_port()
    got = _run_pair(
        tnns, tnns, TensorBuffer,
        f"appsrc name=src dims=3 types=int32 ! tensor_sink_grpc name=g "
        f"port={port} server=true",
        f"tensor_src_grpc name=in port={port} server=false dims=3 "
        f"types=int32 ! tensor_sink name=out",
        lambda s, r: s.get("g").client_count == 1)
    assert [g.tolist() for g in got] == [f.tolist() for f in INT_FRAMES]


def test_grpc_src_client_sniffs_dims():
    port = free_port()
    send = tnns.parse_launch(
        f"appsrc name=src dims=4:2 types=float32 ! tensor_sink_grpc "
        f"name=g port={port} server=true")
    sr = tnns.PipelineRunner(send).start()
    result = {}

    def receive():
        recv = tnns.parse_launch(
            f"tensor_src_grpc name=in port={port} server=false "
            f"sniff_timeout=20 ! tensor_sink name=out")
        rr = tnns.PipelineRunner(recv).start()   # blocks on the sniff
        result["pipe"], result["runner"] = recv, rr

    t = threading.Thread(target=receive)
    t.start()
    try:
        assert _wait(lambda: send.get("g").client_count == 1)
        frames = [np.full((2, 4), i, np.float32) for i in range(3)]
        _push_all(send, sr, [TensorBuffer.of(f) for f in frames])
        t.join(20)
        recv, rr = result["pipe"], result["runner"]
        sr.stop()
        rr.wait(20)
        got = recv.get("out").results
        assert len(got) == 3
        np.testing.assert_array_equal(got[2].tensors[0], frames[2])
    finally:
        sr.stop()
        if "runner" in result:
            result["runner"].stop()


def test_grpc_sink_server_streams_to_raw_client():
    import grpc

    port = free_port()
    pipe = tnns.parse_launch(
        f"appsrc name=src dims=4:2 types=float32 ! "
        f"tensor_sink_grpc name=g port={port} server=true")
    runner = tnns.PipelineRunner(pipe).start()
    chan = grpc.insecure_channel(f"127.0.0.1:{port}")
    grpc.channel_ready_future(chan).result(timeout=10)
    recv = chan.unary_stream(
        "/nnstreamer.protobuf.TensorService/RecvTensors",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=tensors_pb2.Tensors.FromString)
    got = []
    from google.protobuf import empty_pb2

    stream = recv(empty_pb2.Empty())
    collector = threading.Thread(
        target=lambda: [got.append(m) for m in stream], daemon=True)
    collector.start()
    assert _wait(lambda: pipe.get("g").client_count == 1)
    _push_all(pipe, runner,
              [TensorBuffer.of(np.full((2, 4), i, np.float32))
               for i in range(4)])
    runner.stop()
    collector.join(timeout=10)
    chan.close()
    assert len(got) == 4
    np.testing.assert_array_equal(
        np.frombuffer(got[2].tensor[0].data, np.float32),
        np.full(8, 2, np.float32))


def test_grpc_src_server_accepts_raw_client_stream():
    import grpc
    from google.protobuf import empty_pb2

    port = free_port()
    pipe = tnns.parse_launch(
        f"tensor_src_grpc name=in port={port} server=true dims=4:2 "
        f"types=float32 ! tensor_sink name=out")
    runner = tnns.PipelineRunner(pipe).start()
    chan = grpc.insecure_channel(f"127.0.0.1:{port}")
    grpc.channel_ready_future(chan).result(timeout=10)
    send = chan.stream_unary(
        "/nnstreamer.protobuf.TensorService/SendTensors",
        request_serializer=tensors_pb2.Tensors.SerializeToString,
        response_deserializer=empty_pb2.Empty.FromString)

    def frames():
        for i in range(3):
            msg = tensors_pb2.Tensors(num_tensor=1)
            t = msg.tensor.add()
            t.type = 7
            t.dimension.extend([4, 2, 1, 1])
            t.data = np.full((2, 4), i, np.float32).tobytes()
            yield msg

    send(frames())
    sink = pipe.get("out")
    assert _wait(lambda: len(sink.results) >= 3)
    pipe.get("in").interrupt()
    runner.stop()
    chan.close()
    assert len(sink.results) == 3
    np.testing.assert_array_equal(
        sink.results[1].tensors[0], np.full((2, 4), 1, np.float32))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_grpc_across_packages(direction):
    """A sink server of one package feeds a src client of the other (the
    pull pairing), and a sink client of one pushes into a src server of
    the other: the frames arrive in order, bit for bit."""
    send_nns, recv_nns = ((jnns, tnns) if direction == "jax_to_port"
                          else (tnns, jnns))
    SendBuf = JBuf if send_nns is jnns else TensorBuffer
    port = free_port()
    pulled = _run_pair(
        send_nns, recv_nns, SendBuf,
        f"appsrc name=src dims=3 types=int32 ! tensor_sink_grpc name=g "
        f"port={port} server=true",
        f"tensor_src_grpc name=in port={port} server=false dims=3 "
        f"types=int32 ! tensor_sink name=out",
        lambda s, r: len(s.get("g")._clients) == 1)
    port = free_port()
    pushed = _run_pair(
        send_nns, recv_nns, SendBuf,
        f"appsrc name=src dims=3 types=int32 ! tensor_sink_grpc "
        f"port={port} server=false",
        f"tensor_src_grpc name=in port={port} server=true dims=3 "
        f"types=int32 ! tensor_sink name=out",
        lambda s, r: True)
    want = [f.tolist() for f in INT_FRAMES]
    assert [g.tolist() for g in pulled] == want
    assert [g.tolist() for g in pushed] == want


def test_grpc_teardown_while_a_client_streams_joins_everything():
    """stop() on both ends while frames still flow: nothing of either
    element keeps running, and a closing sink takes no new client."""
    import grpc

    port = free_port()
    before = _grpc_threads()
    send = tnns.parse_launch(
        f"appsrc name=src dims=3 types=int32 ! tensor_sink_grpc name=g "
        f"port={port} server=true queue_size=4")
    sr = tnns.PipelineRunner(send).start()
    recv = tnns.parse_launch(
        f"tensor_src_grpc name=in port={port} server=false dims=3 "
        f"types=int32 queue_size=2 ! tensor_sink name=out")
    rr = tnns.PipelineRunner(recv).start()
    assert _wait(lambda: send.get("g").client_count == 1)
    for i in range(50):
        send.get("src").push(TensorBuffer.of(np.array([i] * 3, np.int32)))
    recv.get("in").interrupt()
    rr.stop()
    sr.stop()
    g = send.get("g")
    assert g.client_count == 0
    assert _wait(lambda: _grpc_threads() - before == set(), 10), \
        _grpc_threads() - before
    # a closed sink refuses a late client stream at once, and its server
    # is gone
    assert list(g._recv_tensors(b"", _Ctx())) == []
    chan = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        with pytest.raises(grpc.FutureTimeoutError):
            grpc.channel_ready_future(chan).result(timeout=0.5)
    finally:
        chan.close()


class _Ctx:
    @staticmethod
    def is_active():
        return True


@pytest.mark.parametrize("element,props", [
    ("tensor_sink_grpc", {"port": 1}),
    ("tensor_src_grpc", {"port": 1, "dims": "3", "types": "int32"})])
def test_grpc_missing_names_the_package(monkeypatch, element, props):
    """Without grpcio the element constructs, and starting it raises a
    PipelineError naming the package and the element; nothing falls back
    to another transport."""
    from nnstreamer_tpu_torch.core.registry import PluginKind, registry

    monkeypatch.setitem(sys.modules, "grpc", None)
    el = registry.get(PluginKind.ELEMENT, element)(name="e", **props)
    with pytest.raises(PipelineError, match=f"{element}.*grpcio"):
        el.start()

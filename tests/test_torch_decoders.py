"""The port's image_segment, direct_video and octet_stream decoders
(nnstreamer_tpu_torch/decoders/segment.py, direct_video.py, octet.py)
against the JAX package's, on the CPU.

Copies of `tests/test_decoders.py`'s `test_direct_video_rgb`,
`test_direct_video_rejects_float`, `test_segment_tflite_deeplab_argmax`,
`test_segment_index_variant`, `test_octet_stream_concat` and
`TestDeviceDecode.test_segment_device_argmax_map` — each run through both
packages on the same buffers, the port's outputs, meta and out specs held
to the JAX package's bit for bit — then the device decode's refusals
(an index map, more than 256 classes) with the JAX package's text, and
the device argmax on seeded DeepLab-shaped scores against the host
decoder's class map.
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.elements import AppSrc as JAppSrc
from nnstreamer_tpu.elements import TensorDecoder as JTensorDecoder
from nnstreamer_tpu.elements import TensorSink as JTensorSink
from nnstreamer_tpu.graph.media import OctetSpec as JOctetSpec
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JTensorBuffer
from nnstreamer_tpu.tensor.dtypes import DType as JDType
from nnstreamer_tpu.tensor.info import TensorInfo as JTensorInfo
from nnstreamer_tpu.tensor.info import TensorsSpec as JTensorsSpec
from nnstreamer_tpu_torch.elements import AppSrc, TensorDecoder, TensorSink
from nnstreamer_tpu_torch.graph.media import OctetSpec, VideoSpec
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


def _decode(nns, parts, dec_props, infos, arrays):
    """Both packages' `decode_one` (test_decoders.py): appsrc → decoder →
    sink built by hand → (the decoder element, the sink's buffers)."""
    AppSrc_, Decoder, Sink, Spec, Info, DT, Buf = parts
    spec = Spec.of(*[Info(shape, getattr(DT, dt)) for shape, dt in infos])
    src = AppSrc_(spec=spec, name="src")
    dec = Decoder(name="dec", **dec_props)
    sink = Sink(name="s")
    pipe = nns.Pipeline()
    for e in (src, dec, sink):
        pipe.add(e)
    pipe.link(src, dec)
    pipe.link(dec, sink)
    runner = nns.PipelineRunner(pipe).start()
    for arrs in arrays:
        src.push(Buf.of(*arrs, pts=0))
    src.end()
    runner.wait(30)
    runner.stop()
    return dec, sink.results


PORT = (AppSrc, TensorDecoder, TensorSink, TensorsSpec, TensorInfo, DType,
        TensorBuffer)
JAX = (JAppSrc, JTensorDecoder, JTensorSink, JTensorsSpec, JTensorInfo,
       JDType, JTensorBuffer)


def _both(dec_props, infos, arrays):
    port = _decode(tnns, PORT, dec_props, infos, arrays)
    jax = _decode(jnns, JAX, dec_props, infos, arrays)
    return port, jax


def _same_results(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x.tensors) == len(y.tensors)
        for u, v in zip(x.tensors, y.tensors):
            u, v = np.asarray(u), np.asarray(v)
            assert u.dtype == v.dtype and u.shape == v.shape
            assert u.tobytes() == v.tobytes()


def _spec_fields(spec):
    return (type(spec).__name__, getattr(spec, "width", None),
            getattr(spec, "height", None), getattr(spec, "format", None))


# -- direct_video ------------------------------------------------------------

def test_direct_video_rgb():
    img = np.arange(6 * 8 * 3, dtype=np.uint8).reshape(1, 6, 8, 3)
    (dec, res), (jdec, jres) = _both(
        {"mode": "direct_video"}, [((1, 6, 8, 3), "UINT8")], [(img,)])
    out_spec = dec.out_specs[0]
    assert isinstance(out_spec, VideoSpec)
    assert (out_spec.width, out_spec.height, out_spec.format) == (8, 6, "RGB")
    assert _spec_fields(out_spec) == _spec_fields(jdec.out_specs[0])
    np.testing.assert_array_equal(res[0].tensors[0], img[0])
    _same_results(res, jres)


def test_direct_video_gray_and_forced_format():
    """A 2-D map becomes GRAY8 (H, W, 1); option1 forces the format."""
    gray = np.arange(20, dtype=np.uint8).reshape(4, 5)
    (dec, res), (jdec, jres) = _both(
        {"mode": "direct_video"}, [((4, 5), "UINT8")], [(gray,)])
    assert _spec_fields(dec.out_specs[0]) == (
        "VideoSpec", 5, 4, "GRAY8") == _spec_fields(jdec.out_specs[0])
    _same_results(res, jres)
    rgba = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    (dec, res), (jdec, jres) = _both(
        {"mode": "direct_video", "option1": "BGRx"}, [((2, 3, 4), "UINT8")],
        [(rgba,)])
    assert _spec_fields(dec.out_specs[0]) == (
        "VideoSpec", 3, 2, "BGRx") == _spec_fields(jdec.out_specs[0])
    _same_results(res, jres)


def test_direct_video_rejects_float():
    for nns, parts in ((tnns, PORT), (jnns, JAX)):
        with pytest.raises(Exception, match="uint8"):
            _decode(nns, parts, {"mode": "direct_video"},
                    [((4, 4, 3), "FLOAT32")],
                    [(np.zeros((4, 4, 3), np.float32),)])


# -- segmentation ------------------------------------------------------------

def _halves():
    scores = np.zeros((1, 4, 4, 3), np.float32)
    scores[0, :2, :, 1] = 1.0   # top half class 1
    scores[0, 2:, :, 2] = 1.0   # bottom half class 2
    return scores


def test_segment_tflite_deeplab_argmax():
    scores = _halves()
    (dec, res), (jdec, jres) = _both(
        {"mode": "image_segment", "option1": "tflite-deeplab"},
        [((1, 4, 4, 3), "FLOAT32")], [(scores,)])
    cm = res[0].meta["class_map"]
    assert cm.shape == (4, 4)
    assert (cm[:2] == 1).all() and (cm[2:] == 2).all()
    img = res[0].tensors[0]
    assert img.shape == (4, 4, 4)
    # two distinct colors, both opaque
    assert img[0, 0, 3] == 255 and img[3, 0, 3] == 255
    assert not np.array_equal(img[0, 0], img[3, 0])
    _same_results(res, jres)
    np.testing.assert_array_equal(cm, jres[0].meta["class_map"])
    assert cm.dtype == jres[0].meta["class_map"].dtype
    assert _spec_fields(dec.out_specs[0]) == _spec_fields(jdec.out_specs[0])


def test_segment_index_variant():
    idx_map = np.array([[0, 1], [2, 3]], np.uint8)
    (dec, res), (jdec, jres) = _both(
        {"mode": "image_segment", "option1": "index", "option2": "4"},
        [((2, 2), "UINT8")], [(idx_map,)])
    assert res[0].meta["class_map"].tolist() == [[0, 1], [2, 3]]
    assert res[0].tensors[0][0, 0, 3] == 0  # background transparent
    _same_results(res, jres)
    np.testing.assert_array_equal(res[0].meta["class_map"],
                                  jres[0].meta["class_map"])


def test_segment_deeplab_scores_match_jax():
    """DeepLab's published output shape at a reduced side (seeded scores,
    21 VOC classes): the same RGBA overlay and class map as JAX."""
    scores = np.random.default_rng(0).normal(
        0, 1, (1, 33, 33, 21)).astype(np.float32)
    (dec, res), (_, jres) = _both(
        {"mode": "image_segment", "option1": "tflite-deeplab"},
        [((1, 33, 33, 21), "FLOAT32")], [(scores,)])
    _same_results(res, jres)
    np.testing.assert_array_equal(res[0].meta["class_map"],
                                  scores[0].argmax(-1))


# -- octet -------------------------------------------------------------------

def test_octet_stream_concat():
    a = np.array([1, 2], np.uint8)
    b = np.array([3, 4], np.uint8)
    (dec, res), (jdec, jres) = _both(
        {"mode": "octet_stream"}, [((2,), "UINT8"), ((2,), "UINT8")],
        [(a, b)])
    assert isinstance(dec.out_specs[0], OctetSpec)
    assert isinstance(jdec.out_specs[0], JOctetSpec)
    np.testing.assert_array_equal(res[0].tensors[0], [1, 2, 3, 4])
    _same_results(res, jres)


def test_octet_stream_float_logits_bytes():
    """A float tensor's bytes, as the JAX decoder gives them."""
    logits = np.random.default_rng(1).normal(0, 1, (1, 1001)).astype(
        np.float32)
    (_, res), (_, jres) = _both(
        {"mode": "octet_stream"}, [((1, 1001), "FLOAT32")], [(logits,)])
    assert res[0].tensors[0].tobytes() == logits.tobytes()
    _same_results(res, jres)


# -- device decode -----------------------------------------------------------

def _device_map(nns, scores, option1="tflite-deeplab"):
    dims = ":".join(str(d) for d in scores.shape[::-1])
    pipe = nns.parse_launch(
        f"appsrc name=in dims={dims} types=float32 ! "
        f"tensor_decoder mode=image_segment device=true "
        f"option1={option1} ! tensor_sink name=out")
    runner = nns.PipelineRunner(pipe).start()
    src = pipe.get("in")
    buf = (TensorBuffer if nns is tnns else JTensorBuffer).of(scores)
    src.push(buf)
    src.end()
    runner.wait(30)
    runner.stop()
    return np.asarray(pipe.get("out").results[0].tensors[0])


def test_segment_device_argmax_map():
    cm = _device_map(tnns, _halves())
    assert cm.shape == (4, 4) and cm.dtype == np.uint8
    assert (cm[:2] == 1).all() and (cm[2:] == 2).all()
    jcm = _device_map(jnns, _halves())
    assert cm.tobytes() == jcm.tobytes() and jcm.dtype == np.uint8


def test_segment_device_map_equals_host_class_map():
    """Seeded DeepLab-shaped scores: the device uint8 map is the host
    decoder's int32 argmax, bit for bit, and JAX's device map."""
    scores = np.random.default_rng(2).normal(
        0, 1, (1, 33, 33, 21)).astype(np.float32)
    cm = _device_map(tnns, scores)
    (_, host), _ = _both(
        {"mode": "image_segment", "option1": "tflite-deeplab"},
        [((1, 33, 33, 21), "FLOAT32")], [(scores,)])
    np.testing.assert_array_equal(cm, host[0].meta["class_map"])
    assert cm.tobytes() == _device_map(jnns, scores).tobytes()


@pytest.mark.parametrize("case", ["index", "classes"])
def test_segment_device_refusals_match_jax(case):
    """The device path refuses an index map and more than 256 classes,
    with the JAX package's text."""
    from nnstreamer_tpu_torch.decoders.segment import ImageSegment
    from nnstreamer_tpu.decoders.segment import ImageSegment as JImageSegment

    opt, shape = (("index", (4, 4)) if case == "index"
                  else ("tflite-deeplab", (1, 4, 4, 300)))
    got, want = [], []
    for sub_cls, spec, info, dt, out in (
            (ImageSegment, TensorsSpec, TensorInfo, DType, got),
            (JImageSegment, JTensorsSpec, JTensorInfo, JDType, want)):
        sub = sub_cls()
        sub.init({"option1": opt})
        with pytest.raises(Exception) as e:
            sub.device_negotiate(spec.of(info(shape, dt.FLOAT32)))
        out.append((type(e.value).__name__, str(e.value)))
    assert got == want

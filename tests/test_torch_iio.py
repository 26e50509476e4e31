"""tensor_src_iio on the port (nnstreamer_tpu_torch/elements/iio.py)
against the JAX package's, on the CPU: tests/test_iio.py's cases on the
same fake sysfs trees (the reference's own technique), each run through
both packages' element, the port's frames bit for bit JAX's (`both`),
then the JAX test's assertions on the port's; and the port's source into
a torch filter."""

import struct

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as nns
from nnstreamer_tpu.elements.iio import TensorSrcIIO as JSrcIIO
from nnstreamer_tpu.elements.iio import parse_channel_type as jparse
from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.elements.iio import TensorSrcIIO, parse_channel_type


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def make_device(tmp_path, name="fake_accel", freq="100",
                channels=(), extras=()):
    """channels: (chan_name, index, type_str[, scale[, offset]])."""
    dev = tmp_path / "iio:device0"
    scan = dev / "scan_elements"
    scan.mkdir(parents=True)
    (dev / "name").write_text(name + "\n")
    (dev / "sampling_frequency").write_text(freq + "\n")
    for spec in channels:
        chan, idx, typ = spec[:3]
        (scan / f"{chan}_en").write_text("1\n")
        (scan / f"{chan}_index").write_text(str(idx) + "\n")
        (scan / f"{chan}_type").write_text(typ + "\n")
        if len(spec) > 3:
            (dev / f"{chan}_scale").write_text(str(spec[3]) + "\n")
        if len(spec) > 4:
            (dev / f"{chan}_offset").write_text(str(spec[4]) + "\n")
    for chan, idx, typ in extras:    # present but disabled
        (scan / f"{chan}_en").write_text("0\n")
        (scan / f"{chan}_index").write_text(str(idx) + "\n")
        (scan / f"{chan}_type").write_text(typ + "\n")
    return dev


def _frames(src):
    src.out_specs = [src.output_spec()]
    return list(src.generate())


def run_src(src: TensorSrcIIO):
    """The port's frames, held to JAX's element built with the same
    properties on the same tree: spec, count, pts, dtype and bytes."""
    got = _frames(src)
    jsrc = JSrcIIO(name=src.name, **{k: v for k, v in src.props.items()
                                     if v is not None})
    ref = _frames(jsrc)
    mine, theirs = src.out_specs[0], jsrc.out_specs[0]
    assert [(t.shape, t.name) for t in mine.tensors] == \
        [(t.shape, t.name) for t in theirs.tensors]
    assert mine.rate == theirs.rate and len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.pts == r.pts and g.num_tensors == r.num_tensors
        for a, b in zip(g.tensors, r.tensors):
            assert isinstance(a, np.ndarray)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    return got


# -- type-string parsing ------------------------------------------------------

def test_parse_channel_type():
    assert parse_channel_type("x", "le:s12/16>>4") == jparse(
        "x", "le:s12/16>>4")
    d = parse_channel_type("x", "le:s12/16>>4")
    assert d == dict(used_bits=12, storage_bits=16, shift=4,
                     signed=True, big_endian=False)
    d = parse_channel_type("x", "be:u32/32>>0")
    assert d["big_endian"] and not d["signed"]


@pytest.mark.parametrize("bad", ["s12/16>>4", "le:x12/16>>4", "le:s0/16>>0",
                                 "le:s20/16>>0", "le:s65/128>>0", ""])
def test_parse_channel_type_rejects(bad):
    with pytest.raises(PipelineError):
        parse_channel_type("x", bad)


# -- decode paths -------------------------------------------------------------

def test_basic_capture_with_scale_offset(tmp_path):
    dev = make_device(tmp_path, channels=[
        ("in_accel_x", 0, "le:s16/16>>0", 0.5, 10.0),
        ("in_accel_y", 1, "le:s16/16>>0", 0.5, 10.0)])
    samples = [(-4, 2), (100, -100), (32767, -32768)]
    data = tmp_path / "stream.bin"
    data.write_bytes(b"".join(struct.pack("<hh", x, y) for x, y in samples))
    src = TensorSrcIIO(name="s", device="fake_accel",
                       base_dir=str(tmp_path), data=str(data))
    bufs = run_src(src)
    assert len(bufs) == 3
    # IIO convention: (raw + offset) * scale
    np.testing.assert_allclose(bufs[0].tensors[0],
                               [[(-4 + 10) * .5, (2 + 10) * .5]])
    np.testing.assert_allclose(bufs[2].tensors[0],
                               [[(32767 + 10) * .5, (-32768 + 10) * .5]])


def test_12bit_shifted_sign_extension(tmp_path):
    # 12 used bits stored left-aligned in 16 (>>4), like many ADCs
    dev = make_device(tmp_path, channels=[("in_adc0", 0, "le:s12/16>>4")])
    vals = [-2048, -1, 0, 2047]
    raw = b"".join(struct.pack("<H", (v & 0xFFF) << 4) for v in vals)
    data = tmp_path / "s.bin"
    data.write_bytes(raw)
    src = TensorSrcIIO(name="s", device="iio:device0",
                       base_dir=str(tmp_path), data=str(data),
                       frames_per_tensor=4)
    bufs = run_src(src)
    np.testing.assert_array_equal(bufs[0].tensors[0][:, 0], vals)


def test_mixed_width_alignment_padding(tmp_path):
    """3×16-bit channels + 64-bit timestamp: the kernel pads the u64 to
    an 8-byte boundary, so frames are 16 bytes, not 14
    (gsttensor_srciio.c:1503-1522 alignment rule)."""
    dev = make_device(tmp_path, channels=[
        ("in_accel_x", 0, "le:s16/16>>0"),
        ("in_accel_y", 1, "le:s16/16>>0"),
        ("in_accel_z", 2, "le:s16/16>>0"),
        ("in_timestamp", 3, "le:s64/64>>0")])
    frames = []
    for i in range(3):
        frames.append(struct.pack("<hhh2xq", 10 + i, 20 + i, 30 + i,
                                  1000 + i))
    data = tmp_path / "s.bin"
    data.write_bytes(b"".join(frames))
    src = TensorSrcIIO(name="s", device="fake_accel",
                       base_dir=str(tmp_path), data=str(data))
    assert src.output_spec() and src._frame_bytes == 16
    bufs = run_src(src)
    assert len(bufs) == 3
    np.testing.assert_array_equal(
        bufs[1].tensors[0], [[11.0, 21.0, 31.0, 1001.0]])


def test_channels_ordered_by_index_not_name(tmp_path):
    dev = make_device(tmp_path, channels=[
        ("in_a", 1, "le:u8/8>>0"),      # alphabetically first, index 1
        ("in_b", 0, "le:u8/8>>0")])     # index 0 → first in frame
    data = tmp_path / "s.bin"
    data.write_bytes(bytes([7, 9]))     # frame: [b=7, a=9]
    src = TensorSrcIIO(name="s", device="fake_accel",
                       base_dir=str(tmp_path), data=str(data))
    bufs = run_src(src)
    np.testing.assert_array_equal(bufs[0].tensors[0], [[7.0, 9.0]])


def test_split_channels_and_names(tmp_path):
    dev = make_device(tmp_path, channels=[
        ("in_x", 0, "le:u8/8>>0"), ("in_y", 1, "le:u8/8>>0")])
    data = tmp_path / "s.bin"
    data.write_bytes(bytes([1, 2, 3, 4]))
    src = TensorSrcIIO(name="s", device="fake_accel",
                       base_dir=str(tmp_path), data=str(data),
                       merge_channels=False)
    spec = src.output_spec()
    assert [t.name for t in spec.tensors] == ["in_x", "in_y"]
    bufs = run_src(src)
    assert bufs[0].num_tensors == 2
    np.testing.assert_array_equal(bufs[1].tensors[1], [[4.0]])


def test_disabled_channels_ignored_and_big_endian(tmp_path):
    dev = make_device(
        tmp_path,
        channels=[("in_v", 0, "be:u16/16>>0")],
        extras=[("in_skip", 1, "le:u8/8>>0")])
    data = tmp_path / "s.bin"
    data.write_bytes(struct.pack(">H", 0x0102))
    src = TensorSrcIIO(name="s", device="fake_accel",
                       base_dir=str(tmp_path), data=str(data))
    bufs = run_src(src)
    np.testing.assert_array_equal(bufs[0].tensors[0], [[0x0102]])


def test_trailing_partial_frame_discarded(tmp_path):
    dev = make_device(tmp_path, channels=[("in_v", 0, "le:u16/16>>0")])
    data = tmp_path / "s.bin"
    data.write_bytes(b"\x01\x00\x02\x00\x03")   # 2.5 frames
    src = TensorSrcIIO(name="s", device="fake_accel",
                       base_dir=str(tmp_path), data=str(data))
    bufs = run_src(src)
    assert len(bufs) == 2


# -- negotiation / errors -----------------------------------------------------

def test_rate_and_num_buffers(tmp_path):
    dev = make_device(tmp_path, freq="200", channels=[
        ("in_v", 0, "le:u8/8>>0")])
    data = tmp_path / "s.bin"
    data.write_bytes(bytes(range(10)))
    src = TensorSrcIIO(name="s", device="fake_accel",
                       base_dir=str(tmp_path), data=str(data),
                       frames_per_tensor=2, num_buffers=3)
    spec = src.output_spec()
    assert spec.rate == 100          # 200 Hz / 2 frames per tensor
    assert spec.tensors[0].shape == (2, 1)
    bufs = run_src(src)
    assert len(bufs) == 3 and [b.pts for b in bufs] == [0, 10**7, 2 * 10**7]


def test_unknown_device_lists_found(tmp_path):
    make_device(tmp_path, name="other")
    with pytest.raises(PipelineError, match="no IIO device named"):
        TensorSrcIIO(name="s", device="nope",
                     base_dir=str(tmp_path)).output_spec()


def test_no_enabled_channels_fails(tmp_path):
    make_device(tmp_path, channels=[],
                extras=[("in_v", 0, "le:u8/8>>0")])
    with pytest.raises(PipelineError, match="no enabled channels"):
        TensorSrcIIO(name="s", device="fake_accel",
                     base_dir=str(tmp_path)).output_spec()


def test_pipeline_dsl_integration(tmp_path):
    make_device(tmp_path, channels=[("in_v", 0, "le:s16/16>>0", 0.1)])
    data = tmp_path / "s.bin"
    data.write_bytes(struct.pack("<4h", 10, 20, 30, 40))
    pipe = nns.parse_launch(
        f"tensor_src_iio device=fake_accel base_dir={tmp_path} "
        f"data={data} frames_per_tensor=2 ! tensor_sink name=out")
    runner = nns.PipelineRunner(pipe).start()
    runner.wait(30)
    runner.stop()
    res = pipe.get("out").results
    assert len(res) == 2
    np.testing.assert_allclose(res[0].tensors[0][:, 0], [1.0, 2.0])


def test_iio_into_a_torch_filter(tmp_path):
    """The port's IIO frames (host arrays) staged by a torch filter: the
    model sees them as tensors on its device, the sink the same values as
    JAX's pipeline with the same model."""
    from nnstreamer_tpu.backends.xla import ModelBundle as JBundle
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle

    make_device(tmp_path, channels=[("in_x", 0, "le:s16/16>>0", 0.5),
                                    ("in_y", 1, "le:s16/16>>0", 0.25)])
    data = tmp_path / "s.bin"
    data.write_bytes(struct.pack("<8h", *range(-4, 4)))
    launch = (f"tensor_src_iio device=fake_accel base_dir={tmp_path} "
              f"data={data} frames_per_tensor=2 ! tensor_filter name=f ! "
              f"tensor_sink name=out")
    seen = []
    res = {}
    for pkg, bundle in (
            (jnns, JBundle(fn=lambda p, x: (x.sum(axis=0),))),
            (nns, ModelBundle(fn=lambda p, x: seen.append(x) or
                              (x.sum(dim=0),)))):
        pipe = pkg.parse_launch(launch)
        pipe.get("f").set_props(model=bundle)
        pkg.run_pipeline(pipe, timeout=30)
        res[pkg] = [np.asarray(r.tensors[0]) for r in pipe.get("out").results]
    # the negotiation probe (zeros) and the two frames
    assert all(isinstance(x, torch.Tensor) for x in seen) and len(seen) == 3
    assert len(res[nns]) == len(res[jnns]) == 2
    for g, r in zip(res[nns], res[jnns]):
        np.testing.assert_allclose(g, r, rtol=0, atol=0)


"""tensor_src_iio — Linux IIO sensor source, the JAX package's
elements/iio.py on the port (host work on numpy, as there).

Reference parity: gst/nnstreamer/elements/gsttensor_srciio.c. Reads an
Industrial-I/O device's scan_elements channel config from sysfs
(`/sys/bus/iio/devices/iio:deviceN/`), decodes the device's binary
sample stream, and emits per-sample (or merged) tensors.

sysfs layout consumed (same files the reference reads):
  <base>/iio:deviceN/name                      device name
  <base>/iio:deviceN/sampling_frequency        Hz (optional)
  <base>/iio:deviceN/scan_elements/in_X_en     1 if channel enabled
  <base>/iio:deviceN/scan_elements/in_X_index  position in the frame
  <base>/iio:deviceN/scan_elements/in_X_type   "le:s12/16>>4" layout
  <base>/iio:deviceN/in_X_scale / in_X_offset  optional float transforms

numpy decodes whole sample blocks at once, the (raw + offset) * scale
transform on the full block. The data source is a file path (`data`
property): `/dev/iio:deviceN` on a real system, a regular file in tests
(the reference's own test uses a fake sysfs tree the same way). A
regular file is read once then EOS; a char device streams forever. The
frames are host arrays; a filter on the card downstream stages them.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from fractions import Fraction
from typing import Iterator, List, Optional

import numpy as np

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import PropDef, SourceElement, StreamSpec, prop_bool
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

log = get_logger("elements.iio")

DEFAULT_BASE = "/sys/bus/iio/devices"
_TYPE_RE = re.compile(
    r"^(?P<endian>be|le):(?P<sign>[su])(?P<used>\d+)/(?P<storage>\d+)"
    r">>(?P<shift>\d+)\s*$")


@dataclass
class _Channel:
    name: str
    index: int
    used_bits: int
    storage_bits: int
    shift: int
    signed: bool
    big_endian: bool
    scale: float = 1.0
    offset: float = 0.0

    @property
    def np_dtype(self) -> np.dtype:
        size = self.storage_bits // 8
        if size not in (1, 2, 4, 8):
            raise PipelineError(
                f"iio channel {self.name}: storage {self.storage_bits} bits "
                f"is not byte-aligned")
        return np.dtype(f"{'>' if self.big_endian else '<'}u{size}")

    def decode(self, raw: np.ndarray) -> np.ndarray:
        """Vectorized sample decode: shift, mask to used bits, sign-extend,
        then (value + offset) * scale → float32 (IIO convention)."""
        v = raw.astype(np.uint64) >> np.uint64(self.shift)
        mask = np.uint64((1 << self.used_bits) - 1)
        v = v & mask
        if self.signed:
            # sign-extend any width (incl. 64-bit timestamps) without
            # overflow: left-align in the 64-bit word, arithmetic shift back
            sh = np.uint64(64 - self.used_bits)
            vi = (v << sh).view(np.int64) >> np.int64(sh)
            out = vi.astype(np.float32)
        else:
            out = v.astype(np.float32)
        return ((out + self.offset) * self.scale).astype(np.float32)


def _read_file(path: str) -> Optional[str]:
    try:
        with open(path, "r") as f:
            return f.read().strip()
    except OSError:
        return None


def parse_channel_type(name: str, text: str) -> dict:
    """Parse the scan_elements *_type format ("le:s12/16>>4",
    gsttensor_srciio.c:725-790)."""
    m = _TYPE_RE.match(text)
    if not m:
        raise PipelineError(
            f"iio channel {name}: bad _type contents {text!r}; expected "
            f"e.g. 'le:s12/16>>4'")
    used = int(m.group("used"))
    storage = int(m.group("storage"))
    if used == 0 or used > storage or storage > 64:
        raise PipelineError(
            f"iio channel {name}: invalid bits {used}/{storage}")
    return dict(used_bits=used, storage_bits=storage,
                shift=int(m.group("shift")),
                signed=m.group("sign") == "s",
                big_endian=m.group("endian") == "be")


@register_element("tensor_src_iio")
class TensorSrcIIO(SourceElement):
    """Emit IIO sensor samples as tensor frames.

    device: device name (matched against <base>/iio:deviceN/name) or
    "iio:deviceN" directly. frames_per_tensor: samples per emitted
    buffer. merge_channels: one (frames, channels) float32 tensor
    (default) vs one tensor per channel. data: sample stream path
    (defaults to /dev/<device>).
    """

    ELEMENT_NAME = "tensor_src_iio"
    PROPS = {
        "device": PropDef(str, None, "IIO device name or iio:deviceN"),
        "base_dir": PropDef(str, DEFAULT_BASE, "sysfs root (tests override)"),
        "data": PropDef(str, "", "sample stream path (default /dev/<dev>)"),
        "frames_per_tensor": PropDef(int, 1),
        "merge_channels": PropDef(prop_bool, True),
        "num_buffers": PropDef(int, 0, "0 = until EOF"),
        "frequency": PropDef(int, 0, "override sampling_frequency (Hz)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if not self.props["device"]:
            raise PipelineError(
                f"tensor_src_iio ({self.name}) requires device=<name|"
                f"iio:deviceN>")
        self._channels: List[_Channel] = []
        self._dev_dir = ""
        self._rate = Fraction(0, 1)

    # -- sysfs scan (start-time config, gsttensor_srciio.c:1620-1700) ------
    def _find_device_dir(self) -> str:
        base = self.props["base_dir"]
        want = self.props["device"]
        if want.startswith("iio:device"):
            d = os.path.join(base, want)
            if not os.path.isdir(d):
                raise PipelineError(
                    f"tensor_src_iio {self.name}: no {d!r}")
            return d
        try:
            entries = sorted(os.listdir(base))
        except OSError as e:
            raise PipelineError(
                f"tensor_src_iio {self.name}: cannot scan {base!r}: {e}"
            ) from None
        for ent in entries:
            if not ent.startswith("iio:device"):
                continue
            nm = _read_file(os.path.join(base, ent, "name"))
            if nm == want:
                return os.path.join(base, ent)
        raise PipelineError(
            f"tensor_src_iio {self.name}: no IIO device named {want!r} "
            f"under {base!r} (found: "
            f"{[e for e in entries if e.startswith('iio:')]}))")

    def _scan_channels(self, dev_dir: str) -> List[_Channel]:
        scan = os.path.join(dev_dir, "scan_elements")
        if not os.path.isdir(scan):
            raise PipelineError(
                f"tensor_src_iio {self.name}: {scan!r} missing — device "
                f"has no buffered capture support")
        chans: List[_Channel] = []
        for fn in sorted(os.listdir(scan)):
            if not fn.endswith("_en"):
                continue
            chan_name = fn[:-3]
            if _read_file(os.path.join(scan, fn)) != "1":
                continue
            idx = _read_file(os.path.join(scan, f"{chan_name}_index"))
            typ = _read_file(os.path.join(scan, f"{chan_name}_type"))
            if idx is None or typ is None:
                raise PipelineError(
                    f"tensor_src_iio {self.name}: channel {chan_name} "
                    f"missing _index/_type in {scan!r}")
            spec = parse_channel_type(chan_name, typ)
            scale = _read_file(os.path.join(dev_dir, f"{chan_name}_scale"))
            offset = _read_file(os.path.join(dev_dir, f"{chan_name}_offset"))
            chans.append(_Channel(
                name=chan_name, index=int(idx),
                scale=float(scale) if scale else 1.0,
                offset=float(offset) if offset else 0.0, **spec))
        if not chans:
            raise PipelineError(
                f"tensor_src_iio {self.name}: no enabled channels in "
                f"{scan!r} (echo 1 > in_..._en)")
        chans.sort(key=lambda c: c.index)
        return chans

    def output_spec(self) -> StreamSpec:
        self._dev_dir = self._find_device_dir()
        self._channels = self._scan_channels(self._dev_dir)
        hz = self.props["frequency"] or int(
            float(_read_file(os.path.join(self._dev_dir,
                                          "sampling_frequency")) or 0))
        self._rate = Fraction(hz, max(1, self.props["frames_per_tensor"])) \
            if hz else Fraction(0, 1)
        n = self.props["frames_per_tensor"]
        if self.props["merge_channels"]:
            infos = (TensorInfo((n, len(self._channels)), DType.FLOAT32),)
        else:
            infos = tuple(TensorInfo((n, 1), DType.FLOAT32,
                                     name=c.name) for c in self._channels)
        return TensorsSpec(tensors=infos, rate=self._rate)

    # -- capture loop ------------------------------------------------------
    def _layout(self) -> List[int]:
        """Byte offset of each channel in a frame. The kernel aligns every
        scan element to its own storage size (gsttensor_srciio.c:1503-1522:
        location = align(running_size, storage_bytes)), so mixed-width
        channels (e.g. 3×s16 + u64 timestamp) have padding holes."""
        offs, size = [], 0
        for c in self._channels:
            sb = c.storage_bits // 8
            rem = size % sb
            loc = size if rem == 0 else size - rem + sb
            offs.append(loc)
            size = loc + sb
        return offs

    @property
    def _frame_bytes(self) -> int:
        offs = self._layout()
        last = self._channels[-1]
        return offs[-1] + last.storage_bits // 8

    def _data_path(self) -> str:
        if self.props["data"]:
            return self.props["data"]
        return os.path.join("/dev", os.path.basename(self._dev_dir))

    def generate(self) -> Iterator[TensorBuffer]:
        path = self._data_path()
        fpt = self.props["frames_per_tensor"]
        block = self._frame_bytes * fpt
        limit = self.props["num_buffers"]
        period_ns = int(1e9 / self._rate) if self._rate else 0
        emitted = 0
        try:
            f = open(path, "rb", buffering=0)
        except OSError as e:
            raise PipelineError(
                f"tensor_src_iio {self.name}: cannot open data stream "
                f"{path!r}: {e}") from None
        with f:
            while not limit or emitted < limit:
                # raw char devices legally return short reads when fewer
                # samples are buffered: accumulate until a full block or
                # true EOF (empty read)
                data = b""
                while len(data) < block:
                    chunk = f.read(block - len(data))
                    if not chunk:
                        break
                    data += chunk
                if len(data) < block:
                    if data:
                        log.warning(
                            "%s: discarding %d trailing bytes (< one "
                            "%d-byte block) at EOF", self.name, len(data),
                            block)
                    break   # EOF (regular file) or device stopped
                yield self._decode_block(data, fpt, emitted, period_ns)
                emitted += 1

    def _decode_block(self, data: bytes, fpt: int, seq: int,
                      period_ns: int) -> TensorBuffer:
        # split interleaved storage: channels sit at their aligned
        # locations within each frame (kernel scan-element layout)
        cols = []
        stride = self._frame_bytes
        offs = self._layout()
        raw = np.frombuffer(data, np.uint8).reshape(fpt, stride)
        for c, off in zip(self._channels, offs):
            size = c.storage_bits // 8
            col = raw[:, off:off + size].copy().view(c.np_dtype)[:, 0]
            cols.append(c.decode(col))
        pts = seq * period_ns if period_ns else seq
        if self.props["merge_channels"]:
            return TensorBuffer.of(np.stack(cols, axis=1), pts=pts)
        return TensorBuffer.of(*(col[:, None] for col in cols), pts=pts)

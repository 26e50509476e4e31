"""Source elements: videotestsrc, appsrc, tensor_src, filesrc and
audiotestsrc (GStreamer core's sources and the framework's own
tensor_src; there is no GStreamer underneath). Every source makes host
numpy arrays, equal to the JAX package's for the same properties.

Pacing (videotestsrc is-live, filesrc rate) sleeps through the module's
`_sleep`, so a test can count it on a controlled clock.
"""

from __future__ import annotations

import os
import queue as _queue
import time
from fractions import Fraction
from typing import Iterator, List

import numpy as np

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.media import AudioSpec, VideoSpec
from nnstreamer_tpu_torch.graph.pipeline import (
    PropDef, SourceElement, StreamSpec, prop_bool)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

NS = 1_000_000_000
#: the pacing sleep (time.sleep; a test may replace it)
_sleep = time.sleep


@register_element("videotestsrc")
class VideoTestSrc(SourceElement):
    """Deterministic video pattern generator (videotestsrc analog).

    Patterns: `gradient` (default; per-frame-varying diagonal ramp),
    `random` (seeded uniform noise) and `solid` (every byte
    `solid_color`). The frames equal the JAX package's for the same
    (pattern, seed). `is_live=true` paces emission to the framerate, one
    frame interval before each frame, kept or not. An upstream QoS event
    (`{"type": "qos", "min_interval_ns": N}`) makes it skip frames closer
    than N ns after the last one it emitted, before computing them
    (counted in `qos_skipped`).
    """

    ELEMENT_NAME = "videotestsrc"
    PROPS = {
        "width": PropDef(int, 224),
        "height": PropDef(int, 224),
        "format": PropDef(str, "RGB"),
        "num_buffers": PropDef(int, 10, "frames to emit before EOS"),
        "framerate": PropDef(str, "30/1"),
        "pattern": PropDef(str, "gradient", "gradient|random|solid"),
        "solid_color": PropDef(int, 127),
        "seed": PropDef(int, 0),
        "is_live": PropDef(prop_bool, False, "pace emission to framerate"),
    }

    def output_spec(self) -> StreamSpec:
        return VideoSpec(width=self.props["width"], height=self.props["height"],
                         format=self.props["format"],
                         rate=Fraction(self.props["framerate"]))

    def generate(self) -> Iterator[TensorBuffer]:
        spec: VideoSpec = self.out_specs[0]
        h, w, c = spec.frame_shape
        rate = spec.rate or Fraction(30, 1)
        frame_ns = int(NS / rate)
        pattern = self.props["pattern"]
        rng = np.random.default_rng(self.props["seed"])
        next_qos_pts = 0
        for i in range(self.props["num_buffers"]):
            pts = i * frame_ns
            # a live source models a camera: the frame interval elapses
            # whether or not the frame is kept, so pace BEFORE the QoS
            # skip or throttled live capture runs ahead of real time
            if self.props["is_live"]:
                _sleep(frame_ns / NS)
            # downstream throttle QoS (an upstream event): skip BEFORE
            # computing the frame — the point of the event
            qos = self.qos_min_interval_ns
            if qos and pts < next_qos_pts:
                self.qos_skipped += 1
                continue
            if qos:
                next_qos_pts = pts + qos
            if pattern == "random":
                frame = rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
            elif pattern == "solid":
                frame = np.full((h, w, c), self.props["solid_color"], np.uint8)
            elif pattern == "gradient":
                yy, xx = np.mgrid[0:h, 0:w]
                base = (xx + yy + 7 * i) % 256
                frame = np.stack([(base + 85 * ch) % 256 for ch in range(c)],
                                 axis=-1).astype(np.uint8)
            else:
                raise PipelineError(
                    f"videotestsrc pattern {pattern!r} unknown "
                    f"(gradient|random|solid)")
            yield TensorBuffer.of(frame, pts=pts, duration=frame_ns)


@register_element("appsrc")
class AppSrc(SourceElement):
    """Programmatic ingress: the application pushes buffers.

        src = AppSrc(spec=TensorsSpec...)   # or any MediaSpec
        src.push(buf); ...; src.end()

    In the DSL, give dims/types: `appsrc dims=3:224:224:1 types=uint8`.
    """

    ELEMENT_NAME = "appsrc"
    PROPS = {
        "spec": PropDef(lambda s: s, None, "StreamSpec object (programmatic)"),
        "dims": PropDef(str, "", "tensor dims string, e.g. 3:224:224:1"),
        "types": PropDef(str, "float32"),
        "rate": PropDef(str, "0/1"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._q: "_queue.Queue" = _queue.Queue()
        self._closed = False

    def output_spec(self) -> StreamSpec:
        if self.props["spec"] is not None:
            return self.props["spec"]
        if self.props["dims"]:
            return TensorsSpec.from_strings(
                self.props["dims"], self.props["types"],
                rate=Fraction(self.props["rate"]))
        raise PipelineError(
            f"appsrc ({self.name}) needs spec=<StreamSpec> (programmatic) "
            f"or dims=/types= properties")

    def push(self, buf) -> None:
        if self._closed:
            raise PipelineError(f"appsrc {self.name}: push after end()")
        if isinstance(buf, np.ndarray):
            buf = TensorBuffer.of(buf)
        self._q.put(buf)

    def end(self) -> None:
        self._closed = True
        self._q.put(None)

    def interrupt(self) -> None:
        self._q.put(None)

    def generate(self) -> Iterator[TensorBuffer]:
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item


@register_element("tensor_src")
class TensorSrc(SourceElement):
    """Emit a fixed iterable of arrays/buffers (test + replay source)."""

    ELEMENT_NAME = "tensor_src"
    PROPS = {
        "data": PropDef(lambda s: s, None, "iterable of arrays or buffers"),
        "spec": PropDef(lambda s: s, None, "TensorsSpec (else inferred)"),
        "rate": PropDef(str, "0/1"),
    }

    def output_spec(self) -> StreamSpec:
        if self.props["spec"] is not None:
            return self.props["spec"]
        data = self.props["data"]
        if not data:
            raise PipelineError(f"tensor_src ({self.name}) needs data= items")
        first = data[0]
        arrs = first.tensors if isinstance(first, TensorBuffer) else (first,)
        return TensorBuffer.of(*arrs).spec().with_rate(
            Fraction(self.props["rate"]))

    def generate(self) -> Iterator[TensorBuffer]:
        for i, item in enumerate(self.props["data"] or []):
            if isinstance(item, TensorBuffer):
                yield item
            else:
                yield TensorBuffer.of(item, pts=i)


@register_element("filesrc")
class FileSrc(SourceElement):
    """Replay frames from a file (filesrc + decodebin-lite analog).

    Formats by extension:
    - .npy  — one array; axis 0 indexes frames (shape[1:] per frame),
              unless frames-per-file=1, then the whole array is one frame
    - .npz  — arrays sorted by key, one frame each
    - .raw/.bin — raw bytes reshaped to dims/types per frame, repeated
              until the file is exhausted (the reference's raw filesrc +
              tensor_converter octet path)
    """

    ELEMENT_NAME = "filesrc"
    PROPS = {
        "location": PropDef(str, None, "input file path"),
        "dims": PropDef(str, "", "frame dims for raw files"),
        "types": PropDef(str, "float32"),
        "rate": PropDef(str, "0/1", "emission framerate, 0/1 = as fast"),
        "frames_per_file": PropDef(int, 0, "npy: 0 = axis-0-indexed"),
        "loop": PropDef(prop_bool, False, "repeat forever"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if not self.props["location"]:
            raise PipelineError(f"filesrc {self.name}: location= is required")
        self._frames = self._load()
        if not self._frames:
            raise PipelineError(
                f"filesrc {self.name}: {self.props['location']!r} contains "
                f"no frames (empty file or zero-length leading axis)")

    def _load(self) -> List[np.ndarray]:
        path = self.props["location"]
        if not os.path.isfile(path):
            raise PipelineError(
                f"filesrc {self.name}: file not found: {path!r}")
        ext = path.rsplit(".", 1)[-1].lower()
        if ext == "npy":
            arr = np.load(path)
            if self.props["frames_per_file"] == 1 or arr.ndim == 0:
                return [np.atleast_1d(arr)]
            return [arr[i] for i in range(arr.shape[0])]
        if ext == "npz":
            z = np.load(path)
            return [z[k] for k in sorted(z.files)]
        # raw bytes
        if not self.props["dims"]:
            raise PipelineError(
                f"filesrc {self.name}: raw files need dims=/types= to "
                f"frame the byte stream")
        info = TensorsSpec.from_strings(
            self.props["dims"], self.props["types"]).tensors[0]
        with open(path, "rb") as f:
            data = f.read()
        fsize = info.nbytes
        if fsize == 0 or len(data) % fsize != 0:
            raise PipelineError(
                f"filesrc {self.name}: file size {len(data)} is not a "
                f"multiple of the {fsize}-byte frame ({info})")
        return [np.frombuffer(data[i:i + fsize], info.dtype.np_dtype)
                .reshape(info.shape) for i in range(0, len(data), fsize)]

    def output_spec(self) -> StreamSpec:
        spec = TensorBuffer.of(self._frames[0]).spec()
        return spec.with_rate(Fraction(self.props["rate"]))

    def generate(self) -> Iterator[TensorBuffer]:
        rate = Fraction(self.props["rate"])
        frame_ns = int(1e9 / rate) if rate > 0 else 0
        i = 0
        while True:
            for f in self._frames:
                if frame_ns:
                    _sleep(frame_ns / 1e9)
                yield TensorBuffer.of(f, pts=i * (frame_ns or 1))
                i += 1
            if not self.props["loop"]:
                return


@register_element("audiotestsrc")
class AudioTestSrc(SourceElement):
    """Deterministic audio generator (audiotestsrc analog): sine or
    seeded noise chunks of `samples_per_buffer` frames."""

    ELEMENT_NAME = "audiotestsrc"
    PROPS = {
        "sample_rate": PropDef(int, 16000),
        "channels": PropDef(int, 1),
        "format": PropDef(str, "S16LE"),
        "wave": PropDef(str, "sine", "sine|noise"),
        "freq": PropDef(float, 440.0),
        "num_buffers": PropDef(int, 10),
        "samples_per_buffer": PropDef(int, 1024),
        "seed": PropDef(int, 0),
    }

    def output_spec(self) -> StreamSpec:
        return AudioSpec(sample_rate=self.props["sample_rate"],
                         channels=self.props["channels"],
                         sample_format=self.props["format"])

    def generate(self) -> Iterator[TensorBuffer]:
        spec = self.out_specs[0]
        n = self.props["samples_per_buffer"]
        ch = self.props["channels"]
        sr = self.props["sample_rate"]
        rng = np.random.default_rng(self.props["seed"])
        dtype = np.dtype(spec.dtype_name)
        for i in range(self.props["num_buffers"]):
            t = (np.arange(n) + i * n) / sr
            if self.props["wave"] == "noise":
                wave = rng.uniform(-1.0, 1.0, size=(n, ch))
            else:
                wave = np.sin(2 * np.pi * self.props["freq"] * t)[:, None]
                wave = np.repeat(wave, ch, axis=1)
            if dtype.kind == "i":
                chunk = (wave * 0.8 * np.iinfo(dtype).max).astype(dtype)
            else:
                chunk = wave.astype(dtype)
            yield TensorBuffer.of(chunk, pts=int(i * n * 1e9 / sr))

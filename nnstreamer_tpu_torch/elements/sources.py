"""Source elements (videotestsrc/appsrc analogs)."""

from __future__ import annotations

import queue as _queue
from fractions import Fraction
from typing import Iterator

import numpy as np

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.media import VideoSpec
from nnstreamer_tpu_torch.graph.pipeline import PropDef, SourceElement, StreamSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

NS = 1_000_000_000


@register_element("videotestsrc")
class VideoTestSrc(SourceElement):
    """Deterministic video pattern generator (videotestsrc analog).

    Patterns: `gradient` (default; per-frame-varying diagonal ramp) and
    `random` (seeded uniform noise). The frames equal the JAX package's
    for the same (pattern, seed). An upstream QoS event
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
        "pattern": PropDef(str, "gradient", "gradient|random"),
        "seed": PropDef(int, 0),
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
            elif pattern == "gradient":
                yy, xx = np.mgrid[0:h, 0:w]
                base = (xx + yy + 7 * i) % 256
                frame = np.stack([(base + 85 * ch) % 256 for ch in range(c)],
                                 axis=-1).astype(np.uint8)
            else:
                raise PipelineError(
                    f"videotestsrc pattern {pattern!r} unknown "
                    f"(gradient|random)")
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
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._q: "_queue.Queue" = _queue.Queue()
        self._closed = False

    def output_spec(self) -> StreamSpec:
        if self.props["spec"] is not None:
            return self.props["spec"]
        if self.props["dims"]:
            return TensorsSpec.from_strings(self.props["dims"],
                                            self.props["types"])
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

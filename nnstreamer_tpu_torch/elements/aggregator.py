"""tensor_aggregator — frame aggregation / sliding windows.

Reference parity: gsttensor_aggregator.c (properties frames-in/out/flush
and the concat dim, :171-200; GstAdapter ring). This is the reference's
"sequence length" mechanism: the temporal-window primitive that feeds
windowed models. One output per `frames_flush` inputs (default
frames_out), so the output rate is the input rate × frames_in /
frames_flush.

Windows are concatenated where the frames are (`buffer.concatenate`:
numpy for host frames, torch on the device of the first tensor frame
otherwise). The ring keeps views of the incoming tensors, never copies;
each window is a new tensor, so a later in-place write to a window
cannot reach the ring, and nothing upstream writes a frame in place.
"""

from __future__ import annotations

from collections import deque
from fractions import Fraction
from typing import Deque, List, Sequence

from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import Element, Emission, PropDef, StreamSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer, concatenate
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec


@register_element("tensor_aggregator")
class TensorAggregator(Element):
    ELEMENT_NAME = "tensor_aggregator"
    PROPS = {
        "frames_in": PropDef(int, 1, "frames per incoming buffer along dim"),
        "frames_out": PropDef(int, 1, "frames per outgoing buffer (window)"),
        "frames_flush": PropDef(int, 0, "advance per output; 0 = frames_out "
                                        "(tumbling); < frames_out = sliding"),
        "frames_dim": PropDef(int, 0, "row-major axis that counts frames"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._ring: Deque = deque()
        self._axis = 0
        self._pending_flush = 0

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        if spec.num_tensors != 1:
            self.fail_negotiation(
                f"tensor_aggregator windows a single-tensor stream; got "
                f"{spec.num_tensors} tensors (demux first)")
        t = spec.tensors[0]
        fin, fout = self.props["frames_in"], self.props["frames_out"]
        self._axis = self.props["frames_dim"] % len(t.shape)
        if t.shape[self._axis] % max(1, fin) != 0:
            self.fail_negotiation(
                f"frames_in={fin} does not divide axis {self._axis} size "
                f"{t.shape[self._axis]}")
        flush = self.props["frames_flush"] or fout
        if flush <= 0 or fout <= 0 or fin <= 0:
            self.fail_negotiation("frames_in/out/flush must be positive")
        out_shape = tuple(
            (v // fin) * fout if d == self._axis else v
            for d, v in enumerate(t.shape))
        rate = spec.rate * Fraction(fin, flush) if spec.rate else spec.rate
        return [TensorsSpec.of(TensorInfo(out_shape, t.dtype), rate=rate)]

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        fin = self.props["frames_in"]
        fout = self.props["frames_out"]
        flush = self.props["frames_flush"] or fout
        t = buf.tensors[0]
        # slice the incoming buffer into single frames along the axis
        per = t.shape[self._axis] // fin
        for i in range(fin):
            sl = [slice(None)] * t.ndim
            sl[self._axis] = slice(i * per, (i + 1) * per)
            self._ring.append((t[tuple(sl)], buf.pts))
        out: List[Emission] = []
        while len(self._ring) >= fout + self._pending_flush:
            if self._pending_flush:
                for _ in range(self._pending_flush):
                    self._ring.popleft()
                self._pending_flush = 0
            if len(self._ring) < fout:
                break
            window = list(self._ring)[:fout]
            merged = concatenate([w[0] for w in window], self._axis)
            out.append((0, TensorBuffer(tensors=(merged,), pts=window[-1][1])))
            self._pending_flush = flush
        return out

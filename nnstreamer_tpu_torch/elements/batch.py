"""Deadline micro-batching: tensor_batch / tensor_unbatch.

One buffer is one frame everywhere else in a pipeline, so a model filter
runs one invoke — one set of launches — per frame. This pair makes
batching a stream property negotiated like any other cap:

- `tensor_batch` coalesces up to `max-batch` buffers along a leading
  batch axis. A batch flushes when it is full, or when its oldest frame
  has waited `max-latency-ms`, whichever comes first. The deadline rides
  the scheduler's timer wakeup (Element.next_deadline / on_timer,
  runtime/scheduler.py), so a half-full batch ships on time even if no
  further frame arrives. EOS flushes what is left.
- `tensor_unbatch` splits results back into per-frame buffers, restoring
  each frame's pts/duration/meta and arrival order. With N input streams
  into tensor_batch, frames carry (stream_id, seq) tags through the batch
  and route back to the output pad of their stream.

Negotiation keeps PER-FRAME shapes: a batched link's
`TensorsSpec.dyn_batch` says "buffers here carry up to K frames on axis
0", while `spec.tensors` still describe one frame. Elements that are not
batch-aware refuse such links at build time (Element.expect_tensors),
telling the user to insert tensor_unbatch.

Wire format of a batched buffer (n = occupancy, n <= max_batch):
- per tensor j: frames whose leading dim is 1 are CONCATENATED on axis 0
  (rank kept: (1,H,W,C) frames become (n,H,W,C)); any other frames are
  STACKED on a new axis 0 (rank + 1). tensor_unbatch tells the two apart
  by comparing ranks against the negotiated per-frame spec.
- `buf.meta["dyn_batch"] = {"n", "reason", "frames": [{pts, duration,
  meta, stream_id, seq}, ...]}` carries what rebuilds the originals.

Frames that are torch tensors batch with torch (on their device: CUDA
frames are batched on the card, with no host round trip); host frames
batch with numpy.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Dict, List, Optional, Sequence

from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import (
    DYNAMIC, Element, Emission, PropDef, StreamSpec)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer, coalesce
from nnstreamer_tpu_torch.tensor.info import TensorFormat


@register_element("tensor_batch")
class TensorBatch(Element):
    """Coalesce per-frame buffers into deadline-bounded micro-batches.

    Properties:
    - max-batch: flush as soon as this many frames are queued (also what
      dyn_batch advertises downstream).
    - max-latency-ms: the deadline, armed when the FIRST frame of a batch
      arrives, so no frame waits longer than this for batch-mates.

    Every sink pad must carry the same STATIC per-frame spec; frames from
    every pad share one batch.
    """

    ELEMENT_NAME = "tensor_batch"
    NUM_SINK_PADS = DYNAMIC
    NUM_SRC_PADS = 1
    # a timer and fan-in: it runs on its own worker, never in a chain
    CHAIN_FUSABLE = False
    PROPS = {
        "max_batch": PropDef(int, 8, "flush when this many frames queued"),
        "max_latency_ms": PropDef(
            float, 5.0, "max time the oldest frame waits for batch-mates"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        # touched only from this element's worker thread (the process /
        # on_timer / next_deadline / flush contract): no lock
        self._pending: List[dict] = []
        self._deadline: Optional[float] = None
        self._keepdims: List[bool] = []
        self._seq: Dict[object, int] = {}
        self.frames_in = 0
        self.batches_out = 0
        self.flush_full = 0
        self.flush_deadline = 0
        self.flush_eos = 0
        self.occupancy_hist: Dict[int, int] = {}

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        specs = [self.expect_tensors(s, i) for i, s in enumerate(in_specs)]
        first = specs[0]
        for i, s in enumerate(specs[1:], 1):
            if not first.is_compatible(s):
                self.fail_negotiation(
                    f"sink pad {i} spec {s} incompatible with pad 0 spec "
                    f"{first}; tensor_batch coalesces frames from every pad "
                    f"into one batch, so all input streams must share one "
                    f"per-frame type")
        if first.format != TensorFormat.STATIC:
            self.fail_negotiation(
                f"input format is {first.format.name}; micro-batching needs "
                f"STATIC per-frame shapes (a batch axis over self-describing "
                f"flexible frames would be ragged)")
        max_batch = int(self.props["max_batch"])
        if max_batch < 1:
            self.fail_negotiation(f"max-batch must be >= 1, got {max_batch}")
        if float(self.props["max_latency_ms"]) < 0:
            self.fail_negotiation(
                f"max-latency-ms must be >= 0, got "
                f"{self.props['max_latency_ms']}")
        self._keepdims = [len(t.shape) >= 1 and t.shape[0] == 1
                          for t in first.tensors]
        return [replace(first, dyn_batch=max_batch)]

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        stream_id = buf.meta.get("stream_id", pad)
        seq = self._seq.get(stream_id, 0)
        self._seq[stream_id] = seq + 1
        self.frames_in += 1
        if not self._pending:
            self._deadline = (time.perf_counter()
                              + float(self.props["max_latency_ms"]) * 1e-3)
        self._pending.append({
            "tensors": buf.tensors, "pts": buf.pts,
            "duration": buf.duration, "meta": buf.meta,
            "stream_id": stream_id, "seq": seq})
        if len(self._pending) >= int(self.props["max_batch"]):
            return self._flush("full")
        return []

    def next_deadline(self) -> Optional[float]:
        return self._deadline if self._pending else None

    def on_timer(self) -> List[Emission]:
        return self._flush("deadline") if self._pending else []

    def flush(self) -> List[Emission]:
        return self._flush("eos") if self._pending else []

    def _flush(self, reason: str) -> List[Emission]:
        frames, self._pending = self._pending, []
        self._deadline = None
        n = len(frames)
        self.batches_out += 1
        self.occupancy_hist[n] = self.occupancy_hist.get(n, 0) + 1
        setattr(self, "flush_" + reason,
                getattr(self, "flush_" + reason) + 1)
        if self._tracer.active:
            self._tracer.instant(self.name, "flush_" + reason, n=n)
        batched = tuple(
            coalesce([f["tensors"][j] for f in frames], keep)
            for j, keep in enumerate(self._keepdims))
        out = TensorBuffer(
            tensors=batched, pts=frames[0]["pts"],
            duration=frames[0]["duration"],
            meta={"dyn_batch": {
                "n": n, "reason": reason,
                "frames": [{"pts": f["pts"], "duration": f["duration"],
                            "meta": f["meta"], "stream_id": f["stream_id"],
                            "seq": f["seq"]} for f in frames]}})
        return [(0, out)]

    def extra_stats(self) -> dict:
        occ = self.occupancy_hist
        total = sum(n * c for n, c in occ.items())
        return {
            "frames_in": self.frames_in,
            "batches_out": self.batches_out,
            "flush_full": self.flush_full,
            "flush_deadline": self.flush_deadline,
            "flush_eos": self.flush_eos,
            "occupancy_hist": dict(sorted(occ.items())),
            "occupancy_avg": (total / self.batches_out
                              if self.batches_out else 0.0),
        }


@register_element("tensor_unbatch")
class TensorUnbatch(Element):
    """Split micro-batched buffers back into per-frame buffers.

    Restores each frame's pts/duration/meta from the batch's `dyn_batch`
    meta and emits in arrival order. With one src pad every frame goes
    to pad 0; with several, each frame goes to the pad its stream_id
    names (an integer pad index), undoing an N-stream fan-in through
    tensor_batch.
    """

    ELEMENT_NAME = "tensor_unbatch"
    NUM_SINK_PADS = 1
    NUM_SRC_PADS = DYNAMIC
    # one buffer in, N out: a chain expects one out per one in
    CHAIN_FUSABLE = False
    ACCEPTS_DYN_BATCH = True
    PROPS = {}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._ranks: List[int] = []

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        if not spec.dyn_batch:
            self.fail_negotiation(
                f"input stream {spec} is not micro-batched; tensor_unbatch "
                f"only follows a tensor_batch (directly or across "
                f"batch-aware elements such as tensor_filter)")
        n_out = len(self._pipeline.links_from(self)) if self._pipeline else 1
        self._ranks = [len(t.shape) for t in spec.tensors]
        return [replace(spec, dyn_batch=0)] * max(1, n_out)

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        db = buf.meta.get("dyn_batch")
        if db is None:
            raise ValueError(
                f"{self.name}: buffer has no dyn_batch meta (upstream "
                f"element dropped it?)")
        frames = db["frames"]
        n_pads = max(1, len(self.out_specs))
        out: List[Emission] = []
        for i in range(db["n"]):
            # rank == per-frame rank: frames were concatenated (leading
            # dim 1), a slice keeps it; rank + 1: stacked, index drops it
            tensors = tuple(t[i:i + 1] if t.ndim == self._ranks[j] else t[i]
                            for j, t in enumerate(buf.tensors))
            fr = frames[i]
            meta = dict(fr["meta"])
            meta.setdefault("stream_id", fr["stream_id"])
            meta["batch_seq"] = fr["seq"]
            dst = fr["stream_id"] if n_pads > 1 else 0
            if not isinstance(dst, int) or not 0 <= dst < n_pads:
                raise ValueError(
                    f"{self.name}: frame stream_id {fr['stream_id']!r} does "
                    f"not name one of {n_pads} src pads; with multiple "
                    f"output pads stream ids must be integer pad indices")
            out.append((dst, TensorBuffer(
                tensors=tensors, pts=fr["pts"], duration=fr["duration"],
                meta=meta)))
        return out

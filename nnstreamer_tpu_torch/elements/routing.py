"""Stream routing elements: mux, merge, demux, split, join, tee, queue
(the JAX package's elements/routing.py).

- tensor_mux   (gsttensor_mux.c)   — N tensor streams → 1 multi-tensor
- tensor_merge (gsttensor_merge.c) — N single-tensor streams → 1 tensor,
  concatenated along a chosen dim
- tensor_demux (gsttensor_demux.c) — 1 multi-tensor stream → N streams,
  with `tensorpick` subset/reorder ('+' groups several tensors per pad)
- tensor_split (gsttensor_split.c) — 1 tensor → N along a dim (tensorseg)
- join         (gst/join/gstjoin.c) — N-to-1 active-pad pass-through
- tee          (GStreamer core)    — 1-to-N duplication
- queue        (GStreamer core)    — a pass-through: every link already
  is a bounded queue

Multi-pad time synchronization implements the reference's four policies
(nnstreamer_plugin_api_impl.c:267, modes tensor_common.h:62-68,
Documentation/synchronization-policies-at-mux-merge.md):

- nosync  — FIFO pairing: emit whenever every pad has a queued buffer.
- slowest — base time = max of head PTS across pads; per pad, drop
  buffers older than base and take the nearest one.
- basepad — option `<pad>:<duration_ns>`: pad N's buffers set the base
  time; others contribute their newest buffer within the window.
- refresh — emit on every arrival, reusing the last-seen buffer of every
  other pad.

Mux, demux, split, join and tee pass tensor references (split gives
views): no copy, on whatever device the tensors are. No element of the
port writes a stream tensor in place, so every branch of a tee may hold
the same object, as every JAX branch holds the same immutable array.
A concatenation (merge, tensor_aggregator) runs where the tensors are:
numpy when every input is a host array, bit for bit the JAX package's
host path; torch on the device of the first tensor input otherwise, host
inputs moved there (`tensor.buffer.concatenate`). A device tensor is
never moved to the host.
"""

from __future__ import annotations

from collections import deque
from dataclasses import replace
from fractions import Fraction
from typing import Deque, List, Optional, Sequence

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import (
    DYNAMIC, Element, Emission, PropDef, StreamSpec)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer, concatenate
from nnstreamer_tpu_torch.tensor.info import (
    MAX_TENSORS_PER_FRAME, TensorInfo, TensorsSpec)

log = get_logger("elements.routing")

SYNC_MODES = ("nosync", "slowest", "basepad", "refresh")


class _SyncCollect:
    """Shared multi-pad collect/synchronize machinery (GstCollectPads +
    time-sync helpers analog)."""

    def __init__(self, element: Element, n_pads: int, mode: str, option: str):
        if mode not in SYNC_MODES:
            raise PipelineError(
                f"{element.name}: unknown sync_mode {mode!r}; valid: "
                f"{', '.join(SYNC_MODES)}"
            )
        self.e = element
        self.n = n_pads
        self.mode = mode
        self.queues: List[Deque[TensorBuffer]] = [deque() for _ in range(n_pads)]
        self.last: List[Optional[TensorBuffer]] = [None] * n_pads
        self.base_pad = 0
        self.window_ns = 0
        if mode == "basepad":
            parts = (option or "0").split(":")
            self.base_pad = int(parts[0])
            self.window_ns = int(parts[1]) if len(parts) > 1 else 0
            if self.base_pad >= n_pads:
                raise PipelineError(
                    f"{element.name}: basepad {self.base_pad} out of range "
                    f"for {n_pads} sink pads"
                )

    def offer(self, pad: int, buf: TensorBuffer) -> List[List[TensorBuffer]]:
        """Queue one arrival; return the list of synchronized groups
        (one buffer per pad) ready to emit."""
        self.queues[pad].append(buf)
        self.last[pad] = buf
        out = []
        while True:
            group = self._try_collect(pad)
            if group is None:
                break
            out.append(group)
            if self.mode == "refresh":
                break  # refresh emits at most once per arrival
        return out

    def _try_collect(self, arrived_pad: int) -> Optional[List[TensorBuffer]]:
        if self.mode == "refresh":
            if any(l is None for l in self.last):
                return None
            group = [q.popleft() if q else self.last[i]
                     for i, q in enumerate(self.queues)]
            return group
        if any(not q for q in self.queues):
            return None
        if self.mode == "nosync":
            return [q.popleft() for q in self.queues]
        if self.mode == "slowest":
            base = max(q[0].pts or 0 for q in self.queues)
            group = []
            for q in self.queues:
                # drop frames strictly older than base when a newer one is
                # also queued (catch-up), then take the head
                while len(q) > 1 and (q[1].pts or 0) <= base:
                    q.popleft()
                group.append(q.popleft())
            return group
        # basepad
        bq = self.queues[self.base_pad]
        while bq:
            base = bq[0].pts or 0
            group: List[Optional[TensorBuffer]] = [None] * self.n
            # queues whose matched head should be consumed — deferred to
            # group success, so an aborted (waiting) group loses nothing
            pops: List[Deque[TensorBuffer]] = []
            expired = waiting = False
            for i, q in enumerate(self.queues):
                if i == self.base_pad:
                    continue
                while (len(q) > 1
                       and self._dist(q[1], base) <= self._dist(q[0], base)):
                    q.popleft()
                if self.window_ns and self._dist(q[0], base) > self.window_ns:
                    # q[0] is the best queued candidate (catch-up loop
                    # above). PTS is monotonic per pad, so once the NEWEST
                    # queued frame is past base+window no future frame can
                    # match either — expire the base head (drop + log)
                    # instead of stalling the group forever (ref drops on
                    # window miss, nnstreamer_plugin_api_impl.c:267)
                    if (q[-1].pts or 0) > base + self.window_ns:
                        log.warning(
                            "%s: basepad head pts=%s expired (pad %d has no "
                            "frame within ±%dns); dropping",
                            self.e.name, base, i, self.window_ns)
                        bq.popleft()
                        expired = True
                    else:
                        # partner lags behind: a closer frame may still come
                        waiting = True
                    break
                group[i] = q[0]
                if len(q) > 1:
                    pops.append(q)   # consume on success; reuse if last
            if waiting:
                return None
            if expired:
                continue   # retry with the next base head
            for q in pops:
                q.popleft()
            group[self.base_pad] = bq.popleft()
            return [g for g in group]  # type: ignore
        return None

    @staticmethod
    def _dist(buf: TensorBuffer, base: int) -> int:
        return abs((buf.pts or 0) - base)

    def drain(self) -> List[List[TensorBuffer]]:
        """At EOS: flush complete FIFO groups (nosync only; timed modes
        drop stragglers like the reference's EOS pad handling)."""
        out = []
        if self.mode == "nosync":
            while all(q for q in self.queues):
                out.append([q.popleft() for q in self.queues])
        return out


def _common_rate(specs: Sequence[TensorsSpec]) -> Fraction:
    rates = [s.rate for s in specs if s.rate]
    return max(rates) if rates else Fraction(0, 1)


@register_element("tensor_mux")
class TensorMux(Element):
    """N tensor streams → one multi-tensor stream (num_tensors = Σ)."""

    ELEMENT_NAME = "tensor_mux"
    NUM_SINK_PADS = DYNAMIC
    NUM_SRC_PADS = 1
    # dynamic fan-in: chain fusion is single-in/single-out only
    CHAIN_FUSABLE = False
    PROPS = {
        "sync_mode": PropDef(str, "slowest", "|".join(SYNC_MODES)),
        "sync_option": PropDef(str, "", "basepad option '<pad>:<window_ns>'"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._collect: Optional[_SyncCollect] = None

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        specs = [self.expect_tensors(s, i) for i, s in enumerate(in_specs)]
        total = sum(s.num_tensors for s in specs)
        if total > MAX_TENSORS_PER_FRAME:
            self.fail_negotiation(
                f"muxing {total} tensors exceeds the {MAX_TENSORS_PER_FRAME}"
                f"-tensor frame limit"
            )
        self._collect = _SyncCollect(self, len(specs),
                                     self.props["sync_mode"],
                                     self.props["sync_option"])
        infos = tuple(t for s in specs for t in s.tensors)
        return [TensorsSpec(tensors=infos, rate=_common_rate(specs))]

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        out = []
        for group in self._collect.offer(pad, buf):
            tensors = tuple(t for b in group for t in b.tensors)
            pts = group[self._collect.base_pad].pts \
                if self._collect.mode == "basepad" \
                else max((b.pts or 0) for b in group)
            out.append((0, TensorBuffer(tensors=tensors, pts=pts)))
        return out

    def flush(self) -> List[Emission]:
        return [
            (0, TensorBuffer(
                tensors=tuple(t for b in g for t in b.tensors),
                pts=max((b.pts or 0) for b in g)))
            for g in self._collect.drain()
        ]


@register_element("tensor_merge")
class TensorMerge(Element):
    """N single-tensor streams → 1 tensor, concatenated along a dim.

    mode=linear option=<dim> — dim indexes the ROW-MAJOR shape. The
    reference's channel/width/height/batch keywords map onto row-major
    axes of NHWC at negotiation (gsttensor_merge.c linear modes).
    """

    ELEMENT_NAME = "tensor_merge"
    NUM_SINK_PADS = DYNAMIC
    NUM_SRC_PADS = 1
    # dynamic fan-in: chain fusion is single-in/single-out only
    CHAIN_FUSABLE = False
    _KEYWORDS = {"batch": 0, "height": 1, "width": 2, "channel": 3}
    PROPS = {
        "mode": PropDef(str, "linear"),
        "option": PropDef(str, "channel", "concat axis: int or NHWC keyword"),
        "sync_mode": PropDef(str, "slowest", "|".join(SYNC_MODES)),
        "sync_option": PropDef(str, ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._collect: Optional[_SyncCollect] = None
        self._axis = 0

    def _resolve_axis(self, ndim: int) -> int:
        opt = self.props["option"].strip()
        if opt in self._KEYWORDS:
            if ndim != 4:
                self.fail_negotiation(
                    f"axis keyword {opt!r} assumes NHWC rank-4 tensors but "
                    f"input rank is {ndim}; use a numeric axis")
            return self._KEYWORDS[opt]
        try:
            ax = int(opt)
        except ValueError:
            self.fail_negotiation(
                f"bad merge option {opt!r}: expected an axis number or one "
                f"of {sorted(self._KEYWORDS)}")
        return ax % ndim

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        specs = [self.expect_tensors(s, i) for i, s in enumerate(in_specs)]
        if self.props["mode"] != "linear":
            self.fail_negotiation(
                f"unsupported merge mode {self.props['mode']!r} (only "
                f"'linear' exists — the reference's other modes were never "
                f"implemented either, gsttensor_merge.c)")
        for i, s in enumerate(specs):
            if s.num_tensors != 1:
                self.fail_negotiation(
                    f"sink pad {i} carries {s.num_tensors} tensors; "
                    f"tensor_merge needs single-tensor streams (use "
                    f"tensor_mux for multi-tensor framing)")
        first = specs[0].tensors[0]
        ax = self._resolve_axis(len(first.shape))
        self._axis = ax
        out_dim = 0
        for i, s in enumerate(specs):
            t = s.tensors[0]
            if t.dtype != first.dtype:
                self.fail_negotiation(
                    f"dtype mismatch on pad {i}: {t.dtype.type_name} vs "
                    f"{first.dtype.type_name}")
            if len(t.shape) != len(first.shape) or any(
                    a != b for d, (a, b) in enumerate(zip(t.shape, first.shape))
                    if d != ax):
                self.fail_negotiation(
                    f"shape mismatch on pad {i}: {t.shape} vs {first.shape} "
                    f"(must agree on all axes except concat axis {ax})")
            out_dim += t.shape[ax]
        shape = tuple(out_dim if d == ax else v
                      for d, v in enumerate(first.shape))
        self._collect = _SyncCollect(self, len(specs),
                                     self.props["sync_mode"],
                                     self.props["sync_option"])
        return [TensorsSpec.of(TensorInfo(shape, first.dtype),
                               rate=_common_rate(specs))]

    def _merged(self, group: List[TensorBuffer]) -> Emission:
        return (0, TensorBuffer(
            tensors=(concatenate([b.tensors[0] for b in group], self._axis),),
            pts=max((b.pts or 0) for b in group)))

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        return [self._merged(g) for g in self._collect.offer(pad, buf)]

    def flush(self) -> List[Emission]:
        return [self._merged(g) for g in self._collect.drain()]


@register_element("tensor_demux")
class TensorDemux(Element):
    """1 multi-tensor stream → N streams. `tensorpick` picks/reorders;
    entries may group several tensors per pad with '+': "0,1+2"."""

    ELEMENT_NAME = "tensor_demux"
    NUM_SINK_PADS = 1
    NUM_SRC_PADS = DYNAMIC
    # dynamic fan-out: chain fusion is single-in/single-out only
    CHAIN_FUSABLE = False
    PROPS = {
        "tensorpick": PropDef(str, "", "e.g. '0,2' or '0,1+2'; empty = all"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._picks: List[List[int]] = []

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        n_out = len(self._pipeline.links_from(self)) if self._pipeline else 0
        pick = self.props["tensorpick"]
        if pick:
            self._picks = [[int(x) for x in part.split("+")]
                           for part in pick.split(",")]
        else:
            self._picks = [[i] for i in range(spec.num_tensors)]
        if n_out and len(self._picks) != n_out:
            self.fail_negotiation(
                f"{len(self._picks)} tensorpick group(s) but {n_out} src "
                f"pad(s) linked"
            )
        for grp in self._picks:
            for i in grp:
                if i >= spec.num_tensors:
                    self.fail_negotiation(
                        f"tensorpick index {i} out of range; input has "
                        f"{spec.num_tensors} tensors"
                    )
        return [
            replace(spec, tensors=tuple(spec.tensors[i] for i in grp))
            for grp in self._picks
        ]

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        return [
            (p, buf.subset(grp)) for p, grp in enumerate(self._picks)
        ]


@register_element("tensor_split")
class TensorSplit(Element):
    """1 tensor → N tensors along an axis by `tensorseg` sizes.

    tensorseg="2:4:2" splits axis (default: last) into sizes 2,4,2 —
    the per-dimension unshard primitive (gsttensor_split.c). Each
    segment is a view of the input (a strided one unless the axis is the
    outermost): the filter stages a strided host array by copy, and the
    CUDA kernels' wrappers make their input contiguous.
    """

    ELEMENT_NAME = "tensor_split"
    NUM_SINK_PADS = 1
    NUM_SRC_PADS = DYNAMIC
    # dynamic fan-out: chain fusion is single-in/single-out only
    CHAIN_FUSABLE = False
    PROPS = {
        "tensorseg": PropDef(str, None, "colon-separated segment sizes"),
        "axis": PropDef(int, -1, "row-major split axis (default last)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._sizes: List[int] = []
        self._axis = -1

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        if spec.num_tensors != 1:
            self.fail_negotiation(
                f"tensor_split needs a single-tensor stream, got "
                f"{spec.num_tensors} tensors (tensor_demux separates them)")
        if not self.props["tensorseg"]:
            self.fail_negotiation("tensorseg=<s1:s2:…> is required")
        t = spec.tensors[0]
        self._axis = self.props["axis"] % len(t.shape)
        try:
            self._sizes = [int(x) for x in self.props["tensorseg"].split(":")]
        except ValueError:
            self.fail_negotiation(
                f"bad tensorseg {self.props['tensorseg']!r}: expected "
                f"colon-separated ints")
        if sum(self._sizes) != t.shape[self._axis]:
            self.fail_negotiation(
                f"tensorseg {self._sizes} sums to {sum(self._sizes)} but "
                f"axis {self._axis} has size {t.shape[self._axis]}")
        outs = [TensorsSpec.of(TensorInfo(
            tuple(s if d == self._axis else v for d, v in enumerate(t.shape)),
            t.dtype), rate=spec.rate) for s in self._sizes]
        n_out = len(self._pipeline.links_from(self)) if self._pipeline else 0
        if n_out and n_out != len(outs):
            self.fail_negotiation(
                f"{len(outs)} segments but {n_out} src pads linked")
        return outs

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        t = buf.tensors[0]
        out = []
        off = 0
        for p, s in enumerate(self._sizes):
            sl = [slice(None)] * t.ndim
            sl[self._axis] = slice(off, off + s)
            out.append((p, buf.with_tensors((t[tuple(sl)],))))
            off += s
        return out


@register_element("join")
class Join(Element):
    """N-to-1 active-pad pass-through without synchronization — whatever
    arrives on any pad goes out (gst/join/gstjoin.c). Used to rejoin
    branches after demux/tensor_if routing. The buffers keep their
    placement: a host fill from one branch and device tensors from
    another leave as they came."""

    ELEMENT_NAME = "join"
    NUM_SINK_PADS = DYNAMIC
    NUM_SRC_PADS = 1
    # dynamic fan-in: chain fusion is single-in/single-out only
    CHAIN_FUSABLE = False
    PROPS = {}

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        specs = [self.expect_tensors(s, i) for i, s in enumerate(in_specs)]
        first = specs[0]
        for i, s in enumerate(specs[1:], 1):
            if not first.is_compatible(s):
                self.fail_negotiation(
                    f"pad {i} spec {s} incompatible with pad 0 spec {first}; "
                    f"join requires identical stream types on every pad")
        return [first]

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        return [(0, buf)]


@register_element("tee")
class Tee(Element):
    """1-to-N duplication. Zero-copy: every branch receives the same
    buffer and tensor objects, safe because no element writes a stream
    tensor in place (a transform or filter on one branch makes new
    tensors; the other branches' data stays unchanged)."""

    ELEMENT_NAME = "tee"
    NUM_SINK_PADS = 1
    NUM_SRC_PADS = DYNAMIC
    # dynamic fan-out: chain fusion is single-in/single-out only
    CHAIN_FUSABLE = False
    PROPS = {}

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        n = len(self._pipeline.links_from(self)) if self._pipeline else 1
        return [in_specs[0]] * max(1, n)

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        return [(p, buf) for p in range(len(self.out_specs))]


@register_element("queue")
class Queue(Element):
    """DSL-parity no-op: every link in this runtime already is a bounded
    queue (runtime/scheduler.py), so `queue` just passes through."""

    ELEMENT_NAME = "queue"
    PROPS = {
        "max_size_buffers": PropDef(int, 0, "accepted, ignored"),
        "leaky": PropDef(str, "", "accepted, ignored"),
    }

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        return [in_specs[0]]

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        return [(0, buf)]

"""Stream routing elements: tensor_mux and tensor_demux (the JAX
package's elements/routing.py; merge, split, join, tee and queue wait for
a later slice).

- tensor_mux   (gsttensor_mux.c)   — N tensor streams → 1 multi-tensor
- tensor_demux (gsttensor_demux.c) — 1 multi-tensor stream → N streams,
  with `tensorpick` subset/reorder ('+' groups several tensors per pad)

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

Both pass tensor references: no copy, on whatever device they are.
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
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import MAX_TENSORS_PER_FRAME, TensorsSpec

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


@register_element("tensor_demux")
class TensorDemux(Element):
    """1 multi-tensor stream → N streams. `tensorpick` picks/reorders;
    entries may group several tensors per pad with '+': "0,1+2"."""

    ELEMENT_NAME = "tensor_demux"
    NUM_SINK_PADS = 1
    NUM_SRC_PADS = DYNAMIC
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

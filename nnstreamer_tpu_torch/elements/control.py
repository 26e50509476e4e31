"""Data-driven control-flow elements: tensor_if, tensor_rate, tensor_crop.

- tensor_if  (gsttensor_if.c) — stream branching on tensor values:
  compared-value modes (gsttensor_if.h:42-55), 10 operators (:60-71),
  then/else actions (:79-91) incl. passthrough/skip/fill-zero/tensorpick,
  plus registered custom python predicates (TIFCV_CUSTOM analog).
- tensor_rate (gsttensor_rate.c) — framerate conform by drop/dup with
  `throttle` QoS.
- tensor_crop (gsttensor_crop.c) — crops regions out of a raw tensor
  stream by a second stream of crop geometry. Its output is FLEXIBLE:
  the region sizes vary from buffer to buffer, so a filter after it
  needs `invoke-dynamic=true` (or a tensor_resize between).

tensor_if on a CUDA tensor reduces on the card and reads back only the
one scalar it compares, through runtime/sync: a forced sync, counted and
traced under the element's name. The payload keeps flowing by reference.
Its fill actions build their tensors where the input is: numpy on the
host (the JAX element's np.zeros / np.full / np.frombuffer), a tensor on
the input's device otherwise (the JAX element builds them on the host
whatever the input; ROADMAP N14).
"""

from __future__ import annotations

import operator
from fractions import Fraction
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import (
    DYNAMIC, Element, Emission, PropDef, StreamSpec, prop_bool)
from nnstreamer_tpu_torch.runtime.sync import to_host
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType, host_tensor
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec

# -- tensor_if ---------------------------------------------------------------

#: registered custom predicates (include/tensor_if.h analog)
_custom_conds: Dict[str, Callable[[TensorBuffer], bool]] = {}


def register_if_condition(name: str, fn: Callable[[TensorBuffer], bool]) -> None:
    """Custom-condition registration (TIFCV_CUSTOM analog): fn(buffer)->bool."""
    _custom_conds[name] = fn


_OPS = {
    "eq": operator.eq, "ne": operator.ne,
    "gt": operator.gt, "ge": operator.ge,
    "lt": operator.lt, "le": operator.le,
}
#: two-operand range operators (gsttensor_if.h:67-70); supplied_value is
#: "lo:hi" for these
_RANGE_OPS = {
    "range_inclusive": lambda v, lo, hi: lo <= v <= hi,
    "range_exclusive": lambda v, lo, hi: lo < v < hi,
    "not_in_range_inclusive": lambda v, lo, hi: not (lo <= v <= hi),
    "not_in_range_exclusive": lambda v, lo, hi: not (lo < v < hi),
}

CV_MODES = ("a_value", "average", "custom")
ACTIONS = ("passthrough", "skip", "fill_zero", "fill_values",
           "fill_with_file", "repeat_previous", "tensorpick")


@register_element("tensor_if")
class TensorIf(Element):
    """2 src pads: 0 = then-branch, 1 = else-branch (optional).

    compared_value: a_value (option "<tensor>:<flat_index>"), average
    (option "<tensor>"), or custom (option = registered predicate name).
    operator: eq|ne|gt|ge|lt|le against supplied_value (single float), or
    range_inclusive|range_exclusive|not_in_range_inclusive|
    not_in_range_exclusive against supplied_value "lo:hi"
    (gsttensor_if.h:60-71, all 10 operators).
    then/else: passthrough | skip | fill_zero | fill_values (option =
    per-tensor values, comma-separated, single value broadcasts) |
    fill_with_file (option = raw payload file) | repeat_previous |
    tensorpick (option = comma indices). (gsttensor_if.h:79-91.)

    ``average`` follows the JAX element path by path: a host array's own
    ``mean()`` (numpy: float64 for integers), a tensor's mean in float32
    (integers widened first, as jnp promotes them), or in its own float
    dtype.
    """

    ELEMENT_NAME = "tensor_if"
    NUM_SRC_PADS = DYNAMIC
    # branching fan-out: chain fusion is single-in/single-out only
    CHAIN_FUSABLE = False
    PROPS = {
        "compared_value": PropDef(str, "a_value", "|".join(CV_MODES)),
        "compared_value_option": PropDef(str, "0:0"),
        "operator": PropDef(str, "gt",
                            "|".join(list(_OPS) + list(_RANGE_OPS))),
        "supplied_value": PropDef(lambda s: s, 0.0,
                                  "float, or 'lo:hi' for range operators"),
        "then": PropDef(str, "passthrough", "|".join(ACTIONS)),
        "then_option": PropDef(str, ""),
        "else_": PropDef(str, "skip", "|".join(ACTIONS)),
        "else_option": PropDef(str, ""),
    }

    def __init__(self, name=None, **props):
        props = {("else_" if k in ("else", "else-") else k): v
                 for k, v in props.items()}
        super().__init__(name, **props)
        op = self.props["operator"]
        if op not in _OPS and op not in _RANGE_OPS:
            raise PipelineError(
                f"tensor_if {self.name}: unknown operator {op!r}; valid: "
                f"{sorted(_OPS) + sorted(_RANGE_OPS)}")
        if self.props["compared_value"] not in CV_MODES:
            raise PipelineError(
                f"tensor_if {self.name}: unknown compared_value "
                f"{self.props['compared_value']!r}; valid: {CV_MODES}")
        self._sv = self._parse_supplied(self.props["supplied_value"], op)
        for which in ("then", "else_"):
            if self.props[which] not in ACTIONS:
                raise PipelineError(
                    f"tensor_if {self.name}: unknown {which.rstrip('_')} "
                    f"action {self.props[which]!r}; valid: {ACTIONS}")
        # per-branch action material, keyed by src pad (then=0, else=1):
        # both branches may use fill_with_file/fill_values with different
        # options, so nothing here may be shared state
        self._fill_bytes: Dict[int, bytes] = {}
        self._fill_vals: Dict[int, List[float]] = {}
        for pad_i, which in enumerate(("then", "else_")):
            option = self.props[f"{which.rstrip('_')}_option"]
            if self.props[which] == "fill_with_file":
                try:
                    with open(option, "rb") as f:
                        self._fill_bytes[pad_i] = f.read()
                except OSError as e:
                    raise PipelineError(
                        f"tensor_if {self.name}: fill_with_file cannot "
                        f"read {option!r}: {e}") from None
            elif self.props[which] == "fill_values":
                try:
                    vals = [float(v) for v in str(option).split(",")
                            if v.strip()]
                except ValueError:
                    raise PipelineError(
                        f"tensor_if {self.name}: fill_values option "
                        f"{option!r} is not a comma-separated value list"
                    ) from None
                if not vals:
                    raise PipelineError(
                        f"tensor_if {self.name}: fill_values needs option="
                        f"<v>[,<v>…] (one per tensor, or one broadcast)")
                self._fill_vals[pad_i] = vals
        self._last_fwd: Optional[TensorBuffer] = None

    def _parse_supplied(self, sv, op: str):
        parts = str(sv).split(":")
        try:
            vals = tuple(float(p) for p in parts if p != "")
        except ValueError:
            raise PipelineError(
                f"tensor_if {self.name}: bad supplied_value {sv!r}") from None
        need = 2 if op in _RANGE_OPS else 1
        if len(vals) != need:
            raise PipelineError(
                f"tensor_if {self.name}: operator {op!r} needs "
                f"{need} supplied value(s), got {len(vals)} from {sv!r}"
                + (" (use supplied_value=lo:hi)" if need == 2 else ""))
        if need == 2 and vals[0] > vals[1]:
            raise PipelineError(
                f"tensor_if {self.name}: range lo {vals[0]} > hi {vals[1]}")
        return vals

    def _out_spec_for(self, action: str, option: str,
                      spec: TensorsSpec) -> TensorsSpec:
        if action == "tensorpick":
            idxs = [int(x) for x in option.split(",") if x.strip()]
            for i in idxs:
                if i >= spec.num_tensors:
                    self.fail_negotiation(
                        f"tensorpick index {i} out of range "
                        f"({spec.num_tensors} tensors)")
            return TensorsSpec(
                tensors=tuple(spec.tensors[i] for i in idxs),
                rate=spec.rate)
        return spec

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        n_out = len(self._pipeline.links_from(self)) if self._pipeline else 1
        if n_out not in (1, 2):
            self.fail_negotiation(
                f"tensor_if has then/else src pads; {n_out} links found")
        outs = [self._out_spec_for(self.props["then"],
                                   self.props["then_option"], spec)]
        if n_out == 2:
            outs.append(self._out_spec_for(self.props["else_"],
                                           self.props["else_option"], spec))
        # repeat_previous replays the last forwarded buffer, which may
        # come from the other branch: that is only spec-safe if the other
        # branch is shape-preserving (tensorpick would replay a subset
        # onto a pad negotiated for the full tensor set)
        acts = (self.props["then"], self.props["else_"])
        if "repeat_previous" in acts and "tensorpick" in acts:
            self.fail_negotiation(
                "repeat_previous cannot pair with tensorpick on the other "
                "branch: the repeated buffer would not match this pad's "
                "negotiated tensor set")
        return outs

    # -- condition evaluation (tensor_data.c scalar math analog) -----------
    def _scalar(self, t) -> float:
        """A one-element tensor's value on the host: through
        runtime/sync (one forced sync, counted and traced under this
        element) when it is a CUDA tensor."""
        (v,) = to_host((t,), self._tracer, self.name)
        return float(np.asarray(v).reshape(-1)[0])

    def _decide(self, buf: TensorBuffer) -> bool:
        mode = self.props["compared_value"]
        opt = self.props["compared_value_option"]
        if mode == "custom":
            fn = _custom_conds.get(opt)
            if fn is None:
                raise PipelineError(
                    f"tensor_if {self.name}: no custom condition {opt!r} "
                    f"registered; call register_if_condition() first")
            return bool(fn(buf))
        if mode == "a_value":
            ti, _, idx = opt.partition(":")
            t = buf.tensors[int(ti or 0)]
            flat_idx = int(idx or 0)
            if isinstance(t, torch.Tensor):
                # index on t's device: only the one element comes back
                val = self._scalar(t.reshape(-1)[flat_idx].reshape(1))
            else:
                val = float(t.reshape(-1)[flat_idx])
        else:  # average
            t = buf.tensors[int(opt or 0)]
            if isinstance(t, torch.Tensor):
                if not t.dtype.is_floating_point:
                    t = t.to(torch.float32)
                val = self._scalar(t.mean().reshape(1))
            else:
                val = float(np.asarray(t.mean()))
        op = self.props["operator"]
        if op in _RANGE_OPS:
            return _RANGE_OPS[op](val, self._sv[0], self._sv[1])
        return _OPS[op](val, self._sv[0])

    def _apply(self, action: str, option: str, pad: int,
               buf: TensorBuffer) -> List[Emission]:
        if action == "passthrough":
            return [(pad, buf)]
        if action == "skip":
            return []
        if action == "fill_zero":
            # built from shape/dtype: the payload is never read
            zeros = tuple(
                torch.zeros(t.shape, dtype=t.dtype, device=t.device)
                if isinstance(t, torch.Tensor) else np.zeros(t.shape, t.dtype)
                for t in buf.tensors)
            return [(pad, buf.with_tensors(zeros))]
        if action == "fill_values":
            vals = self._fill_vals[pad]   # parsed/validated in __init__
            if len(vals) == 1:
                vals = vals * buf.num_tensors
            if len(vals) != buf.num_tensors:
                raise PipelineError(
                    f"tensor_if {self.name}: fill_values got {len(vals)} "
                    f"values for {buf.num_tensors} tensors")
            filled = tuple(_full_like(t, v) for t, v in zip(buf.tensors, vals))
            return [(pad, buf.with_tensors(filled))]
        if action == "fill_with_file":
            tensors = []
            off = 0
            data = self._fill_bytes.get(pad, b"")
            for i, t in enumerate(buf.tensors):
                dt = DType.of(t).np_dtype
                count = int(np.prod(t.shape))
                n = count * dt.itemsize
                if off + n > len(data):
                    raise PipelineError(
                        f"tensor_if {self.name}: fill file has "
                        f"{len(data)} bytes but tensor {i} needs bytes "
                        f"[{off}, {off + n})")
                a = np.frombuffer(data, dt, count=count,
                                  offset=off).reshape(tuple(t.shape))
                if isinstance(t, torch.Tensor):
                    a = host_tensor(a.copy()).to(t.device)
                tensors.append(a)
                off += n
            return [(pad, buf.with_tensors(tuple(tensors)))]
        if action == "repeat_previous":
            # re-emit the element's last forwarded frame (either branch)
            # with the current frame's timestamp: then=passthrough /
            # else=repeat_previous gives downstream the last good frame
            # when the condition fails. Declared-but-unimplemented in the
            # reference chain (gsttensor_if.c:1171 default case), so the
            # useful semantics are defined here. Skip when no history.
            prev = self._last_fwd
            if prev is None:
                return []   # nothing to repeat yet
            return [(pad, prev.with_tensors(prev.tensors, pts=buf.pts))]
        if action == "tensorpick":
            idxs = [int(x) for x in option.split(",") if x.strip()]
            return [(pad, buf.subset(idxs))]
        raise PipelineError(
            f"tensor_if {self.name}: unknown action {action!r}; valid: "
            f"{ACTIONS}")

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        cond = self._decide(buf)
        has_else = len(self.out_specs) == 2
        if cond:
            out = self._apply(self.props["then"],
                              self.props["then_option"], 0, buf)
        elif has_else:
            out = self._apply(self.props["else_"],
                              self.props["else_option"], 1, buf)
        else:
            out = []
        for _, b in out:
            self._last_fwd = b   # repeat_previous source material
        return out


def _full_like(t, v: float):
    """np.full(t.shape, v, t.dtype), or its torch counterpart on t's
    device (the value converted as numpy converts it, on the host)."""
    host = np.full(tuple(t.shape), v, DType.of(t).np_dtype)
    if not isinstance(t, torch.Tensor):
        return host
    return host_tensor(host).to(t.device)


# -- tensor_rate -------------------------------------------------------------

@register_element("tensor_rate")
class TensorRate(Element):
    """Conform stream to `framerate` by dropping/duplicating frames.

    PTS-based like the reference (gsttensor_rate.c): each output slot i
    has target time i/rate; incoming frames fill slots up to their PTS
    (dup when source is slower, drop when faster). `throttle=true` posts
    an upstream QoS event with the target inter-frame interval
    (gsttensor_rate.c:22-34) so sources can *skip generating* frames
    that would be dropped here (skip-before-compute); bounded queues
    still provide generic backpressure either way. The event walks every
    upstream path: behind a tee it paces the source for every branch.
    """

    ELEMENT_NAME = "tensor_rate"
    PROPS = {
        "framerate": PropDef(str, None, "target rate 'N/D'"),
        "throttle": PropDef(prop_bool, True),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if not self.props["framerate"]:
            raise PipelineError(
                f"tensor_rate {self.name}: framerate=N/D is required")
        self._rate = Fraction(self.props["framerate"].replace(":", "/"))
        if self._rate <= 0:
            raise PipelineError(
                f"tensor_rate {self.name}: framerate must be positive")
        self._next_slot = 0
        self._prev: Optional[TensorBuffer] = None
        self.dropped = 0
        self.duplicated = 0
        self._qos_posted = False

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        return [spec.with_rate(self._rate)]

    def _slot_pts(self, slot: int) -> int:
        return int(slot * 1_000_000_000 / self._rate)

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        if buf.pts is None:
            return [(0, buf)]  # untimed stream: pass through
        out: List[Emission] = []
        # emit pending slots whose target time has passed, using the
        # previous frame (duplication when upstream is slow)
        while self._prev is not None and \
                self._slot_pts(self._next_slot) < buf.pts:
            out.append((0, self._prev.with_tensors(
                self._prev.tensors, pts=self._slot_pts(self._next_slot))))
            if len(out) > 1:
                self.duplicated += 1
            self._next_slot += 1
        if self._slot_pts(self._next_slot) >= buf.pts or self._prev is None:
            # frame lands in (or before) the next slot — it becomes the
            # candidate; a faster-than-rate source overwrites (drop)
            if self._prev is not None and \
                    buf.pts < self._slot_pts(self._next_slot):
                self.dropped += 1
                if self.props["throttle"] and not self._qos_posted:
                    # upstream QoS: ask sources to pace at the target rate
                    self._qos_posted = True
                    self.post_upstream_event({
                        "type": "qos",
                        "min_interval_ns": int(1_000_000_000 / self._rate),
                    })
            self._prev = buf
        return out

    def flush(self) -> List[Emission]:
        if self._prev is not None:
            return [(0, self._prev.with_tensors(
                self._prev.tensors, pts=self._slot_pts(self._next_slot)))]
        return []


# -- tensor_crop -------------------------------------------------------------


@register_element("tensor_crop")
class TensorCrop(Element):
    """Sink pad 0: raw tensors; sink pad 1: crop info, per frame a tensor
    of shape (num_regions, 4) holding [x, y, w, h] (gsttensor_crop.c:18-33).
    A raw and an info buffer pair up when their pts lie within
    `lateness` ns of each other (:87); the older of two that do not is
    dropped. Regions are views of the raw tensor, so a CUDA frame is
    cropped on the card."""

    ELEMENT_NAME = "tensor_crop"
    NUM_SINK_PADS = 2
    # two-pad fan-in: chain fusion is single-in/single-out only
    CHAIN_FUSABLE = False
    PROPS = {
        "lateness": PropDef(int, 33_000_000, "max |pts_raw - pts_info| ns"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._raw: List[TensorBuffer] = []
        self._info: List[TensorBuffer] = []

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        raw = self.expect_tensors(in_specs[0], 0)
        self.expect_tensors(in_specs[1], 1)
        if raw.num_tensors != 1:
            self.fail_negotiation(
                f"tensor_crop takes a single-tensor raw stream, got "
                f"{raw.num_tensors} tensors (demux first)")
        t = raw.tensors[0]
        if len(t.shape) < 2:
            self.fail_negotiation(
                f"crop input must be at least rank-2 (spatial); got {t}")
        return [TensorsSpec(tensors=raw.tensors, format=TensorFormat.FLEXIBLE,
                            rate=raw.rate)]

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        (self._raw if pad == 0 else self._info).append(buf)
        out: List[Emission] = []
        lateness = self.props["lateness"]
        while self._raw and self._info:
            raw, info = self._raw[0], self._info[0]
            if abs((raw.pts or 0) - (info.pts or 0)) > lateness:
                # drop the older of the two and retry
                if (raw.pts or 0) < (info.pts or 0):
                    self._raw.pop(0)
                else:
                    self._info.pop(0)
                continue
            self._raw.pop(0)
            self._info.pop(0)
            out.append((0, self._crop(raw, info)))
        return out

    def _crop(self, raw: TensorBuffer, info: TensorBuffer) -> TensorBuffer:
        t = raw.tensors[0]
        geom = info.tensors[0]
        if isinstance(geom, torch.Tensor):
            (geom,) = to_host((geom,), self._tracer, self.name)
        regions = np.asarray(geom).reshape(-1, 4).astype(np.int64)
        # spatial dims: (..., H, W, C) at rank >= 3, else (H, W)
        h_ax = t.ndim - 3 if t.ndim >= 3 else 0
        w_ax = h_ax + 1
        H, W = t.shape[h_ax], t.shape[w_ax]
        crops = []
        for x, y, w, h in regions:
            x0, y0 = max(0, int(x)), max(0, int(y))
            x1, y1 = min(W, x0 + int(w)), min(H, y0 + int(h))
            sl = [slice(None)] * t.ndim
            sl[h_ax] = slice(y0, y1)
            sl[w_ax] = slice(x0, x1)
            crops.append(t[tuple(sl)])
        return TensorBuffer(tensors=tuple(crops), pts=raw.pts,
                            format=TensorFormat.FLEXIBLE)

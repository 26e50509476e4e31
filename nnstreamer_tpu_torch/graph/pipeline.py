"""Pipeline graph model and build-time negotiation.

Elements, pads, links, and a single-pass static negotiation that assigns
every link a `TensorsSpec`/`MediaSpec` before any data flows (the
caps-negotiation analog, run once).

Element model (push-based):

- `SourceElement.generate()` yields buffers (driven by the scheduler).
- `Element.process(pad, buf)` → list of (src_pad, buffer) to emit.
- `Element.negotiate(in_specs)` → out_specs, raising NegotiationError
  with actionable messages.
- `Element.start()` after negotiation; `next_deadline()`/`on_timer()`
  for elements that must wake up without input (timer elements).
- Every element takes `error-policy` (fail | skip | retry:N[:backoff_ms]
  | degrade; core/errors.ErrorPolicy), enforced by the scheduler. Under
  degrade the element gets one more src pad, the fallback pad, which
  carries its pad-0 input stream and must be linked.
- Upstream events (`post_upstream_event`) walk the link graph toward
  the sources (videotestsrc's QoS skip consumes `{"type": "qos"}`).

Properties are constructor kwargs; string values arrive from the DSL and
are coerced by each element's `PROPS` declaration.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

from nnstreamer_tpu_torch.core.errors import (
    FAIL_FAST, ErrorPolicy, NegotiationError, PipelineError)
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.graph.media import MediaSpec
from nnstreamer_tpu_torch.runtime.tracing import NULL_TRACER
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

log = get_logger("graph")

StreamSpec = Union[TensorsSpec, MediaSpec]
Emission = Tuple[int, TensorBuffer]  # (src pad index, buffer)

#: suffixes of default element names
_unnamed = itertools.count()

#: pad count set per instance by its links (tensor_mux sinks, tensor_demux
#: srcs): NUM_SINK_PADS / NUM_SRC_PADS = DYNAMIC
DYNAMIC = -1


@dataclass
class PropDef:
    """One declared element property: parser, default, doc."""

    parse: Callable[[str], Any]
    default: Any = None
    doc: str = ""


def prop_bool(s) -> bool:
    if isinstance(s, bool):
        return s
    return str(s).strip().lower() in ("1", "true", "yes", "on")


class Element:
    """Base pipeline element.

    Subclasses declare ELEMENT_NAME (DSL name), sink/src pad counts, a
    PROPS table, and implement negotiate()/process().
    """

    ELEMENT_NAME: str = ""
    NUM_SINK_PADS: int = 1
    NUM_SRC_PADS: int = 1
    PROPS: Dict[str, PropDef] = {}
    #: properties every element understands, resolved alongside the
    #: subclass PROPS table
    COMMON_PROPS: Dict[str, PropDef] = {
        "error_policy": PropDef(
            ErrorPolicy.parse, FAIL_FAST,
            "what the scheduler does when process() raises: fail "
            "(default) | skip | retry:N[:backoff_ms] | degrade "
            "(route input to the added fallback src pad)"),
    }
    #: outputs may leave as tensors whose device work is still queued:
    #: the scheduler does not wait for them before passing them on, and
    #: bounds how many are in flight ([runtime] max_inflight)
    DEVICE_RESIDENT: bool = False
    #: element consumes host arrays (decoders, sinks): the JAX package's
    #: scheduler starts D2H copies early toward it. The port's scheduler
    #: declares it only — each such element calls to_host() itself
    WANTS_HOST: bool = False
    #: eligible for scheduler-level chain fusion (runtime/scheduler.py):
    #: linear runs of cheap single-in/single-out elements execute in one
    #: worker thread with direct call-through. tensor_filter sets False:
    #: its own thread is what overlaps its launches with upstream work
    CHAIN_FUSABLE: bool = True
    #: the pipeline the element was added to (set by Pipeline.add)
    _pipeline: Optional["Pipeline"] = None
    #: hooks the runner sets before start(): the session tracer (emit
    #: custom events behind `if self._tracer.active:`), the upstream
    #: event router, and the teardown event that blocking elements
    #: (injected delays) wait on instead of sleeping blind
    _tracer = NULL_TRACER
    _event_router = None
    _stop_evt = None

    def __init__(self, name: Optional[str] = None, **props):
        # a counter, not id(): the low bits of two live objects' ids can
        # coincide, and two unnamed elements of a pipeline would collide
        self.name = name or f"{self.ELEMENT_NAME}{next(_unnamed)}"
        self.props: Dict[str, Any] = {
            k: d.default for k, d in self.COMMON_PROPS.items()}
        self.props.update({k: d.default for k, d in self.PROPS.items()})
        self.set_props(**props)
        self.in_specs: List[Optional[StreamSpec]] = []
        self.out_specs: List[Optional[StreamSpec]] = []

    def set_props(self, **props) -> None:
        for key, value in props.items():
            k = key.replace("-", "_")
            pd = self.PROPS.get(k) or self.COMMON_PROPS.get(k)
            if pd is None:
                valid = sorted(p.replace("_", "-") for p in
                               list(self.PROPS) + list(self.COMMON_PROPS))
                raise PipelineError(
                    f"element {self.ELEMENT_NAME!r} ({self.name}) has no "
                    f"property {key!r}; valid properties: {valid}")
            try:
                self.props[k] = pd.parse(value) if isinstance(value, str) else value
            except (ValueError, TypeError) as e:
                raise PipelineError(
                    f"bad value {value!r} for property {key!r} of element "
                    f"{self.name}: {e}") from e

    # -- error policy ------------------------------------------------------
    @property
    def error_policy(self) -> ErrorPolicy:
        """Parsed error-policy property (FAIL_FAST unless overridden)."""
        return self.props.get("error_policy") or FAIL_FAST

    @property
    def fallback_src_pad(self) -> Optional[int]:
        """Pad index the scheduler routes failed input buffers to under
        error-policy=degrade: one extra src pad after the declared ones
        (a plain 1-src element degrades on pad 1, a sink on pad 0). It
        carries the element's sink pad 0 input stream, unprocessed.
        None unless the policy is degrade."""
        if self.error_policy.kind != "degrade" \
                or self.NUM_SRC_PADS == DYNAMIC:
            return None
        return self.NUM_SRC_PADS

    @property
    def num_sink_pads(self) -> int:
        return self.NUM_SINK_PADS

    @property
    def num_src_pads(self) -> int:
        if self.fallback_src_pad is not None:
            return self.NUM_SRC_PADS + 1
        return self.NUM_SRC_PADS

    # -- upstream events (GStreamer upstream-event analog) -----------------
    def post_upstream_event(self, event: dict) -> None:
        """Send an event toward the pipeline's sources (e.g. a QoS
        throttle). Routed against the link graph by the runner; each
        upstream element's handle_upstream_event() may consume it
        (return True) or let it propagate further. No-op outside a
        running pipeline."""
        router = self._event_router
        if router is not None:
            router(self, event)

    def handle_upstream_event(self, event: dict) -> bool:
        """Return True to consume the event (stops propagation)."""
        return False

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        """Compute output specs from input specs. Runs once, build time."""
        raise NotImplementedError

    def fail_negotiation(self, msg: str) -> None:
        raise NegotiationError(f"element {self.name} ({self.ELEMENT_NAME}): {msg}")

    #: element understands micro-batched streams (buffers with a
    #: variable leading batch axis, tensor_batch upstream); every other
    #: element refuses them at negotiation
    ACCEPTS_DYN_BATCH: bool = False

    def expect_tensors(self, spec: StreamSpec, pad: int = 0) -> TensorsSpec:
        if not isinstance(spec, TensorsSpec):
            self.fail_negotiation(
                f"sink pad {pad} requires a tensor stream but got "
                f"{type(spec).__name__} ({spec}); insert a tensor_converter "
                f"upstream to turn media into tensors")
        if spec.dyn_batch and not self.ACCEPTS_DYN_BATCH:
            self.fail_negotiation(_batched_refusal(self, pad, spec))
        return spec

    def start(self) -> None:
        """Called after negotiation, before data flows (open engines…)."""

    def stop(self) -> None:
        """Called at teardown."""

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        raise NotImplementedError

    def flush(self) -> List[Emission]:
        """Drain internal state at EOS."""
        return []

    def next_deadline(self) -> Optional[float]:
        """Earliest `time.perf_counter()` instant at which this element
        needs a wakeup even if no buffer arrives (tensor_llm's next
        serving step). None = no pending deadline. Called only from the
        element's own worker thread."""
        return None

    def on_timer(self) -> List[Emission]:
        """Fired by the scheduler when next_deadline() passes before a
        buffer arrives. Same threading contract as process()."""
        return []

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"


def _batched_refusal(e: Element, pad: int, spec: TensorsSpec) -> str:
    return (f"sink pad {pad} stream is dynamically micro-batched "
            f"(tensor_batch upstream, up to {spec.dyn_batch} frames per "
            f"buffer) but {e.ELEMENT_NAME} is not batch-aware; insert "
            f"tensor_unbatch before it to restore per-frame buffers")


class SourceElement(Element):
    NUM_SINK_PADS = 0

    #: QoS pacing requested from downstream (0 = none): sources should
    #: not *generate* frames closer together than this (skip before
    #: compute, the point of an upstream QoS event)
    qos_min_interval_ns: int = 0
    qos_skipped: int = 0

    def handle_upstream_event(self, event: dict) -> bool:
        if event.get("type") == "qos":
            self.qos_min_interval_ns = int(event.get("min_interval_ns", 0))
            return True
        return False

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        return [self.output_spec()]

    def output_spec(self) -> StreamSpec:
        raise NotImplementedError

    def generate(self) -> Iterator[TensorBuffer]:
        raise NotImplementedError

    def interrupt(self) -> None:
        """Unblock generate() for teardown (sources that block on
        external input override this)."""

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        raise PipelineError(f"source {self.name} cannot receive buffers")


class SinkElement(Element):
    NUM_SRC_PADS = 0

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        return []

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        self.render(buf)
        return []

    def render(self, buf: TensorBuffer) -> None:
        raise NotImplementedError


@dataclass(frozen=True)
class Link:
    src: Element
    src_pad: int
    dst: Element
    dst_pad: int

    def __str__(self):
        return (f"{self.src.name}:src{self.src_pad} → "
                f"{self.dst.name}:sink{self.dst_pad}")


class Pipeline:
    """A DAG of elements + links, negotiated then run by the scheduler."""

    def __init__(self, name: str = "pipeline"):
        self.name = name
        self.elements: Dict[str, Element] = {}
        self.links: List[Link] = []
        self._negotiated = False

    def add(self, element: Element) -> Element:
        if element.name in self.elements:
            raise PipelineError(
                f"duplicate element name {element.name!r} in pipeline")
        self.elements[element.name] = element
        element._pipeline = self
        return element

    def link(self, src: Element, dst: Element,
             src_pad: Optional[int] = None,
             dst_pad: Optional[int] = None) -> Link:
        for e in (src, dst):
            if self.elements.get(e.name) is not e:
                raise PipelineError(
                    f"element {e.name!r} is not in pipeline {self.name!r}; "
                    f"add() it before linking")
        if src_pad is None:
            src_pad = self._next_free_pad(src, src_side=True)
        if dst_pad is None:
            dst_pad = self._next_free_pad(dst, src_side=False)
        if src.NUM_SRC_PADS != DYNAMIC and src_pad >= src.num_src_pads:
            raise PipelineError(
                f"{src.name} has {src.num_src_pads} src pad(s); cannot link "
                f"pad {src_pad}")
        if dst.NUM_SINK_PADS != DYNAMIC and dst_pad >= dst.NUM_SINK_PADS:
            raise PipelineError(
                f"{dst.name} has {dst.NUM_SINK_PADS} sink pad(s); cannot "
                f"link pad {dst_pad}")
        for l in self.links:
            if l.src is src and l.src_pad == src_pad:
                raise PipelineError(f"src pad already linked: {l}")
            if l.dst is dst and l.dst_pad == dst_pad:
                raise PipelineError(f"sink pad already linked: {l}")
        link = Link(src, src_pad, dst, dst_pad)
        self.links.append(link)
        self._negotiated = False
        return link

    def _next_free_pad(self, e: Element, src_side: bool) -> int:
        used = {(l.src_pad if src_side else l.dst_pad) for l in self.links
                if (l.src if src_side else l.dst) is e}
        pad = 0
        while pad in used:
            pad += 1
        return pad

    def sources(self) -> List[SourceElement]:
        return [e for e in self.elements.values()
                if isinstance(e, SourceElement)]

    def links_from(self, e: Element) -> List[Link]:
        return sorted((l for l in self.links if l.src is e),
                      key=lambda l: l.src_pad)

    def links_to(self, e: Element) -> List[Link]:
        return sorted((l for l in self.links if l.dst is e),
                      key=lambda l: l.dst_pad)

    def get(self, name: str) -> Element:
        try:
            return self.elements[name]
        except KeyError:
            raise PipelineError(
                f"no element named {name!r} in pipeline; elements: "
                f"{sorted(self.elements)}") from None

    def negotiate(self) -> None:
        """Single-pass static negotiation in topological order."""
        self._validate_topology()
        link_spec: Dict[Tuple[str, int], StreamSpec] = {}
        for e in self._topo_order():
            in_links = self.links_to(e)
            n_sink = (len(in_links) if e.NUM_SINK_PADS == DYNAMIC
                      else e.NUM_SINK_PADS)
            in_specs: List[StreamSpec] = [None] * n_sink  # type: ignore
            for l in in_links:
                if l.dst_pad >= n_sink:
                    raise NegotiationError(
                        f"element {e.name} has unlinked sink pad(s) below "
                        f"pad {l.dst_pad}")
                in_specs[l.dst_pad] = link_spec[(l.src.name, l.src_pad)]
            # checked here too, not only in expect_tensors, so elements
            # whose negotiate() never looks at the spec (sinks) still
            # refuse micro-batched links they cannot read
            for i, s in enumerate(in_specs):
                if isinstance(s, TensorsSpec) and s.dyn_batch \
                        and not e.ACCEPTS_DYN_BATCH:
                    raise NegotiationError(
                        f"element {e.name} ({e.ELEMENT_NAME}): "
                        f"{_batched_refusal(e, i, s)}")
            out_specs = e.negotiate(in_specs)
            fb = e.fallback_src_pad
            if fb is not None and len(out_specs) == fb:
                # the degrade fallback pad carries the element's pad-0
                # input stream verbatim, so its spec is the input spec
                out_specs = list(out_specs) + [in_specs[0]]
            n_src = (len(self.links_from(e)) if e.NUM_SRC_PADS == DYNAMIC
                     else e.num_src_pads)
            if len(out_specs) != n_src:
                raise NegotiationError(
                    f"element {e.name} produced {len(out_specs)} output "
                    f"spec(s) but has {n_src} src pad(s)")
            e.in_specs = list(in_specs)
            e.out_specs = list(out_specs)
            for l in self.links_from(e):
                link_spec[(l.src.name, l.src_pad)] = out_specs[l.src_pad]
            log.debug("negotiated %s: in=%s out=%s", e.name, e.in_specs,
                      e.out_specs)
        self._link_specs = link_spec
        self._negotiated = True

    def _validate_topology(self) -> None:
        if not self.elements:
            raise PipelineError("empty pipeline")
        if not self.sources():
            raise PipelineError(
                "pipeline has no source element; every pipeline needs at "
                "least one (appsrc, videotestsrc, …)")
        for e in self.elements.values():
            policy = e.error_policy
            if policy.kind != "fail" and isinstance(e, SourceElement):
                raise PipelineError(
                    f"element {e.name}: error-policy={policy} is not "
                    f"supported on a source element — a generate() "
                    f"failure kills its pump thread, so sources are "
                    f"always fail-fast; put the policy on the element "
                    f"that can actually fail per-buffer")
            if policy.kind == "degrade" and e.NUM_SRC_PADS == DYNAMIC:
                raise PipelineError(
                    f"element {e.name}: error-policy=degrade needs a "
                    f"fixed src pad count to place the fallback pad, but "
                    f"{e.ELEMENT_NAME} has dynamic src pads; use skip or "
                    f"retry instead")
            n_in, n_out = len(self.links_to(e)), len(self.links_from(e))
            if e.NUM_SINK_PADS != DYNAMIC and n_in != e.num_sink_pads:
                raise PipelineError(
                    f"element {e.name} needs {e.num_sink_pads} sink "
                    f"link(s), has {n_in}")
            if e.NUM_SRC_PADS != DYNAMIC and n_out != e.num_src_pads:
                hint = (
                    f" (error-policy=degrade adds a fallback src pad — "
                    f"pad {e.fallback_src_pad} — that must be linked, "
                    f"e.g. to a cheaper model branch or a sink)"
                    if e.fallback_src_pad is not None else
                    " — every src pad must be linked (terminate unused "
                    "branches with fakesink)")
                raise PipelineError(
                    f"element {e.name} needs {e.num_src_pads} src link(s), "
                    f"has {n_out}{hint}")

    def _topo_order(self) -> List[Element]:
        indeg = {name: len(self.links_to(e)) for name, e in self.elements.items()}
        ready = [e for n, e in self.elements.items() if indeg[n] == 0]
        order: List[Element] = []
        while ready:
            e = ready.pop()
            order.append(e)
            for l in self.links_from(e):
                indeg[l.dst.name] -= 1
                if indeg[l.dst.name] == 0:
                    ready.append(l.dst)
        if len(order) != len(self.elements):
            cyclic = sorted(n for n, d in indeg.items() if d > 0)
            raise PipelineError(
                f"pipeline graph has a cycle involving {cyclic}")
        return order

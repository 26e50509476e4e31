"""Graph optimization: device segments, then transform→filter fusion.

Linear chains of `tensor_transform` elements next to a `tensor_filter`
leave the graph, and their compiled programs go to the filter, whose
backend runs them on the device around the model — no per-element hop,
and the frame crosses to the device as uint8. A `tensor_decoder
device=true` right after the filter's post chain folds in the same way,
its constants (the SSD anchors) passed to each decode as an argument on
the filter's device; a `device=compact` decoder stays in the graph.
Fusion keeps results the same: negotiation runs after the rewrite, and a
backend that declines fusion gets the chains applied by the filter
element.

`fuse_segments` goes a level further: maximal linear runs of
filter → transform* → filter collapse into the upstream ("head")
filter, whose backend runs every member model and connecting chain in
one invoke (`TorchBackend.compose_segment`; one CUDA graph in a compiled
window). A placement plan (serving/placement.SegmentPlan) bounds a run
at its cuts. A backend that declines composition gets the member
invokes run by the head element, with the same bits.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, List, Optional, Tuple

from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.graph.pipeline import Link, Pipeline

log = get_logger("optimize")


def _is_fusable_transform(pipe: Pipeline, elem) -> bool:
    from nnstreamer_tpu_torch.elements.transform import TensorTransform

    return (isinstance(elem, TensorTransform)
            and len(pipe.links_to(elem)) == 1
            and len(pipe.links_from(elem)) == 1
            # a transform with its own error policy stays a separate
            # element: fused, its failures would be charged to (and
            # policied by) the filter instead
            and elem.error_policy.kind == "fail")


def chain_fn(programs) -> Optional[Callable]:
    """Tuple-to-tuple elementwise fn applying `programs` in dataflow
    order. Each program picks numpy or torch from the array it is given,
    so one chain serves the host and the device."""
    if not programs:
        return None

    def chain(tensors: Tuple) -> Tuple:
        out = []
        for t in tensors:
            for prog in programs:
                t = prog.apply(t)
            out.append(t)
        return tuple(out)

    return chain


def transfer_spec(programs, spec):
    """Static shape/dtype transfer of a program chain over a TensorsSpec."""
    if not programs:
        return spec
    infos = []
    for info in spec.tensors:
        for prog in programs:
            info = prog.out_info(info)
        infos.append(info)
    return replace(spec, tensors=tuple(infos))


def _segment_head_ok(f) -> bool:
    """Can `f` head a device segment? The head stays in the graph, its
    props and policy then govern the whole segment, and its backend runs
    the composition."""
    return (f._framework_name() == "torch"
            # dynamic shapes and output rerouting change the tuple
            # contract the composed invoke relies on
            and not f.props.get("invoke_dynamic")
            and not f.props.get("output_combination"))


def _segment_member_ok(pipe: Pipeline, e) -> bool:
    """Can `e` be absorbed into an upstream head's segment? A member
    leaves the graph, so anything that gives it runtime behavior of its
    own (an error policy, a breaker, sync latency timing, combinations,
    a manual reload, placement) keeps it separate."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    return (isinstance(e, TensorFilter)
            and len(pipe.links_to(e)) == 1
            and len(pipe.links_from(e)) == 1
            and e.error_policy.kind == "fail"
            and e._framework_name() == "torch"
            and not e.props.get("invoke_dynamic")
            and not e.props.get("input_combination")
            and not e.props.get("output_combination")
            and e.props.get("latency_mode") != "sync"
            and not e.props.get("breaker_threshold")
            and not e.props.get("shared_tensor_filter_key")
            and not e.props.get("is_updatable")
            and not e._members)


def fuse_segments(pipe: Pipeline, plan=None) -> int:
    """Collapse filter → transform → filter runs into the upstream filter.

    For each eligible head, repeatedly: walk the downstream run of
    fusable transforms; if it lands on an eligible member filter, splice
    the transforms and the member out of the graph and hand them to the
    head (`TensorFilter.absorb_member`). A placement plan (passed here,
    or `pipe.segment_plan` from `apply_plan`) stops the splice at a
    planned cut, so each stage composes into one unit on its device and
    the cut stays an element boundary (where the next stage's backend
    stages its copy).

    Run BEFORE `fuse_transforms`: the head's pre chain, the post chain
    after the last member and a trailing device decoder are then taken
    by the ordinary transform pass. → elements removed."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    plan = plan if plan is not None else getattr(pipe, "segment_plan", None)
    stage_of = plan.stage_of() if plan is not None else {}
    removed = 0
    for f in [e for e in list(pipe.elements.values())
              if isinstance(e, TensorFilter)]:
        # upstream heads come first (insertion order is dataflow order
        # for parse_launch); a filter absorbed already is gone
        if f.name not in pipe.elements or not _segment_head_ok(f):
            continue
        while True:
            mids: List = []
            cur = f
            while True:
                out_links = pipe.links_from(cur)
                if len(out_links) != 1:
                    break
                nxt = out_links[0].dst
                if not _is_fusable_transform(pipe, nxt):
                    break
                mids.append(nxt)
                cur = nxt
            out_links = pipe.links_from(cur)
            if len(out_links) != 1:
                break
            member = out_links[0].dst
            if not _segment_member_ok(pipe, member):
                break   # the transforms, if any, stay for fuse_transforms
            if stage_of and stage_of.get(member.name, stage_of.get(
                    f.name)) != stage_of.get(f.name):
                log.info("segment: plan cut between %s (stage %s) and %s "
                         "(stage %s) — not absorbed", f.name,
                         stage_of.get(f.name), member.name,
                         stage_of.get(member.name))
                break   # a planned cut: the member heads its own stage
            for t in mids:
                _remove_linear_element(pipe, t)
            _remove_linear_element(pipe, member)
            f.absorb_member([t.program for t in mids], member)
            removed += 1 + len(mids)
            log.info("segment: absorbed filter %s (+%d transform(s)) into "
                     "%s", member.name, len(mids), f.name)
    return removed


def fuse_transforms(pipe: Pipeline) -> int:
    """Rewrite the graph in place; → number of elements fused."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    fused = 0
    for f in [e for e in list(pipe.elements.values())
              if isinstance(e, TensorFilter)]:
        up: List = []
        cur = f
        while True:
            in_links = pipe.links_to(cur)
            if len(in_links) != 1 or not _is_fusable_transform(
                    pipe, in_links[0].src):
                break
            cur = in_links[0].src
            up.append(cur)
        up.reverse()  # dataflow order

        down: List = []
        cur = f
        while True:
            out_links = pipe.links_from(cur)
            if len(out_links) != 1 or not _is_fusable_transform(
                    pipe, out_links[0].dst):
                break
            cur = out_links[0].dst
            down.append(cur)

        # a device=true decoder right after the post chain runs inside the
        # filter, unless the filter reroutes or reshapes its output set
        # (output_combination, invoke_dynamic): then the decoder stays an
        # element of its own and still decodes on the device (as the JAX
        # package's fusion pass decides)
        dec = None
        out_links = pipe.links_from(cur)
        if (len(out_links) == 1 and _is_device_decoder(out_links[0].dst)
                and not f.props.get("invoke_dynamic")
                and not f.props.get("output_combination")):
            dec = out_links[0].dst

        if not up and not down and dec is None:
            continue
        for t in up + down:
            _remove_linear_element(pipe, t)
            fused += 1
        f.set_fusion([t.program for t in up], [t.program for t in down])
        if dec is not None:
            _remove_linear_element(pipe, dec)
            f.set_decoder_fusion(dec.sub)
            fused += 1
        log.info("fused %d pre + %d post transform(s)%s into %s", len(up),
                 len(down), " + device decoder" if dec is not None else "",
                 f.name)
    return fused


def _is_device_decoder(elem) -> bool:
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder

    # device=compact stays: its host decode still has work to do
    return isinstance(elem, TensorDecoder) and elem.props["device"] is True


def _remove_linear_element(pipe: Pipeline, elem) -> None:
    """Remove a 1-in/1-out element, splicing its neighbours together."""
    (in_link,) = pipe.links_to(elem)
    (out_link,) = pipe.links_from(elem)
    pipe.links.remove(in_link)
    pipe.links.remove(out_link)
    del pipe.elements[elem.name]
    pipe._negotiated = False
    pipe.links.append(
        Link(in_link.src, in_link.src_pad, out_link.dst, out_link.dst_pad))

"""tensor_filter — the model-execution element.

Reference parity: gst/nnstreamer/tensor_filter/tensor_filter.c +
tensor_filter_common.c: backend open at negotiation, model-info-driven
negotiation (set-input-info for adaptive models), input/output
overrides (`input`/`inputtype`/`output`/`outputtype`), input/output
combinations, per-invoke latency/throughput (:354-460), hot reload
(`is-updatable`), invoke-dynamic, invoke error propagation.

- `framework=` picks the backend (torch, alias xla; pallas for the
  hand-written kernels; custom (alias custom-easy) for python callables;
  python3 for reference-contract scripts; the reference's framework names
  of the formats the port loads map to torch, `_FRAMEWORK_ALIASES`);
  empty means the model file's extension
  (modelio.MODEL_EXTENSIONS), then [filter] default_backend (torch).
- `custom=` is the backend's option string (modelio.parse_loader_opts);
  `inputname`/`outputname` go into the same loader options.
- **Fusion**: `set_fusion()` receives the programs of adjacent
  tensor_transform elements removed by graph/optimize.py; an accepting
  backend runs them on the device. A refusing backend gets them applied
  here, so results never depend on fusion.
- `shared_tensor_filter_key`: filters with the same key hold one
  backend model on one device (torch backend; open takes a holder, close
  drops it, the last close frees it; a reload through one holder reaches
  all). Each filter keeps its own fused chains.
- **Micro-batches** (tensor_batch upstream): one backend
  `invoke_batched` per coalesced buffer; outputs stay batched, with the
  dyn_batch meta, for tensor_unbatch downstream.
- **FLEXIBLE** input (tensor_crop upstream) needs `invoke-dynamic=true`:
  one backend `invoke_flexible` over the buffer's regions.
- Invoke does not wait for the device: outputs flow downstream as tensors
  whose work may still be queued, so the latency stats time the host's
  launches; `latency-mode=sync` waits for each buffer's outputs (one
  forced sync, counted as `forced_syncs`) for the true per-frame latency.
- **Circuit breaker** (`breaker_threshold`, `breaker_cooldown_ms`):
  after that many consecutive invoke failures the circuit opens and
  invokes short-circuit with CircuitOpenError for the cooldown, then one
  half-open probe decides recovery (backends/base.CircuitBreaker). Pair
  it with error-policy=skip or degrade.
- At start() the runner's tracer is handed to the backend, whose invoke
  spans then land on this element's track.
- **Compiled windows** (`compiled_loop`, default on; the scheduler's
  [runtime] compiled_loop gates the whole mechanism): in steady state the
  scheduler hands K queued frames to `process_window`, one backend
  `invoke_window` (one CUDA-graph replay on the card), outputs bit for
  bit those of K `process` calls. FLEXIBLE or micro-batched input, an
  armed breaker, `latency-mode=sync`, a backend without `invoke_window`
  (framework=pallas), replicas and a segment whose members run host
  side keep the per-frame path.
- **Placement** (serving/placement.py, serving/sharding.py):
  ``devices=N`` serves through N replicas, one whole backend per
  logical device behind least-outstanding routing; ``shards=N`` through
  one shard group whose weights are stored split over N devices;
  ``devices=M shards=N`` through M/N such groups. Each replica or group
  runs the one-device program, so outputs are the same bits. Declined
  softly — a log line and the `replica_decline` stat, the one-device
  path kept — for an explicit accelerator, a shared key, a store canary
  and a segment head (and, for shards, host-side chains, I/O overrides
  and a framework other than torch).
- **Device segments** (graph/optimize.fuse_segments): downstream filters
  absorbed into this head (`absorb_member`) are negotiated through it in
  a chain and offered to the backend (`compose_segment`); a backend that
  declines gets the member invokes run here, per buffer, with the same
  bits. A member's failure is charged to the member by name
  (SegmentStageError).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import replace
from typing import Callable, List, Optional, Sequence, Tuple

from nnstreamer_tpu_torch.backends import (  # noqa: F401 (register)
    custom, pallas_backend, python3_script, torch_backend)
from nnstreamer_tpu_torch.backends.base import (
    CircuitBreaker, FilterBackend, get_backend)
from nnstreamer_tpu_torch.core.config import get_config
from nnstreamer_tpu_torch.core.errors import (
    BackendError, CircuitOpenError, PipelineError, SegmentStageError)
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.elements.decoder import aux_on
from nnstreamer_tpu_torch.graph.optimize import chain_fn, transfer_spec
from nnstreamer_tpu_torch.graph.pipeline import Element, Emission, PropDef, StreamSpec
from nnstreamer_tpu_torch.runtime.sync import device_sync
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec

log = get_logger("filter")


def _prop_bool(s) -> bool:
    return str(s).lower() in ("1", "true")


def _parse_combination(s: str) -> Optional[List[int]]:
    if not s:
        return None
    try:
        return [int(x) for x in s.split(",")]
    except ValueError:
        raise PipelineError(
            f"bad combination list {s!r}; expected comma-separated tensor "
            f"indices like '0,2'") from None


def _parse_out_combination(s: str) -> Optional[List[Tuple[str, int]]]:
    """'i0,o1' → [('i', 0), ('o', 1)]: pass input 0 through, then model
    output 1 (the reference's output-combination,
    tensor_filter.c:820-877)."""
    if not s:
        return None
    out = []
    for part in s.split(","):
        part = part.strip()
        if len(part) < 2 or part[0] not in "io" or not part[1:].isdigit():
            raise PipelineError(
                f"bad output-combination entry {part!r}; entries are "
                f"i<idx> (pass input) or o<idx> (model output)")
        out.append((part[0], int(part[1:])))
    return out


@register_element("tensor_filter")
class TensorFilter(Element):
    ELEMENT_NAME = "tensor_filter"
    DEVICE_RESIDENT = True
    #: one backend invoke per coalesced buffer of a tensor_batch upstream
    ACCEPTS_DYN_BATCH = True
    #: its own worker thread is what overlaps its launches with upstream
    #: conversion, so it never joins a fused chain
    CHAIN_FUSABLE = False
    PROPS = {
        "framework": PropDef(str, "", "backend name "
                                      "(torch|xla|pallas|custom|python3)"),
        "model": PropDef(lambda s: s, None, "model reference (backend-specific)"),
        "custom": PropDef(str, "", "opaque backend option string"),
        "accelerator": PropDef(str, "", "device: cuda, cuda:<i> or cpu "
                                        "(empty: [filter] accelerator)"),
        # data-parallel replicas (serving/placement.py): replica i is a
        # whole backend on logical device i, the same bits as devices=0
        "devices": PropDef(
            int, 0, "data-parallel replicas, one per device (0=off)"),
        # dense shards (serving/sharding.py): one backend whose weights
        # are stored split over N devices, leased as one group (a fenced
        # member fences the group); with devices=M, M//N groups
        "shards": PropDef(
            int, 0, "shards per group: one model stored split over N "
                    "devices (0=off; 2/4/8)"),
        "input": PropDef(str, "", "override input dims (dim string list)"),
        "inputtype": PropDef(str, "", "override input types"),
        "output": PropDef(str, "", "override output dims"),
        "outputtype": PropDef(str, "", "override output types"),
        # which graph nodes of a multi-node model file are the I/O (the
        # reference's tensorflow filter props); "," separates names
        "inputname": PropDef(str, "", "model input node name(s)"),
        "outputname": PropDef(str, "", "model output node name(s)"),
        "input_combination": PropDef(str, "", "sink-tensor subset, e.g. 0,2"),
        "output_combination": PropDef(
            str, "", "i<n>=input passthrough / o<n>=output picks"),
        "latency_mode": PropDef(str, "async", "async|sync stats timing"),
        "is_updatable": PropDef(_prop_bool, False),
        "invoke_dynamic": PropDef(
            _prop_bool, False,
            "accept FLEXIBLE input (per-buffer shapes, bucketed calls)"),
        "shared_tensor_filter_key": PropDef(
            str, "", "share one device model across filters with this key"),
        # store:// serving: canary splits are routed by a seeded RNG so
        # a run's version sequence is reproducible
        "canary_seed": PropDef(
            int, 0, "seed for store:// canary routing (deterministic)"),
        "breaker_threshold": PropDef(
            int, 0, "consecutive invoke failures to open the circuit (0=off)"),
        "breaker_cooldown_ms": PropDef(
            float, 1000.0, "open-circuit cooldown before the probe invoke"),
        # per-element opt-out of the scheduler's compiled steady-state
        # window (runtime/compiled_loop.py)
        "compiled_loop": PropDef(
            _prop_bool, True,
            "allow the scheduler's compiled steady-state window"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.backend: Optional[FilterBackend] = None
        self._pre: Optional[Callable] = None   # fused pre chain
        self._post: Optional[Callable] = None
        self._pre_programs: list = []
        self._post_programs: list = []
        self._fused_in_backend = False
        self._fused_decoder = None             # device-decode subplugin
        self._decoder_aux = None               # its constants, on device
        self._breaker: Optional[CircuitBreaker] = None
        self._in_combination = _parse_combination(
            self.props["input_combination"])
        self._out_combination = _parse_out_combination(
            self.props["output_combination"])
        self._lat_window = deque(maxlen=10)    # last 10, reference :443-455
        self._invoke_count = 0
        self._t_start: Optional[float] = None
        self._flexible = False
        self._dyn_batched = 0                  # dyn_batch of the input
        self._batch_keepdims: List[bool] = []
        self._forced_syncs = 0                 # latency-mode=sync waits
        # device segment (graph/optimize.fuse_segments): downstream
        # filters absorbed into this head as (mid programs, element)
        self._members: List[Tuple[list, "TensorFilter"]] = []
        # negotiated member stages: (mid chain | None, member, member
        # batch keepdims)
        self._member_stages: List[Tuple[Optional[Callable],
                                        "TensorFilter", List[bool]]] = []
        self._segment_in_backend = False
        # replicas or shard groups (devices=/shards=): when set, invokes
        # route through them; self.backend stays the negotiation source
        # and runs no frame
        self.replicas = None
        self._replica_decline = ""

    # -- fusion (called by graph/optimize.py) ------------------------------
    def set_fusion(self, pre_programs, post_programs) -> None:
        """Absorb removed transform elements' compiled programs."""
        self._pre_programs = pre_programs or []
        self._post_programs = post_programs or []
        self._pre = chain_fn(self._pre_programs)
        self._post = chain_fn(self._post_programs)

    def set_decoder_fusion(self, sub) -> None:
        """Absorb a downstream `tensor_decoder device=true` subplugin: its
        device_decode runs right after the model (+ post transforms), so
        only the compact result leaves the device."""
        self._fused_decoder = sub
        base_post = self._post

        def post(tensors):
            if base_post is not None:
                tensors = base_post(tensors)
            return tuple(sub.device_decode(tuple(tensors), self._decoder_aux))

        self._post = post

    def absorb_member(self, mid_programs, member: "TensorFilter") -> None:
        """Absorb a downstream tensor_filter (and the transform chain
        before it) removed by `graph/optimize.fuse_segments`: its model
        runs in this head's backend invoke (`compose_segment`), or, where
        the backend declines, is invoked here per buffer."""
        self._members.append((list(mid_programs or []), member))

    def segment_name(self) -> str:
        """head+member1+member2… — the trace and report identity of the
        segment (empty without members)."""
        if not self._members:
            return ""
        return "+".join([self.name] + [m.name for _, m in self._members])

    #: reference framework names → the port's backends, so reference
    #: pipeline strings run verbatim (`framework=snpe model=add2_float.dlc`,
    #: `framework=deepview-rt model=....rtm`, `framework=pytorch
    #: model=....pt`): every framework whose model files the port loads,
    #: and the reference's custom-easy (the custom backend)
    _FRAMEWORK_ALIASES = {
        "tensorflow-lite": "torch", "tensorflow1-lite": "torch",
        "tensorflow2-lite": "torch", "tensorflow": "torch",
        "caffe2": "torch", "snpe": "torch", "deepview-rt": "torch",
        "tensorrt": "torch", "armnn": "torch", "pytorch": "torch",
        "custom-easy": "custom",
    }

    # -- negotiation / backend open ---------------------------------------
    def _framework_name(self) -> str:
        """framework= (through the aliases); empty: the backend that
        loads the model file's extension, then [filter] default_backend."""
        fw = self.props["framework"]
        if fw:
            return self._FRAMEWORK_ALIASES.get(fw, fw)
        model = self.props["model"]
        if isinstance(model, str):
            from nnstreamer_tpu_torch.modelio import (
                MODEL_EXTENSIONS, model_ext)

            ext = model_ext(model)
            if ext in MODEL_EXTENSIONS:
                return MODEL_EXTENSIONS[ext]
        return get_config().get("filter", "default_backend") or "torch"

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        combined = (self._in_combination is not None
                    or self._out_combination is not None)
        self._dyn_batched = spec.dyn_batch
        if spec.dyn_batch:
            if combined:
                self.fail_negotiation(
                    "input-/output-combination cannot apply to a "
                    "micro-batched stream (batched buffers carry one "
                    "variable batch axis, not fixed per-frame tensor "
                    "slots); place tensor_batch after the combination or "
                    "drop the combination properties")
            # the model and every check below see the PER-FRAME spec;
            # dyn_batch goes back onto the output spec at the end
            spec = replace(spec, dyn_batch=0)
            self._batch_keepdims = [len(t.shape) >= 1 and t.shape[0] == 1
                                    for t in spec.tensors]
        fw = self._framework_name()
        try:
            self.backend = get_backend(fw)
        except PipelineError as e:
            self.fail_negotiation(str(e))
        try:
            self.backend.open(dict(self.props))
        except BackendError as e:
            self.fail_negotiation(f"backend {fw!r} failed to open model: {e}")
        if self._pre is not None or self._post is not None:
            self._fused_in_backend = self.backend.fuse(self._pre, self._post)

        if spec.format == TensorFormat.FLEXIBLE:
            if combined:
                self.fail_negotiation(
                    "input-/output-combination cannot apply to a FLEXIBLE "
                    "stream (per-buffer region count, no fixed tensor "
                    "indices); remove the combination properties or make "
                    "the stream static with tensor_resize")
            if not self.props["invoke_dynamic"]:
                self.fail_negotiation(
                    "input stream is FLEXIBLE (per-buffer shapes, e.g. from "
                    "tensor_crop) but invoke-dynamic is off. Either set "
                    "invoke_dynamic=true (shape-bucketed calls; the model "
                    "must accept the per-buffer shapes — use "
                    "custom=dynamic_spatial=true for shape-polymorphic "
                    "models) or insert `tensor_resize size=H:W` to make the "
                    "stream static")
            self._flexible = True
            if int(self.props["devices"] or 0) > 0:
                self._replica_decline = (
                    "FLEXIBLE stream (per-buffer shapes route through one "
                    "backend's bucket set)")
                log.warning("tensor_filter %s: devices=%d declined: %s",
                            self.name, self.props["devices"],
                            self._replica_decline)
            # per-region output shapes are known only per buffer
            model_out = self.backend.get_model_info()[1]
            return [TensorsSpec(
                tensors=model_out.tensors if model_out is not None else (),
                format=TensorFormat.FLEXIBLE, rate=spec.rate)]

        info_in, info_out = self.backend.get_model_info()
        model_in = self._override_spec(
            self.props["input"], self.props["inputtype"], info_in)
        model_out = self._override_spec(
            self.props["output"], self.props["outputtype"], info_out)
        fed = spec if self._in_combination is None else self._subset_spec(spec)
        # what the model itself sees after any fused pre-chain
        model_sees = transfer_spec(self._pre_programs, fed)
        if model_in is not None and not model_in.is_compatible(model_sees):
            self.fail_negotiation(
                f"model expects input {model_in} but receives {model_sees}"
                + (f" (= {fed} after fused pre-transforms)"
                   if self._pre_programs else "")
                + ". Fix the upstream pipeline (converter/transform dims) or "
                  "override with input=/inputtype= properties")
        need_set_input = model_out is None
        if need_set_input:
            try:
                model_out = self.backend.set_input_info(model_sees)
            except BackendError as e:
                self.fail_negotiation(str(e))
        # a segment's members negotiate in a chain, each on the previous
        # stage's output after its connecting transforms, with every
        # member-side check (model info, overrides, backend open) as if
        # it were still in the graph
        if self._members:
            model_out = self._negotiate_members(model_out, spec.rate)
        model_out = transfer_spec(self._post_programs, model_out)
        if self._fused_decoder is not None:
            if self._out_combination is not None:
                self.fail_negotiation(
                    "output-combination cannot combine with a fused device "
                    "decoder (the decoder consumes the whole output set)")
            try:
                model_out = self._fused_decoder.device_negotiate(model_out)
            except (ValueError, PipelineError) as e:
                self.fail_negotiation(
                    f"fused device decoder rejected model output "
                    f"{model_out}: {e}")
            self._decoder_aux = aux_on(self._fused_decoder.device_aux(),
                                       self.backend.device)
        # devices=/shards=: replicate the negotiated backend setup on the
        # placed backends (after the decoder fusion, so each serves the
        # final program)
        self._maybe_setup_replicas(fw, need_set_input, model_sees)
        out = model_out.with_rate(spec.rate)
        if self._out_combination is not None:
            infos = []
            for kind, idx in self._out_combination:
                pool = spec.tensors if kind == "i" else out.tensors
                if idx >= len(pool):
                    self.fail_negotiation(
                        f"output-combination {kind}{idx} out of range "
                        f"({'input' if kind == 'i' else 'output'} has "
                        f"{len(pool)} tensors)")
                infos.append(pool[idx])
            out = replace(out, tensors=tuple(infos))
        if self._dyn_batched:
            out = replace(out, dyn_batch=self._dyn_batched)
        return [out]

    def _maybe_setup_replicas(self, fw: str, need_set_input: bool,
                              model_sees) -> None:
        """Open the devices=N replicas or shards=N groups
        (serving/placement.py, serving/sharding.py). Each replica backend
        gets the head's open props (plus its device pin), fused chains
        and set_input_info, so each serves the head's program. What is
        not supported declines softly (a log line and the
        `replica_decline` stat; the one-device path serves): placement
        never changes what a pipeline computes, only where."""
        n = int(self.props["devices"] or 0)
        shards = int(self.props["shards"] or 0)
        if n <= 0 and shards <= 0:
            return
        decline = ""
        if self._members:
            decline = ("segment head (members absorbed); replicate the "
                       "unfused filters or use segment placement instead")
        elif self.props["accelerator"]:
            decline = (f"accelerator={self.props['accelerator']!r} pins "
                       f"one device explicitly")
        elif self.props["shared_tensor_filter_key"]:
            decline = "shared-tensor-filter-key holds one device-resident model"
        elif "@" in str(self.props["model"] or "") and \
                ":" in str(self.props["model"]).rpartition("@")[2]:
            decline = "store canary split routes per-backend (seeded RNG)"
        if not decline and shards > 0:
            # a shard group serves the raw model bundle: a host-side
            # chain or explicit I/O overrides have no per-group replay
            if self._pre is not None or self._post is not None:
                decline = ("custom-ops pre/post chain (sharded groups "
                           "serve the raw model bundle)")
            elif any(self.props[k] for k in
                     ("input", "inputtype", "output", "outputtype",
                      "inputname", "outputname")):
                decline = "explicit I/O override props are single-backend"
            elif fw != "torch":
                decline = f"framework {fw!r} (sharding is torch-only)"
        if decline:
            what = f"devices={n}" if shards <= 0 else f"shards={shards}"
            self._replica_decline = decline
            log.warning("tensor_filter %s: %s declined: %s",
                        self.name, what, decline)
            return
        if shards > 0:
            from nnstreamer_tpu_torch.serving.sharding import (
                SUPPORTED_SHARDS, ShardedReplicaSet)

            if shards not in SUPPORTED_SHARDS:
                self.fail_negotiation(
                    f"shards must be one of {SUPPORTED_SHARDS} "
                    f"(canonical 8-block serving layout), got {shards}")
            groups = max(1, n // shards) if n > 0 else 1
            try:
                self.replicas = ShardedReplicaSet.open_sharded(
                    self.props["model"], shards=shards, groups=groups,
                    name=self.name, tracer=self._tracer)
            except BackendError as e:
                self.fail_negotiation(f"shards={shards}: {e}")
            return
        from nnstreamer_tpu_torch.serving.placement import ReplicaSet

        pre, post = self._pre, self._post
        fused = self._fused_in_backend

        def configure(b):
            if pre is not None or post is not None:
                if bool(b.fuse(pre, post)) != fused:
                    raise BackendError(
                        "replica backend disagreed with the head about "
                        "pre/post fusion — placement would change results")
            if need_set_input:
                b.set_input_info(model_sees)

        try:
            self.replicas = ReplicaSet.open(
                fw, dict(self.props), n, configure=configure,
                name=self.name)
        except BackendError as e:
            self.fail_negotiation(f"devices={n}: {e}")

    def _negotiate_members(self, model_out: TensorsSpec, rate) -> TensorsSpec:
        """Negotiate the segment's members in a chain, then offer the
        backend the composition. → the last member's output spec."""
        self._member_stages = []
        cur = model_out
        for mids, m in self._members:
            cur = transfer_spec(mids, cur)
            keep = [len(t.shape) >= 1 and t.shape[0] == 1
                    for t in cur.tensors]
            [cur] = m.negotiate([cur.with_rate(rate)])
            self._member_stages.append((chain_fn(mids), m, keep))
        compose = getattr(self.backend, "compose_segment", None)
        self._segment_in_backend = bool(compose is not None and compose(
            [(fn, m.backend, m.name) for fn, m, _ in self._member_stages]))
        if not self._segment_in_backend:
            log.info("segment %s: backend declined composition; member "
                     "invokes run host side (results identical)",
                     self.segment_name())
        return cur

    def _apply_segment_host(self, outputs, n=None, keepdims=None):
        """Declined composition: each member's connecting chain and model
        invoke here, in dataflow order — one invoke per member instead of
        one per segment, the same bits."""
        for fn, m, keep in self._member_stages:
            if fn is not None:
                outputs = fn(outputs)
            try:
                if n is None:
                    outputs = m.backend.invoke(outputs)
                else:
                    outputs = m.backend.invoke_batched(outputs, n, keep)
            except Exception as e:
                m.backend.invoke_failures += 1
                raise SegmentStageError(m.name, e) from e
        return outputs

    def _subset_spec(self, spec: TensorsSpec) -> TensorsSpec:
        idxs = self._in_combination
        if any(i >= spec.num_tensors for i in idxs):
            self.fail_negotiation(
                f"input-combination {idxs} out of range for "
                f"{spec.num_tensors}-tensor input")
        return replace(spec, tensors=tuple(spec.tensors[i] for i in idxs))

    @staticmethod
    def _override_spec(dims: str, types: str,
                       fallback) -> Optional[TensorsSpec]:
        if dims:
            return TensorsSpec.from_strings(dims, types or "float32")
        return fallback

    def start(self) -> None:
        self._t_start = time.monotonic()
        # a test may pre-install a breaker with an injected clock; build
        # one here only if the props ask for it and none exists yet
        if self._breaker is None and self.props["breaker_threshold"] > 0:
            self._breaker = CircuitBreaker(
                self.props["breaker_threshold"],
                self.props["breaker_cooldown_ms"] / 1e3)
        if self.backend is not None:
            # a composed segment's spans land on the joined member names,
            # so report() shows the segment and not vanished elements
            self.backend.tracer = self._tracer
            self.backend.trace_name = self.segment_name() or self.name
            # a store-bound backend replays its persistent bucket
            # manifest here, before any buffer flows; with replicas the
            # head backend serves no frame, so they warm instead
            warm = getattr(self.backend, "warm_start", None)
            if warm is not None and self.replicas is None:
                warm()
        if self.replicas is not None:
            self.replicas.warm_start(self._tracer, self.name)
        for _, m, _ in self._member_stages:
            if m.backend is not None:
                m.backend.tracer = self._tracer
                m.backend.trace_name = m.name   # swaps keep member names
                warm = getattr(m.backend, "warm_start", None)
                if warm is not None and not self._segment_in_backend:
                    # the host fallback invokes the member backend: warm
                    # its manifest like any filter's
                    warm()

    def stop(self) -> None:
        if self.replicas is not None:
            self.replicas.close()
        if self.backend is not None:
            self.backend.close()
        for _, m in self._members:
            if m.backend is not None:
                m.backend.close()

    def extra_stats(self) -> dict:
        """Backend and breaker counters merged into this element's
        stats() row."""
        out = {}
        for k in ("invoke_failures", "staging_transfers", "staging_elided",
                  "window_invokes", "window_frames", "window_compile_count",
                  "warm_start_buckets"):
            v = getattr(self.backend, k, None)
            if v is not None:
                out["backend_" + k] = v
        # micro-batch occupancies served in one call ({n: invokes}) and
        # the number of distinct bucket shapes run
        hist = getattr(self.backend, "batch_size_hist", None)
        if hist:
            out["backend_batch_size_hist"] = dict(sorted(hist.items()))
        buckets = getattr(self.backend, "bucket_shapes", None)
        if buckets:
            out["backend_bucket_shapes"] = len(buckets)
        # store:// serving: per-version invoke/error/p95 counters and the
        # epoch adoptions, under backend_ keys (report()'s backend section)
        vstats = getattr(self.backend, "version_stats", None)
        if vstats is not None:
            for ver, d in vstats().items():
                for k, v in d.items():
                    out[f"backend_v{ver}_{k}"] = v
        swaps = getattr(self.backend, "swap_count", 0)
        if swaps:
            out["backend_swaps"] = swaps
        if self._breaker is not None:
            for k, v in self._breaker.stats().items():
                out["breaker_" + k] = v
        if self._members:
            out["segment"] = self.segment_name()
            out["segment_size"] = 1 + len(self._members)
            out["segment_composed"] = int(self._segment_in_backend)
            mswaps = sum(getattr(m.backend, "swap_count", 0) or 0
                         for _, m in self._members)
            if mswaps:
                out["backend_swaps"] = out.get("backend_swaps", 0) + mswaps
        if self._forced_syncs:
            out["forced_syncs"] = self._forced_syncs
        if self.replicas is not None:
            rst = self.replicas.stats()
            out["replica_devices"] = rst["devices"]
            out["replica_live"] = rst["live"]
            out["replica_invokes"] = sum(
                r["invokes"] for r in rst["replicas"])
            out["replica_errors"] = sum(
                r["errors"] for r in rst["replicas"])
            out["replica_reoffers"] = rst["reoffers"]
            out["replica_fences"] = rst["fences"]
            # per-device rows ride along for the metrics plane
            out["replicas"] = rst["replicas"]
            if "group_size" in rst:       # shard groups
                out["shards"] = rst["group_size"]
                out["shard_groups"] = rst["devices"]
                if "leases" in rst:
                    out["leases"] = rst["leases"]
        if self._replica_decline:
            out["replica_decline"] = self._replica_decline
        return out

    def _invoke_guarded(self, invoke, *args):
        """One backend invoke through the circuit breaker (when
        configured). A short-circuit raises CircuitOpenError without
        touching the backend and without counting as a new failure; the
        element's error policy decides what it means."""
        br = self._breaker
        if br is None:
            return invoke(*args)
        br.guard(self.name)
        try:
            out = invoke(*args)
        except Exception:
            br.record_failure()
            raise
        br.record_success()
        return out

    def _invoke_or_raise(self, what: Callable[[], str], invoke, *args):
        """`_invoke_guarded`, a failure counted and raised as BackendError
        with `what()` (built only then) naming the buffer; a segment
        member's failure names the member."""
        try:
            return self._invoke_guarded(invoke, *args)
        except CircuitOpenError:
            raise   # keep the type — error policies never retry these
        except SegmentStageError as e:
            self.backend.invoke_failures += 1
            raise BackendError(
                f"tensor_filter {self.name}: segment member {e.member!r} "
                f"failed: {what()}: {e}") from e
        except Exception as e:
            self.backend.invoke_failures += 1
            raise BackendError(
                f"tensor_filter {self.name}: {what()}: {e}") from e

    def _invoke_segment(self, inputs):
        """One invoke of this filter: through the replicas, or the
        backend (a composed segment runs every member inside it) and the
        host-side members after it. The breaker guards it as one unit."""
        if self.replicas is not None:
            return self.replicas.invoke(inputs)
        outputs = self.backend.invoke(inputs)
        if self._member_stages and not self._segment_in_backend:
            outputs = self._apply_segment_host(outputs)
        return outputs

    def _invoke_segment_batched(self, inputs, n, keepdims):
        if self.replicas is not None:
            return self.replicas.invoke_batched(inputs, n, keepdims)
        outputs = self.backend.invoke_batched(inputs, n, keepdims)
        if self._member_stages and not self._segment_in_backend:
            outputs = self._apply_segment_host(outputs, n, keepdims)
        return outputs

    def _sync_outputs(self, outputs) -> tuple:
        """latency-mode=sync: one whole-tuple forced sync per buffer
        (runtime/sync.py, traced under this element), counted as the
        `forced_syncs` stat."""
        device_sync(tuple(outputs), self._tracer, self.name)
        self._forced_syncs += 1
        return tuple(outputs)

    # -- hot loop ----------------------------------------------------------
    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        if self._flexible:
            return self._process_flexible(buf)
        if self._dyn_batched:
            return self._process_batched(buf)
        inputs = buf.tensors
        if self._in_combination is not None:
            inputs = tuple(inputs[i] for i in self._in_combination)
        t0 = time.perf_counter()
        if self._pre is not None and not self._fused_in_backend:
            inputs = self._pre(inputs)
        outputs = self._invoke_or_raise(
            lambda: f"invoke failed on frame pts={buf.pts}",
            self._invoke_segment, inputs)
        if self._post is not None and not self._fused_in_backend:
            outputs = self._post(outputs)
        if self.props["latency_mode"] == "sync":
            outputs = self._sync_outputs(outputs)
        self._lat_window.append(time.perf_counter() - t0)
        self._invoke_count += 1
        if self._out_combination is not None:
            outputs = tuple(buf.tensors[idx] if kind == "i" else outputs[idx]
                            for kind, idx in self._out_combination)
        return [(0, buf.with_tensors(outputs))]

    def _process_batched(self, buf: TensorBuffer) -> List[Emission]:
        """A micro-batch (tensor_batch upstream): one batched invoke over
        the coalesced frames; outputs stay batched and keep the dyn_batch
        meta for tensor_unbatch. Host-side fused chains are elementwise,
        so they apply to the batched arrays directly."""
        db = buf.meta.get("dyn_batch")
        if db is None:
            raise BackendError(
                f"tensor_filter {self.name}: micro-batched stream buffer "
                f"has no dyn_batch meta (upstream element dropped it?)")
        n = int(db["n"])
        inputs = buf.tensors
        t0 = time.perf_counter()
        if self._pre is not None and not self._fused_in_backend:
            inputs = self._pre(inputs)
        outputs = self._invoke_or_raise(
            lambda: f"batched invoke failed on buffer pts={buf.pts} "
                    f"occupancy={n}",
            self._invoke_segment_batched, inputs, n, self._batch_keepdims)
        if self._post is not None and not self._fused_in_backend:
            outputs = self._post(outputs)
        if self.props["latency_mode"] == "sync":
            outputs = self._sync_outputs(outputs)
        self._lat_window.append(time.perf_counter() - t0)
        self._invoke_count += n   # the throughput counts FRAMES
        return [(0, buf.with_tensors(outputs))]

    def _process_flexible(self, buf: TensorBuffer) -> List[Emission]:
        """A FLEXIBLE buffer: N variable-shape regions, one model output
        each (invoke-dynamic). Host-side fused chains apply per region."""
        regions = list(buf.tensors)
        if self._pre is not None and not self._fused_in_backend:
            regions = [self._pre((r,))[0] for r in regions]
        t0 = time.perf_counter()
        outputs = list(self._invoke_or_raise(
            lambda: f"flexible invoke failed on frame pts={buf.pts} with "
                    f"region shapes {[tuple(r.shape) for r in regions]}",
            self.backend.invoke_flexible, regions))
        if self._post is not None and not self._fused_in_backend:
            outputs = [self._post((o,))[0] for o in outputs]
        if self.props["latency_mode"] == "sync":
            outputs = self._sync_outputs(outputs)
        self._lat_window.append(time.perf_counter() - t0)
        self._invoke_count += 1
        return [(0, buf.with_tensors(tuple(outputs)))]

    # -- compiled steady-state window (scheduler bypass) --------------------
    def window_capable(self) -> bool:
        """Whether the scheduler may serve this element's frames through
        compiled windows. Excluded are the paths whose per-frame behavior
        is not one fixed-shape invoke: FLEXIBLE and micro-batched input
        (their own bucketing), replica routing (a placement decision a
        frame), an armed breaker (per-frame failure accounting), sync
        latency mode (the point is a sync per frame), a segment whose
        members run host side (host Python a frame anyway), and a
        backend without `invoke_window`."""
        return (bool(self.props["compiled_loop"])
                and self.backend is not None
                and hasattr(self.backend, "invoke_window")
                and not self._flexible
                and not self._dyn_batched
                and self.replicas is None
                and self._breaker is None
                and self.props["latency_mode"] != "sync"
                and not (self._member_stages
                         and not self._segment_in_backend))

    def swap_pending(self) -> bool:
        """A reload this backend has not taken up yet (through another
        holder of its shared key): the scheduler bails the window (cause
        "swap") so the new model is adopted at a per-frame invoke."""
        fn = getattr(self.backend, "swap_pending", None)
        return bool(fn()) if fn is not None else False

    def process_window(self, pad: int,
                       bufs: List[TensorBuffer]) -> List[Emission]:
        """K same-signature frames through ONE backend `invoke_window`.
        Combinations and host-side chains apply per frame exactly as
        `process()` applies them, so outputs are bit for bit those of K
        `process` calls; only the launches change. A raise leaves all K
        frames to the scheduler, which re-runs them per frame so the
        error lands on the precise frame that faulted."""
        frames = []
        for buf in bufs:
            inputs = buf.tensors
            if self._in_combination is not None:
                inputs = tuple(inputs[i] for i in self._in_combination)
            if self._pre is not None and not self._fused_in_backend:
                inputs = self._pre(inputs)
            frames.append(tuple(inputs))
        t0 = time.perf_counter()
        outs = self.backend.invoke_window(frames)
        per = (time.perf_counter() - t0) / len(bufs)
        emissions: List[Emission] = []
        for buf, outputs in zip(bufs, outs):
            if self._post is not None and not self._fused_in_backend:
                outputs = self._post(outputs)
            self._lat_window.append(per)
            self._invoke_count += 1
            if self._out_combination is not None:
                outputs = tuple(buf.tensors[idx] if kind == "i"
                                else outputs[idx]
                                for kind, idx in self._out_combination)
            emissions.append((0, buf.with_tensors(tuple(outputs))))
        return emissions

    # -- stats (the reference's latency/throughput props) ------------------
    @property
    def latency_us(self) -> float:
        """Average invoke latency, µs, over the last 10 (prop `latency`)."""
        if not self._lat_window:
            return 0.0
        return 1e6 * sum(self._lat_window) / len(self._lat_window)

    @property
    def throughput(self) -> float:
        """Frames invoked a second since start (prop `throughput`)."""
        if not self._invoke_count or self._t_start is None:
            return 0.0
        dt = time.monotonic() - self._t_start
        return self._invoke_count / dt if dt > 0 else 0.0

    def reload_model(self, model) -> None:
        """Hot swap (is-updatable + model property update)."""
        if not self.props["is_updatable"]:
            raise PipelineError(
                f"tensor_filter {self.name} is not reloadable; construct it "
                f"with is-updatable=true to allow hot model swaps")
        self.backend.reload(model)


def np_shape(x):
    """The shape of an array, a tensor or anything numpy can read."""
    import numpy as np

    return x.shape if hasattr(x, "shape") else np.asarray(x).shape

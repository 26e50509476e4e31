"""Torch backend — the model-execution engine (counterpart of the JAX
package's backends/xla.py), registered as ``torch`` and as ``xla`` so
reference pipeline strings run verbatim.

A model is a callable ``fn(params, *inputs) -> outputs`` plus its params
(an ``nn.Module``, a dict of tensors, or None). Sources of models:

- the in-repo model zoo (``model=zoo://mobilenet_v2``) — models/zoo.py
- a model file (``model=x.tflite``, ``m.npz``, ``g.pb``, ``n.caffemodel``,
  ``init.pb,predict.pb``, ``l.uff``, ``a.dlc``, ``m.rtm``) through
  modelio.load_model_file, with the ``custom=`` loader options
- a `ModelBundle` or a callable passed programmatically to the element

Filters with the same `shared_tensor_filter_key` hold one model on one
device (the reference's shared-tensor-filter-key,
tensor_filter_common.c:2911-3046): the first open builds it and moves
its params there, later opens take a holder, the last close frees it.
Every holder must ask for the same model and device.

The backend runs eagerly on its device (`pick_device`). Fused pre/post
chains run on the device around the model, after staging, so a uint8
frame crosses to the device as uint8. A bundle's `host_pre` (the
GraphDef DecodeWav entry) runs on the host before staging, once a frame:
in `run`, per frame of a window before its copy into the graph's inputs,
per frame where a micro-batch gives way to one invoke a frame; the
FLEXIBLE path refuses it. `invoke` returns without waiting
for the device; the sink or host decoder that reads the result is the
sync point.

Micro-batches (tensor_batch upstream) run as ONE call per batch, the
occupancy padded up to the next power of two with copies of the last
row and the pad rows sliced off the outputs (`invoke_batched`). FLEXIBLE
buffers (tensor_crop regions) run one call per group of same-shape
regions, padded the same way, and with ``custom=dynamic_spatial=true``
their H and W zero-padded up to powers of two >= 16
(`invoke_flexible`). Whether a model takes a batched shape is decided
once per (shapes, dtypes) by running it on ``meta`` tensors (no data,
no device work); a model that refuses runs per frame (per region)
instead. Nothing compiles, so where the JAX package counts compiles per
bucket, `bucket_shapes` holds the distinct bucket shapes that ran.

`reload` stages the new model on the device before it drops the old
one; filters sharing a key pick a reload up at their next invoke
(`swap_pending` says one is waiting). The model held is one tuple
(bundle, params, serial) swapped in one store, and every invoke reads it
once (`_held`), so a reload from another thread never splits an invoke
or a window between two models; what was derived from the model before
(batchability verdicts, captured graphs) is dropped by the invoking
thread at its next invoke, never by the reloading one.

Compiled windows (`invoke_window`, the scheduler's steady-state loop):
K same-signature frames run as K per-frame calls — the fused pre chain,
the model, the fused post chain, each at the frame's own shape, so the
outputs are bit for bit those of K invokes. On the CPU the K calls run
eagerly. On the card the first window of a (K, input signature) runs
them eagerly (the warm-up a capture needs) and captures them into one
CUDA graph (backends/cuda_graphs.py); later windows copy their frames
into its static inputs, replay it once and clone its outputs, since the
scheduler keeps emitted outputs in flight past the next replay. The
graphs of one backend are those of the model serial it holds and share
one memory pool (`cuda_graphs.GraphCache`); a reload drops them (each
holds the params it baked in until then); a capture that fails raises,
and its key is remembered so the next window raises at once, before it
stages its frames (the scheduler's "error" bail runs them per frame).

``store://`` models (serving/store.py) are bound to the process-wide
model store instead of held alone: the backend attaches as a swap handle
and keeps one `_VState` per live version — the version's bundle, its
params on the device, its held-model tuple and its own `GraphCache`.
Every fixed-shape invoke, micro-batch and compiled window picks its
version at its start (`_pick_version`): the pinned one (``@3``,
``@alias``), the canary at its seeded ratio (``@2:0.05``, the filter's
``canary_seed``; one draw an invoke and one a window, as the JAX
package draws), or the tracked current, adopting a flipped epoch first
(`_adopt`, on the invoking thread). A swap's `prewarm_version` stages
the incoming version's params on the device and runs it once on every
bucket shape this backend has served, off the hot path — a version that
refuses one aborts the swap before the flip. Graphs are kept by version
for the live set only (current, canary, pinned): a canary's windows
replay the graph of the version they picked, and a version's graphs go
when it leaves the set, as the JAX package drops its compiled buckets.
`warm_start` replays the persistent bucket manifest
(serving/compile_cache.py) at element start. Each invoke records its
host time under its version (`version_stats`); a window records K
invokes of dt/K each.

With the session tracer active each invoke is one backend "invoke" span
(`FilterBackend.invoke`), each batched invoke one "invoke_batched" span
with its occupancy and bucket; there is no "compile" span: nothing
compiles. `compile_count` counts what stands in for a compile: the first
run of a (model, bucket) and each CUDA graph captured.

Device segments (graph/optimize.fuse_segments): `compose_segment`
accepts the filters absorbed downstream of this one — member backends
that are `TorchBackend`s on this backend's device (and logical ordinal),
with no canary and no host-side input stage — and one invoke then runs
the pre chain, this model, each connecting chain and member model, and
the post chain (a compiled window captures all of it in one CUDA graph).
Anything else is declined, as the JAX package declines it, and the
element runs the member invokes itself with the same bits. Each invoke
boundary (`_seg_begin`) adopts the members' flipped store epochs and
takes their held models; a change retires the graphs that baked in the
old ones.

Logical devices (``[parallel] virtual_devices``): a backend opened with
``accelerator=<type>:<ordinal>`` knows its `device_ordinal` and tags its
outputs with it; an input tagged with another ordinal is copied on
staging even where the two ordinals share a card (a plan stage's
handoff, counted in `staging_transfers`, as a second card would copy).

The device profiler (runtime/devprof.py), when on, gets each bucket's
first run (its FLOPs under FlopCounterMode, params and I/O bytes, host
seconds) and a pair of CUDA events around every invoke and window.
"""

from __future__ import annotations

import copy
import itertools
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.backends import cuda_graphs
from nnstreamer_tpu_torch.backends.base import (
    ArrayTuple, ElementwiseFn, FilterBackend, pick_device, register_backend)
from nnstreamer_tpu_torch.core.errors import BackendError, SegmentStageError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.modelio import parse_loader_opts
from nnstreamer_tpu_torch.runtime import devprof
from nnstreamer_tpu_torch.runtime.sync import device_sync
from nnstreamer_tpu_torch.tensor.dtypes import DType, host_tensor
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

log = get_logger("backend.torch")


@dataclass
class ModelBundle:
    """A loadable model: function + params + optional fixed specs."""

    fn: Callable[..., Any]            # fn(params, *inputs) -> output(s)
    params: Any = None                # nn.Module | dict of tensors | None
    in_spec: Optional[TensorsSpec] = None
    out_spec: Optional[TensorsSpec] = None
    name: str = ""
    #: optional host-side input stage, run on each frame's tensors before
    #: staging: for inputs that are bytes to parse, not tensor math (the
    #: GraphDef DecodeWav entry decodes the RIFF header here and the PCM
    #: samples go to the device)
    host_pre: Optional[Callable[[tuple], tuple]] = None


@dataclass
class _SharedEntry:
    """One model held on one device by every filter sharing its key."""

    bundle: ModelBundle
    params: Any
    device: torch.device
    model_ref: Optional[str]
    holders: int = 0
    #: bumped by every reload; a holder re-reads bundle and params when
    #: its copy of the version is stale
    version: int = 0


@dataclass
class _VState:
    """One store version resident in this backend: the held-model tuple
    an invoke runs (bundle, params on the device, serial) and the CUDA
    graphs captured from it."""

    version: int
    model: Tuple[ModelBundle, Any, int]
    graphs: cuda_graphs.GraphCache = field(
        default_factory=cuda_graphs.GraphCache)


_shared_models: Dict[str, _SharedEntry] = {}
_shared_lock = threading.Lock()
#: one serial per model a backend takes up (process-wide: two models held
#: one after the other never share one)
_model_serials = itertools.count(1)


def next_pow2(n: int, floor: int = 1) -> int:
    v = max(n, floor)
    return 1 << (v - 1).bit_length()


def params_on_meta(params):
    """A copy of a model's params on the ``meta`` device (shapes and
    dtypes, no storage): an nn.Module deep-copied with every parameter
    and buffer swapped for a meta tensor (the original is not touched,
    so a holder may go on running it), a (nested) dict or list of
    tensors by copy."""
    if isinstance(params, torch.nn.Module):
        memo = {}
        for t in itertools.chain(params.parameters(), params.buffers()):
            m = torch.empty_like(t, device="meta")
            memo[id(t)] = (torch.nn.Parameter(m, requires_grad=False)
                           if isinstance(t, torch.nn.Parameter) else m)
        return copy.deepcopy(params, memo)
    if isinstance(params, torch.Tensor):
        return torch.empty_like(params, device="meta")
    if isinstance(params, dict):
        return {k: params_on_meta(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_on_meta(v) for v in params)
    return params


def pad_rows(x: torch.Tensor, n: int, nb: int) -> torch.Tensor:
    """Pad axis 0 from n to nb rows with copies of the last row: real
    data keeps the pad lanes tame, and they are sliced off before anyone
    sees them (BN runs in eval mode: no row sees another)."""
    if nb <= n:
        return x
    return torch.cat([x, x[-1:].expand((nb - n,) + tuple(x.shape[1:]))])


def to_tuple(x) -> Tuple:
    if isinstance(x, tuple):
        return x
    if isinstance(x, list):
        return tuple(x)
    return (x,)


def params_to(params, device: torch.device):
    """Move a model's params to `device`: an nn.Module in place (and into
    eval mode), a (nested) dict, list or tuple of tensors by copy."""
    if isinstance(params, torch.nn.Module):
        return params.to(device).eval()
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return params


def params_copy_to(params, device: torch.device):
    """`params_to` for params held by someone else (a model store
    version every handle shares): an nn.Module with any parameter or
    buffer off `device` is deep-copied before it moves, so the owner's
    module stays where it was; a tree of tensors moves by copy anyway."""
    if isinstance(params, torch.nn.Module) and any(
            t.device != device
            for t in itertools.chain(params.parameters(), params.buffers())):
        params = copy.deepcopy(params)
    return params_to(params, device)


def tree_bytes(params) -> int:
    """Bytes of every tensor in a model's params (an nn.Module's
    parameters and buffers, or a nested dict/list of tensors)."""
    if isinstance(params, torch.nn.Module):
        return sum(t.numel() * t.element_size() for t in itertools.chain(
            params.parameters(), params.buffers()))
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_bytes(v) for v in params)
    return 0


def bucket_pairs(xs) -> tuple:
    """((shape, dtype name), ...) of staged tensors: a bucket key's
    tensor part, in the JAX package's spelling ("float32", "uint8")."""
    return tuple((tuple(x.shape), DType.of(x).type_name) for x in xs)


#: the attribute naming the logical ordinal of the backend that made a
#: tensor (set on the outputs of a backend pinned to one)
ORDINAL_TAG = "_nns_ordinal"


def stage(arrs, device: torch.device,
          ordinal: Optional[int] = None) -> Tuple[ArrayTuple, int]:
    """Move inputs to `device`, skipping tensors already there. Host
    numpy crosses in its own dtype (a uint8 frame stays 1 byte/element).
    A strided view already on the device (a tensor_split segment, a
    transposed tensor) is made contiguous, as a host array is on its way
    over: the model then sees one layout whether a frame runs alone or
    is copied into a compiled window's static input, so the two give the
    same bits. A tensor another logical device's backend made (its
    ORDINAL_TAG not `ordinal`) is copied even on the same card.
    → (staged tensors, number of transfers made)."""
    staged = []
    transfers = 0
    for a in arrs:
        if isinstance(a, torch.Tensor) and a.device == device:
            src = getattr(a, ORDINAL_TAG, None)
            if ordinal is not None and src is not None and src != ordinal:
                staged.append(a.clone(memory_format=torch.contiguous_format))
                transfers += 1
            else:
                staged.append(a.contiguous())
            continue
        t = a if isinstance(a, torch.Tensor) else host_tensor(a)
        staged.append(t.to(device, non_blocking=True))
        transfers += 1
    return tuple(staged), transfers


@register_backend("torch", "xla")
class TorchBackend(FilterBackend):
    def __init__(self):
        #: (bundle, params, serial) of the model held, replaced whole
        self._model: Tuple[Optional[ModelBundle], Any, int] = (None, None, 0)
        self._shared: Optional[_SharedEntry] = None
        self._shared_key = ""
        self._pre: Optional[ElementwiseFn] = None
        self._post: Optional[ElementwiseFn] = None
        self._version = 0                 # of the shared entry held
        self.device: Optional[torch.device] = None
        #: the logical ordinal of ``accelerator=<type>:<i>`` (None: the
        #: filter did not pin one)
        self.device_ordinal: Optional[int] = None
        self._dynamic_spatial = False
        self._loader_opts: Dict[str, Any] = {}
        # batchability verdicts by (model serial, batched shapes and
        # dtypes), and the params on the meta device they are taken with
        # (by serial); `batch_verdicts` counts the verdicts taken
        self._batch_ok: Dict[tuple, bool] = {}
        self._metas: Dict[int, Any] = {}
        self.batch_verdicts = 0
        # inputs that were already on the device skip the copy
        self.staging_transfers = 0
        self.staging_elided = 0
        #: micro-batch occupancies served in one call ({n: invokes})
        self.batch_size_hist: Dict[int, int] = {}
        #: distinct bucket shapes run by invoke_batched/invoke_flexible
        #: (the JAX package's compile_count counts one compile for each)
        self.bucket_shapes: set = set()
        #: ((row shape, dtype name), ...) of the last batched micro-batch
        #: (stage_bucket runs another occupancy bucket of it)
        self._last_dynb: Optional[tuple] = None
        #: compiled windows served and the frames they served (the JAX
        #: package's names)
        self.window_invokes = 0
        self.window_frames = 0
        # (K, input signature) → graph, for the model serial held; its
        # version is also that of `_batch_ok` and `_meta`
        self._graphs = cuda_graphs.GraphCache()
        # -- store:// serving (serving/store.py handle protocol) --------
        self._store_entry = None
        self._pinned_version: Optional[int] = None
        self._adopted_version: Optional[int] = None
        #: the store epoch this handle serves (the swap barrier reads it)
        self.adopted_epoch = 0
        self._canary: Optional[Tuple[int, float]] = None
        self._canary_rng: Optional[random.Random] = None
        #: the live versions: current (or pinned) and the canary's
        self._vstates: Dict[int, _VState] = {}
        #: version → vstate staged by prewarm_version, installed at adopt
        self._staged: Dict[int, _VState] = {}
        #: bucket keys served (prewarm and the manifest replay these)
        self._served: Dict[tuple, bool] = {}
        #: captures and their seconds of graph caches already dropped
        self._retired_captures = 0
        self._retired_capture_seconds: List[float] = []
        #: epoch adoptions (the JAX package's swap_count)
        self.swap_count = 0
        #: buckets the last warm_start ran (the bucket manifest's replay)
        self.warm_start_buckets = 0
        #: (model serial, bucket label) pairs run once: a first run is
        #: what stands in for the JAX package's compile
        self._ran: set = set()
        # -- device segment (compose_segment) -----------------------------
        #: [(mid chain | None, member TorchBackend, member name)]
        self._segment: List[tuple] = []
        #: the members' held models this invoke, and their serials
        self._seg_models: tuple = ()
        self._seg_sig: tuple = ()

    @property
    def _bundle(self) -> Optional[ModelBundle]:
        return self._model[0]

    @property
    def _params(self):
        return self._model[1]

    @property
    def _meta(self):
        """The held model's params on the meta device (once a verdict
        has been taken on it)."""
        return self._metas.get(self._model[2])

    def _graph_caches(self) -> List[cuda_graphs.GraphCache]:
        return [self._graphs] + [vs.graphs for vs in self._vstates.values()]

    @property
    def window_compile_count(self) -> int:
        """CUDA graphs captured (the JAX package's name)."""
        return self._retired_captures + sum(
            g.captures for g in self._graph_caches())

    @property
    def compile_count(self) -> int:
        """First runs of a (model, bucket) and CUDA graphs captured."""
        return len(self._ran) + self.window_compile_count

    @property
    def capture_seconds(self) -> List[float]:
        """Each capture's host seconds."""
        return self._retired_capture_seconds + [
            s for g in self._graph_caches() for s in g.capture_seconds]

    def _hold(self, bundle: ModelBundle, params) -> None:
        self._model = (bundle, params, next(_model_serials))

    def open(self, props: Dict[str, Any]) -> None:
        model = props.get("model")
        if model is None:
            raise BackendError(
                "framework=torch requires model=<zoo://name | model file | "
                "ModelBundle | callable>")
        opts = parse_loader_opts(props.get("custom") or "")
        self._dynamic_spatial = bool(opts.pop("dynamic_spatial", False))
        # the reference's dedicated props override the custom= string
        for prop, key in (("inputname", "input_names"),
                          ("outputname", "output_names")):
            v = props.get(prop) or ""
            if v:
                opts[key] = [s for s in v.split(",") if s]
        #: options for a model-file loader (modelio.load_model_file)
        self._loader_opts = opts
        accel = str(props.get("accelerator") or "")
        self.device = pick_device(accel)
        idx = accel.partition(":")[2].strip()
        self.device_ordinal = int(idx) if idx.isdigit() else None
        key = props.get("shared_tensor_filter_key") or ""
        if isinstance(model, str) and model.startswith("store://"):
            if key:
                raise BackendError(
                    "store:// models are already process-shared through "
                    "the model store; shared-tensor-filter-key cannot "
                    "combine with a store reference — drop the key")
            self._open_store(model, props)
            return
        if key:
            self._open_shared(key, model)
            return
        bundle = self._resolve(model)
        self._hold(bundle, params_to(bundle.params, self.device))
        log.info("opened model %s on %s", bundle.name or model, self.device)

    def _open_shared(self, key: str, model) -> None:
        ref = model if isinstance(model, str) else None
        with _shared_lock:
            entry = _shared_models.get(key)
            if entry is None:
                bundle = self._resolve(model)
                entry = _SharedEntry(bundle, params_to(bundle.params,
                                                       self.device),
                                     self.device, ref)
                _shared_models[key] = entry
            elif entry.device != self.device:
                raise BackendError(
                    f"shared-tensor-filter-key {key!r} is held on "
                    f"{entry.device} but this filter asked for "
                    f"{self.device}; use a different key per device")
            elif ref is not None and entry.model_ref is not None \
                    and ref != entry.model_ref:
                raise BackendError(
                    f"shared-tensor-filter-key {key!r} already holds model "
                    f"{entry.model_ref!r}; this filter asked for {ref!r} "
                    f"(same key, same model)")
            entry.holders += 1
            self._shared, self._shared_key = entry, key
            self._hold(entry.bundle, entry.params)
            self._version = entry.version
        log.info("opened shared model key=%s holders=%d on %s", key,
                 entry.holders, self.device)

    def _resolve(self, model) -> ModelBundle:
        if isinstance(model, ModelBundle):
            return model
        if isinstance(model, str) and model.startswith("store://"):
            raise BackendError(
                f"{model!r} resolves through the ModelStore at open(); "
                f"store refs cannot nest as version sources — register "
                f"the underlying model instead")
        if isinstance(model, str) and model.startswith("zoo://"):
            from nnstreamer_tpu_torch.models.zoo import build_model

            return build_model(model[len("zoo://"):])
        if isinstance(model, str):
            from nnstreamer_tpu_torch import modelio

            if modelio.model_ext(model) in modelio.MODEL_EXTENSIONS \
                    or "," in model:
                return modelio.load_model_file(model, **self._loader_opts)
        if callable(model):
            return ModelBundle(fn=lambda params, *xs: model(*xs),
                               in_spec=getattr(model, "in_spec", None),
                               out_spec=getattr(model, "out_spec", None),
                               name=getattr(model, "__name__", "callable"))
        raise BackendError(
            f"unrecognized model reference {model!r} for framework=torch; "
            f"expected zoo://<name>, a model file (.tflite, .npz, .pb, "
            f".caffemodel, init,predict .pb pair, .uff, .dlc, .rtm), a "
            f"ModelBundle, or a callable")

    def close(self) -> None:
        """Drop this filter's hold on its model (idempotent). A store
        handle detaches but keeps its entry: version_stats() stays
        readable for post-stop reports."""
        if self._store_entry is not None:
            self._store_entry.detach(self)
            for vs in self._vstates.values():
                self._retire(vs)
            self._vstates.clear()
            self._staged.clear()
        if self._shared is not None:
            with _shared_lock:
                self._shared.holders -= 1
                if self._shared.holders <= 0:
                    _shared_models.pop(self._shared_key, None)
            self._shared = None
        self._model = (self._bundle, None, next(_model_serials))
        self._graphs.use(None)

    def get_model_info(self):
        return self._bundle.in_spec, self._bundle.out_spec

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        """Infer the model's output spec by running the bare model once on
        zeros of `in_spec` on the target device (fused chains do not take
        part: `in_spec` is already what the model sees)."""
        bundle, params, _ = self._model
        zeros = [torch.zeros(t.shape, dtype=t.dtype.torch_dtype,
                             device=self.device) for t in in_spec.tensors]
        try:
            with torch.inference_mode():
                out = to_tuple(bundle.fn(params, *zeros))
        except Exception as e:
            raise BackendError(
                f"model {bundle.name!r} does not accept input "
                f"{in_spec}: {e}") from e
        return TensorsSpec(tensors=tuple(
            TensorInfo(tuple(o.shape), DType.of(o)) for o in out))

    def fuse(self, pre: Optional[ElementwiseFn],
             post: Optional[ElementwiseFn]) -> bool:
        self._pre, self._post = pre, post
        return True

    # -- device segment (graph/optimize.fuse_segments) ---------------------
    def compose_segment(self, stages) -> bool:
        """Accept a device segment: `stages` is [(mid chain | None,
        member backend, member name)] in dataflow order. Accepting means
        each member's model runs inside this backend's invoke, between
        this model and the post chain — one invoke (one graph replay in
        a window) for the whole run. Declined, as the JAX package
        declines it, when a member cannot ride one invoke: not a torch
        backend, another device or logical ordinal, per-invoke canary
        routing, or a host-side input stage; the element then invokes the
        members itself, with the same bits."""
        for _, mb, mname in stages:
            if not isinstance(mb, TorchBackend):
                log.info("segment declined: member %s is not torch", mname)
                return False
            if (mb.device, mb.device_ordinal) != (self.device,
                                                  self.device_ordinal):
                log.info("segment declined: member %s is on %s (ordinal "
                         "%s), head on %s (ordinal %s)", mname, mb.device,
                         mb.device_ordinal, self.device, self.device_ordinal)
                return False
            if mb._canary is not None:
                log.info("segment declined: member %s has canary "
                         "routing", mname)
                return False
            if any(vs.model[0].host_pre is not None
                   for vs in mb._vstates.values()) or (
                    mb._bundle is not None
                    and mb._bundle.host_pre is not None):
                log.info("segment declined: member %s model has a "
                         "host-side input stage", mname)
                return False
        self._segment = list(stages)
        self._seg_begin()
        return True

    def _seg_begin(self) -> None:
        """Segment-invoke boundary: adopt the members' flipped store
        epochs and take their held models for this invoke. A member that
        changed model (a swap, a reload) changes the signature, which
        retires the graphs and verdicts that baked in the old one."""
        if not self._segment:
            return
        models = []
        for _, mb, _ in self._segment:
            if mb._store_entry is not None:
                models.append(mb._vstates[mb._pick_version()].model)
            else:
                models.append(mb._held())
        sig = tuple(m[2] for m in models)
        if sig != self._seg_sig:
            if self._seg_sig:
                for g in self._graph_caches():
                    g.drop()
            self._seg_sig = sig
        self._seg_models = tuple(models)

    def _adopt_shared(self) -> None:
        """Take up a reload made through another holder of the shared
        key (at an invoke boundary: one invoke never mixes two models)."""
        sh = self._shared
        if sh is not None and sh.version != self._version:
            with _shared_lock:
                self._hold(sh.bundle, sh.params)
                self._version = sh.version

    def _held(self) -> Tuple[ModelBundle, Any, int]:
        """The model an invoke runs, read once at its start (after taking
        up a shared reload, or a flipped store epoch: the adopted
        version, no canary draw). What was derived from an earlier model —
        batchability verdicts, the meta copy, captured graphs — is
        dropped here, on the invoking thread."""
        if self._store_entry is not None:
            self._maybe_adopt()
            return self._model
        self._adopt_shared()
        model = self._model
        if self._graphs.use(model[2]):
            self._batch_ok.clear()
            self._metas.clear()
        return model

    def swap_pending(self) -> bool:
        """A reload through another holder of the shared key, or a store
        epoch flip, that this backend has not taken up yet (the compiled
        loop's "swap" bail: adoption then happens at a per-frame invoke
        boundary)."""
        if any(mb.swap_pending() for _, mb, _ in self._segment):
            return True
        if self._store_entry is not None:
            if self._pinned_version is not None:
                return False
            return self._store_entry.state[1] != self.adopted_epoch
        sh = self._shared
        return sh is not None and sh.version != self._version

    def _stage(self, tensors) -> ArrayTuple:
        if self.device_ordinal is None:
            xs, transfers = stage(tensors, self.device)
        else:
            xs, transfers = stage(tensors, self.device, self.device_ordinal)
        self.staging_transfers += transfers
        self.staging_elided += len(xs) - transfers
        return xs

    def _tag(self, out: ArrayTuple) -> ArrayTuple:
        """Mark outputs with this backend's logical ordinal (pinned
        backends only), so a backend on another ordinal stages a copy."""
        if self.device_ordinal is not None:
            for o in out:
                if isinstance(o, torch.Tensor):
                    setattr(o, ORDINAL_TAG, self.device_ordinal)
        return out

    def _call(self, xs: ArrayTuple, model) -> ArrayTuple:
        """pre chain, `model` (a `_held` tuple), the segment's member
        stages (this invoke's snapshot of their models), post chain on
        device tensors."""
        bundle, params, _ = model
        with torch.inference_mode():
            if self._pre is not None:
                xs = self._pre(xs)
            out = to_tuple(bundle.fn(params, *xs))
            if self._segment:
                out = self._run_segment(out, self._seg_models)
            if self._post is not None:
                out = to_tuple(self._post(out))
        return out

    def _run_segment(self, out: ArrayTuple, models: tuple) -> ArrayTuple:
        """Each member's connecting chain and model, in dataflow order; a
        failure names the member element."""
        for (mid, _, name), m in zip(self._segment, models):
            try:
                if mid is not None:
                    out = to_tuple(mid(out))
                out = to_tuple(m[0].fn(m[1], *out))
            except Exception as e:
                raise SegmentStageError(name, e) from e
        return out

    # -- device profiler hooks (runtime/devprof.py) -----------------------
    def _prof_label(self) -> str:
        """The profiler's filter label: the element's trace name, else
        the store model's name, else the bundle's."""
        if self.trace_name:
            return self.trace_name
        if self._store_entry is not None:
            return self._store_entry.name
        b = self._bundle
        return b.name if b is not None and b.name else "torch"

    def _invoke_call(self, xs: ArrayTuple, model, label: str) -> ArrayTuple:
        """`_call` with the first-run record (`compile_count`) and the
        profiler's hooks: a (model, bucket)'s first run is counted under
        FlopCounterMode, every later one sampled by CUDA events."""
        key = (model[2], self._seg_sig, label)
        prof = devprof.get()
        if key not in self._ran:
            self._ran.add(key)
            if prof.enabled:
                prof.attach_model(self._prof_label(), self)
                return prof.capture_cost(
                    self._prof_label(), label,
                    lambda: self._call(xs, model),
                    params=(model[1],) + tuple(m[1] for m in
                                               self._seg_models),
                    inputs=xs)
        if not prof.enabled:
            return self._call(xs, model)
        prof.note_dispatch(self._prof_label(), label, self.device)
        out = self._call(xs, model)
        prof.note_launched()
        return out

    def run(self, tensors: ArrayTuple) -> ArrayTuple:
        self._seg_begin()
        if self._store_entry is not None:
            return self._tag(self._run_store(tensors))
        model = self._held()
        if model[0].host_pre is not None:
            tensors = tuple(model[0].host_pre(tuple(tensors)))
        return self._tag(self._invoke_call(self._stage(tensors), model,
                                           "static"))

    def _batchable(self, sig: Tuple[Tuple[tuple, torch.dtype], ...],
                   model=None) -> bool:
        """Does the model (with its fused chains) take inputs of these
        (shape, dtype)s, batch axis first, and give every output that
        batch axis? Decided on the meta device — shapes only, nothing
        runs on the card — and cached per signature, as the JAX package
        caches its eval_shape verdict. `model`: a `_held` tuple (the one
        held by default)."""
        model = model or self._model
        bundle, _, serial = model
        ok = self._batch_ok.get((serial, self._seg_sig, sig))
        if ok is None:
            try:
                xs = tuple(torch.empty(shape, dtype=dt, device="meta")
                           for shape, dt in sig)
                with torch.inference_mode():
                    if self._pre is not None:
                        xs = self._pre(xs)
                    out = to_tuple(bundle.fn(self._meta_of(model), *xs))
                    if self._segment:
                        out = self._run_segment(out, tuple(
                            (m[0], self._meta_of(m), m[2])
                            for m in self._seg_models))
                    if self._post is not None:
                        out = to_tuple(self._post(out))
                nb = sig[0][0][0]
                ok = all(o.dim() >= 1 and o.shape[0] == nb for o in out)
            except Exception as e:
                log.info("model %s takes no batched input %s (%s): it runs "
                         "per frame", bundle.name, sig, e)
                ok = False
            self.batch_verdicts += 1
            self._batch_ok[(serial, self._seg_sig, sig)] = ok
        return ok

    def _meta_of(self, model):
        """A held model's params on the meta device, by serial."""
        meta = self._metas.get(model[2])
        if meta is None:
            meta = self._metas[model[2]] = params_on_meta(model[1])
        return meta

    def invoke_batched(self, tensors: ArrayTuple, n: int,
                       keepdims: Sequence[bool] = ()) -> ArrayTuple:
        """One call per micro-batch: `n` padded to the next power of two
        (copies of the last row), the pad rows sliced off the outputs, so
        ragged occupancies run at most log2(max_batch) + 1 shapes. A
        model that refuses the batched shape runs per frame (the base
        path), and so does a model with a host-side input stage: it parses
        each frame's bytes and has no batched form. A store model picks
        one version for the whole micro-batch (the canary's granularity
        is the buffer)."""
        self._seg_begin()
        ver = None
        if self._store_entry is not None:
            ver = self._pick_version()
            model = self._vstates[ver].model
        else:
            model = self._held()
        if model[0].host_pre is not None:
            return super().invoke_batched(tensors, n, keepdims)
        xs = self._stage(tensors)
        nb = next_pow2(n)
        sig = tuple(((nb,) + tuple(x.shape[1:]), x.dtype) for x in xs)
        if not self._batchable(sig, model):
            return super().invoke_batched(xs, n, keepdims)
        self.batch_size_hist[n] = self.batch_size_hist.get(n, 0) + 1
        self.bucket_shapes.add(("dynb", nb) + tuple(s for s, _ in sig))
        self._last_dynb = tuple((tuple(x.shape[1:]), DType.of(x).type_name)
                                for x in xs)
        tr = self.tracer
        t0 = time.perf_counter() if tr.active or ver is not None else 0.0
        padded = tuple(pad_rows(x, n, nb) for x in xs)
        label = f"dynb:{nb}"
        if ver is not None:
            self._note_bucket(ver, ("dynb", nb) + bucket_pairs(padded))
            try:
                out = self._invoke_call(padded, model, label)
            except Exception:
                self._record_invoke(ver, t0, error=True)
                raise
            self._record_invoke(ver, t0)
        else:
            out = self._invoke_call(padded, model, label)
        out = self._tag(tuple(o[:n] for o in out))
        if tr.active:
            tr.backend_span(self.trace_name or self.BACKEND_NAME,
                            "invoke_batched", t0, time.perf_counter(), n=n,
                            bucket=nb)
        return out

    def invoke_flexible(self, regions: Sequence[Any]) -> List[Any]:
        """Per-buffer variable-shape regions (tensor_crop output) with a
        bounded set of bucket shapes: same-shape regions stacked (or
        concatenated, leading dim 1) into one call, padded to a
        power-of-two batch; with custom=dynamic_spatial=true, H and W
        (the axes before the last) zero-padded first to powers of two
        >= 16, which suits shape-polymorphic models whose output does not
        see the padding (global-pool classifiers). A model that refuses
        the batched shape runs region by region. A model with a host-side
        input stage is refused (the JAX package's text)."""
        self._seg_begin()
        model = self._held()
        if model[0].host_pre is not None:
            raise BackendError(
                f"model {model[0].name!r} has a host-side input stage "
                f"(host_pre) which the flexible-shape path does not "
                f"support; use the fixed-shape invoke path")
        rs = self._stage(regions)
        out: List[Any] = [None] * len(rs)
        groups: Dict[tuple, List[int]] = {}
        for i, r in enumerate(rs):
            groups.setdefault(tuple(r.shape), []).append(i)
        for shape, idxs in groups.items():
            arrs = [rs[i] for i in idxs]
            if self._dynamic_spatial and len(shape) >= 3:
                ph = next_pow2(shape[-3], 16) - shape[-3]
                pw = next_pow2(shape[-2], 16) - shape[-2]
                if ph or pw:
                    arrs = [F.pad(a, (0, 0, 0, pw, 0, ph)) for a in arrs]
                    shape = tuple(arrs[0].shape)
            n, nb = len(arrs), next_pow2(len(arrs))
            stacked = shape[0] != 1
            batched = ((nb,) + shape) if stacked else ((nb,) + shape[1:])
            if not self._batchable(((batched, arrs[0].dtype),), model):
                self.bucket_shapes.add(("seq",) + shape)
                for i, a in zip(idxs, arrs):
                    out[i] = self._call((a,), model)[0]
                continue
            self.bucket_shapes.add(("bat", nb) + shape)
            block = (torch.stack if stacked else torch.cat)(arrs, 0)
            res = self._call((pad_rows(block, n, nb),), model)[0]
            for k, i in enumerate(idxs):
                out[i] = res[k] if stacked else res[k:k + 1]
        return list(self._tag(tuple(out)))

    def reload(self, model: Any) -> None:
        """Hot model swap (is-updatable): the new model is resolved and
        its params staged on the device before the old ones are dropped.
        Through a shared key it updates the shared entry, so every holder
        takes it up at its next invoke. May run on another thread than
        the invokes: it only swaps the model held (see `_held`)."""
        if self._store_entry is not None:
            raise BackendError(
                f"this filter serves {self._store_entry.name!r} through the "
                f"model store; per-filter reload would fork it from the "
                f"registry — register the new weights as a version and "
                f"ModelStore.update({self._store_entry.name!r}, <version>) "
                f"instead (or `python -m nnstreamer_tpu_torch models "
                f"swap`)")
        bundle = self._resolve(model)
        params = params_to(bundle.params, self.device)
        if self._shared is not None:
            with _shared_lock:
                self._shared.bundle = bundle
                self._shared.params = params
                self._shared.version += 1
            self._adopt_shared()
            return
        self._hold(bundle, params)

    # -- store:// serving (serving/store.py handle protocol) --------------
    def _open_store(self, model: str, props: Dict[str, Any]) -> None:
        """Bind this backend to a served model in the process-wide
        ModelStore: resolve the baseline version, attach as a swap
        handle, and set up canary routing when the ref carries a split
        (``store://name@2:0.05``)."""
        from nnstreamer_tpu_torch.serving.compile_cache import (
            maybe_enable_compile_cache)
        from nnstreamer_tpu_torch.serving.store import (
            get_store, parse_store_ref)

        maybe_enable_compile_cache()
        ref = parse_store_ref(model)
        entry = get_store().entry(ref.name)
        _, epoch = entry.state
        if ref.version is not None:
            self._pinned_version = entry.resolve_version(ref.version)
            base = self._pinned_version
        else:
            base = entry.resolve_version(None)
        self._adopted_version, self.adopted_epoch = base, epoch
        self._vstates[base] = self._make_vstate(base, entry.bundle(base))
        self._model = self._vstates[base].model
        if ref.canary_version is not None:
            cv = entry.resolve_version(ref.canary_version)
            if cv == base:
                raise BackendError(
                    f"canary reference {model!r} routes to the baseline "
                    f"version @{base} itself; pick a different version "
                    f"to canary")
            self._canary = (cv, ref.canary_ratio)
            self._canary_rng = random.Random(
                int(props.get("canary_seed") or 0))
            self._vstates[cv] = self._make_vstate(cv, entry.bundle(cv))
        self._store_entry = entry
        entry.attach(self)
        log.info("opened store model %s@%d epoch=%d%s on %s", ref.name,
                 base, epoch,
                 f" canary=@{self._canary[0]}:{self._canary[1]}"
                 if self._canary else "", self.device)

    @property
    def tracks_store_epoch(self) -> bool:
        """True when this handle follows ``current`` (un-pinned), i.e.
        takes part in the swap barrier."""
        return self._store_entry is not None and self._pinned_version is None

    def _make_vstate(self, version: int, bundle: ModelBundle) -> _VState:
        """`version` resident here: its params on the device (a copy:
        the store's bundle is every handle's) and a serial of its own."""
        vs = _VState(version, (bundle,
                               params_copy_to(bundle.params, self.device),
                               next(_model_serials)))
        vs.graphs.use(vs.model[2])
        return vs

    def _pick_version(self) -> int:
        """Adopt a flipped epoch, then route this invoke: the pinned
        version (immune to swaps), the canary version at its seeded
        ratio, or the tracked current."""
        if self._pinned_version is not None:
            return self._pinned_version
        self._maybe_adopt()
        if (self._canary is not None
                and self._canary_rng.random() < self._canary[1]):
            return self._canary[0]
        return self._adopted_version

    def _maybe_adopt(self) -> None:
        if self._pinned_version is not None:
            return
        cur, epoch = self._store_entry.state    # one read: a consistent pair
        if epoch != self.adopted_epoch:
            self._adopt(cur, epoch)

    def _adopt(self, cur: int, epoch: int) -> None:
        """Flip this backend to the new current version (on the element's
        worker thread, at an invoke boundary): install the state staged
        by `prewarm_version` (or resolve it now), retire the versions
        that left the live set — their params, graphs and batchability
        verdicts — and point the held model at the adopted version, so
        negotiation-era paths (set_input_info, FLEXIBLE invokes) follow."""
        old = self._adopted_version
        staged = self._staged.pop(cur, None)
        if cur not in self._vstates:
            self._vstates[cur] = staged if staged is not None else \
                self._make_vstate(cur, self._store_entry.bundle(cur))
        live = {cur}
        if self._canary is not None:
            live.add(self._canary[0])
        for v in [v for v in self._vstates if v not in live]:
            self._retire(self._vstates.pop(v))
        serials = {vs.model[2] for vs in self._vstates.values()}
        for k in [k for k in self._batch_ok if k[0] not in serials]:
            del self._batch_ok[k]
        for k in [k for k in self._metas if k not in serials]:
            del self._metas[k]
        self._model = self._vstates[cur].model
        self._adopted_version, self.adopted_epoch = cur, epoch
        self.swap_count += 1
        self.tracer.record_swap(
            self.trace_name or self.BACKEND_NAME, time.perf_counter(),
            model=self._store_entry.name, from_version=old, to_version=cur,
            epoch=epoch, prewarmed=staged is not None)
        log.info("adopted %s@%d epoch=%d (from @%s, prewarmed=%s)",
                 self._store_entry.name, cur, epoch, old,
                 staged is not None)

    def _retire(self, vs: _VState) -> None:
        """Drop a version's graphs (and with them the params they baked
        in), keeping their capture counts."""
        self._retired_captures += vs.graphs.captures
        self._retired_capture_seconds += vs.graphs.capture_seconds
        vs.graphs.drop()

    @staticmethod
    def _bucket_array_specs(basekey: tuple):
        """(shape, dtype name) list to materialize a recorded bucket, or
        None for kinds that are not replayed (FLEXIBLE seq/bat)."""
        if basekey[0] == "fix":
            return list(basekey[1:])
        if basekey[0] == "dynb":
            return list(basekey[2:])
        return None

    def _run_bucket(self, model, basekey: tuple) -> bool:
        """Run `model` once on zeros of a recorded bucket, and wait for it
        (off the hot path: a swap's prewarm, the manifest's replay). A
        micro-batch bucket takes its batchability verdict first. False
        for a kind that is not replayed."""
        specs = self._bucket_array_specs(basekey)
        if specs is None:
            return False
        xs = tuple(torch.zeros(s, dtype=DType.from_name(d).torch_dtype,
                               device=self.device) for s, d in specs)
        if basekey[0] == "dynb" and not self._batchable(
                tuple((tuple(x.shape), x.dtype) for x in xs), model):
            raise BackendError(
                f"the model takes no batched input {specs}")
        device_sync(self._call(xs, model), forced=False)
        label = devprof.bucket_label(basekey) if basekey[0] == "fix" \
            else f"dynb:{basekey[1]}"
        self._ran.add((model[2], self._seg_sig, label))
        return True

    def prewarm_version(self, version: int, bundle: ModelBundle) -> int:
        """Stage the incoming version OFF the hot path (on the swap
        controller's thread, before the epoch flips): its params on the
        device, then one run on every bucket shape this backend has
        served (allocator blocks, cuDNN's algorithm choice and the
        batchability verdicts are then in place for the first real
        frame). The worker installs the staged state at adoption. A
        version that rejects a served bucket raises here, aborting the
        swap before anything flips. → buckets run."""
        vs = self._make_vstate(version, bundle)
        warmed = 0
        for basekey in list(self._served):
            try:
                warmed += int(self._run_bucket(vs.model, basekey))
            except Exception as e:
                serial = vs.model[2]
                for k in [k for k in self._batch_ok if k[0] == serial]:
                    self._batch_ok.pop(k, None)
                self._metas.pop(serial, None)
                raise BackendError(
                    f"pre-warm of {self._store_entry.name}@{version} "
                    f"failed on served bucket {basekey[0]} "
                    f"{self._bucket_array_specs(basekey)}: {e} — swap "
                    f"aborted before the epoch flip; the serving version "
                    f"is unchanged") from e
        self._staged[version] = vs
        return warmed

    def warm_start(self) -> int:
        """Replay the persistent manifest's bucket set for the bound
        version (tensor_filter.start(), before any buffer flows): each
        recorded bucket runs once on zeros. A bucket the model no longer
        takes is skipped with a warning: warm start is never a gate.
        → buckets run."""
        if self._store_entry is None:
            return 0
        from nnstreamer_tpu_torch.serving.compile_cache import (
            manifest_buckets)

        self._seg_begin()       # single-threaded (tensor_filter.start)
        ver = self._adopted_version
        vs = self._vstates.get(ver)
        if vs is None:
            return 0
        warmed = 0
        for basekey in manifest_buckets(self._store_entry.name, ver):
            try:
                if not self._run_bucket(vs.model, basekey):
                    continue
            except Exception as e:
                log.warning("warm-start bucket %s skipped: %s",
                            basekey[:2], e)
                continue
            self._served.setdefault(basekey, True)
            warmed += 1
        if warmed:
            log.info("warm start: %d manifest buckets run for %s@%d",
                     warmed, self._store_entry.name, ver)
        self.warm_start_buckets = warmed
        return warmed

    def _note_bucket(self, version: int, basekey: tuple) -> None:
        if basekey not in self._served:
            self._served[basekey] = True
            self._store_entry.note_bucket(version, basekey)

    def version_stats(self) -> Dict[int, dict]:
        """Per-version invoke/error/p95 counters of the bound store entry
        (process-wide across handles), for extra_stats."""
        if self._store_entry is None:
            return {}
        return self._store_entry.stats_dict()

    def _record_invoke(self, version: int, t0: float,
                       error: bool = False) -> None:
        self._store_entry.record(version, time.perf_counter() - t0,
                                 error=error)

    def _run_store(self, tensors: ArrayTuple) -> ArrayTuple:
        """One frame through the store routing point: pick the version
        (adopting a flipped epoch first), run it, record the invoke under
        it. The bucket key carries shapes and dtypes, so a swap can
        prewarm it and the manifest replay it."""
        ver = self._pick_version()
        model = self._vstates[ver].model
        if model[0].host_pre is not None:
            tensors = tuple(model[0].host_pre(tuple(tensors)))
        xs = self._stage(tensors)
        basekey = ("fix",) + bucket_pairs(xs)
        self._note_bucket(ver, basekey)
        t0 = time.perf_counter()
        try:
            out = self._invoke_call(xs, model, devprof.bucket_label(basekey))
        except Exception:
            self._record_invoke(ver, t0, error=True)
            raise
        self._record_invoke(ver, t0)
        return out

    def stage_bucket(self, nb: int) -> bool:
        """Run the pow2 occupancy bucket ``nb`` of the last micro-batch
        signature once, OFF the hot path, on zeros, and register it under
        the bucket keys `invoke_batched` uses (`bucket_shapes`, and the
        store entry's bucket record, so a swap prewarms it and the
        manifest replays it) — the autotuner stages a refined bucket here
        *before* flipping ``tensor_batch``'s ``max_batch``, so the first
        flush at the new size meets cuDNN's algorithm choice, the
        allocator's blocks and the batchability verdict already in place.
        A micro-batch runs eagerly (CUDA graphs are the compiled windows',
        keyed by window), so there is no bucket graph to capture. Called
        from the controller thread: it reads the model held (a store
        handle's adopted version) and never adopts or drops state the
        worker owns. An error is logged and returns False: the bucket
        stays unstaged. → True when the bucket is live (run here or
        already served)."""
        pairs = self._last_dynb
        if pairs is None or nb < 1:
            return False
        nb = next_pow2(int(nb))
        batched = tuple(((nb,) + tuple(s), d) for s, d in pairs)
        shape_key = ("dynb", nb) + tuple(s for s, _ in batched)
        ver = None
        if self._store_entry is not None:
            ver = self._adopted_version
            vs = self._vstates.get(ver)
            if vs is None:
                return False
            model = vs.model
        else:
            model = self._model
        if shape_key in self.bucket_shapes:
            return True
        basekey = ("dynb", nb) + batched
        try:
            self._run_bucket(model, basekey)
        except Exception as e:
            log.warning("stage_bucket(%d) skipped: %s", nb, e)
            return False
        self.bucket_shapes.add(shape_key)
        if ver is not None:
            self._note_bucket(ver, basekey)
        return True

    # -- residency (serving/tenancy.ModelResidency) ------------------------
    def jit_cache_size(self) -> int:
        """What this backend built from its model and could rebuild: the
        CUDA graphs captured and held, and the batched-shape verdicts. A
        model with zero is cold: releasing it again is free."""
        return sum(len(g.graphs) for g in self._graph_caches()) \
            + len(self._batch_ok)

    def release_compiled(self) -> int:
        """Drop the graphs (and their pool) and the verdicts, under
        memory pressure. Params, specs and store attachments stay: the
        next window captures again, the next micro-batch takes its
        verdict again, results are bit for bit unchanged. → entries
        released."""
        n = self.jit_cache_size()
        for g in self._graph_caches():
            g.drop()
        self._batch_ok.clear()
        self._metas.clear()
        return n

    def resident_bytes(self) -> int:
        """Device bytes held by this model's params (every resident store
        version, or the one model held)."""
        if self._vstates:
            return sum(tree_bytes(vs.model[1])
                       for vs in self._vstates.values())
        return tree_bytes(self._params)

    def resident_bytes_by_version(self) -> Dict[str, int]:
        """{"v<N>": bytes} per resident store version (the profiler's
        per-version memory rows); empty for a model held alone."""
        return {f"v{ver}": tree_bytes(vs.model[1])
                for ver, vs in sorted(self._vstates.items())}

    # -- compiled windows --------------------------------------------------
    def invoke_window(self, frames: Sequence[ArrayTuple]) -> List[ArrayTuple]:
        """K same-signature frames as one compiled window → K output
        tuples, bit for bit those of K invokes (see the module
        docstring). The model is picked once, at the window's start (a
        store model's version too: one canary draw a window, and K
        invokes of dt/K each in its per-version record)."""
        self._seg_begin()
        ver = None
        if self._store_entry is not None:
            ver = self._pick_version()
            vs = self._vstates[ver]
            model, graphs = vs.model, vs.graphs
        else:
            model, graphs = self._held(), self._graphs
        key = (len(frames), tuple((tuple(x.shape), str(x.dtype))
                                  for x in frames[0]))
        on_card = self.device.type == "cuda"
        g = graphs.get(key) if on_card else None  # raises if failed
        host_pre = model[0].host_pre
        if host_pre is not None:
            # the host stage runs before the copy into the graph's static
            # inputs, never inside a capture
            frames = [tuple(host_pre(tuple(f))) for f in frames]
        staged = [self._stage(f) for f in frames]
        label = f"win:{len(frames)}"
        t0 = time.perf_counter()
        try:
            outs = self._window_call(model, key, g, staged, graphs, label,
                                     on_card)
        except Exception:
            if ver is not None:
                self._record_invoke(ver, t0, error=True)
            raise
        t1 = time.perf_counter()
        if ver is not None:
            # K invokes of dt/K each: the per-version ledger counts the
            # same frames whether or not a window served them
            k = len(staged)
            for _ in range(k):
                self._store_entry.record(ver, (t1 - t0) / k)
        self.window_invokes += 1
        self.window_frames += len(staged)
        tr = self.tracer
        if tr.active:
            tr.backend_span(self.trace_name or self.BACKEND_NAME,
                            "invoke_window", t0, t1, frames=len(staged),
                            **({"version": ver} if ver is not None else {}))
        return [self._tag(o) for o in outs]

    def _window_call(self, model, key, g, staged, graphs, label: str,
                     on_card: bool) -> List[ArrayTuple]:
        """One window's run with the profiler's hooks: the first window
        of a K is counted (its eager run under FlopCounterMode; on the
        card the capture after it is timed with it), every later window
        sampled by CUDA events."""
        prof = devprof.get()
        first = (model[2], self._seg_sig, label)
        if not prof.enabled or (first in self._ran or g is not None):
            if prof.enabled:
                prof.note_dispatch(self._prof_label(), label, self.device)
            if on_card:
                outs = self._window_on_card(model, key, g, staged, graphs)
            else:
                outs = [self._call(xs, model) for xs in staged]
            if prof.enabled:
                prof.note_launched()
            return outs
        self._ran.add(first)
        prof.attach_model(self._prof_label(), self)
        counter = prof.flop_counter()
        t0 = time.perf_counter()
        if on_card:
            outs = self._window_on_card(model, key, g, staged, graphs,
                                        counter)
        else:
            with counter:
                outs = [self._call(xs, model) for xs in staged]
        prof.note_compile(
            self._prof_label(), label, seconds=time.perf_counter() - t0,
            flops=counter.get_total_flops(),
            bytes_accessed=devprof.tensor_bytes(
                (model[1],) + tuple(m[1] for m in self._seg_models),
                staged, outs))
        return outs

    def _window_on_card(self, model, key, g, staged: List[ArrayTuple],
                        graphs: cuda_graphs.GraphCache,
                        counter=None) -> List[ArrayTuple]:
        """Replay `g`, the graph of `key` for `model`; without one, run
        the window eagerly (the warm-up a capture needs, and this
        window's outputs; under the profiler's `counter` when given) and
        capture it."""
        flat = [x for xs in staged for x in xs]
        with torch.inference_mode():
            if g is not None:
                outs = g.run(flat)
                return [tuple(o.clone() for o in out) for out in outs]
            if counter is not None:
                with counter:
                    outs = [self._call(xs, model) for xs in staged]
            else:
                outs = [self._call(xs, model) for xs in staged]
            k, n_in = len(staged), len(staged[0])

            def body(*flat):
                return [self._call(tuple(flat[i * n_in:(i + 1) * n_in]),
                                   model) for i in range(k)]

            graphs.capture(
                key, body, flat,
                keep=model[:2] + tuple(m[1] for m in self._seg_models),
                what=f"model {model[0].name!r} window K={k} inputs "
                     f"{list(key[1])}")
        return outs

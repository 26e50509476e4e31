"""Pool worker — one pipeline copy in a child process (the JAX package's
serving/worker.py on the port: the same messages, chaos hooks and
two-phase swap and bind, so the pool's accounting is the JAX pool's).

This is the child half of the supervised worker pool (serving/pool.py):
`worker_main` runs inside a spawned process, receives frames from the
supervisor over a multiprocessing duplex pipe, services them, and sends
results back. Everything that crosses the pipe is a small tagged tuple;
tensor payloads travel as wire-frame bytes (edge/wire.py) so the child
never needs the parent's negotiation context.

Parent -> child messages::

    ("req",  rid, payload)            one frame to service
    ("reqs", rid, nbytes, seq)        one frame whose payload rode the
                                      shm req ring (serving/shm.py)
    ("swap", phase, name, version)    two-phase model hot swap
                                      (phase: prepare | commit | abort)
    ("bind", phase, model)            two-phase slot→model rebinding
                                      (replica scaling, pool.rebind)
    ("stop",)                         graceful stop (drain then exit 0)

Child -> parent messages::

    ("ready", info)                   setup done; info carries pid and,
                                      in pipeline mode, the negotiated
                                      output spec strings
    ("hb", seq, t_mono)               heartbeat (dedicated thread, so a
                                      GIL-bound service loop still beats;
                                      only a truly wedged process stops)
    ("tr", delta)                     a traced worker's ship_delta()
    ("res", rid, payload)             one serviced frame
    ("ress", rid, nbytes, seq)        one serviced frame on the res ring
    ("err", rid, pickled_exc)         one frame failed (request-scoped)
    ("swap_ack", phase, ok, err)      swap phase outcome
    ("bind_ack", phase, ok, err)      bind phase outcome
    ("fatal", pickled_exc)            unrecoverable worker error; the
                                      child exits nonzero right after
    ("bye",)                          graceful-stop acknowledgement

Service modes (`WorkerSpec.kind`):

- ``echo``     — sleep `service_ms` then return the frame unchanged.
  The known-capacity worker the chaos tests build on (capacity =
  1000/service_ms rps per worker, serialized in the worker's main loop
  exactly like a GIL-bound pipeline stage).
- ``pipeline`` — parse `pipeline` (a mid-pipeline description, e.g.
  ``tensor_filter framework=pallas model=normalize_u8 ! tensor_filter
  model=store://m``) into ``appsrc ! <pipeline> ! tensor_sink`` and
  stream frames through it.
- ``multiplex`` — M `store://` models resident in one worker, each
  frame routed by its tenant class (serving/tenancy.py); cold models'
  CUDA graphs and batch verdicts are LRU-released under a residency
  bound (`TorchBackend.release_compiled` / `resident_bytes`).

On the card. A pipeline or multiplex child picks its device through
`backends/base.pick_device` before any tensor is made: with no CUDA
device and no CPU request its handshake fails with the `BackendError`
that names the fix (the child inherits
``NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR`` from the parent's
environment). It pins `spec.chips[0]` when the pool leased chips, else
``cuda:0``, and N children that share one card cap their caching
allocator at 1/N of it (`torch.cuda.set_per_process_memory_fraction`,
N = `WorkerSpec.workers`, which the pool fills in). A reply's CUDA
tensors reach the host in one synchronised copy — the tensor_sink's
(pipeline) or `edge/wire.encode_buffer`'s (multiplex) — before they are
encoded to wire bytes.

Chaos hooks (`crash_pts`, `hang_pts`, `crash_after_s`,
`swap_fail_version`) let tests inject deterministic worker failure
without reaching into a live process; they are inert by default.

Exceptions cross the process boundary pickled — which is why every
public error class in core/errors.py is pickle-round-trip safe.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from dataclasses import dataclass
from typing import Optional

#: pts is client-owned; requests are keyed across the pool by a
#: supervisor-assigned rid riding the buffer meta instead
RID_META = "_pool_rid"


@dataclass
class WorkerSpec:
    """Picklable description of what one worker runs (spawn-safe: no
    callables, no open handles — the child rebuilds everything)."""

    kind: str = "echo"                    # echo | pipeline | multiplex
    service_ms: float = 0.0               # echo: per-frame service time
    pipeline: str = ""                    # pipeline: mid-pipeline desc
    dims: str = "8:1"                     # accepted input dims (HELLO)
    types: str = "float32"
    hb_interval_s: float = 0.1            # heartbeat period
    # run a child-side Tracer and ship its deltas over the pipe ("tr"
    # messages on the heartbeat cadence); set automatically by a traced
    # pool. Costs the echo path a decode/encode per frame (hop stamps
    # need the meta), so it defaults off to keep the known-capacity
    # semantics exact for untraced chaos/flood runs.
    trace: bool = False
    # chaos hooks (tests / harness only; all inert by default)
    crash_pts: Optional[int] = None       # os._exit(3) on this pts
    hang_pts: Optional[int] = None        # sleep forever on this pts
    crash_after_s: Optional[float] = None  # os._exit(3) after t seconds
    swap_fail_version: Optional[int] = None  # swap prepare refuses this
    # multiplex mode (serving/tenancy.py): the worker keeps several
    # store:// models resident and routes each frame by its tenant
    # class. `tenants` is a TenantTable.to_dict() snapshot (picklable);
    # `preload` entries (name, version, ref) are registered into the
    # CHILD's model store before the service opens — spawn children
    # only inherit zoo seeds (@0), so extra versions for hot-swap must
    # travel as recipes, not objects. resident_models/resident_bytes
    # bound the LRU residency (0 = unbounded).
    tenants: Optional[dict] = None
    preload: tuple = ()                   # ((name, version, ref), ...)
    resident_models: int = 0
    resident_bytes: int = 0
    # same-host shared-memory lane (serving/shm.py): names of the two
    # per-spawn rings the supervisor created for this slot ("" = pipe
    # only). The child *attaches*; attach failure is not an error — it
    # acks ``shm: False`` at handshake and both sides stay on pickle.
    shm_req: str = ""                     # parent→child payload ring
    shm_res: str = ""                     # child→parent payload ring
    # chip ownership (serving/placement.ChipLeaseTable): device ordinals
    # this worker is leased. The child pins chips[0]; the SUPERVISOR
    # fences the chips when the worker dies and re-leases them to the
    # replacement — a K-chip worker counts as K slots of capacity in
    # the scaler (tenancy.ScalingController).
    chips: tuple = ()
    # slots of the pool this worker belongs to (filled in by the pool):
    # without leased chips that many children share one card, and each
    # caps its allocator at 1/workers of it
    workers: int = 1

    def __post_init__(self):
        if self.kind not in ("echo", "pipeline", "multiplex"):
            raise ValueError(
                f"WorkerSpec.kind must be echo|pipeline|multiplex, "
                f"got {self.kind!r}")
        if self.kind == "pipeline" and not self.pipeline:
            raise ValueError("WorkerSpec(kind='pipeline') needs a "
                             "pipeline description")
        if self.kind == "multiplex" and not self.tenants:
            raise ValueError("WorkerSpec(kind='multiplex') needs a "
                             "tenants table (TenantTable.to_dict())")


def _pickle_exc(exc: BaseException) -> bytes:
    """Best-effort exception pickling: a framework error pickles whole
    (core/errors.py guarantees it); anything else degrades to a
    RuntimeError carrying the repr, never to a poisoned pipe."""
    try:
        return pickle.dumps(exc)
    except Exception:
        return pickle.dumps(RuntimeError(
            f"[unpicklable {type(exc).__name__}] {exc}"))


def _setup_device(spec: WorkerSpec):
    """The child's device, picked before any tensor is made (module
    docstring): `pick_device` raises the BackendError that names the fix
    when CUDA is asked for and absent. → the torch.device."""
    from nnstreamer_tpu_torch.backends.base import pick_device

    dev = pick_device("")
    if dev.type != "cuda":
        return dev
    import torch

    if spec.chips:
        # every filter of this child lands on the leased chip: the
        # port-wide default device is the child's own env
        os.environ["NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR"] = \
            f"cuda:{int(spec.chips[0])}"
        dev = pick_device("")
    torch.cuda.set_device(dev)
    sharing = 1 if spec.chips else max(1, int(spec.workers))
    if sharing > 1:
        torch.cuda.set_per_process_memory_fraction(1.0 / sharing, dev)
    return dev


class _Heartbeat(threading.Thread):
    """Beats on its own thread so a busy (but alive) service loop keeps
    beating; only a wedged process — native hang, hard GIL capture —
    goes silent and trips the supervisor's hb_timeout."""

    def __init__(self, conn, send_lock, interval_s: float, tracer=None):
        super().__init__(name="pool-worker-hb", daemon=True)
        self._conn = conn
        self._lock = send_lock
        self._interval = max(0.01, interval_s)
        self._tracer = tracer
        self._stop = threading.Event()

    def run(self) -> None:
        seq = 0
        while not self._stop.wait(self._interval):
            seq += 1
            # trace deltas ride the heartbeat cadence as their own
            # pipe lane: drained event batches + monotone counter /
            # histogram deltas (runtime/tracing.py ship_delta)
            delta = self._tracer.ship_delta() \
                if self._tracer is not None and self._tracer.active \
                else None
            try:
                with self._lock:
                    self._conn.send(("hb", seq, time.monotonic()))
                    if delta is not None:
                        self._conn.send(("tr", delta))
            except (OSError, ValueError, BrokenPipeError):
                # parent gone: nothing left to serve, don't linger as
                # an orphan
                os._exit(0)

    def stop(self) -> None:
        self._stop.set()


class _EchoService:
    """Known-capacity service: sleep then echo the payload bytes
    untouched (no decode on the hot path unless a chaos hook needs the
    pts, or tracing needs the meta for hop stamps)."""

    def __init__(self, spec: WorkerSpec, tracer=None, wid: int = 0):
        from nnstreamer_tpu_torch.runtime.tracing import NULL_TRACER

        self._spec = spec
        self._tracer = tracer or NULL_TRACER
        self._wid = wid
        self._needs_pts = (spec.crash_pts is not None
                           or spec.hang_pts is not None)
        self._needs_decode = self._needs_pts or self._tracer.active

    def ready_info(self) -> dict:
        # echo's out spec is its in spec
        return {"out_dims": self._spec.dims,
                "out_types": self._spec.types}

    def serve(self, rid: int, payload: bytes, reply) -> None:
        buf = None
        if self._needs_decode:
            from nnstreamer_tpu_torch.edge.wire import decode_buffer

            buf, _ = decode_buffer(payload)
            if buf.pts == self._spec.crash_pts:
                os._exit(3)
            if buf.pts == self._spec.hang_pts:
                time.sleep(3600)          # wedged: supervisor's problem
        tr = self._tracer
        if tr.active and buf is not None:
            from nnstreamer_tpu_torch.edge.wire import encode_buffer
            from nnstreamer_tpu_torch.runtime.tracing import stamp_hop

            stamp_hop(buf.meta, "worker_recv", wid=self._wid)
            t0 = time.perf_counter()
            if self._spec.service_ms > 0:
                time.sleep(self._spec.service_ms / 1e3)
            t1 = time.perf_counter()
            tr.record_process("echo", buf, t0, t1)
            stamp_hop(buf.meta, "worker_done", wid=self._wid)
            reply(("res", rid, encode_buffer(buf)))
            return
        if self._spec.service_ms > 0:
            time.sleep(self._spec.service_ms / 1e3)
        reply(("res", rid, payload))

    def close(self) -> None:
        pass


def _resident_versions() -> dict:
    """{model name: [versions]} resident in THIS process's store —
    advertised through the pool's ready info."""
    from nnstreamer_tpu_torch.serving.store import get_store

    store = get_store()
    return {n: sorted(store.entry(n).versions) for n in store.names()}


class _PipelineService:
    """One full pipeline copy: appsrc ! <spec.pipeline> ! tensor_sink.

    Frames are pushed as they arrive (the pipeline pipelines them); a
    collector thread drains the sink and ships results, matching
    request to result by the RID_META stamp that rides buffer meta
    end-to-end. The sink brings each result to the host (its one
    synchronised D2H) before the collector encodes it."""

    def __init__(self, spec: WorkerSpec, reply, tracer=None,
                 wid: int = 0):
        import queue as _queue

        from nnstreamer_tpu_torch.edge.wire import encode_buffer
        from nnstreamer_tpu_torch.graph.parse import parse_launch
        from nnstreamer_tpu_torch.runtime.scheduler import PipelineRunner
        from nnstreamer_tpu_torch.runtime.tracing import (
            NULL_TRACER, stamp_hop)

        self._reply = reply
        self._tracer = tracer or NULL_TRACER
        self._wid = wid
        self._outq: "_queue.Queue" = _queue.Queue()
        desc = (f"appsrc name=_pool_src dims={spec.dims} "
                f"types={spec.types} ! {spec.pipeline} ! "
                f"tensor_sink name=_pool_sink collect=false")
        pipe = parse_launch(desc)
        self._src = pipe.get("_pool_src")
        sink = pipe.get("_pool_sink")
        sink.props["new_data"] = self._outq.put
        # a traced worker hands ITS tracer to the runner: the child's
        # pipeline elements record spans locally, shipped as deltas
        self.runner = PipelineRunner(
            pipe, trace=self._tracer if self._tracer.active
            else False).start()
        out_spec = sink.in_specs[0] if sink.in_specs else None
        dims, types = "", ""
        if out_spec is not None and hasattr(out_spec, "to_strings"):
            dims, types, _ = out_spec.to_strings()
        self._out_info = {"out_dims": dims, "out_types": types}
        self._stop = threading.Event()

        def collect():
            while not self._stop.is_set():
                try:
                    buf = self._outq.get(timeout=0.1)
                except _queue.Empty:
                    continue
                rid = buf.meta.pop(RID_META, None)
                if rid is None:
                    continue          # not ours (defensive)
                stamp_hop(buf.meta, "worker_done", wid=wid)
                reply(("res", int(rid), encode_buffer(buf)))

        self._collector = threading.Thread(
            target=collect, name="pool-worker-collect", daemon=True)
        self._collector.start()

    def ready_info(self) -> dict:
        info = dict(self._out_info)
        info["versions"] = _resident_versions()
        return info

    def serve(self, rid: int, payload: bytes, reply) -> None:
        from nnstreamer_tpu_torch.edge.wire import decode_buffer
        from nnstreamer_tpu_torch.runtime.tracing import stamp_hop

        # runner death is worker-fatal, not request-scoped: the
        # supervisor restarts the whole process
        err = getattr(self.runner, "_error", None)
        if err is not None:
            raise err
        buf, _ = decode_buffer(payload)
        stamp_hop(buf.meta, "worker_recv", wid=self._wid)
        self._src.push(buf)           # RID_META already rides buf.meta

    def close(self) -> None:
        self._stop.set()
        try:
            self.runner.stop()
        except Exception:
            pass


class _MultiplexService:
    """M models, one worker: per-tenant model routing (serving/tenancy).

    Every model the TenantTable binds gets its own store-attached
    TorchBackend, opened once at startup; each frame routes by the tenant
    class riding its meta (``_tenant_class`` stamped at admission, or
    the raw ``tenant`` claim when driven without an admission front).
    A `ModelResidency` LRU bounds the rebuildable state: after each
    invoke the served model is touched and cold models beyond the bound
    have their CUDA graphs and batch verdicts released — the next frame
    for an evicted model rebuilds them (counted, correct, never an
    error).

    Store hot swaps work unchanged: the backends track the child
    store's epoch and adopt at their next invoke boundary, so an
    ``update(name, version)`` from a committed swap flips exactly the
    swapped model — other tenants' backends are untouched.
    """

    def __init__(self, spec: WorkerSpec, tracer=None, wid: int = 0):
        from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
        from nnstreamer_tpu_torch.runtime.tracing import NULL_TRACER
        from nnstreamer_tpu_torch.serving.tenancy import (
            ModelResidency, TenantTable)
        from nnstreamer_tpu_torch.tensor.info import TensorsSpec

        self._spec = spec
        self._tracer = tracer or NULL_TRACER
        self._wid = wid
        self._table = TenantTable.from_dict(spec.tenants)
        self._in_spec = TensorsSpec.from_strings(spec.dims, spec.types)
        self._residency = ModelResidency(
            max_models=spec.resident_models,
            max_bytes=spec.resident_bytes)
        self._backends: dict = {}
        self.invokes_by_model: dict = {}
        models = self._table.models()
        if not models:
            raise ValueError("multiplex worker: tenant table binds no "
                             "models")
        for name in models:
            b = TorchBackend()
            b.open({"model": f"store://{name}"})
            b.set_input_info(self._in_spec)
            self._backends[name] = b
            self._residency.register(name, b)
        self._default_model = (self._table.model_of(None)
                               or models[0])

    def _route(self, meta) -> str:
        cls = None
        if isinstance(meta, dict):
            cls = meta.get("_tenant_class") or meta.get("tenant")
        model = self._table.model_of(cls) if cls is not None else None
        if model is None or model not in self._backends:
            return self._default_model
        return model

    def ready_info(self) -> dict:
        dims, types, _ = self._in_spec.to_strings()
        return {"out_dims": dims, "out_types": types,
                "versions": _resident_versions(),
                "models": sorted(self._backends)}

    def serve(self, rid: int, payload: bytes, reply) -> None:
        from nnstreamer_tpu_torch.edge.wire import (
            decode_buffer, encode_buffer)
        from nnstreamer_tpu_torch.runtime.tracing import stamp_hop

        buf, _ = decode_buffer(payload)
        if buf.pts == self._spec.crash_pts:
            os._exit(3)
        if buf.pts == self._spec.hang_pts:
            time.sleep(3600)
        model = self._route(buf.meta)
        backend = self._backends[model]
        if self._tracer.active:
            stamp_hop(buf.meta, "worker_recv", wid=self._wid,
                      model=model)
        t0 = time.perf_counter()
        out = backend.invoke(buf.tensors)
        t1 = time.perf_counter()
        self.invokes_by_model[model] = \
            self.invokes_by_model.get(model, 0) + 1
        self._residency.touch(model)
        res = buf.with_tensors(tuple(out), pts=buf.pts)
        if self._tracer.active:
            self._tracer.record_process(f"mux:{model}", buf, t0, t1)
            stamp_hop(res.meta, "worker_done", wid=self._wid,
                      model=model)
        # the reply's one synchronised D2H happens inside encode_buffer
        reply(("res", rid, encode_buffer(res, 0, self._tracer,
                                         f"mux:{model}")))

    def residency_stats(self) -> dict:
        st = self._residency.stats()
        st["invokes_by_model"] = dict(self.invokes_by_model)
        return st

    def close(self) -> None:
        for b in self._backends.values():
            try:
                b.close()
            except Exception:
                pass


def _register_preloads(preload) -> None:
    """Install the spec's (name, version, ref) recipes into THIS
    process's store: string refs register as lazy builders, so nothing
    heavyweight resolves until a swap actually commits that version. A
    version already held (a restart, a double preload) is left as it is;
    any other error (a malformed recipe, a clash the store refuses)
    raises, and fails the child's handshake."""
    from nnstreamer_tpu_torch.core.errors import BackendError
    from nnstreamer_tpu_torch.serving.store import get_store

    store = get_store()
    for name, version, ref in preload:
        # pull the zoo seed (@0) first if there is one, so the preloaded
        # version lands as a LATER version and the zero-downtime contract
        # holds: registration never changes what's being served — only a
        # committed swap does
        try:
            held = store.entry(name).versions
        except BackendError:
            held = {}                 # brand-new name: recipe is v1
        if version in held:
            continue
        store.register(name, model=ref, version=version)


def _handle_bind(service, state: dict, phase: str,
                 model) -> "tuple[bool, Optional[str]]":
    """Two-phase slot→model rebinding, child side (pool.rebind).

    Binding is primarily PARENT routing state (which slot is preferred
    for which model); the child's role is to vote in the two-phase
    broadcast so the flip is epoch-atomic, and — for a multiplex
    worker — to verify it can actually serve the model and warm it.
    Echo/pipeline workers accept any bind (routing is not theirs to
    refuse)."""
    if phase == "abort":
        state.pop("bind_staged", None)
        return True, None
    if phase == "prepare":
        if model is not None and isinstance(service, _MultiplexService):
            if model not in service._backends:
                return False, (f"worker has no backend for model "
                               f"{model!r}")
        state["bind_staged"] = model
        return True, None
    if phase == "commit":
        staged = state.pop("bind_staged", "\0missing")
        if staged == "\0missing" or staged != model:
            return False, (f"bind commit without matching prepare "
                           f"(staged={staged!r})")
        state["bound_model"] = model
        if model is not None and isinstance(service, _MultiplexService):
            service._residency.touch(model)   # pre-warm LRU position
        return True, None
    return False, f"unknown bind phase {phase!r}"


def _handle_swap(service, spec: WorkerSpec, state: dict, phase: str,
                 name: str, version) -> "tuple[bool, Optional[str]]":
    """Two-phase hot swap, child side. `prepare` stages (and for
    pipeline workers validates against the child's model store) without
    flipping; only `commit` makes the new version live — so the
    supervisor can abort every worker if any one prepare fails, and the
    pool epoch flips all-or-none."""
    if phase == "abort":
        state.pop("staged", None)
        return True, None
    if phase == "prepare":
        if spec.swap_fail_version is not None \
                and version == spec.swap_fail_version:
            return False, f"injected prepare failure for @{version}"
        if isinstance(service, (_PipelineService, _MultiplexService)):
            try:
                from nnstreamer_tpu_torch.serving.store import get_store

                entry = get_store().entry(name)
                if version is not None and \
                        int(version) not in entry.versions:
                    return False, (f"store://{name} has no version "
                                   f"@{version} in this worker")
            except Exception as e:
                return False, str(e)
        state["staged"] = (name, version)
        return True, None
    if phase == "commit":
        staged = state.pop("staged", None)
        if staged != (name, version):
            return False, (f"commit without matching prepare "
                           f"(staged={staged!r})")
        if isinstance(service, (_PipelineService, _MultiplexService)):
            try:
                from nnstreamer_tpu_torch.serving.store import get_store

                get_store().update(name, version)
            except Exception as e:
                return False, str(e)
        state["version"] = (name, version)
        return True, None
    return False, f"unknown swap phase {phase!r}"


def worker_main(conn, spec: WorkerSpec, wid: int = 0) -> None:
    """Child entry point (multiprocessing spawn target).

    The loop is deliberately sequential per worker — concurrency comes
    from the POOL running N of these processes, which is the whole
    point: one wedged/GIL-bound worker never slows its siblings."""
    send_lock = threading.Lock()

    # same-host shm lane: attach the supervisor's rings, or silently
    # stay on pickle — the handshake ack below tells the parent which
    shm_req_ring = shm_res_ring = None
    if spec.shm_req and spec.shm_res:
        try:
            from nnstreamer_tpu_torch.serving.shm import ShmRing

            shm_req_ring = ShmRing.attach(spec.shm_req)
            shm_res_ring = ShmRing.attach(spec.shm_res)
        except Exception:
            if shm_req_ring is not None:
                shm_req_ring.close()
            shm_req_ring = shm_res_ring = None

    def reply(msg) -> None:
        try:
            with send_lock:
                # result payloads ride the res ring when they fit; the
                # ring write lands BEFORE the control send (and both
                # under send_lock), so ring order == pipe order and the
                # parent's reader never guesses
                if shm_res_ring is not None and msg[0] == "res":
                    seq = shm_res_ring.try_write(msg[2])
                    if seq is not None:
                        conn.send(("ress", msg[1], len(msg[2]), seq))
                        return
                conn.send(msg)
        except (OSError, ValueError, BrokenPipeError):
            os._exit(0)               # parent gone — never orphan

    tracer = None
    if spec.trace:
        from nnstreamer_tpu_torch.runtime.tracing import Tracer

        tracer = Tracer()
        tracer.enable_shipping()

    hb = _Heartbeat(conn, send_lock, spec.hb_interval_s, tracer)
    hb.start()
    if spec.crash_after_s is not None:
        # chaos: die abruptly after t seconds (circuit-breaker tests);
        # daemon so a worker that drains cleanly first isn't held alive
        # until the fuse fires
        crash = threading.Timer(spec.crash_after_s, lambda: os._exit(3))
        crash.daemon = True
        crash.start()

    service = None
    device = None
    try:
        if spec.kind in ("pipeline", "multiplex"):
            device = _setup_device(spec)
            if tracer is not None:
                # the kernels' launches reach the parent in ship_delta
                from nnstreamer_tpu_torch.backends import cuda_graphs

                cuda_graphs.observe_launches(tracer.record_launches)
        if spec.preload:
            _register_preloads(spec.preload)
        if spec.kind == "pipeline":
            service = _PipelineService(spec, reply, tracer, wid)
        elif spec.kind == "multiplex":
            service = _MultiplexService(spec, tracer, wid)
        else:
            service = _EchoService(spec, tracer, wid)
    except BaseException as e:
        reply(("fatal", _pickle_exc(e)))
        os._exit(4)

    # t_perf lets the parent sample this worker's monotonic-clock
    # offset at handshake (pool.py "ready" handler) so shipped trace
    # timestamps align on one pool-wide timeline
    reply(("ready", dict(service.ready_info(), pid=os.getpid(),
                         wid=wid, t_perf=time.perf_counter(),
                         shm=shm_res_ring is not None,
                         device=str(device) if device is not None
                         else None)))
    swap_state: dict = {}
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                os._exit(1)           # supervisor died — exit, no orphan
            tag = msg[0]
            if tag == "req" or tag == "reqs":
                if tag == "reqs":
                    # payload rode the req ring; the control message
                    # promised (nbytes, seq) — any mismatch is a
                    # request-scoped error, recovered by redelivery
                    _, rid, nbytes, seq = msg
                    try:
                        payload = shm_req_ring.read_record(nbytes, seq)
                    except BaseException as e:
                        reply(("err", rid, _pickle_exc(e)))
                        continue
                else:
                    _, rid, payload = msg
                try:
                    service.serve(rid, payload, reply)
                except BaseException as e:
                    reply(("err", rid, _pickle_exc(e)))
            elif tag == "swap":
                _, phase, name, version = msg
                ok, err = _handle_swap(service, spec, swap_state,
                                       phase, name, version)
                reply(("swap_ack", phase, ok, err))
            elif tag == "bind":
                _, phase, model = msg
                ok, err = _handle_bind(service, swap_state, phase, model)
                reply(("bind_ack", phase, ok, err))
            elif tag == "stop":
                break
    finally:
        hb.stop()
        if service is not None:
            service.close()
        # close (never unlink — the creator owns the name) the shm lane
        for ring in (shm_req_ring, shm_res_ring):
            if ring is not None:
                ring.close()
    if tracer is not None:
        # final drain: a graceful stop must not strand the tail of the
        # trace in the child (the heartbeat cadence may not have fired
        # since the last frame)
        delta = tracer.ship_delta()
        if delta is not None:
            reply(("tr", delta))
    reply(("bye",))
    try:
        conn.close()
    except OSError:
        pass

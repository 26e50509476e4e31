"""Pull-based metrics plane: typed series → Prometheus text → HTTP (the
JAX package's serving/metrics.py on the port: for the same inputs
`render_prometheus` gives the same text, HELP lines included, so one
dashboard reads either package).

`metrics_snapshot()` flattens everything the runtime already counts —
tracer histograms/counters (runtime/tracing.py), admission conservation
counters (traffic/admission.py), pool supervision stats
(serving/pool.py), and any extra numeric gauges the caller owns — into
typed counter/gauge/histogram series; `render_prometheus()` turns them
into the text exposition format; `MetricsServer` serves them over a
tiny stdlib HTTP endpoint (``GET /metrics``); `top_view()` scrapes any
such endpoint and renders a live terminal table (`python -m
nnstreamer_tpu_torch top`).

Monotonicity contract (pinned by tests/test_metrics.py): every series
typed ``counter`` here is backed by a cumulative source — admission
totals, pool lifetime counters, the tracer's delta-merged child
counters and fixed-bound cumulative histograms — so two consecutive
scrapes under load NEVER see a counter or histogram bucket decrease.
Anything windowed (ring length, queue depth, percentiles) is typed
``gauge``.

The HTTP handler is deliberately dependency-free (http.server from the
stdlib) and runs entirely host-side: it reads counters under their own
locks and never touches device state.

`devprof=` takes the device profiler's stats() (runtime/devprof.py: the
nns_jit_*, nns_invoke_* and nns_device_hbm_* families); `serve
--metrics-port` turns the profiler on and passes it.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.core.log import get_logger

log = get_logger("serving.metrics")

#: one exposition series: type is counter | gauge | histogram; samples
#: are (labels, value) pairs — value is a float for counter/gauge and a
#: {"bounds", "counts", "sum", "count"} dict (tracing._Hist.snapshot
#: layout, per-bucket counts) for histogram
Series = Dict[str, Any]

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _series(name: str, typ: str, help_: str,
            samples: List[Tuple[Dict[str, str], Any]]) -> Series:
    return {"name": name, "type": typ, "help": help_, "samples": samples}


def metrics_snapshot(tracer=None, admission: Optional[dict] = None,
                     pool: Optional[dict] = None,
                     mesh: Optional[dict] = None,
                     replicas: Optional[Dict[str, dict]] = None,
                     segments: Optional[Dict[str, dict]] = None,
                     autotune: Optional[dict] = None,
                     llm: Optional[Dict[str, dict]] = None,
                     devprof: Optional[dict] = None,
                     extra: Optional[Dict[str, float]] = None,
                     namespace: str = "nns") -> List[Series]:
    """Flatten runtime state into typed series.

    tracer     — a runtime.tracing.Tracer (ignored when None/inactive)
    admission  — AdmissionQueue.counters() snapshot
    replicas   — {filter: ReplicaSet.stats()} (serving/placement.py):
                 per-chip invoke/error counters + queue-depth/up gauges
                 labelled by device; Σ nns_replica_invokes_total over
                 devices == that filter's invoke count — the replica
                 conservation check, verifiable from one scrape.
                 ShardedReplicaSet stats (rows carrying "group") emit
                 the nns_shard_* family on top: per-group invoke/up/
                 adopted-epoch series plus the shard width and the
                 chip-lease ledger, with the same Σ-over-groups ==
                 filter-invokes conservation contract
    segments   — {plan: SegmentPlan.report()}: per-stage profiled time
                 (labelled stage/device) + the plan's bubble fraction
    pool       — WorkerPool.stats() snapshot
    mesh       — MeshRouter.stats() snapshot: per-host labelled series
                 (the `host` label) + mesh-wide gauges; the router's
                 own admission counters ride the `admission` arg, so
                 Σ nns_host_replied_total == nns_admission_replied_total
                 is checkable from one scrape
    autotune   — AutoTuner.stats() snapshot (serving/autotune.py):
                 cumulative decision counters labelled knob/outcome
                 plus current-knob and SLO gauges, so every applied
                 decision is visible as an nns_autotune_* series
    llm        — {element: TensorLLM.extra_stats()} (or bare
                 LLMEngine.stats()): per-kernel attention invoke
                 counters labelled {element, kernel}, the fallback
                 counter, token/finished totals and the selected-kernel
                 info gauge — one scrape proves which attention path
                 served
    devprof    — DeviceProfiler.stats() (runtime/devprof.py): the
                 device performance plane.  Cost-registry rows become
                 nns_jit_* (flops / bytes accessed / compile seconds
                 per {filter, bucket}); invoke reservoirs become
                 nns_invoke_* (MFU, achieved TFLOP/s, cumulative
                 sampled seconds — Σ nns_invoke_seconds_total is
                 reconcilable against the tracer's proctime histograms
                 from the same scrape); the HBM ledger becomes
                 nns_device_hbm_* labelled {device, kind} with a
                 headroom gauge per device
    extra      — arbitrary numeric gauges {name: value} the caller owns
                 (backend cache sizes, build info, …)
    """
    ns = namespace
    out: List[Series] = []

    if admission:
        for key, help_ in (("offered", "requests seen at the door"),
                           ("admitted", "requests admitted"),
                           ("replied", "requests answered with RESULT")):
            out.append(_series(f"{ns}_admission_{key}_total", "counter",
                               f"admission: {help_}",
                               [({}, float(admission[key]))]))
        out.append(_series(
            f"{ns}_admission_rejected_total", "counter",
            "at-the-door refusals by cause (BUSY, never queued)",
            [({"cause": c}, float(v))
             for c, v in sorted(admission["rejected"].items())] or
            [({"cause": "none"}, 0.0)]))
        out.append(_series(
            f"{ns}_admission_shed_total", "counter",
            "post-admission sheds by cause (BUSY after queueing)",
            [({"cause": c}, float(v))
             for c, v in sorted(admission["shed"].items())] or
            [({"cause": "none"}, 0.0)]))
        out.append(_series(f"{ns}_admission_depth", "gauge",
                           "requests queued right now",
                           [({}, float(admission["depth"]))]))
        out.append(_series(f"{ns}_admission_inflight", "gauge",
                           "requests dequeued but not yet replied",
                           [({}, float(admission["inflight"]))]))
        out.append(_series(f"{ns}_admission_depth_peak", "gauge",
                           "admission queue high-water mark",
                           [({}, float(admission["depth_peak"]))]))
        classes = admission.get("classes")
        if classes:
            # per-tenant conservation ledger: same shape as the global
            # admission counters, labelled by tenant class. Summing any
            # family over the tenant label reproduces the global series
            # — the per-class invariant is checkable from one scrape.
            # Label cardinality is bounded by admission-time tenant
            # name validation (serving/tenancy.validate_tenant_name).
            for key, help_ in (
                    ("offered", "requests seen at the door"),
                    ("admitted", "requests admitted"),
                    ("replied", "requests answered with RESULT")):
                out.append(_series(
                    f"{ns}_tenant_{key}_total", "counter",
                    f"per-tenant admission: {help_}",
                    [({"tenant": t}, float(c[key]))
                     for t, c in sorted(classes.items())]))
            out.append(_series(
                f"{ns}_tenant_rejected_total", "counter",
                "per-tenant at-the-door refusals by cause",
                [({"tenant": t, "cause": cause}, float(v))
                 for t, c in sorted(classes.items())
                 for cause, v in sorted(c["rejected"].items())] or
                [({"tenant": "none", "cause": "none"}, 0.0)]))
            out.append(_series(
                f"{ns}_tenant_shed_total", "counter",
                "per-tenant post-admission sheds by cause",
                [({"tenant": t, "cause": cause}, float(v))
                 for t, c in sorted(classes.items())
                 for cause, v in sorted(c["shed"].items())] or
                [({"tenant": "none", "cause": "none"}, 0.0)]))
            out.append(_series(
                f"{ns}_tenant_depth", "gauge",
                "per-tenant requests queued right now",
                [({"tenant": t}, float(c["depth"]))
                 for t, c in sorted(classes.items())]))
            out.append(_series(
                f"{ns}_tenant_inflight", "gauge",
                "per-tenant requests dequeued but not yet replied",
                [({"tenant": t}, float(c["inflight"]))
                 for t, c in sorted(classes.items())]))
            out.append(_series(
                f"{ns}_tenant_weight", "gauge",
                "per-tenant WFQ weight (scheduling share)",
                [({"tenant": t}, float(c["weight"]))
                 for t, c in sorted(classes.items())]))

    if pool:
        p = pool.get("pool", {})
        for key, help_ in (("restarts", "worker restarts"),
                           ("kills", "supervisor kills (hang/deadline)"),
                           ("reoffered", "frames redelivered after a "
                                         "worker death")):
            out.append(_series(f"{ns}_pool_{key}_total", "counter",
                               f"pool: {help_}",
                               [({}, float(p.get(key, 0)))]))
        # same-host shared-memory transport (serving/shm.py): frames/
        # bytes moved over the rings + hops that fell back to pickle.
        # shm_frames + shm_fallbacks == dispatches + replies attempted,
        # so the lane split is checkable from one scrape.
        for key, help_ in (
                ("shm_frames", "payload hops served over the "
                               "shared-memory ring lane"),
                ("shm_bytes", "payload bytes moved over the "
                              "shared-memory rings"),
                ("shm_fallbacks", "hops that fell back to the pickle "
                                  "pipe lane (ring full / shm "
                                  "unavailable)")):
            out.append(_series(f"{ns}_{key}_total", "counter",
                               f"pool shm transport: {help_}",
                               [({}, float(p.get(key, 0)))]))
        for key, help_ in (("live", "live workers"),
                           ("ready", "ready workers"),
                           ("pending", "router backlog"),
                           ("degraded", "slots disabled by the circuit"),
                           ("epoch", "model swap epoch")):
            out.append(_series(f"{ns}_pool_{key}", "gauge",
                               f"pool: {help_}",
                               [({}, float(p.get(key, 0)))]))
        workers = pool.get("workers", [])
        if workers:
            out.append(_series(
                f"{ns}_worker_replied_total", "counter",
                "per-worker goodput (frames answered)",
                [({"wid": str(w["wid"])}, float(w["replied"]))
                 for w in workers]))
            out.append(_series(
                f"{ns}_worker_restarts_total", "counter",
                "per-worker slot restarts",
                [({"wid": str(w["wid"])}, float(w["restarts"]))
                 for w in workers]))
            out.append(_series(
                f"{ns}_worker_inflight", "gauge",
                "frames dispatched to the worker, unanswered",
                [({"wid": str(w["wid"])}, float(w["inflight"]))
                 for w in workers]))
            out.append(_series(
                f"{ns}_worker_up", "gauge",
                "1 when the slot is ready, else 0 (state label says "
                "why)",
                [({"wid": str(w["wid"]), "state": w["state"]},
                  1.0 if w["state"] == "ready" else 0.0)
                 for w in workers]))

    if replicas:
        flat = [(f, r) for f, st in sorted(replicas.items())
                for r in st.get("replicas", [])]
        if flat:
            out.append(_series(
                f"{ns}_replica_invokes_total", "counter",
                "per-chip replica invokes; summed over devices this "
                "equals the owning filter's invoke count — the replica "
                "conservation check",
                [({"filter": f, "device": str(r["device"])},
                  float(r["invokes"])) for f, r in flat]))
            out.append(_series(
                f"{ns}_replica_errors_total", "counter",
                "per-chip replica invoke failures",
                [({"filter": f, "device": str(r["device"])},
                  float(r["errors"])) for f, r in flat]))
            out.append(_series(
                f"{ns}_replica_queue_depth", "gauge",
                "frames queued on the chip's bounded queue right now",
                [({"filter": f, "device": str(r["device"])},
                  float(r["queue_depth"])) for f, r in flat]))
            out.append(_series(
                f"{ns}_replica_up", "gauge",
                "1 when the replica serves, 0 when fenced (state label "
                "says which)",
                [({"filter": f, "device": str(r["device"]),
                   "state": r["state"]}, 1.0 if r["up"] else 0.0)
                 for f, r in flat]))
        out.append(_series(
            f"{ns}_replica_reoffers_total", "counter",
            "frames re-routed to a surviving replica after a fence",
            [({"filter": f}, float(st.get("reoffers", 0)))
             for f, st in sorted(replicas.items())]))
        # sharded serving: rows carrying a "group" key come from a
        # ShardedReplicaSet (serving/sharding.py) — one row per shard
        # GROUP, i.e. N chips acting as one tensor-parallel backend.
        # Σ nns_shard_group_invokes_total over groups equals the owning
        # filter's invoke count, so tensor-parallel conservation is the
        # same one-scrape check the per-chip replica family gives.
        sh = [(f, r) for f, st in sorted(replicas.items())
              for r in st.get("replicas", []) if "group" in r]
        if sh:
            out.append(_series(
                f"{ns}_shard_group_invokes_total", "counter",
                "per-shard-group invokes; summed over groups this "
                "equals the owning filter's invoke count — the "
                "tensor-parallel conservation check",
                [({"filter": f, "group": str(r["group"]),
                   "devices": ",".join(str(d) for d in r["devices"])},
                  float(r["invokes"])) for f, r in sh]))
            out.append(_series(
                f"{ns}_shard_group_up", "gauge",
                "1 when every member chip of the group serves; fencing "
                "ONE member fences the whole group (state label says "
                "which)",
                [({"filter": f, "group": str(r["group"]),
                   "state": r["state"]}, 1.0 if r["up"] else 0.0)
                 for f, r in sh]))
            out.append(_series(
                f"{ns}_shard_group_adopted_epoch", "gauge",
                "store swap epoch this group last adopted; all groups "
                "of a filter reporting one value proves the hot swap "
                "was epoch-atomic across the shard set",
                [({"filter": f, "group": str(r["group"])},
                  float(r.get("adopted_epoch", 0))) for f, r in sh]))
            out.append(_series(
                f"{ns}_shard_group_size", "gauge",
                "chips per shard group (the tensor-parallel width)",
                [({"filter": f}, float(st["group_size"]))
                 for f, st in sorted(replicas.items())
                 if "group_size" in st]))
            out.append(_series(
                f"{ns}_shard_leased_chips", "gauge",
                "chip-lease ledger of the sharded filter, by state",
                [({"filter": f, "state": state}, float(v))
                 for f, st in sorted(replicas.items())
                 for state, v in sorted(st.get("leases", {}).items())]))

    if segments:
        stage_rows = [(pl, row) for pl, rep in sorted(segments.items())
                      for row in rep.get("stages", [])]
        if stage_rows:
            out.append(_series(
                f"{ns}_segment_stage_seconds", "gauge",
                "profiled per-stage proctime of the placement plan",
                [({"plan": pl, "stage": str(row["stage"]),
                   "device": str(row["device"])}, float(row["time_s"]))
                 for pl, row in stage_rows]))
        out.append(_series(
            f"{ns}_segment_bubble_fraction", "gauge",
            "steady-state device idle share of the segmented pipeline "
            "(0 = perfectly balanced stages)",
            [({"plan": pl}, float(rep.get("bubble_fraction", 0.0)))
             for pl, rep in sorted(segments.items())]))

    if mesh:
        m = mesh.get("mesh", {})
        for key, help_ in (("reoffered", "frames redelivered after a "
                                         "host fence"),
                           ("busy_reroutes", "frames retried on a "
                                             "different host after BUSY"),
                           ("stale_results", "host results for already-"
                                             "settled requests")):
            out.append(_series(f"{ns}_mesh_{key}_total", "counter",
                               f"mesh: {help_}",
                               [({}, float(m.get(key, 0)))]))
        for key, help_ in (("hosts", "registered hosts"),
                           ("ready", "hosts holding a live lease"),
                           ("fenced", "hosts cut out of the mesh"),
                           ("pending", "router backlog"),
                           ("epoch", "mesh swap epoch")):
            out.append(_series(f"{ns}_mesh_{key}", "gauge",
                               f"mesh: {help_}",
                               [({}, float(m.get(key, 0)))]))
        hosts = mesh.get("hosts", [])
        if hosts:
            out.append(_series(
                f"{ns}_host_replied_total", "counter",
                "per-host goodput (frames answered); summed over hosts "
                "this equals nns_admission_replied_total — the "
                "cross-host conservation check",
                [({"host": str(h["host"])}, float(h["replied"]))
                 for h in hosts]))
            out.append(_series(
                f"{ns}_host_busies_total", "counter",
                "per-host typed BUSY refusals seen by the router",
                [({"host": str(h["host"])}, float(h["busies"]))
                 for h in hosts]))
            out.append(_series(
                f"{ns}_host_outstanding", "gauge",
                "frames dispatched to the host, unanswered",
                [({"host": str(h["host"])}, float(h["outstanding"]))
                 for h in hosts]))
            out.append(_series(
                f"{ns}_host_lease_age_ms", "gauge",
                "ms since the host's last lease renewal",
                [({"host": str(h["host"])}, float(h["lease_age_ms"]))
                 for h in hosts]))
            out.append(_series(
                f"{ns}_host_up", "gauge",
                "1 when the host holds a live lease, else 0 (state "
                "label says why)",
                [({"host": str(h["host"]), "state": h["state"]},
                  1.0 if h["state"] == "READY" else 0.0)
                 for h in hosts]))
            # lease renewals carry each host's LOCAL admission
            # counters: the remote half of the conservation ledger
            remote = [(h, h.get("remote") or {}) for h in hosts]
            if any(r for _, r in remote):
                for key in ("offered", "admitted", "replied"):
                    out.append(_series(
                        f"{ns}_host_local_{key}_total", "counter",
                        f"host-local admission {key} (lease-carried)",
                        [({"host": str(h["host"])}, float(r[key]))
                         for h, r in remote if key in r]))

    if tracer is not None and getattr(tracer, "active", False):
        hists = tracer.hists()
        if hists:
            out.append(_series(
                f"{ns}_element_proctime_seconds", "histogram",
                "per-element process() latency (w<wid>/ prefix = "
                "merged from that worker process)",
                [({"element": name}, h)
                 for name, h in sorted(hists.items())]))
        cw = tracer.compiled_windows() \
            if hasattr(tracer, "compiled_windows") else {}
        if cw:
            out.append(_series(
                f"{ns}_loop_entries_total", "counter",
                "compiled steady-state windows entered per element "
                "(scheduler bypass, runtime/compiled_loop.py)",
                [({"element": n}, float(c["windows"]))
                 for n, c in sorted(cw.items())]))
            out.append(_series(
                f"{ns}_compiled_steps_total", "counter",
                "frames served through a compiled window per element",
                [({"element": n}, float(c["frames"]))
                 for n, c in sorted(cw.items())]))
        bails = tracer.loop_bails() \
            if hasattr(tracer, "loop_bails") else {}
        if bails:
            out.append(_series(
                f"{ns}_loop_bails_total", "counter",
                "armed compiled windows that fell back to per-frame "
                "mode, by element and cause",
                [({"element": n, "cause": c}, float(v))
                 for n, causes in sorted(bails.items())
                 for c, v in sorted(causes.items())]))
        forced = tracer.forced_syncs()
        if forced:
            out.append(_series(
                f"{ns}_forced_syncs_total", "counter",
                "semantic host syncs per element (runtime/sync.py)",
                [({"element": n}, float(v))
                 for n, v in sorted(forced.items())]))
        sheds = tracer.shed_counts()
        if sheds:
            out.append(_series(
                f"{ns}_trace_sheds_total", "counter",
                "sheds/rejections as seen by the tracer, per server "
                "and cause",
                [({"server": srv, "cause": c}, float(v))
                 for srv, causes in sorted(sheds.items())
                 for c, v in sorted(causes.items())]))
        out.append(_series(
            f"{ns}_trace_events_total", "counter",
            "trace events recorded pool-wide (monotone; ring length "
            "is bounded)", [({}, float(tracer.total_events))]))
        out.append(_series(
            f"{ns}_trace_events_dropped_total", "counter",
            "trace events lost to ring wrap, children included",
            [({}, float(tracer.events_dropped))]))
        s = tracer.summary()
        out.append(_series(
            f"{ns}_trace_requests_total", "counter",
            "completed request timelines recorded",
            [({}, float(s.get("requests", 0)))]))
        queues = tracer.queue_gauges()
        if queues:
            out.append(_series(
                f"{ns}_queue_depth_peak", "gauge",
                "per-queue high-water mark",
                [({"queue": n}, float(g.get("peak", 0)))
                 for n, g in sorted(queues.items())]))
        tenants = tracer.tenant_summary() \
            if hasattr(tracer, "tenant_summary") else {}
        if tenants:
            out.append(_series(
                f"{ns}_tenant_p99_ms", "gauge",
                "per-tenant server-side p99 latency over the request "
                "window (admit → reply)",
                [({"tenant": t}, float(r["p99_ms"]))
                 for t, r in sorted(tenants.items())]))
            out.append(_series(
                f"{ns}_tenant_p50_ms", "gauge",
                "per-tenant server-side median latency over the "
                "request window",
                [({"tenant": t}, float(r["p50_ms"]))
                 for t, r in sorted(tenants.items())]))
            out.append(_series(
                f"{ns}_tenant_rate_hz", "gauge",
                "per-tenant completion rate over the request window",
                [({"tenant": t}, float(r["rate_hz"]))
                 for t, r in sorted(tenants.items())]))

    if autotune:
        decisions = autotune.get("decisions", {})
        out.append(_series(
            f"{ns}_autotune_decisions_total", "counter",
            "autotuner decisions by knob and outcome (applied / "
            "dry_run / proposed / hysteresis / cooldown / error)",
            [({"knob": k, "outcome": o}, float(n))
             for k, d in sorted(decisions.items())
             for o, n in sorted(d.items())] or
            [({"knob": "none", "outcome": "none"}, 0.0)]))
        out.append(_series(
            f"{ns}_autotune_applied_total", "counter",
            "autotuner decisions actually actuated",
            [({}, float(autotune.get("applied_total", 0)))]))
        out.append(_series(
            f"{ns}_autotune_audit_dropped_total", "counter",
            "audit-ring entries aged out by wrap (totals above stay "
            "exact)",
            [({}, float(autotune.get("audit_dropped", 0)))]))
        out.append(_series(
            f"{ns}_autotune_knob", "gauge",
            "current value of each controlled knob",
            [({"knob": k}, float(v))
             for k, v in sorted(autotune.get("knobs", {}).items())] or
            [({"knob": "none"}, 0.0)]))
        out.append(_series(
            f"{ns}_autotune_dry_run", "gauge",
            "1 when the controller only records decisions, 0 when it "
            "actuates",
            [({}, 1.0 if autotune.get("dry_run") else 0.0)]))
        slo = autotune.get("slo", {})
        out.append(_series(
            f"{ns}_autotune_slo_p99_budget_ms", "gauge",
            "declared p99 latency budget the controller defends",
            [({}, float(slo.get("p99_budget_ms", 0.0)))]))
        out.append(_series(
            f"{ns}_autotune_slo_goodput_floor_rps", "gauge",
            "declared goodput floor (0 = none)",
            [({}, float(slo.get("goodput_floor_rps", 0.0)))]))

    if llm:
        # element → (engine-level stats, executor-level stats); accept
        # either a TensorLLM.extra_stats() merge (executor nested) or a
        # bare executor stats dict
        rows = [(el, st, st.get("executor", st))
                for el, st in sorted(llm.items())]
        out.append(_series(
            f"{ns}_llm_kernel_invokes_total", "counter",
            "paged-attention executions by kernel (pallas = flash "
            "paged kernels, xla = the bit-reference) — one scrape "
            "proves which path served",
            [({"element": el, "kernel": k}, float(v))
             for el, _, ex in rows
             for k, v in sorted(ex.get("kernel_invokes", {}).items())]
            or [({"element": "none", "kernel": "none"}, 0.0)]))
        out.append(_series(
            f"{ns}_llm_kernel_fallback_total", "counter",
            "requested Pallas paths served on XLA instead (kernel "
            "unavailable or failed to build — counted, never an error)",
            [({"element": el}, float(ex.get("kernel_fallback", 0)))
             for el, _, ex in rows]))
        out.append(_series(
            f"{ns}_llm_paged_kernel_info", "gauge",
            "1 for the attention kernel currently selected",
            [({"element": el,
               "kernel": str(ex.get("paged_kernel", "xla"))}, 1.0)
             for el, _, ex in rows]))
        out.append(_series(
            f"{ns}_llm_tokens_total", "counter",
            "tokens generated",
            [({"element": el}, float(st.get("tokens_out", 0)))
             for el, st, _ in rows]))
        out.append(_series(
            f"{ns}_llm_finished_total", "counter",
            "requests finished",
            [({"element": el}, float(st.get("finished", 0)))
             for el, st, _ in rows]))
        out.append(_series(
            f"{ns}_llm_chunk_prefills_total", "counter",
            "prompt chunks run through the chunked-prefill bucket",
            [({"element": el}, float(ex.get("chunk_prefills", 0)))
             for el, _, ex in rows]))
        out.append(_series(
            f"{ns}_llm_prefilling", "gauge",
            "requests mid chunked-prefill right now",
            [({"element": el}, float(st.get("prefilling", 0)))
             for el, st, _ in rows]))

    if devprof:
        jit = devprof.get("jit", [])
        inv = devprof.get("invoke", [])
        out.append(_series(
            f"{ns}_jit_flops", "gauge",
            "XLA cost-model FLOPs of the compiled program (a property "
            "of the (filter, bucket) program, not a rate)",
            [({"filter": r["filter"], "bucket": r["bucket"]},
              float(r["flops"])) for r in jit]
            or [({"filter": "none", "bucket": "none"}, 0.0)]))
        out.append(_series(
            f"{ns}_jit_bytes_accessed", "gauge",
            "XLA cost-model bytes accessed of the compiled program",
            [({"filter": r["filter"], "bucket": r["bucket"]},
              float(r["bytes_accessed"])) for r in jit]))
        out.append(_series(
            f"{ns}_jit_roofline_info", "gauge",
            "1 for the bucket's roofline verdict (compute / memory / "
            "unknown) vs the chip's ridge point",
            [({"filter": r["filter"], "bucket": r["bucket"],
               "bound": r["roofline"]}, 1.0) for r in jit]))
        out.append(_series(
            f"{ns}_compile_seconds_total", "counter",
            "cumulative compile wall-seconds per {filter, bucket}",
            [({"filter": r["filter"], "bucket": r["bucket"]},
              float(r["compile_s"])) for r in jit]
            or [({"filter": "none", "bucket": "none"}, 0.0)]))
        out.append(_series(
            f"{ns}_compiles_total", "counter",
            "compile events (fresh executables) per {filter, bucket}",
            [({"filter": r["filter"], "bucket": r["bucket"]},
              float(r["compiles"])) for r in jit]))
        out.append(_series(
            f"{ns}_invoke_mfu", "gauge",
            "model FLOPs utilization: achieved TFLOP/s over the "
            "declared per-chip peak (0 where no peak is declared — "
            "CPU emulation; see nns_invoke_mfu_calibrated)",
            [({"filter": r["filter"], "bucket": r["bucket"],
               "device": r["device"]}, float(r["mfu"])) for r in inv]
            or [({"filter": "none", "bucket": "none",
                  "device": "none"}, 0.0)]))
        out.append(_series(
            f"{ns}_invoke_mfu_calibrated", "gauge",
            "achieved TFLOP/s over the best achieved so far — the "
            "measured calibration denominator where no declared peak "
            "exists",
            [({"filter": r["filter"], "bucket": r["bucket"],
               "device": r["device"]}, float(r["mfu_calibrated"]))
             for r in inv]))
        out.append(_series(
            f"{ns}_invoke_tflops", "gauge",
            "achieved TFLOP/s (cost-model flops / median sampled "
            "device seconds)",
            [({"filter": r["filter"], "bucket": r["bucket"],
               "device": r["device"]}, float(r["achieved_tflops"]))
             for r in inv]))
        out.append(_series(
            f"{ns}_invoke_seconds_total", "counter",
            "cumulative sampled device-seconds per {filter, bucket} — "
            "reconcilable against the proctime histograms' sum from "
            "the same scrape",
            [({"filter": r["filter"], "bucket": r["bucket"]},
              float(r["seconds_total"])) for r in inv]
            or [({"filter": "none", "bucket": "none"}, 0.0)]))
        out.append(_series(
            f"{ns}_invoke_samples_total", "counter",
            "device-time samples taken per {filter, bucket}",
            [({"filter": r["filter"], "bucket": r["bucket"]},
              float(r["samples_total"])) for r in inv]))
        out.append(_series(
            f"{ns}_device_hbm_bytes", "gauge",
            "device memory ledger: memory_stats() rows per {device, "
            "kind} plus model:<label> attribution rows",
            [({"device": r["device"], "kind": r["kind"]},
              float(r["bytes"])) for r in devprof.get("hbm", [])]
            or [({"device": "none", "kind": "none"}, 0.0)]))
        out.append(_series(
            f"{ns}_device_hbm_headroom", "gauge",
            "fraction of the device's memory limit in use",
            [({"device": r["device"]}, float(r["frac"]))
             for r in devprof.get("headroom", [])]))
        out.append(_series(
            f"{ns}_device_peak_tflops", "gauge",
            "declared per-chip bf16 peak TFLOP/s applied as the MFU "
            "denominator (0 = none declared)",
            [({"device_kind": str(devprof.get("device_kind", "none"))},
              float(devprof.get("peak_tflops", 0.0)))]))
        out.append(_series(
            f"{ns}_device_calibration_tflops", "gauge",
            "best achieved TFLOP/s observed (the measured calibration "
            "peak on platforms with no declared peak)",
            [({}, float(devprof.get("calibration_tflops", 0.0)))]))

    if extra:
        for name, value in sorted(extra.items()):
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            out.append(_series(f"{ns}_{name}", "gauge",
                               "caller-supplied gauge", [({}, v)]))
    return out


# -- text exposition ---------------------------------------------------------

def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote,
    newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def render_prometheus(series: List[Series]) -> str:
    """Serialize series to the text exposition format (one # HELP and
    # TYPE line per family; histograms expand to cumulative le-buckets
    + _sum + _count)."""
    lines: List[str] = []
    for s in series:
        name, typ = s["name"], s["type"]
        help_ = s.get("help", "").replace("\\", "\\\\") \
            .replace("\n", "\\n")
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {typ}")
        for labels, value in s["samples"]:
            if typ == "histogram":
                bounds = value["bounds"]
                counts = value["counts"]
                cum = 0
                for b, c in zip(bounds, counts):
                    cum += c
                    bl = dict(labels, le=_fmt(b))
                    lines.append(
                        f"{name}_bucket{_labels_str(bl)} {cum}")
                cum += counts[len(bounds)] if len(counts) > len(bounds) \
                    else 0
                bl = dict(labels, le="+Inf")
                lines.append(f"{name}_bucket{_labels_str(bl)} {cum}")
                lines.append(f"{name}_sum{_labels_str(labels)} "
                             f"{repr(float(value['sum']))}")
                lines.append(f"{name}_count{_labels_str(labels)} "
                             f"{int(value['count'])}")
            else:
                lines.append(
                    f"{name}{_labels_str(labels)} {_fmt(value)}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, dict]:
    """Minimal exposition parser (tests + `top`): returns
    {family: {"type", "help", "samples": {sample_line_name+labels:
    value}}}. Handles escaped label values; not a full PromQL lexer —
    exactly the subset render_prometheus emits."""
    out: Dict[str, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            fam, _, help_ = rest.partition(" ")
            out.setdefault(fam, {"samples": {}})["help"] = help_
        elif line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            fam, _, typ = rest.partition(" ")
            out.setdefault(fam, {"samples": {}})["type"] = typ
        elif line.startswith("#"):
            continue
        else:
            key, _, val = line.rpartition(" ")
            base = key.split("{", 1)[0]
            fam = base
            for suffix in ("_bucket", "_sum", "_count"):
                if base.endswith(suffix) and \
                        base[:-len(suffix)] in out:
                    fam = base[:-len(suffix)]
                    break
            v = float("inf") if val == "+Inf" else float(val)
            out.setdefault(fam, {"samples": {}})["samples"][key] = v
    return out


# -- HTTP endpoint -----------------------------------------------------------

class MetricsServer:
    """Stdlib HTTP exposition endpoint.

    ``collect`` returns the current series list (called per scrape, on
    the HTTP thread — it must only read counters under their own
    locks). Routes: ``/metrics`` (text exposition), ``/healthz``
    (JSON), ``/`` (pointer). Serving uses ThreadingHTTPServer so a
    slow scraper cannot wedge a concurrent /healthz probe.
    """

    def __init__(self, collect: Callable[[], List[Series]],
                 host: str = "127.0.0.1", port: int = 0,
                 health: Optional[Callable[[], dict]] = None):
        import http.server

        self._collect = collect
        self._health = health
        self.scrapes = 0
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):           # noqa: N802 (stdlib contract)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    try:
                        body = render_prometheus(
                            outer._collect()).encode()
                    except Exception as e:   # a scrape must not 500 the
                        log.warning("metrics collect failed: %s", e)
                        self.send_error(503, "collect failed")
                        return
                    outer.scrapes += 1
                    self._ok(body, _CONTENT_TYPE)
                elif path == "/healthz":
                    info = {"ok": True, "scrapes": outer.scrapes}
                    if outer._health is not None:
                        try:
                            info.update(outer._health())
                        except Exception as e:
                            info = {"ok": False, "error": str(e)}
                    self._ok(json.dumps(info).encode(),
                             "application/json")
                elif path == "/":
                    self._ok(b"nnstreamer_tpu_torch metrics: GET /metrics\n",
                             "text/plain")
                else:
                    self.send_error(404)

            def _ok(self, body: bytes, ctype: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass                      # scrape spam stays off stderr

        self._httpd = http.server.ThreadingHTTPServer(
            (host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True)
        self._thread.start()
        log.info("metrics endpoint on http://%s:%d/metrics",
                 host, self.port)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def scrape(url: str, timeout_s: float = 5.0) -> str:
    """GET one exposition document (stdlib urllib; localhost scrapes)."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return r.read().decode()


# -- terminal top view --------------------------------------------------------

#: families the top view rates/ranks first, in display order
_TOP_KEY_FAMILIES = (
    "nns_admission_offered_total", "nns_admission_admitted_total",
    "nns_admission_replied_total", "nns_admission_rejected_total",
    "nns_admission_shed_total",
    # per-tenant rows: replied rate = goodput, shed/rejected rate =
    # shed rate, p99 gauge = SLO position (all labelled by tenant)
    "nns_tenant_replied_total", "nns_tenant_rejected_total",
    "nns_tenant_shed_total", "nns_tenant_p99_ms",
    "nns_worker_replied_total",
    # per-chip rows (serving/placement.py): invoke rate = per-device
    # goodput, queue depth = where the backpressure is, up = fences
    "nns_replica_invokes_total", "nns_replica_queue_depth",
    "nns_replica_up",
    # shard-group rows (serving/sharding.py): per-group goodput, the
    # group fence state, and the adopted swap epoch — one value across
    # groups means the flip was atomic
    "nns_shard_group_invokes_total", "nns_shard_group_up",
    "nns_shard_group_adopted_epoch",
    # autotuner rows: decision rate by knob/outcome + where every
    # controlled knob sits right now
    "nns_autotune_decisions_total", "nns_autotune_knob",
    # LLM serving rows: token rate = generation goodput, kernel invoke
    # rate = which attention path is hot, prefilling = admission wave
    "nns_llm_tokens_total", "nns_llm_kernel_invokes_total",
    "nns_llm_prefilling",
    # device performance plane (runtime/devprof.py): MFU and HBM
    # headroom answer "how close to the hardware" at a glance
    "nns_invoke_mfu", "nns_invoke_seconds_total",
    "nns_device_hbm_headroom", "nns_compile_seconds_total",
    "nns_pool_restarts_total", "nns_trace_events_total",
)


def top_table(prev: Dict[str, dict], cur: Dict[str, dict],
              dt_s: float) -> List[str]:
    """Render one refresh of the top view from two parsed scrapes:
    counters as rates over the interval, gauges as current values."""
    lines = [f"{'series':<56} {'value':>14} {'rate/s':>10}"]
    lines.append("-" * 82)

    def rows(order):
        for fam in order:
            info = cur.get(fam)
            if info is None:
                continue
            typ = info.get("type", "gauge")
            for key, v in sorted(info["samples"].items()):
                if key.endswith("_sum") or "_bucket{" in key or \
                        key.endswith("_count"):
                    continue
                rate = ""
                if typ == "counter" and fam in prev:
                    pv = prev[fam]["samples"].get(key)
                    if pv is not None and dt_s > 0:
                        rate = f"{max(0.0, (v - pv) / dt_s):.1f}"
                disp = key if len(key) <= 56 else key[:53] + "..."
                lines.append(f"{disp:<56} {v:>14.10g} {rate:>10}")

    rows([f for f in _TOP_KEY_FAMILIES if f in cur])
    rows(sorted(f for f in cur
                if f not in _TOP_KEY_FAMILIES
                and cur[f].get("type") != "histogram"))
    return lines


def top_view(url: str, interval_s: float = 1.0,
             iterations: int = 0, out=None) -> None:
    """Live terminal view over any exposition endpoint: scrape, diff,
    redraw. iterations=0 runs until interrupted."""
    import sys

    out = out or sys.stdout
    prev: Dict[str, dict] = {}
    prev_t = time.monotonic()
    n = 0
    while True:
        try:
            cur = parse_prometheus(scrape(url))
        except OSError as e:
            out.write(f"scrape {url} failed: {e}\n")
            return
        now = time.monotonic()
        lines = top_table(prev, cur, now - prev_t)
        out.write("\x1b[2J\x1b[H" if out.isatty() else "")
        out.write(f"nnstreamer_tpu_torch top — {url} "
                  f"(interval {interval_s:.1f}s)\n")
        out.write("\n".join(lines) + "\n")
        out.flush()
        prev, prev_t = cur, now
        n += 1
        if iterations and n >= iterations:
            return
        time.sleep(interval_s)

"""Scenario executor — compile a spec into a live world and run it.

The executor is deliberately thin: every primitive it drives already
exists and is already tested in isolation. `compile_arrivals` turns
the spec's arrival (and tenant-flood) programs into ONE merged
open-loop timeline; the topology builds into a real `PooledQueryServer`
(pool) or `MeshWorld` (mesh); fault programs become the refactored
fault-injector primitives — `schedule_worker_kills` timers, seeded
`ChaosProxy.program` schedules, swap-broadcast timers — all started
against one clock instant. The run itself is the standard
`run_open_loop` flood with tracing on, so the result carries the same
exhaustive accounting every drill in this repo reports.

Randomness discipline: every consumer draws from
``spec.sub_seed(kind, label)`` — arrival program ``a2`` gets the same
arrival trace whether the spec has one fault or five, which is what
makes delta-debugging shrinks (scenario/shrink.py) meaningful.

At quiesce the executor takes ONE scrape (front-door admission
counters, mesh per-host replied sum, post-close orphan audit, the
per-reply trace contexts) and hands it to the property checker
(scenario/checker.py); violations dump a `FlightRecorder` bundle with
the failing spec embedded.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.scenario.checker import check_result
from nnstreamer_tpu_torch.scenario.spec import ScenarioSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.traffic.admission import DEADLINE_META
from nnstreamer_tpu_torch.traffic.loadgen import (
    MeshWorld, bursty_arrivals, diurnal_arrivals, flash_crowd_arrivals,
    poisson_arrivals, run_open_loop, schedule_worker_kills)

log = get_logger("scenario.executor")

#: how long teardown waits for a fault timer already firing (a swap
#: broadcast is bounded at 5 s)
_TIMER_JOIN_S = 10.0


def compile_arrivals(spec: ScenarioSpec
                     ) -> "Tuple[np.ndarray, List[Optional[str]], List[dict]]":
    """Compile every arrival program — plus every ``tenant_flood``
    fault, which is load in a fault costume — into one merged global
    timeline. Returns ``(arrivals, owner, segments)``: cumulative
    times, the per-request tenant attribution, and a per-program
    summary (label/kind/tenant/n/window) for the report."""
    cap = spec.topology.capacity_rps
    pairs: List[tuple] = []
    segments: List[dict] = []

    def add(times: np.ndarray, tenant: Optional[str], label: str,
            kind: str) -> None:
        segments.append({
            "label": label, "kind": kind, "tenant": tenant,
            "n": int(len(times)), "t0_s": round(float(times[0]), 3),
            "t1_s": round(float(times[-1]), 3)})
        pairs.extend((float(t), tenant) for t in times)

    for a in spec.arrivals:
        rng = np.random.default_rng(spec.sub_seed("arrival", a.label))
        peak = a.rate_x * cap
        if a.kind == "constant":
            times = np.arange(1, a.n + 1) / peak
        elif a.kind == "poisson":
            times = poisson_arrivals(peak, a.n, rng)
        elif a.kind == "bursty":
            times = bursty_arrivals(
                a.n, rate_high_hz=peak, rate_low_hz=peak * a.low_x,
                mean_dwell_s=a.mean_dwell_s, rng=rng)
        elif a.kind == "diurnal":
            times = diurnal_arrivals(
                a.n, peak_hz=peak, trough_hz=peak * a.low_x,
                period_s=a.period_s, rng=rng)
        else:                          # flash_crowd (validated at load)
            times = flash_crowd_arrivals(
                a.n, base_hz=peak * a.low_x, peak_hz=peak,
                ramp_at_s=a.ramp_at_s, ramp_s=a.ramp_s, rng=rng)
        add(times + a.start_s, a.tenant, a.label, a.kind)
    for f in spec.faults:
        if f.kind != "tenant_flood":
            continue
        rng = np.random.default_rng(spec.sub_seed("fault", f.label))
        times = poisson_arrivals(f.rate_x * cap, f.n, rng) + f.at_s
        add(times, f.tenant, f.label, "tenant_flood")
    # sort by (t, tenant) so exact-tie order is spec-determined, not
    # list-order-determined (constant programs can collide exactly)
    pairs.sort(key=lambda p: (p[0], p[1] or ""))
    arrivals = np.asarray([t for t, _ in pairs])
    owner = [tenant for _, tenant in pairs]
    return arrivals, owner, segments


def _build_world(spec: ScenarioSpec):
    """Returns (front, world, table): the front door serving object
    (PooledQueryServer or MeshRouter), the MeshWorld (None on pool
    topologies), and the installed TenantTable (or None)."""
    from nnstreamer_tpu_torch.runtime.tracing import Tracer
    from nnstreamer_tpu_torch.serving.pool import PooledQueryServer
    from nnstreamer_tpu_torch.serving.tenancy import TenantTable

    topo = spec.topology
    table = TenantTable.from_dict({"tenants": dict(topo.tenants)}) \
        if topo.tenants else None
    if topo.kind == "pool":
        # an active tracer makes the workers stamp their hops, which
        # the trace_complete invariant audits on every reply
        front = PooledQueryServer.echo(
            workers=topo.workers, service_ms=topo.service_ms,
            max_pending=topo.max_pending,
            shed_policy=topo.shed_policy, tenants=table,
            tracer=Tracer())
        return front, None, table
    proxy_hosts = sorted({f.host for f in spec.faults
                          if f.kind in ("blackhole", "slow_close")})
    world = MeshWorld(
        hosts=topo.hosts, workers_per_host=topo.workers,
        service_ms=topo.service_ms, max_pending=topo.max_pending,
        lease_s=topo.lease_s, max_redeliver=topo.max_redeliver,
        seed=spec.sub_seed("netchaos"), proxy_hosts=proxy_hosts,
        trace_hosts=True, shed_policy=topo.shed_policy)
    if table is not None:
        try:
            world.router.set_tenants(table)
        except Exception:
            world.close()
            raise
    return world.router, world, table


def run_scenario(spec: ScenarioSpec, *,
                 flight_dir: Optional[str] = None,
                 drain_timeout_s: float = 20.0,
                 recovery_timeout_s: float = 15.0,
                 check: bool = True, recorder=None) -> dict:
    """Run one scenario against a real world; return the result dict:
    ``{scenario, seed, spec, report, admission, totals, orphans,
    fault_log, check}``. ``totals`` is the quiesce ledger the replay
    acceptance compares; ``check`` is the property-checker verdict
    (with a ``flight_bundle`` path when a violation dumped one)."""
    from nnstreamer_tpu_torch.serving.pool import proc_alive

    topo = spec.topology
    arrivals, owner, segments = compile_arrivals(spec)
    front, world, _table = _build_world(spec)
    pools = [front] if world is None else world.pools
    closed = False
    timers: List[threading.Timer] = []
    kill_schedules: List[dict] = []
    swap_log: List[dict] = []
    swap_lock = threading.Lock()
    proxy_events: Dict[int, list] = {}
    try:
        for f in spec.faults:
            if f.kind == "worker_kill":
                pool = pools[f.host].pool if world is not None \
                    else front.pool
                rng = np.random.default_rng(
                    spec.sub_seed("fault", f.label))
                sched, ts = schedule_worker_kills(
                    pool, workers=topo.workers, rng=rng,
                    kill_at_s=f.at_s, kills=f.kills)
                kill_schedules.append({"label": f.label,
                                       "host": f.host,
                                       "schedule": sched})
                timers.extend(ts)
            elif f.kind == "blackhole":
                evs = proxy_events.setdefault(f.host, [])
                evs.append((f.at_s, "blackhole"))
                if f.heal_after_s is not None:
                    evs.append((f.at_s + f.heal_after_s, "heal"))
            elif f.kind == "slow_close":
                proxy_events.setdefault(f.host, []).append(
                    (f.at_s, "slow_close", f.linger_s))
            elif f.kind == "swap_storm":
                def do_swap(j, f=f):
                    # bounded: a swap raced against a blackhole must
                    # not outlive the scenario waiting on a fenced host
                    try:
                        out = front.swap(f"scenario_{f.label}", j + 1,
                                         timeout_s=5.0)
                        ok = bool((out or {}).get("ok", True))
                    except Exception as e:
                        out, ok = {"error": str(e)}, False
                    with swap_lock:
                        swap_log.append({"label": f.label,
                                         "version": j + 1, "ok": ok})

                for j in range(f.swaps):
                    t = threading.Timer(f.at_s + j * f.interval_s,
                                        do_swap, args=(j,))
                    t.daemon = True
                    timers.append(t)
            # tenant_flood already compiled into the arrival timeline

        x = np.ones((8, 1), np.float32)
        tagged = any(o is not None for o in owner)

        def make_frame(i):
            from nnstreamer_tpu_torch.serving.tenancy import TENANT_META

            buf = TensorBuffer.of(x, pts=i)
            meta = {}
            if owner[i] is not None:
                meta[TENANT_META] = owner[i]
            if topo.shed_policy == "deadline-drop":
                meta[DEADLINE_META] = spec.slo.p99_budget_ms
            return buf.with_meta(**meta) if meta else buf

        t0 = time.monotonic()
        for host, evs in proxy_events.items():
            world.proxies[host].program(sorted(evs), t0=t0)
        for t in timers:
            t.start()
        try:
            report = run_open_loop(
                "127.0.0.1", front.port, dims="8:1", types="float32",
                arrivals=arrivals, make_frame=make_frame,
                p99_budget_ms=spec.slo.p99_budget_ms,
                drain_timeout_s=drain_timeout_s,
                depth_probe=front.depth_probe,
                group_of=(lambda i: owner[i] or "_untagged")
                if tagged else None,
                trace=True, collect_traces=True)
        finally:
            for t in timers:
                t.cancel()

        # fault settlement: programs run to their promised offsets
        # (the scenario clock, not the flood's early drain, owns them)
        fault_log: Dict[str, object] = {"kills": kill_schedules,
                                        "swaps": swap_log}
        recovered = None
        if proxy_events:
            for host, evs in proxy_events.items():
                last = max(e[0] for e in evs)
                remaining = (t0 + last) - time.monotonic()
                world.proxies[host].wait_program(
                    max(0.0, remaining) + 10.0)
            fault_log["proxies"] = {
                str(h): list(world.proxies[h].program_log)
                for h in proxy_events}
            healed = any(e[1] == "heal"
                         for evs in proxy_events.values() for e in evs)
            if healed:
                deadline = time.monotonic() + recovery_timeout_s
                while time.monotonic() < deadline and \
                        front.ready_hosts() < topo.hosts:
                    time.sleep(0.05)
                recovered = front.ready_hosts() >= topo.hosts
        if kill_schedules:
            ok = True
            for pqs in (pools if world is not None else [front]):
                ok = pqs.pool.wait_ready(recovery_timeout_s) and ok
            recovered = ok if recovered is None else (recovered and ok)

        c = front.admission_counters()
        perhost = None
        mesh_stats = None
        if world is not None:
            mesh_stats = front.stats()
            perhost = sum(h["replied"] for h in mesh_stats["hosts"])
        if recovered is not None:
            report["recovered"] = bool(recovered)

        # orphan audit must run AFTER close(): a pid still alive once
        # every pool drained is a leaked child. A fault timer still
        # firing finishes first, so none acts on a closed world
        for t in timers:
            if t.is_alive():
                t.join(_TIMER_JOIN_S)
        if world is not None:
            all_pids = world.all_pids()
            world.close()
        else:
            all_pids = front.pool.all_pids_ever()
            front.close()
        closed = True
        orphans = [p for p in all_pids if proc_alive(p)]

        totals = {
            "offered": c["offered"], "admitted": c["admitted"],
            "replied": c["replied"],
            "rejected": sum(c["rejected"].values()),
            "shed": sum(c["shed"].values()),
            "depth": c["depth"], "inflight": c["inflight"],
            "lost": report["lost"], "completed": report["completed"]}
        result = {
            "scenario": spec.name,
            "seed": spec.seed,
            "spec": spec.to_dict(),
            "capacity_rps": round(topo.capacity_rps, 1),
            "segments": segments,
            "report": report,
            "admission": c,
            "totals": totals,
            "orphans": orphans,
            "fault_log": fault_log,
        }
        if perhost is not None:
            result["perhost_replied_sum"] = perhost
        if mesh_stats is not None:
            result["mesh"] = mesh_stats
        if check:
            rec = recorder
            if rec is None and flight_dir:
                from nnstreamer_tpu_torch.runtime.flightrec import \
                    FlightRecorder

                rec = FlightRecorder(flight_dir, cooldown_s=0.0)
            result["check"] = check_result(result, spec, recorder=rec)
        return result
    finally:
        # every exit path: no fault timer fires into a closing world, and
        # one already firing (a swap bounded at 5 s, a kill) finishes
        # before the teardown below
        for t in timers:
            t.cancel()
        for t in timers:
            if t.is_alive():
                t.join(_TIMER_JOIN_S)
        if not closed:
            if world is not None:
                world.close()
            else:
                front.close()


def replay_scenario(result_or_spec: dict, **kw) -> dict:
    """Re-run the scenario a result (or bare spec dict) records, under
    the same root seed, and — when the input carries ``totals`` —
    compare the quiesce ledgers: ``replay_match`` is True iff
    offered/admitted/replied/rejected/shed all reproduce exactly."""
    d = result_or_spec.get("spec") \
        if isinstance(result_or_spec.get("spec"), dict) \
        else result_or_spec
    spec = ScenarioSpec.from_dict(d)
    second = run_scenario(spec, **kw)
    prev = result_or_spec.get("totals")
    if isinstance(prev, dict):
        keys = ("offered", "admitted", "replied", "rejected", "shed")
        diff = {k: [prev.get(k), second["totals"][k]] for k in keys
                if prev.get(k) != second["totals"][k]}
        second["replay_match"] = not diff
        if diff:
            second["replay_diff"] = diff
    return second

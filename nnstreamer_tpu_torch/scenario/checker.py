"""One property checker for the four standing invariants.

Every drill in this repo has asserted some subset of the same four
properties ad-hoc; this module is the single evaluation site, fed by
ONE scrape taken at quiesce (after the open-loop drain, before
teardown):

1. ``offered_admitted``  — ``offered == admitted + Σrejected`` at the
   front door, per tenant class and summed across classes.
2. ``admitted_settled``  — ``admitted == replied + Σshed + depth +
   inflight``, per class and summed; when the scrape carries a
   per-host replied sum (mesh), it must equal the router's replied —
   the cross-host form of the same books.
3. ``zero_orphans``      — no worker pid outlives its pool's close.
4. ``trace_complete``    — every replied frame's trace context carries
   the full serving hop chain (tracing.REQUIRED_REPLY_HOPS), and every
   completed request produced a trace at all.

Scenario SLO assertions (`ScenarioSLO`) layer on top: zero lost,
recovery, optional shed-rate and p99 gates. A violation is data —
``{"invariant", "detail"}`` — so the executor can hand the whole
verdict plus the failing spec to a `FlightRecorder` bundle
(``scenario_violation``) and the shrinker can re-evaluate candidates
mechanically.

The scrape is a plain dict (see `check_scrape`) precisely so tests can
hand-build violating scrapes for each invariant without spinning up a
single worker.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from nnstreamer_tpu_torch.runtime.tracing import (
    missing_hops, trace_chain_complete)

#: the four standing invariants, in evaluation order
INVARIANTS = ("offered_admitted", "admitted_settled", "zero_orphans",
              "trace_complete")


def _viol(out: List[dict], invariant: str, detail: str) -> None:
    out.append({"invariant": invariant, "detail": detail})


def _check_offered_admitted(c: dict, out: List[dict]) -> None:
    rej = sum(c.get("rejected", {}).values())
    if c["offered"] != c["admitted"] + rej:
        _viol(out, "offered_admitted",
              f"offered {c['offered']} != admitted {c['admitted']} + "
              f"rejected {rej}")
    for name, st in (c.get("classes") or {}).items():
        crej = sum(st.get("rejected", {}).values())
        if st["offered"] != st["admitted"] + crej:
            _viol(out, "offered_admitted",
                  f"class {name}: offered {st['offered']} != admitted "
                  f"{st['admitted']} + rejected {crej}")


def _check_admitted_settled(c: dict, out: List[dict],
                            perhost_replied_sum: Optional[int]) -> None:
    shed = sum(c.get("shed", {}).values())
    if c["admitted"] != (c["replied"] + shed + c["depth"]
                         + c["inflight"]):
        _viol(out, "admitted_settled",
              f"admitted {c['admitted']} != replied {c['replied']} + "
              f"shed {shed} + depth {c['depth']} + inflight "
              f"{c['inflight']}")
    classes = c.get("classes") or {}
    sums = {k: 0 for k in ("offered", "admitted", "replied",
                           "rejected", "shed", "depth", "inflight")}
    for name, st in classes.items():
        cshed = sum(st.get("shed", {}).values())
        if st["admitted"] != (st["replied"] + cshed + st["depth"]
                              + st["inflight"]):
            _viol(out, "admitted_settled",
                  f"class {name}: admitted {st['admitted']} != replied "
                  f"{st['replied']} + shed {cshed} + depth "
                  f"{st['depth']} + inflight {st['inflight']}")
        sums["offered"] += st["offered"]
        sums["admitted"] += st["admitted"]
        sums["replied"] += st["replied"]
        sums["rejected"] += sum(st.get("rejected", {}).values())
        sums["shed"] += cshed
        sums["depth"] += st["depth"]
        sums["inflight"] += st["inflight"]
    if classes:
        want = {"offered": c["offered"], "admitted": c["admitted"],
                "replied": c["replied"],
                "rejected": sum(c.get("rejected", {}).values()),
                "shed": sum(c.get("shed", {}).values()),
                "depth": c["depth"], "inflight": c["inflight"]}
        for k, v in want.items():
            if sums[k] != v:
                _viol(out, "admitted_settled",
                      f"class sums: Σ{k} {sums[k]} != global {v}")
    if perhost_replied_sum is not None \
            and perhost_replied_sum != c["replied"]:
        _viol(out, "admitted_settled",
              f"Σ per-host replied {perhost_replied_sum} != router "
              f"replied {c['replied']}")


def _check_traces(scrape: dict, out: List[dict]) -> None:
    traces = scrape.get("traces")
    if traces is None:
        return                        # untraced run: nothing to prove
    completed = scrape.get("completed")
    if completed is not None and len(traces) != completed:
        _viol(out, "trace_complete",
              f"{completed} replies but only {len(traces)} carried a "
              f"trace context home")
    for pts, ctx in traces.items():
        hops = (ctx or {}).get("hops") or []
        if not trace_chain_complete(hops):
            _viol(out, "trace_complete",
                  f"pts {pts} (trace {ctx.get('id')}): missing hops "
                  f"{list(missing_hops(hops))}")
            return                    # one example is enough evidence


def check_scrape(scrape: dict, *, slo=None) -> dict:
    """Evaluate the four invariants (and optional `ScenarioSLO`
    assertions) over one scrape::

        {"admission": AdmissionQueue.counters() dict,   # required
         "orphans": [pid, ...],                          # required
         "completed": int,             # replies the client matched
         "traces": {pts: trace_ctx},   # per-reply contexts (optional)
         "perhost_replied_sum": int,   # mesh cross-host sum (optional)
         "report": {...}}              # loadgen report for SLO gates

    Returns ``{"ok", "invariants": {name: bool}, "violations":
    [{"invariant", "detail"}, ...]}``. SLO violations use invariant
    name ``"slo"`` and do not affect the four standing flags."""
    c = scrape.get("admission")
    if not isinstance(c, dict):
        raise ValueError("scrape needs an 'admission' counters dict")
    violations: List[dict] = []
    _check_offered_admitted(c, violations)
    _check_admitted_settled(c, violations,
                            scrape.get("perhost_replied_sum"))
    orphans = scrape.get("orphans") or []
    if orphans:
        _viol(violations, "zero_orphans",
              f"{len(orphans)} worker pid(s) outlived close(): "
              f"{list(orphans)[:8]}")
    _check_traces(scrape, violations)

    report = scrape.get("report") or {}
    if slo is not None:
        if getattr(slo, "require_zero_lost", False) \
                and report.get("lost", 0) != 0:
            _viol(violations, "slo",
                  f"lost must be 0, got {report.get('lost')}")
        if getattr(slo, "require_recovered", False) \
                and not report.get("recovered", False):
            _viol(violations, "slo", "world did not recover (fence/"
                  "restart budget missed)")
        max_shed = getattr(slo, "max_shed_rate", None)
        if max_shed is not None \
                and report.get("shed_rate", 0.0) > max_shed:
            _viol(violations, "slo",
                  f"shed_rate {report.get('shed_rate')} > "
                  f"{max_shed}")
        if getattr(slo, "enforce_p99", False):
            p99 = (report.get("latency_ms") or {}).get("p99")
            budget = getattr(slo, "p99_budget_ms", None)
            if p99 is not None and budget is not None and p99 > budget:
                _viol(violations, "slo",
                      f"p99 {p99}ms > budget {budget}ms")

    flags: Dict[str, bool] = {
        name: not any(v["invariant"] == name for v in violations)
        for name in INVARIANTS}
    return {"ok": not violations, "invariants": flags,
            "violations": violations}


def check_result(result: dict, spec=None, *, recorder=None) -> dict:
    """Check an executor result (scenario/executor.py shape) and, on
    any violation, dump a flight-recorder bundle with the failing spec
    embedded in the cause (``flight --inspect`` renders it). Returns
    the `check_scrape` verdict, plus ``flight_bundle`` when a bundle
    was published."""
    scrape = {
        "admission": result["admission"],
        "orphans": result.get("orphans") or [],
        "completed": (result.get("report") or {}).get("completed"),
        "traces": (result.get("report") or {}).get("traces"),
        "perhost_replied_sum": result.get("perhost_replied_sum"),
        "report": result.get("report") or {},
    }
    verdict = check_scrape(scrape, slo=spec.slo if spec else None)
    if not verdict["ok"] and recorder is not None:
        cause = {
            "scenario": result.get("scenario"),
            "seed": result.get("seed"),
            "violations": verdict["violations"],
            "scenario_spec": (spec.to_dict() if spec is not None
                              else result.get("spec")),
        }
        try:
            path = recorder.trigger("scenario_violation", cause)
            if path:
                verdict["flight_bundle"] = path
        except Exception:              # forensics must not mask the
            pass                       # violation verdict itself
    return verdict

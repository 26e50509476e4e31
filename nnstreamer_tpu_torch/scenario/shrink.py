"""Deterministic delta-debugging shrinker for failing scenarios.

Given a spec whose run violates an invariant, find a *smaller* spec
that still fails — the classic ddmin loop (Zeller & Hildebrandt,
"Simplifying and Isolating Failure-Inducing Input"), specialised to
the two axes a scenario can shrink along:

1. drop fault programs (ddmin over the fault tuple),
2. drop arrival programs (ddmin, keeping at least one — a scenario
   with no load proves nothing),
3. halve each surviving arrival's ``n`` while the failure persists.

Determinism is the whole point: labels are assigned by ORIGINAL
position (spec.py), so a survivor keeps its exact sub-seed — and
therefore its exact arrival trace and fault randomness — no matter
which siblings were deleted around it. Candidates are memoised by
canonical spec JSON, the predicate is injected (tests use synthetic
predicates; the CLI uses a live `run_scenario` check), and the whole
search is bounded by ``max_runs``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.scenario.spec import ScenarioSpec

log = get_logger("scenario.shrink")


class ShrinkBudgetExceeded(RuntimeError):
    """Raised when the predicate budget runs out mid-search."""


def _with(spec: ScenarioSpec, *, arrivals=None, faults=None
          ) -> ScenarioSpec:
    """A candidate spec with some programs removed / resized. Labels
    are already pinned on the survivors (frozen fields), so their
    sub-seeds ride along untouched."""
    return dataclasses.replace(
        spec,
        arrivals=tuple(arrivals if arrivals is not None
                       else spec.arrivals),
        faults=tuple(faults if faults is not None else spec.faults))


def _ddmin(items: Sequence, rebuild: Callable[[list], ScenarioSpec],
           fails: Callable[[ScenarioSpec], bool],
           min_keep: int = 0) -> List:
    """Minimise `items` under `fails(rebuild(subset))` — returns a
    subset that still fails, of at most the input size. Deterministic:
    chunks are scanned in order, no randomness."""
    items = list(items)
    if len(items) <= min_keep:
        return items
    granularity = 2
    while len(items) > min_keep:
        chunk = max(1, len(items) // granularity)
        shrunk = False
        i = 0
        while i < len(items):
            rest = items[:i] + items[i + chunk:]
            if len(rest) >= min_keep and fails(rebuild(rest)):
                items = rest            # this chunk was irrelevant
                granularity = max(2, granularity - 1)
                shrunk = True
            else:
                i += chunk
        if not shrunk:
            if chunk == 1:
                break
            granularity = min(len(items), granularity * 2)
    return items


def shrink(spec: ScenarioSpec,
           fails: Callable[[ScenarioSpec], bool], *,
           max_runs: int = 200) -> Tuple[ScenarioSpec, dict]:
    """Shrink `spec` to a minimal still-failing repro.

    `fails(candidate)` must return True when the candidate still
    reproduces the violation (the CLI wires this to
    ``not run_scenario(candidate)["check"]["ok"]``; tests inject
    synthetic predicates). The ORIGINAL spec must fail — ValueError
    otherwise (there is nothing to shrink toward).

    Returns ``(minimal_spec, stats)`` with ``stats = {"runs",
    "cache_hits", "initial_size", "final_size"}``. Deterministic:
    same spec + same predicate → same minimal repro, run for run.
    """
    cache: Dict[str, bool] = {}
    stats = {"runs": 0, "cache_hits": 0,
             "initial_size": spec.size(), "final_size": None}

    def check(candidate: ScenarioSpec) -> bool:
        key = candidate.to_json()
        if key in cache:
            stats["cache_hits"] += 1
            return cache[key]
        if stats["runs"] >= max_runs:
            raise ShrinkBudgetExceeded(
                f"shrink exceeded max_runs={max_runs}")
        stats["runs"] += 1
        verdict = bool(fails(candidate))
        cache[key] = verdict
        return verdict

    if not check(spec):
        raise ValueError("original spec does not fail — nothing to "
                         "shrink (predicate returned False)")

    cur = spec
    # axis 1: drop fault programs
    faults = _ddmin(cur.faults,
                    lambda fs: _with(cur, faults=fs), check)
    cur = _with(cur, faults=faults)
    # axis 2: drop arrival programs (a scenario needs ≥1 load segment
    # unless a tenant_flood fault survives to provide the load)
    has_flood = any(f.kind == "tenant_flood" for f in cur.faults)
    arrivals = _ddmin(cur.arrivals,
                      lambda ars: _with(cur, arrivals=ars), check,
                      min_keep=0 if has_flood else 1)
    cur = _with(cur, arrivals=arrivals)
    # axis 3: halve each surviving arrival's n while still failing
    progressed = True
    while progressed:
        progressed = False
        for i, a in enumerate(cur.arrivals):
            while a.n > 1:
                smaller = dataclasses.replace(a, n=a.n // 2)
                cand = _with(cur, arrivals=[
                    smaller if j == i else x
                    for j, x in enumerate(cur.arrivals)])
                if not check(cand):
                    break
                cur, a = cand, smaller
                progressed = True
    stats["final_size"] = cur.size()
    log.info("shrink: %s size %d -> %d in %d runs (%d cached)",
             spec.name, stats["initial_size"], stats["final_size"],
             stats["runs"], stats["cache_hits"])
    return cur, stats

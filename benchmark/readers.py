"""The arithmetic of the metrics: each file under `metrics/` binds one
of these to a metric's name. A reader takes the run's record and returns
a number, or None where the run holds nothing for it to read (the metric
is then left out of the result line; a share of a peak or a roofline is
never reported as 0 for want of a reading)."""

from __future__ import annotations

from typing import Optional, Tuple

from benchmark.cost import mobilenet_v2 as mbv2_cost
from benchmark.cost import peaks
from benchmark.cost import transformer as tcost

#: the symbol of the port's paged decode kernel, as the trace names it
DECODE_KERNEL = "nns_paged_decode"


def _trace(run: dict) -> Optional[dict]:
    """The run's device trace, None where it lost its records."""
    tr = run.get("trace")
    return tr if tr is not None and tr.get("valid", True) else None


# -- end to end (host clock) -------------------------------------------------

def setup_s(run: dict) -> float:
    return float(run["setup_s"])


def frames_per_s(run: dict) -> Optional[float]:
    if "frames_in_window" not in run:
        return None
    return run["frames_in_window"] / run["window_s"]


def output_tokens_per_s(run: dict) -> Optional[float]:
    """Every token that reached the sink in the window, over the
    window."""
    if "requests" not in run:
        return None
    t0, t1 = run["t0"], run["t1"]
    n = sum(1 for r in run["requests"] for a in r.arrivals if t0 <= a < t1)
    return n / run["window_s"]


# -- per layer: the pipeline ------------------------------------------------

def _sub_stats(run: dict):
    sub = run.get("sub")
    if not sub or "stats" not in sub or not sub.get("frames"):
        return None
    return sub["stats"][0], sub["stats"][1], sub["frames"]


def sched_host_ms_per_frame(run: dict) -> Optional[float]:
    """Host milliseconds every element's worker spent in process() (the
    scheduler's proctime counters) per frame, over the traced
    sub-window."""
    got = _sub_stats(run)
    if got is None:
        return None
    s0, s1, frames = got
    total = sum(s1[k]["proctime_total_s"] - s0[k]["proctime_total_s"]
                for k in s1 if k in s0)
    return total * 1e3 / frames


def window_frame_share(run: dict) -> Optional[float]:
    """% of the model filter's frames served inside compiled windows."""
    got = _sub_stats(run)
    if got is None:
        return None
    s0, s1, _ = got
    steps = buffers = 0
    for k, d in s1.items():
        if "compiled_steps" in d and k in s0:
            steps += d["compiled_steps"] - s0[k]["compiled_steps"]
            buffers += d["buffers"] - s0[k]["buffers"]
    return 100.0 * steps / buffers if buffers else None


def device_ms_per_frame(run: dict) -> Optional[float]:
    tr, got = _trace(run), _sub_stats(run)
    if tr is None or got is None:
        return None
    return sum(tr["kernels"].values()) * 1e3 / got[2]


def mfu_frames(run: dict) -> Optional[float]:
    """The analytic MobileNetV2 operations of the frames that reached the
    sink in the traced sub-window, over it, as a % of the card's bf16
    peak."""
    got = _sub_stats(run)
    p = peaks.peaks(run.get("device", {}).get("kind", ""))
    if got is None or p is None:
        return None
    flops = mbv2_cost.frame_flops(run["config"]) * got[2]
    return 100.0 * flops / run["sub"]["host_s"] / p[0]


def device_idle(run: dict) -> Optional[float]:
    """% of the traced window in which no operation ran on the card."""
    tr = _trace(run)
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


# -- per layer: the LLM ---------------------------------------------------
#
# The traced run keeps the executor's spans (the driver's `SpanTap`):
# each decode call with its rows and each row's context, each prefill
# call with its first position and length, those whose spans closed in
# the traced sub-window under `run["sub"]`.

def _spans(run: dict):
    """(decode calls, prefill calls) of the sub-window; None where a
    span could not be read."""
    sub = run.get("sub")
    if not sub or "decodes" not in sub or sub.get("misses"):
        return None
    return sub["decodes"], sub["prefills"]


def rows_per_decode_step(run: dict) -> Optional[float]:
    """Rows per decode call over the traced sub-window, from the
    executor's decode spans (each carries its live rows)."""
    got = _spans(run)
    if got is None or not got[0]:
        return None
    decodes = got[0]
    return sum(d[1] for d in decodes) / len(decodes)


def kv_high_water(run: dict) -> Optional[float]:
    """% of the pool's allocatable blocks held at the allocator's high
    water mark."""
    v = run.get("kv_high_water")
    return None if v is None else 100.0 * v


def _decode_work(run: dict) -> Optional[Tuple[float, float, float, float]]:
    """(operations, bytes, linear operations, measured seconds) of the
    paged decode kernel in the traced sub-window. The rows and contexts
    are those of the decode spans that closed in the host sub-window,
    scaled by the decode launches the trace holds over the layers times
    those calls (a call at an edge runs partly outside the trace)."""
    tr, got = _trace(run), _spans(run)
    if tr is None or got is None or not got[0]:
        return None
    decodes = got[0]
    cfg, bs = run["config"], int(run["mix"]["element"]["block_size"])
    layers = tcost.dims(cfg)["layers"]
    launches = sum(n for k, n in tr["launches"].items() if DECODE_KERNEL in k)
    secs = sum(s for k, s in tr["kernels"].items() if DECODE_KERNEL in k)
    if not launches:
        return None
    scale = (launches / layers) / len(decodes)
    ctxs = [c for d in decodes for c in d[2]]
    f, b = tcost.sum_decode(cfg, ctxs, bs)
    lin = sum(tcost.token_flops(cfg, c) for c in ctxs)
    return f * scale, b * scale, lin * scale, secs


def _roofline(run: dict, work) -> Optional[float]:
    if work is None or work[3] <= 0:
        return None
    t = peaks.least_time(work[0], work[1], run.get("device", {}).get("kind"))
    return None if t is None else 100.0 * t / work[3]


def paged_decode_roofline(run: dict) -> Optional[float]:
    """% of the paged decode kernel's bound: the larger of its operations
    over the bf16 peak and its bytes (K and V at bf16 width) over the
    memory peak, over the kernel's summed time in the trace."""
    return _roofline(run, _decode_work(run))


def mfu_tokens(run: dict) -> Optional[float]:
    """The analytic operations of every decode row and prefill token of
    the traced sub-window (live tokens only: no bucket padding), over
    the sub-window, as a % of the card's bf16 peak."""
    tr, got = _trace(run), _spans(run)
    p = peaks.peaks(run.get("device", {}).get("kind", ""))
    if tr is None or got is None or p is None:
        return None
    decode = _decode_work(run)
    flops = decode[2] if decode is not None else 0.0
    flops += sum(tcost.prefill_flops(run["config"], p0, n)
                 for _, p0, n in got[1])
    if not flops:
        return None
    return 100.0 * flops / tr["window_s"] / p[0]

"""What every cell's run shares: the checkout's caches, the cell's files,
the card check, the import guard, the device trace and its reduction,
and the result line.

Nothing here names a cell: a cell is found by its name in
`BENCHMARK.json`, its configuration, traffic and limits by the file
names that entry gives, and its metrics by their names under
`metrics/`.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

#: the benchmark's folder and the checkout holding it
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: seconds after which a run dumps its threads' stacks and exits
RUN_LIMIT_S = 340.0

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "nnstreamer_tpu")


def cache_env(root: Path = ROOT) -> Dict[str, str]:
    """Fixed directories inside the checkout for every build and kernel
    cache: the port's nvcc-built libraries, Triton's, Inductor's and the
    CUDA driver's JIT cache. Set before torch or the port is imported."""
    build = root / "build"
    env = {
        "NNSTREAMER_TPU_TORCH_BUILD_KERNEL_DIR": str(build / "torch_kernels"),
        "TRITON_CACHE_DIR": str(build / "triton_cache"),
        "TORCHINDUCTOR_CACHE_DIR": str(build / "inductor_cache"),
        "CUDA_CACHE_PATH": str(build / "cuda_cache"),
        # nothing in a run reads the bucket manifest under HOME
        "NNSTREAMER_TPU_TORCH_SERVING_COMPILE_CACHE": "0",
        "USE_FLAX": "0",
    }
    os.environ.update(env)
    return env


def process_age_s() -> float:
    """Seconds since this process started (from /proc, 10 ms ticks)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.process_time()


# -- the cell's files ---------------------------------------------------------

class Cell:
    """One entry of BENCHMARK.json's `workloads`, with its files read."""

    def __init__(self, name: str, root: Path = ROOT):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads(
            (root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (BENCH / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads(
            (BENCH / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])]


def load_metric(name: str):
    """The reader of metric `name`: `metrics/<name>.py`'s `read`."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(entry: str):
    """`drivers/<entry>.py` as a module."""
    return importlib.import_module(f"benchmark.drivers.{entry}")


# -- guards -------------------------------------------------------------------

def require_cards(n: int) -> None:
    """Exit non-zero, printing no result, unless `n` CUDA cards are
    visible. A run never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs only on the card",
              file=sys.stderr)
        raise SystemExit(3)
    if torch.cuda.device_count() < n:
        print(f"the cell needs {n} cards, {torch.cuda.device_count()} "
              f"visible", file=sys.stderr)
        raise SystemExit(3)


def forbidden_loaded(modules: Sequence[str] = ()) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `nnstreamer_tpu_torch` passes."""
    names = modules or list(sys.modules)
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def card_info(index: int = 0) -> dict:
    """The card's name, its power limit (nvidia-smi) and the process's
    device memory peak."""
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(index),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(index))}
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def stop_runner(runner, timeout: float) -> None:
    """Stop a pipeline and wait for its threads, on every path out of a
    run (a process must not exit with them alive; where the run is
    already failing, an error of the wait is chained to that one)."""
    runner.stop()
    runner.wait(timeout)


# -- statistics ---------------------------------------------------------------

def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile by nearest rank (no interpolation): the
    smallest value with at least q% of the sample at or below it."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


# -- the device trace ---------------------------------------------------------

#: names in a trace that mark the traced window's bounds
MARK_START, MARK_STOP = "bench:window_start", "bench:window_stop"
#: entries kept in each list of a breakdown
BREAKDOWN_TOP = 10
#: host events searched backward from a gap for the one running in it
_SCAN = 256


class DeviceTrace:
    """`torch.profiler` over a bounded sub-window of a run, reduced to
    what the per-layer metrics read: kernel seconds and launches by
    name, the device's busy seconds, the window's seconds, and the
    breakdown (top device operations; idle gaps by what the launching
    host thread was running)."""

    def __init__(self):
        self.prof = None
        self.host = (0.0, 0.0)   # perf_counter at start and stop

    @staticmethod
    def warm() -> None:
        """Start the profiler once outside the window, so its first-use
        set-up does not land in it."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        with record_function(MARK_START):
            t = time.perf_counter()
        self.host = (t, t)
        self._torch = torch

    def mark_stop(self) -> None:
        """End the traced window; the profiler records on until `finish`
        (records after the mark are left out)."""
        from torch.profiler import record_function

        with record_function(MARK_STOP):
            t = time.perf_counter()
        self.host = (self.host[0], t)

    def finish(self) -> None:
        t = time.perf_counter()
        self.prof.stop()
        print(f"trace: stopped in {time.perf_counter() - t:.2f} s",
              file=sys.stderr)

    def stop(self) -> None:
        self.mark_stop()
        self.finish()



    def reduce(self) -> dict:
        """The trace's summary (the raw records are dropped)."""
        from torch.autograd import DeviceType

        t = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        print(f"trace: {len(events)} records read in "
              f"{time.perf_counter() - t:.2f} s", file=sys.stderr)
        ws = we = None
        dev: List[Tuple[int, int, str, int]] = []
        host: Dict[int, List[Tuple[int, int, str]]] = {}
        launch_thread: Dict[int, int] = {}
        launched: List[Tuple[int, int]] = []    # (start ns, correlation)
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.start_ns(), e.end_ns(), name,
                            e.correlation_id()))
                continue
            if name == MARK_START:
                ws = e.start_ns()
            elif name == MARK_STOP:
                we = e.start_ns()
            tid = e.start_thread_id()
            host.setdefault(tid, []).append((e.start_ns(), e.end_ns(), name))
            if e.correlation_id():
                launch_thread[e.correlation_id()] = tid
                if name.startswith(LAUNCHES):
                    launched.append((e.start_ns(), e.correlation_id()))
        self.prof = None
        if ws is None or we is None or we <= ws:
            raise RuntimeError("the device trace lacks its window marks")
        out = summarize(dev, host, launch_thread, ws, we)
        out["host_window"] = list(self.host)
        out["launch_coverage"] = coverage(launched, dev, ws, we)
        out["valid"] = (out["launch_coverage"] is not None
                        and out["launch_coverage"] >= MIN_COVERAGE)
        print(f"trace: {out['launch_coverage']!r} of the window's kernel "
              f"and graph launches have device records (valid at "
              f"{MIN_COVERAGE!r}); busy {out['busy_s']!r} s of "
              f"{out['window_s']!r} s", file=sys.stderr)
        return out


#: host calls that put kernels on the card; each has device records
#: under its correlation id unless the profiler lost them
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")
#: launches this long before the window's end are checked (later ones
#: may still be queued on the card when the profiler stops)
COVERAGE_MARGIN_NS = 250_000_000
#: share of those launches that must have device records for the trace
#: to be read; below it the profiler lost records
MIN_COVERAGE = 0.98


def coverage(launched: List[Tuple[int, int]],
             dev: List[Tuple[int, int, str, int]], ws: int,
             we: int) -> Optional[float]:
    """The share of the kernel and graph launches made in the window
    (up to COVERAGE_MARGIN_NS before its end) whose correlation id has a
    device record; None where there was no such launch."""
    ids = {c for s, c in launched if ws <= s < we - COVERAGE_MARGIN_NS}
    if not ids:
        return None
    seen = {d[3] for d in dev}
    return len(ids & seen) / len(ids)


def summarize(dev: List[Tuple[int, int, str, int]],
              host: Dict[int, List[Tuple[int, int, str]]],
              launch_thread: Dict[int, int], ws: int, we: int) -> dict:
    """Device records (start ns, end ns, name, correlation) clipped to
    the window [ws, we] → seconds and launches by name, busy seconds
    (the union of the records' intervals), the window's seconds and the
    breakdown: the top device operations, and the idle gaps summed by
    what the thread that launched the work ending each gap was running
    (`host`: per thread, its host records; `launch_thread`: correlation
    → thread)."""
    dev = sorted(dev)
    kernels: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    busy = 0
    cur_s = cur_e = None
    gaps: List[Tuple[int, int, int]] = []   # (start, end, correlation)
    for s, e, name, corr in dev:
        if e <= ws or s >= we:
            continue
        s, e = max(s, ws), min(e, we)
        kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-9
        launches[name] = launches.get(name, 0) + 1
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            prev = ws if cur_e is None else cur_e
            if s > prev:
                gaps.append((prev, s, corr))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    tail = ws if cur_e is None else cur_e
    if we > tail:
        gaps.append((tail, we, 0))
    for evs in host.values():
        evs.sort()
    idle: Dict[str, float] = {}
    for g0, g1, corr in gaps:
        name = _host_activity(host, launch_thread.get(corr), (g0 + g1) // 2)
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-9
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
    return {
        "busy_s": busy * 1e-9,
        "window_s": (we - ws) * 1e-9,
        "kernels": kernels,
        "launches": launches,
        "breakdown": {
            "device_ops": [[_short(n), s] for n, s in top],
            "idle_gaps": [[_short(n), s] for n, s in top_idle]},
    }


#: sub-windows tried before a traced run gives up
TRACE_ATTEMPTS = 3


def trace_window(t0: float, seconds: float, span: float) -> dict:
    """Profile a sub-window of `span` seconds inside the window [t0, t0 +
    seconds], up to TRACE_ATTEMPTS of them spread over it, until one
    holds its device records. → the trace's summary (its `host_window`
    gives the sub-window on the host clock); where every attempt lost
    its records, the last, marked not `valid` (the readers of the
    device's numbers then find nothing to read)."""
    span = min(span, seconds / (TRACE_ATTEMPTS + 1))
    kept = None
    for k in range(TRACE_ATTEMPTS):
        start = t0 + seconds * (k + 1) / (TRACE_ATTEMPTS + 1) - span / 2
        if time.perf_counter() + span > t0 + seconds:
            break
        sleep_until(start)
        tracer = DeviceTrace()
        tracer.start()
        sleep_until(time.perf_counter() + span)
        tracer.stop()
        kept = tracer.reduce()
        if kept["valid"]:
            return kept
    if kept is None:
        raise RuntimeError("the window was too short for a traced sub-window")
    return kept


def sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def _host_activity(host: Dict[int, list], tid: Optional[int],
                   t: int) -> str:
    """What thread `tid` (the thread that launched the work that ended
    the gap) was running at time `t`: the innermost host event holding
    `t`, or that it was between recorded ops."""
    if tid is None or tid not in host:
        return "no launch recorded after the gap"
    evs = host[tid]
    i = bisect.bisect_right(evs, (t, float("inf"), ""))
    for j in range(i - 1, max(-1, i - 1 - _SCAN), -1):
        s, e, name = evs[j]
        if e >= t:
            return name
    return "host between recorded ops"


# -- the result line ----------------------------------------------------------

def emit(result: dict, checks: List[Tuple[str, float, float]]) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output,
    with the checks under the key that comes last."""
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    result = dict(result)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)

"""Open-loop load harness — Poisson/bursty arrivals + latency-SLO report
(the JAX package's traffic/loadgen.py on the port).

Closed-loop load (send, wait, send) lets a slow server throttle its own
offered load and flatter its tail — the coordinated-omission trap. This
harness is *open-loop*: arrival times are pre-drawn from the arrival
process and every request is sent at its scheduled time regardless of
completions, so overload actually happens and the report shows what the
server did about it.

Arrival processes:

- ``poisson_arrivals(rate, n)``  — memoryless, the standard serving
  baseline (exponential inter-arrivals).
- ``bursty_arrivals(n, ...)``    — Markov-modulated on/off: the source
  alternates between a high-rate and a low-rate state with
  exponentially-distributed dwell times. Same mean rate as a Poisson
  source can carry; the bursts are what break naive admission.

- ``diurnal_arrivals(n, ...)``   — inhomogeneous Poisson whose rate
  swings sinusoidally between a trough and a peak (a day/night load
  curve compressed to seconds).
- ``flash_crowd_arrivals(n, ...)`` — base-rate Poisson until
  ``ramp_at_s``, then a linear ramp to the peak rate over ``ramp_s``
  that stays there: the thundering-herd shape scenario drills
  (scenario/) compose with faults.

Each draws from the numpy generator in the reference's order, so one seed
gives the reference's arrival times.

Per-request outcome accounting is exhaustive: every sent request ends
as *completed* (RESULT received), *rejected* (typed BUSY received), or
*lost* (neither — a crash or silent drop). A healthy bounded server
under overload reports nonzero ``rejected`` and ZERO ``lost``; the seed
behavior (silent queue drop) shows up as ``lost`` > 0.

The drills: `run_against_echo` floods the in-process `EchoServer` (a
live bounded query server with a known service time);
`run_autotune_ramp` ramps one through overload with the SLO autotuner
bound to its live queue; `run_multitenant` / `noisy_neighbor_drill`
flood a weighted-fair multi-tenant worker pool; `run_against_pool`
SIGKILLs pool workers mid-flood (`schedule_worker_kills`, shared with
the scenario executor); `MeshWorld` / `run_against_mesh` build a
`MeshRouter` over pool hosts and flood it while one host is partitioned
(serving/mesh.py, traffic/netchaos.py). Every report carries a
``{"seed", "schedule"}`` block that `replay_report` re-runs.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.traffic.admission import DEADLINE_META
from nnstreamer_tpu_torch.edge import protocol as P
from nnstreamer_tpu_torch.edge.wire import decode_buffer, encode_buffer
from nnstreamer_tpu_torch.runtime.tracing import (
    ensure_trace_ctx, get_trace_ctx, hop_spans, percentile)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

log = get_logger("traffic.loadgen")


# -- arrival processes -------------------------------------------------------

def poisson_arrivals(rate_hz: float, n: int,
                     rng: Optional[np.random.Generator] = None
                     ) -> np.ndarray:
    """`n` cumulative arrival times (s) of a Poisson process at
    `rate_hz` requests/s."""
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    rng = rng or np.random.default_rng(0)
    return np.cumsum(rng.exponential(1.0 / rate_hz, size=n))


def bursty_arrivals(n: int, *, rate_high_hz: float, rate_low_hz: float,
                    mean_dwell_s: float = 0.25,
                    rng: Optional[np.random.Generator] = None
                    ) -> np.ndarray:
    """`n` cumulative arrival times of a Markov-modulated on/off
    process: exponential dwell (`mean_dwell_s`) in each state, drawing
    exponential inter-arrivals at that state's rate. Starts in the
    high-rate state."""
    if rate_high_hz <= 0 or rate_low_hz <= 0:
        raise ValueError("both state rates must be > 0")
    rng = rng or np.random.default_rng(0)
    out: List[float] = []
    t = 0.0
    high = True
    state_end = float(rng.exponential(mean_dwell_s))
    while len(out) < n:
        rate = rate_high_hz if high else rate_low_hz
        t += float(rng.exponential(1.0 / rate))
        while t >= state_end:        # dwell expired: flip state
            high = not high
            state_end += float(rng.exponential(mean_dwell_s))
        out.append(t)
    return np.asarray(out)


def _inhomogeneous_arrivals(n: int, rate_of: Callable[[float], float],
                            rng: np.random.Generator) -> np.ndarray:
    """`n` cumulative arrival times of an inhomogeneous Poisson process
    whose instantaneous rate is `rate_of(t)`: each inter-arrival gap is
    drawn exponential at the rate in force when it starts. For rates
    that vary slowly relative to the gap (every program here) this is
    indistinguishable from thinning and stays strictly sequential in
    the rng — one draw per arrival, so seeds replay bit-exact."""
    out: List[float] = []
    t = 0.0
    for _ in range(n):
        t += float(rng.exponential(1.0 / max(rate_of(t), 1e-9)))
        out.append(t)
    return np.asarray(out)


def diurnal_arrivals(n: int, *, peak_hz: float, trough_hz: float,
                     period_s: float = 4.0,
                     rng: Optional[np.random.Generator] = None
                     ) -> np.ndarray:
    """`n` cumulative arrival times whose rate swings sinusoidally
    between `trough_hz` and `peak_hz` with period `period_s`, starting
    at the midpoint on the rising edge."""
    if trough_hz <= 0 or peak_hz < trough_hz:
        raise ValueError(
            f"need 0 < trough_hz <= peak_hz, got {trough_hz}/{peak_hz}")
    if period_s <= 0:
        raise ValueError(f"period_s must be > 0, got {period_s}")
    rng = rng if rng is not None else np.random.default_rng(0)
    mid = (peak_hz + trough_hz) / 2.0
    amp = (peak_hz - trough_hz) / 2.0
    return _inhomogeneous_arrivals(
        n, lambda t: mid + amp * float(np.sin(2 * np.pi * t / period_s)),
        rng)


def flash_crowd_arrivals(n: int, *, base_hz: float, peak_hz: float,
                         ramp_at_s: float, ramp_s: float = 0.5,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
    """`n` cumulative arrival times of a flash crowd: Poisson at
    `base_hz` until `ramp_at_s`, then a linear rate ramp to `peak_hz`
    over `ramp_s` that never comes back down."""
    if base_hz <= 0 or peak_hz < base_hz:
        raise ValueError(
            f"need 0 < base_hz <= peak_hz, got {base_hz}/{peak_hz}")
    if ramp_at_s < 0 or ramp_s <= 0:
        raise ValueError(
            f"need ramp_at_s >= 0 and ramp_s > 0, got "
            f"{ramp_at_s}/{ramp_s}")
    rng = rng if rng is not None else np.random.default_rng(0)

    def rate_of(t: float) -> float:
        if t < ramp_at_s:
            return base_hz
        frac = min(1.0, (t - ramp_at_s) / ramp_s)
        return base_hz + (peak_hz - base_hz) * frac

    return _inhomogeneous_arrivals(n, rate_of, rng)


# -- open-loop runner --------------------------------------------------------

def run_open_loop(host: str, port: int, *, dims: str,
                  types: str = "float32",
                  arrivals: np.ndarray,
                  make_frame: Callable[[int], TensorBuffer],
                  p99_budget_ms: float = 250.0,
                  drain_timeout_s: float = 15.0,
                  hello_timeout_s: float = 10.0,
                  depth_probe: Optional[Callable[[], int]] = None,
                  depth_sample_ms: float = 25.0,
                  group_of: Optional[Callable[[int], str]] = None,
                  trace: bool = False,
                  collect_traces: bool = False,
                  on_result: Optional[Callable[[int, TensorBuffer], None]]
                  = None) -> dict:
    """Drive one live query server open-loop; return the SLO report.

    make_frame(i) builds request i's TensorBuffer (its pts is forced to
    i — the pts echo is how outcomes are matched). `depth_probe`, when
    the server is in-process, samples its admission-queue depth on a
    timeline; remote servers still get depth points from every BUSY
    payload.

    ``on_result(i, buf)``, when given, sees every decoded RESULT on the
    client's reader thread (the report keeps outcomes and times only).

    ``trace=True`` gives every frame a trace context
    (runtime/tracing.py): the server stack stamps its hops into the
    meta and the reply carries them home, so the report gains a
    ``hop_breakdown`` — the per-stage latency decomposition (admission
    wait / route / worker queue / service / reply) of the worst-p99
    request. The client_send/client_recv hops are recorded LOCALLY
    from the send/complete clocks, not serialized, so the send path
    stays one pre-encoded sendall per frame.
    """
    n = len(arrivals)
    if n == 0:
        raise ValueError("arrivals is empty")
    done: Dict[int, float] = {}      # pts -> completion t
    busy: Dict[int, dict] = {}       # pts -> BUSY payload
    traces: Dict[int, dict] = {}     # pts -> reply trace ctx
    evt_lock = threading.Lock()
    all_answered = threading.Event()
    hello_q: List[tuple] = []
    hello_evt = threading.Event()
    timeline: List[List[float]] = []  # [t_rel_s, depth]
    t0 = [0.0]                        # set when the clock starts

    def on_message(mtype: int, payload: bytes) -> None:
        now = time.perf_counter()
        if mtype in (P.T_HELLO_ACK, P.T_HELLO_NAK):
            hello_q.append((mtype, payload))
            hello_evt.set()
            return
        with evt_lock:
            if mtype == P.T_RESULT:
                try:
                    buf, _ = decode_buffer(payload)
                except ValueError as e:
                    log.warning("loadgen: corrupt result dropped: %s", e)
                    return
                if buf.pts is not None:
                    done[int(buf.pts)] = now
                    if on_result is not None:
                        on_result(int(buf.pts), buf)
                    if trace:
                        ctx = get_trace_ctx(buf.meta)
                        if ctx:
                            traces[int(buf.pts)] = ctx
            elif mtype == P.T_BUSY:
                try:
                    info = json.loads(payload.decode())
                except ValueError:
                    info = {}
                pts = info.get("pts")
                if pts is not None:
                    busy[int(pts)] = info
                if "queue_depth" in info:
                    timeline.append([now - t0[0],
                                     int(info["queue_depth"])])
            if len(done) + len(busy) >= n:
                all_answered.set()

    client = P.MsgClient(host, port, on_message=on_message)
    try:
        client.send(P.T_HELLO,
                    json.dumps({"dims": dims, "types": types}).encode())
        if not hello_evt.wait(hello_timeout_s):
            raise StreamError(
                f"loadgen: query server {host}:{port} did not answer the "
                f"caps handshake within {hello_timeout_s}s")
        kind, payload = hello_q[0]
        if kind == P.T_HELLO_NAK:
            raise StreamError(
                f"loadgen: server rejected caps: {payload.decode()}")

        # pre-encode every frame: send-time work is one sendall, so the
        # arrival schedule is honored to sub-ms even at high rates
        frames = []
        for i in range(n):
            buf = make_frame(i)
            if trace:
                ensure_trace_ctx(buf.meta)
            frames.append(encode_buffer(
                buf.with_tensors(buf.tensors, pts=i)))

        stop_sampler = threading.Event()
        sampler = None
        t0[0] = time.perf_counter()
        if depth_probe is not None:
            def sample():
                while not stop_sampler.is_set():
                    try:
                        d = int(depth_probe())
                    except Exception:
                        break
                    with evt_lock:
                        timeline.append(
                            [time.perf_counter() - t0[0], d])
                    stop_sampler.wait(depth_sample_ms / 1e3)
            sampler = threading.Thread(target=sample, daemon=True,
                                       name="loadgen-depth")
            sampler.start()

        sent_at: List[float] = []
        send_errors = 0
        for i, t_arr in enumerate(arrivals):
            now = time.perf_counter() - t0[0]
            if t_arr > now:
                time.sleep(t_arr - now)
            sent_at.append(time.perf_counter())
            try:
                client.send(P.T_DATA, frames[i])
            except StreamError:
                send_errors += 1
                break                 # connection died: everything after
                                      # this counts as lost
        # drain: wait for every sent request to resolve (or time out)
        all_answered.wait(drain_timeout_s)
        elapsed = time.perf_counter() - t0[0]
        stop_sampler.set()
        if sampler is not None:
            sampler.join(timeout=2)
    finally:
        client.close()

    with evt_lock:
        n_sent = len(sent_at)
        lat_ms = sorted((done[i] - sent_at[i]) * 1e3
                        for i in list(done) if i < n_sent)
        completed = len(lat_ms)
        rejected = sum(1 for i in busy if i < n_sent)
        causes: Dict[str, int] = {}
        retry_hints = []
        for i, info in busy.items():
            if i >= n_sent:
                continue
            causes[info.get("cause", "?")] = \
                causes.get(info.get("cause", "?"), 0) + 1
            if "retry_after_ms" in info:
                retry_hints.append(float(info["retry_after_ms"]))
        tl = sorted(timeline)
    lost = n_sent - completed - rejected
    within = sum(1 for v in lat_ms if v <= p99_budget_ms)
    # offered rate is a property of the SEND window; elapsed also spans
    # the drain wait, which would understate it for any run that queues
    send_window = (sent_at[-1] - t0[0]) if sent_at else 0.0
    report = {
        "offered": n_sent,
        "completed": completed,
        "rejected": rejected,
        "lost": lost,
        "send_errors": send_errors,
        "duration_s": round(elapsed, 3),
        "offered_rate_rps": round(n_sent / send_window, 2)
        if send_window else 0.0,
        "throughput_rps": round(completed / elapsed, 2) if elapsed else 0.0,
        "goodput_rps": round(within / elapsed, 2) if elapsed else 0.0,
        "within_budget": within,
        "p99_budget_ms": p99_budget_ms,
        "shed_rate": round(rejected / n_sent, 4) if n_sent else 0.0,
        "busy_causes": causes,
    }
    if group_of is not None:
        # per-group outcome partition: pts IS the request index, so
        # group_of(i) attributes every sent request to exactly one
        # group — the same exhaustive completed/rejected/lost
        # accounting as the summed report, just filtered
        groups: Dict[str, dict] = {}
        for i in range(n_sent):
            g = str(group_of(i))
            row = groups.setdefault(g, {
                "offered": 0, "completed": 0, "rejected": 0,
                "lost": 0, "busy_causes": {}, "_lat": []})
            row["offered"] += 1
            if i in done:
                row["completed"] += 1
                row["_lat"].append((done[i] - sent_at[i]) * 1e3)
            elif i in busy:
                row["rejected"] += 1
                cause = busy[i].get("cause", "?")
                row["busy_causes"][cause] = \
                    row["busy_causes"].get(cause, 0) + 1
            else:
                row["lost"] += 1
        for row in groups.values():
            lats = sorted(row.pop("_lat"))
            w = sum(1 for v in lats if v <= p99_budget_ms)
            row["within_budget"] = w
            row["goodput_rps"] = \
                round(w / elapsed, 2) if elapsed else 0.0
            row["shed_rate"] = (
                round(row["rejected"] / row["offered"], 4)
                if row["offered"] else 0.0)
            if lats:
                row["latency_ms"] = {
                    "p50": round(percentile(lats, 50), 2),
                    "p99": round(percentile(lats, 99), 2),
                    "max": round(lats[-1], 2)}
        report["groups"] = groups
    if lat_ms:
        report["latency_ms"] = {
            "p50": round(percentile(lat_ms, 50), 2),
            "p95": round(percentile(lat_ms, 95), 2),
            "p99": round(percentile(lat_ms, 99), 2),
            "max": round(lat_ms[-1], 2)}
    if retry_hints:
        retry_hints.sort()
        report["retry_after_ms_p50"] = round(
            percentile(retry_hints, 50), 1)
    if trace and lat_ms:
        # worst-p99 point: the completed request at the p99 latency
        # rank — decompose ITS end-to-end time by hop, from the trace
        # context its reply carried home
        per = {i: (done[i] - sent_at[i]) * 1e3
               for i in done if i < n_sent}
        p99v = percentile(lat_ms, 99)
        at_p99 = [i for i, v in per.items() if v >= p99v]
        pick = min(at_p99, key=lambda i: per[i]) if at_p99 else None
        if pick is not None:
            hops = [{"hop": "client_send", "t": sent_at[pick],
                     "pid": os.getpid()}]
            hops += list(traces.get(pick, {}).get("hops", []))
            hops.append({"hop": "client_recv", "t": done[pick],
                         "pid": os.getpid()})
            spans = hop_spans(hops)
            report["hop_breakdown"] = {
                "pts": pick,
                "latency_ms": round(per[pick], 2),
                "trace_id": traces.get(pick, {}).get("id"),
                "hops": [h["hop"] for h in
                         sorted(hops, key=lambda h: h.get("t", 0.0))],
                "spans": {k: (round(v, 3) if isinstance(v, float)
                              else v) for k, v in spans.items()},
            }
        report["traced_replies"] = len(traces)
        if collect_traces:
            # raw per-reply trace contexts, keyed by pts — what the
            # scenario property checker needs to prove every replied
            # frame carries the full hop chain
            report["traces"] = {int(i): ctx for i, ctx in traces.items()
                                if i < n_sent}
        # redelivery audit: replies whose trace context carries a
        # router/mesh "reoffer" hop survived a worker death or a host
        # fence — list which workers/hosts each one touched, proving
        # one trace_id spans the whole failover
        redelivered = []
        for i, ctx in traces.items():
            hops = [h for h in ctx.get("hops", [])
                    if isinstance(h, dict)]
            if not any(h.get("hop") == "reoffer" for h in hops):
                continue
            redelivered.append({
                "pts": i,
                "trace_id": ctx.get("id"),
                "hosts": sorted({str(h["host"]) for h in hops
                                 if h.get("hop") == "dispatch"
                                 and "host" in h}),
                "wids": sorted({int(h["wid"]) for h in hops
                                if h.get("hop") == "dispatch"
                                and "wid" in h}),
            })
        report["redelivered"] = len(redelivered)
        report["redelivered_examples"] = redelivered[:3]
    if tl:
        # downsample the timeline to <= 200 points, keep the peak honest
        step = max(1, len(tl) // 200)
        report["queue_depth_peak"] = max(d for _, d in tl)
        report["queue_depth_timeline"] = [
            [round(t, 3), int(d)] for t, d in tl[::step]]
    return report


# -- self-contained server (CLI / tests share it) ----------------------------

class EchoServer:
    """A live bounded query server with a known service time: serversrc
    → custom filter (sleeps `service_ms`, returns its input) →
    serversink. Capacity is 1000/service_ms rps by construction, which
    is what lets the harness express load as a multiple of capacity.
    The filter declares its output spec (its input's), so it is never
    probed on a device: frames stay the host arrays the wire gave."""

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, *, dims: str = "8:1", types: str = "float32",
                 service_ms: float = 5.0, max_pending: int = 16,
                 max_inflight: int = 0,
                 shed_policy: str = "reject-newest", port: int = 0):
        import nnstreamer_tpu_torch as nns
        from nnstreamer_tpu_torch.backends.custom import register_custom_easy

        with EchoServer._seq_lock:
            EchoServer._seq += 1
            self.sid = 9000 + EchoServer._seq
        self.dims, self.types = dims, types
        self.service_ms = service_ms
        model = f"traffic_echo_{self.sid}"
        delay = service_ms / 1e3

        def serve(ts):
            if delay > 0:
                time.sleep(delay)
            return ts

        register_custom_easy(model, serve, infer_out=lambda spec: spec)
        self.pipe = nns.parse_launch(
            f"tensor_query_serversrc name=src id={self.sid} port={port} "
            f"dims={dims} types={types} max_pending={max_pending} "
            f"max_inflight={max_inflight} shed_policy={shed_policy} ! "
            f"tensor_filter framework=custom model={model} ! "
            f"tensor_query_serversink id={self.sid}")
        self.runner = nns.PipelineRunner(self.pipe).start()
        self.src = self.pipe.get("src")
        self.port = self.src.port

    @property
    def capacity_rps(self) -> float:
        return 1e3 / self.service_ms if self.service_ms > 0 else 1e6

    def admission_counters(self) -> dict:
        return self.src.admission_counters()

    def depth_probe(self) -> int:
        from nnstreamer_tpu_torch.edge.query import QueryServer

        return QueryServer.get(self.sid).frames.depth

    def crashed(self) -> bool:
        return self.runner._error is not None

    def stop(self) -> None:
        from nnstreamer_tpu_torch.backends.custom import unregister_custom_easy

        try:
            self.runner.stop()
        finally:
            unregister_custom_easy(f"traffic_echo_{self.sid}")


def run_against_echo(*, pattern: str = "poisson", load_x: float = 2.0,
                     n: int = 200, service_ms: float = 5.0,
                     max_pending: int = 16, max_inflight: int = 0,
                     shed_policy: str = "reject-newest",
                     p99_budget_ms: Optional[float] = None,
                     seed: int = 0, trace: bool = False) -> dict:
    """One self-contained harness run: bounded echo server + open-loop
    load at `load_x` × its capacity. The shape the CLI and tests share."""
    rng = np.random.default_rng(seed)
    srv = EchoServer(service_ms=service_ms, max_pending=max_pending,
                     max_inflight=max_inflight, shed_policy=shed_policy)
    try:
        rate = load_x * srv.capacity_rps
        if pattern == "poisson":
            arrivals = poisson_arrivals(rate, n, rng)
        elif pattern == "bursty":
            arrivals = bursty_arrivals(
                n, rate_high_hz=2 * rate, rate_low_hz=max(rate / 4, 0.5),
                rng=rng)
        else:
            raise ValueError(
                f"pattern must be poisson|bursty, got {pattern!r}")
        if p99_budget_ms is None:
            # budget: full queue's worth of waiting + one service time
            p99_budget_ms = (max_pending + 2) * service_ms
        x = np.ones((8, 1), np.float32)

        def make_frame(i):
            buf = TensorBuffer.of(x, pts=i)
            if shed_policy == "deadline-drop":
                # deadline-drop only purges frames that carry a budget;
                # without this stamp the policy silently degrades to
                # reject-newest in the harness
                buf = buf.with_meta(**{DEADLINE_META: p99_budget_ms})
            return buf

        report = run_open_loop(
            "127.0.0.1", srv.port, dims=srv.dims, types=srv.types,
            arrivals=arrivals,
            make_frame=make_frame,
            p99_budget_ms=p99_budget_ms,
            depth_probe=srv.depth_probe, trace=trace)
        report["pattern"] = pattern
        report["load_x"] = load_x
        report["service_ms"] = service_ms
        report["capacity_rps"] = round(srv.capacity_rps, 1)
        report["server_crashed"] = srv.crashed()
        report["admission"] = srv.admission_counters()
        report["seed"] = int(seed)
        report["schedule"] = {
            "kind": "echo", "pattern": pattern, "load_x": load_x,
            "n": n, "service_ms": service_ms,
            "max_pending": max_pending, "max_inflight": max_inflight,
            "shed_policy": shed_policy,
            "p99_budget_ms": p99_budget_ms, "trace": bool(trace)}
        return report
    finally:
        srv.stop()


def _arrivals_for(pattern: str, rate: float, n: int,
                  rng: np.random.Generator) -> np.ndarray:
    if pattern == "poisson":
        return poisson_arrivals(rate, n, rng)
    if pattern == "bursty":
        return bursty_arrivals(n, rate_high_hz=2 * rate,
                               rate_low_hz=max(rate / 4, 0.5), rng=rng)
    raise ValueError(f"pattern must be poisson|bursty, got {pattern!r}")


def conservation_ok(c: dict) -> bool:
    """The admission invariants, checked over an admission counters()
    snapshot — they must hold exactly even across a worker kill."""
    return (c["offered"] == c["admitted"] + sum(c["rejected"].values())
            and c["admitted"] == c["replied"] + sum(c["shed"].values())
            + c["depth"] + c["inflight"])


def tenant_conservation_ok(c: dict) -> bool:
    """Per-class form of the invariants: each class's counters must
    close exactly on their own, AND the classes must sum back to the
    global counters — shed load can move between classes only through
    the books."""
    if not conservation_ok(c):
        return False
    classes = c.get("classes")
    if not classes:
        return True
    sums = {k: 0 for k in ("offered", "admitted", "replied",
                           "rejected", "shed", "depth", "inflight")}
    for st in classes.values():
        rej = sum(st["rejected"].values())
        shed = sum(st["shed"].values())
        if st["offered"] != st["admitted"] + rej:
            return False
        if st["admitted"] != (st["replied"] + shed
                              + st["depth"] + st["inflight"]):
            return False
        sums["offered"] += st["offered"]
        sums["admitted"] += st["admitted"]
        sums["replied"] += st["replied"]
        sums["rejected"] += rej
        sums["shed"] += shed
        sums["depth"] += st["depth"]
        sums["inflight"] += st["inflight"]
    return (sums["offered"] == c["offered"]
            and sums["admitted"] == c["admitted"]
            and sums["replied"] == c["replied"]
            and sums["rejected"] == sum(c["rejected"].values())
            and sums["shed"] == sum(c["shed"].values())
            and sums["depth"] == c["depth"]
            and sums["inflight"] == c["inflight"])


# -- autotune ramp drill -----------------------------------------------------

def run_autotune_ramp(*, ramp=(0.5, 1.0, 1.5, 2.0, 2.5),
                      n_per_step: int = 120, service_ms: float = 5.0,
                      static_max_pending: int = 64,
                      p99_budget_ms: Optional[float] = None,
                      tuned: bool = True, dry_run: bool = False,
                      tick_interval_s: float = 0.25,
                      cooldown_s: float = 0.5,
                      seed: int = 0) -> dict:
    """Open-loop ramp (default 0.5→2.5× capacity, one Poisson segment
    per step) against a bounded echo server, with or without the SLO
    autotuner (serving/autotune.py) closing the loop live.

    Both arms start from the same deliberately mis-set hand config — a
    ``max_pending`` deep enough that queue wait alone blows the p99
    budget under overload. ``tuned=False`` is the static baseline;
    ``tuned=True`` binds an AutoTuner to the server's live admission
    queue, which derives the Little's-law bound from the measured
    reply rate and shrinks the queue until the budget holds. Same
    arrival trace (same seed) either way, so the reports compare
    directly: the tuned arm's win is goodput (completions *within
    budget* per second), not raw throughput.

    The report carries the full audit: ``autotune`` (AutoTuner.stats()
    — every decision), ``conservation_after_apply`` (the admission
    conservation invariants re-checked immediately after every applied
    knob change, mid-flood), and ``conservation_final``."""
    rng = np.random.default_rng(seed)
    # reject-oldest: overload displaces the stalest queued request
    # (which gets a BUSY), and a live max_pending shrink sheds excess
    # entries as victims — every sent request still resolves, so the
    # zero-lost accounting holds through every knob change
    srv = EchoServer(service_ms=service_ms,
                     max_pending=static_max_pending,
                     shed_policy="reject-oldest")
    tuner = None
    try:
        segs = []
        t_off = 0.0
        for x in ramp:
            a = poisson_arrivals(x * srv.capacity_rps, n_per_step, rng) \
                + t_off
            t_off = float(a[-1])
            segs.append(a)
        arrivals = np.concatenate(segs)
        if p99_budget_ms is None:
            # ~18 service times: far less than the static queue's
            # worth of waiting (so the hand config visibly fails it)
            # but wide enough to absorb the drill's own service
            # jitter — the sleep-based echo service overshoots on a
            # loaded host, putting the latency tail at ~2x the median
            # independent of queue depth, and a budget under that
            # floor is unmeetable at any bound
            p99_budget_ms = 18.0 * service_ms
        conservation_after_apply: List[bool] = []
        applied: List[dict] = []
        if tuned:
            from nnstreamer_tpu_torch.edge.query import QueryServer
            from nnstreamer_tpu_torch.serving.autotune import AutoTuner, SLOSpec

            qsrv = QueryServer.get(srv.sid)
            adm = qsrv.frames

            def on_apply(rec):
                conservation_after_apply.append(
                    conservation_ok(adm.counters()))
                applied.append({"knob": rec["knob"], "old": rec["old"],
                                "new": rec["new"]})

            def on_victims(victims):
                for v in victims:
                    try:
                        qsrv.send_busy(v.meta.get("client_id"), v.pts,
                                       "bound_shrink")
                    except Exception:
                        log.warning("autotune victim BUSY failed",
                                    exc_info=True)

            tuner = AutoTuner(
                SLOSpec(p99_budget_ms=p99_budget_ms),
                admission=adm, interval_s=tick_interval_s,
                cooldown_s=cooldown_s, dry_run=dry_run,
                on_apply=on_apply, on_victims=on_victims).start()
        x0 = np.ones((8, 1), np.float32)
        report = run_open_loop(
            "127.0.0.1", srv.port, dims=srv.dims, types=srv.types,
            arrivals=arrivals,
            make_frame=lambda i: TensorBuffer.of(x0, pts=i),
            p99_budget_ms=p99_budget_ms,
            depth_probe=srv.depth_probe)
        if tuner is not None:
            tuner.stop()
            report["autotune"] = tuner.stats()
            report["audit"] = tuner.audit()
            report["conservation_after_apply"] = conservation_after_apply
            report["applied"] = applied
        report["conservation_final"] = conservation_ok(
            srv.admission_counters())
        report["admission"] = srv.admission_counters()
        report["ramp"] = [float(x) for x in ramp]
        report["capacity_rps"] = round(srv.capacity_rps, 1)
        report["service_ms"] = service_ms
        report["static_max_pending"] = static_max_pending
        report["tuned"] = bool(tuned)
        report["dry_run"] = bool(dry_run)
        report["server_crashed"] = srv.crashed()
        report["seed"] = int(seed)
        report["schedule"] = {
            "kind": "autotune_ramp", "ramp": [float(x) for x in ramp],
            "n_per_step": n_per_step, "service_ms": service_ms,
            "static_max_pending": static_max_pending,
            "p99_budget_ms": p99_budget_ms, "tuned": bool(tuned),
            "dry_run": bool(dry_run),
            "tick_interval_s": tick_interval_s,
            "cooldown_s": cooldown_s}
        return report
    finally:
        if tuner is not None:
            tuner.stop()
        srv.stop()


# -- multi-tenant harness ----------------------------------------------------

def merge_tenant_arrivals(schedules: Dict[str, np.ndarray]
                          ) -> "tuple[np.ndarray, List[str]]":
    """Merge per-tenant arrival schedules into one global timeline.
    Returns (arrivals, owner) where owner[i] is the tenant whose
    schedule produced arrival i — the pts→tenant map that lets one
    open-loop run stamp and account per tenant."""
    pairs: List[tuple] = []
    for name, times in schedules.items():
        pairs.extend((float(t), name) for t in times)
    pairs.sort()
    arrivals = np.asarray([t for t, _ in pairs])
    owner = [name for _, name in pairs]
    return arrivals, owner


def run_multitenant(*, tenants: Dict[str, dict],
                    n_per_tenant: Dict[str, int],
                    rate_hz: Dict[str, float],
                    workers: int = 2, service_ms: float = 10.0,
                    max_pending: int = 32,
                    shed_policy: str = "reject-oldest",
                    p99_budget_ms: float = 250.0, seed: int = 0,
                    drain_timeout_s: float = 15.0,
                    **pool_kwargs) -> dict:
    """One multi-tenant harness run: a worker POOL fronted by the WFQ
    admission queue (a TenantTable built from `tenants`), flooded by
    the merged per-tenant Poisson schedules in `rate_hz`/`n_per_tenant`.
    Every frame is stamped with its tenant meta; the report's
    ``groups`` partition the outcome per tenant, and ``conserved``
    checks the invariants per class AND summed.

    `tenants` maps name -> TenantClass kwargs (weight, deadline_ms,
    max_pending, model) — the same dict shape TenantTable.from_dict
    accepts as its "tenants" entry.
    """
    from nnstreamer_tpu_torch.serving.pool import PooledQueryServer
    from nnstreamer_tpu_torch.serving.tenancy import TENANT_META, TenantTable

    rng = np.random.default_rng(seed)
    table = TenantTable.from_dict({"tenants": dict(tenants)})
    schedules = {
        name: poisson_arrivals(rate_hz[name], n_per_tenant[name], rng)
        for name in tenants if n_per_tenant.get(name, 0) > 0}
    if not schedules:
        raise ValueError("no tenant has a nonzero request count")
    arrivals, owner = merge_tenant_arrivals(schedules)

    pqs = PooledQueryServer.echo(
        workers=workers, service_ms=service_ms,
        max_pending=max_pending, shed_policy=shed_policy,
        tenants=table, **pool_kwargs)
    try:
        x = np.ones((8, 1), np.float32)

        def make_frame(i):
            return TensorBuffer.of(x, pts=i).with_meta(
                **{TENANT_META: owner[i]})

        report = run_open_loop(
            "127.0.0.1", pqs.port, dims=pqs.pool.spec.dims,
            types=pqs.pool.spec.types, arrivals=arrivals,
            make_frame=make_frame, p99_budget_ms=p99_budget_ms,
            drain_timeout_s=drain_timeout_s,
            depth_probe=pqs.depth_probe,
            group_of=lambda i: owner[i])
        c = pqs.admission_counters()
        report.update({
            "service_ms": service_ms, "workers": workers,
            "capacity_rps": round(pqs.capacity_rps, 1),
            "seed": int(seed),
            "tenants": {name: {"rate_hz": rate_hz.get(name),
                               "n": n_per_tenant.get(name, 0)}
                        for name in tenants},
            "conserved": tenant_conservation_ok(c),
            "admission": c,
            "schedule": {
                "kind": "multitenant",
                "tenants": {k: dict(v) for k, v in tenants.items()},
                "n_per_tenant": dict(n_per_tenant),
                "rate_hz": {k: float(v) for k, v in rate_hz.items()},
                "workers": workers, "service_ms": service_ms,
                "max_pending": max_pending,
                "shed_policy": shed_policy,
                "p99_budget_ms": p99_budget_ms},
        })
        return report
    finally:
        pqs.close()


def noisy_neighbor_drill(*, victim_weight: float = 1.0,
                         flood_weight: float = 1.0,
                         victim_x: float = 0.5, flood_x: float = 3.0,
                         n_victim: int = 120,
                         workers: int = 2, service_ms: float = 10.0,
                         max_pending: int = 32,
                         deadline_ms: Optional[float] = None,
                         seed: int = 0, **kw) -> dict:
    """The noisy-neighbor acceptance drill: tenant ``flood`` offers
    `flood_x` × its fair share while ``victim`` stays at `victim_x` ×
    its own. Two runs — the victim alone (baseline), then contested —
    and the verdict is the contested/solo goodput ratio: weighted-fair
    admission must keep the victim's goodput and p99 where they were,
    with the overage shed FROM THE FLOODER (cause tenant_over_share).

    Returns {solo, contested, victim_goodput_ratio, victim_p99_ms,
    victim_p99_budget_ms, conserved, zero_lost}.
    """
    capacity = workers * 1e3 / service_ms
    total_w = victim_weight + flood_weight
    victim_share = capacity * victim_weight / total_w
    flood_share = capacity * flood_weight / total_w
    victim_rate = victim_x * victim_share
    flood_rate = flood_x * flood_share
    # matched send windows: the flooder floods for as long as the
    # victim is offering, so contention covers the whole run
    n_flood = max(1, int(round(
        n_victim / victim_rate * flood_rate)))
    if deadline_ms is None:
        # a full fair-share queue's worth of waiting + one service time
        deadline_ms = (max_pending + 2) * service_ms
    tenants = {
        "victim": {"weight": victim_weight, "deadline_ms": deadline_ms},
        "flood": {"weight": flood_weight, "deadline_ms": deadline_ms},
    }

    solo = run_multitenant(
        tenants=tenants,
        n_per_tenant={"victim": n_victim, "flood": 0},
        rate_hz={"victim": victim_rate, "flood": flood_rate},
        workers=workers, service_ms=service_ms,
        max_pending=max_pending, p99_budget_ms=deadline_ms,
        seed=seed, **kw)
    contested = run_multitenant(
        tenants=tenants,
        n_per_tenant={"victim": n_victim, "flood": n_flood},
        rate_hz={"victim": victim_rate, "flood": flood_rate},
        workers=workers, service_ms=service_ms,
        max_pending=max_pending, p99_budget_ms=deadline_ms,
        seed=seed, **kw)

    v_solo = solo["groups"]["victim"]
    v_cont = contested["groups"]["victim"]
    ratio = (v_cont["goodput_rps"] / v_solo["goodput_rps"]
             if v_solo["goodput_rps"] else 0.0)
    return {
        "solo": solo,
        "contested": contested,
        "victim_goodput_ratio": round(ratio, 3),
        "victim_p99_ms": v_cont.get("latency_ms", {}).get("p99"),
        "victim_p99_budget_ms": deadline_ms,
        "conserved": bool(solo["conserved"] and contested["conserved"]),
        "zero_lost": solo["lost"] == 0 and contested["lost"] == 0,
    }


def schedule_worker_kills(pool, *, workers: int,
                          rng: np.random.Generator,
                          kill_at_s: float, kills: int,
                          stagger_s: float = 0.25
                          ) -> "tuple[List[dict], List[threading.Timer]]":
    """Fault-injector primitive: plan `kills` SIGKILLs of rng-chosen
    workers starting at `kill_at_s` (staggered by `stagger_s`). Returns
    (schedule, timers); the caller starts the timers when its clock
    starts and cancels them when the run ends. Each schedule entry's
    ``pid`` is filled in when its kill actually lands, so the executed
    schedule is the replay record. Shared by `run_against_pool` and the
    scenario executor (scenario/executor.py)."""
    schedule: List[dict] = []
    timers: List[threading.Timer] = []
    for k in range(max(0, kills)):
        t_k = kill_at_s + k * stagger_s
        wid = int(rng.integers(0, workers))
        entry = {"t_s": round(t_k, 3), "wid": wid, "pid": None}
        schedule.append(entry)

        def do_kill(entry=entry):
            # the chosen slot may be dead/restarting already: fall
            # back to any live worker so the kill still happens
            pid = pool.kill_worker(entry["wid"])
            if pid is None:
                pid = pool.kill_worker(None)
            entry["pid"] = pid

        t = threading.Timer(t_k, do_kill)
        # cancelled by the caller; daemon besides, so an exception
        # between here and start() can't hang exit
        t.daemon = True
        timers.append(t)
    return schedule, timers


def run_against_pool(*, pattern: str = "poisson", load_x: float = 1.5,
                     n: int = 300, service_ms: float = 20.0,
                     workers: int = 2, max_pending: int = 32,
                     max_inflight: int = 0,
                     shed_policy: str = "reject-newest",
                     p99_budget_ms: float = 90.0, seed: int = 0,
                     kill_at_s: Optional[float] = None, kills: int = 1,
                     recovery_timeout_s: Optional[float] = None,
                     trace: bool = False,
                     **pool_kwargs) -> dict:
    """Chaos-kill harness run: open-loop load at `load_x` × a worker
    POOL's aggregate capacity, with `kills` SIGKILLs of rng-chosen
    workers at `kill_at_s` (default: the median arrival — mid-flood,
    where a lost worker hurts most). The run is reproducible from
    (seed, kill schedule), both recorded in the report.

    The report adds to run_open_loop's fields: `kill_schedule` (planned
    t / wid / pid actually signalled), `recovered` (pool back to full
    non-disabled capacity within `recovery_timeout_s` — default sized
    to the restart budget), `conserved` (admission invariants exact),
    and `orphans` (live pids left after close() — must be empty).
    """
    from nnstreamer_tpu_torch.serving.pool import PooledQueryServer, proc_alive

    rng = np.random.default_rng(seed)
    pqs = PooledQueryServer.echo(
        workers=workers, service_ms=service_ms, max_pending=max_pending,
        max_inflight=max_inflight, shed_policy=shed_policy,
        **pool_kwargs)
    pool = pqs.pool
    closed = False
    try:
        rate = load_x * pqs.capacity_rps
        arrivals = _arrivals_for(pattern, rate, n, rng)
        if kill_at_s is None:
            kill_at_s = float(arrivals[len(arrivals) // 2])
        schedule, timers = schedule_worker_kills(
            pool, workers=workers, rng=rng, kill_at_s=kill_at_s,
            kills=kills)

        x = np.ones((8, 1), np.float32)
        for t in timers:
            t.start()
        try:
            report = run_open_loop(
                "127.0.0.1", pqs.port, dims=pool.spec.dims,
                types=pool.spec.types, arrivals=arrivals,
                make_frame=lambda i: TensorBuffer.of(x, pts=i),
                p99_budget_ms=p99_budget_ms,
                depth_probe=pqs.depth_probe, trace=trace)
        finally:
            for t in timers:
                t.cancel()
        # recovery: back to full non-disabled capacity within the
        # restart budget's worth of backoff (+ margin for respawn)
        if recovery_timeout_s is None:
            recovery_timeout_s = max(
                5.0, 2 * pool.restart_backoff_max_s + 5.0)
        t_rec = time.perf_counter()
        recovered = pool.wait_ready(recovery_timeout_s)
        c = pqs.admission_counters()
        report.update({
            "pattern": pattern, "load_x": load_x,
            "service_ms": service_ms, "workers": workers,
            "capacity_rps": round(pqs.capacity_rps, 1),
            "seed": int(seed),
            "schedule": {
                "kind": "pool", "pattern": pattern, "load_x": load_x,
                "n": n, "service_ms": service_ms, "workers": workers,
                "max_pending": max_pending,
                "max_inflight": max_inflight,
                "shed_policy": shed_policy,
                "p99_budget_ms": p99_budget_ms,
                "kill_at_s": round(float(kill_at_s), 3),
                "kills": kills, "trace": bool(trace)},
            "kill_schedule": schedule,
            "recovered": recovered,
            "recovery_s": round(time.perf_counter() - t_rec, 3),
            "conserved": conservation_ok(c),
            "admission": c,
            "pool": pool.stats(),
        })
        # orphan audit must run AFTER close(): a drained pool may leave
        # no live child — a pid still alive here is a leaked orphan
        all_pids = pool.all_pids_ever()
        pqs.close()
        closed = True
        report["orphans"] = [p for p in all_pids if proc_alive(p)]
        return report
    finally:
        if not closed:
            pqs.close()


# -- the mesh harness --------------------------------------------------------


#: query-server ids the mesh harness burns through (the registry is
#: process-wide; a crashed run must not leave a stale id in the way)
_mesh_sids = None


def _next_mesh_sid() -> int:
    global _mesh_sids
    if _mesh_sids is None:
        import itertools

        _mesh_sids = itertools.count(9500)
    return next(_mesh_sids)


class MeshWorld:
    """A live multi-host mesh fixture: a `MeshRouter` fronting `hosts`
    subprocess worker pools joined by `HostAgent`s, with a seeded
    `ChaosProxy` inserted in front of every host index in
    `proxy_hosts`. The build/teardown half of `run_against_mesh`,
    extracted so the scenario executor (scenario/executor.py) can
    compose its own fault programs against the same world. Drive
    traffic at ``world.router.port``; call `all_pids()` BEFORE
    `close()` to feed the post-close orphan audit."""

    def __init__(self, *, hosts: int, workers_per_host: int = 1,
                 service_ms: float = 20.0, max_pending: int = 64,
                 lease_s: float = 1.0, max_redeliver: int = 2,
                 seed: int = 0, proxy_hosts=(),
                 dims: str = "8:1", types: str = "float32",
                 connect_timeout_s: float = 2.0,
                 wait_timeout_s: float = 10.0,
                 trace_hosts: bool = False, **mesh_kwargs):
        from nnstreamer_tpu_torch.runtime.tracing import Tracer
        from nnstreamer_tpu_torch.serving.mesh import MeshRouter, pool_join
        from nnstreamer_tpu_torch.serving.pool import PooledQueryServer
        from nnstreamer_tpu_torch.traffic.netchaos import ChaosProxy

        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        self.hosts = hosts
        self.workers_per_host = workers_per_host
        self.service_ms = service_ms
        self.router = MeshRouter(
            sid=_next_mesh_sid(), dims=dims, types=types,
            max_pending=max_pending, lease_s=lease_s,
            max_redeliver=max_redeliver, **mesh_kwargs)
        self.pools: List = []
        self.agents: List = []
        self.proxies: Dict[int, "ChaosProxy"] = {}
        try:
            for k in range(hosts):
                # a traced host pool runs traced workers, which is what
                # puts worker_recv/worker_done on the reply hop chain
                # (tracing.REQUIRED_REPLY_HOPS) the scenario checker
                # audits — plain drills skip the decode cost
                pqs = PooledQueryServer.echo(
                    workers=workers_per_host, service_ms=service_ms,
                    sid=_next_mesh_sid(), max_pending=max_pending,
                    tracer=Tracer() if trace_hosts else None)
                self.pools.append(pqs)
                r_host, r_port = "127.0.0.1", self.router.port
                if k in proxy_hosts:
                    proxy = ChaosProxy("127.0.0.1", self.router.port,
                                       seed=seed)
                    self.proxies[k] = proxy
                    r_host, r_port = proxy.host, proxy.port
                self.agents.append(pool_join(
                    pqs, r_host, r_port, name=f"host{k}",
                    connect_timeout_s=connect_timeout_s))
            if not self.router.wait_hosts(hosts,
                                          timeout_s=wait_timeout_s):
                raise StreamError(
                    f"mesh harness: only {self.router.ready_hosts()}"
                    f"/{hosts} hosts registered")
        except Exception:
            self.close()
            raise

    @property
    def capacity_rps(self) -> float:
        return self.hosts * self.workers_per_host * 1e3 / self.service_ms

    def all_pids(self) -> List[int]:
        return [p for pqs in self.pools
                for p in pqs.pool.all_pids_ever()]

    def close(self) -> None:
        _mesh_teardown(self.agents, list(self.proxies.values()),
                       self.pools, self.router)
        self.agents, self.pools = [], []
        self.proxies = {}
        self.router = None


def run_against_mesh(*, hosts: int = 2, workers_per_host: int = 1,
                     pattern: str = "poisson", load_x: float = 1.5,
                     n: int = 300, service_ms: float = 20.0,
                     max_pending: int = 64,
                     p99_budget_ms: float = 250.0, seed: int = 0,
                     lease_s: float = 1.0, max_redeliver: int = 2,
                     blackhole_at_s: Optional[float] = None,
                     blackhole_host: Optional[int] = 0,
                     heal_after_s: Optional[float] = None,
                     drain_timeout_s: float = 15.0,
                     trace: bool = True,
                     **mesh_kwargs) -> dict:
    """Chaos-partition harness run: a `MeshRouter` fronting `hosts`
    worker-pool hosts (each a separate subprocess pool joined by
    a `HostAgent`), flooded open-loop at `load_x` × the mesh's
    aggregate capacity while host `blackhole_host` is silently
    partitioned mid-flood through a netchaos proxy (set it to None for
    a fault-free run).

    The contract this encodes: zero lost —
    every request resolves as RESULT or typed BUSY; `conserved` — the
    router's two admission invariants hold exactly; the fence lands
    within the lease budget (`fence_detect_s`); and with ``trace=True``
    a cross-host redelivered frame keeps ONE trace_id whose dispatch
    hops show both hosts (`redelivered_examples`).

    With `heal_after_s`, the partition heals that many seconds after it
    starts and the report waits for the agent's rejoin
    (`rejoined`) — the full fence → re-offer → rejoin cycle.
    """
    from nnstreamer_tpu_torch.serving.pool import proc_alive

    rng = np.random.default_rng(seed)
    world = MeshWorld(
        hosts=hosts, workers_per_host=workers_per_host,
        service_ms=service_ms, max_pending=max_pending,
        lease_s=lease_s, max_redeliver=max_redeliver, seed=seed,
        proxy_hosts=(() if blackhole_host is None
                     else (blackhole_host,)), **mesh_kwargs)
    router = world.router
    closed = False
    try:
        capacity = world.capacity_rps
        arrivals = _arrivals_for(pattern, load_x * capacity, n, rng)
        if blackhole_at_s is None:
            blackhole_at_s = float(arrivals[len(arrivals) // 2])
        proxy = world.proxies.get(blackhole_host) \
            if blackhole_host is not None else None
        t_prog = time.monotonic()
        if proxy is not None:
            # the partition is a scheduled ChaosProxy program, not
            # hand-rolled timers: the harness owns the clock instant
            # and the proxy's applied-event log is the ground truth
            events = [(blackhole_at_s, "blackhole")]
            if heal_after_s is not None:
                events.append((blackhole_at_s + heal_after_s, "heal"))
            proxy.program(events, t0=t_prog)

        x = np.ones((8, 1), np.float32)
        report = run_open_loop(
            "127.0.0.1", router.port, dims="8:1", types="float32",
            arrivals=arrivals,
            make_frame=lambda i: TensorBuffer.of(x, pts=i),
            p99_budget_ms=p99_budget_ms,
            drain_timeout_s=drain_timeout_s,
            depth_probe=router.depth_probe, trace=trace)
        c = router.admission_counters()
        stats = router.stats()
        report.update({
            "pattern": pattern, "load_x": load_x,
            "service_ms": service_ms, "hosts": hosts,
            "workers_per_host": workers_per_host,
            "capacity_rps": round(capacity, 1),
            "seed": int(seed),
            "schedule": {
                "kind": "mesh", "hosts": hosts,
                "workers_per_host": workers_per_host,
                "pattern": pattern, "load_x": load_x, "n": n,
                "service_ms": service_ms, "max_pending": max_pending,
                "p99_budget_ms": p99_budget_ms, "lease_s": lease_s,
                "max_redeliver": max_redeliver,
                "blackhole_at_s": (round(float(blackhole_at_s), 3)
                                   if blackhole_host is not None
                                   else None),
                "blackhole_host": blackhole_host,
                "heal_after_s": heal_after_s,
                "drain_timeout_s": drain_timeout_s,
                "trace": bool(trace)},
            "lease_s": lease_s,
            "conserved": conservation_ok(c),
            "admission": c,
            "mesh": stats,
            # every router reply maps to exactly one host reply: the
            # cross-host form of the conservation contract
            "perhost_replied_sum": sum(h["replied"]
                                       for h in stats["hosts"]),
        })
        t_bh = proxy.applied("blackhole") if proxy is not None else None
        if proxy is not None and t_bh is None:
            # flood drained before the partition was due: drop the
            # pending program so no surprise fault lands mid-teardown
            proxy.cancel_program()
        if t_bh is not None:
            fences = [e for e in router.events
                      if e[2] == "fence" and e[0] >= t_bh]
            detect_s = (fences[0][0] - t_bh) if fences else None
            report["blackhole_at_s"] = round(blackhole_at_s, 3)
            report["fence_detect_s"] = \
                round(detect_s, 3) if detect_s is not None else None
            # fenced within the lease budget (+ the supervisor's poll
            # cadence): the lease, not luck, found the silent host
            report["recovered"] = bool(
                fences and detect_s <= 2.0 * lease_s
                and report["lost"] == 0 and report["conserved"])
            if heal_after_s is not None:
                # the flood may drain early, but the program still
                # heals at the promised scenario-clock offset — wait
                # for its last event to land, then for the rejoin
                remaining = (t_prog + blackhole_at_s + heal_after_s) \
                    - time.monotonic()
                proxy.wait_program(max(0.0, remaining) + 10.0)
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline and \
                        router.ready_hosts() < hosts:
                    time.sleep(0.05)
                report["rejoined"] = router.ready_hosts() >= hosts
        # orphan audit must run AFTER close(): a pid still alive once
        # every pool drained is a leaked child
        all_pids = world.all_pids()
        world.close()
        closed = True
        report["orphans"] = [p for p in all_pids if proc_alive(p)]
        return report
    finally:
        if not closed:
            world.close()


def _mesh_teardown(agents, proxies, pools, router) -> None:
    for a in agents:
        a.stop()
    for p in proxies:
        p.close()
    for pqs in pools:
        pqs.close()
    if router is not None:
        router.close()


# -- replay ------------------------------------------------------------------

def replay_report(report: dict) -> dict:
    """Re-run the exact drill a ``run_*`` report records. Every runner
    stamps a top-level ``{"seed", "schedule"}`` block sufficient to
    reconstruct its run; this dispatches back into the runner with the
    recorded arguments. Same seed → same arrival trace and same
    planned fault schedule; a quiescent run (zero lost, fully drained)
    replays to the same offered/admitted/replied totals."""
    sched = report.get("schedule")
    seed = report.get("seed")
    if not isinstance(sched, dict) or "kind" not in sched \
            or seed is None:
        raise ValueError(
            "report carries no replayable {'seed', 'schedule'} block")
    kw = dict(sched)
    kind = kw.pop("kind")
    fn = _REPLAY_RUNNERS.get(kind)
    if fn is None:
        raise ValueError(
            f"unknown schedule kind {kind!r}; expected one of "
            f"{sorted(_REPLAY_RUNNERS)}")
    return fn(seed=int(seed), **kw)


_REPLAY_RUNNERS: Dict[str, Callable[..., dict]] = {
    "echo": run_against_echo,
    "autotune_ramp": run_autotune_ramp,
    "multitenant": run_multitenant,
    "pool": run_against_pool,
    "mesh": run_against_mesh,
}

#: the older private names, kept for the callers that grew up with them
_conservation_ok = conservation_ok
_tenant_conservation_ok = tenant_conservation_ok

"""Device performance plane: cost registry, invoke samples, MFU, HBM
ledger (the JAX package's runtime/devprof.py on the port).

Backends report each bucket's first run (FLOPs, bytes, seconds, keyed by
(filter, bucket)), every invoke is sampled by a pair of CUDA events
around it, and `stats()` folds both into achieved TFLOP/s, MFU, a
roofline verdict and a per-device memory ledger, which
`serving.metrics.metrics_snapshot(devprof=...)` exports as the
``nns_jit_*`` / ``nns_invoke_*`` / ``nns_device_hbm_*`` families.

Accounting
----------
- **First run** ("compile", the JAX package's word): nothing compiles
  in eager PyTorch, so a backend calls :meth:`DeviceProfiler.capture_cost`
  on the first invoke of a (filter, bucket) — or the first window of a
  K, whose CUDA graph it captures — with the call to count. The call
  runs once under ``torch.utils.flop_counter.FlopCounterMode``: FLOPs
  are what its formulas count (convolutions, matrix products,
  attention: 2 × multiply-adds); elementwise work counts nothing.
  Bytes are the params', the inputs' and the outputs' bytes, each read
  once: a lower bound of the traffic, where the JAX package reads XLA's
  cost model (``bytes_kind`` says which). Never in steady state.
- **Invoke time**: a backend marks the dispatch (:meth:`note_dispatch`,
  a CUDA event recorded on the current stream) and the end of its
  launches (:meth:`note_launched`, a second event). The pair is read at
  the next ``runtime.sync.device_sync`` on the same thread, whose wait
  already covers it — the profiler never syncs of its own. On the CPU
  the sample is host time, dispatch to launch end.
- **MFU**: achieved TFLOP/s = FLOPs / median sampled seconds, over the
  card's peak from `PEAK_TFLOPS`; with no peak (the CPU) ``mfu`` is 0
  and ``mfu_calibrated`` is the ratio to the best achieved rate so far.
- **Roofline**: arithmetic intensity (FLOPs / bytes) against the ridge
  point (peak FLOP/s / peak bytes/s): "compute" or "memory", "unknown"
  without both peaks.
- **Memory ledger**: per physical CUDA device ``bytes_in_use``
  (``torch.cuda.memory_stats`` allocated.current), ``peak_bytes_in_use``
  and ``bytes_limit`` (``torch.cuda.mem_get_info`` total), plus one
  ``model:<label>`` row per attached backend's resident params.

Off by default: every hook starts with an ``enabled`` test and costs
one attribute read until something (``serve --metrics-port``, a test,
chip_smoke.py) turns it on.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

#: dense bf16 peak TFLOP/s (without sparsity) per card, matched by the
#: prefix of ``torch.cuda.get_device_name()``: NVIDIA spec-sheet values,
#: not measurements
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,      # H100 SXM
    "NVIDIA H100 PCIe": 756.0,
    "NVIDIA H100 NVL": 835.0,
    "NVIDIA H200": 989.0,
    "NVIDIA A100-SXM4-80GB": 312.0,
    "NVIDIA A100-SXM4-40GB": 312.0,
    "NVIDIA A100 80GB PCIe": 312.0,
}

#: memory bandwidth GB/s per card (spec sheet): the roofline's memory peak
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
    "NVIDIA H200": 4800.0,
    "NVIDIA A100-SXM4-80GB": 2039.0,
    "NVIDIA A100-SXM4-40GB": 1555.0,
    "NVIDIA A100 80GB PCIe": 1935.0,
}

#: what the registry's byte counts are (the JAX package's are XLA's
#: cost-model bytes accessed)
BYTES_KIND = "lower bound: params + inputs + outputs, each read once"

#: undrained invoke samples a thread keeps (the oldest go first)
_PENDING_MAX = 256


def peak_for(device_kind: str) -> Tuple[float, float]:
    """(peak TFLOP/s, peak GB/s) for a card name; (0, 0) when none is
    declared (the CPU, an unknown card): callers read 0 as "no
    denominator". Longest prefix wins."""
    k = str(device_kind or "").strip()
    best = ""
    for known in PEAK_TFLOPS:
        if k.lower().startswith(known.lower()) and len(known) > len(best):
            best = known
    if best:
        return PEAK_TFLOPS[best], PEAK_HBM_GBPS.get(best, 0.0)
    return 0.0, 0.0


def _tree_tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, torch.nn.Module):
        yield from x.parameters()
        yield from x.buffers()
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tree_tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tree_tensors(v)


def tensor_bytes(*trees) -> int:
    """Bytes of every tensor in `trees` (modules, dicts, lists, tensors),
    each distinct tensor counted once."""
    seen, total = set(), 0
    for tree in trees:
        for t in _tree_tensors(tree):
            if id(t) in seen:
                continue
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


class DeviceProfiler:
    """Process-wide cost registry, invoke reservoirs and memory ledger.

    The registry and reservoirs are appended under one lock, taken only
    at first runs and at sync samples; the dispatch stamps are
    thread-local."""

    def __init__(self, reservoir: int = 128,
                 peak_tflops: Optional[float] = None,
                 peak_hbm_gbps: Optional[float] = None):
        self._lock = threading.Lock()
        self.enabled = False
        self._reservoir = int(reservoir)
        # (filter, bucket) -> {"flops", "bytes_accessed", "compile_s",
        #                      "compiles"}: cumulative, never reset
        self._cost: Dict[Tuple[str, str], Dict[str, float]] = {}
        # (filter, bucket) -> {"ring", "seconds", "count"}: the ring is
        # the reservoir; seconds/count are exact totals of what was
        # sampled
        self._invoke: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._tl = threading.local()
        self._models: Dict[str, Any] = {}
        self._calib_tflops = 0.0      # best achieved: the CPU's "peak"
        self._peak_override = (peak_tflops, peak_hbm_gbps)
        self._device_info: Optional[Dict[str, Any]] = None

    # -- lifecycle ---------------------------------------------------------
    def enable(self, on: bool = True) -> "DeviceProfiler":
        self.enabled = bool(on)
        return self

    def reset(self) -> None:
        """Drop all accounting (tests, measurement arms)."""
        with self._lock:
            self._cost.clear()
            self._invoke.clear()
            self._models.clear()
            self._calib_tflops = 0.0
            self._device_info = None
        self._tl = threading.local()

    # -- first-run capture -------------------------------------------------
    def note_compile(self, filt: str, bucket: str, *, seconds: float,
                     flops: float = 0.0,
                     bytes_accessed: float = 0.0) -> None:
        """Record one first run into the cost registry. FLOPs and bytes
        are a property of the (filter, bucket) call, so a later first run
        (a reload, a swap) overwrites them; seconds add up."""
        if not self.enabled:
            return
        with self._lock:
            e = self._cost.setdefault(
                (str(filt), str(bucket)),
                {"flops": 0.0, "bytes_accessed": 0.0,
                 "compile_s": 0.0, "compiles": 0})
            if flops:
                e["flops"] = float(flops)
            if bytes_accessed:
                e["bytes_accessed"] = float(bytes_accessed)
            e["compile_s"] += max(0.0, float(seconds))
            e["compiles"] += 1

    def capture_cost(self, filt: str, bucket: str, call: Callable[[], Any],
                     *, params=None, inputs=()) -> Any:
        """Run ``call()`` once under FlopCounterMode and register its
        FLOPs, its bytes (params + inputs + outputs) and its host
        seconds; → what ``call()`` returned. A call the counter cannot
        follow degrades to a seconds-only entry (run again plainly)."""
        from torch.utils.flop_counter import FlopCounterMode

        t0 = time.perf_counter()
        flops = 0
        try:
            counter = FlopCounterMode(display=False)
            with counter:
                out = call()
            flops = counter.get_total_flops()
        except Exception:
            t0 = time.perf_counter()
            out = call()
        seconds = time.perf_counter() - t0
        self.note_compile(filt, bucket, seconds=seconds, flops=flops,
                          bytes_accessed=tensor_bytes(params, inputs, out))
        return out

    @staticmethod
    def flop_counter():
        """A FlopCounterMode for a first run a backend counts itself (a
        window's eager run before its capture): enter it around the run,
        then report ``get_total_flops()`` through `note_compile`."""
        from torch.utils.flop_counter import FlopCounterMode

        return FlopCounterMode(display=False)

    # -- invoke sampling ---------------------------------------------------
    def _pending(self) -> list:
        p = getattr(self._tl, "pending", None)
        if p is None:
            p = self._tl.pending = deque(maxlen=_PENDING_MAX)
            self._tl.free = []
        return p

    def _event(self):
        """A timing CUDA event from this thread's free list (a sample's
        events go back to it once read): creating one costs more host
        time than recording it."""
        free = self._tl.free
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def note_dispatch(self, filt: str, bucket: str, device=None) -> None:
        """Stamp a dispatch on this thread: a CUDA event on `device`'s
        current stream (host time on the CPU). `note_launched` closes
        the launches; the next `device_sync` here reads the pair."""
        if not self.enabled:
            return
        pend = self._pending()
        ev = None
        if device is not None and torch.device(device).type == "cuda":
            ev = self._event()
            ev.record(torch.cuda.current_stream(device))
        pend.append([str(filt), str(bucket), device, time.perf_counter(),
                     ev, None, None])

    def note_launched(self) -> None:
        """The launches of this thread's last dispatch are queued: a
        second CUDA event behind them (host time on the CPU)."""
        if not self.enabled:
            return
        pend = getattr(self._tl, "pending", None)
        if not pend or pend[-1][5] is not None or pend[-1][6] is not None:
            return
        entry = pend[-1]
        if entry[4] is not None:
            ev = self._event()
            ev.record(torch.cuda.current_stream(entry[2]))
            entry[5] = ev
        else:
            entry[6] = time.perf_counter()

    def sample_sync(self) -> None:
        """Close this thread's finished dispatch stamps (called by
        ``runtime.sync.device_sync`` after its wait): each becomes one
        sample. A stamp whose end event has not completed stays pending;
        no stamp on this thread, no sample."""
        if not self.enabled:
            return
        pend = getattr(self._tl, "pending", None)
        if not pend:
            return
        keep = []
        now = time.perf_counter()
        while pend:
            filt, bucket, _, t0, ev0, ev1, t1 = pend.popleft()
            if ev0 is not None:
                if ev1 is None or not ev1.query():
                    if ev1 is not None:
                        keep.append([filt, bucket, _, t0, ev0, ev1, t1])
                    continue
                seconds = ev0.elapsed_time(ev1) / 1e3
                self._tl.free += [ev0, ev1]
            else:
                seconds = (t1 if t1 is not None else now) - t0
            self.note_invoke(filt, bucket, seconds)
        pend.extend(keep)

    def note_invoke(self, filt: str, bucket: str, seconds: float) -> None:
        """Record one sampled device-time observation."""
        if not self.enabled or seconds <= 0:
            return
        with self._lock:
            e = self._invoke.setdefault(
                (str(filt), str(bucket)),
                {"ring": deque(maxlen=self._reservoir),
                 "seconds": 0.0, "count": 0})
            e["ring"].append(float(seconds))
            e["seconds"] += float(seconds)
            e["count"] += 1

    # -- memory ledger -----------------------------------------------------
    def attach_model(self, label: str, backend: Any) -> None:
        """Register a backend for per-model attribution: its
        ``resident_bytes()`` (by version where it has
        ``resident_bytes_by_version()``) shows as ``model:<label>`` rows.
        Held by weakref: a released model leaves the ledger."""
        if not label:
            return
        with self._lock:
            self._models[str(label)] = weakref.ref(backend)

    def _device_meta(self) -> Dict[str, Any]:
        """Platform, card name and count of the configured accelerator
        (cached: the topology does not change mid-process)."""
        if self._device_info is not None:
            return self._device_info
        info = {"platform": "cpu", "device_kind": "cpu", "devices": 1}
        try:
            from nnstreamer_tpu_torch.serving.placement import (
                physical_devices)

            devs = physical_devices()
            if devs and devs[0].type == "cuda":
                info = {"platform": "cuda",
                        "device_kind": torch.cuda.get_device_name(devs[0]),
                        "devices": len(devs)}
        except Exception:
            pass
        self._device_info = info
        return info

    def hbm_rows(self) -> List[Dict[str, Any]]:
        """Per physical CUDA device {device, kind, bytes} rows (none on
        the CPU), then ``model:<label>`` rows from attached backends."""
        rows: List[Dict[str, Any]] = []
        if self._device_meta()["platform"] == "cuda":
            try:
                from nnstreamer_tpu_torch.serving.placement import (
                    physical_devices)

                for d in physical_devices():
                    ms = torch.cuda.memory_stats(d)
                    _, total = torch.cuda.mem_get_info(d)
                    dev = f"cuda:{d.index}"
                    for kind, v in (
                            ("bytes_in_use",
                             ms.get("allocated_bytes.all.current", 0)),
                            ("bytes_limit", total),
                            ("peak_bytes_in_use",
                             ms.get("allocated_bytes.all.peak", 0))):
                        rows.append({"device": dev, "kind": kind,
                                     "bytes": float(v)})
            except Exception:
                pass
        with self._lock:
            models = list(self._models.items())
        for label, ref in models:
            be = ref()
            if be is None:
                with self._lock:
                    self._models.pop(label, None)
                continue
            try:
                by_ver = getattr(be, "resident_bytes_by_version", None)
                vers = by_ver() if by_ver is not None else None
                if vers:
                    for v, b in sorted(vers.items()):
                        rows.append({"device": "-",
                                     "kind": f"model:{label}@{v}",
                                     "bytes": float(b)})
                else:
                    rows.append({"device": "-", "kind": f"model:{label}",
                                 "bytes": float(be.resident_bytes())})
            except Exception:
                continue
        return rows

    # -- read-out ------------------------------------------------------------
    def _peaks(self) -> Tuple[float, float]:
        ot, ob = self._peak_override
        if ot is not None:
            return float(ot), float(ob or 0.0)
        return peak_for(self._device_meta()["device_kind"])

    def stats(self) -> Dict[str, Any]:
        """One snapshot for the metrics plane, top and flight bundles:
        ``jit`` rows (the cost registry), ``invoke`` rows (achieved
        TFLOP/s, MFU, cumulative seconds), ``hbm`` and ``headroom``
        rows, and the peaks applied."""
        meta = self._device_meta()
        peak_tf, peak_bw = self._peaks()
        ridge = (peak_tf * 1e12) / (peak_bw * 1e9) if peak_tf and peak_bw \
            else 0.0
        with self._lock:
            cost = {k: dict(v) for k, v in self._cost.items()}
            invoke = {k: {"samples": list(v["ring"]),
                          "seconds": v["seconds"], "count": v["count"]}
                      for k, v in self._invoke.items()}
        jit_rows = []
        for (filt, bucket), e in sorted(cost.items()):
            ai = e["flops"] / e["bytes_accessed"] \
                if e["bytes_accessed"] else 0.0
            if not e["flops"] or not ridge:
                roofline = "unknown"
            else:
                roofline = "compute" if ai >= ridge else "memory"
            jit_rows.append({
                "filter": filt, "bucket": bucket,
                "flops": e["flops"],
                "bytes_accessed": e["bytes_accessed"],
                "compile_s": e["compile_s"], "compiles": e["compiles"],
                "ai": round(ai, 3), "roofline": roofline,
            })
        achieved: Dict[Tuple[str, str], Tuple[float, float]] = {}
        for key, e in invoke.items():
            samples = sorted(e["samples"])
            if not samples:
                continue
            med = samples[len(samples) // 2]
            flops = cost.get(key, {}).get("flops", 0.0)
            tf = flops / med / 1e12 if flops and med > 0 else 0.0
            achieved[key] = (tf, med)
            if tf > self._calib_tflops:
                self._calib_tflops = tf
        invoke_rows = []
        for (filt, bucket), e in sorted(invoke.items()):
            tf, med = achieved.get((filt, bucket), (0.0, 0.0))
            invoke_rows.append({
                "filter": filt, "bucket": bucket,
                "device": meta["device_kind"],
                "seconds_total": e["seconds"],
                "samples_total": e["count"],
                "p50_ms": round(med * 1e3, 4),
                "achieved_tflops": round(tf, 4),
                "mfu": round(tf / peak_tf, 4) if peak_tf else 0.0,
                "mfu_calibrated": round(tf / self._calib_tflops, 4)
                if self._calib_tflops else 0.0,
            })
        hbm = self.hbm_rows()
        headroom = []
        by_dev: Dict[str, Dict[str, float]] = {}
        for r in hbm:
            if r["device"] != "-":
                by_dev.setdefault(r["device"], {})[r["kind"]] = r["bytes"]
        for dev, kinds in sorted(by_dev.items()):
            limit = kinds.get("bytes_limit", 0.0)
            if limit:
                headroom.append({
                    "device": dev,
                    "frac": round(kinds.get("bytes_in_use", 0.0) / limit,
                                  6)})
        return {
            "enabled": self.enabled,
            "platform": meta["platform"],
            "device_kind": meta["device_kind"],
            "devices": meta["devices"],
            "peak_tflops": peak_tf,
            "peak_hbm_gbps": peak_bw,
            "peak_source": "spec sheet" if peak_tf else "none",
            "bytes_kind": BYTES_KIND,
            "calibration_tflops": round(self._calib_tflops, 4),
            "compile_seconds_total": round(
                sum(r["compile_s"] for r in jit_rows), 6),
            "compiles_total": sum(r["compiles"] for r in jit_rows),
            "jit": jit_rows,
            "invoke": invoke_rows,
            "hbm": hbm,
            "headroom": headroom,
        }

    def counter_tracks(self) -> List[Tuple[str, float]]:
        """(name, value) counter samples for the tracer's ``devprof``
        track: per-bucket MFU (calibrated where no peak is declared) and
        per-device memory in use."""
        st = self.stats()
        out: List[Tuple[str, float]] = []
        for r in st["invoke"]:
            v = r["mfu"] if st["peak_tflops"] else r["mfu_calibrated"]
            out.append((f"mfu:{r['filter']}/{r['bucket']}", v))
        for r in st["hbm"]:
            if r["kind"] == "bytes_in_use":
                out.append((f"hbm:{r['device']}", r["bytes"]))
        return out

    def emit_counters(self, tracer, t: Optional[float] = None) -> int:
        """Write `counter_tracks()` onto `tracer`'s devprof track (a
        traced run's Chrome trace then shows them). → samples written."""
        if not self.enabled or tracer is None or not tracer.active:
            return 0
        t = time.perf_counter() if t is None else t
        tracks = self.counter_tracks()
        for name, value in tracks:
            tracer.record_device_counter(name, value, t)
        return len(tracks)


#: the process-wide profiler: backends and `device_sync` talk to this one
#: instance; off until something enables it
_PROFILER = DeviceProfiler()


def get() -> DeviceProfiler:
    return _PROFILER


def bucket_label(basekey: tuple) -> str:
    """A bounded-cardinality label of a backend bucket key:
    ``("fix", ((1, 224, 224, 3), "uint8"), ...)`` → ``fix:1x224x224x3``,
    ``("dynb", 8, ...)`` → ``dynb:8``, ``()`` → ``static``."""
    if not basekey:
        return "static"
    kind = str(basekey[0])
    if kind == "fix" and len(basekey) > 1:
        shape = basekey[1][0] if isinstance(basekey[1], tuple) else ()
        return f"fix:{'x'.join(str(d) for d in shape)}"
    if kind == "dynb" and len(basekey) > 1:
        return f"dynb:{basekey[1]}"
    return kind

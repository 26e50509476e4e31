#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (nnstreamer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout around this file;
imports nothing of JAX. Phases:

1. environment: torch/CUDA/nvcc versions and the card's name and power
   limit (nvidia-smi);
2. build the hand-written kernels from the checkout's sources (nvcc);
3. each kernel against its plain torch version on the card, on the
   inputs the pipeline gives it and on odd, misaligned and other-dtype
   inputs — bit for bit;
4. the main path: pipelines A (quick start, fused transform) and B
   (kernel path, host and device=true label decode) at full width,
   MobileNetV2 1.0 on 224x224x3 uint8 frames, bf16, on cuda; the launch
   counts and a torch.profiler capture show B went through the kernel;
5. B in f32 on cuda and on the CPU with the same weights: equal labels,
   logits within 1e-3 of max |logit| (cuDNN and the CPU sum in different
   orders and may use different conv algorithms; TF32 off);
6. timings: per-frame latency p50/p99 and FPS of A and B with the
   card's busy share, and each kernel's device time beside its bound and
   its plain version's time.

It prints the card line and a JSON line of kernel numbers before the last
line, and ends with {"ok": true, "device": {...}}. Any failed check
raises, so the exit code is non-zero and no result line is printed.
Without a CUDA device, or run outside the checkout, it exits non-zero at
once. A JSON record of the run goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FRAMES = 16
#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and f32
#: (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
CPU_TOLERANCE = 1e-3     # card vs CPU, relative to max |logit|

SRC = f"videotestsrc num-buffers={FRAMES} ! tensor_converter"
NORM_A = ("tensor_transform mode=arithmetic "
          "option=typecast:float32,add:-127.5,div:127.5")
NORM_B = "tensor_filter framework=pallas model=normalize_u8"
MODEL = "tensor_filter model=zoo://mobilenet_v2"
LABEL = "tensor_decoder mode=image_labeling"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def run_pipeline(nt, desc: str):
    pipe = nt.parse_launch(desc)
    nt.PipelineRunner(pipe).run(600)
    return pipe.get("out").results


def kernel_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms_per_call(torch, fn, iters: int) -> float:
    """Device time (profiler, CUDA kernels only) per call of `fn`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = kernel_events(prof)
    check(bool(evs), "the profiler recorded no CUDA kernels")
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / iters


def event_ms_per_call(torch, fn, iters: int) -> float:
    """CUDA-event time per call over back-to-back calls (host launch
    cost included when it exceeds the device time)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def closed_loop_latency(nt, norm: str, n: int, warmup: int):
    """Per-frame latency: push one frame into an appsrc pipeline and wait
    for its label at the sink, n times. → (latencies in ms)."""
    from nnstreamer_tpu_torch.elements.sources import AppSrc

    got = threading.Event()
    pipe = nt.parse_launch(
        f"appsrc name=src dims=3:224:224:1 types=uint8 ! {norm} ! {MODEL} ! "
        f"{LABEL} ! tensor_sink name=out collect=false")
    pipe.get("out").set_props(new_data=lambda buf: got.set())
    runner = nt.PipelineRunner(pipe).start()
    src: AppSrc = pipe.get("src")
    frame = np.random.default_rng(0).integers(0, 256, (1, 224, 224, 3),
                                              np.uint8)
    lat = []
    try:
        for i in range(warmup + n):
            got.clear()
            t0 = time.perf_counter()
            src.push(frame)
            check(got.wait(60), "no label came back within 60 s")
            if i >= warmup:
                lat.append((time.perf_counter() - t0) * 1e3)
        src.end()
        runner.wait(60)
    finally:
        runner.stop()
    return lat


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the card and has nothing to "
              "do without one", file=sys.stderr)
        return 2
    if not (ROOT / "nnstreamer_tpu_torch").is_dir():
        print(f"chip_smoke: no nnstreamer_tpu_torch package beside "
              f"{__file__}; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.backends import cuda_build, kernels

    record = {}
    # -- 1. environment ---------------------------------------------------
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]
    nvcc = cuda_build.find_nvcc()
    print(f"phase 1: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, torch CUDA {torch.version.cuda}, "
          f"{sh(nvcc, '--version').splitlines()[-1]}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"phase 1: card: {card}")
    record["card"] = card

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib = cuda_build.build("normalize.cu")
    build_s = time.perf_counter() - t0
    ptxas = [l.strip() for l in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in l or "spill" in l]
    print(f"phase 2: built {lib.name} in {build_s:.2f} s")
    for line in ptxas:
        print(f"phase 2: ptxas: {line}")
    record["build_s"] = build_s

    # -- 3. kernel vs plain -------------------------------------------------
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def rand(dtype, shape):
        if dtype == np.float32:
            return (rng.standard_normal(shape) * 100).astype(np.float32)
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, shape, dtype, endpoint=True)

    frame_u8 = torch.from_numpy(rand(np.uint8, (1, 224, 224, 3))).to(dev)
    base = torch.from_numpy(rand(np.uint8, (1 + 150528,))).to(dev)
    cases = {"frame u8": frame_u8,
             "odd 1001 u8": torch.from_numpy(rand(np.uint8, (1001,))).to(dev),
             "misaligned u8": base[1:]}
    for dt in (np.int8, np.uint16, np.int16, np.float32):
        cases[f"frame {np.dtype(dt).name}"] = torch.from_numpy(
            rand(dt, (1, 224, 224, 3))).to(dev)
    main_err = None
    for name, x in cases.items():
        for out_dtype in (torch.float32, torch.bfloat16):
            got = kernels.normalize_u8(x, out_dtype=out_dtype)
            ref = kernels.normalize_u8_plain(x, out_dtype=out_dtype)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            same = torch.equal(got.view(torch.int16) if out_dtype ==
                               torch.bfloat16 else got.view(torch.int32),
                               ref.view(torch.int16) if out_dtype ==
                               torch.bfloat16 else ref.view(torch.int32))
            print(f"phase 3: normalize_u8 {name} -> "
                  f"{str(out_dtype).split('.')[-1]}: max_abs_err {err} "
                  f"bitwise {'equal' if same else 'DIFFERENT'}")
            check(same, f"normalize_u8 {name} -> {out_dtype} differs from "
                        f"its plain version (max abs err {err})")
            if name == "frame u8" and out_dtype == torch.float32:
                main_err = err

    # -- 4. main path: pipelines A and B at full width, bf16, cuda ---------
    from torch.profiler import ProfilerActivity, profile

    results = {}
    kernels.normalize_u8.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        results["B"] = run_pipeline(
            nt, f"{SRC} ! {NORM_B} ! {MODEL} ! {LABEL} ! tensor_sink name=out")
        torch.cuda.synchronize()
    launches = kernels.normalize_u8.launches
    norm_events = [e for e in kernel_events(prof)
                   if "nns_normalize_kernel" in e.name]
    print(f"phase 4: B: normalize_u8 launches {launches} for {FRAMES} "
          f"frames; profiler: {len(norm_events)} nns_normalize_kernel "
          f"launches, {len(kernel_events(prof))} CUDA kernels in all")
    check(launches == FRAMES, f"normalize_u8 launched {launches} times on "
                              f"the main path, expected {FRAMES}")
    check(len(norm_events) == FRAMES,
          f"profiler saw {len(norm_events)} normalize kernels, expected "
          f"{FRAMES}")
    per_frame = {"B": kernel_events(prof)}
    results["B device=true"] = run_pipeline(
        nt, f"{SRC} ! {NORM_B} ! {MODEL} ! {LABEL} device=true ! tensor_sink "
            f"name=out")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        results["A"] = run_pipeline(
            nt, f"{SRC} ! {NORM_A} ! {MODEL} ! {LABEL} ! tensor_sink name=out")
        torch.cuda.synchronize()
    per_frame["A"] = kernel_events(prof)
    for name, evs in per_frame.items():
        # kernels and device time per frame (first frame's setup included)
        per_frame[name] = (len(evs) / FRAMES, sum(
            e.time_range.elapsed_us() for e in evs) / 1e3 / FRAMES)
        print(f"phase 4: {name}: {per_frame[name][0]:.1f} CUDA kernels and "
              f"{per_frame[name][1]:.3f} ms of kernel time per frame")
    logits_b = run_pipeline(nt, f"{SRC} ! {NORM_B} ! {MODEL} ! tensor_sink "
                                f"name=out")
    for name in ("A", "B"):
        bufs = results[name]
        check(len(bufs) == FRAMES, f"{name}: {len(bufs)} sink buffers")
        check(all("label_index" in b.meta and math.isfinite(b.meta["score"])
                  for b in bufs), f"{name}: label_index/score missing")
    dev_idx = [int(b.tensors[0][0]) for b in results["B device=true"]]
    host_idx = [b.meta["label_index"] for b in results["B"]]
    check(dev_idx == host_idx,
          f"B device=true labels {dev_idx} != host decode {host_idx}")
    check(all(b.tensors[0].shape == (1, 1001)
              and np.isfinite(b.tensors[0]).all() for b in logits_b),
          "B logits not finite (1, 1001)")
    print(f"phase 4: A labels {[b.meta['label_index'] for b in results['A']]}")
    print(f"phase 4: B labels {host_idx} (device=true identical)")
    record["main_path"] = {"launches": launches,
                           "profiler_normalize_kernels": len(norm_events)}

    # -- 5. f32 on cuda vs the CPU, same weights ---------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = {}
    for accel in ("cuda", "cpu"):
        f32[accel] = run_pipeline(
            nt, f"{SRC} ! {NORM_B} accelerator={accel} ! {MODEL}?dtype="
                f"float32 accelerator={accel} ! tensor_sink name=out")
    gpu = np.concatenate([b.tensors[0] for b in f32["cuda"]])
    cpu = np.concatenate([b.tensors[0] for b in f32["cpu"]])
    rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    print(f"phase 5: f32 cuda vs cpu: labels {gpu.argmax(-1).tolist()} vs "
          f"{cpu.argmax(-1).tolist()}, max |diff| / max |logit| = {rel:.3e} "
          f"(tolerance {CPU_TOLERANCE})")
    check((gpu.argmax(-1) == cpu.argmax(-1)).all(), "f32 labels differ")
    check(rel <= CPU_TOLERANCE, f"f32 logits differ by {rel:.3e}")
    torch.backends.cudnn.allow_tf32 = True
    record["f32_cuda_vs_cpu_rel_err"] = rel

    # -- 6. timings ---------------------------------------------------------
    timings = {}
    for name, norm in (("A", NORM_A), ("B", NORM_B)):
        lat = closed_loop_latency(nt, norm, n=100, warmup=10)
        n = 200
        run_pipeline(nt, f"videotestsrc num-buffers=8 ! tensor_converter ! "
                         f"{norm} ! {MODEL} ! {LABEL} ! tensor_sink name=out")
        t0 = time.perf_counter()
        out = run_pipeline(nt, f"videotestsrc num-buffers={n} ! "
                               f"tensor_converter ! {norm} ! {MODEL} ! "
                               f"{LABEL} ! tensor_sink name=out")
        fps = len(out) / (time.perf_counter() - t0)
        kern_per_frame, dev_ms = per_frame[name]
        timings[name] = {"latency_p50_ms": float(np.percentile(lat, 50)),
                         "latency_p99_ms": float(np.percentile(lat, 99)),
                         "fps": fps, "kernels_per_frame": kern_per_frame,
                         "device_ms_per_frame": dev_ms,
                         "device_busy_share": dev_ms * fps / 1e3}
        print(f"phase 6: {name}: latency p50 {timings[name]['latency_p50_ms']:.3f} ms "
              f"p99 {timings[name]['latency_p99_ms']:.3f} ms, "
              f"{fps:.1f} frames/s ({n} frames); device busy "
              f"{100 * dev_ms * fps / 1e3:.1f}% (phase-4 kernel time per "
              f"frame x FPS) [{card}]")
    record["pipelines"] = timings

    x = frame_u8
    y_bytes = x.numel() * 4
    moved = x.numel() * x.element_size() + y_bytes
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * x.numel() / F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    kern = lambda: kernels.normalize_u8(x)              # noqa: E731
    plain = lambda: kernels.normalize_u8_plain(x)       # noqa: E731
    ms = device_ms_per_call(torch, kern, 200)
    plain_ms = device_ms_per_call(torch, plain, 200)
    ev_ms = event_ms_per_call(torch, kern, 1000)
    ev_plain_ms = event_ms_per_call(torch, plain, 1000)
    print(f"phase 6: normalize_u8 (1,224,224,3) u8->f32: device {ms:.5f} ms "
          f"per launch (profiler), {ev_ms:.5f} ms per call back-to-back "
          f"(CUDA events); plain torch {plain_ms:.5f} ms device, "
          f"{ev_plain_ms:.5f} ms per call; bound {bound_ms:.6f} ms "
          f"({moved} B at 3.35 TB/s) — far below the few-microsecond "
          f"launch overhead, so launch cost, not bandwidth, sets this "
          f"kernel's time at this size [{card}]")
    record["normalize_u8"] = {"device_ms": ms, "event_ms_per_call": ev_ms,
                              "plain_device_ms": plain_ms,
                              "plain_event_ms_per_call": ev_plain_ms,
                              "bound_ms": bound_ms}

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(card)
    print(json.dumps({"kernels": [{
        "name": "normalize_u8", "route": "cuda",
        "source": "nnstreamer_tpu_torch/backends/csrc/normalize.cu",
        "replaces": "nnstreamer_tpu/backends/pallas_ops.py:34",
        "launches": launches, "max_abs_err": main_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

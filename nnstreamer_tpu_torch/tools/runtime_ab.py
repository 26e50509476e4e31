#!/usr/bin/env python3
"""Compare the per-frame host path of another checkout of the port with
this one, untraced, in one process on the card.

    python3 nnstreamer_tpu_torch/tools/runtime_ab.py OLD_ROOT \
        [--frames 200] [--repeats 3] [--out chiprun_out/runtime_ab.json]
    python3 nnstreamer_tpu_torch/tools/runtime_ab.py OLD_ROOT --llm \
        [--repeats 3] [--tokens 64] [--max-prompt 1536]

OLD_ROOT is a checkout that holds `nnstreamer_tpu_torch/` (for example
the parent commit unpacked with `git archive` into a directory that
`.gitignore` lists). Its package is copied under
`build/runtime_ab/` with every `nnstreamer_tpu_torch` renamed
`nnstreamer_tpu_torch_old`, so both packages load into this one process
and share its host and its card. Three arms run pipelines A (MobileNetV2
1.0 at 224², the arithmetic transform in front) and B (the same with
the `normalize_u8` filter in front), each through `parse_launch` and a
`PipelineRunner` with tracing off:

- "old": OLD_ROOT's package, its default runner;
- "new": this checkout's package, its default runner;
- "new, watchdog and fusion off": this checkout's, with
  `watchdog=False, chain_fusion=False` (the parent's thread layout).

All three pipelines of a kind are live at once. Latency: each round
pushes one frame into every arm in turn (the order reversed every other
round) and waits for its label, `--frames` rounds after 10 of warm-up.
Frames/s: bursts of `--frames` frames into one arm at a time, in turns
forward then backward. The whole is done `--repeats` times; it prints
each repeat's p50/p99 and frames/s per arm, then each arm's median over
the repeats and its difference from "old", and the paired difference:
the median over every round of the arm's latency less "old"'s in the
same round, with the share of rounds in which the arm was slower,
beside the card's name and power limit.

With `--llm` it compares LLM serving instead: the LLM cell (d_model
1024, 8 heads of 128, 4 layers, vocab 512, seeded weights; `tensor_llm
paged_kernel=pallas prefill_chunk=512 max_len=2048 max_batch=8
prewarm=512` in bf16; 8 requests of 64-1536 prompt tokens, 64 new
tokens each, all at t=0) served through `appsrc ! tensor_llm !
tensor_sink` by each package, arms in turns old, new, new, old,
`--repeats` times after one warm-up run an arm. It prints tokens/s
(first push to last token), time to first token and inter-token
latency p50/p99 per run and per arm (medians over the runs), and
whether the two arms' tokens are equal. Both packages build their
kernels into this checkout's `build/torch_kernels/`.

With `NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR=cpu` it runs on the CPU (a
dry run of the script; its times are not the card's).
"""

import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
PKG = "nnstreamer_tpu_torch"
OLD_PKG = PKG + "_old"
NORM = {"A": "tensor_transform mode=arithmetic "
             "option=typecast:float32,add:-127.5,div:127.5",
        "B": "tensor_filter framework=pallas model=normalize_u8"}
PIPE = ("appsrc name=src dims=3:224:224:1 types=uint8 ! {} ! "
        "tensor_filter model=zoo://mobilenet_v2 ! "
        "tensor_decoder mode=image_labeling ! "
        "tensor_sink name=out collect=false")
WARMUP = 10


def load_old(old_root: Path):
    """OLD_ROOT's package, renamed, imported beside this checkout's."""
    dest = ROOT / "build" / "runtime_ab"
    pkg_dir = dest / OLD_PKG
    shutil.rmtree(pkg_dir, ignore_errors=True)
    shutil.copytree(old_root / PKG, pkg_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in pkg_dir.rglob("*.py"):
        f.write_text(f.read_text().replace(PKG, OLD_PKG))
    sys.path.insert(0, str(dest))
    return importlib.import_module(OLD_PKG)


def interleave(arms: dict, frame, frames: int) -> tuple:
    """arms: name → (package, pipeline string, runner kwargs). →
    ({arm: latencies in ms}, {arm: [frames/s]})."""
    live = {}

    def arrive(count, got):
        def on_buf(_buf):
            count[0] += 1
            got.set()
        return on_buf

    try:
        for arm, (nt, desc, kw) in arms.items():
            pipe = nt.parse_launch(desc)
            count, got = [0], threading.Event()
            pipe.get("out").set_props(new_data=arrive(count, got))
            live[arm] = (pipe, nt.PipelineRunner(pipe, **kw).start(),
                         count, got)
        order = list(arms)
        lat = {arm: [] for arm in arms}
        for i in range(WARMUP + frames):
            for arm in (order if i % 2 == 0 else order[::-1]):
                pipe, _, _, got = live[arm]
                got.clear()
                t0 = time.perf_counter()
                pipe.get("src").push(frame)
                if not got.wait(120):
                    raise RuntimeError(f"{arm}: no label within 120 s")
                if i >= WARMUP:
                    lat[arm].append((time.perf_counter() - t0) * 1e3)
        fps = {arm: [] for arm in arms}
        for arm in order + order[::-1]:
            pipe, _, count, _ = live[arm]
            start = count[0]
            t0 = time.perf_counter()
            for _ in range(frames):
                pipe.get("src").push(frame)
            deadline = time.monotonic() + 300
            while count[0] < start + frames:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{arm}: burst not drained in 300 s")
                time.sleep(0.0005)
            fps[arm].append(frames / (time.perf_counter() - t0))
        for pipe, runner, _, _ in live.values():
            pipe.get("src").end()
            runner.wait(60)
    finally:
        for _, runner, _, _ in live.values():
            runner.stop()
    return lat, fps


LLM_DIMS = dict(d_model=1024, n_heads=8, n_layers=4, vocab=512)
LLM_PROPS = dict(model="store://llm_ab", n_heads=8, paged_kernel="pallas",
                 prefill_chunk=512, block_size=16, max_len=2048,
                 num_blocks=1025, max_batch=8, prewarm=512,
                 dtype="bfloat16")
LLM_REQUESTS = 8


def llm_requests(max_prompt: int):
    """8 prompts of lengths spread over 64..max_prompt (seeded)."""
    rng = np.random.default_rng(0)
    lens = rng.permutation(np.linspace(64, max_prompt,
                                       LLM_REQUESTS).astype(int))
    return [rng.integers(0, LLM_DIMS["vocab"], n).astype(np.int32)
            for n in lens]


def serve_llm(nt, requests, new_tokens: int) -> dict:
    """The LLM cell through package `nt`: every request pushed at t=0.
    → tokens/s, TTFT and ITL percentiles, tokens by request."""
    import torch

    el = importlib.import_module(nt.__name__ + ".elements")
    info = importlib.import_module(nt.__name__ + ".tensor.info")
    buffer = importlib.import_module(nt.__name__ + ".tensor.buffer")
    src = el.AppSrc(spec=info.TensorsSpec(
        tensors=(), format=info.TensorFormat.FLEXIBLE))
    llm = el.TensorLLM(**LLM_PROPS)
    sink = el.TensorSink()
    pipe = nt.Pipeline("llm")
    for e in (src, llm, sink):
        pipe.add(e)
    pipe.link(src, llm)
    pipe.link(llm, sink)
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    runner = nt.PipelineRunner(pipe).start()
    try:
        sync()
        t0 = time.perf_counter()
        for i, p in enumerate(requests):
            src.push(buffer.TensorBuffer(tensors=(p,), pts=i, meta={"llm": {
                "request_id": f"r{i}", "max_new_tokens": new_tokens}}))
        src.end()
        runner.wait(600)
        sync()
        wall = time.perf_counter() - t0
    finally:
        runner.stop()
    tokens = {}
    for b in sink.results:
        tokens.setdefault(b.meta["llm"]["request_id"], []).extend(
            int(t) for t in b.tensors[0])
    lat = llm.engine.latency_ms()
    n = llm.engine.tokens_out
    return {"tokens_per_s": n / wall, "seconds": wall, "tokens_out": n,
            "ttft_p50_ms": float(np.percentile(lat["first_token"], 50)),
            "itl_p50_ms": float(np.percentile(lat["inter_token"], 50)),
            "itl_p99_ms": float(np.percentile(lat["inter_token"], 99)),
            "tokens": tokens}


def llm_ab(old, new, args, card) -> dict:
    """Arms old and new serving the LLM cell in turns (module doc)."""
    params = new.models.transformer.init_params(**LLM_DIMS, seed=0)
    for nt in (old, new):
        store = importlib.import_module(nt.__name__ + ".serving.store")
        tb = importlib.import_module(nt.__name__ + ".backends.torch_backend")
        store.get_store().register("llm_ab", tb.ModelBundle(
            fn=None, params=params))
    requests = llm_requests(args.max_prompt)
    arms = {"old": old, "new": new}
    runs = {arm: [] for arm in arms}
    ref = {}
    for arm, nt in arms.items():
        ref[arm] = serve_llm(nt, requests, args.tokens)["tokens"]
    same = ref["old"] == ref["new"]
    for r in range(args.repeats):
        for arm in ("old", "new", "new", "old"):
            res = serve_llm(arms[arm], requests, args.tokens)
            same = same and res.pop("tokens") == ref["old"]
            runs[arm].append(res)
            print(f"runtime_ab: LLM, repeat {r}, {arm}: "
                  f"{res['tokens_per_s']:.1f} tokens/s, TTFT p50 "
                  f"{res['ttft_p50_ms']:.3f} ms, ITL p50 "
                  f"{res['itl_p50_ms']:.3f} ms p99 {res['itl_p99_ms']:.3f} "
                  f"ms [{card}]", flush=True)
    summary = {arm: {k: statistics.median(x[k] for x in rs)
                     for k in ("tokens_per_s", "ttft_p50_ms", "itl_p50_ms",
                               "itl_p99_ms")}
               for arm, rs in runs.items()}
    s = summary["new"]
    s["tokens_per_s_vs_old_pct"] = 100 * (
        s["tokens_per_s"] / summary["old"]["tokens_per_s"] - 1)
    s["itl_p50_vs_old_pct"] = 100 * (
        s["itl_p50_ms"] / summary["old"]["itl_p50_ms"] - 1)
    print(f"runtime_ab: LLM: " + "; ".join(
        f"{arm} {v['tokens_per_s']:.1f} tokens/s, ITL p50 "
        f"{v['itl_p50_ms']:.3f} ms p99 {v['itl_p99_ms']:.3f} ms"
        for arm, v in summary.items())
        + f" (new vs old: tokens/s {s['tokens_per_s_vs_old_pct']:+.2f}%, "
        f"ITL p50 {s['itl_p50_vs_old_pct']:+.2f}%); tokens equal: {same}; "
        f"medians of {2 * args.repeats} runs an arm [{card}]")
    return {"runs": runs, "summary": summary, "tokens_equal": same}


def card_name() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no card"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_root")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="JSON record (default chiprun_out/runtime_ab.json, "
                         "runtime_ab_llm.json with --llm)")
    ap.add_argument("--llm", action="store_true",
                    help="compare LLM serving instead of pipelines A/B")
    ap.add_argument("--tokens", type=int, default=64,
                    help="--llm: new tokens a request")
    ap.add_argument("--max-prompt", type=int, default=1536,
                    help="--llm: the longest prompt")
    args = ap.parse_args(argv)
    old_root = Path(args.old_root).resolve()
    if not (old_root / PKG).is_dir():
        ap.error(f"no {PKG} package in {old_root}")
    # one kernel directory for both packages (the same sources build once)
    os.environ.setdefault("NNSTREAMER_TPU_TORCH_BUILD_KERNEL_DIR",
                          str(ROOT / "build" / "torch_kernels"))
    sys.path.insert(0, str(ROOT))
    new = importlib.import_module(PKG)
    old = load_old(old_root)
    card = card_name()
    if args.llm:
        importlib.import_module(PKG + ".models.transformer")
        res = llm_ab(old, new, args, card)
        out = Path(args.out or "chiprun_out/runtime_ab_llm.json")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "old_root": str(old_root),
                                   **res}))
        return 0
    frame = np.random.default_rng(0).integers(0, 256, (1, 224, 224, 3),
                                              np.uint8)
    runs, lats = {}, {}
    for p, norm in NORM.items():
        desc = PIPE.format(norm)
        arms = {"old": (old, desc, {}), "new": (new, desc, {}),
                "new, watchdog and fusion off": (
                    new, desc, {"watchdog": False, "chain_fusion": False})}
        runs[p] = {arm: [] for arm in arms}
        lats[p] = {arm: [] for arm in arms}
        for r in range(args.repeats):
            lat, fps = interleave(arms, frame, args.frames)
            for arm in arms:
                lats[p][arm] += lat[arm]
                res = {"p50_ms": float(np.percentile(lat[arm], 50)),
                       "p99_ms": float(np.percentile(lat[arm], 99)),
                       "mean_ms": float(np.mean(lat[arm])),
                       "fps": statistics.median(fps[arm])}
                runs[p][arm].append(res)
                print(f"runtime_ab: {p}, repeat {r}, {arm}: p50 "
                      f"{res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms, "
                      f"{res['fps']:.1f} frames/s [{card}]", flush=True)
    summary = {}
    for p, by_arm in runs.items():
        s = summary[p] = {}
        for arm, reps in by_arm.items():
            s[arm] = {k: statistics.median(x[k] for x in reps)
                      for k in ("p50_ms", "p99_ms", "fps")}
        for arm in by_arm:
            if arm == "old":
                continue
            s[arm]["p50_vs_old_pct"] = 100 * (
                s[arm]["p50_ms"] / s["old"]["p50_ms"] - 1)
            s[arm]["fps_vs_old_pct"] = 100 * (
                s[arm]["fps"] / s["old"]["fps"] - 1)
            d = np.subtract(lats[p][arm], lats[p]["old"])
            s[arm]["paired_ms"] = float(np.median(d))
            s[arm]["slower_share"] = float(np.mean(d > 0))
        print(f"runtime_ab: {p}: " + "; ".join(
            f"{arm} p50 {v['p50_ms']:.3f} ms, {v['fps']:.1f} frames/s"
            + (f" ({v['p50_vs_old_pct']:+.2f}% / {v['fps_vs_old_pct']:+.2f}%"
               f" vs old; paired {v['paired_ms']:+.4f} ms a frame, slower "
               f"in {100 * v['slower_share']:.1f}% of rounds)"
               if arm != "old" else "")
            for arm, v in s.items())
            + f"; medians of {args.repeats} repeats [{card}]")
    out = Path(args.out or "chiprun_out/runtime_ab.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "old_root": str(old_root),
                               "runs": runs, "summary": summary,
                               "latencies_ms": lats}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   its plain version's time;
7. the paged-attention kernels (decode, prefill) against their plain
   torch versions on the card: full width (8 heads, hd 128, block 16)
   and GQA (8 heads on 2 kv heads), holey and out-of-order tables,
   staggered rows (one at a block boundary), pow2 padding rows, a
   multi-chunk prefill with pos0 > 0, q in f32 and bf16 — within
   1e-5 * max|plain| + 1e-6;
8. LLM serving at full width through tensor_llm (d_model 1024, 8 heads,
   4 layers, vocab 512, max_len 2048; paged_kernel=pallas,
   prefill_chunk=512): 8 requests of 64-1536 prompt tokens, 64 new tokens
   each, all at t=0. In f32 the kernel arm's tokens equal the torch
   reference arm's (paged_kernel=xla);
9. the same in bf16 activations: tokens/s, time to first token and
   inter-token latency p50/p99, and the kernels' launches counted by the
   wrappers and by name in a profiler trace (4 per decode step, 4 per
   prefill chunk);
10. each paged kernel's device time at the serving shapes beside its
   bytes bound, its plain version's time and
   scaled_dot_product_attention's on K/V gathered beforehand.

It prints the seconds of each phase, the card line and a JSON line of
kernel numbers before the last line, and ends with {"ok": true,
"device": {...}}. Any failed check raises, so the exit code is non-zero
and no result line is printed. Without a CUDA device, or run outside the
checkout, it exits non-zero at once. A JSON record of the run goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FRAMES = 16
#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and f32
#: (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
CPU_TOLERANCE = 1e-3     # card vs CPU, relative to max |logit|
#: paged kernel vs plain: max |diff| <= REL * max |plain| + ABS (f32;
#: the kernel's online softmax sums in another order than the plain one)
PAGED_REL, PAGED_ABS = 1e-5, 1e-6
#: the widest transformer the repo ran on a chip (bench.py:1154), MHA
LLM_DIMS = dict(d_model=1024, n_heads=8, n_layers=4, vocab=512)
LLM_PROPS = dict(model="store://llm_full", n_heads=8, paged_kernel="pallas",
                 prefill_chunk=512, block_size=16, max_len=2048,
                 num_blocks=1025, max_batch=8, prewarm=512)
LLM_REQUESTS, LLM_NEW_TOKENS = 8, 64
#: the top-2 logit gap below which a token flip between the two f32 arms
#: is a near-tie, not a fault (relative to max |logit|)
LLM_TIE = 1e-4

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


class Phases:
    """Prints each phase's seconds as it ends."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds = {}

    def done(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t0
        print(f"phase {name}: {now - self.t0:.2f} s")
        self.t0 = now


# -- paged attention: kernels vs plain ----------------------------------------

def paged_cases(torch, dev):
    """(name, kernel fn, plain fn, args) for every checked case: decode
    and prefill at full width (8 heads, 8 kv heads, hd 128, block 16)
    and GQA (8 heads on 2 kv heads), q f32 and bf16."""
    from nnstreamer_tpu_torch.backends import paged_attn as pa

    rng = np.random.default_rng(1)
    nb, bs, hd, mb = 1025, 16, 128, 128
    cases = []
    for n_kv in (8, 2):
        pools = [torch.from_numpy(rng.standard_normal(
            (nb, bs, n_kv, hd)).astype(np.float32)).to(dev)
            for _ in range(2)]
        # rows: holey/out-of-order tables, staggered depths (row 1 at a
        # block boundary), two pow2 padding rows on the scratch block
        tables = np.zeros((8, mb), np.int32)
        pos = np.zeros(8, np.int32)
        perm = rng.permutation(np.arange(1, nb))
        for b, depth in enumerate((1535, 16, 700, 63, 1000, 3)):
            n = depth // bs + 1
            tables[b, :n] = perm[b * mb:b * mb + n]
            pos[b] = depth
        t_tab = torch.from_numpy(tables).to(dev)
        t_pos = torch.from_numpy(pos).to(dev)
        seq = torch.from_numpy(tables[0]).to(dev)   # 96 holey blocks
        for qdt in (torch.float32, torch.bfloat16):
            tag = f"kv{n_kv} {str(qdt).split('.')[-1]}"
            q = torch.from_numpy(rng.standard_normal(
                (8, 8, hd)).astype(np.float32)).to(dev, qdt)
            cases.append((f"decode {tag} B8", pa.paged_decode_attn,
                          pa.paged_decode_attn_plain,
                          (q, *pools, t_tab, t_pos)))
            # chunks: first of a long prompt, later chunks (pos0 > 0,
            # one not block-aligned), a short chunk padded to its bucket
            for s_c, pos0 in ((512, 0), (512, 1024), (64, 1000), (8, 0)):
                qp = torch.from_numpy(rng.standard_normal(
                    (8, s_c, hd)).astype(np.float32)).to(dev, qdt)
                cases.append((f"prefill {tag} S{s_c} pos0={pos0}",
                              pa.paged_prefill_attn,
                              pa.paged_prefill_attn_plain,
                              (qp, *pools, seq, pos0)))
    return cases


def check_paged_kernels(torch, dev, record) -> dict:
    """Each paged kernel against its plain version on every case → the
    largest abs error per kernel at the main-path shape (kv8, bf16)."""
    errs = {}
    for name, kern, plain, args in paged_cases(torch, dev):
        got = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        lim = PAGED_REL * ref.abs().max().item() + PAGED_ABS
        print(f"phase 7: {name}: max_abs_err {err:.3e} (limit {lim:.3e})")
        check(torch.isfinite(got).all().item(), f"{name}: non-finite output")
        check(err <= lim, f"{name}: kernel differs from its plain version "
                          f"by {err:.3e} > {lim:.3e}")
        record.setdefault("paged_kernel_errs", {})[name] = err
        if "kv8 bfloat16" in name:
            key = name.split()[0]
            errs[key] = max(errs.get(key, 0.0), err)
    return errs


# -- LLM serving ---------------------------------------------------------------

def on_device(params, dev):
    """A transformer params dict (nested dicts/lists of tensors) on dev."""
    if isinstance(params, dict):
        return {k: on_device(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [on_device(v, dev) for v in params]
    return params.to(dev)


def llm_requests():
    """8 prompts of lengths spread over 64-1536 (seeded)."""
    rng = np.random.default_rng(0)
    lens = rng.permutation(np.linspace(64, 1536, LLM_REQUESTS).astype(int))
    return [rng.integers(0, LLM_DIMS["vocab"], n).astype(np.int32)
            for n in lens]


def serve(nt, torch, requests, prof=None, **props):
    """appsrc ! tensor_llm ! tensor_sink with every request pushed at
    t=0. The launch counts are zeroed after start() (which prewarms) and
    read after the run. → (tokens by request id, element, seconds from
    the first push to the last token, launches by kernel)."""
    from nnstreamer_tpu_torch.backends import paged_attn as pa
    from nnstreamer_tpu_torch.elements import AppSrc, TensorLLM, TensorSink
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
    from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec

    src = AppSrc(spec=TensorsSpec(tensors=(), format=TensorFormat.FLEXIBLE))
    llm = TensorLLM(**{**LLM_PROPS, **props})
    sink = TensorSink()
    pipe = nt.Pipeline("llm")
    for e in (src, llm, sink):
        pipe.add(e)
    pipe.link(src, llm)
    pipe.link(llm, sink)
    runner = nt.PipelineRunner(pipe).start()
    try:
        torch.cuda.synchronize()
        pa.paged_decode_attn.launches = 0
        pa.paged_prefill_attn.launches = 0
        with prof or nullcontext():
            t0 = time.perf_counter()
            for i, p in enumerate(requests):
                src.push(TensorBuffer(tensors=(p,), pts=i, meta={"llm": {
                    "request_id": f"r{i}",
                    "max_new_tokens": LLM_NEW_TOKENS}}))
            src.end()
            runner.wait(600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {"paged_decode_attn": pa.paged_decode_attn.launches,
                    "paged_prefill_attn": pa.paged_prefill_attn.launches}
    finally:
        runner.stop()
    tokens = {}
    for b in sink.results:
        tokens.setdefault(b.meta["llm"]["request_id"], []).extend(
            int(t) for t in b.tensors[0])
    for i in range(len(requests)):
        check(len(tokens.get(f"r{i}", ())) == LLM_NEW_TOKENS,
              f"request r{i} got {len(tokens.get(f'r{i}', ()))} tokens")
    return tokens, llm, wall, launches


def check_f32_parity(torch, tt, params, requests, got, ref) -> int:
    """Kernel arm vs torch-reference arm, token for token. A flip where
    the reference's top-2 logits are within LLM_TIE * max|logit| is a
    near-tie and tolerated; any other flip fails. → flips tolerated."""
    ties = 0
    for i, p in enumerate(requests):
        a, b = got[f"r{i}"], ref[f"r{i}"]
        if a == b:
            continue
        k = next(j for j in range(len(a)) if a[j] != b[j])
        seq = torch.from_numpy(np.concatenate(
            [p, np.asarray(b[:k], np.int32)])[None]).to(params["embed"].device)
        with torch.inference_mode():
            logits = tt.apply_seq_kv(params, seq, n_heads=8)[0][0, -1]
        top2 = torch.topk(logits, 2).values
        gap = (top2[0] - top2[1]).item()
        lim = LLM_TIE * logits.abs().max().item()
        print(f"phase 8: r{i} (prompt {len(p)}): tokens differ at step {k} "
              f"({a[k]} vs {b[k]}); reference top-2 gap {gap:.3e}, "
              f"near-tie limit {lim:.3e}")
        check(gap <= lim, f"r{i}: kernel arm differs from the torch "
                          f"reference at step {k} with a top-2 gap {gap:.3e}")
        ties += 1
    return ties


def paged_timing(torch, dev, requests, card) -> dict:
    """Each paged kernel at the serving shapes (bf16 q as in phase 9;
    decode: the 8 rows midway through their 64 new tokens; prefill: the
    third 512-token chunk of the longest prompt) → kernel, plain and
    SDPA-on-pre-gathered times and the bytes bound."""
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.backends import paged_attn as pa

    rng = np.random.default_rng(2)
    nb, bs, n_kv, hd, mb, heads = 1025, 16, 8, 128, 128, 8
    pools = [torch.from_numpy(rng.standard_normal(
        (nb, bs, n_kv, hd)).astype(np.float32)).to(dev) for _ in range(2)]
    perm = rng.permutation(np.arange(1, nb))
    pos = np.array([len(p) + LLM_NEW_TOKENS // 2 for p in requests],
                   np.int32)
    tables = np.zeros((len(requests), mb), np.int32)
    for b, p in enumerate(pos):
        n = (len(requests[b]) + LLM_NEW_TOKENS - 1) // bs + 1
        tables[b, :n] = perm[b * mb:b * mb + n]
    t_tab, t_pos = (torch.from_numpy(a).to(dev) for a in (tables, pos))
    q_dec = torch.from_numpy(rng.standard_normal(
        (len(requests), heads, hd)).astype(np.float32)).to(dev, torch.bfloat16)
    s_c, pos0 = 512, 1024
    q_pre = torch.from_numpy(rng.standard_normal(
        (heads, s_c, hd)).astype(np.float32)).to(dev, torch.bfloat16)
    seq = t_tab[int(np.argmax([len(p) for p in requests]))]

    def gathered(table, rows):
        kv = [pl[table].reshape(rows, -1, n_kv, hd).transpose(1, 2)
              for pl in pools]
        return kv

    # decode yardstick: q (B, H, 1, hd) f32 against K/V gathered beforehand
    kd, vd = gathered(t_tab, len(requests))
    dmask = (torch.arange(mb * bs, device=dev)[None, :]
             <= t_pos[:, None])[:, None, None, :]
    qd32 = q_dec.float()[:, :, None]
    kp, vp = gathered(seq, 1)
    pmask = (torch.arange(mb * bs, device=dev)[None, :]
             <= pos0 + torch.arange(s_c, device=dev)[:, None])[None, None]
    qp32 = q_pre.float()[None]
    kv_row = n_kv * hd * 4 * 2
    dec_bytes = (int((pos + 1).sum()) * kv_row + q_dec.numel() * 2
                 + q_dec.numel() * 4 + tables.nbytes + pos.nbytes)
    dec_ops = int((pos + 1).sum()) * 4 * hd * heads
    kv_tokens = min(pos0 + s_c, mb * bs)
    pre_bytes = (kv_tokens * kv_row + q_pre.numel() * 2 + q_pre.numel() * 4
                 + seq.numel() * 4)
    pre_ops = sum(pos0 + r + 1 for r in range(s_c)) * 4 * hd * heads
    work = {
        "paged_decode_attn": (
            lambda: pa.paged_decode_attn(q_dec, *pools, t_tab, t_pos),
            lambda: pa.paged_decode_attn_plain(q_dec, *pools, t_tab, t_pos),
            lambda: F.scaled_dot_product_attention(qd32, kd, vd,
                                                   attn_mask=dmask),
            dec_bytes, dec_ops, f"B{len(requests)} rows at pos "
                                f"{pos.tolist()}"),
        "paged_prefill_attn": (
            lambda: pa.paged_prefill_attn(q_pre, *pools, seq, pos0),
            lambda: pa.paged_prefill_attn_plain(q_pre, *pools, seq, pos0),
            lambda: F.scaled_dot_product_attention(qp32, kp, vp,
                                                   attn_mask=pmask),
            pre_bytes, pre_ops, f"S_c {s_c} at pos0 {pos0}"),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, ops, shape) in work.items():
        launches = getattr(pa, name).launches
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOPS * 1e3
        res = {"ms": device_ms_per_call(torch, kern, 20),
               "event_ms": event_ms_per_call(torch, kern, 50),
               "plain_ms": device_ms_per_call(torch, plain, 20),
               "plain_event_ms": event_ms_per_call(torch, plain, 50),
               "library_ms": device_ms_per_call(torch, lib, 20),
               "bytes": nbytes, "ops": ops,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        getattr(pa, name).launches = launches   # timing launches not counted
        out[name] = res
        print(f"phase 10: {name} ({shape}, kv8 hd128 bs16, q bf16): "
              f"device {res['ms']:.5f} ms per launch (profiler), "
              f"{res['event_ms']:.5f} ms per call (CUDA events); plain torch "
              f"{res['plain_ms']:.5f} ms device, {res['plain_event_ms']:.5f} "
              f"ms per call; SDPA on pre-gathered K/V, gather not timed, "
              f"{res['library_ms']:.5f} ms device; bound "
              f"{res['bound_ms']:.6f} ms ({res['bound_by']}: {nbytes} B at "
              f"3.35 TB/s, {ops} flop at 67 TFLOP/s f32) [{card}]")
    return out


def llm_phases(nt, torch, card, record, phases) -> dict:
    """Phases 7-10. → kernel entries for the JSON line."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.models import transformer as tt
    from nnstreamer_tpu_torch.serving.store import get_store

    dev = torch.device("cuda", 0)
    errs = check_paged_kernels(torch, dev, record)
    phases.done("7 (paged kernels vs plain)")

    params = tt.init_params(**LLM_DIMS, seed=0)
    get_store().register("llm_full", ModelBundle(fn=None, params=params))
    requests = llm_requests()
    print(f"phase 8: prompt lengths {[len(p) for p in requests]}, "
          f"{LLM_NEW_TOKENS} new tokens each")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got, _, wall_k, _ = serve(nt, torch, requests, dtype="float32")
    ref, _, wall_r, _ = serve(nt, torch, requests, dtype="float32",
                              paged_kernel="xla")
    ties = check_f32_parity(torch, tt, on_device(params, dev), requests,
                            got, ref) if got != ref else 0
    same = sum(got[k] == ref[k] for k in got)
    print(f"phase 8: f32 kernel arm vs torch reference arm: {same}/"
          f"{len(requests)} requests token-identical, {ties} near-tie "
          f"flips; {wall_k:.2f} s vs {wall_r:.2f} s")
    torch.backends.cudnn.allow_tf32 = True
    record["llm_f32"] = {"identical": same, "near_ties": ties}
    phases.done("8 (LLM f32 parity)")

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _, llm, wall_p, launches = serve(nt, torch, requests, prof=prof,
                                     dtype="bfloat16")
    ex = llm.engine.executor
    evs = kernel_events(prof)
    named = {k: sum(f"nns_{k[:-5]}_kernel" in e.name for e in evs)
             for k in launches}                # paged_x_attn → nns_paged_x_kernel
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e6 / wall_p
    host = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total,
                  reverse=True)[:8]
    print("phase 9: host time by op (profiled run, self CPU ms): " + "; ".join(
        f"{a.key} x{a.count} {a.self_cpu_time_total / 1e3:.1f}" for a in host))
    print(f"phase 9: bf16 (profiled): {ex.decode_steps} decode steps, "
          f"{ex.chunk_prefills} prefill chunks, kernel_invokes "
          f"{ex.kernel_invokes}; wrapper launches {launches}; profiler "
          f"launches by name {named}; card busy {100 * busy:.1f}% of "
          f"{wall_p:.3f} s")
    check(launches == named, f"wrapper launches {launches} != profiler "
                             f"{named}")
    check(launches["paged_decode_attn"] == 4 * ex.decode_steps > 0,
          "not 4 decode launches per decode step")
    check(launches["paged_prefill_attn"] == 4 * ex.chunk_prefills > 0,
          "not 4 prefill launches per chunk")
    _, llm, wall, _ = serve(nt, torch, requests, dtype="bfloat16")
    lat = llm.engine.latency_ms()
    ntok = llm.engine.tokens_out
    serving = {"tokens": ntok, "seconds": wall, "tokens_per_s": ntok / wall,
               "ttft_p50_ms": float(np.percentile(lat["first_token"], 50)),
               "ttft_p99_ms": float(np.percentile(lat["first_token"], 99)),
               "itl_p50_ms": float(np.percentile(lat["inter_token"], 50)),
               "itl_p99_ms": float(np.percentile(lat["inter_token"], 99)),
               "decode_steps": llm.engine.executor.decode_steps,
               "prefill_chunks": llm.engine.executor.chunk_prefills,
               "kernel_invokes": dict(llm.engine.executor.kernel_invokes),
               "launches": launches, "profiler_launches": named,
               "busy_share_profiled": busy}
    print(f"phase 9: bf16: {ntok} tokens in {wall:.3f} s = "
          f"{serving['tokens_per_s']:.1f} tokens/s; time to first token "
          f"p50 {serving['ttft_p50_ms']:.3f} ms p99 "
          f"{serving['ttft_p99_ms']:.3f} ms; inter-token latency p50 "
          f"{serving['itl_p50_ms']:.3f} ms p99 {serving['itl_p99_ms']:.3f} "
          f"ms [{card}]")
    record["llm_bf16"] = serving
    phases.done("9 (LLM bf16 serving)")

    timing = paged_timing(torch, dev, requests, card)
    record["paged_timing"] = timing
    phases.done("10 (paged kernel timings)")
    return [{
        "name": name, "route": "cuda",
        "source": "nnstreamer_tpu_torch/backends/csrc/paged_attn.cu",
        "replaces": f"nnstreamer_tpu/backends/pallas_paged.py:{line}",
        "launches": launches[name], "max_abs_err": errs[key],
        "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"]}
        for name, key, line in (("paged_decode_attn", "decode", 69),
                                ("paged_prefill_attn", "prefill", 170))]


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
    phases = Phases()
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
    phases.done("1 (environment)")

    # -- 2. build -----------------------------------------------------------
    # one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = ("normalize.cu", "paged_attn.cu")
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(cuda_build.build, sources))
    build_s = time.perf_counter() - t0
    for lib in libs:
        ptxas = [l.strip() for l in lib.with_suffix(".log").read_text()
                 .splitlines() if "registers" in l or "spill" in l]
        print(f"phase 2: built {lib.name}")
        for line in ptxas:
            print(f"phase 2: ptxas: {line}")
    print(f"phase 2: built {len(libs)} kernel libraries in {build_s:.2f} s "
          f"(in parallel)")
    record["build_s"] = build_s
    phases.done("2 (build)")

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

    phases.done("3 (normalize_u8 vs plain)")

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
    phases.done("4 (pipelines A and B)")

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
    phases.done("5 (B f32 card vs CPU)")

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
    phases.done("6 (timings)")

    # -- 7-10. paged attention and LLM serving -----------------------------
    paged = llm_phases(nt, torch, card, record, phases)
    record["phase_seconds"] = phases.seconds

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
        "library_ms": None}, *paged]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time design variants of two hand-written kernels on the card.

    python3 nnstreamer_tpu_torch/tools/kernel_variants.py [SECTION ...]

Needs one CUDA card and nvcc, and runs from a checkout (it uses
chip_smoke.py's timers). SECTIONs (all by default): ring, clamp, decode,
quantize. It builds, into build/kernel_variants/:

- a copy of backends/csrc/flash_attn_tc.cu with one more entry point,
  which launches the bf16 ring-step kernel in a layout chosen by index
  (query warps, key warps, keys per tile): each layout is held to the
  plain version under chip_smoke.py's bf16 rule, then timed at the
  serving ring's BH 8 and the forward's BH 64 (512 x 512 x 128, a block
  below the diagonal and one on it); the shipped wrapper's time at BH 8
  over Sk 64 .. 512 (non-causal) and for a block above the diagonal,
  which launches and returns at once, beside flash at the same work;
- an f32 clamp kernel in variants of the clip (with short-circuit && and
  ||, or with & and |), threads, 16-byte vectors a thread and the grid
  (the tensor's size, or one wave of resident CTAs that loops), each
  checked bit for bit against the plain version and timed at P's frame
  (1x257x257x3) and at 16M elements beside the shipped kernel and
  torch.clamp, in turns; and the count of branch instructions in each
  clip's SASS (cuobjdump);
- copies of backends/csrc/quantize_rows.cu whose register path spreads a
  row over other numbers of values a lane and packs rows into other CTA
  sizes, each checked bit for bit against the plain version and timed at
  the main path's five shapes beside the launch floor, in turns.

It also launches the shipped paged decode kernel under other split plans
(CTAs aimed at per SM, so blocks per split), each held to the plain
version and timed at the serving shape and at one row at pos 1567, in
turns.

PERF.md cites the numbers it prints.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "kernel_variants"
#: ring-step layouts at head dim 128: (query warps, key warps, keys a tile)
RING_LAYOUTS = [(4, 1, 64), (2, 2, 64), (1, 4, 64), (2, 4, 64), (1, 8, 128)]
#: decode split plans: CTAs aimed at per SM (the shipped plan's
#: paged_attn.DECODE_CTAS_PER_SM is one of them)
DECODE_CTAS = [2, 4, 8, 16, 32]
#: quantize_rows register layouts: (values a lane, threads a CTA at least)
QUANT_LAYOUTS = [(8, 128), (4, 128), (16, 128), (32, 128), (8, 256),
                 (16, 256)]
#: clamp variants: (branch-free clip, threads, vectors a thread, one wave)
CLAMP_VARIANTS = [(False, 256, 1, False), (True, 256, 1, False),
                  (True, 128, 2, False), (True, 128, 4, False),
                  (True, 128, 4, True)]

CLAMP_SRC = r'''
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float clip_branchy(float x, float lo, float hi) {
  if (isnan(x)) return x;
  float v = (x < lo || (x == lo && signbit(x))) ? lo : x;
  return (v > hi || (v == hi && !signbit(v))) ? hi : v;
}

__device__ __forceinline__ float clip_free(float x, float lo, float hi) {
  const bool below = (x < lo) | ((x == lo) & (__float_as_int(x) < 0));
  const float v = below ? lo : x;
  const bool above = (v > hi) | ((v == hi) & (__float_as_int(v) >= 0));
  return above ? hi : v;
}

template <bool FREE, int T, int U>
__global__ void __launch_bounds__(T) clamp_variant(
    const float4* __restrict__ x, float4* __restrict__ y,
    const float* __restrict__ xs, float* __restrict__ ys, uint32_t n,
    float lo, float hi) {
  const uint32_t nvec = n / 4;
  for (uint32_t base = blockIdx.x * T * U + threadIdx.x; base < nvec;
       base += gridDim.x * T * U) {
    float4 in[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * T < nvec) in[u] = x[base + u * T];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * T >= nvec) continue;
      float4 o = in[u];
      o.x = FREE ? clip_free(o.x, lo, hi) : clip_branchy(o.x, lo, hi);
      o.y = FREE ? clip_free(o.y, lo, hi) : clip_branchy(o.y, lo, hi);
      o.z = FREE ? clip_free(o.z, lo, hi) : clip_branchy(o.z, lo, hi);
      o.w = FREE ? clip_free(o.w, lo, hi) : clip_branchy(o.w, lo, hi);
      y[base + u * T] = o;
    }
  }
  if (blockIdx.x == gridDim.x - 1)
    for (uint32_t i = nvec * 4 + threadIdx.x; i < n; i += T)
      ys[i] = FREE ? clip_free(xs[i], lo, hi) : clip_branchy(xs[i], lo, hi);
}

template <bool FREE, int T, int U>
int run(const void* x, void* y, uint32_t n, float lo, float hi, int wave,
        cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long grid = ((long long)n / 4 + T * U - 1) / (T * U);
  if (grid < 1) grid = 1;
  if (wave && grid > (long long)sms * (2048 / T)) grid = sms * (2048 / T);
  clamp_variant<FREE, T, U><<<(int)grid, T, 0, s>>>(
      (const float4*)x, (float4*)y, (const float*)x, (float*)y, n, lo, hi);
  return cudaGetLastError();
}

extern "C" int variant_clamp(int v, const void* x, void* y, uint32_t n,
                             float lo, float hi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (v) {
%s
    default: return 1;
  }
}
'''

RING_ENTRY = r'''
extern "C" int variant_block(int v, const void* q, const void* k,
    const void* v_, void* m, void* l, void* acc, int bh, int heads, int sq,
    int sk, int d, int64_t a0, int64_t a1, int64_t a2, int64_t b0,
    int64_t b1, int64_t b2, int64_t c0, int64_t c1, int64_t c2,
    float scale, int causal, int q_off, int k_off, void* stream) {
  const Strides qs{a0, a1, a2}, ks{b0, b1, b2}, vs{c0, c1, c2};
  float* mf = (float*)m; float* lf = (float*)l; float* af = (float*)acc;
  cudaStream_t s = (cudaStream_t)stream;
  switch (v) {
%s
    default: return 1;
  }
}
'''


def build(cuda_build) -> tuple:
    """Write and compile the two variant sources → (ring .so, clamp .so,
    clamp SASS)."""
    OUT.mkdir(parents=True, exist_ok=True)
    ring = (cuda_build.CSRC / "flash_attn_tc.cu").read_text() + RING_ENTRY % \
        "\n".join(
            f"    case {i}: return launch_block_cfg<128, {qw}, {kw}, {tk}>("
            f"q, k, v_, mf, lf, af, qs, ks, vs, bh, heads, sq, sk, d, scale,"
            f" causal, q_off, k_off, s);"
            for i, (qw, kw, tk) in enumerate(RING_LAYOUTS))
    clamp = CLAMP_SRC % "\n".join(
        f"    case {i}: return run<{str(free).lower()}, {t}, {u}>(x, y, n, "
        f"lo, hi, {int(wave)}, s);"
        for i, (free, t, u, wave) in enumerate(CLAMP_VARIANTS))
    nvcc = cuda_build.find_nvcc()

    def compile_(name, text):
        src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
        src.write_text(text)
        proc = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib),
                               str(src)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}: {proc.stderr[-3000:]}")
        return lib

    with ThreadPoolExecutor(3) as pool:
        libs = list(pool.map(compile_, ("ring_variants", "clamp_variants"),
                             (ring, clamp)))
        list(pool.map(cuda_build.build, ("flash_attn_tc.cu",
                                         "clamp_scale.cu")))
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(libs[1])], capture_output=True,
                          text=True).stdout
    return libs[0], libs[1], sass


def build_quantize(cuda_build) -> list:
    """Copies of quantize_rows.cu in QUANT_LAYOUTS → their libraries."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (cuda_build.CSRC / "quantize_rows.cu").read_text()
    lanes = "lanes = (k + 7) / 8;"
    threads = "constexpr int kRegThreads = 128;"
    assert lanes in src and threads in src
    nvcc = cuda_build.find_nvcc()

    def compile_(layout):
        values, cta = layout
        name = f"quantize_v{values}_t{cta}"
        text = src.replace(lanes, f"lanes = (k + {values - 1}) / {values};")
        text = text.replace(threads, f"constexpr int kRegThreads = {cta};")
        (OUT / f"{name}.cu").write_text(text)
        lib = OUT / f"{name}.so"
        proc = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib),
                               str(OUT / f"{name}.cu")], capture_output=True,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}: {proc.stderr[-3000:]}")
        return lib

    with ThreadPoolExecutor(len(QUANT_LAYOUTS)) as pool:
        return list(pool.map(compile_, QUANT_LAYOUTS))


def decode_plans(torch, cs, card) -> None:
    """The shipped decode kernel under each plan of DECODE_CTAS, held to
    the plain version and timed in turns."""
    from nnstreamer_tpu_torch.backends import paged_attn as pa

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(12)
    nb, bs, n_kv, hd, mb = 1025, 16, 8, 128, 128
    pools = [torch.from_numpy(rng.standard_normal(
        (nb, bs, n_kv, hd)).astype(np.float32)).to(dev) for _ in range(2)]
    perm = rng.permutation(np.arange(1, nb))
    lens = [len(p) + cs.LLM_NEW_TOKENS // 2 for p in cs.llm_requests()]
    sms = cs.sm_count(torch, dev)
    lib = cuda_build_load(pa)
    for label, depths in (("serving B8", lens), ("B1 pos 1567", [1567])):
        tables, pos = cs.decode_rows(rng, perm, depths, bs, mb)
        tab, ps = (torch.from_numpy(a).to(dev) for a in (tables, pos))
        q = torch.from_numpy(rng.standard_normal(
            (len(depths), 8, hd)).astype(np.float32)).to(dev, torch.bfloat16)
        ref = pa.paged_decode_attn_plain(q, *pools, tab, ps)
        fns = {}
        for ctas in DECODE_CTAS:
            shipped = pa.DECODE_CTAS_PER_SM
            pa.DECODE_CTAS_PER_SM = ctas
            plan = pa.decode_plan(len(depths), 8, n_kv, hd, bs, mb, sms)
            pa.DECODE_CTAS_PER_SM = shipped
            ws = torch.empty(max(1, len(depths) * n_kv * plan.splits *
                                 plan.part_floats), device=dev)
            tk = torch.zeros(len(depths) * n_kv, dtype=torch.int32,
                             device=dev)

            def run(plan=plan, ws=ws, tk=tk):
                out = torch.empty((len(depths), 8, hd), device=dev)
                sb, ss, sh, _ = pools[0].stride()
                err = lib.nns_paged_decode(
                    q.data_ptr(), 1, pools[0].data_ptr(), pools[1].data_ptr(),
                    tab.data_ptr(), ps.data_ptr(), out.data_ptr(),
                    ws.data_ptr(), ws.numel(), tk.data_ptr(), tk.numel(),
                    len(depths), 8, n_kv, hd, bs, mb, plan.splits, plan.bps,
                    sb, ss, sh, hd ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return out

            err = (run() - ref).abs().max().item()
            assert err <= cs.PAGED_REL * ref.abs().max().item() + cs.PAGED_ABS
            fns[f"{ctas} CTAs an SM: {plan.splits} splits of {plan.bps} "
                f"blocks"] = run
        names = list(fns)
        times = {n: [] for n in names}
        for order in (names, names[::-1]):          # in turns
            for n in order:
                times[n].append(cs.device_ms_per_call(torch, fns[n], 50))
        for n in names:
            print(f"decode {label}, {n}: {np.mean(times[n]):.5f} ms queued "
                  f"({', '.join(f'{t:.5f}' for t in times[n])}) [{card}]")


def cuda_build_load(pa):
    from nnstreamer_tpu_torch.backends import cuda_build

    return cuda_build.load("paged_attn.cu", pa._SIGNATURES)


def quantize_layouts(torch, cs, card, libs) -> None:
    """Each QUANT_LAYOUTS copy at the main path's shapes, bit for bit and
    timed in turns beside the launch floor."""
    from nnstreamer_tpu_torch.backends import kernels

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(13)
    floor = cs.device_ms_per_call(torch, lambda: torch.cuda._sleep(0), 200)
    print(f"quantize_rows: launch floor {floor:.5f} ms [{card}]")
    fns_lib = []
    for lib in libs:
        cdll = ctypes.CDLL(str(lib))
        cdll.nns_quantize_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        cdll.nns_quantize_rows.restype = ctypes.c_int
        fns_lib.append(cdll)
    for m, k in ((8, 1024), (8, 4096), (512, 1024), (512, 4096),
                 (16384, 1024)):
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32)).to(dev, torch.bfloat16)
        want = kernels.quantize_rows_plain(x)
        fns = {}
        for (values, cta), cdll in zip(QUANT_LAYOUTS, fns_lib):
            def run(cdll=cdll):
                q = torch.empty((m, k), dtype=torch.int8, device=dev)
                s = torch.empty((m, 1), device=dev)
                assert cdll.nns_quantize_rows(
                    x.data_ptr(), 1, k, q.data_ptr(), s.data_ptr(), m, k,
                    torch.cuda.current_stream().cuda_stream) == 0
                return q, s
            got = run()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
            fns[f"~{values} values a lane, CTAs of >= {cta} threads"] = run
        names = list(fns)
        times = {n: [] for n in names}
        for order in (names, names[::-1]):          # in turns
            for n in order:
                times[n].append(cs.device_ms_per_call(torch, fns[n], 200))
        for n in names:
            print(f"quantize_rows M{m} K{k} bf16, {n}: "
                  f"{np.mean(times[n]):.5f} ms queued "
                  f"({', '.join(f'{t:.5f}' for t in times[n])}) [{card}]")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sections", nargs="*",
                    choices=["ring", "clamp", "decode", "quantize"],
                    help="sections to run (all by default)")
    sections = set(ap.parse_args(argv).sections or
                   ("ring", "clamp", "decode", "quantize"))
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from nnstreamer_tpu_torch.backends import cuda_build, kernels

    card = cs.sh("nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader").splitlines()[0]
    print(f"card: {card}")
    if "decode" in sections:
        decode_plans(torch, cs, card)
    if "quantize" in sections:
        quantize_layouts(torch, cs, card, build_quantize(cuda_build))
    if not sections & {"ring", "clamp"}:
        return 0
    ring_lib, clamp_lib, sass = build(cuda_build)
    for free in (False, True):
        fns = [f for f in sass.split("Function : ")[1:]
               if f"clamp_variantILb{int(free)}ELi256ELi1E" in f.split()[0]]
        print(f"clamp SASS, {'&/| clip' if free else '&&/|| clip'} (256 "
              f"threads, 1 vector): {fns[0].count(' BRA ')} BRA, "
              f"{fns[0].count('BSSY')} BSSY, {fns[0].count('FSEL')} FSEL")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(11)
    stream = (lambda: torch.cuda.current_stream().cuda_stream)

    if "ring" in sections:
        # -- ring-step layouts ----------------------------------------------
        lib = ctypes.CDLL(str(ring_lib))
        lib.variant_block.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 +
                                      [ctypes.c_int] * 5 +
                                      [ctypes.c_int64] * 9 +
                                      [ctypes.c_float] + [ctypes.c_int] * 3 +
                                      [ctypes.c_void_p])
        lib.variant_block.restype = ctypes.c_int
        for b in (1, 8):
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (b, 512, 8, 128)).astype(np.float32)).to(dev, torch.bfloat16)
                .transpose(1, 2) for _ in range(3))
            bh, st = 8 * b, [512 * 8 * 128 if b > 1 else 0, 8 * 128, 128]
            start = kernels.flash_carry_init(bh, 512, 128, device=dev)
            kernels.flash_block_update_plain(q.float(), k.float(), v.float(),
                                             *start, q_offset=0, k_offset=0,
                                             causal=False)

            def step(i, carry, q_off, k_off):
                err = lib.variant_block(
                    i, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    *(t.data_ptr() for t in carry), bh, 8, 512, 512, 128, *st,
                    *st, *st, 128 ** -0.5, 1, q_off, k_off, stream())
                assert err == 0, err

            ref = [t.clone() for t in start]
            kernels.flash_block_update_plain(q, k, v, *ref, q_offset=1024,
                                             k_offset=0, causal=True)
            for i, layout in enumerate(RING_LAYOUTS):
                got = [t.clone() for t in start]
                step(i, got, 1024, 0)
                ratio = cs.close_rule(torch, kernels.flash_carry_finalize(
                    got[1], got[2]),
                    kernels.flash_carry_finalize(ref[1], ref[2]),
                    True)[0]
                below = cs.device_ms_per_call(
                    torch, lambda: step(i, got, 1024, 0), 50)
                diag = cs.device_ms_per_call(
                    torch, lambda: step(i, got, 512, 512), 50)
                print(f"ring step BH {bh}, (query warps, key warps, "
                      f"keys a tile) "
                      f"{layout}: |diff| / limit {ratio:.3f}; below the "
                      f"diagonal {below:.5f} ms, on it {diag:.5f} ms [{card}]")
                assert ratio <= 1.0
        q, k, v = (torch.from_numpy(rng.standard_normal((8, 512, 128)).astype(
            np.float32)).to(dev, torch.bfloat16) for _ in range(3))
        carry = kernels.flash_carry_init(8, 512, 128, device=dev)
        counts = (kernels.flash_block_update.launches,
                  kernels.flash_block_update.launches_tc)
        for sk in (64, 128, 256, 512):
            ms = cs.device_ms_per_call(
                torch, lambda: kernels.flash_block_update(
                q, k[:, :sk], v[:, :sk], *carry, q_offset=0, k_offset=0,
                causal=False), 50)
            print(f"ring step BH 8, shipped layout, non-causal Sk {sk}: "
                  f"{ms:.5f} ms [{card}]")
        ms = cs.device_ms_per_call(torch, lambda: kernels.flash_block_update(
            q, k, v, *carry, q_offset=0, k_offset=1024, causal=True), 50)
        print(f"ring step BH 8, a block above the diagonal (launch and "
              f"return): "
              f"{ms:.5f} ms [{card}]")
        (kernels.flash_block_update.launches,
         kernels.flash_block_update.launches_tc) = counts
        qf, kf, vf = (t.view(1, 8, 512, 128).transpose(1, 2)
                      for t in (q, k, v))
        launches = kernels.flash_attention.launches
        ms = cs.device_ms_per_call(torch, lambda: kernels.flash_attention(
            qf, kf, vf, causal=False), 50)
        kernels.flash_attention.launches = launches
        print(f"flash_attention (1, 512, 8, 128) bf16 non-causal, the same "
              f"products: {ms:.5f} ms [{card}]")

    if "clamp" in sections:
        # -- clamp variants -------------------------------------------------
        lib = ctypes.CDLL(str(clamp_lib))
        lib.variant_clamp.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_uint32,
                                      ctypes.c_float, ctypes.c_float,
                                      ctypes.c_void_p]
        lib.variant_clamp.restype = ctypes.c_int
        frame = torch.from_numpy(rng.uniform(
            -1.2, 1.2, (1, 257, 257, 3)).astype(
            np.float32)).to(dev)
        big = torch.from_numpy(rng.standard_normal(1 << 24).astype(
            np.float32)).to(dev)
        launches = kernels.clamp_scale.launches
        for key, x in (("P's frame", frame), ("16M", big)):
            def variant(i):
                def run():
                    y = torch.empty_like(x)
                    assert lib.variant_clamp(i, x.data_ptr(), y.data_ptr(),
                                             x.numel(), -1.0, 1.0,
                                             stream()) == 0
                    return y
                return run
            want = kernels.clamp_scale_plain(x, -1.0, 1.0)
            fns = {"torch.clamp": lambda: torch.clamp(x, -1.0, 1.0),
                   "shipped clamp_scale": lambda: kernels.clamp_scale(x, -1.0,
                                                                      1.0)}
            for i, (free, t, u, wave) in enumerate(CLAMP_VARIANTS):
                assert torch.equal(variant(i)(), want)
                fns[f"{'&/|' if free else '&&/||'} clip, {t} threads, {u} "
                    f"vector(s) a thread, {'one wave' if wave else 'full'} "
                    f"grid"] = variant(i)
            names = list(fns)
            times = {n: [] for n in names}
            for order in (names, names[::-1]):          # in turns
                for n in order:
                    times[n].append(cs.device_ms_per_call(torch, fns[n], 200))
            for n in names:
                prof = cs.profiled_ms_per_launch(
                    torch, fns[n], "clamp", 200)[0]
                print(f"clamp {key}, {n}: {np.mean(times[n]):.5f} ms queued "
                      f"({', '.join(f'{t:.5f}' for t in times[n])}), "
                      f"{prof:.5f} ms by the profiler [{card}]")
        kernels.clamp_scale.launches = launches
    return 0


if __name__ == "__main__":
    sys.exit(main())

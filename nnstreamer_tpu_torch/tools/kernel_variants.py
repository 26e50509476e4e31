#!/usr/bin/env python3
"""Time design variants of the hand-written kernels, and of their launch
path, on the card.

    python3 nnstreamer_tpu_torch/tools/kernel_variants.py [SECTION ...]

Needs one CUDA card and nvcc, and runs from a checkout (it uses
chip_smoke.py's timers). SECTIONs (all by default): ring, clamp, decode,
quantize, normalize, launch. It builds, into build/kernel_variants/:

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

- a copy of backends/csrc/normalize.cu with one more entry point, which
  launches uint8 -> f32 normalize in a variant chosen by index: the
  grid-stride kernel the repository shipped before its one-wave redesign
  (the reference copy below), the shipped one-wave kernel in other
  layouts (slots a thread, threads a CTA), the first one-wave layout (16
  contiguous elements a thread), and a TMA-bulk kernel (a CTA's input into shared memory by cp.async.bulk and
  an mbarrier, its output back by a bulk store); each checked bit for bit
  against the plain version and timed in turns at the pipeline's frame
  (1x224x224x3) and at 16M elements, beside the launch floor.

It also launches the shipped paged decode kernel under other split plans
(CTAs aimed at per SM, so blocks per split), each held to the plain
version and timed at the serving shape and at one row at pos 1567, in
turns.

The launch section times the launch path itself: a reference copy of the
per-call path the wrappers took before `cuda_build.Launcher` (build the
signature table and take the loader's lock, build a Stream object, enter
a device context, then the ctypes call; `pr8_*` and `PR8Launch` below)
against the shipped wrappers, in turns in one process, for every kernel
at a main-path shape — normalize_u8 (the frame), clamp_scale (P's
frame), quantize_rows (M 8 x K 1024 bf16), paged decode (the serving
shape), paged prefill (S_c 512), flash (8 x 2048 x 8 x 128 bf16 causal)
and the ring step (BH 8): host time per call and CUDA-event time per
call, back to back. `launch_breakdown` times each step of both
normalize paths with perf_counter_ns (chip_smoke.py phase 6 prints it).

PERF.md cites the numbers it prints.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
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
#: normalize variants, u8 -> f32: (label, the entry point's case). Case 0
#: is the grid-stride kernel shipped before the one-wave redesign, 1-5 the
#: shipped kernel's template in other layouts (slots of 4 elements, one
#: 16-byte store each; case 1 is the shipped layout), 6 the first one-wave
#: layout (one 16-byte vector of 16 elements a thread, stored as four
#: 16-byte stores 64 bytes apart), 7 one slot a thread in CTAs of 128
#: with write-back stores where the kernel ships streaming (evict-first)
#: ones, 8-9 the TMA-bulk kernel
NORM_VARIANTS = [
    ("grid-stride, 256 threads, grid capped at 4096 (before)", 0),
    ("one wave, 1 slot a thread, CTAs of 256 (shipped)", 1),
    ("one wave, 1 slot a thread, CTAs of 128", 2),
    ("one wave, 1 slot a thread, CTAs of 64", 3),
    ("one wave, 4 slots a thread, CTAs of 128", 4),
    ("one wave, 8 slots a thread, CTAs of 128", 5),
    ("one wave, 16 contiguous elements a thread, CTAs of 128", 6),
    ("one wave, 1 slot a thread, CTAs of 128, write-back stores", 7),
    ("TMA bulk copy in and out, CTAs of 128", 8),
    ("TMA bulk copy in and out, CTAs of 256", 9)]
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


NORM_ENTRY = r'''
// -- the grid-stride kernel shipped before the one-wave redesign ---------
struct alignas(16) U8x16 { uint8_t v[16]; };
struct alignas(16) F32x16 { float v[16]; };

__global__ void old_normalize(const uint8_t* __restrict__ x,
                              float* __restrict__ y, int64_t n, float mean,
                              float inv_std, bool vectorized) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t scalar_from = 0;
  if (vectorized) {
    const int64_t nvec = n / 16;
    const U8x16* xv = reinterpret_cast<const U8x16*>(x);
    F32x16* yv = reinterpret_cast<F32x16*>(y);
    for (int64_t i = tid; i < nvec; i += stride) {
      const U8x16 in = xv[i];
      F32x16 out;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        out.v[k] = (static_cast<float>(in.v[k]) - mean) * inv_std;
      yv[i] = out;
    }
    scalar_from = nvec * 16;
  }
  for (int64_t i = scalar_from + tid; i < n; i += stride)
    y[i] = (static_cast<float>(x[i]) - mean) * inv_std;
}

// -- the first one-wave layout: 16 contiguous elements a thread ----------
template <int T>
__global__ void __launch_bounds__(T) contig_normalize(
    const uint8_t* __restrict__ x, float* __restrict__ y, uint32_t ngroups,
    uint32_t tail, float mean, float inv_std) {
  const uint32_t g = blockIdx.x * T + threadIdx.x;
  if (g < ngroups) {
    const uint4 in = reinterpret_cast<const uint4*>(x)[g];
    const uint8_t* v = reinterpret_cast<const uint8_t*>(&in);
    float r[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      r[k] = (static_cast<float>(v[k]) - mean) * inv_std;
    uint4* yv = reinterpret_cast<uint4*>(y) + size_t(g) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      yv[j] = make_uint4(__float_as_uint(r[4 * j]),
                         __float_as_uint(r[4 * j + 1]),
                         __float_as_uint(r[4 * j + 2]),
                         __float_as_uint(r[4 * j + 3]));
  }
  if (tail && blockIdx.x == gridDim.x - 1 && threadIdx.x < tail) {
    const size_t i = size_t(ngroups) * 16 + threadIdx.x;
    y[i] = (static_cast<float>(x[i]) - mean) * inv_std;
  }
}

// -- one slot a thread, CTAs of 128, write-back stores (the kernel ships
// streaming ones) -----------------------------------------------------------
__global__ void __launch_bounds__(128) wb_normalize(
    const uint32_t* __restrict__ x, float4* __restrict__ y, uint32_t nslots,
    uint32_t tail, float mean, float inv_std) {
  const uint32_t i = blockIdx.x * 128 + threadIdx.x;
  if (i < nslots) {
    const uint32_t w = x[i];
    float4 r;
    r.x = (static_cast<float>(w & 0xff) - mean) * inv_std;
    r.y = (static_cast<float>((w >> 8) & 0xff) - mean) * inv_std;
    r.z = (static_cast<float>((w >> 16) & 0xff) - mean) * inv_std;
    r.w = (static_cast<float>(w >> 24) - mean) * inv_std;
    y[i] = r;
  }
  if (tail && blockIdx.x == gridDim.x - 1 && threadIdx.x < tail) {
    const size_t j = size_t(nslots) * 4 + threadIdx.x;
    reinterpret_cast<float*>(y)[j] =
        (static_cast<float>(reinterpret_cast<const uint8_t*>(x)[j]) - mean)
        * inv_std;
  }
}

// -- TMA bulk: a CTA's input into shared memory, its output back --------
template <int T>
__global__ void __launch_bounds__(T) bulk_normalize(
    const uint8_t* __restrict__ x, float* __restrict__ y, uint32_t ngroups,
    uint32_t tail, float mean, float inv_std) {
  constexpr int E = 16;
  __shared__ alignas(128) uint8_t s_in[T * E];
  __shared__ alignas(128) float s_out[T * E];
  __shared__ alignas(8) unsigned long long bar;
  const uint32_t g0 = blockIdx.x * T;
  const uint32_t groups = ngroups > g0 ? min(uint32_t(T), ngroups - g0) : 0;
  const uint32_t bytes = groups * E;
  const uint32_t bar_a = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  if (threadIdx.x == 0 && bytes) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar_a));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar_a), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(s_in))),
           "l"(reinterpret_cast<uint64_t>(x + size_t(g0) * E)), "r"(bytes),
           "r"(bar_a) : "memory");
  }
  __syncthreads();
  if (bytes) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
          "[%1], 0; selp.u32 %0, 1, 0, p; }"
          : "=r"(done) : "r"(bar_a) : "memory");
    }
    // output float4 j*T + tid: 4-byte reads and 16-byte writes, no bank
    // conflicts
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      const uint32_t o = j * T + threadIdx.x;
      if (o < groups * 4) {
        const uint32_t w = reinterpret_cast<const uint32_t*>(s_in)[o];
        float4 r;
        r.x = (static_cast<float>(w & 0xff) - mean) * inv_std;
        r.y = (static_cast<float>((w >> 8) & 0xff) - mean) * inv_std;
        r.z = (static_cast<float>((w >> 16) & 0xff) - mean) * inv_std;
        r.w = (static_cast<float>(w >> 24) - mean) * inv_std;
        reinterpret_cast<float4*>(s_out)[o] = r;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
          :: "l"(reinterpret_cast<uint64_t>(y + size_t(g0) * E)),
             "r"(static_cast<uint32_t>(__cvta_generic_to_shared(s_out))),
             "r"(bytes * 4) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
  if (tail && blockIdx.x == gridDim.x - 1 && threadIdx.x < tail) {
    const size_t i = size_t(ngroups) * E + threadIdx.x;
    y[i] = (static_cast<float>(x[i]) - mean) * inv_std;
  }
}

template <int T, bool BULK>
int run_groups(const void* x, void* y, int64_t n, float mean, float inv,
               cudaStream_t s) {
  const int64_t groups = n / 16;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16
      || groups > int64_t(UINT32_MAX)) return cudaErrorInvalidValue;
  int64_t grid = (groups + T - 1) / T;
  if (grid < 1) grid = 1;
  auto kernel = BULK ? bulk_normalize<T> : contig_normalize<T>;
  kernel<<<unsigned(grid), T, 0, s>>>(
      static_cast<const uint8_t*>(x), static_cast<float*>(y),
      uint32_t(groups), uint32_t(n - groups * 16), mean, inv);
  return cudaGetLastError();
}

extern "C" int variant_normalize(int v, const void* x, void* y, int64_t n,
                                 float mean, float inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0: {
      const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
      int64_t blocks = ((vec ? (n + 15) / 16 : n) + 255) / 256;
      if (blocks > 4096) blocks = 4096;
      old_normalize<<<int(blocks), 256, 0, s>>>(
          static_cast<const uint8_t*>(x), static_cast<float*>(y), n, mean,
          inv, vec);
      return cudaGetLastError();
    }
    case 1: return launch<uint8_t, float, 1, 256>(x, y, n, mean, inv, s);
    case 2: return launch<uint8_t, float, 1, 128>(x, y, n, mean, inv, s);
    case 3: return launch<uint8_t, float, 1, 64>(x, y, n, mean, inv, s);
    case 4: return launch<uint8_t, float, 4, 128>(x, y, n, mean, inv, s);
    case 5: return launch<uint8_t, float, 8, 128>(x, y, n, mean, inv, s);
    case 6: return run_groups<128, false>(x, y, n, mean, inv, s);
    case 7: {
      const int64_t slots = n / 4;
      if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y))
          % 16 || slots > int64_t(UINT32_MAX)) return cudaErrorInvalidValue;
      int64_t grid = (slots + 127) / 128;
      if (grid < 1) grid = 1;
      wb_normalize<<<unsigned(grid), 128, 0, s>>>(
          static_cast<const uint32_t*>(x), static_cast<float4*>(y),
          uint32_t(slots), uint32_t(n - slots * 4), mean, inv);
      return cudaGetLastError();
    }
    case 8: return run_groups<128, true>(x, y, n, mean, inv, s);
    case 9: return run_groups<256, true>(x, y, n, mean, inv, s);
    default: return cudaErrorInvalidValue;
  }
}
'''


def compile_source(cuda_build, name: str, text: str) -> Path:
    """Write `text` to build/kernel_variants/<name>.cu and compile it with
    the kernels' flags → the library."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                           "-o", str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {name}: {proc.stderr[-3000:]}")
    return lib


def normalize_variants(torch, cs, card, lib_path) -> None:
    """Each NORM_VARIANTS entry, u8 -> f32, bit for bit against the plain
    version (aligned, and at n not a multiple of 16), then timed in turns
    at the frame and at 16M beside the launch floor."""
    from nnstreamer_tpu_torch.backends import kernels

    lib = ctypes.CDLL(str(lib_path))
    lib.variant_normalize.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_float, ctypes.c_float,
                                      ctypes.c_void_p]
    lib.variant_normalize.restype = ctypes.c_int
    dev = torch.device("cuda", 0)  # nnlint: disable=NNL009 a one-card measurement tool: it times the kernels on the card it was given
    rng = np.random.default_rng(14)
    floor = cs.device_ms_per_call(torch, lambda: torch.cuda._sleep(0), 200)
    print(f"normalize: launch floor {floor:.5f} ms [{card}]")
    for key, n in (("frame (1,224,224,3)", 224 * 224 * 3),
                   ("16M", 1 << 24), ("odd 16M + 1001", (1 << 24) + 1001)):
        x = torch.from_numpy(rng.integers(0, 256, n, np.uint8)).to(dev)
        want = kernels.normalize_u8_plain(x)
        bound = (n + 4 * n) / cs.HBM_BYTES_PER_S * 1e3

        def variant(case):
            def run():
                y = torch.empty(n, device=dev)
                err = lib.variant_normalize(
                    case, x.data_ptr(), y.data_ptr(), n, 127.5, 1 / 127.5,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return y
            return run

        fns = {}
        for label, case in NORM_VARIANTS:
            got = variant(case)()
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), label
            fns[label] = variant(case)
        if key.startswith("odd"):
            print(f"normalize {key}: every variant bit for bit [{card}]")
            continue
        names = list(fns)
        times = {n_: [] for n_ in names}
        for order in (names, names[::-1]):          # in turns
            for n_ in order:
                times[n_].append(cs.device_ms_per_call(torch, fns[n_], 200))
        for n_ in names:
            ms = float(np.mean(times[n_]))
            print(f"normalize {key} u8->f32, {n_}: {ms:.5f} ms queued "
                  f"({', '.join(f'{t:.5f}' for t in times[n_])}); "
                  f"{bound / ms:.3f} of the bytes bound {bound:.6f} ms, "
                  f"{ms / floor:.3f} x the launch floor [{card}]")


# -- the launch path before cuda_build.Launcher (reference copy) ------------

_PR8_NORM_SIG = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                 ctypes.c_float, ctypes.c_void_p]
_PR8_PAGED_SIGNATURES = {
    "nns_paged_decode": ([ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p] + [
        ctypes.c_int] * 9 + [ctypes.c_int64] * 3 + [ctypes.c_float,
                                                    ctypes.c_void_p],
        ctypes.c_int),
    "nns_paged_prefill": ([ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 3 + [
        ctypes.c_float, ctypes.c_void_p], ctypes.c_int)}


def _pr8_check(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.nns_error_string(err).decode()})")


def pr8_normalize(torch, x, mean=127.5, std=127.5, out_dtype=None):
    """normalize_u8 as the wrappers launched it before the Launcher."""
    from nnstreamer_tpu_torch.backends import kernels

    out_dtype = out_dtype or torch.float32
    if not kernels._dispatch("normalize_u8", x):
        return kernels.normalize_u8_plain(x, mean, std, out_dtype)
    from nnstreamer_tpu_torch.backends import cuda_build

    if x.dtype not in kernels._NORM_IN or out_dtype not in kernels._NORM_OUT:
        raise RuntimeError(f"normalize_u8: {x.dtype} -> {out_dtype}")
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    lib = cuda_build.load("normalize.cu", {"nns_normalize": (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int)})
    with torch.cuda.device(x.device):
        err = lib.nns_normalize(
            x.data_ptr(), kernels._NORM_IN[x.dtype], y.data_ptr(),
            kernels._NORM_OUT[out_dtype], x.numel(), float(mean),
            1.0 / float(std), torch.cuda.current_stream(x.device).cuda_stream)
    _pr8_check(lib, err, "normalize_u8")
    kernels.normalize_u8.launches += 1
    return y


def pr8_clamp_scale(torch, x, lo, hi, scale=1.0, offset=0.0):
    """clamp_scale as launched before the Launcher: the bounds rounded
    anew and two ctypes array types made on every call."""
    from nnstreamer_tpu_torch.backends import cuda_build, kernels

    a = kernels._ClampArgs(x.dtype, lo, hi, scale, offset)
    assert kernels._dispatch("clamp_scale", x)
    contiguous = x.is_contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ndim = x.dim()
    sizes = (ctypes.c_int64 * max(1, ndim))(*x.shape)
    strides = (ctypes.c_int64 * max(1, ndim))(*x.stride())
    lib = cuda_build.load("clamp_scale.cu", {"nns_clamp_scale": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_double] * 4
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
           ctypes.c_void_p], ctypes.c_int)})
    with torch.cuda.device(x.device):
        err = lib.nns_clamp_scale(
            x.data_ptr(), y.data_ptr(), a.code, x.numel(), ndim,
            ctypes.addressof(sizes), ctypes.addressof(strides),
            int(contiguous), a.lo, a.hi, a.scale, a.offset,
            int(a.fold_add), a.ilo, a.ihi,
            torch.cuda.current_stream(x.device).cuda_stream)
    _pr8_check(lib, err, "clamp_scale")
    kernels.clamp_scale.launches += 1
    return y


def pr8_quantize_rows(torch, x):
    """quantize_rows as launched before the Launcher."""
    from nnstreamer_tpu_torch.backends import kernels

    assert kernels._dispatch("quantize_rows", x)
    from nnstreamer_tpu_torch.backends import cuda_build

    m, k = x.shape
    if x.stride(1) != 1 or (m > 1 and x.stride(0) < k):
        x = x.contiguous()
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    lib = cuda_build.load("quantize_rows.cu", {
        "nns_quantize_rows": (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int),
        "nns_quantize_rows_layout": (
            [ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)],
            ctypes.c_int)})
    with torch.cuda.device(x.device):
        err = lib.nns_quantize_rows(
            x.data_ptr(), kernels._FLOAT_CODE[x.dtype],
            x.stride(0) if m > 1 else k, q.data_ptr(), scale.data_ptr(), m,
            k, torch.cuda.current_stream(x.device).cuda_stream)
    _pr8_check(lib, err, "quantize_rows")
    kernels.quantize_rows.launches += 1
    return q, scale


def pr8_paged_decode(torch, q, k_pool_l, v_pool_l, tables, pos):
    """paged_decode_attn as launched before the Launcher."""
    from nnstreamer_tpu_torch.backends import cuda_build
    from nnstreamer_tpu_torch.backends import paged_attn as pa

    assert q.is_cuda
    b, n_heads, hd = q.shape
    pa._check_pools("paged_decode_attn", q, k_pool_l, v_pool_l, n_heads)
    tables = pa._int32_on("paged_decode_attn", tables, q.device, 2)
    pos = pa._int32_on("paged_decode_attn", pos, q.device, 1)
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    out = torch.empty((b, n_heads, hd), dtype=torch.float32, device=q.device)
    _, bs, n_kv, _ = k_pool_l.shape
    sb, ss, sh, _ = k_pool_l.stride()
    mb = tables.shape[1]
    plan = pa._decode_plan_on(q.device.index, b, n_heads, n_kv, hd, bs, mb)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    floats = b * n_kv * plan.splits * plan.part_floats
    ws, tk = pa._decode_workspace(q.device, stream, floats, b * n_kv)
    lib = cuda_build.load("paged_attn.cu", _PR8_PAGED_SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.nns_paged_decode(
            q.data_ptr(), pa._Q_CODE[q.dtype], k_pool_l.data_ptr(),
            v_pool_l.data_ptr(), tables.data_ptr(), pos.data_ptr(),
            out.data_ptr(), ws.data_ptr(), ws.numel(), tk.data_ptr(),
            tk.numel(), b, n_heads, n_kv, hd, bs, mb, plan.splits, plan.bps,
            sb, ss, sh, hd ** -0.5, stream)
    _pr8_check(lib, err, "paged_decode_attn")
    pa.paged_decode_attn.launches += 1
    return out


class PR8Launch:
    """A Launcher's call made the way wrappers launched before it: import
    the builder, build the signature table and take the loader's lock,
    build a Stream object, enter a device context, call, check. Swapped
    in for the shipped Launcher of flash, the ring step and paged
    prefill, whose wrappers changed in nothing else."""

    def __init__(self, torch, launcher):
        self.torch, self.launcher = torch, launcher

    def __call__(self, index, *args, stream=None):
        from nnstreamer_tpu_torch.backends import cuda_build

        torch, l = self.torch, self.launcher
        lib = cuda_build.load(l.source, {l.symbol: (list(l.argtypes),
                                                    ctypes.c_int)})
        dev = torch.device("cuda", index)
        if stream is None:
            stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = getattr(lib, l.symbol)(*args, stream)
        _pr8_check(lib, err, l.what)


@contextmanager
def pr8_launchers(torch):
    """The wrappers of flash, the ring step and paged prefill on
    PR8Launch while the block runs."""
    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.backends import paged_attn as pa

    saved = (dict(kernels._FLASH_KERNELS), dict(kernels._FLASH_BLOCK_KERNELS),
             pa._PREFILL)
    for table in (kernels._FLASH_KERNELS, kernels._FLASH_BLOCK_KERNELS):
        for k, v in table.items():
            table[k] = PR8Launch(torch, v)
    pa._PREFILL = PR8Launch(torch, pa._PREFILL)
    try:
        yield
    finally:
        kernels._FLASH_KERNELS.update(saved[0])
        kernels._FLASH_BLOCK_KERNELS.update(saved[1])
        pa._PREFILL = saved[2]


def launch_breakdown(torch, x, iters: int = 10000) -> dict:
    """Each step of normalize_u8's launch, u8 -> f32 on `x`, timed with
    perf_counter_ns over `iters` calls, both paths: the one before the
    Launcher (PR8_*) and the shipped one → {path: {step: µs per call}},
    with "timer" the cost of one empty step (two clock reads) and "sum"
    the steps' total; under "calls", what the ctypes call is made of: the
    same call with n 0 (the launcher returns before launching), both
    with the GIL released (ctypes.CDLL, the shipped binding) and kept
    (ctypes.PyDLL), and torch's own launch of an empty kernel from Python
    (torch.cuda._sleep(0))."""
    from nnstreamer_tpu_torch.backends import cuda_build, kernels

    clock = time.perf_counter_ns
    f32 = torch.float32
    pr8 = {n: 0 for n in ("_dispatch", "contiguous", "torch.empty", "load",
                          "current_stream", "device context",
                          "arguments", "ctypes call", "check")}
    new = {n: 0 for n in ("out-dtype check and _dispatch", "dtype code",
                          "contiguous", "torch.empty", "arguments",
                          "thread device (C)", "raw stream (C)",
                          "ctypes call", "return test")}
    launcher = kernels._NORMALIZE
    fn = launcher.function()
    thread_device, raw = cuda_build._thread_device, cuda_build._raw_stream
    lib = cuda_build.load("normalize.cu", {})
    timer = 0
    for _ in range(iters):
        t0 = clock()
        t1 = clock()
        timer += t1 - t0
    launches = kernels.normalize_u8.launches
    for _ in range(iters):
        t0 = clock()
        kernels._dispatch("normalize_u8", x)
        t1 = clock()
        xc = x.contiguous()
        t2 = clock()
        y = torch.empty(xc.shape, dtype=f32, device=xc.device)
        t3 = clock()
        lib = cuda_build.load("normalize.cu", {"nns_normalize": (
            list(_PR8_NORM_SIG), ctypes.c_int)})
        t4 = clock()
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        t5 = clock()
        ctx = torch.cuda.device(xc.device)
        ctx.__enter__()
        t6 = clock()
        args = (xc.data_ptr(), kernels._NORM_IN[xc.dtype], y.data_ptr(),
                kernels._NORM_OUT[f32], xc.numel(), float(127.5),
                1.0 / float(127.5), stream)
        t7 = clock()
        err = lib.nns_normalize(*args)
        t8 = clock()
        ctx.__exit__(None, None, None)
        t9 = clock()
        _pr8_check(lib, err, "normalize_u8")
        t10 = clock()
        for name, dt in zip(pr8, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                  t5 - t4, t6 - t5 + t9 - t8, t7 - t6,
                                  t8 - t7, t10 - t9)):
            pr8[name] += dt
    torch.cuda.synchronize()  # nnlint: disable=NNL002 timing: the tool waits for the card between its measured runs
    for _ in range(iters):
        t0 = clock()
        if f32 not in kernels._NORM_OUT:
            raise RuntimeError
        kernels._dispatch("normalize_u8", x)
        t1 = clock()
        code = kernels._NORM_IN.get(x.dtype)
        t2 = clock()
        xc = x.contiguous()
        t3 = clock()
        y = torch.empty(xc.shape, dtype=f32, device=xc.device)
        t4 = clock()
        index = xc.device.index
        args = (xc.data_ptr(), code, y.data_ptr(), kernels._NORM_OUT[f32],
                xc.numel(), 127.5, 1.0 / 127.5)
        t5 = clock()
        same = thread_device() == index
        t6 = clock()
        stream = raw(index)
        t7 = clock()
        err = fn(*args, stream)
        t8 = clock()
        if err or not same:
            raise RuntimeError(f"normalize_u8: {err}")
        t9 = clock()
        for name, dt in zip(new, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                  t5 - t4, t6 - t5, t7 - t6, t8 - t7,
                                  t9 - t8)):
            new[name] += dt
    torch.cuda.synchronize()  # nnlint: disable=NNL002 timing: the tool waits for the card between its measured runs
    kernels.normalize_u8.launches = launches
    out = {}
    for path, steps in (("before", pr8), ("shipped", new)):
        us = {k: v / iters / 1e3 for k, v in steps.items()}
        us["sum"] = sum(us.values())
        us["timer"] = timer / iters / 1e3
        out[path] = us
    kept = getattr(ctypes.PyDLL(lib._name), "nns_normalize")
    kept.argtypes, kept.restype = fn.argtypes, fn.restype
    xc = x.contiguous()
    y = torch.empty(xc.shape, dtype=f32, device=xc.device)
    stream = raw(xc.device.index)
    calls = {
        "ctypes call, n 0": lambda: fn(xc.data_ptr(), 0, y.data_ptr(), 0, 0,
                                       127.5, 1 / 127.5, stream),
        "ctypes call, GIL kept, n 0": lambda: kept(
            xc.data_ptr(), 0, y.data_ptr(), 0, 0, 127.5, 1 / 127.5, stream),
        "ctypes call": lambda: fn(xc.data_ptr(), 0, y.data_ptr(), 0,
                                  xc.numel(), 127.5, 1 / 127.5, stream),
        "ctypes call, GIL kept": lambda: kept(
            xc.data_ptr(), 0, y.data_ptr(), 0, xc.numel(), 127.5, 1 / 127.5,
            stream),
        "torch.cuda._sleep(0)": lambda: torch.cuda._sleep(0)}
    out["calls"] = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()  # nnlint: disable=NNL002 timing: the tool waits for the card between its measured runs
        t0 = clock()
        for _ in range(iters):
            call()
        out["calls"][name] = (clock() - t0) / iters / 1e3
        torch.cuda.synchronize()  # nnlint: disable=NNL002 timing: the tool waits for the card between its measured runs
    return out


def launch_paths(torch, cs, card) -> dict:
    """Each kernel at a main-path shape through the path before the
    Launcher and through the shipped wrapper, in turns (before, shipped,
    shipped, before): host ms per call and CUDA-event ms per call, back to
    back. normalize, clamp_scale, quantize_rows and paged decode take the
    reference copies above; flash, the ring step and paged prefill their
    shipped wrappers with PR8Launch swapped in."""
    from nnstreamer_tpu_torch.backends import kernels
    from nnstreamer_tpu_torch.backends import paged_attn as pa

    dev = torch.device("cuda", 0)  # nnlint: disable=NNL009 a one-card measurement tool: it times the kernels on the card it was given
    rng = np.random.default_rng(15)
    frame = torch.from_numpy(rng.integers(0, 256, (1, 224, 224, 3),
                                          np.uint8)).to(dev)
    p_frame = torch.from_numpy(rng.uniform(-1.2, 1.2, (1, 257, 257, 3))
                               .astype(np.float32)).to(dev)
    rows = torch.from_numpy(rng.standard_normal((8, 1024)).astype(
        np.float32)).to(dev, torch.bfloat16)
    nb, bs, n_kv, hd, mb = 1025, 16, 8, 128, 128
    pools = [torch.from_numpy(rng.standard_normal(
        (nb, bs, n_kv, hd)).astype(np.float32)).to(dev) for _ in range(2)]
    perm = rng.permutation(np.arange(1, nb))
    lens = [len(p) + cs.LLM_NEW_TOKENS // 2 for p in cs.llm_requests()]
    tables, pos = cs.decode_rows(rng, perm, lens, bs, mb)
    tab, ps = (torch.from_numpy(a).to(dev) for a in (tables, pos))
    q = torch.from_numpy(rng.standard_normal((8, 8, hd)).astype(
        np.float32)).to(dev, torch.bfloat16)
    q_pre = torch.from_numpy(rng.standard_normal((8, 512, hd)).astype(
        np.float32)).to(dev, torch.bfloat16)
    seq = tab[int(np.argmax(lens))]
    fq, fk, fv = (torch.from_numpy(rng.standard_normal(
        (8, 2048, 8, 128)).astype(np.float32)).to(dev, torch.bfloat16)
        for _ in range(3))
    rq, rk, rv = (torch.from_numpy(rng.standard_normal(
        (1, 512, 8, 128)).astype(np.float32)).to(dev, torch.bfloat16)
        .transpose(1, 2) for _ in range(3))
    carry = kernels.flash_carry_init(8, 512, 128, device=dev)
    swap = (lambda: pr8_launchers(torch))                     # noqa: E731

    def ring():
        return kernels.flash_block_update(rq, rk, rv, *carry, q_offset=1024,
                                          k_offset=0, causal=True)

    cases = {
        "normalize_u8 (1,224,224,3) u8->f32": (
            lambda: pr8_normalize(torch, frame),
            lambda: kernels.normalize_u8(frame), nullcontext),
        "clamp_scale P frame (1,257,257,3) f32": (
            lambda: pr8_clamp_scale(torch, p_frame, -1.0, 1.0),
            lambda: kernels.clamp_scale(p_frame, -1.0, 1.0), nullcontext),
        "quantize_rows M8 K1024 bf16": (
            lambda: pr8_quantize_rows(torch, rows),
            lambda: kernels.quantize_rows(rows), nullcontext),
        "paged_decode_attn serving B8": (
            lambda: pr8_paged_decode(torch, q, *pools, tab, ps),
            lambda: pa.paged_decode_attn(q, *pools, tab, ps), nullcontext),
        "paged_prefill_attn S_c 512 at pos0 1024": (
            lambda: pa.paged_prefill_attn(q_pre, *pools, seq, 1024),
            lambda: pa.paged_prefill_attn(q_pre, *pools, seq, 1024), swap),
        "flash_attention (8,2048,8,128) bf16 causal": (
            lambda: kernels.flash_attention(fq, fk, fv, causal=True),
            lambda: kernels.flash_attention(fq, fk, fv, causal=True), swap),
        "flash_block_update BH 8 (512 x 512 x 128) bf16": (
            ring, ring, swap),
    }
    fa, fb = kernels.flash_attention, kernels.flash_block_update
    counters = [(w, n) for w in (kernels.normalize_u8, kernels.clamp_scale,
                                 kernels.quantize_rows, pa.paged_decode_attn,
                                 pa.paged_prefill_attn)
                for n in ("launches",)] + [
        (w, n) for w in (fa, fb)
        for n in ("launches", "launches_tc", "launches_simt")]
    counts = [getattr(w, n) for w, n in counters]
    out = {}
    for name, (before, shipped, before_ctx) in cases.items():
        if "flash_block_update" not in name:      # the ring step's carry
            with before_ctx():                    # moves with every call
                a = before()
            b = shipped()
            a, b = (a if isinstance(a, tuple) else (a,)), \
                (b if isinstance(b, tuple) else (b,))
            assert all(torch.equal(u, v) for u, v in zip(a, b)), name
        iters = 200 if "flash_attention" in name else 500
        turns = {"before": [], "shipped": []}
        for path in ("before", "shipped", "shipped", "before"):
            fn = before if path == "before" else shipped
            with before_ctx() if path == "before" else nullcontext():
                host = cs.host_ms_per_call(torch, fn, iters)
                event = cs.event_ms_per_call(torch, fn, iters)
            turns[path].append((host, event))
        res = {p: {"host_ms": float(np.mean([t[0] for t in v])),
                   "event_ms": float(np.mean([t[1] for t in v])),
                   "turns": v} for p, v in turns.items()}
        out[name] = res
        print(f"launch {name}: before the Launcher host "
              f"{res['before']['host_ms']:.5f} ms, events "
              f"{res['before']['event_ms']:.5f} ms per call; shipped host "
              f"{res['shipped']['host_ms']:.5f} ms, events "
              f"{res['shipped']['event_ms']:.5f} ms per call (in turns "
              f"before, shipped, shipped, before; {iters} calls each) "
              f"[{card}]")
    for (w, n), c in zip(counters, counts):
        setattr(w, n, c)
    return out


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

    dev = torch.device("cuda", 0)  # nnlint: disable=NNL009 a one-card measurement tool: it times the kernels on the card it was given
    rng = np.random.default_rng(12)
    nb, bs, n_kv, hd, mb = 1025, 16, 8, 128, 128
    pools = [torch.from_numpy(rng.standard_normal(
        (nb, bs, n_kv, hd)).astype(np.float32)).to(dev) for _ in range(2)]
    perm = rng.permutation(np.arange(1, nb))
    lens = [len(p) + cs.LLM_NEW_TOKENS // 2 for p in cs.llm_requests()]
    sms = cs.sm_count(torch, dev)
    decode = pa._DECODE.function()
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
                err = decode(
                    q.data_ptr(), 1, pools[0].data_ptr(), pools[1].data_ptr(),
                    tab.data_ptr(), ps.data_ptr(), out.data_ptr(),
                    ws.data_ptr(), ws.numel(), tk.data_ptr(), tk.numel(),
                    len(depths), 8, n_kv, hd, bs, mb, plan.splits, plan.bps,
                    sb, ss, sh, hd ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return out

            err = (run() - ref).abs().max().item()  # nnlint: disable=NNL002 the tool's check of a variant against the plain version reads one scalar back
            assert err <= cs.PAGED_REL * ref.abs().max().item() + cs.PAGED_ABS  # nnlint: disable=NNL002 the tool's check of a variant against the plain version reads one scalar back
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


def quantize_layouts(torch, cs, card, libs) -> None:
    """Each QUANT_LAYOUTS copy at the main path's shapes, bit for bit and
    timed in turns beside the launch floor."""
    from nnstreamer_tpu_torch.backends import kernels

    dev = torch.device("cuda", 0)  # nnlint: disable=NNL009 a one-card measurement tool: it times the kernels on the card it was given
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
                    choices=["ring", "clamp", "decode", "quantize",
                             "normalize", "launch"],
                    help="sections to run (all by default)")
    sections = set(ap.parse_args(argv).sections or
                   ("ring", "clamp", "decode", "quantize", "normalize",
                    "launch"))
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from nnstreamer_tpu_torch.backends import cuda_build, kernels

    card = cs.sh("nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader").splitlines()[0]
    print(f"card: {card}")
    if "normalize" in sections:
        normalize_variants(torch, cs, card, compile_source(
            cuda_build, "normalize_variants",
            (cuda_build.CSRC / "normalize.cu").read_text() + NORM_ENTRY))
    if "launch" in sections:
        frame = torch.from_numpy(np.random.default_rng(16).integers(
            0, 256, (1, 224, 224, 3), np.uint8)).to("cuda")
        for path, us in launch_breakdown(torch, frame).items():
            print(f"launch normalize_u8 {path}: " + "; ".join(
                f"{k} {v:.3f} us" for k, v in us.items()) + f" [{card}]")
        launch_paths(torch, cs, card)
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
    dev = torch.device("cuda", 0)  # nnlint: disable=NNL009 a one-card measurement tool: it times the kernels on the card it was given
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

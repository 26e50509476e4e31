// normalize_u8 for Hopper (sm_90a): y = (float(x) - mean) * inv_std.
//
// Replaces the TPU kernel `_normalize_kernel` / `normalize_u8` in
// nnstreamer_tpu/backends/pallas_ops.py. Input: any element type a tensor
// stream carries (u8, i8, u16, i16, i32, u32, i64, u64, f16, bf16, f32,
// f64); output f32, bf16, f16 or f64. x becomes f32 as Tensor.to(float32)
// makes it: narrow integers and f16/bf16 exactly, wider integers and f64 by
// one round to nearest even. `mean` and `inv_std` arrive as f32, `inv_std`
// computed on the host as 1.0 / std exactly as the JAX wrapper does, so the
// kernel subtracts, multiplies by the reciprocal and never divides; bf16
// and f16 outputs round to nearest even. The result is the plain torch
// version's, bit for bit.
//
// Bound: bytes. Per element it reads 1-8 bytes and writes 2-8 for two
// flops. At the pipeline's frame (1x224x224x3 u8, 0.75 MB) the whole call
// is one launch and one trip to memory, so the design cuts what a launch
// and that trip cost, and at a large n it keeps every access of a warp on
// whole, contiguous lines:
// - one wave sized to the work, no loop: the tensor is cut into slots of
//   K = 16 / sizeof(out) elements, one 16-byte store each, and a thread
//   takes one slot (u8 -> f32: 4 bytes in, 16 out; 147 CTAs of 256
//   threads at the frame, all resident at once; CTAs of 128 ran the frame
//   ~3% slower, of 64 slower still);
// - slot s of thread t in a CTA is slot s * T + t: each load and each
//   store instruction of a warp covers one contiguous run. A thread that
//   read one 16-byte vector and wrote its 16 elements as four 16-byte
//   stores 64 bytes apart ran the 16M case at 46% of the bytes bound. 4
//   slots a thread (16 bytes read, every load before the first store) tie
//   with one at the frame, 8 run it 8-13% slower (tools/kernel_variants.py);
// - stores are streaming (st.global.cs, evict-first): at 16M u8 -> f32
//   the 67 MB output outgrows the 50 MB L2, and write-back stores held the
//   kernel at 78% of the bytes bound against 83%; at the frame the two
//   are within 2%;
// - 32-bit slot indices (the launcher refuses more than 2^32 slots);
// - the aligned (vector) and unaligned (per element, still warp-
//   contiguous) paths are separate instantiations the launcher picks;
// - only the last CTA touches the tail (< K elements);
// - f32 -> bf16/f16 two values at a time (cvt.rn.bf16x2.f32 / f16x2).
// S and T (slots a thread, threads a CTA) stay template parameters so the
// layouts can be timed against each other (tools/kernel_variants.py); the
// launcher ships S 1, T 256.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x -> f32 as Tensor.to(float32) rounds it
template <typename I>
__device__ __forceinline__ float to_f32(I x) {
  return static_cast<float>(x);  // integers: cvt.rn.f32.{s,u}{8..64}
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<double>(double x) {
  return __double2float_rn(x);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t bits(__half2 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// One output type: how many values fill 16 bytes, and how to pack them.
template <typename O>
struct Out;

template <>
struct Out<float> {
  static constexpr int kPer16 = 4;
  __device__ static uint4 pack(const float* r) {
    return make_uint4(__float_as_uint(r[0]), __float_as_uint(r[1]),
                      __float_as_uint(r[2]), __float_as_uint(r[3]));
  }
  __device__ static float one(float v) { return v; }
};

template <>
struct Out<__nv_bfloat16> {
  static constexpr int kPer16 = 8;
  __device__ static uint4 pack(const float* r) {
    return make_uint4(bits(__floats2bfloat162_rn(r[0], r[1])),
                      bits(__floats2bfloat162_rn(r[2], r[3])),
                      bits(__floats2bfloat162_rn(r[4], r[5])),
                      bits(__floats2bfloat162_rn(r[6], r[7])));
  }
  __device__ static __nv_bfloat16 one(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <>
struct Out<__half> {
  static constexpr int kPer16 = 8;
  __device__ static uint4 pack(const float* r) {
    return make_uint4(bits(__floats2half2_rn(r[0], r[1])),
                      bits(__floats2half2_rn(r[2], r[3])),
                      bits(__floats2half2_rn(r[4], r[5])),
                      bits(__floats2half2_rn(r[6], r[7])));
  }
  __device__ static __half one(float v) { return __float2half_rn(v); }
};

template <>
struct Out<double> {
  static constexpr int kPer16 = 2;
  __device__ static uint4 pack(const float* r) {
    const unsigned long long a = __double_as_longlong(r[0]);
    const unsigned long long b = __double_as_longlong(r[1]);
    return make_uint4(static_cast<uint32_t>(a), static_cast<uint32_t>(a >> 32),
                      static_cast<uint32_t>(b), static_cast<uint32_t>(b >> 32));
  }
  __device__ static double one(float v) { return v; }
};

// K values of T moved as one access: aligned to its size up to 16 bytes,
// so an array of them is dense (a 32-byte slot of f32 is two 16-byte
// loads)
template <typename T, int K>
struct alignas(sizeof(T) * K < 16 ? sizeof(T) * K : 16) Vec {
  T v[K];
};

template <typename I, typename O, bool ALIGNED, int S, int T>
__global__ void __launch_bounds__(T)
    nns_normalize_kernel(const I* __restrict__ x, O* __restrict__ y,
                         uint32_t nslots, uint32_t tail, float mean,
                         float inv_std) {
  constexpr int K = Out<O>::kPer16;    // one slot: one 16-byte store
  const uint32_t first = blockIdx.x * (S * T) + threadIdx.x;
  if (ALIGNED) {
    const Vec<I, K>* __restrict__ xv = reinterpret_cast<const Vec<I, K>*>(x);
    uint4* __restrict__ yv = reinterpret_cast<uint4*>(y);
    Vec<I, K> in[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {      // every load before the first store
      const uint32_t slot = first + s * T;
      if (slot < nslots) in[s] = xv[slot];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint32_t slot = first + s * T;
      if (slot >= nslots) continue;
      float r[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        r[k] = (to_f32(in[s].v[k]) - mean) * inv_std;
      __stcs(yv + slot, Out<O>::pack(r));
    }
  } else {
    // element j * T + t of the CTA's S * T * K: each instruction of a warp
    // still reads and writes one contiguous run
    const size_t base = size_t(blockIdx.x) * (S * T * K) + threadIdx.x;
    const size_t end = size_t(nslots) * K;
#pragma unroll
    for (int j = 0; j < S * K; ++j) {
      const size_t i = base + size_t(j) * T;
      if (i < end) y[i] = Out<O>::one((to_f32(x[i]) - mean) * inv_std);
    }
  }
  if (tail && blockIdx.x == gridDim.x - 1 && threadIdx.x < tail) {
    const size_t i = size_t(nslots) * K + threadIdx.x;
    y[i] = Out<O>::one((to_f32(x[i]) - mean) * inv_std);
  }
}

template <typename I, typename O, int S, int T>
cudaError_t launch(const void* x, void* y, int64_t n, float mean,
                   float inv_std, cudaStream_t stream) {
  constexpr int K = Out<O>::kPer16;
  static_assert(K <= T, "the last CTA's threads take the tail");
  const int64_t slots = n / K;
  if (slots > int64_t(UINT32_MAX)) return cudaErrorInvalidValue;
  const uint32_t nslots = static_cast<uint32_t>(slots);
  const uint32_t tail = static_cast<uint32_t>(n - slots * K);
  int64_t grid = (slots + S * T - 1) / (S * T);
  if (grid < 1) grid = 1;
  const I* xi = static_cast<const I*>(x);
  O* yo = static_cast<O*>(y);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0) {
    nns_normalize_kernel<I, O, true, S, T><<<unsigned(grid), T, 0, stream>>>(
        xi, yo, nslots, tail, mean, inv_std);
  } else {
    nns_normalize_kernel<I, O, false, S, T><<<unsigned(grid), T, 0, stream>>>(
        xi, yo, nslots, tail, mean, inv_std);
  }
  return cudaGetLastError();
}

template <typename I, typename O>
cudaError_t launch_shipped(const void* x, void* y, int64_t n, float mean,
                           float inv_std, cudaStream_t s) {
  return launch<I, O, 1, 256>(x, y, n, mean, inv_std, s);
}

template <typename O>
cudaError_t dispatch_in(int in_code, const void* x, void* y, int64_t n,
                        float mean, float inv_std, cudaStream_t s) {
  switch (in_code) {
    case 0: return launch_shipped<uint8_t, O>(x, y, n, mean, inv_std, s);
    case 1: return launch_shipped<int8_t, O>(x, y, n, mean, inv_std, s);
    case 2: return launch_shipped<uint16_t, O>(x, y, n, mean, inv_std, s);
    case 3: return launch_shipped<int16_t, O>(x, y, n, mean, inv_std, s);
    case 4: return launch_shipped<float, O>(x, y, n, mean, inv_std, s);
    case 5: return launch_shipped<int32_t, O>(x, y, n, mean, inv_std, s);
    case 6: return launch_shipped<uint32_t, O>(x, y, n, mean, inv_std, s);
    case 7: return launch_shipped<long long, O>(x, y, n, mean, inv_std, s);
    case 8:
      return launch_shipped<unsigned long long, O>(x, y, n, mean, inv_std, s);
    case 9: return launch_shipped<__half, O>(x, y, n, mean, inv_std, s);
    case 10:
      return launch_shipped<__nv_bfloat16, O>(x, y, n, mean, inv_std, s);
    case 11: return launch_shipped<double, O>(x, y, n, mean, inv_std, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// in_code: 0 u8, 1 i8, 2 u16, 3 i16, 4 f32, 5 i32, 6 u32, 7 i64, 8 u64,
// 9 f16, 10 bf16, 11 f64. out_code: 0 f32, 1 bf16, 2 f16, 3 f64. x and y
// dense, n elements. Launches on `stream` and returns cudaGetLastError();
// does not synchronise and allocates nothing.
int nns_normalize(const void* x, int in_code, void* y, int out_code,
                  int64_t n, float mean, float inv_std, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_code) {
    case 0: return dispatch_in<float>(in_code, x, y, n, mean, inv_std, s);
    case 1:
      return dispatch_in<__nv_bfloat16>(in_code, x, y, n, mean, inv_std, s);
    case 2: return dispatch_in<__half>(in_code, x, y, n, mean, inv_std, s);
    case 3: return dispatch_in<double>(in_code, x, y, n, mean, inv_std, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* nns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

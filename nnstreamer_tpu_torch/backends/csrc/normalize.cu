// normalize_u8 for Hopper (sm_90a): y = (float(x) - mean) * inv_std.
//
// Replaces the TPU kernel `_normalize_kernel` / `normalize_u8` in
// nnstreamer_tpu/backends/pallas_ops.py. Input u8, i8, u16, i16 or f32;
// output f32 or bf16 (round to nearest even). `mean` and `inv_std` arrive
// as f32, `inv_std` computed on the host as 1.0 / std exactly as the JAX
// wrapper does, so the kernel multiplies by the reciprocal and never
// divides: the f32 result matches the plain torch version bit for bit.
//
// Bound: bytes. Per element it reads 1-4 bytes and writes 2-4 bytes for
// two flops, far below the card's operations-per-byte balance. The design
// therefore only makes the memory traffic dense: each thread moves one
// 16-byte vector of input (16 u8, 8 16-bit or 4 f32 values) and the
// matching output vectors, in a grid-stride loop, when both pointers are
// 16-byte aligned; the last n % VEC elements, and every element of a
// misaligned input, take the scalar path. At the pipeline's frame
// (1x224x224x3 u8) the work is ~0.75 MB, so launch latency, not this
// kernel's bandwidth, sets its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// N values moved as one access; aligned to its size up to 16 bytes, so
// sizeof(Vec) is exactly sizeof(T) * N and indexing strides are dense
// (4 f32 -> bf16 outputs are an 8-byte access).
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Vec {
  T v[N];
};

template <typename O>
__device__ __forceinline__ O from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename I, typename O>
__device__ __forceinline__ O normalize_one(I x, float mean, float inv_std) {
  // narrow ints are exact in f32, as the TPU kernel's int32 widening was
  return from_f32<O>((static_cast<float>(x) - mean) * inv_std);
}

template <typename I, typename O>
__global__ void nns_normalize_kernel(const I* __restrict__ x,
                                     O* __restrict__ y, int64_t n,
                                     float mean, float inv_std,
                                     bool vectorized) {
  constexpr int VEC = 16 / sizeof(I);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t scalar_from = 0;
  if (vectorized) {
    const int64_t nvec = n / VEC;
    const Vec<I, VEC>* xv = reinterpret_cast<const Vec<I, VEC>*>(x);
    Vec<O, VEC>* yv = reinterpret_cast<Vec<O, VEC>*>(y);
    for (int64_t i = tid; i < nvec; i += stride) {
      const Vec<I, VEC> in = xv[i];
      Vec<O, VEC> out;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        out.v[k] = normalize_one<I, O>(in.v[k], mean, inv_std);
      }
      yv[i] = out;
    }
    scalar_from = nvec * VEC;
  }
  for (int64_t i = scalar_from + tid; i < n; i += stride) {
    y[i] = normalize_one<I, O>(x[i], mean, inv_std);
  }
}

template <typename I, typename O>
cudaError_t launch(const void* x, void* y, int64_t n, float mean,
                   float inv_std, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int VEC = 16 / sizeof(I);
  const bool vectorized = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                          (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const int64_t work = vectorized ? (n + VEC - 1) / VEC : n;
  // grid-stride: cap the grid, every thread loops over its share
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  nns_normalize_kernel<I, O><<<static_cast<int>(blocks), kThreads, 0,
                                stream>>>(
      static_cast<const I*>(x), static_cast<O*>(y), n, mean, inv_std,
      vectorized);
  return cudaGetLastError();
}

template <typename O>
cudaError_t dispatch_in(int in_code, const void* x, void* y, int64_t n,
                        float mean, float inv_std, cudaStream_t stream) {
  switch (in_code) {
    case 0: return launch<uint8_t, O>(x, y, n, mean, inv_std, stream);
    case 1: return launch<int8_t, O>(x, y, n, mean, inv_std, stream);
    case 2: return launch<uint16_t, O>(x, y, n, mean, inv_std, stream);
    case 3: return launch<int16_t, O>(x, y, n, mean, inv_std, stream);
    case 4: return launch<float, O>(x, y, n, mean, inv_std, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// in_code: 0 u8, 1 i8, 2 u16, 3 i16, 4 f32. out_code: 0 f32, 1 bf16.
// Launches on `stream` and returns cudaGetLastError(); does not
// synchronise and allocates nothing.
int nns_normalize(const void* x, int in_code, void* y, int out_code,
                  int64_t n, float mean, float inv_std, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_code) {
    case 0: return dispatch_in<float>(in_code, x, y, n, mean, inv_std, s);
    case 1:
      return dispatch_in<__nv_bfloat16>(in_code, x, y, n, mean, inv_std, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* nns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

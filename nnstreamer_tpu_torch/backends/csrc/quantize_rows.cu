// quantize_rows for Hopper (sm_90a): symmetric per-row int8 quantization
// of an (M, K) f32 or bf16 matrix, the activation half of the W8A8
// product.
//
// Replaces the TPU kernel `_quantize_rows_kernel` / `quantize_rows` in
// nnstreamer_tpu/backends/pallas_ops.py. Per row:
//   amax  = max |x|                       (in f32; bf16 widens exactly)
//   scale = amax > 0 ? amax * f32(1/127) : 1
//   q     = clip(rint(x / scale), -127, 127) as int8
// The scale is the TPU kernel's `amax / 127.0` as XLA compiles it: a
// division by a constant becomes a product with its f32 reciprocal.
// It equals the plain torch version bit for bit: x / scale is a true
// IEEE division (nvcc's default -prec-div=true; no reciprocal multiply,
// no __fdividef, no fast-math), rintf rounds half to even (as
// torch.round and jnp.round), and the clip is to +-127, never -128. A
// row whose amax is 0 gets scale 1 and q 0. The TPU kernel's pad to 8 rows is a sublane
// rule of that chip: any M runs here, one CTA per row.
//
// Bound: bytes. A row is read once (K * 2 or 4 bytes) and written once
// (K int8 + one f32 scale) for ~3 operations per element, far below the
// card's operations-per-byte balance. The design makes the traffic
// dense and single-pass:
// - each thread loads 16-byte vectors of its row (4 f32 or 8 bf16),
//   neighbouring threads on neighbouring vectors, when the row is
//   16-byte aligned; a tail of K % VEC elements, and every element of a
//   misaligned row, takes the scalar path;
// - the loaded vectors are kept in shared memory while a warp-shuffle
//   max (then one across the CTA's warps) finds amax, so the second
//   pass reads shared memory, not device memory;
// - the int8 row is written VEC bytes per thread when K % VEC == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr float kInv127 = 1.0f / 127.0f;   // rounded to f32 at compile time
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int8_t quantize_one(float x, float scale) {
  const float r = rintf(x / scale);
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) nns_quantize_rows_kernel(
    const T* __restrict__ x, int64_t ldx, int8_t* __restrict__ q,
    float* __restrict__ scales, int k, bool vec_in, bool vec_out) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* row_s = reinterpret_cast<T*>(smem_raw);                // k values
  __shared__ float warp_max[kMaxThreads / 32];

  const int64_t row = blockIdx.x;
  const T* xr = x + row * ldx;
  int8_t* qr = q + row * static_cast<int64_t>(k);
  const int tid = threadIdx.x;
  const int nvec = vec_in ? k / VEC : 0;

  // pass 1: device memory -> shared memory, |x| max on the way
  float amax = 0.f;
  const Vec<T, VEC>* xv = reinterpret_cast<const Vec<T, VEC>*>(xr);
  Vec<T, VEC>* sv = reinterpret_cast<Vec<T, VEC>*>(row_s);
  for (int i = tid; i < nvec; i += blockDim.x) {
    const Vec<T, VEC> in = xv[i];
    sv[i] = in;
#pragma unroll
    for (int j = 0; j < VEC; ++j) amax = fmaxf(amax, fabsf(to_f32(in.v[j])));
  }
  for (int i = nvec * VEC + tid; i < k; i += blockDim.x) {
    const T v = xr[i];
    row_s[i] = v;
    amax = fmaxf(amax, fabsf(to_f32(v)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (tid % 32 == 0) warp_max[tid / 32] = amax;
  __syncthreads();   // also orders the row's shared-memory writes
  amax = warp_max[0];
  for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w)
    amax = fmaxf(amax, warp_max[w]);
  const float scale = amax > 0.f ? amax * kInv127 : 1.f;
  if (tid == 0) scales[row] = scale;

  // pass 2: shared memory -> int8, same element order as pass 1
  if (vec_out) {
    Vec<int8_t, VEC>* qv = reinterpret_cast<Vec<int8_t, VEC>*>(qr);
    for (int i = tid; i < k / VEC; i += blockDim.x) {
      const Vec<T, VEC> in = sv[i];
      Vec<int8_t, VEC> out;
#pragma unroll
      for (int j = 0; j < VEC; ++j) out.v[j] = quantize_one(to_f32(in.v[j]), scale);
      qv[i] = out;
    }
  } else {
    for (int i = tid; i < k; i += blockDim.x)
      qr[i] = quantize_one(to_f32(row_s[i]), scale);
  }
}

template <typename T>
cudaError_t launch(const void* x, int64_t ldx, void* q, void* scales, int m,
                   int k, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t bytes = static_cast<size_t>(k) * sizeof(T);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        nns_quantize_rows_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const bool vec_in = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      (ldx * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  const bool vec_out = vec_in && k % VEC == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0;
  // one thread per 16-byte vector of the row, a whole number of warps
  int threads = (k + VEC - 1) / VEC;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  nns_quantize_rows_kernel<T><<<m, threads, bytes, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<int8_t*>(q),
      static_cast<float*>(scales), k, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_code: 0 f32, 1 bf16. x (m, k) with row stride ldx elements and a
// contiguous last dim; q (m, k) int8 contiguous; scales (m,) f32.
// k * itemsize <= 227 KB (the row is staged in shared memory). Launches
// on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for
// arguments outside the contract); does not synchronise and allocates
// nothing.
int nns_quantize_rows(const void* x, int x_code, int64_t ldx, void* q,
                      void* scales, int m, int k, void* stream) {
  if (m <= 0) return cudaSuccess;
  if (k <= 0 || ldx < k) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_code) {
    case 0: return launch<float>(x, ldx, q, scales, m, k, s);
    case 1: return launch<__nv_bfloat16>(x, ldx, q, scales, m, k, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* nns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

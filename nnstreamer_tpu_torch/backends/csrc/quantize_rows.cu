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
// row whose amax is 0 gets scale 1 and q 0. The TPU kernel's pad to 8
// rows is a sublane rule of that chip: any M runs here.
//
// Bound: bytes. A row is read once (K * 2 or 4 bytes) and written once
// (K int8 + one f32 scale) for ~3 operations per element, far below the
// card's operations-per-byte balance. At the serving shapes (M 8 or 512,
// K 1024 or 4096) a launch moves 25 KB - 6 MB, so its time is a launch,
// one trip to device memory and the chain of work behind it, and the
// design keeps that chain short:
// - the register path (the launcher's pick for 16-byte aligned rows with
//   K a multiple of the vector, up to 4096 vectors a row): each row is
//   loaded once into registers, 16-byte vectors (4 f32 or 8 bf16),
//   neighbouring lanes on neighbouring vectors, spread over up to 16
//   warps so that a lane holds about 8 values (its true divisions run
//   one after another); |x| max by warp shuffles alone where one warp
//   holds the row, else one __syncthreads and a shuffle fold of the
//   warps' maxima; the int8 row is written from the registers. Short
//   rows share a CTA of 4 warps;
// - the shared-memory path for every other row (longer, misaligned or
//   ragged, up to K * itemsize = 227 KB less 32 bytes): the row is staged
//   in shared memory on the way in (16-byte vectors where aligned, a
//   scalar tail), one CTA a row, one __syncthreads and a shuffle fold of
//   the warps' maxima, then int8 out of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;            // shared-memory path
constexpr int kRegThreads = 128;            // register path, at least
constexpr int kRegMaxNv = 8;                // vectors a lane holds
constexpr int kRegMaxWpr = 16;              // warps a row spans
constexpr float kInv127 = 1.0f / 127.0f;   // rounded to f32 at compile time
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;
// the shared-memory kernel's static shared memory (its warps' maxima)
constexpr int kSmemStatic = sizeof(float) * (kMaxThreads / 32);

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

__device__ __forceinline__ float scale_of(float amax) {
  return amax > 0.f ? amax * kInv127 : 1.f;
}

// element e of a 16-byte vector of T held as raw words (bf16 widens
// exactly: its bits are the top half of the f32's)
__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int e);
template <>
__device__ __forceinline__ float elem<float>(const uint4& r, int e) {
  return __uint_as_float(word(r, e));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& r, int e) {
  const uint32_t w = word(r, e / 2);
  return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
}

template <typename T, int VEC>
__device__ __forceinline__ Vec<int8_t, VEC> quantize_vec(const Vec<T, VEC>& in,
                                                         float scale) {
  Vec<int8_t, VEC> out;
#pragma unroll
  for (int j = 0; j < VEC; ++j) out.v[j] = quantize_one(to_f32(in.v[j]), scale);
  return out;
}

// Register path: WPR warps a row, max(kRegThreads, 32 WPR) threads a CTA
// (so one row a CTA from 4 warps a row up); lane i of row warp w holds
// vectors i + 32 (w + WPR j), j < NV. Needs x 16-byte aligned rows,
// K % VEC == 0, q 16-byte aligned.
template <typename T, int NV, int WPR>
__global__ void __launch_bounds__(
    kRegThreads > 32 * WPR ? kRegThreads : 32 * WPR) nns_quantize_rows_kernel(
    const T* __restrict__ x, int64_t ldx, int8_t* __restrict__ q,
    float* __restrict__ scales, int m, int k) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kThreads = kRegThreads > 32 * WPR ? kRegThreads : 32 * WPR;
  constexpr int kRows = kThreads / (32 * WPR);
  __shared__ float warp_max[kRows][WPR];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp / WPR, w = warp % WPR;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + r;
  const bool live = row < m;
  const int nvec = k / VEC;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * ldx);

  uint4 v[NV];                                     // the row, as raw words
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = lane + 32 * (w + WPR * j);
    v[j] = live && i < nvec ? xv[i] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(elem<T>(v[j], e)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (WPR > 1) {
    if (lane == 0) warp_max[r][w] = amax;
    __syncthreads();
    amax = lane < WPR ? warp_max[r][lane] : 0.f;
#pragma unroll
    for (int o = WPR / 2; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    amax = __shfl_sync(0xffffffffu, amax, 0);
  }
  if (!live) return;
  const float scale = scale_of(amax);
  if (w == 0 && lane == 0) scales[row] = scale;
  Vec<int8_t, VEC>* qv =
      reinterpret_cast<Vec<int8_t, VEC>*>(q + row * static_cast<int64_t>(k));
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = lane + 32 * (w + WPR * j);
    if (i < nvec) {
      Vec<int8_t, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o.v[e] = quantize_one(elem<T>(v[j], e), scale);
      qv[i] = o;
    }
  }
}

// Shared-memory path: one CTA a row of any length the shared memory holds.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) nns_quantize_rows_kernel_smem(
    const T* __restrict__ x, int64_t ldx, int8_t* __restrict__ q,
    float* __restrict__ scales, int k, bool vec_in, bool vec_out) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* row_s = reinterpret_cast<T*>(smem_raw);                // k values
  __shared__ float warp_max[kMaxThreads / 32];

  const int64_t row = blockIdx.x;
  const T* xr = x + row * ldx;
  int8_t* qr = q + row * static_cast<int64_t>(k);
  const int tid = threadIdx.x, lane = tid % 32;
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
  if (lane == 0) warp_max[tid / 32] = amax;
  __syncthreads();   // also orders the row's shared-memory writes
  const int nwarps = blockDim.x / 32;
  amax = lane < nwarps ? warp_max[lane] : 0.f;
#pragma unroll
  for (int o = kMaxThreads / 64; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = scale_of(__shfl_sync(0xffffffffu, amax, 0));
  if (tid == 0) scales[row] = scale;

  // pass 2: shared memory -> int8, same element order as pass 1
  if (vec_out) {
    Vec<int8_t, VEC>* qv = reinterpret_cast<Vec<int8_t, VEC>*>(qr);
    for (int i = tid; i < k / VEC; i += blockDim.x)
      qv[i] = quantize_vec<T, VEC>(sv[i], scale);
  } else {
    for (int i = tid; i < k; i += blockDim.x)
      qr[i] = quantize_one(to_f32(row_s[i]), scale);
  }
}

// The register path's (NV, WPR) for a row of k values, or false where the
// row takes the shared-memory path. The division x / scale is a true IEEE
// division, which compiles to a short sequence with a branch to a slow
// path, so a lane's divisions run one after another: a row is spread
// over about 8 values a lane (k / 8 lanes, up to 16 warps), and only
// rows past 16 warps' 32 x 16 bytes take more vectors a lane (up to 8).
bool reg_layout(int itemsize, int k, bool aligned, int* nv, int* wpr) {
  const int vec = 16 / itemsize;
  if (!aligned || k % vec != 0) return false;
  const int nvec = k / vec, lanes = (k + 7) / 8;
  *wpr = 1;
  while (*wpr < kRegMaxWpr && 32 * *wpr < lanes) *wpr *= 2;
  *nv = 1;
  while (*nv * 32 * *wpr < nvec) *nv *= 2;
  return *nv <= kRegMaxNv;
}

template <typename T, int NV, int WPR>
cudaError_t launch_reg(const void* x, int64_t ldx, void* q, void* scales,
                       int m, int k, cudaStream_t stream) {
  constexpr int kThreads = kRegThreads > 32 * WPR ? kRegThreads : 32 * WPR;
  constexpr int kRows = kThreads / (32 * WPR);
  nns_quantize_rows_kernel<T, NV, WPR>
      <<<(m + kRows - 1) / kRows, kThreads, 0, stream>>>(
          static_cast<const T*>(x), ldx, static_cast<int8_t*>(q),
          static_cast<float*>(scales), m, k);
  return cudaGetLastError();
}

// the (NV, WPR) pairs reg_layout gives: NV 1 or 2 below 16 warps a row
// (k / 8 lanes hold k / 8 bf16 or k / 4 f32 vectors), any NV at 16
template <typename T, int NV>
cudaError_t launch_reg_wpr(int wpr, const void* x, int64_t ldx, void* q,
                           void* scales, int m, int k, cudaStream_t stream) {
  switch (wpr) {
    case 1: return launch_reg<T, NV, 1>(x, ldx, q, scales, m, k, stream);
    case 2: return launch_reg<T, NV, 2>(x, ldx, q, scales, m, k, stream);
    case 4: return launch_reg<T, NV, 4>(x, ldx, q, scales, m, k, stream);
    case 8: return launch_reg<T, NV, 8>(x, ldx, q, scales, m, k, stream);
    default: return launch_reg<T, NV, 16>(x, ldx, q, scales, m, k, stream);
  }
}

template <typename T>
cudaError_t launch(const void* x, int64_t ldx, void* q, void* scales, int m,
                   int k, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec_in = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      (ldx * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  const bool vec_out = vec_in && k % VEC == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0;
  int nv, wpr;
  if (reg_layout(sizeof(T), k, vec_out, &nv, &wpr)) {
    switch (nv) {
      case 1: return launch_reg_wpr<T, 1>(wpr, x, ldx, q, scales, m, k, stream);
      case 2: return launch_reg_wpr<T, 2>(wpr, x, ldx, q, scales, m, k, stream);
      case 4: return launch_reg<T, 4, 16>(x, ldx, q, scales, m, k, stream);
      default: return launch_reg<T, 8, 16>(x, ldx, q, scales, m, k, stream);
    }
  }
  // the row's dynamic shared memory beside the kernel's static warp_max;
  // past the 48 KB default a block takes only after opting in
  const size_t bytes = static_cast<size_t>(k) * sizeof(T);
  if (bytes > kMaxSmem - kSmemStatic) return cudaErrorInvalidValue;
  if (bytes > kDefaultSmem - kSmemStatic) {
    const cudaError_t err = cudaFuncSetAttribute(
        nns_quantize_rows_kernel_smem<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  // one thread per 16-byte vector of the row, a whole number of warps
  int threads = (k + VEC - 1) / VEC;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  nns_quantize_rows_kernel_smem<T><<<m, threads, bytes, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<int8_t*>(q),
      static_cast<float*>(scales), k, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_code: 0 f32, 1 bf16. x (m, k) with row stride ldx elements and a
// contiguous last dim; q (m, k) int8 contiguous; scales (m,) f32.
// k * itemsize <= 227 KB less 32 bytes (a row that takes the
// shared-memory path is staged there beside the kernel's 32 bytes). Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments outside the contract); does not
// synchronise and allocates nothing.
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

// The layout nns_quantize_rows takes for a row of k values of x_code's
// type whose rows and q are 16-byte aligned (aligned != 0): 1 and the
// register path's vectors a lane and warps a row, or 0 for the
// shared-memory path.
int nns_quantize_rows_layout(int x_code, int k, int aligned, int* nv,
                             int* wpr) {
  *nv = *wpr = 0;
  return reg_layout(x_code == 1 ? 2 : 4, k, aligned != 0, nv, wpr) ? 1 : 0;
}

const char* nns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

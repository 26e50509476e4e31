// clamp_scale for Hopper (sm_90a): y = clip(x, lo, hi) * scale + offset,
// output in x's dtype.
//
// Replaces the TPU kernel `_clamp_scale_kernel` / `clamp_scale` in
// nnstreamer_tpu/backends/pallas_ops.py. The rounding follows what that
// kernel computes (XLA, interpret mode), which the plain torch version in
// backends/kernels.py repeats bit for bit:
//
// - the bounds, scale and offset arrive already rounded to x's dtype
//   (through f32, as JAX rounds a weak-typed Python float);
// - clip keeps NaN and orders -0.0 below +0.0 (max(-0, +0) = +0,
//   min(-0, +0) = -0); fminf/fmaxf would drop the NaN;
// - f32: one rounding of clip(x) * scale + offset (an FMA); when the
//   offset is +0.0 the add is dropped, as XLA folds it, so -0.0 survives;
// - f16: one rounding of the exact value into f16. The product of two
//   f16 values is exact in f32; the sum is rounded to odd in f32 (its
//   rounding error recovered by TwoSum; when nonzero and the sum's last
//   bit even, one f32 ulp toward the error), which the f32 -> f16
//   rounding then cannot round wrongly a second time;
// - bf16: the product is rounded to bf16, then the f32 sum is rounded to
//   bf16 (two roundings, as XLA does for bf16);
// - f64: product and sum rounded separately (no JAX reference: x64 off);
// - integers: a pure clamp to the bounds rounded inward (ceil(lo),
//   floor(hi)), computed by the caller; scale and offset must be 1 and 0.
//
// Bound: bytes. Per element one read and one write of itemsize bytes for
// a handful of operations. The main path's call is one frame, P's
// (1, 257, 257, 3) f32: 0.79 MB each way, about 2 us of launch, latency
// and tail against 0.47 us of bytes. The design (PERF.md has the
// measured alternatives):
// - the clip is branch-free (compares combined into predicates and
//   selects): short-circuit && and || compile to a branch per element,
//   which costs more than the loads at a frame's size;
// - contiguous input, both pointers 16-byte aligned: one 16-byte vector
//   per thread, 256-thread CTAs, a grid of the tensor's size (P's frame:
//   194 CTAs, one wave); two or four vectors per thread measured slower
//   at P's frame and no faster at 16M, and a grid capped at one wave
//   and looping slower at 16M;
// - 32-bit indices when n < 2^31, 64-bit above;
// - the vector width (16 bytes, or one element when a pointer is not
//   16-byte aligned) and the fold of a +0 offset are template
//   parameters, not branches;
// - the last CTA alone does the elements past the last whole vector;
// - any other layout takes the strided kernel, one element per
//   iteration, its offset unravelled from the shape and strides; the
//   output is always contiguous.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxDims = 8;
constexpr int kThreads = 256;                  // one vector each

// The bounds, scale and offset in the precision the dtype computes in:
// f32 for f32, bf16 and f16; f64 for f64; the inward-rounded integer
// bounds for integers.
template <typename T, bool kInt = std::is_integral<T>::value>
struct Args {
  float lo, hi, scale, offset;
};
template <>
struct Args<double, false> {
  double lo, hi, scale, offset;
};
template <typename T>
struct Args<T, true> {
  long long lo, hi;
};

// The strided kernel's view of x (elements)
struct Shape {
  int ndim;
  int64_t sizes[kMaxDims];
  int64_t strides[kMaxDims];
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// clip without branches: the compares are combined with & and |, so
// they become predicates and selects, not a branch per element. A NaN
// fails every compare and passes through; -0.0 == +0.0, so the sign bit
// orders them.
__device__ __forceinline__ float clip_f(float x, float lo, float hi) {
  const bool below = (x < lo) | ((x == lo) & (__float_as_int(x) < 0));
  const float v = below ? lo : x;
  const bool above = (v > hi) | ((v == hi) & (__float_as_int(v) >= 0));
  return above ? hi : v;
}

__device__ __forceinline__ double clip_d(double x, double lo, double hi) {
  const bool below =
      (x < lo) | ((x == lo) & (__double_as_longlong(x) < 0));
  const double v = below ? lo : x;
  const bool above =
      (v > hi) | ((v == hi) & (__double_as_longlong(v) >= 0));
  return above ? hi : v;
}

// y of one element; FOLD: the offset is +0.0 and its add is dropped
template <bool FOLD>
__device__ __forceinline__ float apply(float x, const Args<float>& a) {
  const float c = clip_f(x, a.lo, a.hi);
  return FOLD ? __fmul_rn(c, a.scale) : __fmaf_rn(c, a.scale, a.offset);
}

template <bool FOLD>
__device__ __forceinline__ __half apply(__half x, const Args<__half>& a) {
  const float c = clip_f(__half2float(x), a.lo, a.hi);
  const float prod = __fmul_rn(c, a.scale);  // exact: 11 x 11 bits
  if (FOLD) return __float2half_rn(prod);
  float s = __fadd_rn(prod, a.offset);
  const float bb = __fsub_rn(s, prod);
  const float err = __fadd_rn(__fsub_rn(prod, __fsub_rn(s, bb)),
                              __fsub_rn(a.offset, bb));
  // round to odd in f32 (24 bits >= 11 + 2), then once to f16
  if (err != 0.0f && (__float_as_uint(s) & 1u) == 0u) {
    s = nextafterf(s, err > 0.0f ? INFINITY : -INFINITY);
  }
  return __float2half_rn(s);
}

template <bool FOLD>
__device__ __forceinline__ __nv_bfloat16 apply(
    __nv_bfloat16 x, const Args<__nv_bfloat16>& a) {
  const float c = clip_f(__bfloat162float(x), a.lo, a.hi);
  const __nv_bfloat16 prod = __float2bfloat16_rn(__fmul_rn(c, a.scale));
  if (FOLD) return prod;
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(prod), a.offset));
}

template <bool FOLD>
__device__ __forceinline__ double apply(double x, const Args<double>& a) {
  const double prod = __dmul_rn(clip_d(x, a.lo, a.hi), a.scale);
  return FOLD ? prod : __dadd_rn(prod, a.offset);
}

// integers: max then min, as torch.clamp (lo > hi gives hi); FOLD unused
template <bool FOLD, typename I>
__device__ __forceinline__
    typename std::enable_if<std::is_integral<I>::value, I>::type
    apply(I x, const Args<I>& a) {
  long long v = static_cast<long long>(x);
  v = v < a.lo ? a.lo : v;
  return static_cast<I>(v > a.hi ? a.hi : v);
}

// Contiguous x and y, vectors of VEC elements (VEC 1: a pointer is not
// 16-byte aligned), indices of type I: thread i of the grid does vector
// i (the grid covers the vectors; it loops only past 2^31 - 1 CTAs).
template <typename T, int VEC, bool FOLD, typename I>
__global__ void __launch_bounds__(kThreads) nns_clamp_scale_kernel(
    const T* __restrict__ x, T* __restrict__ y, I n, Args<T> a) {
  using V = Vec<T, VEC>;
  const V* __restrict__ xv = reinterpret_cast<const V*>(x);
  V* __restrict__ yv = reinterpret_cast<V*>(y);
  const I nvec = n / VEC;
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < nvec;
       i += static_cast<I>(gridDim.x) * kThreads) {
    const V in = xv[i];
    V out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) out.v[e] = apply<FOLD>(in.v[e], a);
    yv[i] = out;
  }
  if (VEC > 1 && blockIdx.x == gridDim.x - 1) {
    for (I i = nvec * VEC + threadIdx.x; i < n; i += kThreads)
      y[i] = apply<FOLD>(x[i], a);
  }
}

// Any other layout: element i of the dense output from x's strides.
template <typename T, bool FOLD>
__global__ void __launch_bounds__(kThreads) nns_clamp_scale_strided_kernel(
    const T* __restrict__ x, T* __restrict__ y, int64_t n, Shape sh,
    Args<T> a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    int64_t rem = i, off = 0;
    for (int d = sh.ndim - 1; d >= 0; --d) {
      off += (rem % sh.sizes[d]) * sh.strides[d];
      rem /= sh.sizes[d];
    }
    y[i] = apply<FOLD>(x[off], a);
  }
}

template <typename T, int VEC, bool FOLD, typename I>
cudaError_t launch_contiguous(const void* x, void* y, int64_t n,
                              const Args<T>& a, cudaStream_t stream) {
  constexpr int64_t kMaxGrid = 0x7fffffff;
  const int64_t blocks = (n / VEC + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 1 ? 1 : blocks < kMaxGrid
                                                         ? blocks
                                                         : kMaxGrid);
  nns_clamp_scale_kernel<T, VEC, FOLD, I><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<I>(n), a);
  return cudaGetLastError();
}

template <typename T, bool FOLD>
cudaError_t launch_fold(const void* x, void* y, int64_t n, const Shape* sh,
                        const Args<T>& a, cudaStream_t stream) {
  if (sh != nullptr) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 8192) blocks = 8192;
    nns_clamp_scale_strided_kernel<T, FOLD>
        <<<static_cast<int>(blocks), kThreads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<T*>(y), n, *sh, a);
    return cudaGetLastError();
  }
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (n < (int64_t{1} << 31))
    return vec ? launch_contiguous<T, VEC, FOLD, uint32_t>(x, y, n, a, stream)
               : launch_contiguous<T, 1, FOLD, uint32_t>(x, y, n, a, stream);
  return vec ? launch_contiguous<T, VEC, FOLD, int64_t>(x, y, n, a, stream)
             : launch_contiguous<T, 1, FOLD, int64_t>(x, y, n, a, stream);
}

template <typename T>
cudaError_t launch_float(const void* x, void* y, int64_t n, const Shape* sh,
                         double lo, double hi, double scale, double offset,
                         bool fold_add, cudaStream_t stream) {
  using A = Args<T>;
  using F = decltype(A::lo);   // float, or double for f64
  const A a{static_cast<F>(lo), static_cast<F>(hi), static_cast<F>(scale),
            static_cast<F>(offset)};
  return fold_add ? launch_fold<T, true>(x, y, n, sh, a, stream)
                  : launch_fold<T, false>(x, y, n, sh, a, stream);
}

template <typename T>
cudaError_t launch_int(const void* x, void* y, int64_t n, const Shape* sh,
                       long long ilo, long long ihi, cudaStream_t stream) {
  return launch_fold<T, true>(x, y, n, sh, Args<T>{ilo, ihi}, stream);
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 f16, 3 f64, 4 u8, 5 i8, 6 u16, 7 i16, 8 i32,
// 9 i64. `sizes`/`strides` (elements) describe x, `ndim` <= 8; `contiguous`
// says x is dense row-major (then they are not read). y is a dense
// row-major tensor of x's shape. lo/hi/scale/offset are already rounded to
// the dtype (floats); ilo/ihi are the inward-rounded integer bounds.
// Launches on `stream` and returns cudaGetLastError(); does not
// synchronise and allocates nothing.
int nns_clamp_scale(const void* x, void* y, int dtype, int64_t n, int ndim,
                    const int64_t* sizes, const int64_t* strides,
                    int contiguous, double lo, double hi, double scale,
                    double offset, int fold_add, long long ilo,
                    long long ihi, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (ndim < 0 || ndim > kMaxDims) return cudaErrorInvalidValue;
  Shape shape;
  const Shape* sh = nullptr;
  if (!contiguous) {
    shape.ndim = ndim;
    for (int d = 0; d < ndim; ++d) {
      shape.sizes[d] = sizes[d];
      shape.strides[d] = strides[d];
    }
    sh = &shape;
  }
  const bool fold = fold_add != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_float<float>(x, y, n, sh, lo, hi, scale, offset,
                                       fold, s);
    case 1: return launch_float<__nv_bfloat16>(x, y, n, sh, lo, hi, scale,
                                               offset, fold, s);
    case 2: return launch_float<__half>(x, y, n, sh, lo, hi, scale, offset,
                                        fold, s);
    case 3: return launch_float<double>(x, y, n, sh, lo, hi, scale, offset,
                                        fold, s);
    case 4: return launch_int<uint8_t>(x, y, n, sh, ilo, ihi, s);
    case 5: return launch_int<int8_t>(x, y, n, sh, ilo, ihi, s);
    case 6: return launch_int<uint16_t>(x, y, n, sh, ilo, ihi, s);
    case 7: return launch_int<int16_t>(x, y, n, sh, ilo, ihi, s);
    case 8: return launch_int<int32_t>(x, y, n, sh, ilo, ihi, s);
    case 9: return launch_int<int64_t>(x, y, n, sh, ilo, ihi, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* nns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

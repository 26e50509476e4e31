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
// a handful of operations. A contiguous, 16-byte-aligned input moves as
// 16-byte vectors in a grid-stride loop (tail elements scalar); any other
// input takes the strided path, one element per iteration, its offset
// unravelled from the shape and strides; the output is always contiguous.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxDims = 8;

struct Params {
  int64_t n;
  int ndim;
  int64_t sizes[kMaxDims];
  int64_t strides[kMaxDims];  // in elements
  float flo, fhi, fscale, foffset;
  double dlo, dhi, dscale, doffset;
  long long ilo, ihi;
  bool fold_add;  // offset is +0.0: y = round(clip(x) * scale)
};

template <typename T, int N>
struct alignas(16) Vec {
  T v[N];
};

__device__ __forceinline__ float clip_f(float x, float lo, float hi) {
  if (isnan(x)) return x;
  float v = (x < lo || (x == lo && signbit(x))) ? lo : x;
  return (v > hi || (v == hi && !signbit(v))) ? hi : v;
}

__device__ __forceinline__ double clip_d(double x, double lo, double hi) {
  if (isnan(x)) return x;
  double v = (x < lo || (x == lo && signbit(x))) ? lo : x;
  return (v > hi || (v == hi && !signbit(v))) ? hi : v;
}

template <typename T>
struct Op;

template <>
struct Op<float> {
  __device__ __forceinline__ static float apply(float x, const Params& p) {
    const float c = clip_f(x, p.flo, p.fhi);
    return p.fold_add ? __fmul_rn(c, p.fscale)
                      : __fmaf_rn(c, p.fscale, p.foffset);
  }
};

template <>
struct Op<__half> {
  __device__ __forceinline__ static __half apply(__half x, const Params& p) {
    const float c = clip_f(__half2float(x), p.flo, p.fhi);
    const float prod = __fmul_rn(c, p.fscale);  // exact: 11 x 11 bits
    if (p.fold_add) return __float2half_rn(prod);
    float s = __fadd_rn(prod, p.foffset);
    const float bb = __fsub_rn(s, prod);
    const float err = __fadd_rn(__fsub_rn(prod, __fsub_rn(s, bb)),
                                __fsub_rn(p.foffset, bb));
    // round to odd in f32 (24 bits >= 11 + 2), then once to f16
    if (err != 0.0f && (__float_as_uint(s) & 1u) == 0u) {
      s = nextafterf(s, err > 0.0f ? INFINITY : -INFINITY);
    }
    return __float2half_rn(s);
  }
};

template <>
struct Op<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 apply(__nv_bfloat16 x,
                                                        const Params& p) {
    const float c = clip_f(__bfloat162float(x), p.flo, p.fhi);
    const __nv_bfloat16 prod = __float2bfloat16_rn(__fmul_rn(c, p.fscale));
    if (p.fold_add) return prod;
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(prod), p.foffset));
  }
};

template <>
struct Op<double> {
  __device__ __forceinline__ static double apply(double x, const Params& p) {
    const double prod = __dmul_rn(clip_d(x, p.dlo, p.dhi), p.dscale);
    return p.fold_add ? prod : __dadd_rn(prod, p.doffset);
  }
};

template <typename I>
struct IntOp {
  __device__ __forceinline__ static I apply(I x, const Params& p) {
    // max then min, as torch.clamp (lo > hi gives hi)
    long long v = static_cast<long long>(x);
    v = v < p.ilo ? p.ilo : v;
    return static_cast<I>(v > p.ihi ? p.ihi : v);
  }
};

template <typename T>
struct Pick {
  using type = Op<T>;
};
template <> struct Pick<uint8_t> { using type = IntOp<uint8_t>; };
template <> struct Pick<int8_t> { using type = IntOp<int8_t>; };
template <> struct Pick<uint16_t> { using type = IntOp<uint16_t>; };
template <> struct Pick<int16_t> { using type = IntOp<int16_t>; };
template <> struct Pick<int32_t> { using type = IntOp<int32_t>; };
template <> struct Pick<int64_t> { using type = IntOp<int64_t>; };

template <typename T>
__global__ void nns_clamp_scale_kernel(const T* __restrict__ x,
                                       T* __restrict__ y, Params p,
                                       bool contiguous, bool vectorized) {
  using F = typename Pick<T>::type;
  constexpr int VEC = 16 / sizeof(T) > 0 ? 16 / sizeof(T) : 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (!contiguous) {
    for (int64_t i = tid; i < p.n; i += stride) {
      int64_t rem = i, off = 0;
      for (int d = p.ndim - 1; d >= 0; --d) {
        off += (rem % p.sizes[d]) * p.strides[d];
        rem /= p.sizes[d];
      }
      y[i] = F::apply(x[off], p);
    }
    return;
  }
  int64_t scalar_from = 0;
  if (vectorized) {
    const int64_t nvec = p.n / VEC;
    const Vec<T, VEC>* xv = reinterpret_cast<const Vec<T, VEC>*>(x);
    Vec<T, VEC>* yv = reinterpret_cast<Vec<T, VEC>*>(y);
    for (int64_t i = tid; i < nvec; i += stride) {
      const Vec<T, VEC> in = xv[i];
      Vec<T, VEC> out;
#pragma unroll
      for (int k = 0; k < VEC; ++k) out.v[k] = F::apply(in.v[k], p);
      yv[i] = out;
    }
    scalar_from = nvec * VEC;
  }
  for (int64_t i = scalar_from + tid; i < p.n; i += stride) {
    y[i] = F::apply(x[i], p);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, const Params& p, bool contiguous,
                   cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int VEC = 16 / sizeof(T);
  const bool vectorized = contiguous &&
                          reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int64_t work = vectorized ? (p.n + VEC - 1) / VEC : p.n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 8192) blocks = 8192;
  nns_clamp_scale_kernel<T><<<static_cast<int>(blocks), kThreads, 0,
                              stream>>>(static_cast<const T*>(x),
                                        static_cast<T*>(y), p, contiguous,
                                        vectorized);
  return cudaGetLastError();
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
  Params p;
  p.n = n;
  p.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    p.sizes[d] = sizes[d];
    p.strides[d] = strides[d];
  }
  p.flo = static_cast<float>(lo);
  p.fhi = static_cast<float>(hi);
  p.fscale = static_cast<float>(scale);
  p.foffset = static_cast<float>(offset);
  p.dlo = lo;
  p.dhi = hi;
  p.dscale = scale;
  p.doffset = offset;
  p.ilo = ilo;
  p.ihi = ihi;
  p.fold_add = fold_add != 0;
  const bool c = contiguous != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, y, p, c, s);
    case 1: return launch<__nv_bfloat16>(x, y, p, c, s);
    case 2: return launch<__half>(x, y, p, c, s);
    case 3: return launch<double>(x, y, p, c, s);
    case 4: return launch<uint8_t>(x, y, p, c, s);
    case 5: return launch<int8_t>(x, y, p, c, s);
    case 6: return launch<uint16_t>(x, y, p, c, s);
    case 7: return launch<int16_t>(x, y, p, c, s);
    case 8: return launch<int32_t>(x, y, p, c, s);
    case 9: return launch<int64_t>(x, y, p, c, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* nns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

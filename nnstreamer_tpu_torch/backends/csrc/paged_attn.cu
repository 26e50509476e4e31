// Paged attention for Hopper (sm_90a): one decode step and one prefill
// chunk of one layer, reading K/V straight from the paged pool through
// block tables.
//
// Replaces the TPU kernels in nnstreamer_tpu/backends/pallas_paged.py:
// - nns_paged_decode_kernel  <- paged_decode_attn  (_paged_decode_kernel)
// - nns_paged_prefill_tf32_kernel <- paged_prefill_attn (_paged_prefill_kernel)
//
// Both compute what the TPU kernels compute, not a carry-over of their
// grids: the TPU walks table blocks as a sequential grid axis with the
// softmax state in scratch memory. Here decode splits each row's walk
// over the KV axis into CTAs of whole pool blocks and folds their
// partials in the same launch; prefill gives one CTA its query rows for
// the whole walk, a 64-key tile at a time (32 at head dim 256), whatever
// the block size. Semantics shared with the JAX package's
// _online_softmax_update (pallas_ops.py):
// - s = (q . k) * scale in f32 (q widened from f32 or bf16; pool f32);
// - masked scores are set to -1e30; p is forced to 0 where s <= -1e29;
// - m starts at -1e30, l at 0; corr = exp(m_old - m_new);
//   l = l * corr + sum(p); acc = acc * corr + p . v;
// - out = acc / max(l, 1e-20), f32.
// Partials (m, l, acc) of disjoint key sets fold as M = max m, l = sum
// l e^(m - M), acc = sum acc e^(m - M); one with no live key (m -1e30,
// l 0) adds nothing. Decode masks kv_pos <= pos[b] (inclusive) and skips
// table blocks that start past pos[b] (a row with pos < 0 gives 0);
// prefill masks pos0 + row >= kv_pos and skips blocks that start past
// the q-block's last row. GQA: query head h reads kv head
// h / (n_heads / n_kv) straight from the narrow pool, never a
// group-expanded copy. The pool of one layer arrives as a pointer plus
// block/slot/head strides (innermost dim contiguous); nothing is copied.
//
// Bound: bytes for decode (each attended K/V element, 4 bytes of the f32
// pool, is read once for 2 flops of q.k and 2 of p.v). For prefill, the
// operations: the serving chunk (S_c 512 at pos0 1024, 8 heads x hd 128)
// does 2.69 GFLOP, 0.0401 ms on the CUDA cores' 67 TFLOP/s f32; as split
// TF32 (below) its 3 x 2.69 GFLOP take 0.0163 ms at the tensor cores'
// 495 TFLOP/s TF32; its ~12.6 MB of K/V take ~0.004 ms at 3.35 TB/s.
// The designs:
// - decode: grid (batch, n_kv, splits). Split s of a row takes table
//   blocks s * bps .. s * bps + bps - 1; the host picks splits and bps
//   from the table width, batch * n_kv and the SM count (it never reads
//   pos), so a few short rows' dead splits return at once and a long
//   row's walk runs on many SMs. A CTA's four warps each walk their own
//   batches of 8 keys (4 where more heads or dims take the registers)
//   with (m, l, acc) in registers, no barrier per batch: lane i holds
//   dims 4i .. 4i + 3 of q, acc and each batch key's K and V row (16-byte
//   loads, a batch's 2-4 KB in flight a warp); the batch's dot products
//   are summed by one reduce-scatter of shuffles, so each lane ends with
//   one key's score, takes its exp, and the p's are broadcast for p.v.
//   The warps' partials fold once through shared memory; the split's
//   partial goes to a workspace, and the last live split of a (row, kv
//   head) to take an atomic ticket (after __threadfence) folds all of
//   them in split order, so the result does not depend on which CTA ran
//   last, writes out and resets the ticket to 0 for the next launch on
//   that stream. A row with a single live split writes out directly.
//   GQA shares each K/V load among the group's heads;
// - prefill: K/V tiles move global -> shared with cp.async, 16 bytes a
//   thread, double-buffered so the next tile's copy overlaps this tile's
//   math; a tile slot past the walk is zero-filled, so masked p = 0
//   never meets an uninitialised (possibly NaN) value; the CTA's slice
//   of the block table is copied to shared memory once;
// - prefill: both products on the tensor cores as split TF32
//   (mma.sync.m16n8k8.tf32, f32 accumulators). Each f32 operand x is
//   split into hi = tf32(x) and lo = tf32(x - hi), and a.b is taken as
//   lo_a.hi_b + hi_a.lo_b + hi_a.hi_b: the dropped lo.lo term is ~2^-22
//   of the product, near f32, where one TF32 product (2^-11) would not
//   hold the 1e-5 tolerance. A bf16 q is exact in TF32 (lo = 0), so its
//   Q.K^T takes two products; P.V (f32 p, not rounded, f32 pool) three.
//   A CTA of 16 warps owns 32 query rows of one head: two row groups of
//   16 times eight key warps, each taking 8 keys of every 64-key tile
//   with its own (m, l, acc), combined once after the walk (head dim 256:
//   four key warps and 32-key tiles, for the registers). So the serving
//   chunk's 128 CTAs run 2048 warps, one CTA an SM (~155 KB of shared
//   memory with a bf16 q: two f32 K/V tile pairs and the q-block's TF32
//   parts); of the layouts measured this was the fastest at the serving
//   shape (PERF.md). The online softmax runs on the accumulator
//   fragments in registers (quad shuffles); Q.K^T's k index runs over
//   dims (2t, 2t+1) and P.V's over keys (2t, 2t+1), so S's accumulator
//   fragment is P.V's A fragment as it stands and P never touches shared
//   memory.
// Still ahead (later work): TMA and wgmma for prefill; for decode, K/V
// loads of the next batch issued before this batch's math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kMasked = -1e30f;
constexpr float kMaskedBelow = -1e29f;
constexpr float kLFloor = 1e-20f;
constexpr int kMaxBlock = 64;        // pool block size, at most
constexpr int kDecMaxTable = 4096;   // table blocks a decode split stages
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 operator*(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ void fma4(float4& acc, float p, float4 v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 16-byte global -> shared copy; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- decode: each row's walk split over the KV axis ---------------------------

constexpr int kDecWarps = 4;                      // key warps per CTA
constexpr int kDecThreads = 32 * kDecWarps;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// One decode CTA by GP (the query group g padded to a power of two) and
// VPL (128-dim chunks of the head, 4 dims a lane each): KB keys per warp
// batch (fewer where the registers hold more heads or dims), and the
// floats of one (acc, m, l) partial.
template <int GP, int VPL>
struct DecodeCfg {
  static constexpr int kKB = (VPL == 1 && GP <= 2) ? 8 : 4;
  static constexpr int kKeyShift = kKB == 8 ? 2 : 3;  // lane >> it: its key
  static constexpr int kHdp = 128 * VPL;
  static constexpr int kAcc = GP * kHdp;
  // m and l of each head after acc, padded so each warp's partial in
  // shared memory starts 16-byte aligned
  static constexpr int kPart = kAcc + (2 * GP + 3) / 4 * 4;
};

// Reduce-scatter of KB per-lane partial sums over the warp: each halving
// step keeps half of the values and adds the partner's copy of them, so
// the KB sums take KB - 1 + log2(32 / KB) shuffles, not 5 KB. On return
// v[0] is the whole sum of key (lane >> (5 - log2 KB)), the same in the
// 32 / KB lanes that hold it.
template <int N, int OFF, int KB>
struct Scatter {
  static __device__ __forceinline__ void run(float (&v)[KB], int lane) {
    const bool hi = lane & OFF;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = hi ? v[i] : v[i + N / 2];
      const float keep = hi ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    Scatter<N / 2, OFF / 2, KB>::run(v, lane);
  }
};
template <int OFF, int KB>
struct Scatter<1, OFF, KB> {
  static __device__ __forceinline__ void run(float (&v)[KB], int) {
#pragma unroll
    for (int o = OFF; o > 0; o >>= 1)
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  }
};

// Fold n (acc, m, l) partials, in order, into element `e` of one head:
// M = max m, L = sum l e^(m - M), A = sum acc e^(m - M) → A (M and L
// through the pointers). A partial with no live key (m -1e30, l 0, acc
// 0) adds nothing.
template <typename Load>
__device__ __forceinline__ float fold_parts(Load ld, int n, int e, int m_at,
                                            int l_at, float* M, float* L) {
  float mx = kMasked;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, ld(i, m_at));
  float a = 0.f, s = 0.f;
  for (int i = 0; i < n; ++i) {
    const float c = expf(ld(i, m_at) - mx);
    s = fmaf(ld(i, l_at), c, s);
    a = fmaf(ld(i, e), c, a);
  }
  *M = mx;
  *L = s;
  return a;
}

// Grid (batch, n_kv, splits): CTA (b, kv head, split) attends the g query
// heads of the group against table blocks split * bps .. + bps - 1 of
// row b, up to pos[b]. A split past pos[b] returns at once; a row with
// one live split (or none: pos < 0) writes out itself. Otherwise each
// live split leaves its partial in ws, and the last of them to take a
// ticket folds all of them in split order, writes out and resets the
// ticket. In the CTA, warp w takes key batches w, w + 4, ... with its
// own (m, l, acc) in registers: lane i holds dims 4i .. 4i + 3 of each
// 128-dim chunk of q and acc, and of every batch key's K and V row (16-
// byte loads, 2 KB loads in flight each).
template <typename Q, int GP, int VPL>
__global__ void __launch_bounds__(kDecThreads) nns_paged_decode_kernel(
    const Q* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ pos, float* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ tickets, int n_heads,
    int n_kv, int hd, int bs, int mb, int bps, int64_t sb, int64_t ss,
    int64_t sh, float scale) {
  using C = DecodeCfg<GP, VPL>;
  constexpr int KB = C::kKB;
  __shared__ __align__(16) float red_s[kDecWarps * C::kPart];
  __shared__ int last_s;
  extern __shared__ int tab_s[];                    // the split's blocks

  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int p = pos[b];
  const int nblk = p < 0 ? 0 : min(mb, p / bs + 1);
  const int nlive = (nblk + bps - 1) / bps;
  if (split > 0 && split >= nlive) return;          // no live key here
  const int blk0 = split * bps;
  const int nb = max(0, min(bps, nblk - blk0));
  const int key0 = blk0 * bs, key1 = key0 + nb * bs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = n_heads / n_kv;

  for (int i = tid; i < nb; i += kDecThreads)
    tab_s[i] = tables[static_cast<int64_t>(b) * mb + blk0 + i];
  const int64_t row0 = (static_cast<int64_t>(b) * n_heads + kvh * g) * hd;
  float4 qv[GP][VPL], acc[GP][VPL];
  float m[GP], l[GP];
#pragma unroll
  for (int h = 0; h < GP; ++h) {
    m[h] = kMasked;
    l[h] = 0.f;
#pragma unroll
    for (int c = 0; c < VPL; ++c) {
      const int d = c * 128 + 4 * lane;
      qv[h][c] = h < g && d < hd ? load4(q + row0 + h * hd + d)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[h][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();                                  // tab_s is in

  const int64_t head_off = kvh * sh;
  const int nbatch = (key1 - key0 + KB - 1) / KB;
  for (int j = warp; j < nbatch; j += kDecWarps) {
    const int kb = key0 + j * KB;
    int blk = kb / bs, slot = kb - blk * bs;
    blk -= blk0;
    float4 kr[KB][VPL], vr[KB][VPL];
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      const bool in = kb + i < key1;
      int64_t off = 0;
      if (in) off = static_cast<int64_t>(tab_s[blk]) * sb + slot * ss + head_off;
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        const int d = c * 128 + 4 * lane;
        if (in && d < hd) {
          kr[i][c] = load4(k_pool + off + d);
          vr[i][c] = load4(v_pool + off + d);
        } else {
          kr[i][c] = vr[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      if (++slot == bs) {
        slot = 0;
        ++blk;
      }
    }
    const int key = kb + (lane >> C::kKeyShift);    // this lane's key
    const bool valid = key <= p && key < key1;
#pragma unroll
    for (int h = 0; h < GP; ++h) {
      float sc[KB];
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        float d0 = 0.f;
#pragma unroll
        for (int c = 0; c < VPL; ++c) d0 = dot4(qv[h][c], kr[i][c], d0);
        sc[i] = d0;
      }
      Scatter<KB, 16, KB>::run(sc, lane);
      const float s = valid ? sc[0] * scale : kMasked;
      float mx = s;
#pragma unroll
      for (int o = 1 << C::kKeyShift; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[h], mx);
      const float corr = expf(m[h] - m_new);
      const float e = s <= kMaskedBelow ? 0.f : expf(s - m_new);
      l[h] = fmaf(l[h], corr, e);                   // this lane's key only
      m[h] = m_new;
#pragma unroll
      for (int c = 0; c < VPL; ++c) acc[h][c] = acc[h][c] * corr;
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        const float pk = __shfl_sync(0xffffffffu, e, i << C::kKeyShift);
#pragma unroll
        for (int c = 0; c < VPL; ++c) fma4(acc[h][c], pk, vr[i][c]);
      }
    }
  }

  // the warps' partials (l summed over the lanes of distinct keys) into
  // shared memory, folded in warp order into the split's
  float* mine = red_s + warp * C::kPart;
#pragma unroll
  for (int h = 0; h < GP; ++h) {
#pragma unroll
    for (int o = 1 << C::kKeyShift; o < 32; o <<= 1)
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], o);
#pragma unroll
    for (int c = 0; c < VPL; ++c)
      *reinterpret_cast<float4*>(mine + h * C::kHdp + c * 128 + 4 * lane) =
          acc[h][c];
    if (lane == 0) {
      mine[C::kAcc + h] = m[h];
      mine[C::kAcc + GP + h] = l[h];
    }
  }
  __syncthreads();
  const auto from_warps = [&](int w, int i) { return red_s[w * C::kPart + i]; };
  const int64_t pair = static_cast<int64_t>(b) * n_kv + kvh;
  float* part = ws + (pair * gridDim.z + split) * C::kPart;
  for (int e = tid; e < C::kAcc; e += kDecThreads) {
    const int h = e / C::kHdp, d = e - h * C::kHdp;
    float mx, lsum;
    const float a = fold_parts(from_warps, kDecWarps, e, C::kAcc + h,
                               C::kAcc + GP + h, &mx, &lsum);
    if (nlive <= 1) {
      if (h < g && d < hd) out[row0 + h * hd + d] = a / fmaxf(lsum, kLFloor);
    } else {
      part[e] = a;
      if (d == 0) {
        part[C::kAcc + h] = mx;
        part[C::kAcc + GP + h] = lsum;
      }
    }
  }
  if (nlive <= 1) return;

  // ticket: the partial is visible before the count moves; the CTA that
  // takes the last ticket reads the partials after seeing the count
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_s = atomicAdd(tickets + pair, 1) == nlive - 1;
    if (last_s) tickets[pair] = 0;                  // every live split took one
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* parts = ws + pair * gridDim.z * C::kPart;
  const auto from_splits = [&](int s, int i) {
    return __ldcg(parts + static_cast<int64_t>(s) * C::kPart + i);
  };
  for (int e = tid; e < C::kAcc; e += kDecThreads) {
    const int h = e / C::kHdp, d = e - h * C::kHdp;
    if (h >= g || d >= hd) continue;
    float mx, lsum;
    const float a = fold_parts(from_splits, nlive, e, C::kAcc + h,
                               C::kAcc + GP + h, &mx, &lsum);
    out[row0 + h * hd + d] = a / fmaxf(lsum, kLFloor);
  }
}

// -- prefill: split-TF32 products on the tensor cores -------------------------

constexpr int kPreRowWarps = 2;                    // 16 query rows each
constexpr int kPreRows = 16 * kPreRowWarps;        // query rows per CTA
constexpr int kPreMaxHd = 256;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// x = hi + lo + O(2^-22 x), hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest (ties away), as TF32 bit patterns
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d += a (16x8 tf32, row) * b (8x8 tf32, col), f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b to near-f32 accuracy from split operands: the cross terms
// first, then hi * hi; lo * lo (~2^-22 of the product) is dropped, and so
// is lo_a * hi_b when a has no low part (A_LO false: a bf16 q is exact
// in TF32)
template <bool A_LO>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b)[4]) {
  if (A_LO) mma_tf32(d, a_lo, b[0], b[1]);
  mma_tf32(d, a_hi, b[2], b[3]);
  mma_tf32(d, a_hi, b[0], b[1]);
}

// b: {hi0, hi1, lo0, lo1} of the two values of a B fragment
__device__ __forceinline__ void split_b(float x0, float x1, uint32_t (&b)[4]) {
  split_tf32(x0, b[0], b[2]);
  split_tf32(x1, b[1], b[3]);
}

// One prefill CTA by head dim (padded): its key warps (each takes 8
// keys of every tile), and its shared memory (floats, then the table):
// two K/V tile pairs (reused at the end for the key warps' partials),
// the q-block's TF32 hi parts and, for an f32 q, its lo parts. Eight key
// warps (16 warps, 64-key tiles) where a thread's 128 registers hold the
// accumulators (head dim <= 128), else four. Row strides: K and q rows
// are HDP + 8 floats (= 8 mod 32: the 64-bit fragment reads of 8 rows x
// 4 lanes cover the 32 banks once per half-warp), V rows HDP + 4 (= 4
// mod 32: the 32-bit reads of rows 2t and 2t + 1, columns g, do too).
template <int HDP>
struct PrefillCfg {
  static constexpr int kKeyWarps = HDP <= 128 ? 8 : 4;
  static constexpr int kTileKeys = 8 * kKeyWarps;
  static constexpr int kThreads = 32 * kPreRowWarps * kKeyWarps;
  static constexpr int kLdK = HDP + 8, kLdV = HDP + 4, kLdQ = HDP + 8;
  static constexpr int kTileK = kTileKeys * kLdK;
  static constexpr int kTileV = kTileKeys * kLdV;
  static constexpr int kRed = HDP / 2 + 4;   // acc fragments, m, l
  static constexpr int kRedFloats =
      (kKeyWarps - 1) * kPreRowWarps * kRed * 32;
  static constexpr int kKvFloats =
      2 * (kTileK + kTileV) > kRedFloats ? 2 * (kTileK + kTileV) : kRedFloats;
  static size_t bytes(bool q_lo, int mb) {
    return sizeof(float) * (kKvFloats + (q_lo ? 2 : 1) * kPreRows * kLdQ) +
           sizeof(int) * static_cast<size_t>(mb);
  }
};

// One CTA per (query head h, q-block of kPreRows rows): causal attention
// of the chunk's rows (absolute positions pos0 + row) against the
// sequence's table blocks up to the q-block's last row, kTileKeys keys a
// tile. Warp (rw, kw) owns rows 16 rw .. 16 rw + 15 and keys 8 kw ..
// 8 kw + 7 of every tile, with its own (m, l, acc); the kKeyWarps
// partials of a row group are combined once, after the walk. In a
// fragment, lane (g, t) holds rows g and g + 8 at columns 2t and 2t + 1;
// the k index of Q.K^T runs over dims (2t, 2t + 1) and that of P.V over
// keys (2t, 2t + 1), so S's accumulator fragment is P.V's A fragment as
// it stands.
template <typename Q, int HDP>
__global__ void __launch_bounds__(PrefillCfg<HDP>::kThreads)
    nns_paged_prefill_tf32_kernel(
    const Q* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ table,
    float* __restrict__ out, int n_heads, int n_kv, int s_c, int hd, int bs,
    int mb, int pos0, int64_t sb, int64_t ss, int64_t sh, float scale) {
  using L = PrefillCfg<HDP>;
  constexpr bool kQLo = sizeof(Q) == sizeof(float);
  constexpr int kNT = HDP / 8;   // 8-dim steps of Q.K^T; 8-column out tiles
  extern __shared__ __align__(16) float smem[];
  float* kv_s = smem;                                  // 2 x (K, V)
  float* qh_s = kv_s + L::kKvFloats;                   // rows x kLdQ
  float* ql_s = qh_s + kPreRows * L::kLdQ;             // f32 q only
  int* tab_s = reinterpret_cast<int*>(ql_s + (kQLo ? kPreRows * L::kLdQ : 0));

  const int h = blockIdx.x, row_lo = blockIdx.y * kPreRows;
  const int rows = min(kPreRows, s_c - row_lo);
  const int q_hi = pos0 + row_lo + rows - 1;
  const int nblk = q_hi < 0 ? 0 : min(mb, q_hi / bs + 1);
  const int nkeys = nblk * bs;
  const int ntiles = (nkeys + L::kTileKeys - 1) / L::kTileKeys;
  const int64_t head_off = static_cast<int64_t>(h / (n_heads / n_kv)) * sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % kPreRowWarps, kw = warp / kPreRowWarps;
  const int g = lane / 4, t4 = lane % 4;

  const int64_t q0 = (static_cast<int64_t>(h) * s_c + row_lo) * hd;
  for (int i = threadIdx.x; i < kPreRows * HDP; i += L::kThreads) {
    const int r = i / HDP, c = i - r * HDP;
    const float x = r < rows && c < hd ? to_f32(q[q0 + r * hd + c]) : 0.f;
    uint32_t hi, lo;
    split_tf32(x, hi, lo);
    qh_s[r * L::kLdQ + c] = __uint_as_float(hi);
    if (kQLo) ql_s[r * L::kLdQ + c] = __uint_as_float(lo);
  }
  for (int i = threadIdx.x; i < nblk; i += L::kThreads) tab_s[i] = table[i];
  __syncthreads();

  // queue tile t's copy: key t * L::kTileKeys + r sits in table block
  // key / bs at slot key % bs; keys past the walk and dims past hd are
  // zero-filled
  auto stage = [&](int t) {
    float* k_s = kv_s + (t & 1) * (L::kTileK + L::kTileV);
    float* v_s = k_s + L::kTileK;
    constexpr int kChunks = HDP / 4;
    for (int i = threadIdx.x; i < L::kTileKeys * kChunks; i += L::kThreads) {
      const int r = i / kChunks, c = (i - r * kChunks) * 4;
      const int key = t * L::kTileKeys + r;
      const bool live = key < nkeys && c < hd;
      int64_t off = 0;
      if (live) {
        const int j = key / bs;
        off = static_cast<int64_t>(tab_s[j]) * sb + (key - j * bs) * ss +
              head_off + c;
      }
      cp_async16(k_s + r * L::kLdK + c, k_pool + off, live ? 16 : 0);
      cp_async16(v_s + r * L::kLdV + c, v_pool + off, live ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};   // rows g, g + 8
  const int qp = pos0 + row_lo + rw * 16 + g;            // row g's position
  const float* qh_r = qh_s + (rw * 16 + g) * L::kLdQ + 2 * t4;
  const float* ql_r = ql_s + (rw * 16 + g) * L::kLdQ + 2 * t4;

  if (ntiles > 0) stage(0);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t landed; every warp is done with tile t - 1
    if (t + 1 < ntiles) stage(t + 1);
    const float* k_s = kv_s + (t & 1) * (L::kTileK + L::kTileV);
    const float* v_s = k_s + L::kTileK;
    const float* k_r = k_s + (8 * kw + g) * L::kLdK + 2 * t4;
    const float* v_r = v_s + (8 * kw + 2 * t4) * L::kLdV + g;

    // S = Q K^T, 16 rows x this warp's 8 keys
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      const float2 q0h = *reinterpret_cast<const float2*>(qh_r + 8 * kk);
      const float2 q1h =
          *reinterpret_cast<const float2*>(qh_r + 8 * L::kLdQ + 8 * kk);
      const uint32_t a_hi[4] = {__float_as_uint(q0h.x), __float_as_uint(q1h.x),
                                __float_as_uint(q0h.y), __float_as_uint(q1h.y)};
      uint32_t a_lo[4] = {0u, 0u, 0u, 0u};
      if (kQLo) {
        const float2 q0l = *reinterpret_cast<const float2*>(ql_r + 8 * kk);
        const float2 q1l =
            *reinterpret_cast<const float2*>(ql_r + 8 * L::kLdQ + 8 * kk);
        a_lo[0] = __float_as_uint(q0l.x);
        a_lo[1] = __float_as_uint(q1l.x);
        a_lo[2] = __float_as_uint(q0l.y);
        a_lo[3] = __float_as_uint(q1l.y);
      }
      const float2 kv = *reinterpret_cast<const float2*>(k_r + 8 * kk);
      uint32_t b[4];
      split_b(kv.x, kv.y, b);
      mma_3xtf32<kQLo>(s, a_hi, a_lo, b);
    }

    // online softmax: e 0, 1 are row g at keys key0 + 2t, + 1; e 2, 3
    // row g + 8
    const int key0 = t * L::kTileKeys + 8 * kw + 2 * t4;
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + (e & 1);
      const bool ok = key < nkeys && key <= qp + 8 * (e >> 1);
      s[e] = ok ? s[e] * scale : kMasked;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[e]);
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = s[e] <= kMaskedBelow ? 0.f : expf(s[e] - m[e >> 1]);
      l[e >> 1] += p;
      s[e] = p;
    }

    // acc = acc * corr + P V, P (f32, not rounded) split like V
    uint32_t p_hi[4], p_lo[4];
    split_tf32(s[0], p_hi[0], p_lo[0]);
    split_tf32(s[2], p_hi[1], p_lo[1]);
    split_tf32(s[1], p_hi[2], p_lo[2]);
    split_tf32(s[3], p_hi[3], p_lo[3]);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
      uint32_t b[4];
      split_b(v_r[8 * n], v_r[L::kLdV + 8 * n], b);
      mma_3xtf32<true>(acc[n], p_hi, p_lo, b);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the tile buffers now hold the key warps' partials

  // warps kw > 0 leave (m, l, acc) in shared memory (element-major, so
  // the 32 lanes hit 32 banks); warp kw = 0 of the row group folds them
  // into its own, in kw order, and writes out = acc / max(l, 1e-20)
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
  if (kw > 0) {
    float* red = kv_s + ((kw - 1) * kPreRowWarps + rw) * L::kRed * 32 + lane;
    red[0] = m[0];
    red[32] = m[1];
    red[64] = l[0];
    red[96] = l[1];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(4 + 4 * n + e) * 32] = acc[n][e];
  }
  __syncthreads();
  if (kw > 0) return;
  for (int w = 1; w < L::kKeyWarps; ++w) {
    const float* red =
        kv_s + ((w - 1) * kPreRowWarps + rw) * L::kRed * 32 + lane;
    float c_own[2], c_part[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_part = red[32 * i];
      const float m_new = fmaxf(m[i], m_part);
      c_own[i] = expf(m[i] - m_new);
      c_part[i] = expf(m_part - m_new);
      l[i] = l[i] * c_own[i] + red[64 + 32 * i] * c_part[i];
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = acc[n][e] * c_own[e >> 1] +
                    red[(4 + 4 * n + e) * 32] * c_part[e >> 1];
  }
  float lf[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lf[i] = fmaxf(l[i], kLFloor);
  float* o_h = out + static_cast<int64_t>(h) * s_c * hd;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = 8 * n + 2 * t4;
    if (col >= hd) continue;   // hd is even: col + 1 is inside too
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + rw * 16 + g + 8 * i;
      if (row < s_c)
        *reinterpret_cast<float2*>(o_h + static_cast<int64_t>(row) * hd +
                                   col) =
            make_float2(acc[n][2 * i] / lf[i], acc[n][2 * i + 1] / lf[i]);
    }
  }
}

// Opt a kernel into `bytes` of dynamic shared memory above the default
// 48 KB (on the current device).
template <typename K>
cudaError_t ensure_smem(K kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename Q, int GP, int VPL>
cudaError_t launch_decode_cfg(const void* q, const void* k_pool,
                              const void* v_pool, const void* tables,
                              const void* pos, void* out, void* ws,
                              int64_t ws_floats, void* tickets, int n_tickets,
                              int batch, int n_heads, int n_kv, int hd, int bs,
                              int mb, int splits, int bps, int64_t sb,
                              int64_t ss, int64_t sh, float scale,
                              cudaStream_t stream) {
  const int64_t pairs = static_cast<int64_t>(batch) * n_kv;
  if (splits < 1 || splits > 65535 || n_kv > 65535 || bps < 1 ||
      static_cast<int64_t>(splits) * bps < mb || bps > kDecMaxTable)
    return cudaErrorInvalidConfiguration;
  if (splits > 1 &&
      (ws == nullptr || tickets == nullptr || n_tickets < pairs ||
       ws_floats < pairs * splits * DecodeCfg<GP, VPL>::kPart))
    return cudaErrorInvalidValue;
  const size_t bytes = sizeof(int) * std::min(bps, mb);
  nns_paged_decode_kernel<Q, GP, VPL>
      <<<dim3(batch, n_kv, splits), kDecThreads, bytes, stream>>>(
          static_cast<const Q*>(q), static_cast<const float*>(k_pool),
          static_cast<const float*>(v_pool), static_cast<const int*>(tables),
          static_cast<const int*>(pos), static_cast<float*>(out),
          static_cast<float*>(ws), static_cast<int*>(tickets), n_heads, n_kv,
          hd, bs, mb, bps, sb, ss, sh, scale);
  return cudaGetLastError();
}

// the kernel by the group padded to a power of two and the 128-dim
// chunks of the head (GP * VPL <= 8: the registers)
template <typename Q>
cudaError_t launch_decode(const void* q, const void* k_pool,
                          const void* v_pool, const void* tables,
                          const void* pos, void* out, void* ws,
                          int64_t ws_floats, void* tickets, int n_tickets,
                          int batch, int n_heads, int n_kv, int hd, int bs,
                          int mb, int splits, int bps, int64_t sb, int64_t ss,
                          int64_t sh, float scale, cudaStream_t stream) {
  const int g = n_heads / n_kv;
  const int vpl = (hd + 127) / 128;
#define NNS_DECODE(GPV, VPLV)                                                 \
  if (g <= GPV && vpl == VPLV)                                                \
    return launch_decode_cfg<Q, GPV, VPLV>(                                   \
        q, k_pool, v_pool, tables, pos, out, ws, ws_floats, tickets,          \
        n_tickets, batch, n_heads, n_kv, hd, bs, mb, splits, bps, sb, ss, sh, \
        scale, stream);
  NNS_DECODE(1, 1)
  NNS_DECODE(2, 1)
  NNS_DECODE(4, 1)
  NNS_DECODE(8, 1)
  NNS_DECODE(1, 2)
  NNS_DECODE(2, 2)
  NNS_DECODE(4, 2)
#undef NNS_DECODE
  return cudaErrorInvalidValue;
}

template <typename Q, int HDP>
cudaError_t launch_prefill_hd(const void* q, const void* k_pool,
                              const void* v_pool, const void* table,
                              void* out, int n_heads, int n_kv, int s_c,
                              int hd, int bs, int mb, int pos0, int64_t sb,
                              int64_t ss, int64_t sh, float scale,
                              cudaStream_t stream) {
  const size_t bytes =
      PrefillCfg<HDP>::bytes(sizeof(Q) == sizeof(float), mb);
  if (bytes > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = ensure_smem(nns_paged_prefill_tf32_kernel<Q, HDP>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_heads, (s_c + kPreRows - 1) / kPreRows);
  nns_paged_prefill_tf32_kernel<Q, HDP>
      <<<grid, PrefillCfg<HDP>::kThreads, bytes, stream>>>(
      static_cast<const Q*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(table),
      static_cast<float*>(out), n_heads, n_kv, s_c, hd, bs, mb, pos0, sb, ss,
      sh, scale);
  return cudaGetLastError();
}

// the head dim padded to the kernel's 64, 128 or 256 (zero-filled)
template <typename Q>
cudaError_t launch_prefill(const void* q, const void* k_pool,
                           const void* v_pool, const void* table, void* out,
                           int n_heads, int n_kv, int s_c, int hd, int bs,
                           int mb, int pos0, int64_t sb, int64_t ss,
                           int64_t sh, float scale, cudaStream_t stream) {
  if (hd > kPreMaxHd) return cudaErrorInvalidConfiguration;
  if (hd <= 64)
    return launch_prefill_hd<Q, 64>(q, k_pool, v_pool, table, out, n_heads,
                                    n_kv, s_c, hd, bs, mb, pos0, sb, ss, sh,
                                    scale, stream);
  if (hd <= 128)
    return launch_prefill_hd<Q, 128>(q, k_pool, v_pool, table, out, n_heads,
                                     n_kv, s_c, hd, bs, mb, pos0, sb, ss, sh,
                                     scale, stream);
  return launch_prefill_hd<Q, 256>(q, k_pool, v_pool, table, out, n_heads,
                                   n_kv, s_c, hd, bs, mb, pos0, sb, ss, sh,
                                   scale, stream);
}

// the kernels' shape contract, checked before any launch
bool shapes_ok(int n_heads, int n_kv, int hd, int bs, int mb, int64_t sb,
               int64_t ss, int64_t sh) {
  return n_kv > 0 && n_heads % n_kv == 0 && hd > 0 && hd % 4 == 0 &&
         bs > 0 && bs <= kMaxBlock && mb > 0 && sb % 4 == 0 && ss % 4 == 0 &&
         sh % 4 == 0;
}

}  // namespace

extern "C" {

// q_code: 0 f32, 1 bf16. q (batch, n_heads, hd) contiguous, 16-byte
// aligned; k/v pool of one layer with block/slot/head strides sb/ss/sh in
// elements (innermost contiguous, 16-byte aligned rows: hd and the
// strides multiples of 4); tables (batch, mb) and pos (batch,) int32; out
// (batch, n_heads, hd) f32. block size <= 64; g = n_heads / n_kv padded
// to a power of two, times ceil(hd / 128), at most 8 (hd <= 256). The
// walk is split in `splits` CTAs of `bps` table blocks per (row, kv
// head), splits * bps >= mb and bps <= 4096; with splits > 1, ws holds
// ws_floats >= batch * n_kv * splits * (GP * 128 * ceil(hd / 128) +
// 2 GP rounded up to a multiple of 4) floats and tickets n_tickets >= batch * n_kv ints, all 0 before the
// first launch on a stream (each launch leaves them 0; two streams never
// share them). Launches on `stream`, returns cudaGetLastError() (or
// cudaErrorInvalidValue / InvalidConfiguration for arguments outside the
// contract); does not synchronise and allocates nothing.
int nns_paged_decode(const void* q, int q_code, const void* k_pool,
                     const void* v_pool, const void* tables, const void* pos,
                     void* out, void* ws, int64_t ws_floats, void* tickets,
                     int n_tickets, int batch, int n_heads, int n_kv, int hd,
                     int bs, int mb, int splits, int bps, int64_t sb,
                     int64_t ss, int64_t sh, float scale, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (!shapes_ok(n_heads, n_kv, hd, bs, mb, sb, ss, sh))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_code) {
    case 0:
      return launch_decode<float>(q, k_pool, v_pool, tables, pos, out, ws,
                                  ws_floats, tickets, n_tickets, batch,
                                  n_heads, n_kv, hd, bs, mb, splits, bps, sb,
                                  ss, sh, scale, s);
    case 1:
      return launch_decode<__nv_bfloat16>(
          q, k_pool, v_pool, tables, pos, out, ws, ws_floats, tickets,
          n_tickets, batch, n_heads, n_kv, hd, bs, mb, splits, bps, sb, ss,
          sh, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// q (n_heads, s_c, hd) contiguous, f32 or bf16; table (mb,) int32; out
// (n_heads, s_c, hd) f32; pos0 the chunk's absolute start. Same contract
// as nns_paged_decode.
int nns_paged_prefill(const void* q, int q_code, const void* k_pool,
                      const void* v_pool, const void* table, void* out,
                      int n_heads, int n_kv, int s_c, int hd, int bs, int mb,
                      int pos0, int64_t sb, int64_t ss, int64_t sh,
                      float scale, void* stream) {
  if (s_c <= 0) return cudaSuccess;
  if (!shapes_ok(n_heads, n_kv, hd, bs, mb, sb, ss, sh))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_code) {
    case 0:
      return launch_prefill<float>(q, k_pool, v_pool, table, out, n_heads,
                                   n_kv, s_c, hd, bs, mb, pos0, sb, ss, sh,
                                   scale, s);
    case 1:
      return launch_prefill<__nv_bfloat16>(q, k_pool, v_pool, table, out,
                                           n_heads, n_kv, s_c, hd, bs, mb,
                                           pos0, sb, ss, sh, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* nns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

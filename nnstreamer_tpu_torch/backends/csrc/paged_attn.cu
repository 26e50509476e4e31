// Paged attention for Hopper (sm_90a): one decode step and one prefill
// chunk of one layer, reading K/V straight from the paged pool through
// block tables.
//
// Replaces the TPU kernels in nnstreamer_tpu/backends/pallas_paged.py:
// - nns_paged_decode_kernel  <- paged_decode_attn  (_paged_decode_kernel)
// - nns_paged_prefill_kernel <- paged_prefill_attn (_paged_prefill_kernel)
//
// Both compute what the TPU kernels compute, not a carry-over of their
// grids: the TPU walks table blocks as a sequential grid axis with the
// softmax state in scratch memory; here one CTA owns its query rows for
// the whole walk and loops over the table itself, a tile of whole pool
// blocks (up to 64 keys) at a time. Semantics shared with the JAX
// package's _online_softmax_update (pallas_ops.py):
// - s = (q . k) * scale in f32 (q widened from f32 or bf16; pool f32);
// - masked scores are set to -1e30; p is forced to 0 where s <= -1e29;
// - m starts at -1e30, l at 0; corr = exp(m_old - m_new);
//   l = l * corr + sum(p); acc = acc * corr + p . v;
// - out = acc / max(l, 1e-20), f32.
// Decode masks kv_pos <= pos[b] (inclusive) and skips table blocks that
// start past pos[b]; prefill masks pos0 + row >= kv_pos and skips blocks
// that start past the q-block's last row. GQA: query head h reads kv head
// h / (n_heads / n_kv) straight from the narrow pool, never a
// group-expanded copy. The pool of one layer arrives as a pointer plus
// block/slot/head strides (innermost dim contiguous); nothing is copied.
//
// Bound: bytes for decode (each attended K/V element is read once for
// 2-4 flops); for a long prefill chunk the f32 operations, since each
// K/V tile serves a 32-row q-block. The design against both:
// - K/V tiles move global -> shared with cp.async, 16 bytes a thread,
//   double-buffered so the next tile's copy overlaps this tile's math;
//   a tile slot past the walk is zero-filled, so masked p = 0 never meets
//   an uninitialised (possibly NaN) value;
// - the CTA's slice of the block table is copied to shared memory once;
// - decode: one thread per (query head, key) for q.k (float4 rows of a
//   padded tile, conflict-free), one warp per query head for the
//   softmax, and the P.V accumulators in registers, with the tile's keys
//   split over the threads that would otherwise idle (partials summed
//   once at the end);
// - prefill: a 16x16 thread grid over a 32-row q-block (so a 512-row
//   chunk of 8 heads fills 128 SMs with 8 warps each), each thread a
//   2-row x 4-key block of S and a 2-row x (head_dim/16)-column block of
//   the output in registers, so shared memory serves 6 float4 loads per
//   32 FMAs; the online softmax runs in registers with half-warp
//   shuffles.
// Still ahead (later work): a split over the KV axis for small decode
// batches (the longest row walks alone in its CTA), TMA, and tensor-core
// products (TF32 would not hold the 1e-5 tolerance; a bf16-pool variant
// could use wgmma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kMasked = -1e30f;
constexpr float kMaskedBelow = -1e29f;
constexpr float kLFloor = 1e-20f;
constexpr int kTileKeys = 64;        // keys per tile (whole pool blocks)
constexpr int kDecodeThreads = 128;
constexpr int kDecodeMaxOut = 4;     // float4 accumulators per thread
constexpr int kPrefillRows = 32;     // query rows per prefill CTA
constexpr int kPrefillThreads = 256; // 16 x 16
constexpr int kRowsPerThread = kPrefillRows / (kPrefillThreads / 16);
constexpr int kPrefillMaxCols = 4;   // float4 column groups per thread
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max / sum over the 16 lanes of a half-warp (xor offsets stay inside it)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// Where one layer's pool is and how one CTA walks it.
struct PoolWalk {
  const float* k_pool;
  const float* v_pool;
  const int* table;      // this walk's block table (shared memory)
  int64_t sb, ss;        // block / slot strides (elements)
  int64_t head_off;      // kv head * head stride
  int bs, hd, ld;        // block size, head dim, smem row stride
  int bpt;               // pool blocks per tile
  int nblk;              // table blocks this CTA attends
};

// Queue the copy of tile t (blocks t*bpt .. t*bpt+bpt-1) into k_s/v_s,
// rows = keys; blocks past the walk are zero-filled.
__device__ __forceinline__ void stage_tile(const PoolWalk& w, int t,
                                           float* k_s, float* v_s) {
  const int vec = w.hd / 4;
  const int n = w.bpt * w.bs * vec;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = i / vec, d = (i - row * vec) * 4;
    const int blk = row / w.bs, slot = row - blk * w.bs;
    const int j = t * w.bpt + blk;
    const bool live = j < w.nblk;
    const int64_t off =
        live ? static_cast<int64_t>(w.table[j]) * w.sb + slot * w.ss +
                   w.head_off + d
             : 0;
    cp_async16(k_s + row * w.ld + d, w.k_pool + off, live ? 16 : 0);
    cp_async16(v_s + row * w.ld + d, w.v_pool + off, live ? 16 : 0);
  }
  cp_async_commit();
}

// Walk every tile with a double-buffered (nbuf 2) or single-buffered
// (nbuf 1) copy; body(tile, k_s, v_s) runs between barriers.
template <typename Body>
__device__ __forceinline__ void walk_tiles(const PoolWalk& w, int nbuf,
                                           float* kv_s, Body body) {
  const int tile_elems = w.bpt * w.bs * w.ld;
  const int ntiles = (w.nblk + w.bpt - 1) / w.bpt;
  if (ntiles == 0) return;
  stage_tile(w, 0, kv_s, kv_s + tile_elems);
  for (int t = 0; t < ntiles; ++t) {
    float* cur = kv_s + (t % nbuf) * 2 * tile_elems;
    const bool ahead = nbuf == 2 && t + 1 < ntiles;
    if (ahead) {
      float* nxt = kv_s + ((t + 1) % 2) * 2 * tile_elems;
      stage_tile(w, t + 1, nxt, nxt + tile_elems);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(t, cur, cur + tile_elems);
    __syncthreads();
    if (nbuf == 1 && t + 1 < ntiles)
      stage_tile(w, t + 1, kv_s, kv_s + tile_elems);
  }
}

// One CTA per (row b, kv head): the g query heads of the group against
// every table block j with j * bs <= pos[b].
template <typename Q>
__global__ void __launch_bounds__(kDecodeThreads) nns_paged_decode_kernel(
    const Q* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ pos, float* __restrict__ out, int n_heads,
    int n_kv, int hd, int bs, int mb, int64_t sb, int64_t ss, int64_t sh,
    float scale, int nbuf) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int g = n_heads / n_kv;
  const int vec = hd / 4;
  const int nout = g * vec;                      // float4 outputs
  const int parts = max(1, kDecodeThreads / nout);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = kDecodeThreads / 32;
  const int p = pos[b];

  PoolWalk w;
  w.k_pool = k_pool;
  w.v_pool = v_pool;
  w.sb = sb;
  w.ss = ss;
  w.head_off = kvh * sh;
  w.bs = bs;
  w.hd = hd;
  w.ld = hd + 4;                      // float4-aligned, conflict-free
  w.bpt = max(1, kTileKeys / bs);
  w.nblk = p < 0 ? 0 : min(mb, p / bs + 1);
  const int tile_keys = w.bpt * bs;

  float* kv_s = smem;                                  // nbuf x 2 tiles
  float* q_s = kv_s + nbuf * 2 * tile_keys * w.ld;     // g x hd
  float* s_s = q_s + g * hd;                           // g x tile_keys
  float* m_s = s_s + g * tile_keys;                    // g
  float* l_s = m_s + g;                                // g
  float* c_s = l_s + g;                                // g
  int* tab_s = reinterpret_cast<int*>(c_s + g);        // nblk
  w.table = tab_s;

  const int64_t row0 = (static_cast<int64_t>(b) * n_heads + kvh * g) * hd;
  for (int i = tid; i < g * hd; i += kDecodeThreads)
    q_s[i] = to_f32(q[row0 + i]);
  for (int i = tid; i < w.nblk; i += kDecodeThreads)
    tab_s[i] = tables[static_cast<int64_t>(b) * mb + i];
  for (int i = tid; i < g; i += kDecodeThreads) {
    m_s[i] = kMasked;
    l_s[i] = 0.f;
  }
  __syncthreads();

  // thread tid accumulates outputs o = tid % nout + k * kDecodeThreads
  // (when nout >= the block) over the keys of its part tid / nout
  const int part = tid / nout < parts ? tid / nout : parts;  // parts = idle
  float4 acc[kDecodeMaxOut];
#pragma unroll
  for (int k = 0; k < kDecodeMaxOut; ++k) acc[k] = make_float4(0, 0, 0, 0);

  walk_tiles(w, nbuf, kv_s, [&](int t, const float* k_s, const float* v_s) {
    const int key0 = t * tile_keys;
    for (int i = tid; i < g * tile_keys; i += kDecodeThreads) {
      const int h = i / tile_keys, k = i - h * tile_keys;
      const float4* qr = reinterpret_cast<const float4*>(q_s + h * hd);
      const float4* kr = reinterpret_cast<const float4*>(k_s + k * w.ld);
      float d0 = 0.f, d1 = 0.f;          // two chains for ILP
      int d4 = 0;
      for (; d4 + 1 < vec; d4 += 2) {
        d0 = dot4(qr[d4], kr[d4], d0);
        d1 = dot4(qr[d4 + 1], kr[d4 + 1], d1);
      }
      if (d4 < vec) d0 = dot4(qr[d4], kr[d4], d0);
      s_s[i] = key0 + k <= p ? (d0 + d1) * scale : kMasked;
    }
    __syncthreads();
    for (int h = warp; h < g; h += nwarps) {
      float* sr = s_s + h * tile_keys;
      float mx = kMasked;
      for (int k = lane; k < tile_keys; k += 32) mx = fmaxf(mx, sr[k]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m_s[h], mx);
      float sum = 0.f;
      for (int k = lane; k < tile_keys; k += 32) {
        const float s = sr[k];
        const float e = s <= kMaskedBelow ? 0.f : expf(s - m_new);
        sr[k] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_s[h] - m_new);
        c_s[h] = corr;
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();
    if (part < parts) {
#pragma unroll
      for (int k = 0; k < kDecodeMaxOut; ++k) {
        const int o = tid % nout + k * kDecodeThreads;
        if (o >= nout || (k > 0 && nout <= kDecodeThreads)) break;
        const int h = o / vec, d4 = o - h * vec;
        const float* pr = s_s + h * tile_keys;
        float4 a = acc[k] * c_s[h];
        for (int key = part; key < tile_keys; key += parts)
          fma4(a, pr[key],
               reinterpret_cast<const float4*>(v_s + key * w.ld)[d4]);
        acc[k] = a;
      }
    }
  });

  // sum the parts' partial accumulators, normalise, write
  float4* red = reinterpret_cast<float4*>(kv_s);       // parts x nout
  if (part < parts) {
#pragma unroll
    for (int k = 0; k < kDecodeMaxOut; ++k) {
      const int o = tid % nout + k * kDecodeThreads;
      if (o >= nout || (k > 0 && nout <= kDecodeThreads)) break;
      red[part * nout + o] = acc[k];
    }
  }
  __syncthreads();
  float4* o4 = reinterpret_cast<float4*>(out + row0);
  for (int o = tid; o < nout; o += kDecodeThreads) {
    float4 a = red[o];
    for (int pt = 1; pt < parts; ++pt) {
      const float4 x = red[pt * nout + o];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    o4[o] = a * (1.f / fmaxf(l_s[o / vec], kLFloor));
  }
}

// One CTA per (query head h, q-block of 32 rows): causal attention of the
// chunk's rows (absolute positions pos0 + row) against the sequence's
// table blocks up to the q-block's last row. Thread (ty, tx) of the
// 16 x 16 grid owns rows ty*R .. ty*R+R-1 (R = kRowsPerThread): keys
// tx + 16 j of each tile in S, and float4 column groups tx + 16 c of the
// output.
template <typename Q>
__global__ void __launch_bounds__(kPrefillThreads) nns_paged_prefill_kernel(
    const Q* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ table,
    float* __restrict__ out, int n_heads, int n_kv, int s_c, int hd, int bs,
    int mb, int pos0, int64_t sb, int64_t ss, int64_t sh, float scale,
    int nbuf) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, row_lo = blockIdx.y * kPrefillRows;
  const int rows = min(kPrefillRows, s_c - row_lo);
  const int vec = hd / 4;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q_lo = pos0 + row_lo;
  const int q_hi = q_lo + rows - 1;

  PoolWalk w;
  w.k_pool = k_pool;
  w.v_pool = v_pool;
  w.sb = sb;
  w.ss = ss;
  w.head_off = (h / (n_heads / n_kv)) * sh;
  w.bs = bs;
  w.hd = hd;
  w.ld = hd + 4;                      // float4-aligned, conflict-free
  w.bpt = max(1, kTileKeys / bs);
  w.nblk = q_hi < 0 ? 0 : min(mb, q_hi / bs + 1);
  const int tile_keys = w.bpt * bs;
  const int nj = (tile_keys + 15) / 16;  // keys per thread in S
  const int nc = (vec + 15) / 16;        // column groups per thread
  // p_s row stride: the two half-warps' rows land 16 banks apart
  const int ldp = kTileKeys + 8;

  float* kv_s = smem;                                   // nbuf x 2 tiles
  float* q_s = kv_s + nbuf * 2 * tile_keys * w.ld;      // rows x ld
  float* p_s = q_s + kPrefillRows * w.ld;               // rows x ldp
  int* tab_s = reinterpret_cast<int*>(p_s + kPrefillRows * ldp);  // nblk
  w.table = tab_s;

  const int64_t row0 = (static_cast<int64_t>(h) * s_c + row_lo) * hd;
  for (int i = tid; i < kPrefillRows * hd; i += kPrefillThreads) {
    const int r = i / hd, d = i - r * hd;
    q_s[r * w.ld + d] = r < rows ? to_f32(q[row0 + i]) : 0.f;
  }
  for (int i = tid; i < w.nblk; i += kPrefillThreads) tab_s[i] = table[i];
  __syncthreads();

  float m[kRowsPerThread], l[kRowsPerThread];
  float4 acc[kRowsPerThread][kPrefillMaxCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kPrefillMaxCols; ++c)
      acc[i][c] = make_float4(0, 0, 0, 0);
  }

  walk_tiles(w, nbuf, kv_s, [&](int t, const float* k_s, const float* v_s) {
    const int key0 = t * tile_keys;
    float s[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d4 = 0; d4 < vec; ++d4) {
      float4 qv[kRowsPerThread], kv[4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = reinterpret_cast<const float4*>(
            q_s + (ty * kRowsPerThread + i) * w.ld)[d4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = j < nj ? reinterpret_cast<const float4*>(
                             k_s + min(tx + 16 * j, tile_keys - 1) * w.ld)[d4]
                       : make_float4(0, 0, 0, 0);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int qp = q_lo + ty * kRowsPerThread + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        const bool ok = key < tile_keys && qp >= key0 + key;
        s[i][j] = ok ? s[i][j] * scale : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = s[i][j] <= kMaskedBelow ? 0.f : expf(s[i][j] - m_new);
        const int key = tx + 16 * j;
        if (key < tile_keys)
          p_s[(ty * kRowsPerThread + i) * ldp + key] = e;
        sum += e;
      }
      sum = half_sum(sum);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kPrefillMaxCols; ++c) acc[i][c] = acc[i][c] * corr;
    }
    __syncthreads();
    for (int key = 0; key < tile_keys; ++key) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = p_s[(ty * kRowsPerThread + i) * ldp + key];
      const float4* vr = reinterpret_cast<const float4*>(v_s + key * w.ld);
#pragma unroll
      for (int c = 0; c < kPrefillMaxCols; ++c) {
        if (c < nc && tx + 16 * c < vec) {
          const float4 vv = vr[tx + 16 * c];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) fma4(acc[i][c], pv[i], vv);
        }
      }
    }
  });

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty * kRowsPerThread + i;
    if (r >= rows) continue;
    const float inv = 1.f / fmaxf(l[i], kLFloor);
    float4* o4 = reinterpret_cast<float4*>(out + row0 + r * hd);
#pragma unroll
    for (int c = 0; c < kPrefillMaxCols; ++c)
      if (c < nc && tx + 16 * c < vec) o4[tx + 16 * c] = acc[i][c] * inv;
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

// Shared memory for nbuf K/V tile pairs plus `rest` floats: double
// buffering when it fits, else single.
int pick_nbuf(size_t tile_pair_bytes, size_t rest_bytes, size_t* bytes) {
  for (int nbuf = 2; nbuf >= 1; --nbuf) {
    *bytes = nbuf * tile_pair_bytes + rest_bytes;
    if (*bytes <= kMaxSmem) return nbuf;
  }
  return 0;
}

template <typename Q>
cudaError_t launch_decode(const void* q, const void* k_pool,
                          const void* v_pool, const void* tables,
                          const void* pos, void* out, int batch, int n_heads,
                          int n_kv, int hd, int bs, int mb, int64_t sb,
                          int64_t ss, int64_t sh, float scale,
                          cudaStream_t stream) {
  const int g = n_heads / n_kv;
  const size_t tile_keys =
      static_cast<size_t>(std::max(1, kTileKeys / bs)) * bs;
  size_t bytes = 0;
  const size_t tile_pair = sizeof(float) * 2 * tile_keys * (hd + 4);
  const int nbuf = pick_nbuf(
      tile_pair,
      sizeof(float) * (static_cast<size_t>(g) * hd + g * tile_keys + 3 * g) +
          sizeof(int) * mb,
      &bytes);
  // the final reduction reuses the tile buffers: parts x g*hd floats
  if (nbuf == 0 || g * hd / 4 > kDecodeMaxOut * kDecodeThreads ||
      sizeof(float) * std::max(kDecodeThreads * 4, g * hd) > nbuf * tile_pair)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = ensure_smem(nns_paged_decode_kernel<Q>, bytes);
  if (err != cudaSuccess) return err;
  nns_paged_decode_kernel<Q><<<dim3(batch, n_kv), kDecodeThreads, bytes,
                               stream>>>(
      static_cast<const Q*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<float*>(out), n_heads, n_kv,
      hd, bs, mb, sb, ss, sh, scale, nbuf);
  return cudaGetLastError();
}

template <typename Q>
cudaError_t launch_prefill(const void* q, const void* k_pool,
                           const void* v_pool, const void* table, void* out,
                           int n_heads, int n_kv, int s_c, int hd, int bs,
                           int mb, int pos0, int64_t sb, int64_t ss,
                           int64_t sh, float scale, cudaStream_t stream) {
  const size_t ld = hd + 4;
  const size_t tile_keys =
      static_cast<size_t>(std::max(1, kTileKeys / bs)) * bs;
  size_t bytes = 0;
  const int nbuf = pick_nbuf(
      sizeof(float) * 2 * tile_keys * ld,
      sizeof(float) * kPrefillRows * (ld + kTileKeys + 8) + sizeof(int) * mb,
      &bytes);
  if (nbuf == 0 || hd / 4 > 16 * kPrefillMaxCols)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = ensure_smem(nns_paged_prefill_kernel<Q>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_heads, (s_c + kPrefillRows - 1) / kPrefillRows);
  nns_paged_prefill_kernel<Q><<<grid, kPrefillThreads, bytes, stream>>>(
      static_cast<const Q*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(table),
      static_cast<float*>(out), n_heads, n_kv, s_c, hd, bs, mb, pos0, sb, ss,
      sh, scale, nbuf);
  return cudaGetLastError();
}

// the kernels' shape contract, checked before any launch
bool shapes_ok(int n_heads, int n_kv, int hd, int bs, int mb, int64_t sb,
               int64_t ss, int64_t sh) {
  return n_kv > 0 && n_heads % n_kv == 0 && hd > 0 && hd % 4 == 0 &&
         bs > 0 && bs <= kTileKeys && mb > 0 && sb % 4 == 0 && ss % 4 == 0 &&
         sh % 4 == 0;
}

}  // namespace

extern "C" {

// q_code: 0 f32, 1 bf16. q (batch, n_heads, hd) contiguous; k/v pool of
// one layer with block/slot/head strides sb/ss/sh in elements (innermost
// contiguous, 16-byte aligned rows: hd and the strides multiples of 4);
// tables (batch, mb) and pos (batch,) int32; out (batch, n_heads, hd)
// f32. block size <= 64. Launches on `stream`, returns
// cudaGetLastError() (or cudaErrorInvalidValue / InvalidConfiguration
// for shapes outside the contract); does not synchronise and allocates
// nothing.
int nns_paged_decode(const void* q, int q_code, const void* k_pool,
                     const void* v_pool, const void* tables, const void* pos,
                     void* out, int batch, int n_heads, int n_kv, int hd,
                     int bs, int mb, int64_t sb, int64_t ss, int64_t sh,
                     float scale, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (!shapes_ok(n_heads, n_kv, hd, bs, mb, sb, ss, sh))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_code) {
    case 0:
      return launch_decode<float>(q, k_pool, v_pool, tables, pos, out, batch,
                                  n_heads, n_kv, hd, bs, mb, sb, ss, sh,
                                  scale, s);
    case 1:
      return launch_decode<__nv_bfloat16>(q, k_pool, v_pool, tables, pos, out,
                                          batch, n_heads, n_kv, hd, bs, mb,
                                          sb, ss, sh, scale, s);
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

// Flash attention for Hopper (sm_90a) on the CUDA cores:
// softmax(q k^T * D^-0.5) v over (B, S, H, D) f32 tensors, causal or not,
// without the S x S score matrix ever reaching device memory. bf16 calls
// go to the tensor-core kernel in flash_attn_tc.cu; this kernel keeps f32,
// whose 1e-5 tolerance a TF32 product would not hold.
//
// Replaces, for f32, both TPU kernels in
// nnstreamer_tpu/backends/pallas_ops.py:
// - `_flash_kernel` / `flash_attention` (K/V of a head resident in VMEM);
// - `_flash_kgrid_kernel` / `_flash_attention_kgrid` (K/V streamed one
//   block per sequential grid step, for long S).
// On the TPU the two differ only in where K/V live; here one CTA owns a
// block of query rows for its whole walk and streams K/V through shared
// memory a tile at a time whatever S is, so one kernel is both. The grid
// is (q-blocks, heads, batch); no state carries between CTAs.
//
// A second kernel, nns_flash_block_kernel, replaces `_flash_block_kernel`
// / `flash_block_update` (the ring-attention step) for f32: the same tile
// walk over ONE incoming K/V block, starting from and writing back a
// carry (m, l, acc) that lives in device memory between ring steps, with
// the causal mask placed by the block's global query/key offsets. Both
// kernels share the tile code below (attend_tile, walk_tiles). bf16 ring
// steps run on the tensor cores (nns_flash_block_tc_kernel in
// flash_attn_tc.cu); this kernel's launcher still takes bf16, which only
// a side-by-side timing uses.
//
// Semantics shared with _online_softmax_update / _causal_mask:
// - s = (q . k) * scale in f32; bf16 inputs widen exactly, so each
//   product is exact and the sum is f32, as the MXU's f32 accumulation;
// - masked scores (above the diagonal, or keys past S in a ragged last
//   tile) are set to -1e30 and their p forced to 0 (p = 0 where
//   s <= -1e29); m starts at -1e30, l at 0; corr = exp(m_old - m_new),
//   l = l * corr + sum(p) with p in f32, acc = acc * corr + p . v where p
//   is first rounded to the input dtype (bf16 runs round p to bf16, as
//   JAX's p.astype(v.dtype));
// - out = acc / max(l, 1e-20), cast to the input dtype;
// - causal: key tiles wholly above the block's last row are skipped.
//
// Bound: operations. Per (b, h) the work is 4 * S^2 * D flops (half of it
// under the causal mask) over 4 * S * D elements of traffic. The products
// run on the CUDA cores in f32, so the ceiling is the 67 TFLOP/s f32
// rate. The design:
// - a CTA of 16 x 16 threads owns 64 query rows of one (b, h); thread
//   (ty, tx) holds rows ty*4 .. ty*4+3: keys tx + 16 j of each 64-key
//   tile in S, and float4 column groups tx + 16 c of the output in
//   registers, so each shared-memory load feeds 4-16 FMAs;
// - K/V tiles move global -> shared with 16-byte cp.async,
//   double-buffered (single-buffered when two tiles do not fit) so the
//   next tile's copy overlaps this tile's math; a key past S is
//   zero-filled by the copy, so p = 0 never meets stale memory;
// - tile rows are padded by 16 bytes, so 16-byte reads of 8 neighbouring
//   rows hit distinct banks; the online softmax reduces over half-warps
//   with shuffles;
// - inputs are read through their (b, s, h) strides (innermost dim
//   contiguous), so JAX's two (B,S,H,D) <-> (BH,S,D) transposes are not
//   paid; causal q-blocks are launched heaviest first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float kMasked = -1e30f;
constexpr float kMaskedBelow = -1e29f;
constexpr float kLFloor = 1e-20f;
constexpr int kBQ = 64;                 // query rows per CTA
constexpr int kBK = 64;                 // keys per tile
constexpr int kThreads = 256;           // 16 x 16
constexpr int kRows = kBQ / 16;         // rows per thread
constexpr int kKeys = kBK / 16;         // keys per thread in S
constexpr int kLdp = kBK + 4;           // p_s row stride (floats)
constexpr int kMaxD = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

struct Strides {
  int64_t b, s, h;   // elements; the head dim is contiguous
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// p as the PV product sees it: rounded to the input dtype
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// 16 bytes of shared memory -> CH = 16 / sizeof(T) floats
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 4 consecutive values of a shared-memory row -> float4
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

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

__device__ __forceinline__ void fma4(float4& acc, float p, float4 v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
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

// Queue the copy of key tile t (keys t*kBK ..) of one (b, h) into
// k_s / v_s (rows of ld elements); keys past S are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* k_bh, const T* v_bh,
                                           int64_t k_ss, int64_t v_ss,
                                           int s_len, int d, int ld, int t,
                                           T* k_s, T* v_s) {
  constexpr int CH = 16 / sizeof(T);
  const int chunks = d / CH;
  for (int i = threadIdx.x; i < kBK * chunks; i += kThreads) {
    const int row = i / chunks, c = (i - row * chunks) * CH;
    const int key = t * kBK + row;
    const bool live = key < s_len;
    const int64_t kk = live ? key : 0;
    cp_async16(k_s + row * ld + c, k_bh + kk * k_ss + c, live ? 16 : 0);
    cp_async16(v_s + row * ld + c, v_bh + kk * v_ss + c, live ? 16 : 0);
  }
  cp_async_commit();
}

// One key tile of the online softmax for this thread's kRows query rows
// (rows ty*kRows ..): s = (q . k) * scale in f32 against the tile's keys
// key0 .. key0 + kBK - 1; a key is masked (s = -1e30, p = 0) at or past
// s_len, or, when causal, where its position kpos0 + key exceeds the
// row's position qpos0 + row; then m, l and acc carry on and acc += p . v
// with p rounded to T. Every thread of the CTA calls it: it synchronises
// between the softmax (which fills p_s) and the P.V product.
template <typename T, int NC>
__device__ __forceinline__ void attend_tile(
    const float* q_s, int ldq, const T* k_s, const T* v_s, int ld,
    float* p_s, int d, int key0, int s_len, int causal, int qpos0,
    int kpos0, float scale, float (&m)[kRows], float (&l)[kRows],
    float4 (&acc)[kRows][NC]) {
  constexpr int CH = 16 / sizeof(T);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int vec = d / 4;

  // S = Q K^T for this thread's 4 rows x 4 keys
  float s[kRows][kKeys];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
  for (int c0 = 0; c0 < d; c0 += CH) {
    float kf[kKeys][CH];
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
      load16(k_s + (tx + 16 * j) * ld + c0, kf[j]);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float* qr = q_s + (ty * kRows + i) * ldq + c0;
#pragma unroll
      for (int c4 = 0; c4 < CH; c4 += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + c4);
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = fmaf(qv.x, kf[j][c4], s[i][j]);
          s[i][j] = fmaf(qv.y, kf[j][c4 + 1], s[i][j]);
          s[i][j] = fmaf(qv.z, kf[j][c4 + 2], s[i][j]);
          s[i][j] = fmaf(qv.w, kf[j][c4 + 3], s[i][j]);
        }
      }
    }
  }

  // online softmax over the tile, per row, across the half-warp
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    const int qpos = qpos0 + r;
    float mx = kMasked;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int key = key0 + tx + 16 * j;
      const bool ok = key < s_len && (!causal || kpos0 + key <= qpos);
      s[i][j] = ok ? s[i][j] * scale : kMasked;
      mx = fmaxf(mx, s[i][j]);
    }
    mx = half_max(mx);
    const float m_new = fmaxf(m[i], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float e = s[i][j] <= kMaskedBelow ? 0.f : expf(s[i][j] - m_new);
      p_s[r * kLdp + tx + 16 * j] = round_p(e, T());
      sum += e;
    }
    sum = half_sum(sum);
    const float corr = expf(m[i] - m_new);
    l[i] = l[i] * corr + sum;
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[i][c].x *= corr;
      acc[i][c].y *= corr;
      acc[i][c].z *= corr;
      acc[i][c].w *= corr;
    }
  }
  __syncthreads();

  // acc += P V
  for (int key = 0; key < kBK; ++key) {
    float pv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty * kRows + i) * kLdp + key];
    const T* vr = v_s + key * ld;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int g = tx + 16 * c;
      if (g < vec) {
        const float4 vv = load4(vr + 4 * g);
#pragma unroll
        for (int i = 0; i < kRows; ++i) fma4(acc[i][c], pv[i], vv);
      }
    }
  }
}

// Copy 64 query rows (row stride qss elements, rows past `rows` zero) into
// q_s as f32.
template <typename T>
__device__ __forceinline__ void stage_q(const T* q_rows, int64_t qss,
                                        int rows, int d, int ldq,
                                        float* q_s) {
  for (int i = threadIdx.x; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    q_s[r * ldq + c] = r < rows ? to_f32(q_rows[r * qss + c]) : 0.f;
  }
}

// The walk over key tiles 0 .. ntiles-1 of one (b, h): the next tile's
// copy is queued before this tile's math when two tiles fit (nbuf 2),
// after it otherwise. Tile 0 must already be queued.
template <typename T, int NC>
__device__ __forceinline__ void walk_tiles(
    const T* k_bh, const T* v_bh, int64_t kss, int64_t vss, T* kv_s,
    int nbuf, int ntiles, const float* q_s, int ldq, float* p_s, int d,
    int s_len, int causal, int qpos0, int kpos0, float scale,
    float (&m)[kRows], float (&l)[kRows], float4 (&acc)[kRows][NC]) {
  constexpr int CH = 16 / sizeof(T);
  const int ld = d + CH;
  const int tile_elems = kBK * ld;
  for (int t = 0; t < ntiles; ++t) {
    T* k_s = kv_s + (nbuf == 2 ? (t % 2) : 0) * 2 * tile_elems;
    T* v_s = k_s + tile_elems;
    if (nbuf == 2 && t + 1 < ntiles) {
      T* nxt = kv_s + ((t + 1) % 2) * 2 * tile_elems;
      stage_tile(k_bh, v_bh, kss, vss, s_len, d, ld, t + 1, nxt,
                 nxt + tile_elems);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    attend_tile<T, NC>(q_s, ldq, k_s, v_s, ld, p_s, d, t * kBK, s_len,
                       causal, qpos0, kpos0, scale, m, l, acc);
    __syncthreads();   // this tile's buffers are refilled next
    if (nbuf == 1 && t + 1 < ntiles)
      stage_tile(k_bh, v_bh, kss, vss, s_len, d, ld, t + 1, kv_s,
                 kv_s + tile_elems);
  }
  cp_async_wait<0>();
}

// One CTA per (q-block, head, batch row): 64 query rows against every
// key tile they may attend.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) nns_flash_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, Strides qs, Strides ks,
    Strides vs, Strides os, int s_len, int d, float scale, int causal,
    int nbuf) {
  constexpr int CH = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nqb = gridDim.x;
  const int qb = causal ? nqb - 1 - blockIdx.x : blockIdx.x;  // heavy first
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = qb * kBQ;
  const int rows = min(kBQ, s_len - row0);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int ld = d + CH;                  // tile row stride (elements)
  const int ldq = d + 4;                  // q_s row stride (floats)
  const int vec = d / 4;                  // float4 column groups

  const int tile_elems = kBK * ld;
  T* kv_s = reinterpret_cast<T*>(smem_raw);                  // nbuf x (K, V)
  float* q_s = reinterpret_cast<float*>(kv_s + nbuf * 2 * tile_elems);
  float* p_s = q_s + kBQ * ldq;                              // kBQ x kLdp

  const T* q_bh = q + b * qs.b + h * qs.h + row0 * qs.s;
  const T* k_bh = k + b * ks.b + h * ks.h;
  const T* v_bh = v + b * vs.b + h * vs.h;

  const int last_row = row0 + rows - 1;
  const int all_tiles = (s_len + kBK - 1) / kBK;
  const int ntiles = causal ? min(all_tiles, last_row / kBK + 1) : all_tiles;

  stage_tile(k_bh, v_bh, ks.s, vs.s, s_len, d, ld, 0, kv_s,
             kv_s + tile_elems);
  stage_q(q_bh, qs.s, rows, d, ldq, q_s);

  float m[kRows], l[kRows];
  float4 acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0, 0, 0, 0);
  }
  walk_tiles<T, NC>(k_bh, v_bh, ks.s, vs.s, kv_s, nbuf, ntiles, q_s, ldq,
                    p_s, d, s_len, causal, row0, 0, scale, m, l, acc);

  T* o_bh = out + b * os.b + h * os.h + row0 * os.s;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r >= rows) continue;
    const float lf = fmaxf(l[i], kLFloor);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int g = tx + 16 * c;
      if (g < vec) {
        const float4 a = acc[i][c];
        store4(o_bh + r * os.s + 4 * g,
               make_float4(a.x / lf, a.y / lf, a.z / lf, a.w / lf));
      }
    }
  }
}

// One ring-attention step (replaces pallas_ops._flash_block_kernel /
// flash_block_update): one CTA per (q-block, bh) continues the online
// softmax of 64 query rows over every key tile of ONE incoming K/V block,
// reading the f32 carry m, l (BH, Sq) and acc (BH, Sq, D) and writing it
// back in place. Query row r sits at position q_off + r and key j at
// k_off + j. Causal: key tiles whose first key lies past the q-block's
// last row are skipped; a q-block with none left returns before touching
// the carry, so a block wholly above the diagonal leaves m, l and acc
// bit-identical (a fully masked row inside a computed tile keeps them
// too: corr = 1 and p = 0). bh = b * heads + h addresses q/k/v through
// their (b, h, s) strides, so the ring's (B, S, H, D) -> (B, H, S, D)
// views are read without a copy. Bound: bytes at the ring's shapes — the
// f32 carry (acc alone is twice a bf16 q) is read and written each step.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) nns_flash_block_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ m_g,
    float* __restrict__ l_g, float* __restrict__ acc_g, Strides qs,
    Strides ks, Strides vs, int heads, int sq, int sk, int d, float scale,
    int causal, int q_off, int k_off, int nbuf) {
  constexpr int CH = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int row0 = blockIdx.x * kBQ;
  const int rows = min(kBQ, sq - row0);
  const int all_tiles = (sk + kBK - 1) / kBK;
  int ntiles = all_tiles;
  if (causal) {
    const int last_q = q_off + row0 + rows - 1;
    if (last_q < k_off) return;        // wholly above the diagonal
    ntiles = min(all_tiles, (last_q - k_off) / kBK + 1);
  }
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int ld = d + CH;
  const int ldq = d + 4;
  const int vec = d / 4;
  const int tile_elems = kBK * ld;
  T* kv_s = reinterpret_cast<T*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(kv_s + nbuf * 2 * tile_elems);
  float* p_s = q_s + kBQ * ldq;

  const T* k_bh = k + b * ks.b + h * ks.h;
  const T* v_bh = v + b * vs.b + h * vs.h;
  stage_tile(k_bh, v_bh, ks.s, vs.s, sk, d, ld, 0, kv_s, kv_s + tile_elems);
  stage_q(q + b * qs.b + h * qs.h + row0 * qs.s, qs.s, rows, d, ldq, q_s);

  const int64_t row_base = static_cast<int64_t>(bh) * sq + row0;
  float* m_rows = m_g + row_base;
  float* l_rows = l_g + row_base;
  float* a_rows = acc_g + row_base * d;
  float m[kRows], l[kRows];
  float4 acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    const bool live = r < rows;
    m[i] = live ? m_rows[r] : kMasked;
    l[i] = live ? l_rows[r] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int g = tx + 16 * c;
      acc[i][c] = live && g < vec
          ? *reinterpret_cast<const float4*>(a_rows + r * d + 4 * g)
          : make_float4(0, 0, 0, 0);
    }
  }
  walk_tiles<T, NC>(k_bh, v_bh, ks.s, vs.s, kv_s, nbuf, ntiles, q_s, ldq,
                    p_s, d, sk, causal, q_off + row0, k_off, scale, m, l,
                    acc);

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r >= rows) continue;
    if (tx == 0) {
      m_rows[r] = m[i];
      l_rows[r] = l[i];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int g = tx + 16 * c;
      if (g < vec)
        *reinterpret_cast<float4*>(a_rows + r * d + 4 * g) = acc[i][c];
    }
  }
}

// Shared memory of one CTA: nbuf K/V tile pairs, q_s and p_s. Two tile
// pairs when they fit (double buffering), else one; 0 bytes when even one
// does not.
template <typename T>
size_t smem_bytes(int d, int* nbuf) {
  constexpr int CH = 16 / sizeof(T);
  const size_t tile_pair = 2 * sizeof(T) * kBK * static_cast<size_t>(d + CH);
  const size_t rest =
      sizeof(float) * (kBQ * static_cast<size_t>(d + 4) + kBQ * kLdp);
  *nbuf = 2;
  if (2 * tile_pair + rest <= kMaxSmem) return 2 * tile_pair + rest;
  *nbuf = 1;
  return tile_pair + rest <= kMaxSmem ? tile_pair + rest : 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, void* out,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      int batch, int s_len, int n_heads, int d, float scale,
                      int causal, cudaStream_t stream) {
  int nbuf;
  const size_t bytes = smem_bytes<T>(d, &nbuf);
  if (bytes == 0) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem(nns_flash_attn_kernel<T, NC>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + kBQ - 1) / kBQ, n_heads, batch);
  nns_flash_attn_kernel<T, NC><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, s_len,
      d, scale, causal, nbuf);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_block_nc(const void* q, const void* k, const void* v,
                            float* m, float* l, float* acc, Strides qs,
                            Strides ks, Strides vs, int bh, int heads,
                            int sq, int sk, int d, float scale, int causal,
                            int q_off, int k_off, cudaStream_t stream) {
  int nbuf;
  const size_t bytes = smem_bytes<T>(d, &nbuf);
  if (bytes == 0) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem(nns_flash_block_kernel<T, NC>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  nns_flash_block_kernel<T, NC><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), m, l, acc, qs, ks, vs, heads, sq, sk, d,
      scale, causal, q_off, k_off, nbuf);
  return cudaGetLastError();
}

// 16-byte rows for cp.async: every (b, s, h) stride and every pointer
// keeps them aligned.
template <typename T>
bool aligned(std::initializer_list<Strides> strides,
             std::initializer_list<const void*> ptrs) {
  constexpr int CH = 16 / sizeof(T);
  for (const Strides& st : strides)
    if (st.b % CH || st.s % CH || st.h % CH) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   Strides qs, Strides ks, Strides vs, Strides os, int batch,
                   int s_len, int n_heads, int d, float scale, int causal,
                   cudaStream_t stream) {
  if (!aligned<T>({qs, ks, vs, os}, {q, k, v, out}))
    return cudaErrorInvalidValue;
  if (d <= 64)
    return launch_nc<T, 1>(q, k, v, out, qs, ks, vs, os, batch, s_len,
                           n_heads, d, scale, causal, stream);
  if (d <= 128)
    return launch_nc<T, 2>(q, k, v, out, qs, ks, vs, os, batch, s_len,
                           n_heads, d, scale, causal, stream);
  return launch_nc<T, 4>(q, k, v, out, qs, ks, vs, os, batch, s_len, n_heads,
                         d, scale, causal, stream);
}

template <typename T>
cudaError_t launch_block(const void* q, const void* k, const void* v,
                         float* m, float* l, float* acc, Strides qs,
                         Strides ks, Strides vs, int bh, int heads, int sq,
                         int sk, int d, float scale, int causal, int q_off,
                         int k_off, cudaStream_t stream) {
  if (!aligned<T>({qs, ks, vs}, {q, k, v, acc})) return cudaErrorInvalidValue;
  if (d <= 64)
    return launch_block_nc<T, 1>(q, k, v, m, l, acc, qs, ks, vs, bh, heads,
                                 sq, sk, d, scale, causal, q_off, k_off,
                                 stream);
  if (d <= 128)
    return launch_block_nc<T, 2>(q, k, v, m, l, acc, qs, ks, vs, bh, heads,
                                 sq, sk, d, scale, causal, q_off, k_off,
                                 stream);
  return launch_block_nc<T, 4>(q, k, v, m, l, acc, qs, ks, vs, bh, heads, sq,
                               sk, d, scale, causal, q_off, k_off, stream);
}

}  // namespace

extern "C" {

// q, k, v, out: f32 (batch, s_len, n_heads, d) (bf16 is the tensor-core
// kernel's, nns_flash_attn_tc) with element strides (b, s, h) given per
// tensor and a contiguous last dim; d a multiple of 4 and <= 256; every
// stride a multiple of 16 bytes and every pointer 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue / InvalidConfiguration for arguments outside the
// contract); does not synchronise and allocates nothing.
int nns_flash_attn(const void* q, const void* k, const void* v, void* out,
                   int batch, int s_len, int n_heads, int d,
                   int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                   int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                   int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                   float scale, int causal, void* stream) {
  if (batch <= 0 || s_len <= 0 || n_heads <= 0) return cudaSuccess;
  if (d <= 0 || d > kMaxD || d % 4 || batch > 65535 || n_heads > 65535)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  return launch<float>(q, k, v, out, qs, ks, vs, os, batch, s_len, n_heads,
                       d, scale, causal, static_cast<cudaStream_t>(stream));
}

// One ring step. dtype_code: 0 f32, 1 bf16 (q, k, v alike). q: bh rows of
// (sq, d), k and v: bh rows of (sk, d), row bh = b * heads + h read at
// b * s?_b + h * s?_h with position stride s?_s (elements; last dim
// contiguous, every stride a multiple of 16 bytes, pointers 16-byte
// aligned). m, l: (bh, sq) f32 and acc: (bh, sq, d) f32, contiguous,
// updated in place. Launches on `stream`, returns cudaGetLastError();
// does not synchronise and allocates nothing.
int nns_flash_block(const void* q, const void* k, const void* v, void* m,
                    void* l, void* acc, int dtype_code, int bh, int heads,
                    int sq, int sk, int d, int64_t q_sb, int64_t q_ss,
                    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale,
                    int causal, int q_off, int k_off, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0) return cudaSuccess;
  if (d <= 0 || d > kMaxD || bh > 65535 || heads <= 0 || bh % heads)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      if (d % 4) return cudaErrorInvalidValue;
      return launch_block<float>(q, k, v, mf, lf, af, qs, ks, vs, bh, heads,
                                 sq, sk, d, scale, causal, q_off, k_off, s);
    case 1:
      if (d % 8) return cudaErrorInvalidValue;
      return launch_block<__nv_bfloat16>(q, k, v, mf, lf, af, qs, ks, vs, bh,
                                         heads, sq, sk, d, scale, causal,
                                         q_off, k_off, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* nns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

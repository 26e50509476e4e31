// Flash attention for Hopper (sm_90a) on the tensor cores, bf16:
// softmax(q k^T * D^-0.5) v over (B, S, H, D) bf16 tensors, causal or
// not, without the S x S score matrix ever reaching device memory.
//
// Replaces, for bf16, both TPU kernels in
// nnstreamer_tpu/backends/pallas_ops.py:
// - `_flash_kernel` / `flash_attention` (K/V of a head resident in VMEM);
// - `_flash_kgrid_kernel` / `_flash_attention_kgrid` (K/V streamed one
//   block per sequential grid step, for long S).
// One CTA owns a block of query rows for its whole walk and streams K/V
// through shared memory a tile at a time whatever S is, so one kernel is
// both; nothing carries between CTAs. f32 calls stay on the CUDA-core
// kernel in flash_attn.cu: a tensor-core product in TF32 would not hold
// the f32 tolerance (1e-5 * max + 1e-6).
//
// A second kernel, nns_flash_block_tc_kernel, replaces, for bf16,
// `_flash_block_kernel` / `flash_block_update` (the ring-attention step):
// the same tile code over ONE incoming K/V block, starting from and
// writing back the f32 carry (m, l, acc) that lives in device memory
// between ring steps, the causal mask placed per element by the block's
// global offsets; no division (flash_carry_finalize divides). Bound:
// bytes at the ring's shapes — the carry (acc alone is twice a bf16 q)
// is read and written each step: 7.41 MB, 0.0022 ms at BH 8 x 512 x 512
// x 128; its 1.07 GFLOP take half that. Its layouts are at the kernel.
//
// Semantics of _online_softmax_update / _causal_mask, as the MXU runs
// them: every q.k and p.v product is a bf16 x bf16 product, exact in the
// f32 accumulator, and every sum is f32;
// - s = (q . k) * scale; a masked score (above the diagonal, or a key
//   past S) takes no part in the row max and its p is 0, which leaves m,
//   l and acc as JAX's -1e30 with p forced to 0 (p = 0 where
//   s <= -1e29) leaves them; m starts at -1e30, l at 0;
//   corr = exp(m_old - m_new), taken as 2^x in the log2 domain;
// - l = l * corr + sum(p) over the f32 values of p; the P.V product takes
//   p rounded to bf16, as JAX's p.astype(v.dtype);
// - out = acc / max(l, 1e-20), rounded to bf16;
// - causal: key tiles wholly above a q-block's last row are skipped and
//   the diagonal tile is masked.
//
// Bound: operations. The forward's call, (8, 2048, 8, 128) causal, does
// 68.75 GFLOP (4 * S^2 * D per (b, h), half under the mask), 0.0695 ms at
// the card's 989 TFLOP/s bf16; its 134 MB of traffic (q, k, v read and
// out written once) take 0.040 ms at 3.35 TB/s. The design, for that
// bound:
// - both products on the tensor cores, mma.sync.m16n8k16 bf16 -> f32,
//   fed by ldmatrix (wgmma would need the swizzled shared-memory
//   descriptors of Hopper's canonical layouts; mma.sync reads plain
//   padded tiles and keeps the kernel one readable file);
// - a CTA of 4 warps owns 128 query rows, 32 per warp as two 16-row
//   m-tiles that share every K/V fragment the warp reads from shared
//   memory (head dim 256: 64 rows, one m-tile, for the registers); Q is
//   copied once as bf16 and its A fragments read per 16-dim step;
// - K and V tiles of 64 keys stream through a 2-stage cp.async ring, the
//   next tile's copy in flight during this tile's math; keys past S and
//   head-dim columns past D are zero-filled by the copy (a D that is not
//   a multiple of 16 is padded to the kernel's 64, 128 or 256);
// - the online softmax runs on the S accumulator fragments in registers
//   (row max and, at the end, row sum over the 4 lanes of a quad), in
//   the log2 domain: one FFMA and one ex2 per score; the
//   S fragments of two adjacent 8-key tiles are exactly the A fragment
//   of the next product, so P is packed to bf16 in registers and never
//   touches shared memory;
// - tile rows are padded by 16 bytes, so ldmatrix's 8 row reads of a
//   matrix hit 8 distinct bank groups;
// - inputs are read through their (b, s, h) strides, so JAX's
//   (B,S,H,D) <-> (BH,S,D) transposes are not paid; causal q-blocks are
//   launched heaviest first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMasked = -1e30f;
constexpr float kLFloor = 1e-20f;
constexpr int kBK = 64;                 // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;              // K/V tile pairs in flight
constexpr int kMaxD = 256;
constexpr int kDefaultSmem = 48 * 1024;

struct Strides {
  int64_t b, s, h;   // elements; the head dim is contiguous
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Queue the copy of ROWS rows (row0 ..) of one (b, h) into a tile of
// row stride DP + 8 elements: rows at or past s_len and columns at or
// past d are zero-filled.
template <int DP, int ROWS, int NT = kThreads>
__device__ __forceinline__ void stage_rows(const bf16* base, int64_t stride,
                                           int row0, int s_len, int d,
                                           bf16* dst) {
  constexpr int kChunks = DP / 8;
  constexpr int kLd = DP + 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const int row = row0 + r;
    const bool live = row < s_len && c < d;
    const bf16* src = live ? base + row * stride + c : base;
    cp_async16(dst + r * kLd + c, src, live ? 16 : 0);
  }
}

// Rows per warp by head dim: 16 per m-tile, and two m-tiles share every
// K/V fragment a warp reads from shared memory where their accumulators
// fit the registers (head dim <= 128).
template <int DP>
struct Cfg {
  static constexpr int kMT = DP <= 128 ? 2 : 1;   // m-tiles per warp
  static constexpr int kBQ = 16 * kMT * kWarps;   // query rows per CTA
  static constexpr int kLd = DP + 8;              // tile row stride
  static size_t smem_bytes() {
    return sizeof(bf16) * static_cast<size_t>(kLd) *
           (kBQ + kStages * 2 * kBK);
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One CTA per (q-block, head, batch row): kBQ query rows against every
// key tile they may attend. Warp w owns rows kMT * 16 * w .. + kMT * 16
// of the block, one 16-row m-tile after another; lane (g = lane / 4,
// t = lane % 4) holds, in each 8-column accumulator tile, rows g and
// g + 8 of the m-tile at columns 2t and 2t + 1. The softmax runs in the
// log2 domain: m holds max(s) * log2(e) and p = 2^(s * scale * log2(e) -
// m), one FFMA and one ex2 per score; a masked score takes no part in
// the max and gets p = 0 (-inf in, 0 out), which leaves m, l and acc as
// JAX's -1e30 with p forced to 0 leaves them.
template <int DP>
__global__ void __launch_bounds__(kThreads) nns_flash_attn_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, Strides qs,
    Strides ks, Strides vs, Strides os, int s_len, int d, float scale,
    int causal) {
  constexpr int kMT = Cfg<DP>::kMT, kBQ = Cfg<DP>::kBQ, kLd = Cfg<DP>::kLd;
  constexpr int kTile = kBK * kLd;      // elements of one K or V tile
  constexpr int kKS = DP / 16;          // k-steps of Q.K^T
  constexpr int kNT = DP / 8;           // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + kBQ * kLd;         // kStages x (K, V)

  const int nqb = gridDim.x;
  const int qb = causal ? nqb - 1 - blockIdx.x : blockIdx.x;  // heavy first
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = qb * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float sl2 = scale * 1.4426950408889634f;   // s -> log2 domain

  const bf16* q_bh = q + b * qs.b + h * qs.h;
  const bf16* k_bh = k + b * ks.b + h * ks.h;
  const bf16* v_bh = v + b * vs.b + h * vs.h;

  const int last_row = min(row0 + kBQ, s_len) - 1;
  const int all_tiles = (s_len + kBK - 1) / kBK;
  const int ntiles = causal ? min(all_tiles, last_row / kBK + 1) : all_tiles;

  stage_rows<DP, kBQ>(q_bh, qs.s, row0, s_len, d, q_s);
  stage_rows<DP, kBK>(k_bh, ks.s, 0, s_len, d, kv_s);
  stage_rows<DP, kBK>(v_bh, vs.s, 0, s_len, d, kv_s + kTile);
  cp_async_commit();

  // ldmatrix row addresses of this lane: Q's A fragment (rows of an
  // m-tile, halves of a 16-column step), K's B fragments (two 8-key
  // tiles, halves of a 16-dim step) and V's (transposed: two 16-key
  // halves, two 8-column tiles)
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const uint32_t q_addr =
      smem_u32(q_s + (warp * 16 * kMT + a_row) * kLd + a_col);
  const int kb_row = (lane & 7) + 8 * (lane >> 4);
  const int kb_col = 8 * ((lane >> 3) & 1);

  float o[kMT][kNT][4];
  float m[kMT][2], l[kMT][2];   // rows g, g + 8 of each m-tile
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = kMasked;
      l[mt][i] = 0.f;
    }
  }
  const int r_lo = row0 + warp * 16 * kMT + g;   // m-tile 0, e = 0, 1

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();   // tile t landed; every warp is done with tile t - 1
    if (t + 1 < ntiles) {
      bf16* nxt = kv_s + ((t + 1) % kStages) * 2 * kTile;
      stage_rows<DP, kBK>(k_bh, ks.s, (t + 1) * kBK, s_len, d, nxt);
      stage_rows<DP, kBK>(v_bh, vs.s, (t + 1) * kBK, s_len, d,
                          nxt + kTile);
      cp_async_commit();
    }
    const bf16* k_s = kv_s + (t % kStages) * 2 * kTile;
    const bf16* v_s = k_s + kTile;
    const uint32_t k_addr = smem_u32(k_s + kb_row * kLd + kb_col);
    const uint32_t v_addr = smem_u32(v_s + a_row * kLd + a_col);

    // S = Q K^T: kMT x 16 rows x 64 keys per warp, eight 8-key tiles
    float s[kMT][8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldmatrix_x4(a[mt], q_addr + (mt * 16 * kLd + kk * 16) * 2);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t kb[4];
        ldmatrix_x4(kb, k_addr + (jj * 16 * kLd + kk * 16) * 2);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * jj], a[mt], kb[0], kb[1]);
          mma_bf16(s[mt][2 * jj + 1], a[mt], kb[2], kb[3]);
        }
      }
    }

    // online softmax on the fragments: lane holds rows r_lo + 16 mt
    // (e 0, 1) and + 8 (e 2, 3), keys key0 + 8j + 2t4 (+1)
    const int key0 = t * kBK;
    const bool edge = key0 + kBK > s_len || (causal && key0 + kBK - 1 > row0);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int key = key0 + 8 * j + 2 * t4 + (e & 1);
            const int row = r_lo + 16 * mt + 8 * (e >> 1);
            if (key >= s_len || (causal && key > row))
              s[mt][j][e] = -INFINITY;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
        }
      float corr[2], neg_m[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[mt][i], quad_max(mx[i]) * sl2);
        corr[i] = ex2(m[mt][i] - m_new);
        m[mt][i] = m_new;
        neg_m[i] = -m_new;
        l[mt][i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[mt][j][e], sl2, neg_m[e >> 1]));
          l[mt][e >> 1] += p;            // f32 p; the quad sums at the end
          s[mt][j][e] = p;
        }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[mt][n][0] *= corr[0];
        o[mt][n][1] *= corr[0];
        o[mt][n][2] *= corr[1];
        o[mt][n][3] *= corr[1];
      }
    }

    // O += P V: the S fragments of 8-key tiles 2kk and 2kk + 1, rounded
    // to bf16, are the A fragment of a 16-key step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int nn = 0; nn < kNT / 2; ++nn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_addr + (kk * 16 * kLd + nn * 16) * 2);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(o[mt][2 * nn], a[mt], vb[0], vb[1]);
          mma_bf16(o[mt][2 * nn + 1], a[mt], vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait_all();

  // out = acc / max(l, 1e-20) in bf16; d is a multiple of 8, so an
  // 8-column tile is wholly inside or outside the head dim
  bf16* o_bh = out + b * os.b + h * os.h;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    float lf[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) lf[i] = fmaxf(quad_sum(l[mt][i]), kLFloor);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = 8 * n + 2 * t4;
      if (8 * n >= d) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r_lo + 16 * mt + 8 * i;
        if (row < s_len)
          *reinterpret_cast<uint32_t*>(o_bh + row * os.s + col) = pack_bf16(
              o[mt][n][2 * i] / lf[i], o[mt][n][2 * i + 1] / lf[i]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* out,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      int batch, int s_len, int n_heads, int d, float scale,
                      int causal, cudaStream_t stream) {
  const size_t bytes = Cfg<DP>::smem_bytes();
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        nns_flash_attn_tc_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((s_len + Cfg<DP>::kBQ - 1) / Cfg<DP>::kBQ, n_heads, batch);
  nns_flash_attn_tc_kernel<DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), qs, ks, vs, os,
      s_len, d, scale, causal);
  return cudaGetLastError();
}

// The ring step's CTA: QW query warps of 16 * kMT rows times KW key
// warps, which share each tile of TK keys (TK / KW each, with their own
// m, l and acc). Its shared memory holds the q-block and the 2-stage K/V
// tile ring during the walk, then the partials of key warps 1 .. KW - 1
// (per lane: kMT * DP / 2 acc values, 2 m and 2 l per m-tile), stored
// element-major so the 32 lanes hit 32 banks.
template <int DP, int QW, int KW, int TK>
struct BlockCfg {
  static constexpr int kMT = Cfg<DP>::kMT;
  static constexpr int kThreads = 32 * QW * KW;
  static constexpr int kBQ = 16 * kMT * QW;       // query rows per CTA
  static constexpr int kKeys = TK / KW;           // keys of a tile per warp
  static constexpr int kLd = DP + 8;
  static constexpr int kRed = kMT * (DP / 2 + 4);
  static size_t smem_bytes() {
    const size_t tiles = sizeof(bf16) * static_cast<size_t>(kLd) *
                         (kBQ + kStages * 2 * TK);
    const size_t red = sizeof(float) * static_cast<size_t>(KW - 1) * QW *
                       kRed * 32;
    return tiles > red ? tiles : red;
  }
};

// One ring-attention step (replaces pallas_ops._flash_block_kernel /
// flash_block_update, bf16): one CTA per (q-block, bh) continues the
// online softmax of kBQ query rows over every key tile of ONE incoming
// K/V block, from the f32 carry m, l (BH, Sq) and acc (BH, Sq, D) in
// device memory, and writes the carry back in place. Query row r sits at
// position q_off + r and key j at k_off + j.
// - Key warp 0 starts from the carry: acc is loaded straight into its
//   P.V accumulator fragments, m and l per row (l in the quad's first
//   lane, the others' partial sums start at 0). Key warps 1 .. KW - 1
//   start empty (m -1e30, l 0, acc 0), as flash_carry_init does; after
//   the walk warp 0 folds their partials into its own in kw order.
// - m stays in the natural domain, the max of the scaled scores, as the
//   plain version and flash_carry_finalize read it; each exponent is one
//   FFMA, s * (scale * log2 e) - m * log2 e, and corr = 2^((m_old -
//   m_new) * log2 e). m is never rebuilt from a log2-domain value.
// - A masked score (causal: q_off + row < k_off + key, placed per
//   element; or a key past Sk) is -inf: it takes no part in the max and
//   its p is 0. A row that meets no live key keeps m (max(m, -inf) = m),
//   so corr = 2^0 = 1 exactly, p = 0, and l and acc keep their bits; its
//   fold takes c_own = 1 and a partial of l 0 and acc 0. m -1e30 with a
//   masked score gives 2^-inf = 0, never inf - inf.
// - Causal: a CTA whose last row lies above the block's first key
//   returns before touching the carry; key tiles past its last row are
//   skipped.
// No division: flash_carry_finalize divides after the last step.
template <int DP, int QW, int KW, int TK>
__global__ void __launch_bounds__(32 * QW * KW) nns_flash_block_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, float* __restrict__ m_g,
    float* __restrict__ l_g, float* __restrict__ acc_g, Strides qs,
    Strides ks, Strides vs, int heads, int sq, int sk, int d, float scale,
    int causal, int q_off, int k_off) {
  using C = BlockCfg<DP, QW, KW, TK>;
  static_assert(C::kKeys % 16 == 0, "a key warp takes whole 16-key steps");
  constexpr int kMT = C::kMT, kBQ = C::kBQ, kLd = C::kLd, kThr = C::kThreads;
  constexpr int kTile = TK * kLd;
  constexpr int kKS = DP / 16;          // k-steps of Q.K^T
  constexpr int kNT = DP / 8;           // 8-column tiles of acc
  constexpr int kNJ = C::kKeys / 8;     // 8-key tiles of S per warp
  constexpr int kPV = C::kKeys / 16;    // 16-key steps of P.V per warp
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + kBQ * kLd;

  const int nqb = gridDim.x;
  const int qb = causal ? nqb - 1 - blockIdx.x : blockIdx.x;  // heavy first
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int row0 = qb * kBQ;
  const int all_tiles = (sk + TK - 1) / TK;
  int ntiles = all_tiles;
  if (causal) {
    const int last_q = q_off + min(row0 + kBQ, sq) - 1;
    if (last_q < k_off) return;         // wholly above the diagonal
    ntiles = min(all_tiles, (last_q - k_off) / TK + 1);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw = warp / KW, kw = warp % KW;
  const int g = lane / 4, t4 = lane % 4;
  const float sl2 = scale * kLog2e;     // s -> log2 domain

  const bf16* k_bh = k + b * ks.b + h * ks.h;
  const bf16* v_bh = v + b * vs.b + h * vs.h;
  auto stage_tile = [&](int t) {   // K/V tile t into its ring slot
    bf16* dst = kv_s + (t % kStages) * 2 * kTile;
    stage_rows<DP, TK, kThr>(k_bh, ks.s, t * TK, sk, d, dst);
    stage_rows<DP, TK, kThr>(v_bh, vs.s, t * TK, sk, d, dst + kTile);
    cp_async_commit();
  };
  stage_rows<DP, kBQ, kThr>(q + b * qs.b + h * qs.h, qs.s, row0, sq, d,
                            q_s);
  stage_tile(0);

  // the carry (key warp 0) or an empty partial, while tile 0 is in flight
  const int r_lo = row0 + qw * 16 * kMT + g;   // m-tile 0, e = 0, 1
  const int64_t row_base = static_cast<int64_t>(bh) * sq;
  float o[kMT][kNT][4];
  float m[kMT][2], l[kMT][2];   // rows g, g + 8 of each m-tile
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r_lo + 16 * mt + 8 * i;
      const bool live = kw == 0 && row < sq;
      const int64_t at = row_base + row;
      m[mt][i] = live ? m_g[at] : kMasked;
      l[mt][i] = live && t4 == 0 ? l_g[at] : 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        float2 a = make_float2(0.f, 0.f);
        if (live && 8 * n < d)
          a = *reinterpret_cast<const float2*>(acc_g + at * d + 8 * n +
                                               2 * t4);
        o[mt][n][2 * i] = a.x;
        o[mt][n][2 * i + 1] = a.y;
      }
    }

  // ldmatrix row addresses of this lane, as in the flash kernel, offset
  // to this warp's rows and to its keys of a tile
  const int key_w = kw * C::kKeys;
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const uint32_t q_addr =
      smem_u32(q_s + (qw * 16 * kMT + a_row) * kLd + a_col);
  const int kb_row = (lane & 7) + 8 * (lane >> 4);
  const int kb_col = 8 * ((lane >> 3) & 1);
  const int wpos0 = q_off + row0 + qw * 16 * kMT;   // warp's first row

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();   // tile t landed; every warp is done with tile t - 1
    if (t + 1 < ntiles) stage_tile(t + 1);
    const bf16* k_s = kv_s + (t % kStages) * 2 * kTile;
    const bf16* v_s = k_s + kTile;
    const uint32_t k_addr = smem_u32(k_s + (key_w + kb_row) * kLd + kb_col);
    const uint32_t v_addr = smem_u32(v_s + (key_w + a_row) * kLd + a_col);

    // S = Q K^T: kMT x 16 rows x this warp's keys of the tile
    float s[kMT][kNJ][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldmatrix_x4(a[mt], q_addr + (mt * 16 * kLd + kk * 16) * 2);
#pragma unroll
      for (int jj = 0; jj < kNJ / 2; ++jj) {
        uint32_t kb[4];
        ldmatrix_x4(kb, k_addr + (jj * 16 * kLd + kk * 16) * 2);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * jj], a[mt], kb[0], kb[1]);
          mma_bf16(s[mt][2 * jj + 1], a[mt], kb[2], kb[3]);
        }
      }
    }

    // online softmax on the fragments: lane holds rows r_lo + 16 mt
    // (e 0, 1) and + 8 (e 2, 3), keys key0 + 8j + 2t4 (+1)
    const int key0 = t * TK + key_w;
    const bool edge = key0 + C::kKeys > sk ||
                      (causal && k_off + key0 + C::kKeys - 1 > wpos0);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int key = key0 + 8 * j + 2 * t4 + (e & 1);
            const int pos = wpos0 + 16 * mt + g + 8 * (e >> 1);
            if (key >= sk || (causal && k_off + key > pos))
              s[mt][j][e] = -INFINITY;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
        }
      float corr[2], neg_m[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[mt][i], quad_max(mx[i]) * scale);
        corr[i] = ex2((m[mt][i] - m_new) * kLog2e);
        m[mt][i] = m_new;
        neg_m[i] = -m_new * kLog2e;
        l[mt][i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[mt][j][e], sl2, neg_m[e >> 1]));
          l[mt][e >> 1] += p;            // f32 p; the quad sums at the end
          s[mt][j][e] = p;
        }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[mt][n][0] *= corr[0];
        o[mt][n][1] *= corr[0];
        o[mt][n][2] *= corr[1];
        o[mt][n][3] *= corr[1];
      }
    }

    // acc += P V: the S fragments of 8-key tiles 2kk and 2kk + 1, rounded
    // to bf16, are the A fragment of a 16-key step
#pragma unroll
    for (int kk = 0; kk < kPV; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int nn = 0; nn < kNT / 2; ++nn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_addr + (kk * 16 * kLd + nn * 16) * 2);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(o[mt][2 * nn], a[mt], vb[0], vb[1]);
          mma_bf16(o[mt][2 * nn + 1], a[mt], vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) l[mt][i] = quad_sum(l[mt][i]);

  if constexpr (KW > 1) {
    // key warps 1 .. KW - 1 leave their partials in shared memory (the
    // tiles are done with); warp 0 folds them into its own, in kw order
    __syncthreads();
    float* red_all = reinterpret_cast<float*>(smem_raw);
    if (kw > 0) {
      float* red = red_all + ((kw - 1) * QW + qw) * C::kRed * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float* r = red + mt * (DP / 2 + 4) * 32;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          r[32 * i] = m[mt][i];
          r[32 * (2 + i)] = l[mt][i];
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) r[(4 + 4 * n + e) * 32] = o[mt][n][e];
      }
    }
    __syncthreads();
    if (kw > 0) return;
    for (int w = 1; w < KW; ++w) {
      const float* red =
          red_all + ((w - 1) * QW + qw) * C::kRed * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* r = red + mt * (DP / 2 + 4) * 32;
        float c_own[2], c_part[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_part = r[32 * i];
          const float m_new = fmaxf(m[mt][i], m_part);
          c_own[i] = ex2((m[mt][i] - m_new) * kLog2e);
          c_part[i] = ex2((m_part - m_new) * kLog2e);
          l[mt][i] = l[mt][i] * c_own[i] + r[32 * (2 + i)] * c_part[i];
          m[mt][i] = m_new;
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[mt][n][e] = o[mt][n][e] * c_own[e >> 1] +
                          r[(4 + 4 * n + e) * 32] * c_part[e >> 1];
      }
    }
  }

  // the carry back, in place; d is a multiple of 8, so an 8-column tile
  // is wholly inside or outside the head dim
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r_lo + 16 * mt + 8 * i;
      if (row >= sq) continue;
      const int64_t at = row_base + row;
      if (t4 == 0) {
        m_g[at] = m[mt][i];
        l_g[at] = l[mt][i];
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        if (8 * n < d)
          *reinterpret_cast<float2*>(acc_g + at * d + 8 * n + 2 * t4) =
              make_float2(o[mt][n][2 * i], o[mt][n][2 * i + 1]);
    }
}

template <int DP, int QW, int KW, int TK>
cudaError_t launch_block_cfg(const void* q, const void* k, const void* v,
                             float* m, float* l, float* acc, Strides qs,
                             Strides ks, Strides vs, int bh, int heads,
                             int sq, int sk, int d, float scale, int causal,
                             int q_off, int k_off, cudaStream_t stream) {
  using C = BlockCfg<DP, QW, KW, TK>;
  const size_t bytes = C::smem_bytes();
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        nns_flash_block_tc_kernel<DP, QW, KW, TK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + C::kBQ - 1) / C::kBQ, bh);
  nns_flash_block_tc_kernel<DP, QW, KW, TK>
      <<<grid, C::kThreads, bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), m, l, acc, qs, ks, vs, heads, sq, sk,
          d, scale, causal, q_off, k_off);
  return cudaGetLastError();
}

// The layout by the work: the flash kernel's CTA (4 query warps, one key
// warp, 64-key tiles) while those CTAs are at least one per
// SM; below that (the serving ring's BH 8 x Sq 512 gives 32 of them) one
// query warp of 32 rows and eight key warps over each 128-key tile, four
// times the CTAs with twice the warps and half the tile steps (head dim
// 256: four key warps over 64-key tiles, for the shared memory).
template <int DP>
cudaError_t launch_block_dp(const void* q, const void* k, const void* v,
                            float* m, float* l, float* acc, Strides qs,
                            Strides ks, Strides vs, int bh, int heads,
                            int sq, int sk, int d, float scale, int causal,
                            int q_off, int k_off, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  constexpr int kWideRows = BlockCfg<DP, kWarps, 1, kBK>::kBQ;
  const int64_t wide =
      static_cast<int64_t>(bh) * ((sq + kWideRows - 1) / kWideRows);
  if (wide >= sms)
    return launch_block_cfg<DP, kWarps, 1, kBK>(
        q, k, v, m, l, acc, qs, ks, vs, bh, heads, sq, sk, d, scale, causal,
        q_off, k_off, stream);
  constexpr int kSplitKW = DP <= 128 ? 8 : 4;
  return launch_block_cfg<DP, 1, kSplitKW, 16 * kSplitKW>(
      q, k, v, m, l, acc, qs, ks, vs, bh, heads, sq, sk, d, scale, causal,
      q_off, k_off, stream);
}

bool aligned(const Strides& st) {
  return st.b % 8 == 0 && st.s % 8 == 0 && st.h % 8 == 0;
}

}  // namespace

extern "C" {

// q, k, v, out: bf16 (batch, s_len, n_heads, d) with element strides
// (b, s, h) given per tensor and a contiguous last dim; d a multiple of 8
// and <= 256; every stride a multiple of 8 elements (16 bytes) and every
// pointer 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments outside the
// contract); does not synchronise and allocates nothing.
int nns_flash_attn_tc(const void* q, const void* k, const void* v, void* out,
                      int batch, int s_len, int n_heads, int d, int64_t q_sb,
                      int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                      int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                      int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale,
                      int causal, void* stream) {
  if (batch <= 0 || s_len <= 0 || n_heads <= 0) return cudaSuccess;
  if (d <= 0 || d > kMaxD || d % 8 || batch > 65535 || n_heads > 65535)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  if (!aligned(qs) || !aligned(ks) || !aligned(vs) || !aligned(os))
    return cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_dp<64>(q, k, v, out, qs, ks, vs, os, batch, s_len, n_heads,
                         d, scale, causal, s);
  if (d <= 128)
    return launch_dp<128>(q, k, v, out, qs, ks, vs, os, batch, s_len,
                          n_heads, d, scale, causal, s);
  return launch_dp<256>(q, k, v, out, qs, ks, vs, os, batch, s_len, n_heads,
                        d, scale, causal, s);
}

// One ring step in bf16 (f32 is the CUDA-core kernel's, nns_flash_block
// in flash_attn.cu). q: bh rows of (sq, d), k and v: bh rows of (sk, d),
// all bf16, row bh = b * heads + h read at b * s?_b + h * s?_h with
// position stride s?_s (elements; last dim contiguous; d a multiple of 8
// and <= 256; every stride a multiple of 8 elements and every pointer
// 16-byte aligned). m, l: (bh, sq) f32 and acc: (bh, sq, d) f32,
// contiguous, updated in place. Launches on `stream`, returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments outside the
// contract); does not synchronise and allocates nothing.
int nns_flash_block_tc(const void* q, const void* k, const void* v, void* m,
                       void* l, void* acc, int bh, int heads, int sq, int sk,
                       int d, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                       int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                       int64_t v_ss, int64_t v_sh, float scale, int causal,
                       int q_off, int k_off, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0) return cudaSuccess;
  if (d <= 0 || d > kMaxD || d % 8 || bh > 65535 || heads <= 0 ||
      bh % heads)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  if (!aligned(qs) || !aligned(ks) || !aligned(vs))
    return cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(acc)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_block_dp<64>(q, k, v, mf, lf, af, qs, ks, vs, bh, heads,
                               sq, sk, d, scale, causal, q_off, k_off, s);
  if (d <= 128)
    return launch_block_dp<128>(q, k, v, mf, lf, af, qs, ks, vs, bh, heads,
                                sq, sk, d, scale, causal, q_off, k_off, s);
  return launch_block_dp<256>(q, k, v, mf, lf, af, qs, ks, vs, bh, heads, sq,
                              sk, d, scale, causal, q_off, k_off, s);
}

const char* nns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

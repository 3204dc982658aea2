// Phase-split backward of the attention core on Hopper (kernel 5): the same
// function as attention_qkv_bwd.cu (kernel 4).  Given the fused projection
// qkv [B, Tp, 3D] (q | k | v, heads contiguous inside each) and the
// cotangent g [B, Tp, D] of the concatenated head outputs (zero on pad
// rows), per head
//
//   w  = softmax(q k^T * s), key columns >= valid_len at -1e30   (f32)
//   dv = cdt(w)^T g,  dw = g v^T,  dl = w (dw - rowsum(dw w))
//   dq = cdt(dl) k * s,  dk = cdt(dl)^T q * s
//
// into dqkv [B, Tp, 3D], where cdt is the input type (bf16, or f32 where
// the rounding is the identity).  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_qkv_bwd_kernel_phased
// (:259), the opt-in form of kernel 4 selected by BWD_PHASED, and keeps its
// rounding points: w is rounded to cdt only as the operand of dv, dl is
// formed from the f32 w and dw after each row's full sum and rounded to
// cdt only as the operand of dq and dk; every product sums in f32.
// rowsum(dw w) is summed as written, not reassociated.
//
// Bound on the H100: the same work as kernel 4.  bf16 at ViT-B, B = 128,
// Tp = 200: qkv and g in, dqkv out, about 275 MB, >= 0.082 ms at 3.35 TB/s
// (the five [Tp, Tp] x Dh products are 39 GFLOP, 0.04 ms at the bf16
// peak).  f32 at B = 32: the five products are 9.8 GFLOP on the FMA units,
// >= 0.147 ms at 67 TFLOP/s.
//
// What "phased" means here.  The TPU schedule computes each (item, head)'s
// softmax once and then issues all products of one kind back to back out of
// VMEM.  On this card that is one launch a call, one block per (head,
// item) that keeps the head on chip from its first product to its last,
// each of the five products computed once (kernel 4 computes the scores
// and dw twice), no workspace in device memory.
//
// bf16 (head dims 16, 32, 64; Tp up to 208): kernel 4's shared layout, the
// 16-byte-chunk XOR swizzle in place of padding -- K and V [nk][Dh], then Q
// and G in their place, and the bf16 w and dl [nk][nk] (nk = Tp rounded up
// to 16): 226 KB of the 227 at Tp 200, Dh 64.  Phase A: K and V staged by
// 16-byte cp.async (V lands while the first scores run); a warp owns 16
// query rows at a time and keeps their f32 scores, then w, in registers
// (KEYS / 2 a thread, 104 at Tp 200), computes dw = g v^T into registers
// beside them (another 104), takes rowsum(dw w) and dl = w (dw - rowsum) in
// f32, stores bf16 w and dl for phase B, and accumulates dq = bf16(dl) k
// from the dl registers.  Operands K and V are read by ldmatrix (.trans for
// dq); the warp's Q and G fragments come straight from device memory, once
// a row group (no room is left in shared memory), G's issued before the
// softmax and the next row group's Q during dq, so that their latency
// hides behind arithmetic.  The softmax runs in base 2 (the scale times
// log2 e folded into the logits, exp2f, one reciprocal a row).  Holding w
// and dw together takes 255 registers a thread (~130 B of spills), so a
// block has 7 warps, one block an SM, that take the 13 row groups of Tp 200
// in two rounds.  Phase B: Q and G staged over K and V; a warp owns 16 keys
// and accumulates dv = w^T g and dk = dl^T q over all rows from the stored
// tiles (ldmatrix.trans, the row loop unrolled).  Products: scores, dw, dq
// in A; dv, dk in B.
//
// f32 (head dims 16, 32, 64; Tp up to 256), plain FMAs (no TF32; the
// softmax in base 2 as above): the f32 w and dl of a head are 173 KB each,
// so they cannot stay on chip; instead the query rows go through in chunks
// of 16 and dv and dk stay in registers across the chunks.  K and V [Tp][Dh + 4] f32 are staged once;
// per chunk (its Q and G prefetched by cp.async during the previous one):
//   1. s = q k^T * s and dw = g v^T for the chunk's 16 rows (a thread: 4
//      rows x 4 keys of each, 16 float4 loads for 128 FMAs), into [16][Tp];
//   2. a warp per row: the softmax w, rowsum(dw w), dl = w (dw - rowsum);
//   3. dq = dl k * s of the chunk's rows, written out;
//      dv += w^T g and dk += dl^T q for every key (a thread: 16 keys x 4
//      columns of each, in registers until the last chunk).
// Budget at Tp 200, Dh 64: 148 KB of shared memory (K and V 106 KB, the
// double-buffered Q and G chunks 17 KB, w and dl 25 KB), one block of 8
// warps an SM, 128 accumulators a thread.
//
// Rows with g = 0 give dw = 0, hence dl = 0: pad rows add nothing and their
// dq is 0; masked key columns have w = 0 exactly, so their dk and dv are 0.
// Longer Tp and the other head dims take the four-launch schedule in
// attention_qkv_bwd_phased_long.cu (chosen by shape in ops/attention.py).
#include <math_constants.h>

#include "attention_bwd_core.cuh"  // kernel 4's tile layouts: head_at, sq_at, stage

namespace vsd {
namespace {

constexpr int kPhWarps = 7;          // bf16: warps a block
constexpr int kPhMaxKeys = 208;      // bf16: keys (Tp rounded up to 16) a block holds
constexpr int kPhF32Threads = 256;   // f32: threads a block
constexpr int kPhF32Rows = 16;       // f32: query rows a chunk
constexpr int kPhF32MaxKeys = 256;   // f32: keys a block holds

// Kernel 4's swizzles depend only on a row's place within its 16-row tile
// (head_at: r mod 8, or the bits above for narrower heads; sq_at: bit 2 of
// r), so a tile's shared address is its first tile's plus a constant
// (ldmatrix_x4_at).
__device__ __forceinline__ float ph_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// bf16: KEYS (64, 128 or kPhMaxKeys) bounds nk; NJ = KEYS / 8 score tiles a warp.
// ---------------------------------------------------------------------------
template <int DH, int KEYS>
__global__ void __launch_bounds__(kPhWarps * 32, 1)
    phased_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gout,
                      bf16* __restrict__ dqkv, int tp, int d, int valid_len, float scale) {
  constexpr int KK = DH / 16;  // k-steps over the head dim
  constexpr int NO = DH / 8;   // 8-column tiles of the head dim
  constexpr int NJ = KEYS / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nk = bwd_keys(tp), ng = nk / 16;
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ld = 3 * d;
  const size_t hoff = static_cast<size_t>(blockIdx.x) * DH;
  const bf16* qb = qkv + static_cast<size_t>(blockIdx.y) * tp * ld + hoff;  // q; k at + d, v at + 2d
  const bf16* gb = gout + static_cast<size_t>(blockIdx.y) * tp * d + hoff;
  bf16* ob = dqkv + static_cast<size_t>(blockIdx.y) * tp * ld + hoff;
  bf16* T0 = reinterpret_cast<bf16*>(smem);  // K, then Q
  bf16* T1 = T0 + nk * DH;                   // V, then G
  bf16* Ws = T1 + nk * DH;                   // bf16 w  [query][key]
  bf16* Ls = Ws + nk * nk;                   // bf16 dl [query][key]

  stage<DH>(T0, qb + d, ld, tp, nk);  // group 0: K
  cp_async_commit();
  stage<DH>(T1, qb + 2 * d, ld, tp, nk);  // group 1: V
  cp_async_commit();

  // ldmatrix.x4 row addresses: B fragments of two 8-key tiles (keys +0..7 /
  // +8..15, depth +0 / +8); .trans: two 8-column tiles of 16 rows
  const int kb_row = (lane & 7) + ((lane >> 4) << 3), kb_col = ((lane >> 3) & 1) << 3;
  const int tr_row = lane & 15, tr_col = (lane >> 4) << 3;

  // A fragments of 16 rows (r0 .. r0 + 15; rows past Tp zeros) of a [Tp][Dh]
  // operand in device memory (rows at + r * ldr), every depth step at once
  auto frags = [&](uint32_t (&a)[KK][4], const bf16* base, int ldr, int r0) {
    const bool lo_in = r0 + g < tp, hi_in = r0 + g + 8 < tp;
    const bf16* lo = base + static_cast<size_t>(r0 + g) * ldr + t4 * 2;
    const bf16* hi = lo + 8 * static_cast<size_t>(ldr);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      a[kk][0] = lo_in ? ld_global_u32(lo + kk * 16) : 0u;
      a[kk][1] = hi_in ? ld_global_u32(hi + kk * 16) : 0u;
      a[kk][2] = lo_in ? ld_global_u32(lo + kk * 16 + 8) : 0u;
      a[kk][3] = hi_in ? ld_global_u32(hi + kk * 16 + 8) : 0u;
    }
  };
  // c[j] = a b^T for the staged [nk][Dh] tile b: the 16 rows against every
  // key (c[j][0..1] row g, keys 8 j + 2 t4 + {0, 1})
  auto rows_by_keys = [&](float (&c)[NJ][4], const uint32_t (&a)[KK][4], const bf16* tile) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t base = smem_addr(tile + head_at<DH>(kb_row, kk * 16 + kb_col));
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        if (jp * 16 < nk) {
          uint32_t b[4];
          ldmatrix_x4_at(b, base + jp * 16 * DH * 2);
          mma_16816(c[2 * jp], a[kk], b[0], b[1]);
          mma_16816(c[2 * jp + 1], a[kk], b[2], b[3]);
        }
      }
    }
  };

  // ---- A: a warp per 16 query rows ----
  const float scale2 = scale * kLog2e;  // logits in base 2: exp2(s2 - max) = exp(s - max)
  uint32_t qa[KK][4];
  frags(qa, qb, ld, warp * 16);  // in flight while K lands
  cp_async_wait<1>();
  __syncthreads();
  for (int rg = warp, it = 0; rg < ng; rg += nw, ++it) {
    const int r0 = rg * 16;
    const bool lo_in = r0 + g < tp, hi_in = r0 + g + 8 < tp;
    float w[NJ][4];
    rows_by_keys(w, qa, T0);  // product 1: the scores
    uint32_t ga[KK][4];
    frags(ga, gb, d, r0);  // in flight during the softmax
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[j][e] = masked_logit2(w[j][e], j * 8 + t4 * 2 + (e & 1), valid_len, tp, scale2);
        m[e >> 1] = fmaxf(m[e >> 1], w[j][e]);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 1));
      m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 2));
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[j][e] = exp2f(w[j][e] - m[e >> 1]);
        l[e >> 1] += w[j][e];
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
      l[hr] = 1.f / l[hr];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[j][e] *= l[e >> 1];

    if (it == 0) {  // every warp has a first row group
      cp_async_wait<0>();  // V
      __syncthreads();
    }
    float dl[NJ][4];
    rows_by_keys(dl, ga, T1);  // product 2: dw = g v^T
    float dd[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dd[e >> 1] = fmaf(dl[j][e], w[j][e], dd[e >> 1]);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      dd[hr] += __shfl_xor_sync(0xffffffffu, dd[hr], 1);
      dd[hr] += __shfl_xor_sync(0xffffffffu, dd[hr], 2);
    }
    const int rlo = r0 + g, rhi = r0 + g + 8;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dl[j][e] = w[j][e] * (dl[j][e] - dd[e >> 1]);
      if (j * 8 < nk) {
        const int key = j * 8 + t4 * 2;
        *reinterpret_cast<uint32_t*>(Ws + sq_at(nk, rlo, key)) = pack_bf16x2(w[j][0], w[j][1]);
        *reinterpret_cast<uint32_t*>(Ws + sq_at(nk, rhi, key)) = pack_bf16x2(w[j][2], w[j][3]);
        *reinterpret_cast<uint32_t*>(Ls + sq_at(nk, rlo, key)) = pack_bf16x2(dl[j][0], dl[j][1]);
        *reinterpret_cast<uint32_t*>(Ls + sq_at(nk, rhi, key)) = pack_bf16x2(dl[j][2], dl[j][3]);
      }
    }
    if (rg + nw < ng) frags(qa, qb, ld, r0 + 16 * nw);  // the next row group's, during dq
    // product 3: dq = bf16(dl) k, the dl registers as A fragments
    float dq[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < NJ / 2; ++t) {
      if (t * 16 < nk) {
        const uint32_t pa[4] = {pack_bf16x2(dl[2 * t][0], dl[2 * t][1]),
                                pack_bf16x2(dl[2 * t][2], dl[2 * t][3]),
                                pack_bf16x2(dl[2 * t + 1][0], dl[2 * t + 1][1]),
                                pack_bf16x2(dl[2 * t + 1][2], dl[2 * t + 1][3])};
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans_at(b, smem_addr(T0 + head_at<DH>(tr_row, n * 8 + tr_col)) +
                                  t * 16 * DH * 2);
          mma_16816(dq[n], pa, b[0], b[1]);
          mma_16816(dq[n + 1], pa, b[2], b[3]);
        }
      }
    }
    bf16* orow = ob + static_cast<size_t>(rlo) * ld + t4 * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (lo_in)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16x2(dq[n][0] * scale, dq[n][1] * scale);
      if (hi_in)
        *reinterpret_cast<uint32_t*>(orow + 8 * static_cast<size_t>(ld) + n * 8) =
            pack_bf16x2(dq[n][2] * scale, dq[n][3] * scale);
    }
  }
  __syncthreads();  // w and dl complete; K and V no longer read

  // ---- B: Q and G over K and V; a warp per 16 keys ----
  stage<DH>(T0, qb, ld, tp, nk);
  stage<DH>(T1, gb, d, tp, nk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // ldmatrix.x4.trans of w^T / dl^T: tile i = lane / 8 covers queries
  // +8 (i / 2) and keys +8 (i % 2) of a 16 x 16 block
  const int qoff = (lane & 7) + ((lane >> 4) << 3);
  for (int kt = warp; kt < ng; kt += nw) {
    const int k0 = kt * 16, koff = k0 + (((lane >> 3) & 1) << 3);
    const uint32_t wbase = smem_addr(Ws + sq_at(nk, qoff, koff));
    const uint32_t lbase = smem_addr(Ls + sq_at(nk, qoff, koff));
    float dv[NO][4], dk[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;
#pragma unroll
    for (int q0 = 0; q0 < KEYS; q0 += 16) {  // unrolled: the next tiles' loads overlap
      if (q0 >= nk) break;
      uint32_t wt[4], lt[4];
      ldmatrix_x4_trans_at(wt, wbase + q0 * nk * 2);
      ldmatrix_x4_trans_at(lt, lbase + q0 * nk * 2);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        const int col = head_at<DH>(tr_row, n * 8 + tr_col) * 2 + q0 * DH * 2;
        uint32_t b[4];
        ldmatrix_x4_trans_at(b, smem_addr(T1) + col);  // product 4: dv
        mma_16816(dv[n], wt, b[0], b[1]);
        mma_16816(dv[n + 1], wt, b[2], b[3]);
        ldmatrix_x4_trans_at(b, smem_addr(T0) + col);  // and 5: dk
        mma_16816(dk[n], lt, b[0], b[1]);
        mma_16816(dk[n + 1], lt, b[2], b[3]);
      }
    }
    const int key = k0 + g;
    bf16* krow = ob + d + static_cast<size_t>(key) * ld + t4 * 2;
    bf16* vrow = krow + d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (key < tp) {
        *reinterpret_cast<uint32_t*>(krow + n * 8) = pack_bf16x2(dk[n][0] * scale, dk[n][1] * scale);
        *reinterpret_cast<uint32_t*>(vrow + n * 8) = pack_bf16x2(dv[n][0], dv[n][1]);
      }
      if (key + 8 < tp) {
        *reinterpret_cast<uint32_t*>(krow + 8 * static_cast<size_t>(ld) + n * 8) =
            pack_bf16x2(dk[n][2] * scale, dk[n][3] * scale);
        *reinterpret_cast<uint32_t*>(vrow + 8 * static_cast<size_t>(ld) + n * 8) =
            pack_bf16x2(dv[n][2], dv[n][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: chunks of kPhF32Rows query rows through one block of kPhF32Threads.
// ---------------------------------------------------------------------------
__host__ __device__ inline int ph_keys4(int tp) { return (tp + 3) / 4 * 4; }

// K and V [nkp][Dh + 4], Q and G chunks [2][16][Dh + 4] each, the chunk's
// w and dl [16][nkp] (nkp = Tp rounded up to 4).
__host__ __device__ inline size_t phased_f32_smem_bytes(int tp, int dh) {
  const size_t nkp = ph_keys4(tp), ldf = dh + 4;
  return (2 * nkp * ldf + 4 * kPhF32Rows * ldf + 2 * kPhF32Rows * nkp) * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kPhF32Threads, 1)
    phased_bwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ gout,
                          float* __restrict__ dqkv, int tp, int d, int valid_len, float scale) {
  constexpr int LD = DH + 4;                   // shared row stride (floats)
  constexpr int C4 = DH / 4;                   // float4 chunks a head row
  constexpr int CL = DH / 4;                   // column lanes of steps 3 (4 columns each)
  constexpr int KQ = kPhF32Threads / CL;       // key-quad lanes of the dv / dk sums
  constexpr int NJ5 = (kPhF32MaxKeys + 4 * KQ - 1) / (4 * KQ);
  constexpr int NJ2 = kPhF32MaxKeys / 64;      // keys a thread of step 1
  extern __shared__ __align__(128) unsigned char smem[];
  const int nkp = ph_keys4(tp), nch = (tp + kPhF32Rows - 1) / kPhF32Rows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ld = 3 * d;
  const size_t hoff = static_cast<size_t>(blockIdx.x) * DH;
  const float* qb = qkv + static_cast<size_t>(blockIdx.y) * tp * ld + hoff;
  const float* gb = gout + static_cast<size_t>(blockIdx.y) * tp * d + hoff;
  float* ob = dqkv + static_cast<size_t>(blockIdx.y) * tp * ld + hoff;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + nkp * LD;
  float* Qb = Vs + nkp * LD;               // [2][16][LD]
  float* Gb = Qb + 2 * kPhF32Rows * LD;    // [2][16][LD]
  float* Wc = Gb + 2 * kPhF32Rows * LD;    // [16][nkp]: s, then w
  float* Lc = Wc + kPhF32Rows * nkp;       // [16][nkp]: dw, then dl

  // rows [r0, r0 + n) of a head operand (row r at src + r * ldr) into dst
  // [n][LD]; rows at or past tp are zeros
  auto stage_f32 = [&](float* dst, const float* src, int ldr, int r0, int n) {
    for (int c = tid; c < n * C4; c += kPhF32Threads) {
      const int r = c / C4, col = (c % C4) * 4;
      float* p = dst + r * LD + col;
      if (r0 + r < tp)
        cp_async16(p, src + static_cast<size_t>(r0 + r) * ldr + col);
      else
        store_zero16(p);
    }
  };
  stage_f32(Ks, qb + d, ld, 0, nkp);
  stage_f32(Vs, qb + 2 * d, ld, 0, nkp);
  stage_f32(Qb, qb, ld, 0, kPhF32Rows);
  stage_f32(Gb, gb, d, 0, kPhF32Rows);
  cp_async_commit();

  const float scale2 = scale * kLog2e;
  const int rq = tid / 64, kl = tid % 64;          // step 1: rows 4 rq .., keys kl + 64 j
  const int cl = tid % CL, kq = tid / CL;          // step 3: columns 4 cl .., keys 4 kq + 4 KQ j
  float dv[NJ5][4][4], dk[NJ5][4][4];
#pragma unroll
  for (int j = 0; j < NJ5; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dv[j][i][c] = dk[j][i][c] = 0.f;

  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch landed; the last chunk's steps are done
    if (ch + 1 < nch) {
      const int nb = (ch + 1) & 1;
      stage_f32(Qb + nb * kPhF32Rows * LD, qb, ld, (ch + 1) * kPhF32Rows, kPhF32Rows);
      stage_f32(Gb + nb * kPhF32Rows * LD, gb, d, (ch + 1) * kPhF32Rows, kPhF32Rows);
    }
    cp_async_commit();
    const float* Qc = Qb + (ch & 1) * kPhF32Rows * LD;
    const float* Gc = Gb + (ch & 1) * kPhF32Rows * LD;

    {  // 1. products 1 and 2: s and dw of the chunk's rows
      float s[4][NJ2], dw[4][NJ2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < NJ2; ++j) s[r][j] = dw[r][j] = 0.f;
      for (int c = 0; c < DH; c += 4) {
        float4 qv[4], gv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qv[r] = *reinterpret_cast<const float4*>(Qc + (rq * 4 + r) * LD + c);
          gv[r] = *reinterpret_cast<const float4*>(Gc + (rq * 4 + r) * LD + c);
        }
#pragma unroll
        for (int j = 0; j < NJ2; ++j) {
          const int key = kl + 64 * j;
          if (key < tp) {
            const float4 kv = *reinterpret_cast<const float4*>(Ks + key * LD + c);
            const float4 vv = *reinterpret_cast<const float4*>(Vs + key * LD + c);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              s[r][j] = fmaf(qv[r].x, kv.x, s[r][j]);
              s[r][j] = fmaf(qv[r].y, kv.y, s[r][j]);
              s[r][j] = fmaf(qv[r].z, kv.z, s[r][j]);
              s[r][j] = fmaf(qv[r].w, kv.w, s[r][j]);
              dw[r][j] = fmaf(gv[r].x, vv.x, dw[r][j]);
              dw[r][j] = fmaf(gv[r].y, vv.y, dw[r][j]);
              dw[r][j] = fmaf(gv[r].z, vv.z, dw[r][j]);
              dw[r][j] = fmaf(gv[r].w, vv.w, dw[r][j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NJ2; ++j) {
        const int key = kl + 64 * j;
        if (key < tp)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            Wc[(rq * 4 + r) * nkp + key] = masked_logit2(s[r][j], key, valid_len, tp, scale2);
            Lc[(rq * 4 + r) * nkp + key] = dw[r][j];
          }
      }
    }
    __syncthreads();

    // 2. a warp per row: w = softmax, dd = rowsum(dw w), dl = w (dw - dd);
    // the row's pad keys (Tp .. nkp) are zeros in both
    for (int row = warp; row < kPhF32Rows; row += kPhF32Threads / 32) {
      float* wr = Wc + row * nkp;
      float* lr = Lc + row * nkp;
      float mx = -CUDART_INF_F;
      for (int k = lane; k < tp; k += 32) mx = fmaxf(mx, wr[k]);
      mx = ph_warp_max(mx);
      float sum = 0.f;
      for (int k = lane; k < tp; k += 32) {
        const float e = exp2f(wr[k] - mx);
        wr[k] = e;
        sum += e;
      }
      sum = 1.f / warp_sum(sum);
      float dd = 0.f;
      for (int k = lane; k < tp; k += 32) {
        const float wv = wr[k] * sum;
        wr[k] = wv;
        dd = fmaf(lr[k], wv, dd);
      }
      dd = warp_sum(dd);
      for (int k = lane; k < tp; k += 32) lr[k] = wr[k] * (lr[k] - dd);
      if (tp + lane < nkp) wr[tp + lane] = lr[tp + lane] = 0.f;
    }
    __syncthreads();

    // 3. product 3: dq = dl k * s of the chunk's rows ...
    if (tid < kPhF32Rows * CL) {
      const int r = tid / CL, c0 = cl * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* lr = Lc + r * nkp;
      for (int k = 0; k < nkp; k += 4) {
        const float4 l4 = *reinterpret_cast<const float4*>(lr + k);
        const float lk[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 kv = *reinterpret_cast<const float4*>(Ks + (k + i) * LD + c0);
          acc.x = fmaf(lk[i], kv.x, acc.x);
          acc.y = fmaf(lk[i], kv.y, acc.y);
          acc.z = fmaf(lk[i], kv.z, acc.z);
          acc.w = fmaf(lk[i], kv.w, acc.w);
        }
      }
      const int row = ch * kPhF32Rows + r;
      if (row < tp)
        *reinterpret_cast<float4*>(ob + static_cast<size_t>(row) * ld + c0) =
            make_float4(acc.x * scale, acc.y * scale, acc.z * scale, acc.w * scale);
    }
    // ... products 4 and 5: dv += w^T g, dk += dl^T q over the chunk's rows
    for (int r = 0; r < kPhF32Rows; ++r) {
      const float4 g4 = *reinterpret_cast<const float4*>(Gc + r * LD + cl * 4);
      const float4 q4 = *reinterpret_cast<const float4*>(Qc + r * LD + cl * 4);
      const float gc[4] = {g4.x, g4.y, g4.z, g4.w}, qc[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int j = 0; j < NJ5; ++j) {
        const int key0 = 4 * kq + 4 * KQ * j;
        if (key0 < tp) {
          const float4 w4 = *reinterpret_cast<const float4*>(Wc + r * nkp + key0);
          const float4 l4 = *reinterpret_cast<const float4*>(Lc + r * nkp + key0);
          const float wk[4] = {w4.x, w4.y, w4.z, w4.w}, lk[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              dv[j][i][c] = fmaf(wk[i], gc[c], dv[j][i][c]);
              dk[j][i][c] = fmaf(lk[i], qc[c], dk[j][i][c]);
            }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ5; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 4 * kq + 4 * KQ * j + i;
      if (key < tp) {
        float* kr = ob + d + static_cast<size_t>(key) * ld + cl * 4;
        *reinterpret_cast<float4*>(kr) = make_float4(dk[j][i][0] * scale, dk[j][i][1] * scale,
                                                     dk[j][i][2] * scale, dk[j][i][3] * scale);
        *reinterpret_cast<float4*>(kr + d) =
            make_float4(dv[j][i][0], dv[j][i][1], dv[j][i][2], dv[j][i][3]);
      }
    }
}

template <int DH>
cudaError_t launch_bf16(const bf16* qkv, const bf16* g, bf16* dqkv, int batch, int tp, int d,
                        int heads, int valid_len, float scale, cudaStream_t stream) {
  const int nk = bwd_keys(tp);
  const size_t smem = bwd_smem_bytes(tp, tp, DH);
  if (nk > kPhMaxKeys || smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = nk <= 64    ? phased_bwd_kernel<DH, 64>
                : nk <= 128 ? phased_bwd_kernel<DH, 128>
                            : phased_bwd_kernel<DH, kPhMaxKeys>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int warps = nk / 16 < kPhWarps ? nk / 16 : kPhWarps;
  kernel<<<dim3(heads, batch), warps * 32, smem, stream>>>(qkv, g, dqkv, tp, d, valid_len, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const float* qkv, const float* g, float* dqkv, int batch, int tp, int d,
                       int heads, int valid_len, float scale, cudaStream_t stream) {
  const size_t smem = phased_f32_smem_bytes(tp, DH);
  if (tp > kPhF32MaxKeys || smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(phased_bwd_f32_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  phased_bwd_f32_kernel<DH><<<dim3(heads, batch), kPhF32Threads, smem, stream>>>(
      qkv, g, dqkv, tp, d, valid_len, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// qkv, dqkv [B, Tp, 3D] and g [B, Tp, D], all bf16 (f32 == 0) or all f32
// (f32 == 1), contiguous and 16-byte aligned; g zero on rows >= valid_len.
// Needs a head dim of 16, 32 or 64, 0 < valid_len <= Tp, B and H up to
// 65535, and Tp up to 208 in bf16 (its tiles within shared memory) or 256
// in f32.  One launch on ``stream``; returns its CUDA error (0 on success).
extern "C" int vsd_attention_qkv_bwd_phased(const void* qkv, const void* g, void* dqkv, int f32,
                                            int batch, int tp, int d, int num_heads,
                                            int valid_len, float scale, void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || tp <= 0 || d <= 0 || num_heads <= 0 ||
      num_heads > 65535 || d % num_heads || valid_len <= 0 || valid_len > tp)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / num_heads) {
#define VSD_HEAD_DIM(DH)                                                                  \
  case DH:                                                                                \
    return f32 ? launch_f32<DH>(static_cast<const float*>(qkv), static_cast<const float*>(g), \
                                static_cast<float*>(dqkv), batch, tp, d, num_heads,       \
                                valid_len, scale, s)                                      \
               : launch_bf16<DH>(static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), \
                                 static_cast<bf16*>(dqkv), batch, tp, d, num_heads,       \
                                 valid_len, scale, s);
    VSD_HEAD_DIM(16)
    VSD_HEAD_DIM(32)
    VSD_HEAD_DIM(64)
#undef VSD_HEAD_DIM
    default:
      return cudaErrorInvalidValue;
  }
}

// The attention backward on chip: one launch, a block per (head, item) that
// keeps the head on chip from its first product to its last, each of the
// five products computed once, no workspace in device memory.  Kernels 4
// (attention_qkv_bwd.cu), 5 (attention_qkv_bwd_phased.cu) and 13
// (attention_cp_bwd.cu) launch it; the key-tiled backward
// (attention_bwd_tiled.cu) takes the shapes past it.  Per head, for tq
// query rows against tk keys,
//
//   w  = softmax(q k^T * s), key columns >= valid_len at -1e30   (f32)
//   dv = cdt(w)^T g,  dw = g v^T,  dl = w (dw - rowsum(dw w))
//   dq = cdt(dl) k * s,  dk = cdt(dl)^T q * s
//
// where cdt is the input type (bf16, or f32 where the rounding is the
// identity).  The TPU kernels' rounding points: w is rounded to cdt only as
// the operand of dv, dl is formed from the f32 w and dw after each row's
// full sum and rounded to cdt only as the operand of dq and dk, every
// product sums in f32, the scale is applied after the dq and dk products.
// rowsum(dw w) is summed as written, not reassociated.  The softmax runs in
// base 2 (the scale times log2 e folded into the logits, exp2f, one
// reciprocal a row).  Rows with g = 0 give dw = 0, hence dl = 0: pad query
// rows add nothing and their dq is 0; masked key columns have w = 0
// exactly, so their dk and dv are 0.
//
// Addressing (the key-tiled backward's convention): separate q, k, v, g, dq,
// dk and dv base pointers; head h of item b at base + b * batch stride +
// h * Dh, rows a row stride apart; dq shares q's strides, dk and dv share
// k's.  Kernels 4 and 5 pass the thirds of qkv / dqkv [B, Tp, 3D] (row
// stride 3D) and g [B, Tp, D]; kernel 13 passes q, g, dq [B, Tq, D] and the
// halves of kv / dkv [B, Tk, 2D].  The batch offset is formed once a block
// in 64 bits (past 2^31 elements at ~4,660 items of Tp 200 x 3 x 768); the
// row strides stay 32-bit.
//
// bf16 (head dims 16, 32, 64; Tk rounded up to 16 at most 208): shared
// memory holds K and V [nk][Dh], the bf16 w and dl [nq][nk] (nq, nk: Tq and
// Tk rounded up to 16) and, where room is left, Q and G [nq][Dh], all with
// a 16-byte-chunk XOR swizzle in place of padding.
//   A. K, V (and Q and G where they have tiles of their own) staged by
//      16-byte cp.async in three groups, waited in order: K before the
//      first scores, V before the first dw, Q and G before part B, so Q
//      and G land while part A runs.  A warp owns 16 query rows at a time
//      and keeps their f32 scores, then w, in registers (KEYS / 2 a thread),
//      computes dw = g v^T into registers beside them, takes rowsum(dw w)
//      and dl = w (dw - rowsum) in f32, stores bf16 w and dl, and
//      accumulates dq = bf16(dl) k from the dl registers.  The warp's Q and
//      G fragments come from device memory, once a row group, G's issued
//      before the softmax and the next row group's Q during dq.
//   B. (Q and G staged over K and V when they had no room.)  A warp owns
//      16 keys and accumulates dv = w^T g and dk = dl^T q over every query
//      row from the stored tiles (ldmatrix.trans).
// Products: scores, dw, dq in A; dv, dk in B.  Holding w and dw together
// takes up to 255 registers a thread, so a block has 7 warps, one block an
// SM.  At Tq 104 / Tk 208 (two sequence ranks) part A's 7 row groups are
// one round of the 7 warps, and Q and G (28 KB) fit beside K, V, w and dl
// (146 KB); the square Tp 200 (226 KB without them) stages Q and G after
// part A.
//
// f32 (head dims 16, 32, 64; Tk up to 320, 448 or 576 by head dim; any Tq),
// plain FMAs (no TF32): a head's f32 w and dl do not fit on chip, so the
// query rows go through in chunks of 16 and dv and dk stay in registers
// across the chunks.  K and V [nkp][Dh + 4] (nkp: Tk rounded up to 4) are
// staged once; per chunk (its Q and G prefetched by cp.async during the
// previous one):
//   1. s = q k^T * s and dw = g v^T for the chunk's 16 rows (a thread: 4
//      rows x KEYS / 64 keys of each), into [16][nkp];
//   2. a warp per row: the softmax w, rowsum(dw w), dl = w (dw - rowsum);
//   3. dq = dl k * s of the chunk's rows, written out;
//      dv += w^T g and dk += dl^T q for every key (a thread: 4-key groups x
//      4 columns of each, in registers until the last chunk).
// Budget at Tk 200, Dh 64: 148 KB of shared memory, one block of 8 warps
// an SM, 128 accumulators a thread (KEYS 256; the 320-key instance holds
// 160).
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace vsd {
namespace {

constexpr int kOnWarps = 7;            // bf16: warps a block
constexpr int kOnMaxKeys = 208;        // bf16: keys (Tk rounded up to 16) a warp holds
constexpr int kOnRowsUnrolled = 208;   // bf16: query rows part B's loop unrolls
constexpr int kOnF32Threads = 256;     // f32: threads a block
constexpr int kOnF32Rows = 16;         // f32: query rows a chunk
constexpr int kOnF32Keys = 256;        // f32: keys of the smaller instance

// f32: keys of the larger instance, by head dim (dv and dk take 32
// accumulators per 4096 / Dh keys; kept at or under 160)
constexpr int on_f32_max_keys(int dh) { return dh == 64 ? 320 : dh == 32 ? 448 : 576; }

__host__ __device__ inline int bwd_keys(int t) { return (t + 15) / 16 * 16; }
__host__ __device__ inline int bwd_keys4(int t) { return (t + 3) / 4 * 4; }

// Element (r, c) of a [rows][DH] head tile: 16-byte chunk c / 8 of row r
// XOR-swizzled so 8 consecutive rows hit 8 different bank groups.  The
// swizzle depends only on a row's place within its 16-row tile, so a tile's
// shared address is its first tile's plus a constant.
template <int DH>
__device__ __forceinline__ int head_at(int r, int c) {
  constexpr int CPR = DH / 8;                          // chunks per row
  constexpr int RSH = CPR == 8 ? 0 : (CPR == 4 ? 1 : 2);
  return r * DH + ((((c >> 3) ^ (r >> RSH)) & (CPR - 1)) << 3) + (c & 7);
}

// Element (r, c) of a [rows][nk] tile (nk % 16 == 0): chunk XOR bit 2 of r.
__device__ __forceinline__ int sq_at(int nk, int r, int c) {
  return r * nk + (((c >> 3) ^ ((r >> 2) & 1)) << 3) + (c & 7);
}

// Stage rows [0, n) of one head's DH columns (row r at src + r * width)
// into a swizzled tile; rows past t are zeros.
template <int DH>
__device__ __forceinline__ void stage(bf16* tile, const bf16* src, size_t width, int t, int n) {
  constexpr int CPR = DH / 8;
  for (int c = threadIdx.x; c < n * CPR; c += blockDim.x) {
    const int r = c / CPR, col = (c % CPR) * 8;
    bf16* dst = tile + head_at<DH>(r, col);
    if (r < t)
      cp_async16(dst, src + r * width + col);
    else
      store_zero16(dst);
  }
}

// One backward call: base pointers, sizes and strides (elements).
struct OnArgs {
  const void *q, *k, *v, *g;
  void *dq, *dk, *dv;
  int tq, tk, ldq, ldk, ldg, valid_len;
  long long bsq, bsk, bsg;
  float scale;
};

// bf16: a block's shared memory; *own says whether Q and G get tiles of
// their own (staged during part A) or go over K and V after it.
__host__ __device__ inline size_t onchip_smem_bf16(int tq, int tk, int dh, bool* own) {
  const size_t nq = bwd_keys(tq), nk = bwd_keys(tk), nt = nq > nk ? nq : nk;
  const size_t apart = (2 * nk * dh + 2 * nq * nk + 2 * nq * dh) * sizeof(bf16);
  *own = apart <= kMaxSmem;
  return *own ? apart : (2 * nt * dh + 2 * nq * nk) * sizeof(bf16);
}

// f32: K and V [nkp][Dh + 4], the Q and G chunks [2][16][Dh + 4] each and
// the chunk's w and dl [16][nkp].
__host__ __device__ inline size_t onchip_smem_f32(int tk, int dh) {
  const size_t nkp = bwd_keys4(tk), ldf = dh + 4;
  return (2 * nkp * ldf + 4 * kOnF32Rows * ldf + 2 * kOnF32Rows * nkp) * sizeof(float);
}

// ---------------------------------------------------------------------------
// bf16: KEYS (64, 128 or kOnMaxKeys) bounds nk; NJ = KEYS / 8 score tiles a warp.
// ---------------------------------------------------------------------------
template <int DH, int KEYS>
__global__ void __launch_bounds__(kOnWarps * 32, 1)
    onchip_bwd_kernel(const OnArgs a, int own_qg) {
  constexpr int KK = DH / 16;  // k-steps over the head dim
  constexpr int NO = DH / 8;   // 8-column tiles of the head dim
  constexpr int NJ = KEYS / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tq = a.tq, tk = a.tk, ldq = a.ldq, ldg = a.ldg;
  const int nq = bwd_keys(tq), nk = bwd_keys(tk), ngq = nq / 16, ngk = nk / 16;
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t hoff = static_cast<size_t>(blockIdx.x) * DH;
  const long long b = blockIdx.y;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.bsq + hoff;
  const bf16* gb = static_cast<const bf16*>(a.g) + b * a.bsg + hoff;
  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.bsq + hoff;
  const int nt = own_qg ? nk : (nq > nk ? nq : nk);
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // K (then Q, without tiles of its own)
  bf16* Vs = Ks + nt * DH;                   // V (then G)
  bf16* Ws = Vs + nt * DH;                   // bf16 w  [query][key]
  bf16* Ls = Ws + nq * nk;                   // bf16 dl [query][key]
  bf16* Qs = own_qg ? Ls + nq * nk : Ks;
  bf16* Gs = own_qg ? Qs + nq * DH : Vs;

  stage<DH>(Ks, static_cast<const bf16*>(a.k) + b * a.bsk + hoff, a.ldk, tk, nk);
  cp_async_commit();  // group 0: K
  stage<DH>(Vs, static_cast<const bf16*>(a.v) + b * a.bsk + hoff, a.ldk, tk, nk);
  cp_async_commit();  // group 1: V
  if (own_qg) {
    stage<DH>(Qs, qb, ldq, tq, nq);
    stage<DH>(Gs, gb, ldg, tq, nq);
  }
  cp_async_commit();  // group 2: Q and G for part B (empty without tiles of their own)

  // ldmatrix.x4 row addresses: B fragments of two 8-key tiles (keys +0..7 /
  // +8..15, depth +0 / +8); .trans: two 8-column tiles of 16 rows
  const int kb_row = (lane & 7) + ((lane >> 4) << 3), kb_col = ((lane >> 3) & 1) << 3;
  const int tr_row = lane & 15, tr_col = (lane >> 4) << 3;

  // A fragments of 16 query rows (r0 .. r0 + 15; rows past tq zeros) of a
  // [tq][Dh] operand in device memory (rows at + r * ldr), every depth step
  auto frags = [&](uint32_t (&f)[KK][4], const bf16* base, int ldr, int r0) {
    const bool lo_in = r0 + g < tq, hi_in = r0 + g + 8 < tq;
    const bf16* lo = base + static_cast<size_t>(r0 + g) * ldr + t4 * 2;
    const bf16* hi = lo + 8 * static_cast<size_t>(ldr);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      f[kk][0] = lo_in ? ld_global_u32(lo + kk * 16) : 0u;
      f[kk][1] = hi_in ? ld_global_u32(hi + kk * 16) : 0u;
      f[kk][2] = lo_in ? ld_global_u32(lo + kk * 16 + 8) : 0u;
      f[kk][3] = hi_in ? ld_global_u32(hi + kk * 16 + 8) : 0u;
    }
  };
  // c[j] = f t^T for the staged [nk][Dh] tile t: the 16 rows against every
  // key (c[j][0..1] row g, keys 8 j + 2 t4 + {0, 1})
  auto rows_by_keys = [&](float (&c)[NJ][4], const uint32_t (&f)[KK][4], const bf16* tile) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t base = smem_addr(tile + head_at<DH>(kb_row, kk * 16 + kb_col));
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        if (jp * 16 < nk) {
          uint32_t t[4];
          ldmatrix_x4_at(t, base + jp * 16 * DH * 2);
          mma_16816(c[2 * jp], f[kk], t[0], t[1]);
          mma_16816(c[2 * jp + 1], f[kk], t[2], t[3]);
        }
      }
    }
  };

  // ---- A: a warp per 16 query rows ----
  const float scale = a.scale, scale2 = scale * kLog2e;
  uint32_t qa[KK][4];
  frags(qa, qb, ldq, warp * 16);  // in flight while K lands
  cp_async_wait<2>();
  __syncthreads();
  for (int rg = warp, it = 0; rg < ngq; rg += nw, ++it) {
    const int r0 = rg * 16;
    const bool lo_in = r0 + g < tq, hi_in = r0 + g + 8 < tq;
    float w[NJ][4];
    rows_by_keys(w, qa, Ks);  // product 1: the scores
    uint32_t ga[KK][4];
    frags(ga, gb, ldg, r0);  // in flight during the softmax
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[j][e] = masked_logit2(w[j][e], j * 8 + t4 * 2 + (e & 1), a.valid_len, tk, scale2);
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

    if (it == 0) {  // V; the warps without a row group wait below
      cp_async_wait<1>();
      __syncthreads();
    }
    float dl[NJ][4];
    rows_by_keys(dl, ga, Vs);  // product 2: dw = g v^T
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
    if (rg + nw < ngq) frags(qa, qb, ldq, r0 + 16 * nw);  // the next row group's, during dq
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
          uint32_t kt[4];
          ldmatrix_x4_trans_at(kt, smem_addr(Ks + head_at<DH>(tr_row, n * 8 + tr_col)) +
                                       t * 16 * DH * 2);
          mma_16816(dq[n], pa, kt[0], kt[1]);
          mma_16816(dq[n + 1], pa, kt[2], kt[3]);
        }
      }
    }
    bf16* orow = dqb + static_cast<size_t>(rlo) * ldq + t4 * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (lo_in)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16x2(dq[n][0] * scale, dq[n][1] * scale);
      if (hi_in)
        *reinterpret_cast<uint32_t*>(orow + 8 * static_cast<size_t>(ldq) + n * 8) =
            pack_bf16x2(dq[n][2] * scale, dq[n][3] * scale);
    }
  }
  if (warp >= ngq) {  // no row group (Tq under the block's rows): the V barrier above
    cp_async_wait<1>();
    __syncthreads();
  }
  __syncthreads();  // w and dl complete; K and V no longer read

  // ---- B: a warp per 16 keys ----
  if (!own_qg) {  // Q and G over K and V
    stage<DH>(Qs, qb, ldq, tq, nq);
    stage<DH>(Gs, gb, ldg, tq, nq);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  const int ldk = a.ldk;
  bf16* dkb = static_cast<bf16*>(a.dk) + b * a.bsk + hoff;
  bf16* dvb = static_cast<bf16*>(a.dv) + b * a.bsk + hoff;
  const uint32_t qs = smem_addr(Qs), gs = smem_addr(Gs);
  // ldmatrix.x4.trans of w^T / dl^T: tile i = lane / 8 covers queries
  // +8 (i / 2) and keys +8 (i % 2) of a 16 x 16 block
  const int qoff = (lane & 7) + ((lane >> 4) << 3);
  for (int kt = warp; kt < ngk; kt += nw) {
    const int k0 = kt * 16, koff = k0 + (((lane >> 3) & 1) << 3);
    const uint32_t wbase = smem_addr(Ws + sq_at(nk, qoff, koff));
    const uint32_t lbase = smem_addr(Ls + sq_at(nk, qoff, koff));
    float dv[NO][4], dk[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;
    // products 4 and 5 over the 16 query rows from q0
    auto rows16 = [&](int q0) {
      uint32_t wt[4], lt[4];
      ldmatrix_x4_trans_at(wt, wbase + q0 * nk * 2);
      ldmatrix_x4_trans_at(lt, lbase + q0 * nk * 2);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        const int col = head_at<DH>(tr_row, n * 8 + tr_col) * 2 + q0 * DH * 2;
        uint32_t f[4];
        ldmatrix_x4_trans_at(f, gs + col);  // product 4: dv
        mma_16816(dv[n], wt, f[0], f[1]);
        mma_16816(dv[n + 1], wt, f[2], f[3]);
        ldmatrix_x4_trans_at(f, qs + col);  // and 5: dk
        mma_16816(dk[n], lt, f[0], f[1]);
        mma_16816(dk[n + 1], lt, f[2], f[3]);
      }
    };
#pragma unroll
    for (int q0 = 0; q0 < kOnRowsUnrolled; q0 += 16) {  // unrolled: the next tiles' loads overlap
      if (q0 >= nq) break;
      rows16(q0);
    }
    for (int q0 = kOnRowsUnrolled; q0 < nq; q0 += 16) rows16(q0);
    const int key = k0 + g;
    bf16* krow = dkb + static_cast<size_t>(key) * ldk + t4 * 2;
    bf16* vrow = dvb + static_cast<size_t>(key) * ldk + t4 * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (key < tk) {
        *reinterpret_cast<uint32_t*>(krow + n * 8) = pack_bf16x2(dk[n][0] * scale, dk[n][1] * scale);
        *reinterpret_cast<uint32_t*>(vrow + n * 8) = pack_bf16x2(dv[n][0], dv[n][1]);
      }
      if (key + 8 < tk) {
        *reinterpret_cast<uint32_t*>(krow + 8 * static_cast<size_t>(ldk) + n * 8) =
            pack_bf16x2(dk[n][2] * scale, dk[n][3] * scale);
        *reinterpret_cast<uint32_t*>(vrow + 8 * static_cast<size_t>(ldk) + n * 8) =
            pack_bf16x2(dv[n][2], dv[n][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: chunks of kOnF32Rows query rows through one block of kOnF32Threads;
// KEYS bounds tk.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float on_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int DH, int KEYS>
__global__ void __launch_bounds__(kOnF32Threads, 1)
    onchip_bwd_f32_kernel(const OnArgs a) {
  constexpr int LD = DH + 4;                   // shared row stride (floats)
  constexpr int C4 = DH / 4;                   // float4 chunks a head row
  constexpr int CL = DH / 4;                   // column lanes of step 3 (4 columns each)
  constexpr int KQ = kOnF32Threads / CL;       // key-quad lanes of the dv / dk sums
  constexpr int NJ5 = (KEYS + 4 * KQ - 1) / (4 * KQ);
  constexpr int NJ2 = (KEYS + 63) / 64;        // keys a thread of step 1
  extern __shared__ __align__(128) unsigned char smem[];
  const int tq = a.tq, tk = a.tk, ldq = a.ldq, ldg = a.ldg;
  const int nkp = bwd_keys4(tk), nch = (tq + kOnF32Rows - 1) / kOnF32Rows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t hoff = static_cast<size_t>(blockIdx.x) * DH;
  const long long b = blockIdx.y;
  const float* qb = static_cast<const float*>(a.q) + b * a.bsq + hoff;
  const float* gb = static_cast<const float*>(a.g) + b * a.bsg + hoff;
  float* dqb = static_cast<float*>(a.dq) + b * a.bsq + hoff;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + nkp * LD;
  float* Qb = Vs + nkp * LD;               // [2][16][LD]
  float* Gb = Qb + 2 * kOnF32Rows * LD;    // [2][16][LD]
  float* Wc = Gb + 2 * kOnF32Rows * LD;    // [16][nkp]: s, then w
  float* Lc = Wc + kOnF32Rows * nkp;       // [16][nkp]: dw, then dl

  // rows [r0, r0 + n) of a head operand (row r at src + r * ldr) into dst
  // [n][LD]; rows at or past t are zeros
  auto stage_f32 = [&](float* dst, const float* src, int ldr, int r0, int n, int t) {
    for (int c = tid; c < n * C4; c += kOnF32Threads) {
      const int r = c / C4, col = (c % C4) * 4;
      float* p = dst + r * LD + col;
      if (r0 + r < t)
        cp_async16(p, src + static_cast<size_t>(r0 + r) * ldr + col);
      else
        store_zero16(p);
    }
  };
  stage_f32(Ks, static_cast<const float*>(a.k) + b * a.bsk + hoff, a.ldk, 0, nkp, tk);
  stage_f32(Vs, static_cast<const float*>(a.v) + b * a.bsk + hoff, a.ldk, 0, nkp, tk);
  stage_f32(Qb, qb, ldq, 0, kOnF32Rows, tq);
  stage_f32(Gb, gb, ldg, 0, kOnF32Rows, tq);
  cp_async_commit();

  const float scale = a.scale, scale2 = scale * kLog2e;
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
      stage_f32(Qb + nb * kOnF32Rows * LD, qb, ldq, (ch + 1) * kOnF32Rows, kOnF32Rows, tq);
      stage_f32(Gb + nb * kOnF32Rows * LD, gb, ldg, (ch + 1) * kOnF32Rows, kOnF32Rows, tq);
    }
    cp_async_commit();
    const float* Qc = Qb + (ch & 1) * kOnF32Rows * LD;
    const float* Gc = Gb + (ch & 1) * kOnF32Rows * LD;

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
          if (key < tk) {
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
        if (key < tk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            Wc[(rq * 4 + r) * nkp + key] = masked_logit2(s[r][j], key, a.valid_len, tk, scale2);
            Lc[(rq * 4 + r) * nkp + key] = dw[r][j];
          }
      }
    }
    __syncthreads();

    // 2. a warp per row: w = softmax, dd = rowsum(dw w), dl = w (dw - dd);
    // the row's pad keys (tk .. nkp) are zeros in both
    for (int row = warp; row < kOnF32Rows; row += kOnF32Threads / 32) {
      float* wr = Wc + row * nkp;
      float* lr = Lc + row * nkp;
      float mx = -CUDART_INF_F;
      for (int k = lane; k < tk; k += 32) mx = fmaxf(mx, wr[k]);
      mx = on_warp_max(mx);
      float sum = 0.f;
      for (int k = lane; k < tk; k += 32) {
        const float e = exp2f(wr[k] - mx);
        wr[k] = e;
        sum += e;
      }
      sum = 1.f / warp_sum(sum);
      float dd = 0.f;
      for (int k = lane; k < tk; k += 32) {
        const float wv = wr[k] * sum;
        wr[k] = wv;
        dd = fmaf(lr[k], wv, dd);
      }
      dd = warp_sum(dd);
      for (int k = lane; k < tk; k += 32) lr[k] = wr[k] * (lr[k] - dd);
      if (tk + lane < nkp) wr[tk + lane] = lr[tk + lane] = 0.f;
    }
    __syncthreads();

    // 3. product 3: dq = dl k * s of the chunk's rows ...
    if (tid < kOnF32Rows * CL) {
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
      const int row = ch * kOnF32Rows + r;
      if (row < tq)
        *reinterpret_cast<float4*>(dqb + static_cast<size_t>(row) * ldq + c0) =
            make_float4(acc.x * scale, acc.y * scale, acc.z * scale, acc.w * scale);
    }
    // ... products 4 and 5: dv += w^T g, dk += dl^T q over the chunk's rows
    for (int r = 0; r < kOnF32Rows; ++r) {
      const float4 g4 = *reinterpret_cast<const float4*>(Gc + r * LD + cl * 4);
      const float4 q4 = *reinterpret_cast<const float4*>(Qc + r * LD + cl * 4);
      const float gc[4] = {g4.x, g4.y, g4.z, g4.w}, qc[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int j = 0; j < NJ5; ++j) {
        const int key0 = 4 * kq + 4 * KQ * j;
        if (key0 < tk) {
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
  const int ldk = a.ldk;
  float* dkb = static_cast<float*>(a.dk) + b * a.bsk + hoff;
  float* dvb = static_cast<float*>(a.dv) + b * a.bsk + hoff;
#pragma unroll
  for (int j = 0; j < NJ5; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 4 * kq + 4 * KQ * j + i;
      if (key < tk) {
        *reinterpret_cast<float4*>(dkb + static_cast<size_t>(key) * ldk + cl * 4) =
            make_float4(dk[j][i][0] * scale, dk[j][i][1] * scale, dk[j][i][2] * scale,
                        dk[j][i][3] * scale);
        *reinterpret_cast<float4*>(dvb + static_cast<size_t>(key) * ldk + cl * 4) =
            make_float4(dv[j][i][0], dv[j][i][1], dv[j][i][2], dv[j][i][3]);
      }
    }
}

// What a launch for tq query rows against tk keys at head dim dh runs: the
// instance (keys), the warps of a block, its dynamic shared memory and, in
// bf16, whether Q and G get tiles of their own.  False where the core does
// not hold the head.  The launch below and vsd_onchip_bwd_config (the
// library's report of it) both read this one choice.
struct OnConfig {
  int keys, warps;
  size_t smem;
  bool own;
};

inline bool onchip_config(int tq, int tk, int dh, bool f32, OnConfig* c) {
  if ((dh != 16 && dh != 32 && dh != 64) || tq <= 0 || tk <= 0) return false;
  if (!f32) {
    const int nk = bwd_keys(tk), nq = bwd_keys(tq);
    c->smem = onchip_smem_bf16(tq, tk, dh, &c->own);
    if (nk > kOnMaxKeys || c->smem > kMaxSmem) return false;
    c->keys = nk <= 64 ? 64 : nk <= 128 ? 128 : kOnMaxKeys;
    const int groups = (nq > nk ? nq : nk) / 16;
    c->warps = groups < kOnWarps ? groups : kOnWarps;
    return true;
  }
  c->smem = onchip_smem_f32(tk, dh);
  c->own = false;
  if (tk > on_f32_max_keys(dh) || c->smem > kMaxSmem) return false;
  c->keys = tk <= kOnF32Keys ? kOnF32Keys : on_f32_max_keys(dh);
  c->warps = kOnF32Threads / 32;
  return true;
}

template <int DH>
cudaError_t launch_onchip_dh(const OnArgs& a, bool f32, int batch, int heads,
                             cudaStream_t stream) {
  OnConfig c;
  if (!onchip_config(a.tq, a.tk, DH, f32, &c)) return cudaErrorInvalidValue;
  const dim3 grid(heads, batch);
  cudaError_t e;
  if (!f32) {
    auto kernel = c.keys == 64    ? onchip_bwd_kernel<DH, 64>
                  : c.keys == 128 ? onchip_bwd_kernel<DH, 128>
                                  : onchip_bwd_kernel<DH, kOnMaxKeys>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(c.smem));
    if (e != cudaSuccess) return e;
    kernel<<<grid, c.warps * 32, c.smem, stream>>>(a, c.own ? 1 : 0);
    return cudaGetLastError();
  }
  auto kernel = c.keys == kOnF32Keys ? onchip_bwd_f32_kernel<DH, kOnF32Keys>
                                     : onchip_bwd_f32_kernel<DH, on_f32_max_keys(DH)>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(c.smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, c.warps * 32, c.smem, stream>>>(a);
  return cudaGetLastError();
}

// One launch of the backward on ``stream`` (bf16, or f32 with ``f32``):
// head dims 16, 32 and 64; bf16 Tk up to 208 with the block's tiles within
// shared memory, f32 Tk up to on_f32_max_keys(Dh) (any Tq); 0 < valid_len
// <= Tk; B and heads up to 65535; row strides multiples of 8 (4 in f32) and
// pointers 16-byte aligned.  Returns the launch's CUDA error (0 on success).
inline cudaError_t launch_onchip_bwd(const OnArgs& a, bool f32, int batch, int heads, int dh,
                                     cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 || a.tq <= 0 || a.tk <= 0 ||
      a.valid_len <= 0 || a.valid_len > a.tk)
    return cudaErrorInvalidValue;
  switch (dh) {
    case 16:
      return launch_onchip_dh<16>(a, f32, batch, heads, stream);
    case 32:
      return launch_onchip_dh<32>(a, f32, batch, heads, stream);
    case 64:
      return launch_onchip_dh<64>(a, f32, batch, heads, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The backward on the fused projection (kernels 4 and 5): qkv, dqkv [B, Tp,
// 3D] and g [B, Tp, D], all bf16 (f32 == 0) or all f32, contiguous; g zero
// on rows >= valid_len.
inline int onchip_qkv_bwd(const void* qkv, const void* g, void* dqkv, int f32, int batch,
                          int tp, int d, int heads, int valid_len, float scale, void* stream) {
  if (tp <= 0 || d <= 0 || heads <= 0 || d % heads) return cudaErrorInvalidValue;
  const size_t es = f32 ? sizeof(float) : sizeof(bf16);
  const char* p = static_cast<const char*>(qkv);
  char* o = static_cast<char*>(dqkv);
  const long long bs = static_cast<long long>(tp) * 3 * d;
  const OnArgs a{p,         p + d * es,     p + 2 * d * es, g,     o,  o + d * es,
                 o + 2 * d * es, tp,         tp,             3 * d, 3 * d, d,
                 valid_len, bs,             bs,             static_cast<long long>(tp) * d,
                 scale};
  return launch_onchip_bwd(a, f32 != 0, batch, heads, d / heads,
                           static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace vsd

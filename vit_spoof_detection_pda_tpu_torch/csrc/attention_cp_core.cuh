// The core of kernel 12 (csrc/attention_cp.cu): one query tile of one
// (head, item) of the rectangular attention
//
//   out = softmax(q k^T * scale) v,  key columns >= valid_len at -1e30,
//
// q [tq][DH] against k, v [tk][DH] (row strides ldq, ldk, ldo), in bf16
// (mma.sync) or f32 (FMAs, never TF32).  Rounding points as the TPU
// kernel's: f32 logits, the f32 softmax, the weights normalised and then
// rounded to v's type, f32 sums, one final rounding.  The design and its
// budget are described in attention_cp.cu.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace vsd {
namespace {

constexpr int kCpMaxWarps = 7;        // bf16: warps of 16 query rows a block
constexpr int kCpF32Warps = 8;        // f32 two-pass: 8 warps of 16 query rows
constexpr int kCpOnePassKeys = 208;   // keys a one-pass instance holds in registers
constexpr int kCpChunk = 64;          // keys a cp.async group of K (one-pass form)
constexpr int kCpF32WStride = 20;     // f32 weight chunk row: 16 rows + 4 (banks)

__host__ __device__ inline int cp_keys16(int tk) { return (tk + 15) / 16 * 16; }
__host__ __device__ inline int cp_keys8(int tk) { return (tk + 7) / 8 * 8; }

// bf16 shared memory: K and V [nk][DH + 8] and, in the one-pass form, the
// tile's query rows [warps * 16][DH + 8] (nk = tk rounded up to 16, or the
// two-pass form's key tile).
__host__ __device__ inline size_t cp_smem_bytes(bool one_pass, int warps, int tk, int dh) {
  return ((one_pass ? static_cast<size_t>(warps) * 16 : 0) + 2 * static_cast<size_t>(cp_keys16(tk))) *
         (dh + 8) * sizeof(bf16);
}

// two-pass f32 shared memory: K and V [nk][DH + 4] (nk = tk rounded up to
// 8, or the key tile) and each warp's weight chunk [32 keys][kCpF32WStride].
__host__ __device__ inline size_t cp_f32_smem_bytes(int tk, int dh) {
  return (2 * static_cast<size_t>(cp_keys8(tk)) * (dh + 4) +
          static_cast<size_t>(kCpF32Warps) * 32 * kCpF32WStride) *
         sizeof(float);
}

// Keys a two-pass block stages at once: all of them (rounded up to 16 in
// bf16, 8 in f32) where K and V fit its shared memory, else the key-tiled
// form, which restages K (pass 1) and K and V (pass 2) tile by tile, in
// tiles of kCpKeyTile (bf16) or kCpF32KeyTile (f32) keys: small enough for
// two or more blocks an SM (at 128 f32 keys the form ran 1.6x faster than
// with the largest tile that fits, 384: PERF.md, PR 11).
constexpr int kCpKeyTile = 256, kCpF32KeyTile = 128;
__host__ __device__ inline int cp_key_tile(int tk, int dh, bool f32) {
  if (!f32) {
    const int nk = cp_keys16(tk);
    return nk * 2 * static_cast<size_t>(dh + 8) * sizeof(bf16) <= kMaxSmem ? nk : kCpKeyTile;
  }
  const size_t fixed = static_cast<size_t>(kCpF32Warps) * 32 * kCpF32WStride * sizeof(float);
  const int nk = cp_keys8(tk);
  return fixed + nk * 2 * static_cast<size_t>(dh + 4) * sizeof(float) <= kMaxSmem
             ? nk
             : kCpF32KeyTile;
}

// Query tiles of 16-row groups, split evenly over at most max_warps warps.
inline void cp_tiles(int tq, int max_warps, int* tiles, int* warps) {
  const int groups = (tq + 15) / 16;
  *tiles = (groups + max_warps - 1) / max_warps;
  *warps = (groups + *tiles - 1) / *tiles;
}

// cp.async.wait_group with a count that is a constant only after unrolling.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<8>(); break;
  }
}

// ---------------------------------------------------------------------------
// bf16, the one-pass form (nk <= KEYS): Q staged once, K in chunks of
// kCpChunk keys, each its own cp.async group, V last; every score of the
// warp's 16 rows stays in registers, so the softmax is exact in one pass.
// The two-pass form for longer key blocks is cp_rows_bf16_tiles.  The
// block's warps own query rows q0 + 16 w .. + 15; warps past tq idle but
// take part in the barriers.
// ---------------------------------------------------------------------------
template <int DH, int KEYS>
__device__ __forceinline__ void cp_rows_bf16(const bf16* __restrict__ q, int ldq,
                                             const bf16* __restrict__ k,
                                             const bf16* __restrict__ v, int ldk,
                                             bf16* __restrict__ out, int ldo, int tq, int tk,
                                             int valid_len, float scale, int q0, bf16* smem) {
  static_assert(KEYS > 0, "the one-pass form holds a fixed number of keys");
  constexpr int LD = DH + 8;   // shared row stride (elements), 16-byte multiple
  constexpr int KK = DH / 16;  // k-steps of Q K^T
  constexpr int NO = DH / 8;   // 8-column output tiles
  constexpr int CPR = DH / 8;  // 16-byte chunks a row
  constexpr int NCH = (KEYS + kCpChunk - 1) / kCpChunk;
  const int nk = cp_keys16(tk);
  const int nw = blockDim.x >> 5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale2 = scale * kLog2e;
  bf16* Qs = smem;                                   // [nw * 16][LD]
  bf16* Ks = Qs + nw * 16 * LD;                      // [nk][LD]
  bf16* Vs = Ks + nk * LD;                           // [nk][LD]

  auto stage_rows = [&](bf16* dst0, const bf16* src, int r0, int r1) {
    for (int c = tid; c < (r1 - r0) * CPR; c += blockDim.x) {
      const int r = r0 + c / CPR, col = (c % CPR) * 8;
      bf16* dst = dst0 + r * LD + col;
      if (r < tk)
        cp_async16(dst, src + static_cast<size_t>(r) * ldk + col);
      else
        store_zero16(dst);  // keys past tk: zeros, so zero weights meet no garbage
    }
  };
  for (int c = tid; c < nw * 16 * CPR; c += blockDim.x) {  // group 0: Q
    const int r = c / CPR, col = (c % CPR) * 8;
    bf16* dst = Qs + r * LD + col;
    if (q0 + r < tq)
      cp_async16(dst, q + static_cast<size_t>(q0 + r) * ldq + col);
    else
      store_zero16(dst);
  }
  cp_async_commit();
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {  // groups 1 .. NCH: K chunks (empty past nk)
    stage_rows(Ks, k, min(ch * kCpChunk, nk), min((ch + 1) * kCpChunk, nk));
    cp_async_commit();
  }
  stage_rows(Vs, v, 0, nk);  // the last group: V
  cp_async_commit();

  const int r0 = q0 + warp * 16;  // this warp's first query row
  const bool active = r0 < tq;
  // ldmatrix.x4 row addresses: B fragments of two 8-key tiles of K (keys
  // +0..7 / +8..15, depth +0 / +8), and of two 8-column tiles of V (trans)
  const uint32_t kfrag =
      smem_addr(Ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3));
  const uint32_t vfrag = smem_addr(Vs + (lane & 15) * LD + ((lane >> 4) << 3));
  auto pv_tile = [&](float (&o)[NO][4], const uint32_t (&pa)[4], int key0) {  // o += P V
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      uint32_t vb[4];
      ldmatrix_x4_trans_at(vb, vfrag + (key0 * LD + n * 8) * 2);
      mma_16816(o[n], pa, vb[0], vb[1]);
      mma_16816(o[n + 1], pa, vb[2], vb[3]);
    }
  };
  auto score_pair = [&](float (&s0)[4], float (&s1)[4], const uint32_t (&qa)[4], int key0,
                        int kk) {
    uint32_t kb[4];
    ldmatrix_x4_at(kb, kfrag + (key0 * LD + kk * 16) * 2);
    mma_16816(s0, qa, kb[0], kb[1]);
    mma_16816(s1, qa, kb[2], kb[3]);
  };

  constexpr int NJ = KEYS / 8;  // 8-key score tiles a warp holds
  const uint32_t qfrag = smem_addr(
      Qs + (warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3));
  float s[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // Q K^T chunk by chunk, each as soon as its group has landed
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    cp_async_wait_upto(NCH - ch);  // Q and K chunks 0 .. ch (V and later chunks pending)
    __syncthreads();
    if (active && ch * kCpChunk < nk) {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t qa[4];
        ldmatrix_x4_at(qa, qfrag + kk * 32);
#pragma unroll
        for (int jp = 0; jp < kCpChunk / 16; ++jp) {
          const int key0 = ch * kCpChunk + jp * 16;
          if (key0 < KEYS && key0 < nk) score_pair(s[key0 / 8], s[key0 / 8 + 1], qa, key0, kk);
        }
      }
    }
  }
  // the exact softmax of each row (the four lanes of a quad share a row)
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = masked_logit2(s[j][e], j * 8 + t4 * 2 + (e & 1), valid_len, tk, scale2);
      m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
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
      s[j][e] = exp2f(s[j][e] - m[e >> 1]);
      l[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    l[hr] = 1.f / l[hr];
  }
  // normalised, then rounded to bf16: the A fragments of P V, packed
  // before the products so the f32 scores are dead when o is live
  uint32_t pa[NJ / 2][4];
#pragma unroll
  for (int t = 0; t < NJ / 2; ++t) {
    const float(&lo)[4] = s[2 * t];
    const float(&hi)[4] = s[2 * t + 1];
    pa[t][0] = pack_bf16x2(lo[0] * l[0], lo[1] * l[0]);
    pa[t][1] = pack_bf16x2(lo[2] * l[1], lo[3] * l[1]);
    pa[t][2] = pack_bf16x2(hi[0] * l[0], hi[1] * l[0]);
    pa[t][3] = pack_bf16x2(hi[2] * l[1], hi[3] * l[1]);
  }
  cp_async_wait<0>();  // V, in flight during the softmax
  __syncthreads();
  if (active) {
    float o[NO][4];  // declared here: live only after the scores are packed
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < NJ / 2; ++t)
      if (t * 16 < nk) pv_tile(o, pa[t], t * 16);
    // through this warp's own Q rows (read above) to 16-byte row stores
    bf16* os = Qs + warp * 16 * LD;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(os + g * LD + n * 8 + t4 * 2) = pack_bf16x2(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + n * 8 + t4 * 2) =
          pack_bf16x2(o[n][2], o[n][3]);
    }
    __syncwarp();
    for (int c = lane; c < 16 * CPR; c += 32) {
      const int r = c / CPR, col = (c % CPR) * 8;
      if (r0 + r < tq)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(r0 + r) * ldo + col) =
            *reinterpret_cast<const uint4*>(os + r * LD + col);
    }
  }
}

// bf16, two passes over key tiles of kt keys (cp_key_tile; a multiple of
// kCpChunk, or every key when K and V fit): Q fragments from device memory;
// pass 1 the online max and sum over the tiles of K, pass 2 the scores
// again over the tiles of K and V, normalised, rounded, and P V.  With one
// tile, K and V are staged once (V lands during pass 1); with more, each
// pass restages its tiles.
template <int DH>
__device__ __forceinline__ void cp_rows_bf16_tiles(const bf16* __restrict__ q, int ldq,
                                                   const bf16* __restrict__ k,
                                                   const bf16* __restrict__ v, int ldk,
                                                   bf16* __restrict__ out, int ldo, int tq,
                                                   int tk, int valid_len, float scale, int q0,
                                                   int kt, bf16* smem) {
  constexpr int LD = DH + 8, KK = DH / 16, NO = DH / 8, CPR = DH / 8;
  constexpr int NJ = kCpChunk / 8;
  const int nk = cp_keys16(tk), nt = (nk + kt - 1) / kt;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale2 = scale * kLog2e;
  bf16* Ks = smem;          // [kt][LD]
  bf16* Vs = Ks + kt * LD;  // [kt][LD]
  auto stage = [&](bf16* dst, const bf16* src, int t0) {  // keys t0 .. t0 + kt - 1
    for (int c = tid; c < kt * CPR; c += blockDim.x) {
      const int r = c / CPR, col = (c % CPR) * 8;
      bf16* p = dst + r * LD + col;
      if (t0 + r < tk)
        cp_async16(p, src + static_cast<size_t>(t0 + r) * ldk + col);
      else
        store_zero16(p);  // keys past tk: zeros, so zero weights meet no garbage
    }
  };
  const int r0 = q0 + warp * 16;
  const bool active = r0 < tq;
  const uint32_t kfrag =
      smem_addr(Ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3));
  const uint32_t vfrag = smem_addr(Vs + (lane & 15) * LD + ((lane >> 4) << 3));
  uint32_t qa[KK][4];
  {
    const bool lo_in = r0 + g < tq, hi_in = r0 + g + 8 < tq;
    const bf16* qlo = q + static_cast<size_t>(r0 + g) * ldq + t4 * 2;
    const bf16* qhi = qlo + 8 * static_cast<size_t>(ldq);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      qa[kk][0] = lo_in ? ld_global_u32(qlo + kk * 16) : 0u;
      qa[kk][1] = hi_in ? ld_global_u32(qhi + kk * 16) : 0u;
      qa[kk][2] = lo_in ? ld_global_u32(qlo + kk * 16 + 8) : 0u;
      qa[kk][3] = hi_in ? ld_global_u32(qhi + kk * 16 + 8) : 0u;
    }
  }
  // the scores of chunk kc0 (tile-relative) of the tile at key t0
  auto chunk_scores = [&](float (&s)[NJ][4], int t0, int kc0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp)
        if (t0 + kc0 + jp * 16 < nk) {
          uint32_t kb[4];
          ldmatrix_x4_at(kb, kfrag + ((kc0 + jp * 16) * LD + kk * 16) * 2);
          mma_16816(s[2 * jp], qa[kk], kb[0], kb[1]);
          mma_16816(s[2 * jp + 1], qa[kk], kb[2], kb[3]);
        }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = masked_logit2(s[j][e], t0 + kc0 + j * 8 + t4 * 2 + (e & 1), valid_len, tk,
                                scale2);
  };

  stage(Ks, k, 0);
  cp_async_commit();
  if (nt == 1) {
    stage(Vs, v, 0);  // in flight through pass 1
    cp_async_commit();
  }
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int it = 0; it < nt; ++it) {  // pass 1
    const int t0 = it * kt;
    if (it) {
      __syncthreads();  // the last tile is no longer read
      stage(Ks, k, t0);
      cp_async_commit();
    }
    if (nt == 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    for (int kc0 = 0; kc0 < kt && t0 + kc0 < nk; kc0 += kCpChunk) {
      float s[NJ][4];
      chunk_scores(s, t0, kc0);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[hr], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          sum += exp2f(s[j][2 * hr] - mn) + exp2f(s[j][2 * hr + 1] - mn);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[hr] = l[hr] * exp2f(m[hr] - mn) + sum;
        m[hr] = mn;
      }
    }
  }
  l[0] = 1.f / l[0];
  l[1] = 1.f / l[1];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int it = 0; it < nt; ++it) {  // pass 2
    const int t0 = it * kt;
    if (nt > 1) {
      __syncthreads();
      stage(Ks, k, t0);
      stage(Vs, v, t0);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    for (int kc0 = 0; kc0 < kt && t0 + kc0 < nk; kc0 += kCpChunk) {
      float s[NJ][4];
      chunk_scores(s, t0, kc0);
#pragma unroll
      for (int t = 0; t < NJ / 2; ++t) {
        if (t0 + kc0 + t * 16 < nk) {
          const float(&lo)[4] = s[2 * t];
          const float(&hi)[4] = s[2 * t + 1];
          const uint32_t pa[4] = {
              pack_bf16x2(exp2f(lo[0] - m[0]) * l[0], exp2f(lo[1] - m[0]) * l[0]),
              pack_bf16x2(exp2f(lo[2] - m[1]) * l[1], exp2f(lo[3] - m[1]) * l[1]),
              pack_bf16x2(exp2f(hi[0] - m[0]) * l[0], exp2f(hi[1] - m[0]) * l[0]),
              pack_bf16x2(exp2f(hi[2] - m[1]) * l[1], exp2f(hi[3] - m[1]) * l[1])};
#pragma unroll
          for (int n = 0; n < NO; n += 2) {
            uint32_t vb[4];
            ldmatrix_x4_trans_at(vb, vfrag + ((kc0 + t * 16) * LD + n * 8) * 2);
            mma_16816(o[n], pa, vb[0], vb[1]);
            mma_16816(o[n + 1], pa, vb[2], vb[3]);
          }
        }
      }
    }
  }
  if (!active) return;
  const int row = r0 + g;
  bf16* orow = out + static_cast<size_t>(row) * ldo + t4 * 2;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (row < tq) *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16x2(o[n][0], o[n][1]);
    if (row + 8 < tq)
      *reinterpret_cast<uint32_t*>(orow + 8 * static_cast<size_t>(ldo) + n * 8) =
          pack_bf16x2(o[n][2], o[n][3]);
  }
}

// ---------------------------------------------------------------------------
// f32, plain FMAs.  Lane (rq = lane / 8, kl = lane % 8) of a warp holds
// query rows 4 rq .. + 3 of its 16 against every 8th key (kl, kl + 8, ...),
// so each 16-byte K read feeds 16 FMAs and each q read (device memory, L1)
// a whole chunk of keys.  P V goes through the warp's weight chunk wb
// [keys][kCpF32WStride] in shared memory: lane (rq, cg = lane % 8) sums
// rows 4 rq .. + 3 by DH / 8 columns, read 16 bytes at a time where DH is a
// multiple of 32 (CpF32::col).
// ---------------------------------------------------------------------------
template <int DH>
struct CpF32 {
  static constexpr int LD = DH + 4;   // shared row stride (floats), 16-byte multiple
  static constexpr int C4 = DH / 4;   // float4 chunks a row
  static constexpr int NO = DH / 8;   // output columns a lane in P V
  static constexpr int VW = DH % 32 == 0 ? 4 : 2;  // floats a lane reads of a V row at once
  static constexpr int NV = NO / VW;               // such reads a V row
  // the first of lane cg's VW columns in read i (columns VW cg + 8 VW i ..)
  static __device__ __forceinline__ int col(int cg, int i) { return VW * cg + 8 * VW * i; }
  static __device__ __forceinline__ void ld(float* d, const float* p) {
    if constexpr (VW == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      d[0] = t.x, d[1] = t.y, d[2] = t.z, d[3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(p);
      d[0] = t.x, d[1] = t.y;
    }
  }
  static __device__ __forceinline__ void st(float* p, const float* d) {
    if constexpr (VW == 4)
      *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
    else
      *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  }

  // rows [r0, r1) of a head operand (row r at src + r * ldk) into dst rows
  // [r0, r1) of stride LD; rows at or past tk are zeros
  static __device__ __forceinline__ void stage(float* dst0, const float* src, int ldk, int tk,
                                               int r0, int r1) {
    for (int c = threadIdx.x; c < (r1 - r0) * C4; c += blockDim.x) {
      const int r = r0 + c / C4, col = (c % C4) * 4;
      float* dst = dst0 + r * LD + col;
      if (r < tk)
        cp_async16(dst, src + static_cast<size_t>(r) * ldk + col);
      else
        store_zero16(dst);
    }
  }
  static __device__ __forceinline__ void load_q(float4 (&qv)[4], const float* q, int ldq, int rb,
                                                int tq, int c) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      qv[r] = rb + r < tq ? __ldg(reinterpret_cast<const float4*>(
                                q + static_cast<size_t>(rb + r) * ldq + c))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float dot4(float s, const float4& a, const float4& b) {
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    return fmaf(a.w, b.w, s);
  }
  static __device__ __forceinline__ float row_max(float x) {  // over the 8 key lanes
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  }
  static __device__ __forceinline__ float row_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    return x + __shfl_xor_sync(0xffffffffu, x, 4);
  }
  // o += w V over 8 keys key0 .. key0 + 7 whose weights are wb rows w0 ..
  static __device__ __forceinline__ void pv8(float (&o)[4][NO], const float* wb, int w0,
                                             const float* Vs, int key0, int rq, int cg) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float4 w4 = *reinterpret_cast<const float4*>(wb + (w0 + kk) * kCpF32WStride + rq * 4);
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
      const float* vr = Vs + (key0 + kk) * LD;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float vv[VW];
        ld(vv, vr + col(cg, i));
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < VW; ++e) o[r][VW * i + e] = fmaf(w[r], vv[e], o[r][VW * i + e]);
      }
    }
  }
  static __device__ __forceinline__ void zero(float (&o)[4][NO]) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < NO; ++i) o[r][i] = 0.f;
  }
  static __device__ __forceinline__ void store(const float (&o)[4][NO], float* out, int ldo,
                                               int rb, int tq, int cg) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (rb + r >= tq) continue;
      float* orow = out + static_cast<size_t>(rb + r) * ldo;
#pragma unroll
      for (int i = 0; i < NV; ++i) st(orow + col(cg, i), &o[r][VW * i]);
    }
  }
};

constexpr int kCpF32SplitWarps = 16;  // one-pass f32: two warps a 16-row group

// one-pass f32 shared memory: K and V [nk][DH + 4], each warp's weight chunk
// [32][kCpF32WStride], the halves' row max and sum [2][8 groups][2][16], the
// second half's partial outputs [8 groups][16][DH]
__host__ __device__ inline size_t cp_f32_split_smem_bytes(int tk, int dh) {
  return (2 * static_cast<size_t>(cp_keys8(tk)) * (dh + 4) +
          static_cast<size_t>(kCpF32SplitWarps) * 32 * kCpF32WStride + 2 * 8 * 2 * 16 +
          static_cast<size_t>(8) * 16 * dh) *
         sizeof(float);
}

// One pass (nk <= KEYS), 16 warps: warps 2 g and 2 g + 1 share query rows
// q0 + 16 g .. + 15, the first taking the even 8-key tiles, the second the
// odd ones (14 warps busy at Tq 104, where one warp a group left 7 an SM).
// Every score of a warp stays in registers; the halves trade their rows'
// max and sum through shared memory, and the second half's partial output
// is added to the first's before the store.  K arrives in chunks of 16
// columns (every key), each its own cp.async group, V last: Q K^T runs on a
// chunk as soon as it lands, and each q read feeds all of a warp's keys.
// Loops around the unrolled key tiles stay rolled, which keeps the code in
// the instruction cache (fully unrolled, the form ran 1.5x slower).
template <int DH, int KEYS>
__device__ __forceinline__ void cp_rows_f32_split(const float* __restrict__ q, int ldq,
                                                  const float* __restrict__ k,
                                                  const float* __restrict__ v, int ldk,
                                                  float* __restrict__ out, int ldo, int tq,
                                                  int tk, int valid_len, float scale, int q0,
                                                  float* smem) {
  using F = CpF32<DH>;
  constexpr int LD = F::LD, NO = F::NO, VW = F::VW, NV = F::NV;
  constexpr int NJH = (KEYS / 8 + 1) / 2;  // 8-key tiles a warp: tile 2 jl + half
  constexpr int NCC = DH / 16;             // column chunks of K
  const int nk = cp_keys8(tk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rq = lane >> 3, kl = lane & 7;
  const int grp = warp >> 1, half = warp & 1;
  const float scale2 = scale * kLog2e;
  float* Ks = smem;
  float* Vs = Ks + nk * LD;
  float* wb = Vs + nk * LD + warp * 32 * kCpF32WStride;                // [32][20]
  float* smax = Vs + nk * LD + kCpF32SplitWarps * 32 * kCpF32WStride;  // [8][2][16]
  float* ssum = smax + 8 * 2 * 16;                                     // [8][2][16]
  float* ox = ssum + 8 * 2 * 16;                                       // [8][16][DH]

#pragma unroll
  for (int cc = 0; cc < NCC; ++cc) {
    for (int c = threadIdx.x; c < nk * 4; c += blockDim.x) {
      const int r = c >> 2, col = cc * 16 + (c & 3) * 4;
      float* dst = Ks + r * LD + col;
      if (r < tk)
        cp_async16(dst, k + static_cast<size_t>(r) * ldk + col);
      else
        store_zero16(dst);
    }
    cp_async_commit();
  }
  F::stage(Vs, v, ldk, tk, 0, nk);
  cp_async_commit();

  const int rb = q0 + grp * 16 + rq * 4;  // this lane's first query row
  const bool active = q0 + grp * 16 < tq;
  float s[4][NJH];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJH; ++j) s[r][j] = 0.f;
#pragma unroll 1
  for (int cc = 0; cc < NCC; ++cc) {
    cp_async_wait_upto(NCC - cc);  // columns 0 .. 16 cc + 15 (V and later chunks pending)
    __syncthreads();
    if (active) {
#pragma unroll 1
      for (int c = cc * 16; c < cc * 16 + 16; c += 4) {
        float4 qv[4];
        F::load_q(qv, q, ldq, rb, tq, c);
#pragma unroll
        for (int j = 0; j < NJH; ++j) {
          const int key0 = (2 * j + half) * 8;
          if (key0 < nk) {
            const float4 kv = *reinterpret_cast<const float4*>(Ks + (key0 + kl) * LD + c);
#pragma unroll
            for (int r = 0; r < 4; ++r) s[r][j] = F::dot4(s[r][j], qv[r], kv);
          }
        }
      }
    }
  }
  // the row max and sum over both halves
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NJH; ++j) {
      s[r][j] = masked_logit2(s[r][j], (2 * j + half) * 8 + kl, valid_len, tk, scale2);
      m[r] = fmaxf(m[r], s[r][j]);
    }
    m[r] = F::row_max(m[r]);
    if (kl == 0) smax[(grp * 2 + half) * 16 + rq * 4 + r] = m[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = fmaxf(m[r], smax[(grp * 2 + (half ^ 1)) * 16 + rq * 4 + r]);
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NJH; ++j) {
      s[r][j] = exp2f(s[r][j] - m[r]);
      l[r] += s[r][j];
    }
    l[r] = F::row_sum(l[r]);
    if (kl == 0) ssum[(grp * 2 + half) * 16 + rq * 4 + r] = l[r];
  }
  cp_async_wait<0>();  // V, in flight during the softmax
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r)  // the even tiles' sum first, in both warps
    l[r] = 1.f / (ssum[grp * 32 + rq * 4 + r] + ssum[grp * 32 + 16 + rq * 4 + r]);
  float o[4][NO];  // declared here: live only after the scores
  F::zero(o);
  if (active) {
#pragma unroll
    for (int cc = 0; cc < (NJH + 3) / 4; ++cc) {  // this warp's tiles 4 cc .. + 3
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * cc + jj;
        if (j < NJH)
          *reinterpret_cast<float4*>(wb + (jj * 8 + kl) * kCpF32WStride + rq * 4) =
              make_float4(s[0][j] * l[0], s[1][j] * l[1], s[2][j] * l[2], s[3][j] * l[3]);
      }
      __syncwarp();
#pragma unroll 1
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * cc + jj, key0 = (2 * j + half) * 8;
        if (j < NJH && key0 < nk) F::pv8(o, wb, jj * 8, Vs, key0, rq, kl);
      }
      __syncwarp();  // wb is rewritten by the next tiles
    }
    if (half) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < NV; ++i)
          F::st(ox + (grp * 16 + rq * 4 + r) * DH + F::col(kl, i), &o[r][VW * i]);
    }
  }
  __syncthreads();
  if (!active || half) return;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float p[VW];
      F::ld(p, ox + (grp * 16 + rq * 4 + r) * DH + F::col(kl, i));
#pragma unroll
      for (int e = 0; e < VW; ++e) o[r][VW * i + e] += p[e];
    }
  F::store(o, out, ldo, rb, tq, kl);
}

// Two passes over 32-key chunks (lane keys kc0 + 8 j + kl), K and V in
// tiles of kt keys (cp_key_tile: all of them where they fit, else a
// multiple of 32 and each pass restages its tiles): the form past the
// one-pass keys.
template <int DH>
__device__ __forceinline__ void cp_rows_f32_two_pass(const float* __restrict__ q, int ldq,
                                                     const float* __restrict__ k,
                                                     const float* __restrict__ v, int ldk,
                                                     float* __restrict__ out, int ldo, int tq,
                                                     int tk, int valid_len, float scale, int q0,
                                                     int kt, float* smem) {
  using F = CpF32<DH>;
  constexpr int LD = F::LD, NO = F::NO;
  const int nk = cp_keys8(tk), nt = (nk + kt - 1) / kt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rq = lane >> 3, kl = lane & 7;
  const float scale2 = scale * kLog2e;
  float* Ks = smem;
  float* Vs = Ks + kt * LD;
  float* wb = Vs + kt * LD + warp * 32 * kCpF32WStride;  // [32][20]
  const int rb = q0 + warp * 16 + rq * 4;
  const bool active = q0 + warp * 16 < tq;
  // keys t0 .. t0 + kt - 1 into a tile; keys past tk zeros
  auto stage = [&](float* dst, const float* src, int t0) {
    F::stage(dst, src + static_cast<size_t>(t0) * ldk, ldk, tk - t0, 0, kt);
  };
  auto chunk_scores = [&](float (&s)[4][4], int t0, int kc0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.f;
    for (int c = 0; c < DH; c += 4) {
      float4 qv[4];
      F::load_q(qv, q, ldq, rb, tq, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t0 + kc0 + j * 8 < nk) {
          const float4 kv = *reinterpret_cast<const float4*>(Ks + (kc0 + j * 8 + kl) * LD + c);
#pragma unroll
          for (int r = 0; r < 4; ++r) s[r][j] = F::dot4(s[r][j], qv[r], kv);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[r][j] = masked_logit2(s[r][j], t0 + kc0 + j * 8 + kl, valid_len, tk, scale2);
  };
  stage(Ks, k, 0);
  if (nt == 1) stage(Vs, v, 0);
  cp_async_commit();
  float m[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = 0; it < nt; ++it) {  // pass 1
    const int t0 = it * kt;
    if (it) {
      __syncthreads();  // the last tile is no longer read
      stage(Ks, k, t0);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    for (int kc0 = 0; kc0 < kt && t0 + kc0 < nk; kc0 += 32) {
      float s[4][4];
      chunk_scores(s, t0, kc0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float mn =
            fmaxf(m[r], F::row_max(fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]))));
        const float sum = F::row_sum(exp2f(s[r][0] - mn) + exp2f(s[r][1] - mn) +
                                     exp2f(s[r][2] - mn) + exp2f(s[r][3] - mn));
        l[r] = l[r] * exp2f(m[r] - mn) + sum;
        m[r] = mn;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) l[r] = 1.f / l[r];
  float o[4][NO];
  F::zero(o);
  for (int it = 0; it < nt; ++it) {  // pass 2
    const int t0 = it * kt;
    if (nt > 1) {
      __syncthreads();
      stage(Ks, k, t0);
      stage(Vs, v, t0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;
    for (int kc0 = 0; kc0 < kt && t0 + kc0 < nk; kc0 += 32) {
      float s[4][4];
      chunk_scores(s, t0, kc0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(wb + (j * 8 + kl) * kCpF32WStride + rq * 4) =
            make_float4(exp2f(s[0][j] - m[0]) * l[0], exp2f(s[1][j] - m[1]) * l[1],
                        exp2f(s[2][j] - m[2]) * l[2], exp2f(s[3][j] - m[3]) * l[3]);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t0 + kc0 + j * 8 < nk) F::pv8(o, wb, j * 8, Vs, kc0 + j * 8, rq, kl);
      __syncwarp();
    }
  }
  if (active) F::store(o, out, ldo, rb, tq, kl);
}

}  // namespace
}  // namespace vsd

// The f32 backward of the attention core (kernel 4's f32 form), shared by
// the square backward on the fused projection (attention_qkv_bwd_f32.cu)
// and the rectangular backward of sequence parallelism (attention_cp_bwd.cu,
// kernel 13).  Per head, for tq query rows against tk keys:
//
//   w  = softmax(q k^T * s), key columns >= valid_len at -1e30
//   dv = w^T g,  dw = g v^T,  dl = w (dw - rowsum(dw w))
//   dq = dl k * s,  dk = dl^T q * s
//
// in plain f32 FMAs (never TF32), in two launches: bwd_rows_f32 (grid over
// query tiles: dq and each row's stats) and bwd_keys_f32 (grid over key
// tiles: dk and dv).  The design is described in attention_qkv_bwd_f32.cu.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace vsd {
namespace {

constexpr int kBwdF32Warps = 8;       // warps of a block
constexpr int kBwdF32Rows = 4;        // rows (A) or keys (B) of a warp at a time
constexpr int kBwdF32TileRows = 128;  // rows or keys of a block at most

// Both launches, t being the larger of the query and key counts: two staged
// [t][dh + 4] head tiles, the stats of t rows (launch B), and per warp two
// [4][dh] rows and two [t][4] columns.
__host__ __device__ inline size_t bwd_f32_smem_bytes(int t, int dh) {
  return (2 * static_cast<size_t>(t) * (dh + 4) + 4 * static_cast<size_t>(t) +
          static_cast<size_t>(kBwdF32Warps) * (2 * kBwdF32Rows * dh + 2 * 4 * t)) *
         sizeof(float);
}

__device__ __forceinline__ float bwd_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Stage rows [0, t) of one head's DH columns (row r at src + r * width).
template <int DH>
__device__ __forceinline__ void stage_f32(float* tile, const float* src, size_t width, int t) {
  constexpr int LD = DH + 4, C4 = DH / 4;
  for (int c = threadIdx.x; c < t * C4; c += blockDim.x) {
    const int r = c / C4, col = (c % C4) * 4;
    *reinterpret_cast<float4*>(tile + r * LD + col) =
        __ldg(reinterpret_cast<const float4*>(src + r * width + col));
  }
}

// The warp's 4 rows r0 .. r0 + 3 of one head's DH columns into dst [4][DH];
// rows at or past end are zeros.
template <int DH>
__device__ __forceinline__ void warp_rows(float* dst, const float* src, size_t width, int r0,
                                          int end, int lane) {
  constexpr int C4 = DH / 4;
  for (int c = lane; c < kBwdF32Rows * C4; c += 32) {
    const int rr = c / C4, col = (c % C4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + rr < end) v = __ldg(reinterpret_cast<const float4*>(src + (r0 + rr) * width + col));
    *reinterpret_cast<float4*>(dst + rr * DH + col) = v;
  }
}

// dot products of one staged row (stride-free, DH values) with the warp's
// 4 rows, in column order: out[rr] = sum_c a[rr][c] * row[c].
template <int DH>
__device__ __forceinline__ void dots4(float (&out)[kBwdF32Rows], const float* a,
                                      const float* row) {
#pragma unroll
  for (int rr = 0; rr < kBwdF32Rows; ++rr) out[rr] = 0.f;
#pragma unroll
  for (int c = 0; c < DH; c += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(row + c);
#pragma unroll
    for (int rr = 0; rr < kBwdF32Rows; ++rr) {
      const float4 qv = *reinterpret_cast<const float4*>(a + rr * DH + c);
      out[rr] = fmaf(qv.x, kv.x, out[rr]);
      out[rr] = fmaf(qv.y, kv.y, out[rr]);
      out[rr] = fmaf(qv.z, kv.z, out[rr]);
      out[rr] = fmaf(qv.w, kv.w, out[rr]);
    }
  }
}

// Launch A over one (head, item): query rows tile blockIdx.x (tile_rows a
// tile) against all tk keys.  q, g and dq point at the head's slice of
// query row 0 (rows at + r * ldq, ldg, lddq), k and v at its slice of key
// row 0 (rows at + r * ldk); st is this (item, head)'s stats [tq][4]
// (m, l, rowsum(dw w)), written for launch B.
template <int DH>
__device__ __forceinline__ void bwd_rows_f32(const float* __restrict__ qb, size_t ldq,
                                             const float* __restrict__ kb,
                                             const float* __restrict__ vb, size_t ldk,
                                             const float* __restrict__ gb, size_t ldg,
                                             float* __restrict__ dqb, size_t lddq,
                                             float* __restrict__ st, int tq, int tk,
                                             int valid_len, float scale, int tile_rows) {
  constexpr int LD = DH + 4;
  constexpr int NJ = (DH + 31) / 32;
  extern __shared__ __align__(16) float smf[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Ks = smf;
  float* Vs = Ks + static_cast<size_t>(tk) * LD;
  float* Qw = Vs + static_cast<size_t>(tk) * LD + 4 * static_cast<size_t>(tk) +
              static_cast<size_t>(warp) * (2 * kBwdF32Rows * DH + 8 * tk);
  float* Gw = Qw + kBwdF32Rows * DH;
  float* Pw = Gw + kBwdF32Rows * DH;  // [tk][4]: s, then w, then dl
  float* Dw = Pw + 4 * tk;            // [tk][4]: dw

  stage_f32<DH>(Ks, kb, ldk, tk);
  stage_f32<DH>(Vs, vb, ldk, tk);
  __syncthreads();

  const int q_end = min(tq, (static_cast<int>(blockIdx.x) + 1) * tile_rows);
  for (int r0 = blockIdx.x * tile_rows + warp * kBwdF32Rows; r0 < q_end;
       r0 += kBwdF32Warps * kBwdF32Rows) {
    warp_rows<DH>(Qw, qb, ldq, r0, q_end, lane);
    warp_rows<DH>(Gw, gb, ldg, r0, q_end, lane);
    __syncwarp();

    // scores and dw of this lane's keys; the row max
    float m[kBwdF32Rows];
#pragma unroll
    for (int rr = 0; rr < kBwdF32Rows; ++rr) m[rr] = -CUDART_INF_F;
    for (int key = lane; key < tk; key += 32) {
      float s[kBwdF32Rows], dw[kBwdF32Rows];
      dots4<DH>(s, Qw, Ks + key * LD);
      dots4<DH>(dw, Gw, Vs + key * LD);
#pragma unroll
      for (int rr = 0; rr < kBwdF32Rows; ++rr) {
        s[rr] = key < valid_len ? s[rr] * scale : -1e30f;
        m[rr] = fmaxf(m[rr], s[rr]);
      }
      *reinterpret_cast<float4*>(Pw + key * 4) = make_float4(s[0], s[1], s[2], s[3]);
      *reinterpret_cast<float4*>(Dw + key * 4) = make_float4(dw[0], dw[1], dw[2], dw[3]);
    }
#pragma unroll
    for (int rr = 0; rr < kBwdF32Rows; ++rr) m[rr] = bwd_warp_max(m[rr]);

    // e = exp(s - m), l = sum e
    float l[kBwdF32Rows] = {0.f, 0.f, 0.f, 0.f};
    for (int key = lane; key < tk; key += 32) {
      float4 e = *reinterpret_cast<const float4*>(Pw + key * 4);
      e.x = expf(e.x - m[0]);
      e.y = expf(e.y - m[1]);
      e.z = expf(e.z - m[2]);
      e.w = expf(e.w - m[3]);
      l[0] += e.x;
      l[1] += e.y;
      l[2] += e.z;
      l[3] += e.w;
      *reinterpret_cast<float4*>(Pw + key * 4) = e;
    }
#pragma unroll
    for (int rr = 0; rr < kBwdF32Rows; ++rr) l[rr] = warp_sum(l[rr]);

    // w = e / l and dd = rowsum(dw w)
    float dd[kBwdF32Rows] = {0.f, 0.f, 0.f, 0.f};
    for (int key = lane; key < tk; key += 32) {
      float4 w = *reinterpret_cast<const float4*>(Pw + key * 4);
      const float4 dw = *reinterpret_cast<const float4*>(Dw + key * 4);
      w.x /= l[0];
      w.y /= l[1];
      w.z /= l[2];
      w.w /= l[3];
      dd[0] = fmaf(dw.x, w.x, dd[0]);
      dd[1] = fmaf(dw.y, w.y, dd[1]);
      dd[2] = fmaf(dw.z, w.z, dd[2]);
      dd[3] = fmaf(dw.w, w.w, dd[3]);
      *reinterpret_cast<float4*>(Pw + key * 4) = w;
    }
#pragma unroll
    for (int rr = 0; rr < kBwdF32Rows; ++rr) dd[rr] = warp_sum(dd[rr]);

    // dl = w (dw - dd)
    for (int key = lane; key < tk; key += 32) {
      const float4 w = *reinterpret_cast<const float4*>(Pw + key * 4);
      const float4 dw = *reinterpret_cast<const float4*>(Dw + key * 4);
      *reinterpret_cast<float4*>(Pw + key * 4) =
          make_float4(w.x * (dw.x - dd[0]), w.y * (dw.y - dd[1]), w.z * (dw.z - dd[2]),
                      w.w * (dw.w - dd[3]));
    }
    if (lane < kBwdF32Rows && r0 + lane < q_end) {
      const float mv = lane == 0 ? m[0] : lane == 1 ? m[1] : lane == 2 ? m[2] : m[3];
      const float lv = lane == 0 ? l[0] : lane == 1 ? l[1] : lane == 2 ? l[2] : l[3];
      const float dv = lane == 0 ? dd[0] : lane == 1 ? dd[1] : lane == 2 ? dd[2] : dd[3];
      *reinterpret_cast<float4*>(st + static_cast<size_t>(r0 + lane) * 4) =
          make_float4(mv, lv, dv, 0.f);
    }
    __syncwarp();

    // dq = dl K * s
    float o[kBwdF32Rows][NJ];
#pragma unroll
    for (int rr = 0; rr < kBwdF32Rows; ++rr)
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[rr][j] = 0.f;
    for (int key = 0; key < tk; ++key) {
      const float4 dl = *reinterpret_cast<const float4*>(Pw + key * 4);
      const float* kr = Ks + key * LD;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < DH) {
          const float kv = kr[c];
          o[0][j] = fmaf(dl.x, kv, o[0][j]);
          o[1][j] = fmaf(dl.y, kv, o[1][j]);
          o[2][j] = fmaf(dl.z, kv, o[2][j]);
          o[3][j] = fmaf(dl.w, kv, o[3][j]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kBwdF32Rows; ++rr) {
      if (r0 + rr >= q_end) continue;
      float* orow = dqb + static_cast<size_t>(r0 + rr) * lddq;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < DH) orow[c] = o[rr][j] * scale;
      }
    }
    __syncwarp();  // Qw, Gw, Pw and Dw are rewritten by the next rows
  }
}

// Launch B over one (head, item): keys tile blockIdx.x (tile_keys a tile)
// against all tq query rows, from launch A's stats st [tq][4]; writes dk
// and dv (rows at + r * lddk).  Pointers as in bwd_rows_f32.
template <int DH>
__device__ __forceinline__ void bwd_keys_f32(const float* __restrict__ qb, size_t ldq,
                                             const float* __restrict__ kb,
                                             const float* __restrict__ vb, size_t ldk,
                                             const float* __restrict__ gb, size_t ldg,
                                             float* __restrict__ dkb, float* __restrict__ dvb,
                                             size_t lddk, const float* __restrict__ st, int tq,
                                             int tk, int valid_len, float scale,
                                             int tile_keys) {
  constexpr int LD = DH + 4;
  constexpr int NJ = (DH + 31) / 32;
  extern __shared__ __align__(16) float smf[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Qs = smf;
  float* Gs = Qs + static_cast<size_t>(tq) * LD;
  float* St = Gs + static_cast<size_t>(tq) * LD;  // [tq][4]: m, l, dd
  float* Kw = St + 4 * static_cast<size_t>(tq) +
              static_cast<size_t>(warp) * (2 * kBwdF32Rows * DH + 8 * tq);
  float* Vw = Kw + kBwdF32Rows * DH;
  float* Pw = Vw + kBwdF32Rows * DH;  // [tq][4]: w
  float* Lw = Pw + 4 * tq;            // [tq][4]: dl

  stage_f32<DH>(Qs, qb, ldq, tq);
  stage_f32<DH>(Gs, gb, ldg, tq);
  for (int r = tid; r < tq; r += blockDim.x)
    *reinterpret_cast<float4*>(St + r * 4) =
        __ldg(reinterpret_cast<const float4*>(st + static_cast<size_t>(r) * 4));
  __syncthreads();

  const int k_end = min(tk, (static_cast<int>(blockIdx.x) + 1) * tile_keys);
  for (int k0 = blockIdx.x * tile_keys + warp * kBwdF32Rows; k0 < k_end;
       k0 += kBwdF32Warps * kBwdF32Rows) {
    warp_rows<DH>(Kw, kb, ldk, k0, k_end, lane);
    warp_rows<DH>(Vw, vb, ldk, k0, k_end, lane);
    __syncwarp();

    // w and dl of every query row against the warp's 4 keys, each from the
    // same f32 operations as launch A
    for (int r = lane; r < tq; r += 32) {
      float s[kBwdF32Rows], dw[kBwdF32Rows];
      dots4<DH>(s, Kw, Qs + r * LD);
      dots4<DH>(dw, Vw, Gs + r * LD);
      const float4 sr = *reinterpret_cast<const float4*>(St + r * 4);
      float w[kBwdF32Rows], dl[kBwdF32Rows];
#pragma unroll
      for (int kk = 0; kk < kBwdF32Rows; ++kk) {
        const float sv = k0 + kk < valid_len ? s[kk] * scale : -1e30f;
        w[kk] = expf(sv - sr.x) / sr.y;
        dl[kk] = w[kk] * (dw[kk] - sr.z);
      }
      *reinterpret_cast<float4*>(Pw + r * 4) = make_float4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<float4*>(Lw + r * 4) = make_float4(dl[0], dl[1], dl[2], dl[3]);
    }
    __syncwarp();

    // dv = w^T G, dk = dl^T Q * s
    float ov[kBwdF32Rows][NJ], ok[kBwdF32Rows][NJ];
#pragma unroll
    for (int kk = 0; kk < kBwdF32Rows; ++kk)
#pragma unroll
      for (int j = 0; j < NJ; ++j) ov[kk][j] = ok[kk][j] = 0.f;
    for (int r = 0; r < tq; ++r) {
      const float4 w = *reinterpret_cast<const float4*>(Pw + r * 4);
      const float4 dl = *reinterpret_cast<const float4*>(Lw + r * 4);
      const float* gr = Gs + r * LD;
      const float* qr = Qs + r * LD;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < DH) {
          const float gv = gr[c], qv = qr[c];
          ov[0][j] = fmaf(w.x, gv, ov[0][j]);
          ov[1][j] = fmaf(w.y, gv, ov[1][j]);
          ov[2][j] = fmaf(w.z, gv, ov[2][j]);
          ov[3][j] = fmaf(w.w, gv, ov[3][j]);
          ok[0][j] = fmaf(dl.x, qv, ok[0][j]);
          ok[1][j] = fmaf(dl.y, qv, ok[1][j]);
          ok[2][j] = fmaf(dl.z, qv, ok[2][j]);
          ok[3][j] = fmaf(dl.w, qv, ok[3][j]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBwdF32Rows; ++kk) {
      if (k0 + kk >= k_end) continue;
      float* krow = dkb + static_cast<size_t>(k0 + kk) * lddk;
      float* vrow = dvb + static_cast<size_t>(k0 + kk) * lddk;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < DH) {
          krow[c] = ok[kk][j] * scale;
          vrow[c] = ov[kk][j];
        }
      }
    }
    __syncwarp();  // Kw, Vw, Pw and Lw are rewritten by the next keys
  }
}

// Rows (or keys) of a launch's tiles: t split evenly into tiles of at most
// kBwdF32TileRows, in whole 4-row groups.
inline int bwd_f32_tile(int t) {
  const int tiles = (t + kBwdF32TileRows - 1) / kBwdF32TileRows;
  return ((t + tiles - 1) / tiles + kBwdF32Rows - 1) / kBwdF32Rows * kBwdF32Rows;
}

}  // namespace
}  // namespace vsd

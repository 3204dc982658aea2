// The backward of the attention core (kernel 4's arithmetic, bf16), shared
// by the square backward on the fused projection (attention_qkv_bwd.cu,
// kernel 4) and the rectangular backward of sequence parallelism
// (attention_cp_bwd.cu, kernel 13).  Per head, for tq query rows against
// tk keys:
//
//   w  = softmax(q k^T * s), key columns >= valid_len at -1e30   (f32)
//   dv = bf16(w)^T g,  dw = g v^T,  dl = w (dw - rowsum(dw w))
//   dq = bf16(dl) k * s,  dk = bf16(dl)^T q * s
//
// with the TPU kernels' rounding points (w rounded to bf16 before dv, dl
// formed from the f32 w and dw after each row's full sum and rounded to
// bf16 before dq and dk, every product summed in f32, the scale applied
// after the dq and dk products).  The design is described in
// attention_qkv_bwd.cu.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace vsd {
namespace {

constexpr int kBwdMaxWarps = 16;   // 256 rows or keys (shared memory binds first)
constexpr int kBwdKeyChunk = 32;   // keys per step of the row passes

__host__ __device__ inline int bwd_keys(int t) { return (t + 15) / 16 * 16; }

// Warps of a block: one per 16 query rows (part A) and per 16 keys (B).
__host__ __device__ inline int bwd_warps(int tq, int tk) {
  const int nq = bwd_keys(tq), nk = bwd_keys(tk);
  return (nq > nk ? nq : nk) / 16;
}

// Shared memory of one block: two [max(nq, nk)][dh] operand tiles (K and
// V, then Q and G) and the bf16 w and dl [nq][nk], nq and nk being tq and
// tk rounded up to 16.
__host__ __device__ inline size_t bwd_smem_bytes(int tq, int tk, int dh) {
  const size_t nq = bwd_keys(tq), nk = bwd_keys(tk);
  return (2 * (nq > nk ? nq : nk) * dh + 2 * nq * nk) * sizeof(bf16);
}

// Element (r, c) of a [rows][DH] head tile: 16-byte chunk c / 8 of row r
// XOR-swizzled so 8 consecutive rows hit 8 different bank groups.
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

// One (head, item) of the backward, by a block of bwd_warps(tq, tk) warps
// with bwd_smem_bytes(tq, tk, DH) of dynamic shared memory.  Each pointer
// is at that head's slice of row 0 of its matrix: q, g and dq (rows at
// + r * ldq, ldg, lddq), k and dk (rows at + r * ldk, lddk); v and dv sit
// voff elements past k and dk (the fused [k | v] layouts of both callers).
// g must be zero on query rows whose gradient should not count (pad
// rows); dk and dv are written for all tk keys (zero on keys at or past
// valid_len), dq for all tq rows.  kRect: tq and tk may differ (warps past
// either count idle in that part); without it tq == tk, no warp idles and
// the square kernel carries no such branch.  Row strides are multiples of
// 8 and the pointers 16-byte aligned.  Strides and the offset are 32-bit
// and v / dv derived from k / dk: every register held across the loops
// counts.  A block of 13 to 16 warps gets 128 registers a thread at most
// (registers go out per 4 warps, so launch bounds of 13 warps gain
// nothing), and at that cap the DH = 64 body spills 40 B (PERF.md, kernel 4).
template <int DH, bool kRect>
__device__ __forceinline__ void attention_bwd_rows(
    const bf16* __restrict__ qbase, int ldq, const bf16* __restrict__ kbase, int ldk,
    const bf16* __restrict__ gbase, int ldg, bf16* __restrict__ dqbase, int lddq,
    bf16* __restrict__ dkbase, int lddk, int voff, int tq, int tk, int valid_len, float scale,
    unsigned char* smem) {
  constexpr int KK = DH / 16;  // k-steps over the head dim
  constexpr int NO = DH / 8;   // 8-column tiles of the head dim
  constexpr int NJ = kBwdKeyChunk / 8;
  const int nq = bwd_keys(tq), nk = bwd_keys(tk);
  const int nt = nq > nk ? nq : nk;
  bf16* T0 = reinterpret_cast<bf16*>(smem);  // K, then Q
  bf16* T1 = T0 + nt * DH;                   // V, then G
  bf16* Ws = T1 + nt * DH;                   // bf16 w   [query][key]
  bf16* Ls = Ws + nq * nk;                   // bf16 dl  [query][key]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair

  stage<DH>(T0, kbase, ldk, tk, nk);          // K
  stage<DH>(T1, kbase + voff, ldk, tk, nk);   // V
  cp_async_commit();

  // ---- A: warp owns query rows r0 .. r0 + 15 (warps past nq idle) ----
  const int r0 = warp * 16;
  uint32_t qa[KK][4], ga[KK][4];
  {
    const bool lo_in = r0 + g < tq, hi_in = r0 + g + 8 < tq;
    const bf16* qlo = qbase + static_cast<size_t>(r0 + g) * ldq + t4 * 2;
    const bf16* glo = gbase + static_cast<size_t>(r0 + g) * ldg + t4 * 2;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int c = kk * 16;
      qa[kk][0] = lo_in ? ld_global_u32(qlo + c) : 0u;
      qa[kk][1] = hi_in ? ld_global_u32(qlo + 8 * static_cast<size_t>(ldq) + c) : 0u;
      qa[kk][2] = lo_in ? ld_global_u32(qlo + c + 8) : 0u;
      qa[kk][3] = hi_in ? ld_global_u32(qlo + 8 * static_cast<size_t>(ldq) + c + 8) : 0u;
      ga[kk][0] = lo_in ? ld_global_u32(glo + c) : 0u;
      ga[kk][1] = hi_in ? ld_global_u32(glo + 8 * static_cast<size_t>(ldg) + c) : 0u;
      ga[kk][2] = lo_in ? ld_global_u32(glo + c + 8) : 0u;
      ga[kk][3] = hi_in ? ld_global_u32(glo + 8 * static_cast<size_t>(ldg) + c + 8) : 0u;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // s = a b^T over one chunk of keys from a staged [key][DH] tile:
  // s[j][0..1] row g, keys kc0 + 8j + 2 t4 + {0, 1}; s[j][2..3] row g + 8.
  auto rows_by_keys = [&](float (&s)[NJ][4], const uint32_t (&a)[KK][4], const bf16* tile,
                          int kc0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const int key = kc0 + j * 8 + g;
      if (kc0 + j * 8 < nk) {
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          mma_16816(s[j], a[kk], ld_shared_u32(tile + head_at<DH>(key, kk * 16 + t4 * 2)),
                    ld_shared_u32(tile + head_at<DH>(key, kk * 16 + 8 + t4 * 2)));
      }
    }
  };
  auto scores = [&](float (&s)[NJ][4], int kc0) {
    rows_by_keys(s, qa, T0, kc0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kc0 + j * 8 + t4 * 2 + (e & 1);
        s[j][e] = key < valid_len ? s[j][e] * scale : (key < tk ? -1e30f : -CUDART_INF_F);
      }
  };

  if (!kRect || r0 < nq) {
    // Pass 1: row max m, sum l of exp(s - m) and du = sum exp(s - m) dw,
    // rescaled online; the four lanes of a quad share a row.
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, du[2] = {0.f, 0.f};
    for (int kc0 = 0; kc0 < nk; kc0 += kBwdKeyChunk) {
      float s[NJ][4], dw[NJ][4];
      scores(s, kc0);
      rows_by_keys(dw, ga, T1, kc0);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[hr], mx);
        float sum = 0.f, dsum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            const float p = expf(s[j][e] - mn);
            sum += p;
            dsum += p * dw[j][e];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
        const float corr = expf(m[hr] - mn);
        l[hr] = l[hr] * corr + sum;
        du[hr] = du[hr] * corr + dsum;
        m[hr] = mn;
      }
    }
    const float dd[2] = {du[0] / l[0], du[1] / l[1]};  // rowsum(dw w)

    // Pass 2: w and dl in f32, stored as bf16; dq += bf16(dl) k.
    float dq[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
    for (int kc0 = 0; kc0 < nk; kc0 += kBwdKeyChunk) {
      float s[NJ][4], dw[NJ][4];
      scores(s, kc0);
      rows_by_keys(dw, ga, T1, kc0);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const float w = expf(s[j][e] - m[hr]) / l[hr];
          dw[j][e] = w * (dw[j][e] - dd[hr]);  // dl
          s[j][e] = w;
        }
        const int key = kc0 + j * 8 + t4 * 2;
        if (kc0 + j * 8 < nk) {
          const int rlo = r0 + g, rhi = r0 + g + 8;
          *reinterpret_cast<uint32_t*>(Ws + sq_at(nk, rlo, key)) = pack_bf16x2(s[j][0], s[j][1]);
          *reinterpret_cast<uint32_t*>(Ws + sq_at(nk, rhi, key)) = pack_bf16x2(s[j][2], s[j][3]);
          *reinterpret_cast<uint32_t*>(Ls + sq_at(nk, rlo, key)) =
              pack_bf16x2(dw[j][0], dw[j][1]);
          *reinterpret_cast<uint32_t*>(Ls + sq_at(nk, rhi, key)) =
              pack_bf16x2(dw[j][2], dw[j][3]);
        }
      }
#pragma unroll
      for (int t = 0; t < NJ / 2; ++t) {
        const int key0 = kc0 + t * 16;
        if (key0 < nk) {
          const float(&lo)[4] = dw[2 * t];
          const float(&hi)[4] = dw[2 * t + 1];
          const uint32_t pa[4] = {pack_bf16x2(lo[0], lo[1]), pack_bf16x2(lo[2], lo[3]),
                                  pack_bf16x2(hi[0], hi[1]), pack_bf16x2(hi[2], hi[3])};
          const int krow = key0 + (lane & 15);
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            uint32_t b0, b1;
            ldmatrix_x2_trans(b0, b1, T0 + head_at<DH>(krow, n * 8));
            mma_16816(dq[n], pa, b0, b1);
          }
        }
      }
    }
    const int row = r0 + g;
    bf16* orow = dqbase + static_cast<size_t>(row) * lddq + t4 * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (row < tq)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16x2(dq[n][0] * scale, dq[n][1] * scale);
      if (row + 8 < tq)
        *reinterpret_cast<uint32_t*>(orow + 8 * static_cast<size_t>(lddq) + n * 8) =
            pack_bf16x2(dq[n][2] * scale, dq[n][3] * scale);
    }
  }
  __syncthreads();  // every warp is done with K and V; w and dl are complete

  // ---- B: warp owns keys k0 .. k0 + 15 (warps past nk idle) ----
  stage<DH>(T0, qbase, ldq, tq, nq);   // Q
  stage<DH>(T1, gbase, ldg, tq, nq);   // G
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int k0 = warp * 16;
  if (kRect && k0 >= nk) return;
  float dv[NO][4], dk[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;
  // ldmatrix.x4.trans row addresses: tile i = lane / 8 covers queries
  // +8 (i / 2) and keys +8 (i % 2) of a 16 x 16 block
  const int qoff = (lane & 7) + ((lane >> 4) << 3), koff = k0 + (((lane >> 3) & 1) << 3);
  for (int q0 = 0; q0 < nq; q0 += 16) {
    uint32_t wt[4], lt[4];
    ldmatrix_x4_trans(wt, Ws + sq_at(nk, q0 + qoff, koff));
    ldmatrix_x4_trans(lt, Ls + sq_at(nk, q0 + qoff, koff));
    const int qrow = q0 + (lane & 15);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, T1 + head_at<DH>(qrow, n * 8));
      mma_16816(dv[n], wt, b0, b1);
      ldmatrix_x2_trans(b0, b1, T0 + head_at<DH>(qrow, n * 8));
      mma_16816(dk[n], lt, b0, b1);
    }
  }
  const int key = k0 + g;
  bf16* krow = dkbase + static_cast<size_t>(key) * lddk + t4 * 2;
  bf16* vrow = krow + voff;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (key < tk) {
      *reinterpret_cast<uint32_t*>(krow + n * 8) = pack_bf16x2(dk[n][0] * scale, dk[n][1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + n * 8) = pack_bf16x2(dv[n][0], dv[n][1]);
    }
    if (key + 8 < tk) {
      *reinterpret_cast<uint32_t*>(krow + 8 * static_cast<size_t>(lddk) + n * 8) =
          pack_bf16x2(dk[n][2] * scale, dk[n][3] * scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * static_cast<size_t>(lddk) + n * 8) =
          pack_bf16x2(dv[n][2], dv[n][3]);
    }
  }
}

// Validate a launch's shape: the block's warps and shared memory.
template <int DH>
cudaError_t prepare_bwd(const void* kernel, int tq, int tk, size_t* smem, int* warps) {
  *smem = bwd_smem_bytes(tq, tk, DH);
  *warps = bwd_warps(tq, tk);
  if (*smem > kMaxSmem || *warps > kBwdMaxWarps) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace
}  // namespace vsd

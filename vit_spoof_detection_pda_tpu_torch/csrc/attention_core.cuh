// The attention core of the port's attention-block kernels (serving and
// training): softmax(Q K^T * scale) V per head on the fused projection
// qkv [B, Tp, 3D], key columns at or past valid_len masked, written as the
// concatenated head outputs [B, Tp, D].  See attention_block.cu for the
// design and its bounds.  A block holds one head's K and V whole (Tp up to
// 800 at head dim 64); past that, attention() runs the same function on
// kernel 12's key-tiled two passes (attention_cp_core.cuh::
// cp_rows_bf16_tiles with Tq = Tk: f32 logits, the f32 softmax normalised
// before the bf16 rounding, P V summed in f32, one rounding), so any Tp
// runs.
//
// Its forward serves kernels 1 and 3 (attention() in attention_block.cu and
// attention_block_train.cu); kernels 10 and 11 run their own attention
// phase on the same arithmetic (lowlat_core.cuh attention_phase, keys split
// over warps).  Kernels 8 and 9 left it for kernel 12's cores
// (attention_self.cuh), which were faster at every T in turns (PERF.md,
// kernel table rows 8 and 9); they still launch attention_tiled_kernel
// below.
#pragma once

#include <math_constants.h>

#include "attention_cp_core.cuh"
#include "common.cuh"

namespace vsd {
namespace {

constexpr int kAttMaxWarps = 8;    // a block: up to 8 warps of 16 query rows
constexpr int kAttKeyChunk = 64;   // keys per step of the score loops

__host__ __device__ inline int att_keys(int tk) { return (tk + 15) / 16 * 16; }

// Shared memory of one block over tk keys: K and V [tk rounded up to 16][dh + 8] bf16.
__host__ __device__ inline size_t att_smem_bytes(int tk, int dh) {
  return 2 * static_cast<size_t>(att_keys(tk)) * (dh + 8) * sizeof(bf16);
}

// qkv [B, Tp, 3D] (q | k | v, heads contiguous inside each) -> out [B, Tp, D]
// for head dim DH.  Grid (query tiles, heads, B), the Tp rows split evenly
// into tiles of at most 8 warps (Tp = 200: two tiles of 7 warps), so each
// block loads one head's K and V once for up to 128 queries.  Warp w owns
// query rows 16w .. 16w + 15 of its tile: it reads their Q fragments from
// device memory and keeps their scores in registers (mma.sync fragments),
// never in shared memory.
//
// Two passes over the keys, 64 at a time, recomputing Q K^T in the second:
//   1. running row max m and sum l of exp(s - m) (online rescaling);
//   2. w = exp(s - m) / l, rounded to bf16, and O += w V.
// So the weights are normalized before the bf16 rounding, as in the TPU
// kernel (a one-pass online softmax would round unnormalized weights).
// Logits are f32 q . k * scale; key columns >= valid_len are -1e30 like
// the TPU kernel's mask, columns past the stream (>= Tp) are -inf so they
// add nothing to m or l.
//
// attention_rows is one query tile of one (head, item) over three base
// pointers: q points at that head's slice of query row 0 (row r at
// + r * ldq), k and v at its slice of key row 0 (row r at + r * ldk), out
// at the head's slice of output row 0 (row r at + r * ldo).  There are tq
// query rows and tk keys (equal in self-attention; the sequence-parallel
// kernel 12 has a local query block against the gathered keys).  The
// block's warps own query rows q0 + 16w .. q0 + 16w + 15; Ks and Vs are
// the block's shared memory (att_smem_bytes(tk, DH)).  ldq, ldk and ldo
// are multiples of 8 and the pointers 16-byte aligned (the 16-byte K/V
// copies).
template <int DH>
__device__ __forceinline__ void attention_rows(const bf16* __restrict__ q, size_t ldq,
                                               const bf16* __restrict__ k,
                                               const bf16* __restrict__ v, size_t ldk,
                                               bf16* __restrict__ out, size_t ldo, int tq,
                                               int tk, int valid_len, float scale, int q0,
                                               bf16* Ks, bf16* Vs) {
  constexpr int LD = DH + 8;   // shared row stride (elements), 16-byte multiple
  constexpr int KK = DH / 16;  // k-steps of Q K^T
  constexpr int NO = DH / 8;   // 8-column output tiles
  constexpr int CPR = DH / 8;  // 16-byte chunks per head row
  const int nk = att_keys(tk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Every key/value row; rows past tk are zeros so that zero weights never
  // meet uninitialised values.
  for (int c = tid; c < nk * CPR; c += blockDim.x) {
    const int r = c / CPR, col = (c % CPR) * 8;
    bf16* dk = Ks + r * LD + col;
    bf16* dv = Vs + r * LD + col;
    if (r < tk) {
      cp_async16(dk, k + r * ldk + col);
      cp_async16(dv, v + r * ldk + col);
    } else {
      store_zero16(dk);
      store_zero16(dv);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = q0 + warp * 16;
  if (r0 >= tq) return;  // all of this warp's rows are past the queries
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair

  // Q as the A fragments of Q K^T (rows r0 + g and r0 + g + 8); rows past
  // tq are zeros.
  uint32_t qa[KK][4];
  const bf16* qlo = q + static_cast<size_t>(r0 + g) * ldq + t4 * 2;
  const bf16* qhi = qlo + 8 * ldq;
  const bool lo_in = r0 + g < tq, hi_in = r0 + g + 8 < tq;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    qa[kk][0] = lo_in ? ld_global_u32(qlo + kk * 16) : 0u;
    qa[kk][1] = hi_in ? ld_global_u32(qhi + kk * 16) : 0u;
    qa[kk][2] = lo_in ? ld_global_u32(qlo + kk * 16 + 8) : 0u;
    qa[kk][3] = hi_in ? ld_global_u32(qhi + kk * 16 + 8) : 0u;
  }

  // s[j][0..1]: row g, keys kc0 + 8j + 2*t4 + {0, 1}; s[j][2..3]: row g + 8.
  auto scores = [&](float (&s)[8][4], int kc0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const int key0 = kc0 + j * 8;
      if (key0 < nk) {
        const bf16* kp = Ks + (key0 + g) * LD + t4 * 2;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          mma_16816(s[j], qa[kk], ld_shared_u32(kp + kk * 16), ld_shared_u32(kp + kk * 16 + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + t4 * 2 + (e & 1);
        s[j][e] = key < valid_len ? s[j][e] * scale : (key < tk ? -1e30f : -CUDART_INF_F);
      }
    }
  };

  // Pass 1: row max and sum.  The four lanes of a quad share a row.
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int kc0 = 0; kc0 < nk; kc0 += kAttKeyChunk) {
    float s[8][4];
    scores(s, kc0);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[hr], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sum += expf(s[j][2 * hr] - mn) + expf(s[j][2 * hr + 1] - mn);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * expf(m[hr] - mn) + sum;
      m[hr] = mn;
    }
  }

  // Pass 2: normalized weights in bf16 as the A fragments of P V.
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int kc0 = 0; kc0 < nk; kc0 += kAttKeyChunk) {
    float s[8][4];
    scores(s, kc0);
#pragma unroll
    for (int t = 0; t < kAttKeyChunk / 16; ++t) {
      const int key0 = kc0 + t * 16;
      if (key0 < nk) {
        const float(&lo)[4] = s[2 * t];
        const float(&hi)[4] = s[2 * t + 1];
        const uint32_t pa[4] = {
            pack_bf16x2(expf(lo[0] - m[0]) / l[0], expf(lo[1] - m[0]) / l[0]),
            pack_bf16x2(expf(lo[2] - m[1]) / l[1], expf(lo[3] - m[1]) / l[1]),
            pack_bf16x2(expf(hi[0] - m[0]) / l[0], expf(hi[1] - m[0]) / l[0]),
            pack_bf16x2(expf(hi[2] - m[1]) / l[1], expf(hi[3] - m[1]) / l[1])};
        const bf16* vrow = Vs + (key0 + (lane & 15)) * LD;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, vrow + n * 8);
          mma_16816(o[n], pa, b0, b1);
        }
      }
    }
  }

  // Each head's output columns, rounded to bf16 once.
  const int row = r0 + g;
  bf16* orow = out + static_cast<size_t>(row) * ldo + t4 * 2;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (row < tq)
      *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16x2(o[n][0], o[n][1]);
    if (row + 8 < tq)
      *reinterpret_cast<uint32_t*>(orow + 8 * ldo + n * 8) =
          pack_bf16x2(o[n][2], o[n][3]);
  }
}

// attention_tile: the same on the fused projection qkv [B, Tp, 3D] (q | k |
// v, heads contiguous inside each) for head h of item b, written to out
// [B, Tp, D].
template <int DH>
__device__ __forceinline__ void attention_tile(const bf16* __restrict__ qkv,
                                               bf16* __restrict__ out, int tp, int d,
                                               int valid_len, float scale, int q0, int h, int b,
                                               bf16* Ks, bf16* Vs) {
  const size_t stride = 3 * static_cast<size_t>(d);
  const bf16* base = qkv + static_cast<size_t>(b) * tp * stride + static_cast<size_t>(h) * DH;
  attention_rows<DH>(base, stride, base + d, base + 2 * d, stride,
                                out + static_cast<size_t>(b) * tp * d + static_cast<size_t>(h) * DH,
                                d, tp, tp, valid_len, scale, q0, Ks, Vs);
}

template <int DH>
__global__ void __launch_bounds__(kAttMaxWarps * 32)
    attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int tp, int d,
                     int valid_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + att_keys(tp) * (DH + 8);
  attention_tile<DH>(qkv, out, tp, d, valid_len, scale, blockIdx.x * blockDim.x / 2,
                            blockIdx.y, blockIdx.z, Ks, Vs);
}

// The key-tiled route: q, k and v [B, t, H, DH] sharing row stride ld and
// batch stride bs (elements), out [B, t, H * DH]; grid (query tiles of up
// to kCpMaxWarps 16-row groups, heads, B), K and V in tiles of kt keys.
template <int DH>
__global__ void __launch_bounds__(kCpMaxWarps * 32)
    attention_tiled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out, int t, int d,
                           int ld, long long bs, int valid_len, float scale, int kt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t off = static_cast<size_t>(b) * bs + static_cast<size_t>(h) * DH;
  cp_rows_bf16_tiles<DH>(q + off, ld, k + off, v + off, ld,
                         out + static_cast<size_t>(b) * t * d + static_cast<size_t>(h) * DH, d,
                         t, t, valid_len, scale, blockIdx.x * (blockDim.x >> 5) * 16, kt,
                         reinterpret_cast<bf16*>(smem));
}

template <int DH>
cudaError_t launch_attention_tiled(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                   int batch, int t, int heads, int ld, long long bs,
                                   int valid_len, float scale, cudaStream_t stream) {
  const int kt = cp_key_tile(t, DH, false);
  const size_t smem = cp_smem_bytes(false, 0, kt, DH);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_tiled_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int groups = (t + 15) / 16;
  const int tiles = (groups + kCpMaxWarps - 1) / kCpMaxWarps;
  const int warps = (groups + tiles - 1) / tiles;
  attention_tiled_kernel<DH><<<dim3(tiles, heads, batch), warps * 32, smem, stream>>>(
      q, k, v, out, t, heads * DH, ld, bs, valid_len, scale, kt);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_attention(const bf16* qkv, bf16* out, int batch, int tp, int d, int heads,
                             int valid_len, float scale, cudaStream_t stream) {
  const size_t smem = att_smem_bytes(tp, DH);
  if (smem > kMaxSmem)  // past one head's K and V: the key-tiled route
    return launch_attention_tiled<DH>(qkv, qkv + d, qkv + 2 * d, out, batch, tp, heads, 3 * d,
                                      static_cast<long long>(tp) * 3 * d, valid_len, scale,
                                      stream);
  cudaError_t e = cudaFuncSetAttribute(attention_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int groups = (tp + 15) / 16;  // 16-row query groups, one warp each
  const int tiles = (groups + kAttMaxWarps - 1) / kAttMaxWarps;
  const int warps = (groups + tiles - 1) / tiles;
  const dim3 grid(tiles, heads, batch);
  attention_kernel<DH><<<grid, warps * 32, smem, stream>>>(qkv, out, tp, d, valid_len, scale);
  return cudaGetLastError();
}

cudaError_t attention(const bf16* qkv, bf16* out, int batch, int tp, int d, int heads,
                      int valid_len, float scale, cudaStream_t stream) {
  switch (d / heads) {
#define VSD_HEAD_DIM(DH) \
  case DH:               \
    return launch_attention<DH>(qkv, out, batch, tp, d, heads, valid_len, scale, stream);
    VSD_HEAD_DIM(16)
    VSD_HEAD_DIM(32)
    VSD_HEAD_DIM(48)
    VSD_HEAD_DIM(64)
    VSD_HEAD_DIM(80)
    VSD_HEAD_DIM(96)
    VSD_HEAD_DIM(112)
    VSD_HEAD_DIM(128)
#undef VSD_HEAD_DIM
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace vsd


// Backward of the attention core on Hopper: given the fused projection
// qkv [B, Tp, 3D] (q | k | v, heads contiguous inside each) and the
// cotangent g [B, Tp, D] of the concatenated head outputs (zero on pad
// rows), per head
//
//   w  = softmax(q k^T * s), key columns >= valid_len at -1e30   (f32)
//   dv = bf16(w)^T g,  dw = g v^T,  dl = w (dw - rowsum(dw w))
//   dq = bf16(dl) k * s,  dk = bf16(dl)^T q * s
//
// into dqkv [B, Tp, 3D] bf16.  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_qkv_bwd_kernel (:199)
// and keeps its rounding points: w is rounded to bf16 before dv, dl is
// formed from the f32 w and dw after each row's full sum, and rounded to
// bf16 before dq and dk; every product accumulates in f32.
//
// Bound on the H100: bytes.  At ViT-B, B = 128, Tp = 200 it reads qkv and g
// and writes dqkv, about 275 MB, >= 0.082 ms at 3.35 TB/s; its five
// [Tp, Tp] x Dh products are 39-47 GFLOP (0.04-0.05 ms at the bf16 peak).
//
// Design (a first, simple one): one block per (head, item), one warp per
// 16 rows of the Tp rows rounded up to 16 (13 warps at Tp = 200).  The TPU
// kernel held one head's f32 [Tp, Tp] weights in VMEM (160 KB); a block
// here keeps the bf16 weights and dl [tk, tk] (173 KB at tk = 208) and one
// pair of [tk, Dh] operands (53 KB) in shared memory, with a 16-byte-chunk
// XOR swizzle in place of padding so that Tp = 200 fits in 227 KB:
//   A. K and V staged; each warp owns 16 query rows, Q and G fragments in
//      registers: pass 1 over the keys (mma.sync) gives the row max, the
//      softmax sum and rowsum(dw w) online; pass 2 recomputes the scores
//      and dw, forms w and dl in f32, stores both as bf16 and accumulates
//      dq = dl k in registers.
//   B. Q and G staged where K and V were; each warp owns 16 keys and
//      accumulates dv = w^T g and dk = dl^T q over all the query rows in
//      registers (ldmatrix.trans reads w^T and dl^T from the stored tiles).
// The scores are computed twice and dw twice (7 products instead of the
// TPU kernel's 5); one block per SM.  Making it fast is later work.
#include <math_constants.h>

#include "common.cuh"

namespace vsd {
namespace {

constexpr int kBwdMaxWarps = 16;   // Tp up to 256 (shared memory binds first)
constexpr int kBwdKeyChunk = 32;   // keys per step of the row passes

__host__ __device__ inline int bwd_keys(int tp) { return (tp + 15) / 16 * 16; }

__host__ __device__ inline size_t bwd_smem_bytes(int tp, int dh) {
  const size_t tk = bwd_keys(tp);
  return (2 * tk * dh + 2 * tk * tk) * sizeof(bf16);
}

// Element (r, c) of a [rows][DH] head tile: 16-byte chunk c / 8 of row r
// XOR-swizzled so 8 consecutive rows hit 8 different bank groups.
template <int DH>
__device__ __forceinline__ int head_at(int r, int c) {
  constexpr int CPR = DH / 8;                          // chunks per row
  constexpr int RSH = CPR == 8 ? 0 : (CPR == 4 ? 1 : 2);
  return r * DH + ((((c >> 3) ^ (r >> RSH)) & (CPR - 1)) << 3) + (c & 7);
}

// Element (r, c) of a [tk][tk] tile (tk % 16 == 0): chunk XOR bit 2 of r.
__device__ __forceinline__ int sq_at(int tk, int r, int c) {
  return r * tk + (((c >> 3) ^ ((r >> 2) & 1)) << 3) + (c & 7);
}

// Stage rows [0, tk) of one head's columns col0 .. col0 + DH of a
// [B, Tp, width] matrix into a swizzled tile; rows past Tp are zeros.
template <int DH>
__device__ __forceinline__ void stage(bf16* tile, const bf16* src, size_t width, int tp, int tk) {
  constexpr int CPR = DH / 8;
  for (int c = threadIdx.x; c < tk * CPR; c += blockDim.x) {
    const int r = c / CPR, col = (c % CPR) * 8;
    bf16* dst = tile + head_at<DH>(r, col);
    if (r < tp)
      cp_async16(dst, src + r * width + col);
    else
      store_zero16(dst);
  }
}

template <int DH>
__global__ void __launch_bounds__(kBwdMaxWarps * 32, 1)
    attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gout,
                         bf16* __restrict__ dqkv, int tp, int d, int valid_len, float scale) {
  constexpr int KK = DH / 16;  // k-steps over the head dim
  constexpr int NO = DH / 8;   // 8-column tiles of the head dim
  constexpr int NJ = kBwdKeyChunk / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tk = bwd_keys(tp);
  bf16* T0 = reinterpret_cast<bf16*>(smem);  // K, then Q
  bf16* T1 = T0 + tk * DH;                   // V, then G
  bf16* Ws = T1 + tk * DH;                   // bf16 w   [query][key]
  bf16* Ls = Ws + tk * tk;                   // bf16 dl  [query][key]

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const size_t stride = 3 * static_cast<size_t>(d);
  const bf16* qbase = qkv + static_cast<size_t>(b) * tp * stride + static_cast<size_t>(h) * DH;
  const bf16* gbase = gout + static_cast<size_t>(b) * tp * d + static_cast<size_t>(h) * DH;
  bf16* obase = dqkv + static_cast<size_t>(b) * tp * stride + static_cast<size_t>(h) * DH;

  stage<DH>(T0, qbase + d, stride, tp, tk);       // K
  stage<DH>(T1, qbase + 2 * d, stride, tp, tk);   // V
  cp_async_commit();

  // ---- A: warp owns query rows r0 .. r0 + 15 ----
  const int r0 = warp * 16;
  uint32_t qa[KK][4], ga[KK][4];
  {
    const bool lo_in = r0 + g < tp, hi_in = r0 + g + 8 < tp;
    const bf16* qlo = qbase + static_cast<size_t>(r0 + g) * stride + t4 * 2;
    const bf16* glo = gbase + static_cast<size_t>(r0 + g) * d + t4 * 2;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int c = kk * 16;
      qa[kk][0] = lo_in ? ld_global_u32(qlo + c) : 0u;
      qa[kk][1] = hi_in ? ld_global_u32(qlo + 8 * stride + c) : 0u;
      qa[kk][2] = lo_in ? ld_global_u32(qlo + c + 8) : 0u;
      qa[kk][3] = hi_in ? ld_global_u32(qlo + 8 * stride + c + 8) : 0u;
      ga[kk][0] = lo_in ? ld_global_u32(glo + c) : 0u;
      ga[kk][1] = hi_in ? ld_global_u32(glo + 8 * static_cast<size_t>(d) + c) : 0u;
      ga[kk][2] = lo_in ? ld_global_u32(glo + c + 8) : 0u;
      ga[kk][3] = hi_in ? ld_global_u32(glo + 8 * static_cast<size_t>(d) + c + 8) : 0u;
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
      if (kc0 + j * 8 < tk) {
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
        s[j][e] = key < valid_len ? s[j][e] * scale : (key < tp ? -1e30f : -CUDART_INF_F);
      }
  };

  // Pass 1: row max m, sum l of exp(s - m) and du = sum exp(s - m) dw,
  // rescaled online; the four lanes of a quad share a row.
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, du[2] = {0.f, 0.f};
  for (int kc0 = 0; kc0 < tk; kc0 += kBwdKeyChunk) {
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
  for (int kc0 = 0; kc0 < tk; kc0 += kBwdKeyChunk) {
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
      if (kc0 + j * 8 < tk) {
        const int rlo = r0 + g, rhi = r0 + g + 8;
        *reinterpret_cast<uint32_t*>(Ws + sq_at(tk, rlo, key)) = pack_bf16x2(s[j][0], s[j][1]);
        *reinterpret_cast<uint32_t*>(Ws + sq_at(tk, rhi, key)) = pack_bf16x2(s[j][2], s[j][3]);
        *reinterpret_cast<uint32_t*>(Ls + sq_at(tk, rlo, key)) = pack_bf16x2(dw[j][0], dw[j][1]);
        *reinterpret_cast<uint32_t*>(Ls + sq_at(tk, rhi, key)) = pack_bf16x2(dw[j][2], dw[j][3]);
      }
    }
#pragma unroll
    for (int t = 0; t < NJ / 2; ++t) {
      const int key0 = kc0 + t * 16;
      if (key0 < tk) {
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
  {
    const int row = r0 + g;
    bf16* orow = obase + static_cast<size_t>(row) * stride + t4 * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (row < tp)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16x2(dq[n][0] * scale, dq[n][1] * scale);
      if (row + 8 < tp)
        *reinterpret_cast<uint32_t*>(orow + 8 * stride + n * 8) =
            pack_bf16x2(dq[n][2] * scale, dq[n][3] * scale);
    }
  }
  __syncthreads();  // every warp is done with K and V; w and dl are complete

  // ---- B: warp owns keys k0 .. k0 + 15 ----
  stage<DH>(T0, qbase, stride, tp, tk);   // Q
  stage<DH>(T1, gbase, d, tp, tk);        // G
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int k0 = warp * 16;
  float dv[NO][4], dk[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;
  // ldmatrix.x4.trans row addresses: tile i = lane / 8 covers queries
  // +8 (i / 2) and keys +8 (i % 2) of a 16 x 16 block
  const int qoff = (lane & 7) + ((lane >> 4) << 3), koff = k0 + (((lane >> 3) & 1) << 3);
  for (int q0 = 0; q0 < tk; q0 += 16) {
    uint32_t wt[4], lt[4];
    ldmatrix_x4_trans(wt, Ws + sq_at(tk, q0 + qoff, koff));
    ldmatrix_x4_trans(lt, Ls + sq_at(tk, q0 + qoff, koff));
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
  bf16* krow = obase + static_cast<size_t>(key) * stride + d + t4 * 2;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (key < tp) {
      *reinterpret_cast<uint32_t*>(krow + n * 8) = pack_bf16x2(dk[n][0] * scale, dk[n][1] * scale);
      *reinterpret_cast<uint32_t*>(krow + d + n * 8) = pack_bf16x2(dv[n][0], dv[n][1]);
    }
    if (key + 8 < tp) {
      bf16* k8 = krow + 8 * stride;
      *reinterpret_cast<uint32_t*>(k8 + n * 8) = pack_bf16x2(dk[n][2] * scale, dk[n][3] * scale);
      *reinterpret_cast<uint32_t*>(k8 + d + n * 8) = pack_bf16x2(dv[n][2], dv[n][3]);
    }
  }
}

template <int DH>
cudaError_t launch_bwd(const bf16* qkv, const bf16* g, bf16* dqkv, int batch, int tp, int d,
                       int heads, int valid_len, float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(tp, DH);
  const int warps = bwd_keys(tp) / 16;
  if (smem > kMaxSmem || warps > kBwdMaxWarps) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_bwd_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  attention_bwd_kernel<DH><<<dim3(heads, batch), warps * 32, smem, stream>>>(
      qkv, g, dqkv, tp, d, valid_len, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// qkv, dqkv [B, Tp, 3D] bf16; g [B, Tp, D] bf16, zero on rows >= valid_len.
// Needs a head dim of 16, 32 or 64, Tp % 8 == 0, 0 < valid_len <= Tp, and
// the block's shared memory (2 (2 tk Dh + 2 tk^2) bytes, tk = Tp rounded up
// to 16) within the card's.  Returns the launch's CUDA error (0 on success).
extern "C" int vsd_attention_qkv_bwd(const void* qkv, const void* g, void* dqkv, int batch,
                                     int tp, int d, int num_heads, int valid_len, float scale,
                                     void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || tp <= 0 || tp % 8 || d <= 0 || num_heads <= 0 ||
      num_heads > 65535 || d % num_heads || valid_len <= 0 || valid_len > tp)
    return cudaErrorInvalidValue;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* gb = static_cast<const bf16*>(g);
  bf16* out = static_cast<bf16*>(dqkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / num_heads) {
    case 16:
      return launch_bwd<16>(q, gb, out, batch, tp, d, num_heads, valid_len, scale, s);
    case 32:
      return launch_bwd<32>(q, gb, out, batch, tp, d, num_heads, valid_len, scale, s);
    case 64:
      return launch_bwd<64>(q, gb, out, batch, tp, d, num_heads, valid_len, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

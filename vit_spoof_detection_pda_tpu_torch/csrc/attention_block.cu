// Pre-LN attention sub-layer of the ViT for serving, on Hopper:
//
//   out = x + proj(MHA(LN1(x) @ Wqkv + bqkv)) + bproj
//
// over a padded residual stream x [B, Tp, D] bf16 whose key columns at or
// past valid_len are masked.  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_block_kernel (:412).
//
// Bound on the H100: the tensor cores.  At ViT-B, B = 128, Tp = 200 one call
// does 2*B*Tp*D*4D + 4*B*H*Tp^2*Dh = 136.5 GFLOP of bf16 products, >= 0.138 ms
// at 989 TFLOP/s; its ~83 MB of compulsory traffic (x in, out, weights) takes
// 0.025 ms at 3.35 TB/s and does not bind.
//
// Design (a first, simple one): four launches on the caller's stream,
//   1. LayerNorm rows -> xn (bf16 scratch)
//   2. GEMM xn @ Wqkv + bqkv -> qkv (bf16 scratch [B*Tp, 3D]), wgmma
//      (common.cuh)
//   3. attention per (query tile of up to 128 rows, head, item) with
//      mma.sync, K and V in shared memory, the scores in registers -> attn
//      (bf16 scratch, reusing the xn buffer)
//   4. GEMM attn @ Wproj + bproj + x -> out, wgmma
// All products are bf16 x bf16 with f32 accumulation.  The TPU kernel kept
// qkv and the head outputs in VMEM; here they go through device memory
// (about 4x the compulsory bytes), and the attention core recomputes
// Q K^T once to normalize the weights before rounding them (1.5x its
// 15.7 GFLOP).  Fusing qkv away, TMA loads and a persistent GEMM schedule
// are later work.
//
// Rounding points follow the TPU kernel: xn, qkv, the softmax weights and
// the concatenated head outputs are rounded to bf16; LN, the logits, the
// softmax and every sum are f32; out is rounded once.
#include <math_constants.h>

#include "common.cuh"

namespace vsd {
namespace {

constexpr int kAttMaxWarps = 8;    // a block: up to 8 warps of 16 query rows
constexpr int kAttKeyChunk = 64;   // keys per step of the score loops

__host__ __device__ inline int att_keys(int tp) { return (tp + 15) / 16 * 16; }

// Shared memory of one block: K and V [tk][dh + 8] bf16.
__host__ __device__ inline size_t att_smem_bytes(int tp, int dh) {
  return 2 * static_cast<size_t>(att_keys(tp)) * (dh + 8) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t ld_shared_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_global_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// c += a @ b for one 16x8x16 tile: a row-major bf16 (4 regs), b
// column-major bf16 (2 regs), c f32 (4 regs), the PTX fragment layouts.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 bf16 tiles of a row-major [key][col] matrix, transposed on the
// way into registers: the B fragment of a 16-key x 8-column product.
// Lanes 0-15 give the addresses of rows key0 .. key0 + 15.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const bf16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(a));
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
template <int DH>
__global__ void __launch_bounds__(kAttMaxWarps * 32)
    attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int tp, int d,
                     int valid_len, float scale) {
  constexpr int LD = DH + 8;   // shared row stride (elements), 16-byte multiple
  constexpr int KK = DH / 16;  // k-steps of Q K^T
  constexpr int NO = DH / 8;   // 8-column output tiles
  constexpr int CPR = DH / 8;  // 16-byte chunks per head row
  extern __shared__ __align__(128) unsigned char smem[];
  const int tk = att_keys(tp);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + tk * LD;

  const int q0 = blockIdx.x * blockDim.x / 2, h = blockIdx.y, b = blockIdx.z;  // 16 rows a warp
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t stride = 3 * static_cast<size_t>(d);
  const bf16* base = qkv + static_cast<size_t>(b) * tp * stride + static_cast<size_t>(h) * DH;

  // Every key/value row; rows past Tp are zeros so that zero weights never
  // meet uninitialised values.
  for (int c = tid; c < tk * CPR; c += blockDim.x) {
    const int r = c / CPR, col = (c % CPR) * 8;
    bf16* dk = Ks + r * LD + col;
    bf16* dv = Vs + r * LD + col;
    if (r < tp) {
      cp_async16(dk, base + r * stride + d + col);
      cp_async16(dv, base + r * stride + 2 * d + col);
    } else {
      store_zero16(dk);
      store_zero16(dv);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = q0 + warp * 16;
  if (r0 >= tp) return;  // all of this warp's rows are past the stream
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair

  // Q as the A fragments of Q K^T (rows r0 + g and r0 + g + 8); rows past
  // Tp are zeros.
  uint32_t qa[KK][4];
  const bf16* qlo = base + static_cast<size_t>(r0 + g) * stride + t4 * 2;
  const bf16* qhi = qlo + 8 * stride;
  const bool lo_in = r0 + g < tp, hi_in = r0 + g + 8 < tp;
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
      if (key0 < tk) {
        const bf16* kp = Ks + (key0 + g) * LD + t4 * 2;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          mma_16816(s[j], qa[kk], ld_shared_u32(kp + kk * 16), ld_shared_u32(kp + kk * 16 + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + t4 * 2 + (e & 1);
        s[j][e] = key < valid_len ? s[j][e] * scale : (key < tp ? -1e30f : -CUDART_INF_F);
      }
    }
  };

  // Pass 1: row max and sum.  The four lanes of a quad share a row.
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int kc0 = 0; kc0 < tk; kc0 += kAttKeyChunk) {
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
  for (int kc0 = 0; kc0 < tk; kc0 += kAttKeyChunk) {
    float s[8][4];
    scores(s, kc0);
#pragma unroll
    for (int t = 0; t < kAttKeyChunk / 16; ++t) {
      const int key0 = kc0 + t * 16;
      if (key0 < tk) {
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
  bf16* orow = out + (static_cast<size_t>(b) * tp + row) * d + static_cast<size_t>(h) * DH + t4 * 2;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (row < tp)
      *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16x2(o[n][0], o[n][1]);
    if (row + 8 < tp)
      *reinterpret_cast<uint32_t*>(orow + 8 * static_cast<size_t>(d) + n * 8) =
          pack_bf16x2(o[n][2], o[n][3]);
  }
}

template <int DH>
cudaError_t launch_attention(const bf16* qkv, bf16* out, int batch, int tp, int d, int heads,
                             int valid_len, float scale, cudaStream_t stream) {
  const size_t smem = att_smem_bytes(tp, DH);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
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

// x, out [B, Tp, D] bf16; ln_* [D] f32; w_qkv [D, 3D] and w_proj [D, D] bf16;
// b_qkv [3D], b_proj [D] f32; scratch [B*Tp, D] and qkv [B*Tp, 3D] bf16.
// Needs a head dim that is a multiple of 16 up to 128, Tp % 8 == 0,
// 0 <= valid_len <= Tp, and one head's K and V within shared memory.
// Returns the first CUDA error of the four launches (0 on success).
extern "C" int vsd_attention_block(const void* x, const void* ln_scale, const void* ln_bias,
                                   const void* w_qkv, const void* b_qkv, const void* w_proj,
                                   const void* b_proj, void* scratch, void* qkv, void* out,
                                   int batch, int tp, int d, int num_heads, int valid_len,
                                   float eps, float scale, void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || tp <= 0 || tp % 8 || d <= 0 ||
      num_heads <= 0 || num_heads > 65535 || d % num_heads || valid_len < 0 || valid_len > tp)
    return cudaErrorInvalidValue;
  const int dh = d / num_heads;
  if (dh % 16 || dh > 128 || att_smem_bytes(tp, dh) > kMaxSmem) return cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = batch * tp;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* sc = static_cast<bf16*>(scratch);
  bf16* qb = static_cast<bf16*>(qkv);

  cudaError_t e = launch_layernorm(xb, static_cast<const float*>(ln_scale),
                                   static_cast<const float*>(ln_bias), sc, rows, d, eps, s);
  if (e != cudaSuccess) return e;
  e = launch_gemm<kEpiBias>(sc, static_cast<const bf16*>(w_qkv), static_cast<const float*>(b_qkv),
                            nullptr, qb, rows, 3 * d, d, s);
  if (e != cudaSuccess) return e;
  e = attention(qb, sc, batch, tp, d, num_heads, valid_len, scale, s);
  if (e != cudaSuccess) return e;
  return launch_gemm<kEpiBiasResidual>(sc, static_cast<const bf16*>(w_proj),
                                       static_cast<const float*>(b_proj), xb,
                                       static_cast<bf16*>(out), rows, d, d, s);
}

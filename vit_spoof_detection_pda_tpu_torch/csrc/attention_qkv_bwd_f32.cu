// Backward of the attention core in f32 on Hopper: given the fused
// projection qkv [B, Tp, 3D] f32 (q | k | v, heads contiguous inside each)
// and the cotangent g [B, Tp, D] f32 of the concatenated head outputs (zero
// on pad rows), per head
//
//   w  = softmax(q k^T * s), key columns >= valid_len at -1e30
//   dv = w^T g,  dw = g v^T,  dl = w (dw - rowsum(dw w))
//   dq = dl k * s,  dk = dl^T q * s
//
// into dqkv [B, Tp, 3D] f32.  Replaces the f32 form of the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_qkv_bwd_kernel (:199),
// whose f32 dots keep exact products; so does this one (plain f32 FMAs,
// never TF32).
//
// Bound on the H100: the f32 FMA rate.  At ViT-B, B = 32, Tp = 200 the five
// [Tp, Tp] x Dh products per head are 9.8 GFLOP, >= 0.147 ms at 67 TFLOP/s;
// qkv and g in and dqkv out are 72 MB (0.021 ms at 3.35 TB/s).
//
// Design.  The bf16 kernel (attention_qkv_bwd.cu) holds a head's whole
// [Tp, Tp] w and dl in shared memory; in f32 those alone take 320 KB at
// Tp = 200, over the card's 227 KB.  So f32 runs two launches, each of
// which holds one head's operands [Tp][Dh + 4] in shared memory and keeps
// only a warp's 4 rows (or 4 keys) of w and dl, [Tp][4] each:
//   A. rows: grid (query tiles, heads, B), K and V staged.  A warp takes 4
//      query rows at a time: its lanes score their keys (s = q k * s) and
//      form dw = g v, the row max m and sum l (warp reductions) give
//      w = exp(s - m) / l, then dd = rowsum(dw w), dl = w (dw - dd), and
//      dq = dl K * s with each lane owning columns lane, lane + 32, ...
//      m, l and dd of every row go to a small stats buffer [B, H, Tp, 4].
//   B. keys: grid (key tiles, heads, B), Q, G and the rows' stats staged.
//      A warp takes 4 keys at a time: its lanes take the query rows
//      (lane, lane + 32, ...) and recompute s, w = exp(s - m) / l, dw and
//      dl = w (dw - dd) with the same f32 operations in the same order as
//      launch A (so the same bits), then dv = w^T G and dk = dl^T Q * s
//      with each lane owning columns.
// The scores and dw are computed twice (7 products instead of 5).  Rows
// with g = 0 give dw = 0, hence dd = 0 and dl = 0: pad rows add nothing;
// masked key columns have w = 0 exactly, so their dk and dv are 0.
#include <math_constants.h>

#include "common.cuh"

namespace vsd {
namespace {

constexpr int kBwdF32Warps = 8;       // warps of a block
constexpr int kBwdF32Rows = 4;        // rows (A) or keys (B) of a warp at a time
constexpr int kBwdF32TileRows = 128;  // rows or keys of a block at most

// Both launches: two staged [t][dh + 4] head tiles, the stats of t rows
// (launch B), and per warp two [4][dh] rows and two [t][4] columns.
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

// Stage rows [0, t) of one head's DH columns of a [B, t, width] matrix.
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

template <int DH>
__global__ void __launch_bounds__(kBwdF32Warps * 32)
    attn_bwd_rows_f32(const float* __restrict__ qkv, const float* __restrict__ gout,
                      float* __restrict__ dqkv, float* __restrict__ stats, int t, int d,
                      int valid_len, float scale, int tile_rows) {
  constexpr int LD = DH + 4;
  constexpr int NJ = (DH + 31) / 32;
  extern __shared__ __align__(16) float smf[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Ks = smf;
  float* Vs = Ks + static_cast<size_t>(t) * LD;
  float* Qw = Vs + static_cast<size_t>(t) * LD + 4 * static_cast<size_t>(t) +
              static_cast<size_t>(warp) * (2 * kBwdF32Rows * DH + 8 * t);
  float* Gw = Qw + kBwdF32Rows * DH;
  float* Pw = Gw + kBwdF32Rows * DH;  // [t][4]: s, then w, then dl
  float* Dw = Pw + 4 * t;             // [t][4]: dw
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const size_t stride = 3 * static_cast<size_t>(d);
  const float* base = qkv + static_cast<size_t>(b) * t * stride + static_cast<size_t>(h) * DH;
  const float* gbase = gout + static_cast<size_t>(b) * t * d + static_cast<size_t>(h) * DH;
  float* obase = dqkv + static_cast<size_t>(b) * t * stride + static_cast<size_t>(h) * DH;
  float* sbase = stats + (static_cast<size_t>(b) * heads + h) * t * 4;

  stage_f32<DH>(Ks, base + d, stride, t);
  stage_f32<DH>(Vs, base + 2 * d, stride, t);
  __syncthreads();

  const int q_end = min(t, (static_cast<int>(blockIdx.x) + 1) * tile_rows);
  for (int r0 = blockIdx.x * tile_rows + warp * kBwdF32Rows; r0 < q_end;
       r0 += kBwdF32Warps * kBwdF32Rows) {
    warp_rows<DH>(Qw, base, stride, r0, q_end, lane);
    warp_rows<DH>(Gw, gbase, d, r0, q_end, lane);
    __syncwarp();

    // scores and dw of this lane's keys; the row max
    float m[kBwdF32Rows];
#pragma unroll
    for (int rr = 0; rr < kBwdF32Rows; ++rr) m[rr] = -CUDART_INF_F;
    for (int key = lane; key < t; key += 32) {
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
    for (int key = lane; key < t; key += 32) {
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
    for (int key = lane; key < t; key += 32) {
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
    for (int key = lane; key < t; key += 32) {
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
      *reinterpret_cast<float4*>(sbase + static_cast<size_t>(r0 + lane) * 4) =
          make_float4(mv, lv, dv, 0.f);
    }
    __syncwarp();

    // dq = dl K * s
    float o[kBwdF32Rows][NJ];
#pragma unroll
    for (int rr = 0; rr < kBwdF32Rows; ++rr)
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[rr][j] = 0.f;
    for (int key = 0; key < t; ++key) {
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
      float* orow = obase + static_cast<size_t>(r0 + rr) * stride;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < DH) orow[c] = o[rr][j] * scale;
      }
    }
    __syncwarp();  // Qw, Gw, Pw and Dw are rewritten by the next rows
  }
}

template <int DH>
__global__ void __launch_bounds__(kBwdF32Warps * 32)
    attn_bwd_keys_f32(const float* __restrict__ qkv, const float* __restrict__ gout,
                      float* __restrict__ dqkv, const float* __restrict__ stats, int t, int d,
                      int valid_len, float scale, int tile_keys) {
  constexpr int LD = DH + 4;
  constexpr int NJ = (DH + 31) / 32;
  extern __shared__ __align__(16) float smf[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Qs = smf;
  float* Gs = Qs + static_cast<size_t>(t) * LD;
  float* St = Gs + static_cast<size_t>(t) * LD;  // [t][4]: m, l, dd
  float* Kw = St + 4 * static_cast<size_t>(t) +
              static_cast<size_t>(warp) * (2 * kBwdF32Rows * DH + 8 * t);
  float* Vw = Kw + kBwdF32Rows * DH;
  float* Pw = Vw + kBwdF32Rows * DH;  // [t][4]: w
  float* Lw = Pw + 4 * t;             // [t][4]: dl
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const size_t stride = 3 * static_cast<size_t>(d);
  const float* base = qkv + static_cast<size_t>(b) * t * stride + static_cast<size_t>(h) * DH;
  const float* gbase = gout + static_cast<size_t>(b) * t * d + static_cast<size_t>(h) * DH;
  float* obase = dqkv + static_cast<size_t>(b) * t * stride + static_cast<size_t>(h) * DH;
  const float* sbase = stats + (static_cast<size_t>(b) * heads + h) * t * 4;

  stage_f32<DH>(Qs, base, stride, t);
  stage_f32<DH>(Gs, gbase, d, t);
  for (int r = tid; r < t; r += blockDim.x)
    *reinterpret_cast<float4*>(St + r * 4) =
        __ldg(reinterpret_cast<const float4*>(sbase + static_cast<size_t>(r) * 4));
  __syncthreads();

  const int k_end = min(t, (static_cast<int>(blockIdx.x) + 1) * tile_keys);
  for (int k0 = blockIdx.x * tile_keys + warp * kBwdF32Rows; k0 < k_end;
       k0 += kBwdF32Warps * kBwdF32Rows) {
    warp_rows<DH>(Kw, base + d, stride, k0, k_end, lane);
    warp_rows<DH>(Vw, base + 2 * d, stride, k0, k_end, lane);
    __syncwarp();

    // w and dl of every query row against the warp's 4 keys, each from the
    // same f32 operations as launch A
    for (int r = lane; r < t; r += 32) {
      float s[kBwdF32Rows], dw[kBwdF32Rows];
      dots4<DH>(s, Kw, Qs + r * LD);
      dots4<DH>(dw, Vw, Gs + r * LD);
      const float4 st = *reinterpret_cast<const float4*>(St + r * 4);
      float w[kBwdF32Rows], dl[kBwdF32Rows];
#pragma unroll
      for (int kk = 0; kk < kBwdF32Rows; ++kk) {
        const float sv = k0 + kk < valid_len ? s[kk] * scale : -1e30f;
        w[kk] = expf(sv - st.x) / st.y;
        dl[kk] = w[kk] * (dw[kk] - st.z);
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
    for (int r = 0; r < t; ++r) {
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
      float* krow = obase + static_cast<size_t>(k0 + kk) * stride + d;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < DH) {
          krow[c] = ok[kk][j] * scale;
          krow[d + c] = ov[kk][j];
        }
      }
    }
    __syncwarp();  // Kw, Vw, Pw and Lw are rewritten by the next keys
  }
}

template <int DH>
cudaError_t launch_bwd_f32(const float* qkv, const float* g, float* dqkv, float* stats,
                           int batch, int t, int d, int heads, int valid_len, float scale,
                           cudaStream_t stream) {
  const size_t smem = bwd_f32_smem_bytes(t, DH);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_rows_f32<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attn_bwd_keys_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // rows (keys) split evenly into tiles of at most kBwdF32TileRows, in
  // whole 4-row groups
  const int tiles = (t + kBwdF32TileRows - 1) / kBwdF32TileRows;
  const int rows = ((t + tiles - 1) / tiles + kBwdF32Rows - 1) / kBwdF32Rows * kBwdF32Rows;
  const dim3 grid((t + rows - 1) / rows, heads, batch);
  attn_bwd_rows_f32<DH><<<grid, kBwdF32Warps * 32, smem, stream>>>(qkv, g, dqkv, stats, t, d,
                                                                   valid_len, scale, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_keys_f32<DH><<<grid, kBwdF32Warps * 32, smem, stream>>>(qkv, g, dqkv, stats, t, d,
                                                                   valid_len, scale, rows);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// qkv, dqkv [B, Tp, 3D] f32; g [B, Tp, D] f32, zero on rows >= valid_len;
// stats [B, H, Tp, 4] f32 scratch.  Needs a head dim that is a multiple of
// 16 up to 128, 0 < valid_len <= Tp and the launches' shared memory
// (4 (2 Tp (Dh + 4) + 4 Tp + 8 (8 Dh + 8 Tp)) bytes) within the card's.
// Returns the first CUDA error of the two launches (0 on success).
extern "C" int vsd_attention_qkv_bwd_f32(const void* qkv, const void* g, void* dqkv,
                                         void* stats, int batch, int tp, int d, int num_heads,
                                         int valid_len, float scale, void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || tp <= 0 || d <= 0 || num_heads <= 0 ||
      num_heads > 65535 || d % num_heads || valid_len <= 0 || valid_len > tp)
    return cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(qkv);
  const float* gf = static_cast<const float*>(g);
  float* out = static_cast<float*>(dqkv);
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / num_heads) {
#define VSD_HEAD_DIM(DH) \
  case DH:               \
    return launch_bwd_f32<DH>(q, gf, out, st, batch, tp, d, num_heads, valid_len, scale, s);
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

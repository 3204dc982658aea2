// The f32 attention core of the port's module path (kernel 8's f32 route,
// csrc/attention_qkv.cu) and of the f32 attention blocks
// (csrc/attention_block_f32.cu):
//
//   out[b, :, h] = softmax(Q_h K_h^T * scale) V_h
//
// per head h on the fused projection qkv [B, T, 3D] f32, key columns at or
// past valid_len at -1e30, in plain f32 FMAs (never the tensor cores: TF32
// would round q, k and the weights to 10 mantissa bits).  The design and
// its bound are described in attention_qkv.cu.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace vsd {
namespace {

constexpr int kF32Warps = 8;      // warps of a block
constexpr int kF32Rows = 4;       // query rows of a warp at a time
constexpr int kF32TileRows = 128; // query rows of a block at most

__host__ __device__ inline size_t f32_smem_bytes(int t, int dh) {
  return (2 * static_cast<size_t>(t) * (dh + 4) +
          static_cast<size_t>(kF32Warps) * kF32Rows * (dh + t)) *
         sizeof(float);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One query tile (blockIdx.x, tile_rows rows) of one (head, item) over three
// base pointers: q, k and v point at that head's slice of row 0 (row r at
// + r * ld), out at the head's slice of output row 0 (row r at + r * ldo).
// ld and the pointers keep 16-byte float4 rows (ld a multiple of 4).
template <int DH>
__device__ __forceinline__ void attention_f32_rows(const float* __restrict__ q,
                                                   const float* __restrict__ k,
                                                   const float* __restrict__ v, size_t ld,
                                                   float* __restrict__ out, size_t ldo, int t,
                                                   int valid_len, float scale, int tile_rows) {
  constexpr int LD = DH + 4;          // shared row stride (floats), 16-byte multiple
  constexpr int C4 = DH / 4;          // float4 chunks of a head row
  constexpr int NJ = (DH + 31) / 32;  // output columns of a lane
  extern __shared__ __align__(16) float smf[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Ks = smf;
  float* Vs = Ks + static_cast<size_t>(t) * LD;
  float* Qw = Vs + static_cast<size_t>(t) * LD +
              static_cast<size_t>(warp) * kF32Rows * (DH + t);  // [4][DH]
  float* Pw = Qw + kF32Rows * DH;                               // [t][4]

  for (int c = tid; c < t * C4; c += blockDim.x) {
    const int r = c / C4, col = (c % C4) * 4;
    *reinterpret_cast<float4*>(Ks + r * LD + col) =
        __ldg(reinterpret_cast<const float4*>(k + r * ld + col));
    *reinterpret_cast<float4*>(Vs + r * LD + col) =
        __ldg(reinterpret_cast<const float4*>(v + r * ld + col));
  }
  __syncthreads();

  const int tile = static_cast<int>(blockIdx.x);
  const int q_end = min(t, (tile + 1) * tile_rows);
  for (int r0 = tile * tile_rows + warp * kF32Rows; r0 < q_end;
       r0 += kF32Warps * kF32Rows) {
    // the 4 query rows; rows past the tile are zeros and are not written
    for (int c = lane; c < kF32Rows * C4; c += 32) {
      const int rr = c / C4, col = (c % C4) * 4;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + rr < q_end) qv = __ldg(reinterpret_cast<const float4*>(q + (r0 + rr) * ld + col));
      *reinterpret_cast<float4*>(Qw + rr * DH + col) = qv;
    }
    __syncwarp();

    // 1. logits of this lane's keys, and the row max
    float m[kF32Rows];
#pragma unroll
    for (int rr = 0; rr < kF32Rows; ++rr) m[rr] = -CUDART_INF_F;
    for (int key = lane; key < t; key += 32) {
      float s[kF32Rows] = {0.f, 0.f, 0.f, 0.f};
      const float* kr = Ks + key * LD;
#pragma unroll
      for (int c = 0; c < DH; c += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int rr = 0; rr < kF32Rows; ++rr) {
          const float4 qv = *reinterpret_cast<const float4*>(Qw + rr * DH + c);
          s[rr] = fmaf(qv.x, kv.x, s[rr]);
          s[rr] = fmaf(qv.y, kv.y, s[rr]);
          s[rr] = fmaf(qv.z, kv.z, s[rr]);
          s[rr] = fmaf(qv.w, kv.w, s[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kF32Rows; ++rr) {
        s[rr] = key < valid_len ? s[rr] * scale : -1e30f;
        m[rr] = fmaxf(m[rr], s[rr]);
      }
      *reinterpret_cast<float4*>(Pw + key * 4) = make_float4(s[0], s[1], s[2], s[3]);
    }
#pragma unroll
    for (int rr = 0; rr < kF32Rows; ++rr) m[rr] = warp_max(m[rr]);

    // 2. e = exp(s - m), l = sum e, w = e / l
    float l[kF32Rows] = {0.f, 0.f, 0.f, 0.f};
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
    for (int rr = 0; rr < kF32Rows; ++rr) l[rr] = warp_sum(l[rr]);
    for (int key = lane; key < t; key += 32) {
      float4 w = *reinterpret_cast<const float4*>(Pw + key * 4);
      w.x /= l[0];
      w.y /= l[1];
      w.z /= l[2];
      w.w /= l[3];
      *reinterpret_cast<float4*>(Pw + key * 4) = w;
    }
    __syncwarp();

    // 3. O = w V
    float o[kF32Rows][NJ];
#pragma unroll
    for (int rr = 0; rr < kF32Rows; ++rr) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[rr][j] = 0.f;
    }
    for (int key = 0; key < t; ++key) {
      const float4 w = *reinterpret_cast<const float4*>(Pw + key * 4);
      const float* vr = Vs + key * LD;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < DH) {
          const float vv = vr[c];
          o[0][j] = fmaf(w.x, vv, o[0][j]);
          o[1][j] = fmaf(w.y, vv, o[1][j]);
          o[2][j] = fmaf(w.z, vv, o[2][j]);
          o[3][j] = fmaf(w.w, vv, o[3][j]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kF32Rows; ++rr) {
      if (r0 + rr >= q_end) continue;
      float* orow = out + static_cast<size_t>(r0 + rr) * ldo;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c < DH) orow[c] = o[rr][j];
      }
    }
    __syncwarp();  // Qw and Pw are rewritten by the next rows
  }
}

// Kernel 8's f32 route: the fused projection qkv [B, T, 3D] -> out [B, T, D],
// grid (query tiles, heads, B).
template <int DH>
__global__ void __launch_bounds__(kF32Warps * 32)
    attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int t, int d,
                         int valid_len, float scale, int tile_rows) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t stride = 3 * static_cast<size_t>(d);
  const float* base = qkv + static_cast<size_t>(b) * t * stride + static_cast<size_t>(h) * DH;
  attention_f32_rows<DH>(base, base + d, base + 2 * d, stride,
                         out + static_cast<size_t>(b) * t * d + static_cast<size_t>(h) * DH, d,
                         t, valid_len, scale, tile_rows);
}

// The query tiles of a launch: rows split evenly into tiles of at most
// kF32TileRows, in whole 4-row groups.
inline int f32_tile_rows(int t) {
  const int tiles = (t + kF32TileRows - 1) / kF32TileRows;
  return ((t + tiles - 1) / tiles + kF32Rows - 1) / kF32Rows * kF32Rows;
}

template <int DH>
cudaError_t launch_attention_f32(const float* qkv, float* out, int batch, int t, int d,
                                 int heads, int valid_len, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(t, DH);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_f32_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = f32_tile_rows(t);
  const dim3 grid((t + rows - 1) / rows, heads, batch);
  attention_f32_kernel<DH><<<grid, kF32Warps * 32, smem, stream>>>(qkv, out, t, d, valid_len,
                                                                   scale, rows);
  return cudaGetLastError();
}

cudaError_t attention_f32(const float* qkv, float* out, int batch, int t, int d, int heads,
                          int valid_len, float scale, cudaStream_t stream) {
  switch (d / heads) {
#define VSD_HEAD_DIM(DH) \
  case DH:               \
    return launch_attention_f32<DH>(qkv, out, batch, t, d, heads, valid_len, scale, stream);
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

// The f32 attention core of kernels 1, 3 (the f32 attention blocks,
// csrc/attention_block_f32.cu), 8 and 9 past the keys their one-pass core
// holds (csrc/attention_self.cuh, which launches it):
//
//   out[b, :, h] = softmax(Q_h K_h^T * scale) V_h
//
// per head h on strided q, k and v f32 (the fused projection qkv [B, T, 3D]
// of the blocks and kernel 8), key columns at or past valid_len at -1e30,
// in plain f32 FMAs (never the tensor cores: TF32 would round q, k and the
// weights to 10 mantissa bits).  Grid (query
// tiles, heads, B); a block of 8 warps loads one head's K and V
// [T][dh + 4] into shared memory (16-byte rows, the +4 keeps a
// quarter-warp's float4 reads on distinct banks), and each warp takes 4
// query rows at a time:
//   1. each lane scores its keys (lane, lane + 32, ...) against the 4
//      rows, q from shared memory as float4 broadcasts; the logits go to
//      the warp's [T][4] buffer, the row maxima to a warp reduction;
//   2. e = exp(s - m) and l = sum e (warp reductions), then
//      w = e / l in f32 (jax.nn.softmax's arithmetic);
//   3. O = w V, each lane owning columns lane, lane + 32, ... of the 4
//      rows, one float4 broadcast of the 4 rows' weights per key.
// It reads K, V and q from shared memory for every FMA (1.25 16-byte loads
// per 4 FMAs in step 1), so shared-memory bandwidth, not the FMA rate
// (67 TFLOP/s), is its limit.
//
// Two forms, chosen by shape (ops/attention.py::module_attention_plan):
// where one head's K and V fit a block's shared memory (f32_smem_bytes; T
// up to 333 at head dim 64), attention_f32_rows holds
// them whole and takes the exact softmax of each row; past that,
// attention_f32_rows_tiled walks the keys in tiles of kF32KeyTile staged
// through shared memory, with an online softmax (the running max and sum
// rescale the output sums at each tile, and the output is divided by the
// sum once at the end), so any T runs.  The tiled form differs from the
// whole one only in the order and place of f32 roundings.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace vsd {
namespace {

constexpr int kF32Warps = 8;      // warps of a block
constexpr int kF32Rows = 4;       // query rows of a warp at a time
constexpr int kF32TileRows = 128; // query rows of a block at most

// Shared memory of one block over tk keys: K and V [tk][dh + 4], and per
// warp 4 query rows [4][dh] and their weights [tk][4].
__host__ __device__ inline size_t f32_smem_bytes(int tk, int dh) {
  return (2 * static_cast<size_t>(tk) * (dh + 4) +
          static_cast<size_t>(kF32Warps) * kF32Rows * (dh + tk)) *
         sizeof(float);
}

// The key-tiled form: K and V tiles [kF32KeyTile][dh + 4] and per warp 4
// query rows [4][dh] and their tile weights [kF32KeyTile][4].
constexpr int kF32KeyTile = 128;
__host__ __device__ inline size_t f32_tiled_smem_bytes(int dh) {
  return (2 * static_cast<size_t>(kF32KeyTile) * (dh + 4) +
          static_cast<size_t>(kF32Warps) * kF32Rows * (dh + kF32KeyTile)) *
         sizeof(float);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One query tile (blockIdx.x, tile_rows rows) of one (head, item) over three
// base pointers: q points at that head's slice of query row 0 (row r at
// + r * ldq), k and v at its slice of key row 0 (row r at + r * ldk), out at
// the head's slice of output row 0 (row r at + r * ldo); tq query rows
// against tk keys (f32_smem_bytes(tk, DH) of shared memory).  ldq, ldk and
// the pointers keep 16-byte float4 rows (multiples of 4).
template <int DH>
__device__ __forceinline__ void attention_f32_rows(const float* __restrict__ q, size_t ldq,
                                                   const float* __restrict__ k,
                                                   const float* __restrict__ v, size_t ldk,
                                                   float* __restrict__ out, size_t ldo, int tq,
                                                   int tk, int valid_len, float scale,
                                                   int tile_rows) {
  constexpr int LD = DH + 4;          // shared row stride (floats), 16-byte multiple
  constexpr int C4 = DH / 4;          // float4 chunks of a head row
  constexpr int NJ = (DH + 31) / 32;  // output columns of a lane
  extern __shared__ __align__(16) float smf[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Ks = smf;
  float* Vs = Ks + static_cast<size_t>(tk) * LD;
  float* Qw = Vs + static_cast<size_t>(tk) * LD +
              static_cast<size_t>(warp) * kF32Rows * (DH + tk);  // [4][DH]
  float* Pw = Qw + kF32Rows * DH;                                // [tk][4]

  for (int c = tid; c < tk * C4; c += blockDim.x) {
    const int r = c / C4, col = (c % C4) * 4;
    *reinterpret_cast<float4*>(Ks + r * LD + col) =
        __ldg(reinterpret_cast<const float4*>(k + r * ldk + col));
    *reinterpret_cast<float4*>(Vs + r * LD + col) =
        __ldg(reinterpret_cast<const float4*>(v + r * ldk + col));
  }
  __syncthreads();

  const int tile = static_cast<int>(blockIdx.x);
  const int q_end = min(tq, (tile + 1) * tile_rows);
  for (int r0 = tile * tile_rows + warp * kF32Rows; r0 < q_end;
       r0 += kF32Warps * kF32Rows) {
    // the 4 query rows; rows past the tile are zeros and are not written
    for (int c = lane; c < kF32Rows * C4; c += 32) {
      const int rr = c / C4, col = (c % C4) * 4;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + rr < q_end) qv = __ldg(reinterpret_cast<const float4*>(q + (r0 + rr) * ldq + col));
      *reinterpret_cast<float4*>(Qw + rr * DH + col) = qv;
    }
    __syncwarp();

    // 1. logits of this lane's keys, and the row max
    float m[kF32Rows];
#pragma unroll
    for (int rr = 0; rr < kF32Rows; ++rr) m[rr] = -CUDART_INF_F;
    for (int key = lane; key < tk; key += 32) {
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
    for (int rr = 0; rr < kF32Rows; ++rr) l[rr] = warp_sum(l[rr]);
    for (int key = lane; key < tk; key += 32) {
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
    for (int key = 0; key < tk; ++key) {
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

// The key-tiled form: a block of kF32Warps warps takes 32 query rows (4 a
// warp) of one (head, item) against tk keys in tiles of kF32KeyTile.  Per
// tile: K and V staged, each lane's logits of the warp's 4 rows, the tile's
// row max; the running max m and sum l and the output sums rescaled by
// exp(m_old - m); e = exp(s - m) into the warp's buffer; O += e V.  The
// output is O / l.  Pointers as in attention_f32_rows; blockIdx.x is the
// 32-row tile.
template <int DH>
__device__ __forceinline__ void attention_f32_rows_tiled(const float* __restrict__ q, size_t ldq,
                                                         const float* __restrict__ k,
                                                         const float* __restrict__ v, size_t ldk,
                                                         float* __restrict__ out, size_t ldo,
                                                         int tq, int tk, int valid_len,
                                                         float scale) {
  constexpr int LD = DH + 4;
  constexpr int C4 = DH / 4;
  constexpr int NJ = (DH + 31) / 32;
  constexpr int KT = kF32KeyTile;
  extern __shared__ __align__(16) float smf[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Ks = smf;
  float* Vs = Ks + KT * LD;
  float* Qw = Vs + KT * LD + warp * kF32Rows * (DH + KT);  // [4][DH]
  float* Pw = Qw + kF32Rows * DH;                          // [KT][4]

  const int r0 = blockIdx.x * kF32Warps * kF32Rows + warp * kF32Rows;
  const bool active = r0 < tq;
  for (int c = lane; c < kF32Rows * C4; c += 32) {
    const int rr = c / C4, col = (c % C4) * 4;
    float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + rr < tq) qv = __ldg(reinterpret_cast<const float4*>(q + (r0 + rr) * ldq + col));
    *reinterpret_cast<float4*>(Qw + rr * DH + col) = qv;
  }
  float m[kF32Rows], l[kF32Rows], o[kF32Rows][NJ];
#pragma unroll
  for (int rr = 0; rr < kF32Rows; ++rr) {
    m[rr] = -CUDART_INF_F;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[rr][j] = 0.f;
  }

  for (int t0 = 0; t0 < tk; t0 += KT) {
    const int n = min(KT, tk - t0);
    __syncthreads();  // the last tile's K and V are no longer read
    for (int c = tid; c < n * C4; c += blockDim.x) {
      const int r = c / C4, col = (c % C4) * 4;
      *reinterpret_cast<float4*>(Ks + r * LD + col) =
          __ldg(reinterpret_cast<const float4*>(k + (t0 + r) * ldk + col));
      *reinterpret_cast<float4*>(Vs + r * LD + col) =
          __ldg(reinterpret_cast<const float4*>(v + (t0 + r) * ldk + col));
    }
    __syncthreads();
    if (!active) continue;

    // 1. logits of this lane's keys, the tile's row max
    float mt[kF32Rows];
#pragma unroll
    for (int rr = 0; rr < kF32Rows; ++rr) mt[rr] = -CUDART_INF_F;
    for (int key = lane; key < n; key += 32) {
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
        s[rr] = t0 + key < valid_len ? s[rr] * scale : -1e30f;
        mt[rr] = fmaxf(mt[rr], s[rr]);
      }
      *reinterpret_cast<float4*>(Pw + key * 4) = make_float4(s[0], s[1], s[2], s[3]);
    }
    // 2. the running max; l and O rescaled; e = exp(s - m) (key 0 is real,
    // so m is finite from the first tile on)
#pragma unroll
    for (int rr = 0; rr < kF32Rows; ++rr) {
      const float mn = fmaxf(m[rr], warp_max(mt[rr]));
      const float corr = expf(m[rr] - mn);
      l[rr] *= corr;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[rr][j] *= corr;
      m[rr] = mn;
    }
    float lt[kF32Rows] = {0.f, 0.f, 0.f, 0.f};
    for (int key = lane; key < n; key += 32) {
      float4 e = *reinterpret_cast<const float4*>(Pw + key * 4);
      e.x = expf(e.x - m[0]);
      e.y = expf(e.y - m[1]);
      e.z = expf(e.z - m[2]);
      e.w = expf(e.w - m[3]);
      lt[0] += e.x;
      lt[1] += e.y;
      lt[2] += e.z;
      lt[3] += e.w;
      *reinterpret_cast<float4*>(Pw + key * 4) = e;
    }
#pragma unroll
    for (int rr = 0; rr < kF32Rows; ++rr) l[rr] += warp_sum(lt[rr]);
    __syncwarp();

    // 3. O += e V
    for (int key = 0; key < n; ++key) {
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
    __syncwarp();  // Pw is rewritten by the next tile
  }
  if (!active) return;
#pragma unroll
  for (int rr = 0; rr < kF32Rows; ++rr) {
    if (r0 + rr >= tq) continue;
    float* orow = out + static_cast<size_t>(r0 + rr) * ldo;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < DH) orow[c] = o[rr][j] / l[rr];
    }
  }
}

// The query tiles of a launch: rows split evenly into tiles of at most
// kF32TileRows, in whole 4-row groups.
inline int f32_tile_rows(int t) {
  const int tiles = (t + kF32TileRows - 1) / kF32TileRows;
  return ((t + tiles - 1) / tiles + kF32Rows - 1) / kF32Rows * kF32Rows;
}

// Launch a key-tiled kernel (grid (32-row tiles, heads, B)) with its shared
// memory.
template <typename Kernel, typename... Args>
cudaError_t launch_f32_tiled(Kernel kernel, int dh, int t, int heads, int batch,
                             cudaStream_t stream, Args... args) {
  const size_t smem = f32_tiled_smem_bytes(dh);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = kF32Warps * kF32Rows;
  kernel<<<dim3((t + rows - 1) / rows, heads, batch), kF32Warps * 32, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// The bf16 attention forward's key-tiled route, kernel 12's two passes
// (attention_cp_core.cuh::cp_rows_bf16_tiles with Tq = Tk: f32 logits, the
// f32 softmax normalised before the bf16 rounding, P V summed in f32, one
// rounding) over strided q, k and v, with K and V staged whole or in tiles
// of 256 keys where they do not fit a block.  The attention forwards of
// kernels 1, 3, 8 and 9 launch it past the keys kernel 12's one-pass core
// holds (attention_self.cuh::launch_self).  Kernels 10 and 11 run their
// own attention phase on the same arithmetic (lowlat_core.cuh
// attention_phase, keys split over warps, kAttKeyChunk keys a step).
#pragma once

#include <math_constants.h>

#include "attention_cp_core.cuh"
#include "common.cuh"

namespace vsd {
namespace {

constexpr int kAttKeyChunk = 64;   // keys per step of the score loops

__host__ __device__ inline int att_keys(int tk) { return (tk + 15) / 16 * 16; }

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

}  // namespace
}  // namespace vsd

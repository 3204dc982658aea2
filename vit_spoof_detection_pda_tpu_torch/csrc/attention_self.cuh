// The attention forward of the module path, shared by kernel 8
// (csrc/attention_qkv.cu, the fused projection) and kernel 9
// (csrc/attention.cu, q/k/v views), and the attention stage of the blocks,
// kernels 1 and 3 (csrc/attention_block*.cu, the fused projection):
//
//   out[b, :, h] = softmax(Q[b, :, h] K[b, :, h]^T * scale) V[b, :, h]
//
// over q, k and v that share their strides: head h of item b at
// base + b * bs + h * DH, rows ld apart (kernel 8: the three thirds of
// qkv [B, T, 3D], ld = 3D), key columns at or past valid_len at -1e30,
// written as the concatenated head outputs out [B, T, D], in bf16 or f32.
// The route is chosen by shape (launch_self; ops/attention.py::
// module_attention_plan names the same one for the launch counter):
//   one pass       kernel 12's one-pass core (attention_cp_core.cuh::
//                  cp_rows_bf16 / cp_rows_f32_split with Tq = Tk = T), where
//                  the keys rounded up to 16 (bf16) or 8 (f32) are at most
//                  208 and, in f32, the block fits;
//   bf16 past it   kernel 12's two passes (attention_core.cuh::
//                  launch_attention_tiled: cp_rows_bf16_tiles with every key
//                  staged at once, or over tiles of 256 keys where K and V
//                  do not fit a block);
//   f32 past it    the two-pass core of the f32 blocks with one head's K
//                  and V whole in a block (attention_f32.cuh::
//                  attention_f32_rows), else its key-tiled form
//                  (attention_f32_rows_tiled: tiles of 128 keys, an online
//                  softmax).
// The design of each core and its bounds are in attention_qkv.cu.
#pragma once

#include "attention_core.cuh"  // launch_attention_tiled: kernel 12's two passes, strided
#include "attention_cp_core.cuh"
#include "attention_f32.cuh"

namespace vsd {
namespace {

// The offset of this block's (head, item) in q, k and v, and in out.
template <int DH>
__device__ __forceinline__ size_t self_in(long long bs) {
  return static_cast<size_t>(blockIdx.z) * bs + static_cast<size_t>(blockIdx.y) * DH;
}
template <int DH>
__device__ __forceinline__ size_t self_out(int t, int d) {
  return static_cast<size_t>(blockIdx.z) * t * d + static_cast<size_t>(blockIdx.y) * DH;
}

// bf16, one pass: a block of up to kCpMaxWarps warps of 16 query rows
// stages Q, then K in 64-key cp.async groups and V, and keeps every score
// of a warp in registers (the launch bounds of kernel 12's one-pass form:
// two blocks an SM).
template <int DH>
__global__ void __launch_bounds__(kCpMaxWarps * 32, 2)
    self_one_pass_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out, int t, int d,
                         int ld, long long bs, int valid_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t in = self_in<DH>(bs);
  cp_rows_bf16<DH, kCpOnePassKeys>(q + in, ld, k + in, v + in, ld, out + self_out<DH>(t, d), d,
                                   t, t, valid_len, scale, blockIdx.x * (blockDim.x >> 5) * 16,
                                   reinterpret_cast<bf16*>(smem));
}

// f32, one pass: 8 groups of 16 query rows a block, two warps a group.
template <int DH>
__global__ void __launch_bounds__(kCpF32SplitWarps * 32, 1)
    self_one_pass_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out, int t, int d,
                             int ld, long long bs, int valid_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t in = self_in<DH>(bs);
  cp_rows_f32_split<DH, kCpOnePassKeys>(q + in, ld, k + in, v + in, ld,
                                        out + self_out<DH>(t, d), d, t, t, valid_len, scale,
                                        blockIdx.x * 8 * 16, reinterpret_cast<float*>(smem));
}

template <int DH>
__global__ void __launch_bounds__(kF32Warps * 32)
    self_whole_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out, int t, int d,
                          int ld, long long bs, int valid_len, float scale, int tile_rows) {
  const size_t in = self_in<DH>(bs);
  attention_f32_rows<DH>(q + in, ld, k + in, v + in, ld, out + self_out<DH>(t, d), d, t, t,
                         valid_len, scale, tile_rows);
}

template <int DH>
__global__ void __launch_bounds__(kF32Warps * 32)
    self_key_tiled_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ out, int t, int d,
                              int ld, long long bs, int valid_len, float scale) {
  const size_t in = self_in<DH>(bs);
  attention_f32_rows_tiled<DH>(q + in, ld, k + in, v + in, ld, out + self_out<DH>(t, d), d, t,
                               t, valid_len, scale);
}

// Set a kernel's dynamic shared memory and launch it.
template <typename Kernel, typename... Args>
cudaError_t launch_smem(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                        Args... args) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The route by shape (ops/attention.py::module_attention_plan names the
// same one for the launch counter).
template <int DH>
cudaError_t launch_self(const void* q, const void* k, const void* v, void* out, int dtype,
                        int batch, int t, int heads, int ld, long long bs, int valid_len,
                        float scale, cudaStream_t s) {
  const int d = heads * DH;
  if (dtype == 0) {
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v);
    bf16* ob = static_cast<bf16*>(out);
    if (cp_keys16(t) > kCpOnePassKeys)  // kernel 12's two passes, K and V whole or in tiles
      return launch_attention_tiled<DH>(qb, kb, vb, ob, batch, t, heads, ld, bs, valid_len,
                                        scale, s);
    int tiles, warps;
    cp_tiles(t, kCpMaxWarps, &tiles, &warps);
    return launch_smem(self_one_pass_kernel<DH>, dim3(tiles, heads, batch), warps * 32,
                       cp_smem_bytes(true, warps, t, DH), s, qb, kb, vb, ob, t, d, ld, bs,
                       valid_len, scale);
  }
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  if (cp_keys8(t) <= kCpOnePassKeys && cp_f32_split_smem_bytes(t, DH) <= kMaxSmem)
    // 8 row groups a block, two warps each
    return launch_smem(self_one_pass_f32_kernel<DH>, dim3((t + 127) / 128, heads, batch),
                       kCpF32SplitWarps * 32, cp_f32_split_smem_bytes(t, DH), s, qf, kf, vf, of,
                       t, d, ld, bs, valid_len, scale);
  if (f32_smem_bytes(t, DH) <= kMaxSmem) {
    const int rows = f32_tile_rows(t);
    return launch_smem(self_whole_f32_kernel<DH>, dim3((t + rows - 1) / rows, heads, batch),
                       kF32Warps * 32, f32_smem_bytes(t, DH), s, qf, kf, vf, of, t, d, ld, bs,
                       valid_len, scale, rows);
  }
  return launch_f32_tiled(self_key_tiled_f32_kernel<DH>, DH, t, heads, batch, s, qf, kf, vf, of,
                          t, d, ld, bs, valid_len, scale);
}

// Kernels 8 and 9 at head dim dh (a multiple of 16 up to 128); any T.  The
// caller checks the rest of the geometry.
cudaError_t attention_self(const void* q, const void* k, const void* v, void* out, int dtype,
                           int batch, int t, int heads, int dh, int ld, long long bs,
                           int valid_len, float scale, cudaStream_t s) {
  switch (dh) {
#define VSD_HEAD_DIM(DH) \
  case DH:               \
    return launch_self<DH>(q, k, v, out, dtype, batch, t, heads, ld, bs, valid_len, scale, s);
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

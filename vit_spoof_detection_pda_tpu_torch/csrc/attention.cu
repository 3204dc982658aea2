// Generic attention on Hopper (kernel 9):
//
//   out[b, :, h, :] = softmax(Q[b, :, h] K[b, :, h]^T * scale) V[b, :, h]
//
// over three tensors q, k and v of shape [B, T, H, Dh] that share their
// strides (heads and head columns contiguous, a row stride ld and a batch
// stride bs, in elements), written as a contiguous [B, T, H, Dh], in bf16
// or f32.  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_kernel (:58; wrapper
// fused_attention :1076, forward _forward :83), which the int8 module path
// (models/serving.py) and models/vit.py::dot_product_attention run.
//
// The TPU kernel pads T to a multiple of 8 rows and masks keys at or past
// T at -1e30; this one takes the T rows as they are (the core zero-fills
// rows past T and gives them no weight), which equals the padded form
// because masked columns add exactly 0.  Rounding points are the TPU
// kernel's: f32 logits q . k * Dh^-0.5, the f32 softmax (e / l), the
// weights rounded to v's dtype, P V summed in f32 and rounded once.
//
// The arithmetic is kernel 8's (csrc/attention_qkv.cu), which computes the
// same core on one fused [B, T, 3D] row: both run attention_core.cuh::
// attention_rows (bf16: mma.sync Q K^T, a two-pass softmax normalized
// before the bf16 rounding, ldmatrix P V) and attention_f32.cuh::
// attention_f32_rows (f32: plain FMAs, no TF32), which take three base
// pointers and their row strides.  Only the addressing differs.
//
// Bound on the H100 at the int8 module path's shape (ViT-B, B = 128,
// T = 197, 12 heads of 64, bf16): q, k, v and the output are
// 4 x 128 x 197 x 768 x 2 B = 77.5 MB, 0.023 ms at 3.35 TB/s, against
// 4 B H T^2 Dh = 15.3 GFLOP, 0.015 ms at 989 TFLOP/s: the bytes bind.  In
// f32 at B = 32, 3.8 GFLOP at 67 TFLOP/s (0.057 ms) binds.  This first
// design reads each head's K and V into shared memory once per query tile
// and, past the T whose K and V fit a block, runs the key-tiled routes of
// kernel 8's cores (attention_core.cuh::launch_attention_tiled in bf16,
// attention_f32.cuh::attention_f32_rows_tiled in f32): any T.
#include "attention_core.cuh"
#include "attention_f32.cuh"

namespace vsd {
namespace {

template <int DH>
__global__ void __launch_bounds__(kAttMaxWarps * 32)
    attention3_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int t, int d,
                      long long ld, long long bs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + att_keys(t) * (DH + 8);
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t off = static_cast<size_t>(b) * bs + static_cast<size_t>(h) * DH;
  attention_rows<DH, false>(q + off, static_cast<size_t>(ld), k + off, v + off,
                            static_cast<size_t>(ld),
                            out + static_cast<size_t>(b) * t * d + static_cast<size_t>(h) * DH,
                            d, t, t, t, scale, blockIdx.x * blockDim.x / 2, Ks, Vs);
}

template <int DH>
__global__ void __launch_bounds__(kF32Warps * 32)
    attention3_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ out, int t, int d,
                          long long ld, long long bs, float scale, int tile_rows) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t off = static_cast<size_t>(b) * bs + static_cast<size_t>(h) * DH;
  attention_f32_rows<DH>(q + off, static_cast<size_t>(ld), k + off, v + off,
                         static_cast<size_t>(ld),
                         out + static_cast<size_t>(b) * t * d + static_cast<size_t>(h) * DH, d,
                         t, t, t, scale, tile_rows);
}

template <int DH>
__global__ void __launch_bounds__(kF32Warps * 32)
    attention3_f32_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ out, int t,
                                int d, long long ld, long long bs, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t off = static_cast<size_t>(b) * bs + static_cast<size_t>(h) * DH;
  attention_f32_rows_tiled<DH>(q + off, static_cast<size_t>(ld), k + off, v + off,
                               static_cast<size_t>(ld),
                               out + static_cast<size_t>(b) * t * d + static_cast<size_t>(h) * DH,
                               d, t, t, t, scale);
}

template <int DH>
cudaError_t launch3(const void* q, const void* k, const void* v, void* out, int dtype, int batch,
                    int t, int heads, long long ld, long long bs, float scale,
                    cudaStream_t stream) {
  const int d = heads * DH;
  if (dtype == 0) {
    const size_t smem = att_smem_bytes(t, DH);
    if (smem > kMaxSmem)  // past one head's K and V: the key-tiled route
      return launch_attention_tiled<DH>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                        static_cast<const bf16*>(v), static_cast<bf16*>(out),
                                        batch, t, heads, static_cast<int>(ld), bs, t, scale,
                                        stream);
    cudaError_t e = cudaFuncSetAttribute(attention3_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const int groups = (t + 15) / 16;  // 16-row query groups, one warp each
    const int tiles = (groups + kAttMaxWarps - 1) / kAttMaxWarps;
    const int warps = (groups + tiles - 1) / tiles;
    attention3_kernel<DH><<<dim3(tiles, heads, batch), warps * 32, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), t, d, ld, bs, scale);
    return cudaGetLastError();
  }
  const size_t smem = f32_smem_bytes(t, DH);
  if (smem > kMaxSmem)  // past one head's K and V: the key-tiled form
    return launch_f32_tiled(attention3_f32_tiled_kernel<DH>, DH, t, heads, batch, stream,
                            static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), static_cast<float*>(out), t, d, ld,
                            bs, scale);
  cudaError_t e = cudaFuncSetAttribute(attention3_f32_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = f32_tile_rows(t);
  attention3_f32_kernel<DH><<<dim3((t + rows - 1) / rows, heads, batch), kF32Warps * 32, smem,
                              stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), t, d, ld, bs, scale, rows);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// q, k, v [B, T, H, Dh] sharing strides (element (b, t, h, c) at
// b * bs + t * ld + h * Dh + c), all bf16 (dtype 0) or f32 (dtype 1),
// 16-byte aligned with ld a multiple of 8 (bf16) or 4 (f32); out a
// contiguous [B, T, H, Dh] of the same dtype.  Needs a head dim that is a
// multiple of 16 up to 128; any T.
// Returns the launch's CUDA error (0 on success).
extern "C" int vsd_attention(const void* q, const void* k, const void* v, void* out, int dtype,
                             int batch, int t, int heads, int dh, long long ld, long long bs,
                             float scale, void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || t <= 0 || heads <= 0 || heads > 65535 ||
      (dtype != 0 && dtype != 1) || ld < static_cast<long long>(heads) * dh ||
      ld % (dtype == 0 ? 8 : 4) || bs < ld * (t - 1) + static_cast<long long>(heads) * dh)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
#define VSD_HEAD_DIM(DH) \
  case DH:               \
    return launch3<DH>(q, k, v, out, dtype, batch, t, heads, ld, bs, scale, s);
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

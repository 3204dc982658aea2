// Rectangular attention for sequence parallelism on Hopper (kernel 12):
//
//   out[b, :, h] = softmax(Q[b, :, h] K[b, :, h]^T * scale) V[b, :, h]
//
// for a local block of Tq query rows q [B, Tq, D] against the gathered
// keys and values kv [B, Tk, 2D] ([k | v], heads contiguous inside each),
// key columns at or past valid_len masked at -1e30, written as the
// concatenated head outputs out [B, Tq, D], in bf16 or f32.  Replaces the
// TPU kernel vit_spoof_detection_pda_tpu/ops/attention.py::_attn_cp_kernel
// (:836; wrapper fused_attention_qkv_cp :987, forward _forward_cp :912),
// which the sequence-parallel attention (_sp_sharded :1024) runs on each
// device's query block against the all-gathered K and V.
//
// The TPU kernel pads Tq and Tk to multiples of 8 with zeros; this one
// takes the rows as they are (the cores zero-fill keys past Tk and give
// them no weight, and skip query rows past Tq), which equals the padded
// form because pad keys are masked and pad queries are sliced off.
// Rounding points are the TPU kernel's: f32 logits q . k * Dh^-0.5, the
// f32 softmax, the weights rounded to v's dtype before @ v, f32 sums, the
// output rounded once.
//
// The arithmetic is kernel 8's (csrc/attention_qkv.cu) and kernel 9's
// (csrc/attention.cu) on a rectangle: all three run attention_core.cuh::
// attention_rows (bf16: mma.sync Q K^T, a two-pass softmax normalized before
// the bf16 rounding, ldmatrix P V) and attention_f32.cuh::attention_f32_rows
// (f32: plain FMAs, no TF32), which take a query count apart from the key
// count and separate row strides for q (D) and kv (2D).  Grid (query tiles,
// heads, B); each block stages one head's K and V rows once for up to 128
// queries.
//
// Bound on the H100 at the sequence-parallel step's shape (ViT-B/16, two
// sequence ranks: B = 128, Tq = 104, Tk = 208, 12 heads of 64, bf16): q in,
// kv in and out are 20.4 + 81.8 + 20.4 = 122.7 MB, 0.037 ms at 3.35 TB/s,
// against 4 B H Tq Tk Dh = 8.5 GFLOP, 0.009 ms at 989 TFLOP/s: the bytes
// bind.  In f32 (B = 32) the 2.1 GFLOP on the FMA units (67 TFLOP/s) take
// 0.032 ms against 61.3 MB (0.018 ms): the operations bind.  Each block
// reads its head's K and V once per query tile, so with Tq <= 128 the
// gathered kv is read once; the first design inherits kernel 8's limits.
#include "attention_core.cuh"
#include "attention_f32.cuh"

namespace vsd {
namespace {

template <int DH>
__global__ void __launch_bounds__(kAttMaxWarps * 32)
    attention_cp_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                        bf16* __restrict__ out, int tq, int tk, int d, int valid_len,
                        float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + att_keys(tk) * (DH + 8);
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t hoff = static_cast<size_t>(h) * DH;
  const bf16* kb = kv + static_cast<size_t>(b) * tk * 2 * d + hoff;
  bf16* ob = out + static_cast<size_t>(b) * tq * d + hoff;
  attention_rows<DH, false>(q + static_cast<size_t>(b) * tq * d + hoff, d, kb, kb + d, 2 * d,
                            ob, d, tq, tk, valid_len, scale, blockIdx.x * blockDim.x / 2, Ks,
                            Vs);
}

template <int DH>
__global__ void __launch_bounds__(kF32Warps * 32)
    attention_cp_f32_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                            float* __restrict__ out, int tq, int tk, int d, int valid_len,
                            float scale, int tile_rows) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t hoff = static_cast<size_t>(h) * DH;
  const float* kb = kv + static_cast<size_t>(b) * tk * 2 * d + hoff;
  attention_f32_rows<DH>(q + static_cast<size_t>(b) * tq * d + hoff, d, kb, kb + d, 2 * d,
                         out + static_cast<size_t>(b) * tq * d + hoff, d, tq, tk, valid_len,
                         scale, tile_rows);
}

template <int DH>
cudaError_t launch_cp(const void* q, const void* kv, void* out, int dtype, int batch, int tq,
                      int tk, int heads, int valid_len, float scale, cudaStream_t stream) {
  const int d = heads * DH;
  if (dtype == 0) {
    const size_t smem = att_smem_bytes(tk, DH);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(attention_cp_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const int groups = (tq + 15) / 16;  // 16-row query groups, one warp each
    const int tiles = (groups + kAttMaxWarps - 1) / kAttMaxWarps;
    const int warps = (groups + tiles - 1) / tiles;
    attention_cp_kernel<DH><<<dim3(tiles, heads, batch), warps * 32, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kv), static_cast<bf16*>(out), tq,
        tk, d, valid_len, scale);
    return cudaGetLastError();
  }
  const size_t smem = f32_smem_bytes(tk, DH);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_cp_f32_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = f32_tile_rows(tq);
  attention_cp_f32_kernel<DH><<<dim3((tq + rows - 1) / rows, heads, batch), kF32Warps * 32, smem,
                                stream>>>(static_cast<const float*>(q),
                                          static_cast<const float*>(kv),
                                          static_cast<float*>(out), tq, tk, d, valid_len, scale,
                                          rows);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// q [B, Tq, D], kv [B, Tk, 2D] and out [B, Tq, D], all bf16 (dtype 0) or all
// f32 (dtype 1), contiguous and 16-byte aligned.  Needs a head dim that is
// a multiple of 16 up to 128, 0 < valid_len <= Tk and one head's K and V
// within shared memory.  Returns the launch's CUDA error (0 on success).
extern "C" int vsd_attention_cp(const void* q, const void* kv, void* out, int dtype, int batch,
                                int tq, int tk, int d, int num_heads, int valid_len, float scale,
                                void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || tq <= 0 || tk <= 0 || d <= 0 || num_heads <= 0 ||
      num_heads > 65535 || d % num_heads || valid_len <= 0 || valid_len > tk ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / num_heads) {
#define VSD_HEAD_DIM(DH) \
  case DH:               \
    return launch_cp<DH>(q, kv, out, dtype, batch, tq, tk, num_heads, valid_len, scale, s);
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

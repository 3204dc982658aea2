// The attention core of the ViT's module path on Hopper:
//
//   out[b, :, h] = softmax(Q_h K_h^T * scale) V_h
//
// per head h on the fused projection qkv [B, T, 3D] (q | k | v, heads
// contiguous inside each), written as the concatenated head outputs
// [B, T, D], in bf16 or f32.  Key columns at or past valid_len are masked
// at -1e30.  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_qkv_kernel (:119).
//
// bf16: a standalone launch of the port's attention core
// (attention_core.cuh::attention, kernel 1's attention stage): mma.sync
// Q K^T, a two-pass f32 softmax whose weights are normalized before the
// bf16 rounding, ldmatrix P V with f32 sums, each output rounded once.
// The TPU kernel pads T = 197 to 200 rows for its 8-row tiling; this one
// takes T rows as they are (the core zero-fills rows past T and gives
// columns past T no weight), and the results equal the padded form's
// because masked columns add exactly 0.
//
// f32 (the harness's dtype and the JAX package's f32 eval default): plain
// f32 FMAs, not the tensor cores, since TF32 would round q, k and the
// weights to 10 mantissa bits.  Grid (query tiles, heads, B); a block of 8
// warps loads one head's K and V [T][dh + 4] into shared memory (16-byte
// rows, the +4 keeps a quarter-warp's float4 reads on distinct banks),
// and each warp takes 4 query rows at a time:
//   1. each lane scores its keys (lane, lane + 32, ...) against the 4
//      rows, q from shared memory as float4 broadcasts; the logits go to
//      the warp's [T][4] buffer, the row maxima to a warp reduction;
//   2. e = exp(s - m) and l = sum e (warp reductions), then
//      w = e / l in f32 (jax.nn.softmax's arithmetic);
//   3. O = w V, each lane owning columns lane, lane + 32, ... of the 4
//      rows, one float4 broadcast of the 4 rows' weights per key.
// The weights stay f32 (JAX's weights.astype(v.dtype) is a no-op at f32).
//
// Bound on the H100.  bf16 at ViT-B, B = 128, T = 197: 154.9 MB of
// compulsory traffic (qkv in, out) = 0.046 ms at 3.35 TB/s against
// 15.3 GFLOP = 0.015 ms at 989 TFLOP/s: the bytes bind.  f32 at B = 32:
// 3.81 GFLOP = 0.057 ms at 67 TFLOP/s against 77.5 MB = 0.023 ms: the f32
// operations bind.  This first f32 design reads K, V and q from shared
// memory for every FMA (1.25 16-byte loads per 4 FMAs in step 1), so
// shared-memory bandwidth, not the FMA rate, is its limit; register-tiled
// K and V blocks are later work.
#include "attention_core.cuh"
#include "attention_f32.cuh"

// qkv [B, T, 3D] and out [B, T, D], both bf16 (dtype 0) or f32 (dtype 1),
// contiguous and 16-byte aligned.  Needs a head dim that is a multiple of
// 16 up to 128, 0 < valid_len <= T and one head's K and V within shared
// memory.  Returns the launch's CUDA error (0 on success).
extern "C" int vsd_attention_qkv(const void* qkv, void* out, int dtype, int batch, int t, int d,
                                 int num_heads, int valid_len, float scale, void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || t <= 0 || d <= 0 || num_heads <= 0 ||
      num_heads > 65535 || d % num_heads || valid_len <= 0 || valid_len > t)
    return cudaErrorInvalidValue;
  const int dh = d / num_heads;
  if (dh % 16 || dh > 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return attention(static_cast<const bf16*>(qkv), static_cast<bf16*>(out), batch, t, d,
                     num_heads, valid_len, scale, s);
  if (dtype == 1)
    return attention_f32(static_cast<const float*>(qkv), static_cast<float*>(out), batch, t, d,
                         num_heads, valid_len, scale, s);
  return cudaErrorInvalidValue;
}

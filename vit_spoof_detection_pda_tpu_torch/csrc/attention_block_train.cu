// Pre-LN attention sub-layer of the ViT for training, on Hopper:
//
//   out = x + proj(MHA(LN1(x) @ Wqkv + bqkv)) + bproj
//
// over a padded residual stream x [B, Tp, D] bf16 (key columns at or past
// valid_len masked), with the backward's residuals as extra outputs: the
// fused projection qkv [B, Tp, 3D], the concatenated head outputs
// attn [B, Tp, D], the LN's xhat [B, Tp, D] (bf16) and inv = rsqrt(var + eps)
// [B, Tp] (f32).  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/models/fasttrain.py::_attn_block_train_kernel
// (:70).
//
// Bound on the H100: the tensor cores.  At ViT-B, B = 128, Tp = 200 one call
// does the serving kernel's 136.5 GFLOP, >= 0.138 ms at 989 TFLOP/s; its
// compulsory traffic (x in; out, qkv, attn, xhat, inv out; weights) is
// about 280 MB, 0.084 ms at 3.35 TB/s.
//
// Design: the serving kernel's four launches (attention_block.cu: the
// GEMMs on gemm_core.cuh, the attention stage on the routes of
// attention_self.cuh), whose scratch becomes output: the LayerNorm launch
// also writes xhat and inv, the qkv GEMM writes the qkv output, the
// attention stage writes the attn output, and the proj GEMM adds bproj and
// the residual.  Only xn stays scratch.  Rounding points are the serving
// kernel's and the TPU kernel's: xn, xhat, qkv, the softmax weights and
// the head outputs are rounded to bf16, LN, the softmax and every sum are
// f32, out is rounded once.
#include "attention_self.cuh"
#include "gemm_core.cuh"

// x, out, xn_scratch, attn, xhat [B, Tp, D] bf16; qkv [B, Tp, 3D] bf16;
// inv [B, Tp] f32; ln_* [D] f32; w_qkv [D, 3D], w_proj [D, D] bf16;
// b_qkv [3D], b_proj [D] f32.  Takes what vsd_attention_block takes.
// Returns the first CUDA error of the four launches (0 on success).
extern "C" int vsd_attention_block_train(const void* x, const void* ln_scale,
                                         const void* ln_bias, const void* w_qkv,
                                         const void* b_qkv, const void* w_proj,
                                         const void* b_proj, void* xn_scratch, void* qkv,
                                         void* attn, void* xhat, void* inv, void* out,
                                         int batch, int tp, int d, int num_heads,
                                         int valid_len, float eps, float scale, void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || tp <= 0 || tp % 8 || d <= 0 ||
      num_heads <= 0 || num_heads > 65535 || d % num_heads || valid_len < 0 || valid_len > tp)
    return cudaErrorInvalidValue;
  const int dh = d / num_heads;
  if (dh % 16 || dh > 128) return cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = batch * tp;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(xn_scratch);
  bf16* qb = static_cast<bf16*>(qkv);
  bf16* ab = static_cast<bf16*>(attn);

  cudaError_t e = launch_layernorm(xb, static_cast<const float*>(ln_scale),
                                   static_cast<const float*>(ln_bias), xn, rows, d, eps, s,
                                   static_cast<bf16*>(xhat), static_cast<float*>(inv));
  if (e != cudaSuccess) return e;
  e = launch_gemm<kEpiBias>(xn, static_cast<const bf16*>(w_qkv), static_cast<const float*>(b_qkv),
                            nullptr, qb, rows, 3 * d, d, s);
  if (e != cudaSuccess) return e;
  e = attention_self(qb, qb + d, qb + 2 * d, ab, 0, batch, tp, num_heads, dh, 3 * d,
                     static_cast<long long>(tp) * 3 * d, valid_len, scale, s);
  if (e != cudaSuccess) return e;
  return launch_gemm<kEpiBiasResidual>(ab, static_cast<const bf16*>(w_proj),
                                       static_cast<const float*>(b_proj), xb,
                                       static_cast<bf16*>(out), rows, d, d, s);
}

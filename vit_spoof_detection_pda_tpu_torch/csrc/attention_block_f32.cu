// Pre-LN attention sub-layer of the ViT in f32, on Hopper:
//
//   out = x + proj(MHA(LN1(x) @ Wqkv + bqkv)) + bproj
//
// over a padded residual stream x [B, Tp, D] f32 (key columns at or past
// valid_len masked), optionally with the backward's residuals as extra
// outputs: the fused projection qkv [B, Tp, 3D], the concatenated head
// outputs attn [B, Tp, D], the LN's xhat [B, Tp, D] and inv =
// rsqrt(var + eps) [B, Tp].  Replaces the f32 forms of the TPU kernels
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_block_kernel (:412)
// (serving: no residual outputs) and
// vit_spoof_detection_pda_tpu/models/fasttrain.py::_attn_block_train_kernel
// (:70) (training).
//
// Bound on the H100: the f32 FMA rate.  At ViT-B, B = 32, Tp = 200 one call
// does 2*B*Tp*D*4D + 4*B*H*Tp^2*Dh = 34.1 GFLOP, >= 0.51 ms at 67 TFLOP/s;
// its compulsory traffic (x in; out, qkv, attn, xhat, inv out; weights)
// is about 140 MB, 0.042 ms at 3.35 TB/s.
//
// Design: the bf16 kernels' four launches (attention_block_train.cu) with
// f32 parts that never touch the tensor cores:
//   1. the f32 LayerNorm (f32_common.cuh) -> xn (scratch), xhat, inv
//   2. the f32 GEMM xn @ Wqkv + bqkv -> qkv
//   3. kernel 8's f32 attention core (attention_f32.cuh) -> attn
//   4. the f32 GEMM attn @ Wproj + bproj + x -> out
// Every value stays f32 (the TPU kernel's roundings to the compute dtype
// are no-ops at f32); only the order of the f32 sums differs from the
// plain version.
#include "attention_f32.cuh"
#include "f32_common.cuh"

// x, out, xn_scratch, attn [B, Tp, D] f32; qkv [B, Tp, 3D] f32; ln_* [D],
// w_qkv [D, 3D], b_qkv [3D], w_proj [D, D], b_proj [D] f32; xhat [B, Tp, D]
// and inv [B, Tp] f32, or both null (the serving form).  Needs a head dim
// that is a multiple of 16 up to 128, Tp % 8 == 0, 0 <= valid_len <= Tp, D
// a multiple of 4 and one head's K and V within shared memory.  Returns
// the first CUDA error of the four launches (0 on success).
extern "C" int vsd_attention_block_f32(const void* x, const void* ln_scale, const void* ln_bias,
                                       const void* w_qkv, const void* b_qkv, const void* w_proj,
                                       const void* b_proj, void* xn_scratch, void* qkv,
                                       void* attn, void* xhat, void* inv, void* out, int batch,
                                       int tp, int d, int num_heads, int valid_len, float eps,
                                       float scale, void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || tp <= 0 || tp % 8 || d <= 0 || d % 4 ||
      num_heads <= 0 || num_heads > 65535 || d % num_heads || valid_len < 0 || valid_len > tp)
    return cudaErrorInvalidValue;
  const int dh = d / num_heads;
  if (dh % 16 || dh > 128 || f32_smem_bytes(tp, dh) > kMaxSmem) return cudaErrorInvalidValue;
  if ((xhat == nullptr) != (inv == nullptr)) return cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = batch * tp;
  const float* xf = static_cast<const float*>(x);
  float* xn = static_cast<float*>(xn_scratch);
  float* qf = static_cast<float*>(qkv);
  float* af = static_cast<float*>(attn);

  cudaError_t e = launch_layernorm_f32(xf, static_cast<const float*>(ln_scale),
                                       static_cast<const float*>(ln_bias), xn, rows, d, eps, s,
                                       static_cast<float*>(xhat), static_cast<float*>(inv));
  if (e != cudaSuccess) return e;
  e = launch_gemm_f32<kEpiF32Bias>(xn, static_cast<const float*>(w_qkv),
                                   static_cast<const float*>(b_qkv), nullptr, qf, rows, 3 * d, d,
                                   s);
  if (e != cudaSuccess) return e;
  e = attention_f32(qf, af, batch, tp, d, num_heads, valid_len, scale, s);
  if (e != cudaSuccess) return e;
  return launch_gemm_f32<kEpiF32BiasResidual>(af, static_cast<const float*>(w_proj),
                                              static_cast<const float*>(b_proj), xf,
                                              static_cast<float*>(out), rows, d, d, s);
}

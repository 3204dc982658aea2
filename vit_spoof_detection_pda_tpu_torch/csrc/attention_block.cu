// Pre-LN attention sub-layer of the ViT for serving, on Hopper:
//
//   out = x + proj(MHA(LN1(x) @ Wqkv + bqkv)) + bproj
//
// over a padded residual stream x [B, Tp, D] bf16 whose key columns at or
// past valid_len are masked.  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_block_kernel (:412).
//
// Bound on the H100: the tensor cores.  At ViT-B, B = 128, Tp = 200 one call
// does 2*B*Tp*D*4D + 4*B*H*Tp^2*Dh = 136.5 GFLOP of bf16 products, >= 0.138 ms
// at 989 TFLOP/s; its ~83 MB of compulsory traffic (x in, out, weights) takes
// 0.025 ms at 3.35 TB/s and does not bind.
//
// Design: four launches on the caller's stream,
//   1. LayerNorm rows -> xn (bf16 scratch)
//   2. GEMM xn @ Wqkv + bqkv -> qkv (bf16 scratch [B*Tp, 3D]) on the
//      TMA-fed, warp-specialised, persistent wgmma core (gemm_core.cuh)
//   3. attention per (query tile, head, item) on the qkv buffer -> attn
//      (bf16 scratch, reusing the xn buffer), by the routes of kernels 8
//      and 9 (attention_self.cuh): kernel 12's one-pass core where the
//      keys rounded up to 16 are at most 208 (Tp 200 at 224 px: every
//      score in registers, K and V staged once, the weights normalised
//      before their bf16 rounding), else kernel 12's two passes with K and
//      V whole, and past T 800 its 256-key tiles
//   4. GEMM attn @ Wproj + bproj + x -> out on the same core
// All products are bf16 x bf16 with f32 accumulation.  The TPU kernel kept
// qkv and the head outputs in VMEM; here they go through device memory
// (about 4x the compulsory bytes).  Fusing qkv away is later work.
//
// Rounding points follow the TPU kernel: xn, qkv, the softmax weights and
// the concatenated head outputs are rounded to bf16; LN, the logits, the
// softmax and every sum are f32; out is rounded once.
#include "attention_self.cuh"
#include "gemm_core.cuh"

// x, out [B, Tp, D] bf16; ln_* [D] f32; w_qkv [D, 3D] and w_proj [D, D] bf16;
// b_qkv [3D], b_proj [D] f32; scratch [B*Tp, D] and qkv [B*Tp, 3D] bf16.
// Needs a head dim that is a multiple of 16 up to 128, Tp % 8 == 0 and
// 0 <= valid_len <= Tp; any Tp (the attention stage's route by shape,
// attention_self.cuh).  Returns the first CUDA error of the four launches
// (0 on success).
extern "C" int vsd_attention_block(const void* x, const void* ln_scale, const void* ln_bias,
                                   const void* w_qkv, const void* b_qkv, const void* w_proj,
                                   const void* b_proj, void* scratch, void* qkv, void* out,
                                   int batch, int tp, int d, int num_heads, int valid_len,
                                   float eps, float scale, void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || tp <= 0 || tp % 8 || d <= 0 ||
      num_heads <= 0 || num_heads > 65535 || d % num_heads || valid_len < 0 || valid_len > tp)
    return cudaErrorInvalidValue;
  const int dh = d / num_heads;
  if (dh % 16 || dh > 128) return cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = batch * tp;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* sc = static_cast<bf16*>(scratch);
  bf16* qb = static_cast<bf16*>(qkv);

  cudaError_t e = launch_layernorm(xb, static_cast<const float*>(ln_scale),
                                   static_cast<const float*>(ln_bias), sc, rows, d, eps, s);
  if (e != cudaSuccess) return e;
  e = launch_gemm<kEpiBias>(sc, static_cast<const bf16*>(w_qkv), static_cast<const float*>(b_qkv),
                            nullptr, qb, rows, 3 * d, d, s);
  if (e != cudaSuccess) return e;
  e = attention_self(qb, qb + d, qb + 2 * d, sc, 0, batch, tp, num_heads, dh, 3 * d,
                     static_cast<long long>(tp) * 3 * d, valid_len, scale, s);
  if (e != cudaSuccess) return e;
  return launch_gemm<kEpiBiasResidual>(sc, static_cast<const bf16*>(w_proj),
                                       static_cast<const float*>(b_proj), xb,
                                       static_cast<bf16*>(out), rows, d, d, s);
}

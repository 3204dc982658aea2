// MLP sub-layer of the ViT for serving, on Hopper:
//
//   out = x + fc2(gelu_tanh(LN2(x) @ W1 + b1)) + b2
//
// over the flat rows of the residual stream, x [rows, D] bf16.  Replaces the
// TPU kernel vit_spoof_detection_pda_tpu/ops/attention.py::_mlp_block_kernel
// (:532).
//
// Bound on the H100: the tensor cores.  At ViT-B, B = 128, Tp = 200
// (25,600 rows) one call does 4*rows*D*4D = 241.6 GFLOP of bf16 products,
// >= 0.244 ms at 989 TFLOP/s; its ~88 MB of compulsory traffic takes
// 0.026 ms at 3.35 TB/s.
//
// Design: three launches on the caller's stream (vsd_mlp_block_plan below,
// mirrored by ops/attention.py::mlp_block_plan),
//   1. LayerNorm rows -> xn (bf16 scratch): a warp a row, the row held in
//      registers between its mean, variance and normalizing passes, so it
//      is read from device memory once (common.cuh, layernorm_row_reg);
//   2. GEMM xn @ W1 + b1, tanh-GELU in f32 -> h (bf16 scratch [rows, 4D]);
//      the GELU in its sigmoid form x / (1 + 2^t) on the special-function
//      unit (common.cuh, gelu_tanh_fast), which shortens the epilogue
//      during which the tensor cores wait;
//   3. GEMM h @ W2 + b2 + x -> out.
// Both GEMMs run the TMA-fed, warp-specialised, persistent wgmma core of
// gemm_core.cuh (its 128 x 256 tiles, two consumer warpgroups on each).
// The TPU kernel never wrote the [rows, 4D] hidden to HBM (it looped over
// hidden chunks in VMEM); here it goes through device memory (157 MB each
// way at B = 128): fused over hidden chunks, each 64-row block would
// re-read all of W1 and W2 (9.4 MB) from L2, 3.8 GB a call.
//
// Rounding points follow the TPU kernel: xn and the GELU output are rounded
// to bf16; LN, the GELU and every sum are f32; out is rounded once.  Any row
// count works; D and the hidden width must be multiples of 8.
#include "gemm_core.cuh"

// x, out [rows, D] bf16; ln_* [D] f32; w1 [D, hidden], w2 [hidden, D] bf16;
// b1 [hidden], b2 [D] f32; scratch [rows, D] and hidden_buf [rows, hidden]
// bf16.  Returns the first CUDA error of the three launches (0 on success).
extern "C" int vsd_mlp_block(const void* x, const void* ln_scale, const void* ln_bias,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             void* scratch, void* hidden_buf, void* out, int rows, int d,
                             int hidden, float eps, void* stream) {
  using namespace vsd;
  if (rows < 0 || d <= 0 || d % 8 || hidden <= 0 || hidden % 8)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(scratch);
  bf16* hb = static_cast<bf16*>(hidden_buf);

  cudaError_t e = launch_layernorm(xb, static_cast<const float*>(ln_scale),
                                   static_cast<const float*>(ln_bias), xn, rows, d, eps, s);
  if (e != cudaSuccess) return e;
  e = launch_gemm<kEpiBiasGelu>(xn, static_cast<const bf16*>(w1), static_cast<const float*>(b1),
                                nullptr, hb, rows, hidden, d, s);
  if (e != cudaSuccess) return e;
  return launch_gemm<kEpiBiasResidual>(hb, static_cast<const bf16*>(w2),
                                       static_cast<const float*>(b2), xb,
                                       static_cast<bf16*>(out), rows, d, hidden, s);
}

// The block's plan for rows x d x hidden on `sms` SMs (this card's when sms
// <= 0), as len ints: the LayerNorm launch's rows a block, blocks and
// threads, then fc1's and fc2's GEMM plans (gemm_plan: bm, bn, bk, stages,
// tiles_m, tiles_n, tiles, grid, smem, group_m, threads, each).
// ops/attention.py::mlp_block_launch_config reads it; mlp_block_plan there
// mirrors it.  Returns the count written, 0 on bad arguments.
extern "C" int vsd_mlp_block_plan(int rows, int d, int hidden, int sms, int* out, int len) {
  using namespace vsd;
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kGemmMaxDevices) return 0;
    sms = gemm_sm_count(dev);
  }
  if (sms <= 0 || rows <= 0 || d <= 0 || d % 8 || hidden <= 0 || hidden % 8) return 0;
  const GemmPlan f1 = gemm_plan(rows, hidden, d, sms), f2 = gemm_plan(rows, d, hidden, sms);
  const int v[] = {kLnRowsPerBlock, gemm_cdiv(rows, kLnRowsPerBlock), kLnRowsPerBlock * 32,
                   f1.bm, f1.bn, f1.bk, f1.stages, f1.tiles_m, f1.tiles_n, f1.tiles, f1.grid,
                   f1.smem, f1.group_m, f1.threads,
                   f2.bm, f2.bn, f2.bk, f2.stages, f2.tiles_m, f2.tiles_n, f2.tiles, f2.grid,
                   f2.smem, f2.group_m, f2.threads};
  const int count = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count < len ? count : len;
}

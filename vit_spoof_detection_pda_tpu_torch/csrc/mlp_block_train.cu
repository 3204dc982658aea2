// MLP sub-layer of the ViT for training, on Hopper:
//
//   y = x + fc2(gelu(LN2(x) @ W1 + b1)) + b2
//
// over the flat rows of the residual stream, x [rows, D], with the
// stored-hidden backward's residuals as extra outputs: the LN's
// xhat [rows, D] and inv = rsqrt(var + eps) [rows] (f32), and the hidden
// pre-activation h = LN2(x) @ W1 + b1 [rows, 4D] rounded to the compute
// dtype BEFORE the GELU, so the stored h, the activation and the
// backward's gate recompute all see one tensor.  erf or tanh GELU.
// Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/models/fasttrain.py::_mlp_block_train_p_kernel
// (:508), which emulated erf with the A&S rational (Mosaic has no erf).
// Here the bf16 form computes either GELU in its tail form on the
// special-function unit (common.cuh, gelu_erf_tail / gelu_tanh_tail:
// within one bf16 ulp of the exact GELU at every finite bf16 hidden
// value, where 1 + erff would cancel below x ~ -3); the f32 form uses
// CUDA's erff and tanhf.
//
// Bound on the H100: the tensor cores at bf16.  At ViT-B, B = 128, Tp = 197
// (25,216 rows) one call does 4*rows*D*4D = 238 GFLOP, >= 0.241 ms at 989
// TFLOP/s; its compulsory traffic (x in; y, xhat out, h out [rows, 4D],
// inv; weights) is about 244 MB, 0.073 ms at 3.35 TB/s.  f32: the FMA rate,
// 59.5 GFLOP at B = 32 (6,304 rows), >= 0.89 ms at 67 TFLOP/s.
//
// Design: the serving MLP kernel's three launches
// (mlp_block.cu) with the training outputs:
//   1. LayerNorm rows -> xn (scratch), xhat, inv (the training form of the
//      LayerNorm, as kernel 3's)
//   2. GEMM xn @ W1 + b1 -> h (output, rounded), gelu(h) -> a (scratch
//      [rows, 4D])
//   3. GEMM a @ W2 + b2 + x -> y
// bf16 runs the wgmma GEMM core of gemm_core.cuh with its stored-hidden
// epilogue (one pass over the accumulator: H and C of each 64-column box
// staged side by side and stored together);
// f32 the FMA GEMM of f32_common.cuh (no TF32).  The TPU kernel kept the
// activation in VMEM; here it goes through device memory once each way.
//
// Rounding points follow the TPU kernel: xn, xhat, h and the GELU output
// are rounded to the compute dtype; LN, the GELU and every sum are f32; y
// is rounded once.
#include "f32_common.cuh"
#include "gemm_core.cuh"

// dtype 0: x, y, xhat, scratch [rows, D], w1 [D, hidden], w2 [hidden, D],
// h, act [rows, hidden] bf16; dtype 1: all of them f32.  ln_* [D], b1
// [hidden], b2 [D] and inv [rows] f32.  gelu_erf 1: erf GELU, 0: tanh.
// D and hidden multiples of 8.  Returns the first CUDA error of the three
// launches (0 on success).
extern "C" int vsd_mlp_block_train(const void* x, const void* ln_scale, const void* ln_bias,
                                   const void* w1, const void* b1, const void* w2,
                                   const void* b2, void* scratch, void* act, void* h,
                                   void* xhat, void* inv, void* y, int rows, int d, int hidden,
                                   float eps, int gelu_erf_mode, int dtype, void* stream) {
  using namespace vsd;
  if (rows < 0 || d <= 0 || d % 8 || hidden <= 0 || hidden % 8 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lns = static_cast<const float*>(ln_scale);
  const float* lnb = static_cast<const float*>(ln_bias);
  const float* bf1 = static_cast<const float*>(b1);
  const float* bf2 = static_cast<const float*>(b2);
  float* invf = static_cast<float*>(inv);
  cudaError_t e;
  if (dtype == 0) {
    const bf16* xb = static_cast<const bf16*>(x);
    bf16* xn = static_cast<bf16*>(scratch);
    bf16* ab = static_cast<bf16*>(act);
    e = launch_layernorm(xb, lns, lnb, xn, rows, d, eps, s, static_cast<bf16*>(xhat), invf);
    if (e != cudaSuccess) return e;
    if (gelu_erf_mode)
      e = launch_gemm<kEpiBiasHGeluErf>(xn, static_cast<const bf16*>(w1), bf1, nullptr, ab, rows,
                                        hidden, d, s, static_cast<bf16*>(h));
    else
      e = launch_gemm<kEpiBiasHGeluTanh>(xn, static_cast<const bf16*>(w1), bf1, nullptr, ab,
                                         rows, hidden, d, s, static_cast<bf16*>(h));
    if (e != cudaSuccess) return e;
    return launch_gemm<kEpiBiasResidual>(ab, static_cast<const bf16*>(w2), bf2, xb,
                                         static_cast<bf16*>(y), rows, d, hidden, s);
  }
  const float* xf = static_cast<const float*>(x);
  float* xn = static_cast<float*>(scratch);
  float* af = static_cast<float*>(act);
  e = launch_layernorm_f32(xf, lns, lnb, xn, rows, d, eps, s, static_cast<float*>(xhat), invf);
  if (e != cudaSuccess) return e;
  if (gelu_erf_mode)
    e = launch_gemm_f32<kEpiF32BiasHGelu, kGeluErf>(xn, static_cast<const float*>(w1), bf1,
                                                    nullptr, af, rows, hidden, d, s,
                                                    static_cast<float*>(h));
  else
    e = launch_gemm_f32<kEpiF32BiasHGelu, kGeluTanh>(xn, static_cast<const float*>(w1), bf1,
                                                     nullptr, af, rows, hidden, d, s,
                                                     static_cast<float*>(h));
  if (e != cudaSuccess) return e;
  return launch_gemm_f32<kEpiF32BiasResidual>(af, static_cast<const float*>(w2), bf2, xf,
                                              static_cast<float*>(y), rows, d, hidden, s);
}

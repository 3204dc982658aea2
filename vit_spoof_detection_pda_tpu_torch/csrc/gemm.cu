// The GEMM cores alone: C = epilogue(A[M, K] @ W[K, N]) in bf16 on the
// TMA-fed, warp-specialised wgmma core (gemm_core.cuh) or in f32 on the FMA
// GEMM (f32_common.cuh), with any of their epilogues.  Replaces no TPU
// kernel by itself: the block kernels (attention_block*.cu, mlp_block*.cu)
// launch these cores for the products of the TPU kernels they replace
// (vit_spoof_detection_pda_tpu/ops/attention.py::_attn_block_kernel :412,
// _mlp_block_kernel :532; models/fasttrain.py::_attn_block_train_kernel
// :70, _mlp_block_train_p_kernel :508).  This entry exists so that the
// card tests and the timings reach the cores on their own
// (ops/gemm.py::gemm); nothing on a main path calls it.
//
// Bound on the H100: the tensor cores (bf16) or the FMA rate (f32) at the
// blocks' shapes; the bytes only when M, N or K are small.
#include "f32_common.cuh"
#include "gemm_core.cuh"

namespace {

using namespace vsd;

template <int EPI>
cudaError_t gemm_bf16(const void* a, const void* w, const void* bias, const void* r, void* c,
                      void* h, int m, int n, int k, cudaStream_t s) {
  return launch_gemm<EPI>(static_cast<const bf16*>(a), static_cast<const bf16*>(w),
                          static_cast<const float*>(bias), static_cast<const bf16*>(r),
                          static_cast<bf16*>(c), m, n, k, s, static_cast<bf16*>(h));
}

template <int EPI, int GELU = kGeluTanh>
cudaError_t gemm_f32(const void* a, const void* w, const void* bias, const void* r, void* c,
                     void* h, int m, int n, int k, cudaStream_t s) {
  return launch_gemm_f32<EPI, GELU>(static_cast<const float*>(a), static_cast<const float*>(w),
                                    static_cast<const float*>(bias),
                                    static_cast<const float*>(r), static_cast<float*>(c), m, n,
                                    k, s, static_cast<float*>(h));
}

}  // namespace

// a [M, K], w [K, N], c (and h) [M, N], r [M, N] or null, bias [N] f32;
// dtype 0: a, w, r, c, h bf16 (N, K multiples of 8); 1: f32 (multiples of
// 4).  epi: 0 bias, 1 bias + tanh GELU (bf16 only), 2 residual + bias,
// 3 stored hidden + erf GELU, 4 stored hidden + tanh GELU.  Returns the
// launch's CUDA error (0 on success).
extern "C" int vsd_gemm(const void* a, const void* w, const void* bias, const void* r, void* c,
                        void* h, int m, int n, int k, int epi, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 0 || (epi == kEpiBiasResidual) != (r != nullptr) ||
      (epi >= kEpiBiasHGeluErf) != (h != nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (epi) {
      case kEpiBias: return gemm_bf16<kEpiBias>(a, w, bias, r, c, h, m, n, k, s);
      case kEpiBiasGelu: return gemm_bf16<kEpiBiasGelu>(a, w, bias, r, c, h, m, n, k, s);
      case kEpiBiasResidual: return gemm_bf16<kEpiBiasResidual>(a, w, bias, r, c, h, m, n, k, s);
      case kEpiBiasHGeluErf: return gemm_bf16<kEpiBiasHGeluErf>(a, w, bias, r, c, h, m, n, k, s);
      case kEpiBiasHGeluTanh:
        return gemm_bf16<kEpiBiasHGeluTanh>(a, w, bias, r, c, h, m, n, k, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  switch (epi) {
    case kEpiBias: return gemm_f32<kEpiF32Bias>(a, w, bias, r, c, h, m, n, k, s);
    case kEpiBiasResidual: return gemm_f32<kEpiF32BiasResidual>(a, w, bias, r, c, h, m, n, k, s);
    case kEpiBiasHGeluErf:
      return gemm_f32<kEpiF32BiasHGelu, kGeluErf>(a, w, bias, r, c, h, m, n, k, s);
    case kEpiBiasHGeluTanh:
      return gemm_f32<kEpiF32BiasHGelu, kGeluTanh>(a, w, bias, r, c, h, m, n, k, s);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 core's plan for an M x N x K product on `sms` SMs (this card's
// when sms <= 0), as len ints: bm, bn, bk, stages, tiles_m, tiles_n, tiles,
// grid, smem, group_m, threads (ops/gemm.py::gemm_launch_config reads it;
// gemm_plan there mirrors it).  Returns the count written, 0 on error.
extern "C" int vsd_gemm_plan(int m, int n, int k, int sms, int* out, int len) {
  using namespace vsd;
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kGemmMaxDevices) return 0;
    sms = gemm_sm_count(dev);
  }
  if (sms <= 0 || m <= 0 || n <= 0 || k <= 0) return 0;
  const GemmPlan p = gemm_plan(m, n, k, sms);
  const int v[] = {p.bm, p.bn, p.bk, p.stages, p.tiles_m, p.tiles_n,
                   p.tiles, p.grid, p.smem, p.group_m, p.threads};
  const int count = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count < len ? count : len;
}

#ifdef VSD_GEMM_STAMPS
// The unit stamps of the last launches (gemm_core.cuh, VSD_GEMM_STAMPS):
// with out null, writes {blocks, tiles, per} to layout and returns 3;
// else copies min(n, all) stamps into the host array out and returns the
// count copied (-1 on a CUDA error).
extern "C" int vsd_gemm_stamps(unsigned long long* out, int n, int* layout) {
  using namespace vsd;
  const int all = kStampBlocks * 2 * kStampPer;
  if (!out) {
    layout[0] = kStampBlocks;
    layout[1] = kStampTiles;
    layout[2] = kStampPer;
    return 3;
  }
  const int count = n < all ? n : all;
  if (cudaDeviceSynchronize() != cudaSuccess ||
      cudaMemcpyFromSymbol(out, g_gemm_stamps, count * sizeof(unsigned long long)) != cudaSuccess)
    return -1;
  return count;
}
#endif

// Fast non-local-means denoise on Hopper.  For each image and pixel, over
// the (2r + 1)^2 offsets (dy, dx) of the search window:
//
//   shifted = img[clamp(y + dy), clamp(x + dx)]                (edge clamp)
//   diff2   = sum over channels of (img - shifted)^2
//   d2      = (sum of diff2 over the (2p + 1)^2 patch, edge-clamped) / (patch_n * C)
//   w       = exp(-max(d2 - 2 sigma^2, 0) / h^2)
//   acc    += w * shifted,  wsum += w
//
// and out = acc / max(wsum, 1e-12).  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/nlm_pallas.py::_nlm_kernel (:52, wrapper
// nlm_denoise_pallas :97); the algorithm is ops/nlm.py's XLA form.  The TPU
// kernel expressed every shift and the patch box filter as one-hot and
// banded matmuls (Mosaic could not slice at pixel granularity nor run
// cumsum) and swept the offsets as a grid axis; here the shifts are plain
// shared-memory reads.
//
// Bound on the H100: operations (f32, outside the tensor cores).  Per
// pixel and offset about 3C + (C - 1) for diff2, (2p + 1)^2 - 1 adds for
// the box, 5 for the weight (the exp counted as one) and 2C + 1 for the
// sums: ~30 at C = 3, p = 1, so 121 offsets x 30 = 3,630 a pixel; at
// B = 8 x 224 x 224 that is 1.46 GFLOP, >= 0.022 ms at 67 TFLOP/s, while
// the bytes (image in, out, f32) take 0.003 ms.
// Design: a block of 16 x 16 threads owns a 16 x 16 output tile; it stages
// the image tile with a halo of r + p (edge-clamped) in shared memory once,
// then per offset writes diff2 over the tile plus a halo of p (each halo
// entry holds diff2 at the edge-clamped position, which is the patch
// window's edge clamp) and each thread sums its patch from there.  All
// arithmetic is f32 with explicit roundings (__fmul_rn, __fadd_rn,
// __fdiv_rn) in the order of ops/nlm.py::nlm_denoise_plain, so the two
// agree to the exp's last bit.  Any H x W; C <= 4.
#include "common.cuh"

namespace vsd {
namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    nlm_kernel(const float* __restrict__ img, float* __restrict__ out, int h, int w, int r,
               int p, float two_sigma2, float inv_h2, float norm) {
  extern __shared__ float smem[];
  const int halo = r + p;
  const int sw = kTile + 2 * halo;  // staged image tile, edge
  const int dw = kTile + 2 * p;     // diff2 tile, edge
  float* src = smem;                // [sw][sw][C]
  float* d2s = smem + sw * sw * C;  // [dw][dw]
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const float* im = img + static_cast<long long>(blockIdx.z) * h * w * C;
  const int tid = threadIdx.x;

  for (int i = tid; i < sw * sw; i += kThreads) {
    const int yy = clampi(y0 - halo + i / sw, 0, h - 1);
    const int xx = clampi(x0 - halo + i % sw, 0, w - 1);
    const float* q = im + (static_cast<long long>(yy) * w + xx) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) src[i * C + ch] = q[ch];
  }
  __syncthreads();

  // shared-memory offset of the in-image pixel (ay, ax)
  const int sy0 = y0 - halo, sx0 = x0 - halo;
  const int ty = tid / kTile, tx = tid % kTile;
  const int y = y0 + ty, x = x0 + tx;
  const bool inside = y < h && x < w;
  const int cy = clampi(y, 0, h - 1), cx = clampi(x, 0, w - 1);
  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.f;
  float wsum = 0.f;

  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx) {
      for (int i = tid; i < dw * dw; i += kThreads) {
        const int qy = clampi(y0 - p + i / dw, 0, h - 1);
        const int qx = clampi(x0 - p + i % dw, 0, w - 1);
        const int ssy = clampi(qy + dy, 0, h - 1), ssx = clampi(qx + dx, 0, w - 1);
        const float* a = src + ((qy - sy0) * sw + (qx - sx0)) * C;
        const float* s = src + ((ssy - sy0) * sw + (ssx - sx0)) * C;
        float v = 0.f;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          const float dd = __fsub_rn(a[ch], s[ch]);
          v = __fadd_rn(v, __fmul_rn(dd, dd));
        }
        d2s[i] = v;
      }
      __syncthreads();
      if (inside) {
        float box = 0.f;
        for (int i = 0; i <= 2 * p; ++i)
          for (int j = 0; j <= 2 * p; ++j) box = __fadd_rn(box, d2s[(ty + i) * dw + tx + j]);
        const float d2 = __fdiv_rn(box, norm);
        const float m = fmaxf(__fsub_rn(d2, two_sigma2), 0.f);
        const float wt = expf(__fmul_rn(-m, inv_h2));
        const float* s = src + ((clampi(cy + dy, 0, h - 1) - sy0) * sw +
                                (clampi(cx + dx, 0, w - 1) - sx0)) * C;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[ch] = __fadd_rn(acc[ch], __fmul_rn(wt, s[ch]));
        wsum = __fadd_rn(wsum, wt);
      }
      __syncthreads();
    }
  }
  if (inside) {
    float* o = out + (static_cast<long long>(blockIdx.z) * h * w + static_cast<long long>(y) * w +
                      x) * C;
    const float den = fmaxf(wsum, 1e-12f);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) o[ch] = __fdiv_rn(acc[ch], den);
  }
}

template <int C>
cudaError_t launch(const float* img, float* out, int b, int h, int w, int r, int p,
                   float two_sigma2, float inv_h2, float norm, cudaStream_t s) {
  const int sw = kTile + 2 * (r + p), dw = kTile + 2 * p;
  const size_t smem = sizeof(float) * (static_cast<size_t>(sw) * sw * C + dw * dw);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nlm_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
  nlm_kernel<C><<<grid, kThreads, smem, s>>>(img, out, h, w, r, p, two_sigma2, inv_h2, norm);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// img, out [b, h, w, c] f32 contiguous, c in 1..4; r the search radius, p
// the patch radius; two_sigma2 = 2 sigma^2, inv_h2 = 1 / h^2, norm =
// (2p + 1)^2 * c.  Returns the launch's CUDA error (0 on success).
extern "C" int vsd_nlm(const void* img, void* out, int b, int h, int w, int c, int r, int p,
                       float two_sigma2, float inv_h2, float norm, void* stream) {
  using namespace vsd;
  if (b < 0 || b > 65535 || h <= 0 || w <= 0 || r < 0 || p < 0) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(img);
  float* o = static_cast<float*>(out);
  switch (c) {
    case 1: return launch<1>(x, o, b, h, w, r, p, two_sigma2, inv_h2, norm, s);
    case 2: return launch<2>(x, o, b, h, w, r, p, two_sigma2, inv_h2, norm, s);
    case 3: return launch<3>(x, o, b, h, w, r, p, two_sigma2, inv_h2, norm, s);
    case 4: return launch<4>(x, o, b, h, w, r, p, two_sigma2, inv_h2, norm, s);
    default: return cudaErrorInvalidValue;
  }
}

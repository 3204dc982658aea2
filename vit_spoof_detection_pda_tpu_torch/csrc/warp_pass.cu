// One scanline pass of the gather-free warp tower on Hopper:
//
//   rows (along x):  out[b, y, x, :] = img[b, y, x + f[b, y, x], :]
//   cols (along y):  out[b, y, x, :] = img[b, y + f[b, y, x], x, :]
//
// with a 2-tap tent (linear) interpolation and zero fill where the source
// coordinate pos + f lies outside [0, n - 1].  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/warp_pallas.py::_pass_kernel (:58),
// wrappers resample_rows_field_pallas (:71) / resample_cols_field_pallas
// (:113).
//
// What the TPU kernel computes: sum over k in [-kmax, kmax] of
// max(0, 1 - |f - k|) * roll(img, -k)[pos], in f32, the output cast to the
// image dtype; out-of-frame pixels carry the sentinel f = kmax + 4, so no
// tent fires and the output is 0.  Only k0 = floor(f) and k0 + 1 can have a
// nonzero tent, so this kernel reads those two taps (a tap outside [-kmax,
// kmax] has no term, as in the TPU sum) and adds them in the same order
// with the same f32 roundings (__fmul_rn / __fadd_rn keep nvcc from
// contracting to an FMA), so it matches ops/warp.py::warp_pass_plain bit
// for bit.  The TPU's roll wraps within the row; a wrapped tap carries
// weight 0 in exact arithmetic (at most ~1e-7 after the f32 rounding of
// pos + f), and the tap index is wrapped the same way, so no read leaves
// the row.  The TPU transposed the image for the column pass (Mosaic's
// sublane rotates were slow or wrong); here the same kernel reads along y
// with a stride.
//
// Bound on the H100: bytes.  Image in, field in, image out; at B = 128,
// 224 x 224 x 3 bf16 with a full f32 field that is 38.5 + 25.7 + 38.5 MB,
// >= 0.031 ms at 3.35 TB/s (the rotation passes read a broadcast field of
// B x 224 floats, which the strides below pass without materializing).
// Design: one thread per output pixel (all C <= 4 channels), neighbouring
// threads on neighbouring x, so both the taps and the stores coalesce.
#include "common.cuh"

namespace vsd {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 4;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    warp_pass_kernel(const T* __restrict__ img, const float* __restrict__ field,
                     T* __restrict__ out, int h, int w, int c, long long npix, long long fsb,
                     long long fsy, long long fsx, int kmax, int along_y) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= npix) return;
  const int x = static_cast<int>(i % w);
  const long long t = i / w;
  const int y = static_cast<int>(t % h);
  const long long b = t / h;
  const float f = field[b * fsb + y * fsy + x * fsx];
  const int n = along_y ? h : w;
  const int pos = along_y ? y : x;
  // the line the pass reads: row y of image b, or column x
  const long long row = static_cast<long long>(w) * c;
  const T* line = img + b * h * row + (along_y ? static_cast<long long>(x) * c : y * row);
  const long long step = along_y ? row : c;

  float acc[kMaxC];
#pragma unroll
  for (int ch = 0; ch < kMaxC; ++ch) acc[ch] = 0.f;
  const float src = __fadd_rn(static_cast<float>(pos), f);
  if (src >= 0.f && src <= static_cast<float>(n - 1)) {
    const float k0 = floorf(f);
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const float k = k0 + static_cast<float>(d);
      if (k < static_cast<float>(-kmax) || k > static_cast<float>(kmax)) continue;
      const float wt = fmaxf(0.f, 1.f - fabsf(f - k));
      int idx = (pos + static_cast<int>(k)) % n;
      if (idx < 0) idx += n;
      const T* p = line + idx * step;
#pragma unroll
      for (int ch = 0; ch < kMaxC; ++ch)
        if (ch < c) acc[ch] = __fadd_rn(acc[ch], __fmul_rn(wt, load_f(p + ch)));
    }
  }
  T* o = out + i * c;
#pragma unroll
  for (int ch = 0; ch < kMaxC; ++ch)
    if (ch < c) store_f(o + ch, acc[ch]);
}

template <typename T>
cudaError_t launch(const void* img, const float* field, void* out, int b, int h, int w, int c,
                   long long fsb, long long fsy, long long fsx, int kmax, int along_y,
                   cudaStream_t s) {
  const long long npix = static_cast<long long>(b) * h * w;
  const long long blocks = (npix + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  warp_pass_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(img), field, static_cast<T*>(out), h, w, c, npix, fsb, fsy, fsx,
      kmax, along_y);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// img, out [b, h, w, c] contiguous, f32 (is_bf16 = 0) or bf16 (1); field f32
// read at field[bi * fsb + y * fsy + x * fsx] (element strides; 0 for a
// broadcast axis); along_y = 0: the pass runs along x, 1: along y.  Returns
// the launch's CUDA error (0 on success).
extern "C" int vsd_warp_pass(const void* img, const void* field, void* out, int b, int h, int w,
                             int c, long long fsb, long long fsy, long long fsx, int kmax,
                             int along_y, int is_bf16, void* stream) {
  using namespace vsd;
  if (b < 0 || h <= 0 || w <= 0 || c <= 0 || c > kMaxC || kmax < 0) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(field);
  return is_bf16 ? launch<bf16>(img, f, out, b, h, w, c, fsb, fsy, fsx, kmax, along_y, s)
                 : launch<float>(img, f, out, b, h, w, c, fsb, fsy, fsx, kmax, along_y, s);
}

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
// Bound on the H100: operations (f32, outside the tensor cores, none of
// them fused: every step is an explicit __fadd_rn / __fmul_rn rounding, so
// the rate is 33.5 T/s, half the FMA-counted 67 TFLOP/s).  Per pixel and
// offset 3C + (C - 1) for diff2, (2p + 1)^2 - 1 adds for the box, 5 for
// the weight (the exp counted as one) and 2C + 1 for the sums: 28 at C = 3,
// p = 1, so 121 offsets x 28 = 3,388 a pixel; at the eval batch B = 64 x
// 224 x 224 that is 10.9 G operations, >= 0.325 ms, while the bytes (image
// in, out, f32: 77 MB) take 0.023 ms.
//
// Design (the register route, p <= kNlmMaxRegP; nlm_plan below, mirrored
// by ops/nlm.py::nlm_plan): a block of 4 warps owns an output tile of
// (32 - 2p) columns x 32 rows.  It stages the tile's source pixels with a
// halo of r (+ p) once, edge-clamped, in shared memory behind one barrier;
// nothing writes shared memory after it.  Lane l of a warp computes diff2
// for column x0 - p + l and each warp owns 8 output rows, so a thread keeps
// its column's 8 + 2p centre pixels in registers across all offsets.  Per
// offset it reads the 8 + 2p shifted pixels from shared memory, forms their
// diff2 in registers, takes its neighbours' columns by warp shuffles (lanes
// p .. 31 - p produce outputs), sums each patch from registers in the plain
// version's order (rows from the top, each row from the left), and updates
// its 8 pixels' sums: no shared-memory write and no barrier inside the
// offset loop.  Each thread's clamped rows and column are computed once,
// before the loop (the clamped halo rows and columns hold the diff2 of the
// clamped pixel, which is the patch window's edge clamp), so the loop has
// no clamp; blocks whose staged tile lies inside the image (nlm_plan's
// interior range) also stage it without one.  The division by the norm is
// a multiply and one FMA correction where that equals __fdiv_rn at every
// f32 input (nlm_div), else __fdiv_rn.  128 registers a thread, 4 blocks
// an SM.  All arithmetic is f32 with explicit roundings (__fmul_rn,
// __fadd_rn, __fdiv_rn's result) in the order of
// ops/nlm.py::nlm_denoise_plain, so the two agree to the exp's last bit.
// Past kNlmMaxRegP (the staged route) a block of 16 x 16 threads keeps the
// first design: per offset it writes diff2 over its tile plus a halo of p
// in shared memory and each thread sums its patch from there.  Any H x W;
// C <= 4.
#include "common.cuh"

namespace vsd {
namespace {

constexpr int kNlmLanes = 32;                 // columns a warp computes diff2 for
constexpr int kNlmRows = 8;                   // output rows a thread owns
constexpr int kNlmWarps = 4;                  // warps a block, stacked in rows
constexpr int kNlmThreads = kNlmLanes * kNlmWarps;
constexpr int kNlmTileH = kNlmRows * kNlmWarps;
constexpr int kNlmMaxRegP = 2;                // patch radii of the register route
constexpr int kNlmStagedTile = 16;            // the staged route's square tile
constexpr int kNlmStagedThreads = kNlmStagedTile * kNlmStagedTile;

enum { kNlmRegister = 0, kNlmStaged = 1 };

__host__ __device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__host__ __device__ constexpr int nlm_cdiv(int a, int b) { return (a + b - 1) / b; }

// x / norm for the register route's norms, (2p + 1)^2 C: x times the
// correctly rounded reciprocal, then one FMA correction (Markstein) with
// the remainder's sign flipped into the FMA (so that -0 / norm stays -0),
// with rcp = __frcp_rn(norm); where the remainder is NaN (x infinite or
// NaN) the product stands.  tests/test_torch_kernels_cuda.py holds it bit
// for bit to __fdiv_rn(x, norm) at every one of the 2^32 f32 inputs (NaN
// to NaN) for each norm that nlm_fast_div admits (vsd_nlm_div_check): the
// odd norms and the powers of two.  An even norm with an odd factor (C 2
// or 4 with p >= 1) is not admitted: near the subnormal range its ties
// (x / 18 = k + 1/2 ulp) round the other way in the correction.
__device__ __forceinline__ float nlm_div(float x, float norm, float rcp) {
  const float q = __fmul_rn(x, rcp);
  const float t = __fmaf_rn(q, norm, -x);  // -(x - q norm), exact
  return t == t ? __fmaf_rn(-t, rcp, q) : q;
}

__host__ __device__ constexpr bool nlm_fast_div(int c, int p) {
  return c == 1 || c == 3 || p == 0;
}

// Floor of a / b for b > 0 and any a.
__host__ __device__ __forceinline__ int nlm_floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The launcher's choice for an h x w x c image, search radius r, patch
// radius p: the route, the output tile, the grid (per image), the block's
// threads and shared memory, the block indices whose staged tile lies
// inside the image ([ix0, ix1) x [iy0, iy1); the staged route has none),
// and whether the patch sums are divided by nlm_div (1) or __fdiv_rn (0).
struct NlmPlan {
  int route, tile_w, tile_h, grid_x, grid_y, threads, smem, ix0, ix1, iy0, iy1, fast_div;
};

inline NlmPlan nlm_plan(int h, int w, int c, int r, int p) {
  NlmPlan q{};
  if (p <= kNlmMaxRegP) {
    q.route = kNlmRegister;
    q.tile_w = kNlmLanes - 2 * p;
    q.tile_h = kNlmTileH;
    q.threads = kNlmThreads;
    const long long sw = kNlmLanes + 2LL * r, sh = kNlmTileH + 2LL * (r + p);
    q.smem = static_cast<int>(
        sw * sh * c * 4 > static_cast<long long>(kMaxSmem) ? kMaxSmem + 1 : sw * sh * c * 4);
    q.grid_x = nlm_cdiv(w, q.tile_w);
    q.grid_y = nlm_cdiv(h, q.tile_h);
    // block bx stages columns bx * tile_w - p - r .. + sw - 1: inside
    // [0, w) for bx * tile_w >= p + r and bx * tile_w + 32 - p + r <= w
    q.ix0 = nlm_cdiv(p + r, q.tile_w);
    q.ix1 = nlm_floordiv(w - kNlmLanes + p - r, q.tile_w) + 1;
    q.iy0 = nlm_cdiv(p + r, q.tile_h);
    q.iy1 = nlm_floordiv(h - kNlmTileH - p - r, q.tile_h) + 1;
    q.ix1 = clampi(q.ix1, 0, q.grid_x);
    q.iy1 = clampi(q.iy1, 0, q.grid_y);
    if (q.ix1 < q.ix0) q.ix1 = q.ix0 = 0;
    if (q.iy1 < q.iy0) q.iy1 = q.iy0 = 0;
    if (q.ix0 > q.grid_x) q.ix0 = q.ix1 = 0;
    if (q.iy0 > q.grid_y) q.iy0 = q.iy1 = 0;
    q.fast_div = nlm_fast_div(c, p);
  } else {
    q.route = kNlmStaged;
    q.tile_w = q.tile_h = kNlmStagedTile;
    q.threads = kNlmStagedThreads;
    const long long sw = kNlmStagedTile + 2LL * (r + p), dw = kNlmStagedTile + 2LL * p;
    const long long bytes = 4 * (sw * sw * c + dw * dw);
    q.smem = static_cast<int>(bytes > static_cast<long long>(kMaxSmem) ? kMaxSmem + 1 : bytes);
    q.grid_x = nlm_cdiv(w, kNlmStagedTile);
    q.grid_y = nlm_cdiv(h, kNlmStagedTile);
    q.ix0 = q.ix1 = q.iy0 = q.iy1 = 0;
  }
  return q;
}

// The register route: a block of kNlmWarps warps on a (32 - 2P) x 32 tile.
template <int C, int P>
__global__ void __launch_bounds__(kNlmThreads, 4)
    nlm_reg_kernel(const float* __restrict__ img, float* __restrict__ out, int h, int w, int r,
                   float two_sigma2, float inv_h2, int ix0, int ix1, int iy0, int iy1) {
  extern __shared__ float smem[];
  constexpr int kTileW = kNlmLanes - 2 * P;
  constexpr int kRows = kNlmRows + 2 * P;  // rows of diff2 a thread forms
  const int sw = kNlmLanes + 2 * r;        // staged columns from sx0
  const int sh = kNlmTileH + 2 * (r + P);  // staged rows from sy0
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kNlmTileH;
  const int sx0 = x0 - P - r, sy0 = y0 - P - r;
  const float* im = img + static_cast<long long>(blockIdx.z) * h * w * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // stage [sh][sw][C] once: a warp a row, lanes along it
  const bool interior = static_cast<int>(blockIdx.x) >= ix0 &&
                        static_cast<int>(blockIdx.x) < ix1 &&
                        static_cast<int>(blockIdx.y) >= iy0 && static_cast<int>(blockIdx.y) < iy1;
  const int row_len = sw * C;
  if (interior) {
    for (int yy = warp; yy < sh; yy += kNlmWarps) {
      const float* g = im + (static_cast<long long>(sy0 + yy) * w + sx0) * C;
      float* s = smem + yy * row_len;
      for (int k = lane; k < row_len; k += kNlmLanes) s[k] = g[k];
    }
  } else {
    for (int yy = warp; yy < sh; yy += kNlmWarps) {
      const float* g = im + static_cast<long long>(clampi(sy0 + yy, 0, h - 1)) * w * C;
      float* s = smem + yy * row_len;
      for (int k = lane; k < row_len; k += kNlmLanes) {
        const int xx = k / C, ch = k - xx * C;
        s[k] = g[clampi(sx0 + xx, 0, w - 1) * C + ch];
      }
    }
  }
  __syncthreads();

  // this lane's column and the thread's rows, clamped once: row i is
  // ys - P + i; smem offsets of their centre pixels
  const int xl = x0 - P + lane;
  const int qx = clampi(xl, 0, w - 1);
  const int ys = y0 + warp * kNlmRows;
  int base[kRows];
  float ctr[kRows][C];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qy = clampi(ys - P + i, 0, h - 1);
    base[i] = ((qy - sy0) * sw + (qx - sx0)) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) ctr[i][ch] = smem[base[i] + ch];
  }
  constexpr float kNorm = static_cast<float>((2 * P + 1) * (2 * P + 1) * C);
  const float rcp = __frcp_rn(kNorm);
  float acc[kNlmRows][C], wsum[kNlmRows];
#pragma unroll
  for (int o = 0; o < kNlmRows; ++o) {
    wsum[o] = 0.f;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[o][ch] = 0.f;
  }

  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx) {
      const int off = (dy * sw + dx) * C;
      float d2[kRows], sv[kNlmRows][C];
      // every diff2 term is a square (+0 or more, or NaN), so each sum may
      // start at its first term: 0 + t == t, as the plain version's sums
      // that start at 0 have it
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float v = 0.f;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          const float s = smem[base[i] + off + ch];
          const float dd = __fsub_rn(ctr[i][ch], s);
          v = ch == 0 ? __fmul_rn(dd, dd) : __fadd_rn(v, __fmul_rn(dd, dd));
          if (i >= P && i < P + kNlmRows) sv[i - P][ch] = s;
        }
        d2[i] = v;
      }
      // nb[i][j]: diff2 of row i at column offset j - P (the neighbours'
      // lanes; lanes < P and > 31 - P read wrapped values and store nothing)
      float nb[kRows][2 * P + 1];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j <= 2 * P; ++j)
          nb[i][j] = j == P ? d2[i] : __shfl_sync(0xffffffffu, d2[i], lane + j - P);
      }
#pragma unroll
      for (int o = 0; o < kNlmRows; ++o) {
        float box = nb[o][0];
#pragma unroll
        for (int a = 0; a <= 2 * P; ++a)
#pragma unroll
          for (int b = 0; b <= 2 * P; ++b)
            if (a || b) box = __fadd_rn(box, nb[o + a][b]);
        const float dd2 = nlm_fast_div(C, P) ? nlm_div(box, kNorm, rcp) : __fdiv_rn(box, kNorm);
        const float m = fmaxf(__fsub_rn(dd2, two_sigma2), 0.f);
        const float wt = expf(__fmul_rn(-m, inv_h2));
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[o][ch] = __fadd_rn(acc[o][ch], __fmul_rn(wt, sv[o][ch]));
        wsum[o] = __fadd_rn(wsum[o], wt);
      }
    }
  }

  if (lane < P || lane >= P + kTileW || xl >= w) return;
#pragma unroll
  for (int o = 0; o < kNlmRows; ++o) {
    const int y = ys + o;
    if (y < h) {
      float* q = out + ((static_cast<long long>(blockIdx.z) * h + y) * w + xl) * C;
      const float den = fmaxf(wsum[o], 1e-12f);
#pragma unroll
      for (int ch = 0; ch < C; ++ch) q[ch] = __fdiv_rn(acc[o][ch], den);
    }
  }
}

// The staged route (patch radii past kNlmMaxRegP): a 16 x 16 block on a
// 16 x 16 tile, diff2 of each offset written to shared memory.
template <int C>
__global__ void __launch_bounds__(kNlmStagedThreads)
    nlm_staged_kernel(const float* __restrict__ img, float* __restrict__ out, int h, int w, int r,
                      int p, float two_sigma2, float inv_h2, float norm) {
  extern __shared__ float smem[];
  const int halo = r + p;
  const int sw = kNlmStagedTile + 2 * halo;  // staged image tile, edge
  const int dw = kNlmStagedTile + 2 * p;     // diff2 tile, edge
  float* src = smem;                         // [sw][sw][C]
  float* d2s = smem + sw * sw * C;           // [dw][dw]
  const int y0 = blockIdx.y * kNlmStagedTile, x0 = blockIdx.x * kNlmStagedTile;
  const float* im = img + static_cast<long long>(blockIdx.z) * h * w * C;
  const int tid = threadIdx.x;

  for (int i = tid; i < sw * sw; i += kNlmStagedThreads) {
    const int yy = clampi(y0 - halo + i / sw, 0, h - 1);
    const int xx = clampi(x0 - halo + i % sw, 0, w - 1);
    const float* q = im + (static_cast<long long>(yy) * w + xx) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) src[i * C + ch] = q[ch];
  }
  __syncthreads();

  // shared-memory offset of the in-image pixel (ay, ax)
  const int sy0 = y0 - halo, sx0 = x0 - halo;
  const int ty = tid / kNlmStagedTile, tx = tid % kNlmStagedTile;
  const int y = y0 + ty, x = x0 + tx;
  const bool inside = y < h && x < w;
  const int cy = clampi(y, 0, h - 1), cx = clampi(x, 0, w - 1);
  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.f;
  float wsum = 0.f;

  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx) {
      for (int i = tid; i < dw * dw; i += kNlmStagedThreads) {
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

template <typename Kernel>
cudaError_t set_smem(Kernel k, int smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

template <int C, int P>
cudaError_t launch_reg(const NlmPlan& q, const float* img, float* out, int b, int h, int w, int r,
                       float two_sigma2, float inv_h2, cudaStream_t s) {
  const cudaError_t e = set_smem(nlm_reg_kernel<C, P>, q.smem);
  if (e != cudaSuccess) return e;
  nlm_reg_kernel<C, P><<<dim3(q.grid_x, q.grid_y, b), q.threads, q.smem, s>>>(
      img, out, h, w, r, two_sigma2, inv_h2, q.ix0, q.ix1, q.iy0, q.iy1);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const float* img, float* out, int b, int h, int w, int r, int p,
                   float two_sigma2, float inv_h2, float norm, cudaStream_t s) {
  const NlmPlan q = nlm_plan(h, w, C, r, p);
  if (q.smem > static_cast<int>(kMaxSmem)) return cudaErrorInvalidValue;
  // the register route divides by its own (2p + 1)^2 C
  if (q.route == kNlmRegister && norm != static_cast<float>((2 * p + 1) * (2 * p + 1) * C))
    return cudaErrorInvalidValue;
  if (q.grid_y > 65535) return cudaErrorInvalidValue;
  switch (q.route == kNlmRegister ? p : -1) {
    case 0: return launch_reg<C, 0>(q, img, out, b, h, w, r, two_sigma2, inv_h2, s);
    case 1: return launch_reg<C, 1>(q, img, out, b, h, w, r, two_sigma2, inv_h2, s);
    case 2: return launch_reg<C, 2>(q, img, out, b, h, w, r, two_sigma2, inv_h2, s);
    default: break;
  }
  const cudaError_t e = set_smem(nlm_staged_kernel<C>, q.smem);
  if (e != cudaSuccess) return e;
  nlm_staged_kernel<C><<<dim3(q.grid_x, q.grid_y, b), q.threads, q.smem, s>>>(
      img, out, h, w, r, p, two_sigma2, inv_h2, norm);
  return cudaGetLastError();
}

// Every f32 bit pattern x: out[0] counts those where nlm_div(x, norm) and
// __fdiv_rn(x, norm) differ (two NaNs agree), out[1] holds the least such
// pattern (2^32 where none).
__global__ void nlm_div_check_kernel(float norm, unsigned long long* out) {
  const float rcp = __frcp_rn(norm);
  unsigned long long bad = 0, first = 1ull << 32;
  const unsigned long long step = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
                              threadIdx.x;
       i < (1ull << 32); i += step) {
    const float x = __uint_as_float(static_cast<unsigned>(i));
    const float a = __fdiv_rn(x, norm), b = nlm_div(x, norm, rcp);
    if (__float_as_uint(a) != __float_as_uint(b) && !(a != a && b != b)) {
      ++bad;
      if (i < first) first = i;
    }
  }
  if (bad) {
    atomicAdd(out, bad);
    atomicMin(out + 1, first);
  }
}

}  // namespace
}  // namespace vsd

// The exhaustive check of nlm_div against __fdiv_rn at one norm (above):
// out [2] u64, set here.  Returns the launch's CUDA error.
extern "C" int vsd_nlm_div_check(float norm, void* out, void* stream) {
  using namespace vsd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long init[2] = {0, 1ull << 32};
  cudaError_t e = cudaMemcpyAsync(out, init, sizeof(init), cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return e;
  nlm_div_check_kernel<<<4096, 256, 0, s>>>(norm, static_cast<unsigned long long*>(out));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return cudaStreamSynchronize(s);
}

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

// The launcher's plan for an h x w x c image (nlm_plan above) as 12 ints:
// route (0 register, 1 staged), tile_w, tile_h, grid_x, grid_y, threads,
// smem (past kMaxSmem: kMaxSmem + 1), ix0, ix1, iy0, iy1, fast_div
// (ops/nlm.py::nlm_c_plan reads it; nlm_plan there mirrors it).  Returns
// the count written, 0 on bad arguments.
extern "C" int vsd_nlm_plan(int h, int w, int c, int r, int p, int* out, int len) {
  using namespace vsd;
  if (h <= 0 || w <= 0 || c < 1 || c > 4 || r < 0 || p < 0) return 0;
  const NlmPlan q = nlm_plan(h, w, c, r, p);
  const int v[] = {q.route, q.tile_w, q.tile_h, q.grid_x, q.grid_y, q.threads,
                   q.smem,  q.ix0,    q.ix1,    q.iy0,    q.iy1,    q.fast_div};
  const int count = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count < len ? count : len;
}

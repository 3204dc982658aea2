// LayerNorm + residual backward on Hopper: for y = x + f(LN(x)), given the
// stored xhat and inv = rsqrt(var + eps) (f32) of each row, the cotangent
// dxn of the LN's affine output and g of y,
//
//   dxh = dxn * scale
//   dx  = g + inv * (dxh - mean(dxh) - xhat * mean(dxh * xhat))
//   dscale = sum over rows of dxn * xhat,  dbias = sum over rows of dxn
//
// Replaces the TPU kernel vit_spoof_detection_pda_tpu/ops/ln_bwd.py::
// _ln_res_bwd_kernel (:45).
//
// Bound on the H100: bytes.  At ViT-B, B = 128, Tp = 200 (25,600 rows of
// 768) it reads xhat, dxn, g (bf16) and inv and writes dx: about 157 MB,
// >= 0.047 ms at 3.35 TB/s; its ~10 operations per element are nothing.
// The f32 form (xhat, g, dx and dxn f32; the f32 training path) moves
// twice the bytes: at B = 32, 79 MB, >= 0.024 ms.
//
// Design: one warp per row, each lane holding 8 columns of every 256, so
// the row's two means are two warp reductions and each operand is read
// once, 16 bytes a lane.  The TPU kernel summed dscale and dbias across its
// sequential grid; here blocks run in any order, so each block of 8 warps
// sums its 128 rows in a fixed order (per lane in registers, then the 8
// warps through shared memory) into a partial row, and a second launch
// adds the partials in block order.  No atomics: the sums are the same
// from run to run.  Rows with dxn = g = 0 (padding) give dx = 0 and add
// nothing.  D must be a multiple of 8 up to 1024.  Types: xhat, g and dx
// are bf16 (dxn bf16 or f32) or all four are f32; one template covers
// both, so the f32 form sums in the same fixed order.
#include "common.cuh"

namespace vsd {
namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 128;  // as ops/ln_bwd.py::_LN_ROWS_PER_BLOCK
constexpr int kMaxD = 1024;

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = pack8(f);
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// NCH: 256-column chunks of a row (lane holds columns 256j + 8 lane .. + 7).
// TX: the type of xh, g and dx; TD: of dxn.
template <typename TX, typename TD, int NCH>
__global__ void __launch_bounds__(kWarps * 32)
    ln_res_bwd_kernel(const TX* __restrict__ xh, const float* __restrict__ inv,
                      const TD* __restrict__ dxn, const TX* __restrict__ g,
                      const float* __restrict__ lns, TX* __restrict__ dx,
                      float* __restrict__ partial, int rows, int d) {
  __shared__ float red[kWarps][kMaxD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc_s[NCH][8], acc_b[NCH][8], sc[NCH][8];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = 256 * j + lane * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc_s[j][i] = acc_b[j][i] = 0.f;
      sc[j][i] = c < d ? lns[c + i] : 0.f;
    }
  }

  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  for (int k = warp; k < kRowsPerBlock; k += kWarps) {
    const long long row = r0 + k;
    if (row >= rows) break;
    const size_t off = static_cast<size_t>(row) * d;
    float xv[NCH][8], dv[NCH][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = 256 * j + lane * 8;
      if (c < d) {
        load8(xh + off + c, xv[j]);
        load8(dxn + off + c, dv[j]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[j][i] = dv[j][i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dh = dv[j][i] * sc[j][i];
        s1 += dh;
        s2 += dh * xv[j][i];
        acc_s[j][i] += dv[j][i] * xv[j][i];
        acc_b[j][i] += dv[j][i];
      }
    }
    const float m1 = warp_sum(s1) / static_cast<float>(d);
    const float m2 = warp_sum(s2) / static_cast<float>(d);
    const float iv = inv[row];
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = 256 * j + lane * 8;
      if (c >= d) continue;
      float gv[8], o[8];
      load8(g + off + c, gv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dh = dv[j][i] * sc[j][i];
        o[i] = gv[i] + iv * ((dh - m1) - xv[j][i] * m2);
      }
      store8(dx + off + c, o);
    }
  }

  // The block's partial sums: each warp's row of red, then the 8 warps
  // added in order, one column a thread.
  float* out_s = partial + static_cast<size_t>(blockIdx.x) * d;
  float* out_b = partial + (static_cast<size_t>(gridDim.x) + blockIdx.x) * d;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = 256 * j + lane * 8;
      if (c < d) {
#pragma unroll
        for (int i = 0; i < 8; ++i) red[warp][c + i] = pass ? acc_b[j][i] : acc_s[j][i];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w][c];
      (pass ? out_b : out_s)[c] = t;
    }
    __syncthreads();
  }
}

// dscale[c] = sum over blocks of partial[0][blk][c], dbias from partial[1],
// added in block order.
__global__ void ln_res_bwd_sum_kernel(const float* __restrict__ partial, int blocks, int d,
                                     float* __restrict__ dscale, float* __restrict__ dbias) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f, b = 0.f;
  for (int k = 0; k < blocks; ++k) {
    s += partial[static_cast<size_t>(k) * d + c];
    b += partial[(static_cast<size_t>(blocks) + k) * d + c];
  }
  dscale[c] = s;
  dbias[c] = b;
}

template <typename TX, typename TD>
cudaError_t launch(const TX* xh, const float* inv, const TD* dxn, const TX* g,
                   const float* lns, TX* dx, float* partial, int blocks, int rows, int d,
                   cudaStream_t s) {
  switch ((d + 255) / 256) {
#define VSD_CHUNKS(N)                                                                   \
  case N:                                                                               \
    ln_res_bwd_kernel<TX, TD, N><<<blocks, kWarps * 32, 0, s>>>(xh, inv, dxn, g, lns,  \
                                                                dx, partial, rows, d); \
    break;
    VSD_CHUNKS(1)
    VSD_CHUNKS(2)
    VSD_CHUNKS(3)
    VSD_CHUNKS(4)
#undef VSD_CHUNKS
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// xh, g, dx [rows, d] bf16 (x_f32 = 0) or f32 (x_f32 = 1); inv [rows] f32;
// dxn [rows, d] bf16 (dxn_f32 = 0) or f32 (dxn_f32 = 1), f32 when x_f32;
// lns, dscale, dbias [d] f32; partial [2, ceil(rows / 128), d] f32
// scratch.  Returns the first CUDA error of the two launches (0 on
// success).
extern "C" int vsd_ln_res_bwd(const void* xh, const void* inv, const void* dxn, const void* g,
                              const void* lns, void* dx, void* partial, void* dscale,
                              void* dbias, int rows, int d, int dxn_f32, int x_f32,
                              void* stream) {
  using namespace vsd;
  if (rows < 0 || d <= 0 || d % 8 || d > kMaxD || (x_f32 && !dxn_f32))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = rows > 0 ? (rows + kRowsPerBlock - 1) / kRowsPerBlock : 1;
  cudaError_t e;
  if (rows == 0) {
    e = cudaMemsetAsync(partial, 0, 2 * sizeof(float) * d, s);
  } else if (x_f32) {
    e = launch(static_cast<const float*>(xh), static_cast<const float*>(inv),
               static_cast<const float*>(dxn), static_cast<const float*>(g),
               static_cast<const float*>(lns), static_cast<float*>(dx),
               static_cast<float*>(partial), blocks, rows, d, s);
  } else if (dxn_f32) {
    e = launch(static_cast<const bf16*>(xh), static_cast<const float*>(inv),
               static_cast<const float*>(dxn), static_cast<const bf16*>(g),
               static_cast<const float*>(lns), static_cast<bf16*>(dx),
               static_cast<float*>(partial), blocks, rows, d, s);
  } else {
    e = launch(static_cast<const bf16*>(xh), static_cast<const float*>(inv),
               static_cast<const bf16*>(dxn), static_cast<const bf16*>(g),
               static_cast<const float*>(lns), static_cast<bf16*>(dx),
               static_cast<float*>(partial), blocks, rows, d, s);
  }
  if (e != cudaSuccess) return e;
  ln_res_bwd_sum_kernel<<<(d + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial),
                                                        blocks, d, static_cast<float*>(dscale),
                                                        static_cast<float*>(dbias));
  return cudaGetLastError();
}

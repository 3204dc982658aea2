// The f32 building blocks of the port's f32 training kernels: a LayerNorm
// row pass and a GEMM with fused epilogues, both in plain f32 FMAs.  f32
// never touches the tensor cores here: TF32 would round the operands to
// 10 mantissa bits, and the f32 path exists to train and check in full
// f32 (the JAX package's f32 dots keep exact products).
//
// Bound on the H100: the f32 FMA rate (67 TFLOP/s) for the GEMMs at the
// ViT's widths; the LayerNorm by its bytes.  The GEMM is a first, simple
// design (a 128 x 128 output tile per block of 256 threads, 8 x 8 outputs
// a thread, K in steps of 8 through shared memory, one buffer); its time
// is recorded, not tuned.
#pragma once

#include "common.cuh"

namespace vsd {

// ---------------------------------------------------------------------------
// LayerNorm, f32: one warp per row of d values (d % 4 == 0).  Mean and
// variance in f32 (two passes over the row), xhat = (x - mu) * inv with
// inv = 1 / sqrt(var + eps), out = xhat * gamma + beta.  The training form
// also writes xhat and inv.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kLnRowsPerBlock * 32)
    layernorm_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, float* __restrict__ out,
                         float* __restrict__ xhat, float* __restrict__ inv_out, int rows, int d,
                         float eps) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kLnRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float* xr = x + row * d;
  float s = 0.f;
  for (int c = lane * 4; c < d; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + c);
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mu = warp_sum(s) / static_cast<float>(d);
  float var = 0.f;
  for (int c = lane * 4; c < d; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + c);
    const float a = v.x - mu, b = v.y - mu, e = v.z - mu, f = v.w - mu;
    var += (a * a + b * b) + (e * e + f * f);
  }
  const float inv = 1.0f / sqrtf(warp_sum(var) / static_cast<float>(d) + eps);
  if (inv_out && lane == 0) inv_out[row] = inv;
  for (int c = lane * 4; c < d; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(xr + c);
    const float4 h = make_float4((v.x - mu) * inv, (v.y - mu) * inv, (v.z - mu) * inv,
                                 (v.w - mu) * inv);
    const float4 g = *reinterpret_cast<const float4*>(gamma + c);
    const float4 b = *reinterpret_cast<const float4*>(beta + c);
    *reinterpret_cast<float4*>(out + row * d + c) =
        make_float4(h.x * g.x + b.x, h.y * g.y + b.y, h.z * g.z + b.z, h.w * g.w + b.w);
    if (xhat) *reinterpret_cast<float4*>(xhat + row * d + c) = h;
  }
}

// xhat and inv_out are written when given (the training form).
inline cudaError_t launch_layernorm_f32(const float* x, const float* gamma, const float* beta,
                                        float* out, int rows, int d, float eps,
                                        cudaStream_t stream, float* xhat = nullptr,
                                        float* inv_out = nullptr) {
  if (rows <= 0) return cudaSuccess;
  if (d % 4) return cudaErrorInvalidValue;
  const int blocks = (rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock;
  layernorm_f32_kernel<<<blocks, kLnRowsPerBlock * 32, 0, stream>>>(x, gamma, beta, out, xhat,
                                                                    inv_out, rows, d, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GEMM, f32: C[M, N] = epilogue(A[M, K] @ W[K, N]), A and W f32 row-major
// (W in the JAX [in, out] layout).  Thread (tx, ty) of the 16 x 16 block
// owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3} and the same columns of
// tx, so the shared-memory reads of a k step are two float4 broadcasts of
// A and two conflict-free float4 reads of W.  A's tile is stored transposed
// ([k][m]).  Rows past M, columns past N and k past K are zero-filled on
// load and skipped on store: any M works, N and K must be multiples of 4.
// Each output sums its K products in k order, one FMA each.
//
// Epilogues, all in f32:
//   kEpiF32Bias          C = acc + bias
//   kEpiF32BiasResidual  C = (R + acc) + bias
//   kEpiF32BiasHGelu     H = acc + bias, C = gelu(H); erf GELU (kGeluErf)
//                        or tanh (kGeluTanh)
// ---------------------------------------------------------------------------

enum { kEpiF32Bias = 0, kEpiF32BiasResidual = 1, kEpiF32BiasHGelu = 2 };
enum { kGeluTanh = 0, kGeluErf = 1 };

template <int GELU>
__device__ __forceinline__ float gelu_f32(float x) {
  return GELU == kGeluErf ? gelu_erf(x) : gelu_tanh(x);
}

constexpr int kSgemmBM = 128, kSgemmBN = 128, kSgemmBK = 8, kSgemmThreads = 256;

template <int EPI, int GELU>
__global__ void __launch_bounds__(kSgemmThreads)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                    const float* __restrict__ bias, const float* __restrict__ R,
                    float* __restrict__ C, float* __restrict__ H, int M, int N, int K) {
  __shared__ __align__(16) float As[kSgemmBK][kSgemmBM];
  __shared__ __align__(16) float Ws[kSgemmBK][kSgemmBN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kSgemmBM, n0 = blockIdx.x * kSgemmBN;
  // loaders: A row a_r, k a_k .. a_k + 3; W k-row w_k, columns w_n .. w_n + 3
  const int a_r = tid >> 1, a_k = (tid & 1) * 4;
  const int w_k = tid >> 5, w_n = (tid & 31) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kSgemmBK) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), w = a;
    if (m0 + a_r < M && k0 + a_k < K)
      a = __ldg(reinterpret_cast<const float4*>(A + static_cast<size_t>(m0 + a_r) * K + k0 +
                                                a_k));
    if (k0 + w_k < K && n0 + w_n < N)
      w = __ldg(reinterpret_cast<const float4*>(W + static_cast<size_t>(k0 + w_k) * N + n0 +
                                                w_n));
    __syncthreads();  // the previous step's reads are done
    As[a_k][a_r] = a.x;
    As[a_k + 1][a_r] = a.y;
    As[a_k + 2][a_r] = a.z;
    As[a_k + 3][a_r] = a.w;
    *reinterpret_cast<float4*>(&Ws[w_k][w_n]) = w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSgemmBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ws[k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 64 + tx * 4;
      if (col >= N) continue;
      const float4 bb = *reinterpret_cast<const float4*>(bias + col);
      const size_t off = static_cast<size_t>(row) * N + col;
      float v[4] = {acc[i][half * 4], acc[i][half * 4 + 1], acc[i][half * 4 + 2],
                    acc[i][half * 4 + 3]};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
      if (EPI == kEpiF32BiasResidual) {
        const float4 r = *reinterpret_cast<const float4*>(R + off);
        const float rv[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = (rv[e] + v[e]) + bv[e];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] += bv[e];
      }
      if (EPI == kEpiF32BiasHGelu) {
        *reinterpret_cast<float4*>(H + off) = make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = gelu_f32<GELU>(v[e]);
      }
      *reinterpret_cast<float4*>(C + off) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// H is written only by kEpiF32BiasHGelu, R read only by kEpiF32BiasResidual.
template <int EPI, int GELU = kGeluTanh>
inline cudaError_t launch_gemm_f32(const float* A, const float* W, const float* bias,
                                   const float* R, float* C, int M, int N, int K,
                                   cudaStream_t stream, float* H = nullptr) {
  if (M <= 0) return cudaSuccess;
  if (N <= 0 || N % 4 || K <= 0 || K % 4) return cudaErrorInvalidValue;
  const int grid_m = (M + kSgemmBM - 1) / kSgemmBM;
  if (grid_m > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + kSgemmBN - 1) / kSgemmBN, grid_m);
  gemm_f32_kernel<EPI, GELU><<<grid, kSgemmThreads, 0, stream>>>(A, W, bias, R, C, H, M, N, K);
  return cudaGetLastError();
}

}  // namespace vsd

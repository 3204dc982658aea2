// Device code shared by the port's hand-written Hopper kernels: a
// LayerNorm row pass, the mma.sync / ldmatrix helpers of the attention
// kernels and the wgmma helpers of the GEMM cores (the bf16 GEMM itself is
// gemm_core.cuh).
//
// Built by ops/_build.py with nvcc for sm_90a into one shared library
// per kernel source (csrc/*.cu), each exposing a plain C entry point
// loaded with ctypes.  Nothing here allocates or
// synchronises: the Python wrapper allocates outputs and scratch, and
// every launch goes on the caller's stream.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace vsd {

using bf16 = __nv_bfloat16;

// Launches of the GEMM cores in this library (0: the bf16 core,
// gemm_core.cuh::launch_gemm; 1: the f32 core,
// f32_common.cuh::launch_gemm_f32), each counted by its launcher where it
// launches the kernel; vsd_core_launches reads them.
static std::atomic<long long> g_core_launches[2];

// Largest dynamic shared memory one block may ask for on the H100.
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store_zero16(void* smem) {
  *reinterpret_cast<uint4*>(smem) = make_uint4(0u, 0u, 0u, 0u);
}

// 8 bf16 values in one 16-byte word <-> 8 floats.
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// tanh GELU in f32, the formula of jax.nn.gelu(approximate=True).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return x * (0.5f * (1.0f + tanhf(inner)));
}

// The same function in the form the serving MLP's fc1 epilogue runs
// (gemm_core.cuh, kEpiBiasGelu): x (1 + tanh u) / 2 = x / (1 + 2^t), with
// u = sqrt(2 / pi) (x + 0.044715 x^3) and t = -2u log2(e), on the
// special-function unit (ex2.approx, rcp.approx): a multiply, an FMA, a
// multiply, two SFU operations, an add and a multiply.  About 2e-6
// relative to gelu_tanh at any x, including large negative x, where
// 1 + tanh u cancels (tanh.approx.f32 would lose the small values there).
// The result is rounded to bf16, so it moves a hidden value by one bf16
// ulp only where that value lies within ~2e-6 of a rounding midpoint.
// Past |t| ~ 128 the power is 0 or inf and the quotient x or -0, as for
// tanhf.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float gelu_tanh_fast(float x) {
  // t = x (c0 + c1 x^2), c0 = -2 sqrt(2 / pi) log2(e), c1 = 0.044715 c0
  const float t = x * fmaf(-0.1029432395800235f, x * x, -2.302208198144325f);
  return x * rcp_approx(1.0f + ex2_approx(t));
}

// erf GELU in f32, the formula of jax.nn.gelu(approximate=False) and of
// torch's gelu: 0.5 x (1 + erf(x / sqrt 2)), with CUDA's erff (the TPU
// kernel had to emulate erf with the A&S rational; CUDA has it).
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// The two GELUs of the training MLP's stored-hidden epilogue (kernel 7,
// gemm_core.cuh), on the special-function unit, as x Phi(x) with Phi
// written through its small tail E: Phi = E for x < 0 and 1 - E past it,
// so that 1 + erf and 1 + tanh never cancel at large negative x.  The
// tail is scaled by 2^24 inside the ex2 and back by a multiply, so that
// where x E lies in the subnormals it is rounded there once and not
// flushed to 0 (ex2.approx.ftz flushes).  On every finite bf16 input the
// bf16-rounded result is within one bf16 ulp of the exact GELU of its
// flavour (tests/test_torch_mlp_train_epilogue.py emulates these lines
// over all of them; on the card ops/gemm.py::hidden_gelu_check runs them).
// A non-finite input gives NaN (the erf form) or +-inf / NaN (the tanh
// form), as x Phi(x) does.
//
// erf: E = erfc(|x| / sqrt 2) / 2 = t 2^(q(t) - x^2 log2(e) / 2 - 24),
// t = 1 / (1 + p |x| / sqrt 2) (p = 0.7; kGeluTailC = p / sqrt 2),
// q(t) = log2(e) g(t) + 23, g the degree-4 fit of ln(erfcx(u) / t) over u
// in [0, 10] (relative error 6.0e-5 in E; erfcx(u) = e^(u^2) erfc(u)), so
// E keeps its relative accuracy out to |x| = 14.1, past which x E rounds
// to 0 in bf16 (x < 0) or x - x E to x (x > 0).  ops/gemm.py mirrors the
// constants.
constexpr float kGeluTailC = 0.4949747468305833f;
// q(t) = (((Q4 t + Q3) t + Q2) t + Q1) t + Q0
constexpr float kGeluTailQ4 = 0.361751914024353f;
constexpr float kGeluTailQ3 = -1.1295230388641357f;
constexpr float kGeluTailQ2 = 0.7219557166099548f;
constexpr float kGeluTailQ1 = 1.382437825202942f;
constexpr float kGeluTailQ0 = 21.663318634033203f;

__device__ __forceinline__ float gelu_erf_tail(float x) {
  const float t = rcp_approx(fmaf(fabsf(x), kGeluTailC, 1.0f));
  float q = fmaf(kGeluTailQ4, t, kGeluTailQ3);
  q = fmaf(q, t, kGeluTailQ2);
  q = fmaf(q, t, kGeluTailQ1);
  q = fmaf(q, t, kGeluTailQ0);
  const float e = ex2_approx(fmaf(x * x, -0.7213475204444817f, q));  // 2^24 E / t
  // x Phi = max(x, 0) - |x| E: x - x E past 0, x E below it
  return fmaxf(x, 0.f) - (fabsf(x) * t) * (e * 5.9604644775390625e-8f);
}

// tanh: Phi = 1 / (1 + 2^s), s = -2 sqrt(2 / pi) (x + 0.044715 x^3) log2(e)
// (gelu_tanh_fast's exponent); with S = 2^-|s|, Phi = S / (1 + S) for
// x < 0 and 1 / (1 + S) past it.
__device__ __forceinline__ float gelu_tanh_tail(float x) {
  const float s = x * fmaf(-0.1029432395800235f, x * x, -2.302208198144325f);
  const float sm = ex2_approx(24.0f - fabsf(s)) * 5.9604644775390625e-8f;  // 2^-|s|
  const float xr = x * rcp_approx(1.0f + sm);
  return x < 0.f ? xr * sm : xr;
}

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row of d bf16 values (d % 8 == 0).  Mean and
// variance in f32, (x - mu) * rsqrt(var + eps) * gamma + beta, rounded to
// bf16 once.  Rows of up to 1,024 values stay in registers between the
// passes (one read from device memory); a longer row is read three times,
// the second and third reads from L1/L2.  The training form (kResid) also writes the backward's
// residuals: xhat = (x - mu) * rsqrt(var + eps) rounded to bf16, and the
// f32 rsqrt(var + eps) of each row.
// ---------------------------------------------------------------------------

constexpr int kLnRowsPerBlock = 8;

// One row by one warp: xr, orow (and xhrow, inv) point at the row.
template <bool kResid>
__device__ __forceinline__ void layernorm_row(const bf16* __restrict__ xr,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta,
                                              bf16* __restrict__ orow, bf16* __restrict__ xhrow,
                                              float* __restrict__ inv_out, int d, float eps,
                                              int lane) {
  float f[8];
  float s = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mu = warp_sum(s) / static_cast<float>(d);
  float v = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float t = f[i] - mu;
      v += t * t;
    }
  }
  const float inv = 1.0f / sqrtf(warp_sum(v) / static_cast<float>(d) + eps);
  if (kResid && lane == 0) *inv_out = inv;
  for (int c = lane * 8; c < d; c += 256) {
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
    float h[8], g[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      h[i] = (f[i] - mu) * inv;
      g[i] = h[i] * gamma[c + i] + beta[c + i];
    }
    *reinterpret_cast<uint4*>(orow + c) = pack8(g);
    if (kResid) *reinterpret_cast<uint4*>(xhrow + c) = pack8(h);
  }
}

// The same row with its values held in registers between the passes
// (rows of at most kLnRegChunks * 256 values): one read of the row from
// device memory, the sums in layernorm_row's order, so the two agree bit
// for bit.
constexpr int kLnRegChunks = 4;

// Row xr's values into f and its mean and 1 / sqrt(var + eps), one warp.
__device__ __forceinline__ void ln_row_reg_stats(const bf16* __restrict__ xr,
                                                 float (&f)[kLnRegChunks][8], int d, float eps,
                                                 int lane, float& mu, float& inv) {
#pragma unroll
  for (int k = 0; k < kLnRegChunks; ++k) {
    const int c = lane * 8 + k * 256;
    if (c < d) unpack8(__ldg(reinterpret_cast<const uint4*>(xr + c)), f[k]);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kLnRegChunks; ++k)
    if (lane * 8 + k * 256 < d) {
#pragma unroll
      for (int i = 0; i < 8; ++i) s += f[k][i];
    }
  mu = warp_sum(s) / static_cast<float>(d);
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < kLnRegChunks; ++k)
    if (lane * 8 + k * 256 < d) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t = f[k][i] - mu;
        v += t * t;
      }
    }
  inv = 1.0f / sqrtf(warp_sum(v) / static_cast<float>(d) + eps);
}

template <bool kResid>
__device__ __forceinline__ void layernorm_row_reg(const bf16* __restrict__ xr,
                                                  const float* __restrict__ gamma,
                                                  const float* __restrict__ beta,
                                                  bf16* __restrict__ orow, bf16* __restrict__ xhrow,
                                                  float* __restrict__ inv_out, int d, float eps,
                                                  int lane) {
  float f[kLnRegChunks][8], mu, inv;
  ln_row_reg_stats(xr, f, d, eps, lane, mu, inv);
  if (kResid && lane == 0) *inv_out = inv;
#pragma unroll
  for (int k = 0; k < kLnRegChunks; ++k) {
    const int c = lane * 8 + k * 256;
    if (c < d) {
      float gm[8], bt[8], h[8], g[8];
      *reinterpret_cast<float4*>(gm) = __ldg(reinterpret_cast<const float4*>(gamma + c));
      *reinterpret_cast<float4*>(gm + 4) = __ldg(reinterpret_cast<const float4*>(gamma + c + 4));
      *reinterpret_cast<float4*>(bt) = __ldg(reinterpret_cast<const float4*>(beta + c));
      *reinterpret_cast<float4*>(bt + 4) = __ldg(reinterpret_cast<const float4*>(beta + c + 4));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        h[i] = (f[k][i] - mu) * inv;
        g[i] = h[i] * gm[i] + bt[i];
      }
      *reinterpret_cast<uint4*>(orow + c) = pack8(g);
      if (kResid) *reinterpret_cast<uint4*>(xhrow + c) = pack8(h);
    }
  }
}

template <bool kResid>
__global__ void __launch_bounds__(kLnRowsPerBlock * 32)
    layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, bf16* __restrict__ out,
                     bf16* __restrict__ xhat, float* __restrict__ inv_out, int rows, int d,
                     float eps) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kLnRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  if (d <= kLnRegChunks * 256)
    layernorm_row_reg<kResid>(x + row * d, gamma, beta, out + row * d,
                              kResid ? xhat + row * d : nullptr,
                              kResid ? inv_out + row : nullptr, d, eps, threadIdx.x & 31);
  else
    layernorm_row<kResid>(x + row * d, gamma, beta, out + row * d,
                          kResid ? xhat + row * d : nullptr, kResid ? inv_out + row : nullptr, d,
                          eps, threadIdx.x & 31);
}

// xhat and inv_out are written only when both are given (the training form).
inline cudaError_t launch_layernorm(const bf16* x, const float* gamma, const float* beta,
                                    bf16* out, int rows, int d, float eps,
                                    cudaStream_t stream, bf16* xhat = nullptr,
                                    float* inv_out = nullptr) {
  if (rows <= 0) return cudaSuccess;
  if (d % 8) return cudaErrorInvalidValue;
  const int blocks = (rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock;
  if (xhat && inv_out)
    layernorm_kernel<true><<<blocks, kLnRowsPerBlock * 32, 0, stream>>>(
        x, gamma, beta, out, xhat, inv_out, rows, d, eps);
  else
    layernorm_kernel<false><<<blocks, kLnRowsPerBlock * 32, 0, stream>>>(
        x, gamma, beta, out, nullptr, nullptr, rows, d, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Warp-level tensor-core helpers of the attention kernels (mma.sync
// m16n8k16 bf16 with f32 accumulation, ldmatrix).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld_shared_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_global_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// c += a @ b for one 16x8x16 tile: a row-major bf16 (4 regs), b
// column-major bf16 (2 regs), c f32 (4 regs), the PTX fragment layouts:
// with g = lane / 4 and t4 = lane % 4, a[0..3] hold A[g][2t4..+1],
// A[g+8][2t4..+1], A[g][2t4+8..+9], A[g+8][2t4+8..+9]; b0, b1 hold
// B[2t4..+1][g], B[2t4+8..+9][g]; c[0..1] C[g][2t4..+1], c[2..3] C[g+8][..].
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 bf16 tiles of a row-major [key][col] matrix, transposed on the
// way into registers: the B fragment of a 16-key x 8-column product.
// Lanes 0-15 give the addresses of rows key0 .. key0 + 15.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const bf16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(a));
}

// Four 8x8 bf16 tiles into registers; lanes 8i .. 8i + 7 give the row
// addresses of tile i.  Without .trans the tiles land as the A fragment of
// a row-major [m][k] 16x16 block (tiles: m 0-7/k 0-7, m 8-15/k 0-7,
// m 0-7/k 8-15, m 8-15/k 8-15); with .trans, from a [k][m] matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

// The same at a shared-memory byte address (smem_addr): a base register plus
// an offset that is a constant after unrolling, so that no address is held
// live across a loop.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans_at(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// An attention logit in base 2 for exp2f (scale2 = scale * log2 e, so that
// exp2(s2 - max) = exp(s - max)): key columns >= valid_len at -1e30 as the
// TPU kernels mask them, columns past the keys (>= tk) at -inf.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float masked_logit2(float s, int key, int valid_len, int tk,
                                               float scale2) {
  return key < valid_len ? s * scale2 : (key < tk ? -1e30f : -CUDART_INF_F);
}

// ---------------------------------------------------------------------------
// Warpgroup MMA (wgmma) helpers of the cores that multiply on Hopper's
// tensor cores from shared memory (gemm_core.cuh, lowlat_core.cuh).  Their
// tiles are stored in the 128-byte swizzled layout wgmma reads: A K-major
// (one 128-byte row of 64 k per m), W N-major (for each 64-column block,
// one 128-byte row of 64 n per k); 16-byte chunk c of row r sits at chunk
// c ^ (r % 8).
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte swizzled tile: start
// address, leading and stride byte offsets (16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t gmma_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint64_t d = static_cast<uint64_t>((a & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
  return d | (1ull << 62);  // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory writes (cp.async, stores) visible to
// wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace vsd

extern "C" const char* vsd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[0], out[1]: the bf16 and the f32 GEMM cores' launches in this
// library since it was loaded or last reset; reset != 0 zeroes them.
extern "C" void vsd_core_launches(long long* out, int reset) {
  for (int i = 0; i < 2; ++i)
    out[i] = reset ? vsd::g_core_launches[i].exchange(0) : vsd::g_core_launches[i].load();
}

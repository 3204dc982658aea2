// Device code shared by the port's hand-written Hopper kernels: a
// LayerNorm row pass, a bf16 wgmma GEMM with fused epilogues, and the
// mma.sync / ldmatrix helpers of the attention kernels.
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

namespace vsd {

using bf16 = __nv_bfloat16;

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

// erf GELU in f32, the formula of jax.nn.gelu(approximate=False) and of
// torch's gelu: 0.5 x (1 + erf(x / sqrt 2)), with CUDA's erff (the TPU
// kernel had to emulate erf with the A&S rational; CUDA has it).
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row of d bf16 values (d % 8 == 0).  Mean and
// variance in f32, (x - mu) * rsqrt(var + eps) * gamma + beta, rounded to
// bf16 once.  The row is read three times; the second and third reads
// come from L1/L2.  The training form (kResid) also writes the backward's
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

template <bool kResid>
__global__ void __launch_bounds__(kLnRowsPerBlock * 32)
    layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, bf16* __restrict__ out,
                     bf16* __restrict__ xhat, float* __restrict__ inv_out, int rows, int d,
                     float eps) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kLnRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
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
// GEMM: C[M, N] = epilogue(A[M, K] @ W[K, N]), A and W bf16 row-major (W in
// the JAX [in, out] layout), f32 accumulation on the tensor cores through
// Hopper's warpgroup MMA (wgmma.mma_async m64n128k16).
//
// A 128 x 128 output tile per block of two warpgroups (64 rows each); K
// advances 64 at a time through a 3-stage cp.async ring in shared memory,
// two blocks per SM (96 KB each) so one block's epilogue overlaps the
// other's products.  Tiles are stored in the 128-byte swizzled layout
// wgmma reads: A K-major (one 128-byte row of 64 k per m), W N-major (for
// each 64-column block, one 128-byte row of 64 n per k); 16-byte chunk c of
// row r sits at chunk c ^ (r % 8).  The ring keeps one wgmma group in
// flight: tile kt + 1 is loaded while tile kt is multiplied, into the slot
// whose products retired at the barrier.  Rows past M, columns past N and
// k past K are zero-filled on load and skipped on store, so any M works and
// N, K need only be multiples of 8 (16-byte rows).
//
// Epilogues, all in f32 and rounded to bf16 once:
//   kEpiBias          acc + bias
//   kEpiBiasGelu      gelu_tanh(acc + bias)
//   kEpiBiasResidual  (residual + acc) + bias
// and the training MLP's stored-hidden epilogues, which write two outputs:
//   kEpiBiasHGeluErf  H = bf16(acc + bias), C = bf16(gelu_erf(H))
//   kEpiBiasHGeluTanh H = bf16(acc + bias), C = bf16(gelu_tanh(H))
// (the GELU reads the rounded hidden, so the stored H, the activation and
// the backward's recompute of the gate all see one tensor).
// ---------------------------------------------------------------------------

enum {
  kEpiBias = 0,
  kEpiBiasGelu = 1,
  kEpiBiasResidual = 2,
  kEpiBiasHGeluErf = 3,
  kEpiBiasHGeluTanh = 4
};

constexpr int kGemmBM = 128, kGemmBN = 128, kGemmBK = 64, kGemmStages = 3;
constexpr int kGemmThreads = 256;
constexpr int kGemmAStage = kGemmBM * kGemmBK, kGemmBStage = kGemmBN * kGemmBK;  // elements
constexpr size_t kGemmSmem =
    static_cast<size_t>(kGemmStages) * (kGemmAStage + kGemmBStage) * sizeof(bf16) +
    1024;  // room to align the ring to the 1024-byte swizzle period

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

// d += A (64 x 16, K-major) @ B (16 x 128, N-major), f32 accumulation, one
// warpgroup; a and b are shared-memory descriptors (gmma_desc).  The
// accumulator layout: thread t of the warpgroup holds, for each 8-column
// group j, rows 16 * (t / 32) + (t % 32) / 4 (+ 8) and columns
// 8j + 2 * (t % 4) (+ 1) in d[4j .. 4j + 3].
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int EPI>
__global__ void __launch_bounds__(kGemmThreads, 2)
    gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                     const float* __restrict__ bias, const bf16* __restrict__ R,
                     bf16* __restrict__ C, bf16* __restrict__ H, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  bf16* As = reinterpret_cast<bf16*>(smem_raw + ((1024 - (base & 1023)) & 1023));
  bf16* Bs = As + kGemmStages * kGemmAStage;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * kGemmBM, n0 = blockIdx.x * kGemmBN;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * kGemmBK;
    bf16* as = As + stage * kGemmAStage;
    bf16* bs = Bs + stage * kGemmBStage;
#pragma unroll
    for (int i = 0; i < kGemmBM * 8 / kGemmThreads; ++i) {  // row r, chunk ch
      const int c = tid + i * kGemmThreads, r = c >> 3, ch = c & 7;
      bf16* dst = as + r * 64 + ((ch ^ (r & 7)) << 3);
      if (m0 + r < M && k0 + ch * 8 < K)
        cp_async16(dst, A + static_cast<size_t>(m0 + r) * K + k0 + ch * 8);
      else
        store_zero16(dst);
    }
#pragma unroll
    for (int i = 0; i < kGemmBN * 8 / kGemmThreads; ++i) {  // block nb, k-row kr, chunk ch
      const int c = tid + i * kGemmThreads, nb = c >> 9, kr = (c >> 3) & 63, ch = c & 7;
      bf16* dst = bs + nb * 64 * 64 + kr * 64 + ((ch ^ (kr & 7)) << 3);
      const int col = n0 + nb * 64 + ch * 8;
      if (k0 + kr < K && col < N)
        cp_async16(dst, W + static_cast<size_t>(k0 + kr) * N + col);
      else
        store_zero16(dst);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  const int ktiles = (K + kGemmBK - 1) / kGemmBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<0>();  // tile kt has landed (this thread's part) ...
    fence_proxy_async();
    __syncthreads();     // ... everyone's, and wgmma kt - 2 has retired in both warpgroups
    if (kt + 1 < ktiles) load_tile((kt + 1) % kGemmStages, kt + 1);
    cp_async_commit();

    const bf16* as = As + (kt % kGemmStages) * kGemmAStage + wg * 64 * 64;
    const bf16* bs = Bs + (kt % kGemmStages) * kGemmBStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk)  // A: 1024 B per 8 rows; W: 8 KB per 64 columns
      wgmma_m64n128k16(acc, gmma_desc(as + kk * 16, 16, 1024),
                       gmma_desc(bs + kk * 16 * 64, 8192, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // wgmma kt - 1 has retired: its slot is free after the next barrier
  }
  wgmma_wait<0>();

  const int lane = tid & 31;
  const int row0 = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kGemmBN / 8; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
    if (col >= N) continue;
    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + h * 8;
      if (row >= M) continue;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      const size_t off = static_cast<size_t>(row) * N + col;
      if (EPI == kEpiBiasResidual) {
        const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(R + off));
        v0 = (r.x + v0) + bb.x;
        v1 = (r.y + v1) + bb.y;
      } else if (EPI == kEpiBiasHGeluErf || EPI == kEpiBiasHGeluTanh) {
        const __nv_bfloat162 hv = __floats2bfloat162_rn(v0 + bb.x, v1 + bb.y);
        *reinterpret_cast<__nv_bfloat162*>(H + off) = hv;
        const float2 hf = __bfloat1622float2(hv);
        v0 = EPI == kEpiBiasHGeluErf ? gelu_erf(hf.x) : gelu_tanh(hf.x);
        v1 = EPI == kEpiBiasHGeluErf ? gelu_erf(hf.y) : gelu_tanh(hf.y);
      } else {
        v0 += bb.x;
        v1 += bb.y;
        if (EPI == kEpiBiasGelu) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(C + off) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// H is written only by the stored-hidden epilogues.
template <int EPI>
inline cudaError_t launch_gemm(const bf16* A, const bf16* W, const float* bias, const bf16* R,
                               bf16* C, int M, int N, int K, cudaStream_t stream,
                               bf16* H = nullptr) {
  if (M <= 0) return cudaSuccess;
  if (N <= 0 || N % 8 || K <= 0 || K % 8) return cudaErrorInvalidValue;
  const int grid_m = (M + kGemmBM - 1) / kGemmBM;
  if (grid_m > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(gemm_bf16_kernel<EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kGemmSmem));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, grid_m);
  gemm_bf16_kernel<EPI><<<grid, kGemmThreads, kGemmSmem, stream>>>(A, W, bias, R, C, H, M, N,
                                                                   K);
  return cudaGetLastError();
}

}  // namespace vsd

extern "C" const char* vsd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

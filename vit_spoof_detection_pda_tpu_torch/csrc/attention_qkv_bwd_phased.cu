// Phase-split backward of the attention core on Hopper: the same function
// as attention_qkv_bwd.cu (kernel 4).  Given the fused projection
// qkv [B, Tp, 3D] (q | k | v, heads contiguous inside each) and the
// cotangent g [B, Tp, D] of the concatenated head outputs (zero on pad
// rows), per head
//
//   w  = softmax(q k^T * s), key columns >= valid_len at -1e30   (f32)
//   dv = cdt(w)^T g,  dw = g v^T,  dl = w (dw - rowsum(dw w))
//   dq = cdt(dl) k * s,  dk = cdt(dl)^T q * s
//
// into dqkv [B, Tp, 3D], where cdt is the input type (bf16, or f32 where
// the rounding is the identity).  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_qkv_bwd_kernel_phased
// (:259), the opt-in form of kernel 4 selected by BWD_PHASED, and keeps its
// rounding points: w is rounded to cdt only as the operand of dv, dl is
// formed from the f32 w and dw after each row's full sum and rounded to
// cdt only as the operand of dq and dk; every product sums in f32.
//
// Bound on the H100: the same work as kernel 4.  bf16 at ViT-B, B = 128,
// Tp = 200: qkv and g in, dqkv out, about 275 MB, >= 0.082 ms at 3.35 TB/s
// (the five [Tp, Tp] x Dh products are 39 GFLOP, 0.04 ms at the bf16
// peak).  f32 at B = 32: the five products are 9.8 GFLOP on the FMA units,
// >= 0.147 ms at 67 TFLOP/s.
//
// Design.  The TPU kernel keeps block_b * H f32 [Tp, Tp] weight tiles in
// VMEM (3.84 MB) between four phases, each of which issues all (item, head)
// pairs' products of one kind back to back.  No SM's shared memory holds
// that (one head's f32 w is 160 KB at Tp 200), so here the phases are four
// launches over a global f32 workspace [chunk * H, Tp, Tp]:
//   A. scores: a warp per 16 query rows of one (item, head) computes
//      s = q k^T * s with mma.sync tiles (once; kernel 4 computes them
//      twice), writes them to its rows of the workspace, then turns each
//      row into w = exp(s - max) / sum in place.
//   B. dv: a warp per 16 keys accumulates dv = cdt(w)^T g over the rows.
//   C. dl: a warp per 16 query rows forms dw = g v^T into shared memory,
//      then rowsum(dw w) of each row, then writes dl = w (dw - rowsum)
//      over w in place (w's last read is here).
//   D. dq and dk: a warp per 16 query rows accumulates dq = cdt(dl) k * s,
//      a warp per 16 keys dk = cdt(dl)^T q * s.
// The items go through in chunks, so that the workspace stays in the 50 MB
// L2 between the phases: the wrapper (ops/attention.py) sizes a chunk to
// 32 MB of workspace, 16 items at ViT-B (1.92 MB an item: 12 heads of
// 200 x 200 f32).  At B = 128 the whole workspace would be 246 MB and its
// four round trips would go to HBM.  The chunk loop runs here on the
// caller's stream (four launches a chunk), so a CUDA graph can capture it.
//
// The products use kernel 4's m16n8k16 fragment layouts (common.cuh
// mma_16816): at bf16 each fragment is packed from its elements and
// multiplied on the tensor cores; at f32 the same fragment positions are
// summed with FMAs (Tile<float>), so one template serves both types and the
// f32 form never touches the tensor cores.  Operands are read from global
// memory (L1 / L2), element by element: a simple first design, not a fast
// one.  Rows with g = 0 give dw = 0, hence dl = 0: pad rows add nothing
// and their dq is 0; masked key columns have w = 0 exactly, so their dk
// and dv are 0.
#include <math_constants.h>

#include "common.cuh"

namespace vsd {
namespace {

constexpr int kWarps = 4;  // warps a block, each on one 16-row (or 16-key) tile

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void from_f(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C (an m16n8 f32 fragment) += A (16 x 16) B (16 x 8).  ``at(i, k)`` and
// ``bt(k, n)`` give the operands' elements as f32 (zero outside the
// matrix).  With g = lane / 4 and t4 = lane % 4, c[0..1] hold C[g][2 t4 ..
// + 1] and c[2..3] C[g + 8][2 t4 .. + 1], as mma_16816 gives them.
template <typename T>
struct Tile;

template <>
struct Tile<bf16> {  // the tensor cores; operands rounded to bf16 here
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r0, r1;
  };
  template <class F>
  __device__ static A load_a(F at, int g, int t4) {
    A x;
    x.r[0] = pack_bf16x2(at(g, 2 * t4), at(g, 2 * t4 + 1));
    x.r[1] = pack_bf16x2(at(g + 8, 2 * t4), at(g + 8, 2 * t4 + 1));
    x.r[2] = pack_bf16x2(at(g, 2 * t4 + 8), at(g, 2 * t4 + 9));
    x.r[3] = pack_bf16x2(at(g + 8, 2 * t4 + 8), at(g + 8, 2 * t4 + 9));
    return x;
  }
  template <class F>
  __device__ static B load_b(F bt, int g, int t4) {
    return {pack_bf16x2(bt(2 * t4, g), bt(2 * t4 + 1, g)),
            pack_bf16x2(bt(2 * t4 + 8, g), bt(2 * t4 + 9, g))};
  }
  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
    mma_16816(c, a.r, b.r0, b.r1);
  }
};

template <>
struct Tile<float> {  // FMAs in the same fragment positions; no TF32
  struct A {
    float r[2][16];  // rows g, g + 8
  };
  struct B {
    float c[2][16];  // columns 2 t4, 2 t4 + 1
  };
  template <class F>
  __device__ static A load_a(F at, int g, int /*t4*/) {
    A x;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      x.r[0][k] = at(g, k);
      x.r[1][k] = at(g + 8, k);
    }
    return x;
  }
  template <class F>
  __device__ static B load_b(F bt, int /*g*/, int t4) {
    B x;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      x.c[0][k] = bt(k, 2 * t4);
      x.c[1][k] = bt(k, 2 * t4 + 1);
    }
    return x;
  }
  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      c[0] = fmaf(a.r[0][k], b.c[0][k], c[0]);
      c[1] = fmaf(a.r[0][k], b.c[1][k], c[1]);
      c[2] = fmaf(a.r[1][k], b.c[0][k], c[2]);
      c[3] = fmaf(a.r[1][k], b.c[1][k], c[3]);
    }
  }
};

// Where a block's warp works: tile (16 rows or keys) of one (item, head).
struct Where {
  int tile, h, item, lane, g, t4;
};

__device__ __forceinline__ Where where_am_i(int tile_base) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return {tile_base + static_cast<int>(blockIdx.x) * kWarps + warp, static_cast<int>(blockIdx.y),
          static_cast<int>(blockIdx.z), lane, lane >> 2, lane & 3};
}

// The operand pointers of one (item, head): q, k, v rows of stride 3D, g
// rows of stride D, the workspace's [Tp, Tp] tile.
template <typename T>
struct Head {
  const T* q;
  const T* k;
  const T* v;
  const T* g;
  T* dq;
  float* w;
  size_t stride;  // 3D
  int d;
};

template <typename T, int DH>
__device__ __forceinline__ Head<T> head_of(const T* qkv, const T* gout, T* dqkv, float* work,
                                           const Where& at, int tp, int d, int heads) {
  const size_t stride = 3 * static_cast<size_t>(d);
  const size_t row0 = static_cast<size_t>(at.item) * tp;
  const size_t col = static_cast<size_t>(at.h) * DH;
  const T* q = qkv + row0 * stride + col;
  return {q,
          q + d,
          q + 2 * static_cast<size_t>(d),
          gout + row0 * d + col,
          dqkv + row0 * stride + col,
          work + (static_cast<size_t>(at.item) * heads + at.h) * tp * tp,
          stride,
          d};
}

// Store an m16n8 fragment of rows (or keys) r0 .. r0 + 15, columns
// n0 .. n0 + 7 of a head's [Tp][DH] output slice, times ``mul``.
template <typename T>
__device__ __forceinline__ void store_frag(T* out, size_t stride, int tp, int r0, int n0,
                                           const float (&c)[4], float mul, int g, int t4) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = r0 + g + (e >> 1) * 8;
    if (r < tp) from_f(out + r * stride + n0 + 2 * t4 + (e & 1), c[e] * mul);
  }
}

// ---- A: w = softmax(q k^T * s) into the workspace ----
template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
    phase_scores(const T* __restrict__ qkv, const T* __restrict__ gout, T* __restrict__ dqkv,
                 float* __restrict__ work, int tp, int d, int heads, int valid_len, float scale) {
  const Where at = where_am_i(0);
  if (at.tile * 16 >= tp) return;
  const Head<T> hd = head_of<T, DH>(qkv, gout, dqkv, work, at, tp, d, heads);
  const int r0 = at.tile * 16;
  for (int c0 = 0; c0 < tp; c0 += 8) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      const auto a = Tile<T>::load_a(
          [&](int i, int k) {
            const int r = r0 + i;
            return r < tp ? to_f(hd.q[r * hd.stride + kk + k]) : 0.f;
          },
          at.g, at.t4);
      const auto b = Tile<T>::load_b(
          [&](int k, int n) {
            const int c = c0 + n;
            return c < tp ? to_f(hd.k[c * hd.stride + kk + k]) : 0.f;
          },
          at.g, at.t4);
      Tile<T>::mma(s, a, b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + at.g + (e >> 1) * 8, c = c0 + 2 * at.t4 + (e & 1);
      if (r < tp && c < tp) hd.w[r * tp + c] = c < valid_len ? s[e] * scale : -1e30f;
    }
  }
  __syncwarp();
  for (int i = 0; i < 16 && r0 + i < tp; ++i) {
    float* row = hd.w + (r0 + i) * tp;
    float m = -CUDART_INF_F;
    for (int c = at.lane; c < tp; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = at.lane; c < tp; c += 32) l += expf(row[c] - m);
    l = warp_sum(l);
    for (int c = at.lane; c < tp; c += 32) row[c] = expf(row[c] - m) / l;
    __syncwarp();
  }
}

// ---- B: dv = cdt(w)^T g ----
template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
    phase_dv(const T* __restrict__ qkv, const T* __restrict__ gout, T* __restrict__ dqkv,
             float* __restrict__ work, int tp, int d, int heads) {
  constexpr int NO = DH / 8;
  const Where at = where_am_i(0);
  if (at.tile * 16 >= tp) return;
  const Head<T> hd = head_of<T, DH>(qkv, gout, dqkv, work, at, tp, d, heads);
  const int k0 = at.tile * 16;
  float acc[NO][4] = {};
  for (int r0 = 0; r0 < tp; r0 += 16) {
    const auto a = Tile<T>::load_a(  // w^T: rows are keys, depth the queries
        [&](int i, int k) {
          const int c = k0 + i, r = r0 + k;
          return c < tp && r < tp ? hd.w[r * tp + c] : 0.f;
        },
        at.g, at.t4);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const auto b = Tile<T>::load_b(
          [&](int k, int j) {
            const int r = r0 + k;
            return r < tp ? to_f(hd.g[r * static_cast<size_t>(d) + n * 8 + j]) : 0.f;
          },
          at.g, at.t4);
      Tile<T>::mma(acc[n], a, b);
    }
  }
  T* dv = hd.dq + 2 * static_cast<size_t>(d);
#pragma unroll
  for (int n = 0; n < NO; ++n) store_frag(dv, hd.stride, tp, k0, n * 8, acc[n], 1.f, at.g, at.t4);
}

// ---- C: dl = w (dw - rowsum(dw w)) over w, dw = g v^T ----
template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
    phase_dl(const T* __restrict__ qkv, const T* __restrict__ gout, T* __restrict__ dqkv,
             float* __restrict__ work, int tp, int d, int heads) {
  extern __shared__ __align__(16) float dws[];  // [kWarps][16][tp]
  const Where at = where_am_i(0);
  if (at.tile * 16 >= tp) return;
  const Head<T> hd = head_of<T, DH>(qkv, gout, dqkv, work, at, tp, d, heads);
  float* dw = dws + static_cast<size_t>(threadIdx.x >> 5) * 16 * tp;
  const int r0 = at.tile * 16;
  for (int c0 = 0; c0 < tp; c0 += 8) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      const auto a = Tile<T>::load_a(
          [&](int i, int k) {
            const int r = r0 + i;
            return r < tp ? to_f(hd.g[r * static_cast<size_t>(d) + kk + k]) : 0.f;
          },
          at.g, at.t4);
      const auto b = Tile<T>::load_b(
          [&](int k, int n) {
            const int c = c0 + n;
            return c < tp ? to_f(hd.v[c * hd.stride + kk + k]) : 0.f;
          },
          at.g, at.t4);
      Tile<T>::mma(s, a, b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = at.g + (e >> 1) * 8, c = c0 + 2 * at.t4 + (e & 1);
      if (c < tp) dw[i * tp + c] = s[e];
    }
  }
  __syncwarp();
  for (int i = 0; i < 16 && r0 + i < tp; ++i) {
    float* row = hd.w + (r0 + i) * tp;
    const float* dwr = dw + i * tp;
    float dd = 0.f;
    for (int c = at.lane; c < tp; c += 32) dd += dwr[c] * row[c];
    dd = warp_sum(dd);
    for (int c = at.lane; c < tp; c += 32) row[c] = row[c] * (dwr[c] - dd);
  }
}

// ---- D: dq = cdt(dl) k * s (tiles of rows), dk = cdt(dl)^T q * s (keys) ----
template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
    phase_dqdk(const T* __restrict__ qkv, const T* __restrict__ gout, T* __restrict__ dqkv,
               float* __restrict__ work, int tp, int d, int heads, int groups, float scale) {
  constexpr int NO = DH / 8;
  const bool keys = static_cast<int>(blockIdx.x) >= groups;
  const Where at = where_am_i(keys ? -groups * kWarps : 0);
  if (at.tile * 16 >= tp) return;
  const Head<T> hd = head_of<T, DH>(qkv, gout, dqkv, work, at, tp, d, heads);
  const int t0 = at.tile * 16;
  const T* op = keys ? hd.q : hd.k;  // the product's right operand, [Tp][DH]
  float acc[NO][4] = {};
  for (int u0 = 0; u0 < tp; u0 += 16) {
    const auto a = Tile<T>::load_a(
        [&](int i, int k) {  // dl rows (dq), or dl^T (dk)
          const int r = keys ? u0 + k : t0 + i, c = keys ? t0 + i : u0 + k;
          return r < tp && c < tp ? hd.w[r * tp + c] : 0.f;
        },
        at.g, at.t4);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const auto b = Tile<T>::load_b(
          [&](int k, int j) {
            const int u = u0 + k;
            return u < tp ? to_f(op[u * hd.stride + n * 8 + j]) : 0.f;
          },
          at.g, at.t4);
      Tile<T>::mma(acc[n], a, b);
    }
  }
  T* out = hd.dq + (keys ? static_cast<size_t>(d) : 0);
#pragma unroll
  for (int n = 0; n < NO; ++n) store_frag(out, hd.stride, tp, t0, n * 8, acc[n], scale, at.g, at.t4);
}

template <typename T, int DH>
cudaError_t launch_phased(const T* qkv, const T* g, T* dqkv, float* work, int chunk, int batch,
                          int tp, int d, int heads, int valid_len, float scale,
                          cudaStream_t stream) {
  const size_t smem_dl = static_cast<size_t>(kWarps) * 16 * tp * sizeof(float);
  if (smem_dl > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(phase_dl<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_dl));
  if (e != cudaSuccess) return e;
  const int groups = ((tp + 15) / 16 + kWarps - 1) / kWarps;
  const size_t item = static_cast<size_t>(tp) * 3 * d, gitem = static_cast<size_t>(tp) * d;
  for (int b0 = 0; b0 < batch; b0 += chunk) {
    const int n = batch - b0 < chunk ? batch - b0 : chunk;
    const T* q = qkv + b0 * item;
    const T* gb = g + b0 * gitem;
    T* o = dqkv + b0 * item;
    const dim3 grid(groups, heads, n), block(kWarps * 32);
    phase_scores<T, DH><<<grid, block, 0, stream>>>(q, gb, o, work, tp, d, heads, valid_len, scale);
    phase_dv<T, DH><<<grid, block, 0, stream>>>(q, gb, o, work, tp, d, heads);
    phase_dl<T, DH><<<grid, block, smem_dl, stream>>>(q, gb, o, work, tp, d, heads);
    phase_dqdk<T, DH><<<dim3(2 * groups, heads, n), block, 0, stream>>>(q, gb, o, work, tp, d,
                                                                        heads, groups, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* qkv, const void* g, void* dqkv, void* work, int chunk, int batch,
                     int tp, int d, int heads, int valid_len, float scale, cudaStream_t s) {
  const T* q = static_cast<const T*>(qkv);
  const T* gb = static_cast<const T*>(g);
  T* o = static_cast<T*>(dqkv);
  float* w = static_cast<float*>(work);
  switch (d / heads) {
    case 16:
      return launch_phased<T, 16>(q, gb, o, w, chunk, batch, tp, d, heads, valid_len, scale, s);
    case 32:
      return launch_phased<T, 32>(q, gb, o, w, chunk, batch, tp, d, heads, valid_len, scale, s);
    case 64:
      return launch_phased<T, 64>(q, gb, o, w, chunk, batch, tp, d, heads, valid_len, scale, s);
    case 128:
      return launch_phased<T, 128>(q, gb, o, w, chunk, batch, tp, d, heads, valid_len, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace vsd

// qkv, dqkv [B, Tp, 3D] and g [B, Tp, D], all bf16 (f32 == 0) or all f32
// (f32 == 1); g zero on rows >= valid_len; work f32 [chunk * H, Tp, Tp].
// Needs a head dim of 16, 32, 64 or 128, 0 < valid_len <= Tp, chunk and H
// up to 65535 and 4 * 16 * Tp f32 of shared memory (Tp up to 908).  Runs
// the items in chunks of ``chunk``, four launches a chunk, on ``stream``.
// Returns the first CUDA error (0 on success).
extern "C" int vsd_attention_qkv_bwd_phased(const void* qkv, const void* g, void* dqkv,
                                            void* work, int chunk, int f32, int batch, int tp,
                                            int d, int num_heads, int valid_len, float scale,
                                            void* stream) {
  using namespace vsd;
  if (batch <= 0 || chunk <= 0 || chunk > 65535 || tp <= 0 || d <= 0 || num_heads <= 0 ||
      num_heads > 65535 || d % num_heads || valid_len <= 0 || valid_len > tp)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? dispatch<float>(qkv, g, dqkv, work, chunk, batch, tp, d, num_heads, valid_len,
                               scale, s)
             : dispatch<bf16>(qkv, g, dqkv, work, chunk, batch, tp, d, num_heads, valid_len,
                              scale, s);
}

// The whole ViT encoder in one launch, for B = 1 serving, on Hopper:
//
//   encoder-only:  x [B, Tp, D] -> every layer of the per-item pack -> x
//   fold-ends:     patch rows [B, Tp, D] -> patch-embed + aux -> every layer
//                  -> final LN of the CLS row -> anti-spoof head -> logits [B, 2]
//
// Replaces the TPU kernel vit_spoof_detection_pda_tpu/ops/lowlat.py::
// _encoder_kernel (:94; wrappers forward_lowlat_e2e :570 and
// encoder_forward_lowlat :634).
//
// Bound on the H100 at ViT-B, B = 1: the bytes.  One forward reads the 36
// superblocks W [768, 3072] bf16 (169.9 MB) and the 2.0 MB stem/head block,
// 0.051 ms at 3.35 TB/s; its 35.5 GFLOP of products take 0.036 ms at
// 989 TFLOP/s.
//
// Design (a first, simple one; lowlat_core.cuh has the phase loop): one
// cooperative launch of a persistent grid, phases separated by a grid
// barrier -- per layer LN1 | QKV | attention | proj + residual | LN2 |
// fc1 + GELU | fc2 + residual, with the stem before the first layer and two
// head phases after the last.  The B items are computed together (B * Tp
// rows) and every superblock is read from device memory once per launch.
// What the weight stream still waits on: a phase reads its weights only
// after the barrier; a TMA ring prefetching the next phase's weights during
// the current one is later work.
//
// Rounding points follow the TPU kernel: LN, softmax and every sum in f32;
// xn, qkv, the softmax weights, the head outputs, the GELU output and each
// sub-layer's output rounded to bf16 once.  Stem: patches @ W_embed in f32
// plus aux, rounded once.  Head: final LN, a bf16 round trip, head LN (eps
// head_eps), fc1 in f32 against the bf16 weights, erf GELU (erff, where the
// TPU kernel used an A&S rational) rounded to bf16, the two fc2 dot
// products in f32.
#include "lowlat_core.cuh"

namespace vsd {
namespace lowlat {
namespace {

constexpr int kHeadCols = kThreads;  // head fc1 columns a block computes

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red's previous readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// row (f32, in shared memory) <- LN(row) * gamma + beta, in place.
__device__ __forceinline__ void ln_shared(float* row, const float* gamma, const float* beta,
                                          int d, float eps, float* red) {
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) s += row[i];
  const float mu = block_sum(s, red) / static_cast<float>(d);
  float v = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) v += (row[i] - mu) * (row[i] - mu);
  const float inv = 1.0f / sqrtf(block_sum(v, red) / static_cast<float>(d) + eps);
  __syncthreads();  // every thread has read the row
  for (int i = threadIdx.x; i < d; i += kThreads) row[i] = (row[i] - mu) * inv * gamma[i] + beta[i];
  __syncthreads();
}

// Head fc1: for each item, block (item, column tile) recomputes both LNs of
// the CLS row and writes 128 columns of bf16(gelu_erf(f @ W1 + b1)) to h1.
__device__ __forceinline__ void head_fc1_phase(const Params& p, unsigned char* smem) {
  const int d = p.d, h4 = 4 * d, hh = p.hh;
  float* row = reinterpret_cast<float*>(smem);
  float* red = row + d;
  const int ctiles = (hh + kHeadCols - 1) / kHeadCols;
  for (int it = blockIdx.x; it < p.batch * ctiles; it += gridDim.x) {
    const int b = it / ctiles, j = (it % ctiles) * kHeadCols + threadIdx.x;
    __syncthreads();  // the previous item's row readers are done
    const bf16* cls = p.x + static_cast<size_t>(b) * p.tp * d;  // row 0 of item b
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(cls + i));
      row[i] = __bfloat162float(__ushort_as_bfloat16(u));
    }
    __syncthreads();
    ln_shared(row, p.s_end, p.s_end + h4, d, p.eps, red);  // vit.norm
    for (int i = threadIdx.x; i < d; i += kThreads)
      row[i] = __bfloat162float(__float2bfloat16(row[i]));
    __syncthreads();
    ln_shared(row, p.s_end + d, p.s_end + h4 + d, d, p.head_eps, red);  // head.norm
    if (j < hh) {
      const bf16* wcol = p.w_end + d + j;  // column j of the head's fc1
      float acc = 0.f;
      for (int k = 0; k < d; ++k)
        acc += row[k] * __bfloat162float(wcol[static_cast<size_t>(k) * (d + hh)]);
      float h = acc + p.s_end[2 * h4 + j];
      h = 0.5f * h * (1.0f + erff(h * 0.7071067811865476f));
      __stcg(p.h1 + static_cast<size_t>(b) * hh + j, __bfloat162float(__float2bfloat16(h)));
    }
  }
}

// Head fc2: logits[b] = (h1 . fc2[:, 0] + b0, h1 . fc2[:, 1] + b1).
__device__ __forceinline__ void head_fc2_phase(const Params& p, unsigned char* smem) {
  const int d = p.d, h4 = 4 * d, hh = p.hh;
  float* red = reinterpret_cast<float*>(smem);
  for (int b = blockIdx.x; b < p.batch; b += gridDim.x) {
    float l0 = 0.f, l1 = 0.f;
    for (int j = threadIdx.x; j < hh; j += kThreads) {
      const float h = __ldcg(p.h1 + static_cast<size_t>(b) * hh + j);
      l0 += h * p.s_end[2 * d + j];
      l1 += h * p.s_end[h4 + 2 * d + j];
    }
    l0 = block_sum(l0, red);
    l1 = block_sum(l1, red);
    if (threadIdx.x == 0) {
      p.logits[2 * b] = l0 + p.s_end[3 * h4];
      p.logits[2 * b + 1] = l1 + p.s_end[3 * h4 + 1];
    }
  }
}

__global__ void __launch_bounds__(kThreads) lowlat_encoder_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int rows = p.batch * p.tp, d = p.d, h4 = 4 * d;
  const bool fold_ends = p.w_end != nullptr;
  const bf16* cur = p.x_in;
  trace_begin(p);
  if (fold_ends) {  // x = patches @ W_embed + aux
    Gemm stem{};
    stem.a = p.x_in, stem.lda = d, stem.w = p.w_end, stem.ldw = d + p.hh, stem.kc = d;
    stem.aux = p.aux, stem.aux_rows = p.tp, stem.c = p.x, stem.ldc = d;
    stem.m = rows, stem.n = d, stem.k = d;
    gemm_phase<kAux>(p, stem, nullptr, smem);
    grid_sync(p.bar, p.trace);
    cur = p.x;
  }
  for (int l = 0; l < p.depth; ++l) {
    const bf16* w0 = p.w + static_cast<size_t>(3 * l) * d * h4;
    const float* s0 = p.s + static_cast<size_t>(3 * l) * 4 * h4;
    const bf16 *w1 = w0 + static_cast<size_t>(d) * h4, *w2 = w1 + static_cast<size_t>(d) * h4;
    const float *s1 = s0 + 4 * h4, *s2 = s1 + 4 * h4;
    attention_sublayer(p, cur, w0, s0, smem);
    cur = p.x;
    ln_phase(p.x, s1, s1 + h4, p.xn, rows, d, p.eps);
    grid_sync(p.bar, p.trace);
    Gemm fc1{};
    fc1.a = p.xn, fc1.lda = d, fc1.w = w1, fc1.ldw = h4, fc1.kc = d, fc1.bias = s1 + 2 * h4;
    fc1.c = p.hid, fc1.ldc = h4, fc1.m = rows, fc1.n = h4, fc1.k = d;
    gemm_phase<kGelu>(p, fc1, nullptr, smem);
    grid_sync(p.bar, p.trace);
    Gemm fc2{};  // fc2's row chunk c sits in columns cD .. cD + D of w2
    fc2.a = p.hid, fc2.lda = h4, fc2.w = w2, fc2.ldw = h4, fc2.kc = d, fc2.bias = s2;
    fc2.r = p.x, fc2.c = p.x, fc2.ldc = d, fc2.m = rows, fc2.n = d, fc2.k = h4;
    gemm_phase<kRes>(p, fc2, nullptr, smem);
    if (fold_ends || l + 1 < p.depth) grid_sync(p.bar, p.trace);
  }
  if (fold_ends) {
    head_fc1_phase(p, smem);
    grid_sync(p.bar, p.trace);
    head_fc2_phase(p, smem);
  }
  trace_end(p);
}

}  // namespace
}  // namespace lowlat
}  // namespace vsd

// x_in [B, Tp, D] bf16 (fold-ends: patch rows, row 0 zeros); x [B, Tp, D]
// bf16 out; w [3*depth, D, 4D] bf16, s [3*depth, 4, 4D] f32 (the per-item
// pack); w_end [D, D+hh] bf16, s_end [4, 4D] f32, aux [Tp, D] f32 for
// fold-ends (all three null for encoder-only); scratch xn [B*Tp, D],
// qkv [B*Tp, 3D], hid [B*Tp, 4D] bf16, h1 [B, hh] f32; logits [B, 2] f32
// out (fold-ends); bar: 2 + splitk_units 32-bit words; splitk
// [splitk_units, 64, 128] f32 scratch; trace: null, or 64-bit timestamps,
// one per barrier (lowlat_core.cuh).  Needs a head dim of 16, 32 or 64, D
// and Tp multiples of 8, 0 < valid_len <= Tp; fold-ends also hh % 8 == 0
// and 2D + hh <= 4D.  Returns the CUDA error of the launch (0 on success).
extern "C" int vsd_lowlat_encoder(const void* x_in, void* x, const void* w, const void* s,
                                  const void* w_end, const void* s_end, const void* aux,
                                  void* xn, void* qkv, void* hid, void* h1, void* logits,
                                  void* bar, void* splitk, int splitk_units, void* trace,
                                  int depth, int batch, int tp, int d, int heads, int valid_len,
                                  int hh, float eps, float head_eps, float scale, void* stream) {
  using namespace vsd;
  using namespace vsd::lowlat;
  if (splitk_units < 0 || !valid_shape(depth, batch, tp, d, heads, valid_len))
    return cudaErrorInvalidValue;
  const bool fold_ends = w_end != nullptr;
  if (fold_ends && (!s_end || !aux || hh <= 0 || hh % 8 || 2 * d + hh > 4 * d))
    return cudaErrorInvalidValue;
  Params p{};
  p.x_in = static_cast<const bf16*>(x_in);
  p.x = static_cast<bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.s = static_cast<const float*>(s);
  p.xn = static_cast<bf16*>(xn);
  p.qkv = static_cast<bf16*>(qkv);
  p.hid = static_cast<bf16*>(hid);
  p.w_end = static_cast<const bf16*>(w_end);
  p.s_end = static_cast<const float*>(s_end);
  p.aux = static_cast<const float*>(aux);
  p.h1 = static_cast<float*>(h1);
  p.logits = static_cast<float*>(logits);
  p.bar = static_cast<unsigned*>(bar);
  p.tile_count = p.bar + 2;
  p.splitk = static_cast<float*>(splitk);
  p.splitk_units = splitk_units;
  p.trace = static_cast<unsigned long long*>(trace);
  p.depth = depth, p.batch = batch, p.tp = tp, p.d = d, p.heads = heads;
  p.valid_len = valid_len, p.hh = fold_ends ? hh : 0;
  p.eps = eps, p.head_eps = head_eps, p.scale = scale;
  return launch_persistent(reinterpret_cast<const void*>(&lowlat_encoder_kernel), p,
                           static_cast<cudaStream_t>(stream));
}

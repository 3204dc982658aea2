// The persistent phase loop of the whole-encoder kernels (lowlat_encoder.cu,
// lowlat_batchgrid.cu): one cooperative launch walks every layer of the
// ViT encoder, each phase spread over all blocks of a grid that fills the
// card, phases separated by a grid-wide barrier.
//
// The residual stream and every intermediate (xn, qkv, the head outputs,
// the MLP hidden, the batch-grid f32 partial) live in device memory and
// stay in the 50 MB L2 at the batch sizes these kernels serve (the hidden
// is 1.2 MB an item); they are the counterpart of the TPU kernels' VMEM
// scratch.  Data written during the launch is read back through L2 only
// (cp.async.cg, __ldcg): the read-only path would keep stale copies.
//
// Work of a phase is cut into tiles that the grid's blocks take in turn:
//   - LayerNorm: one warp per row (common.cuh layernorm_row);
//   - GEMM: 64 x 128 output tiles, one warpgroup each, wgmma (common.cuh)
//     over a 4-stage cp.async ring that keeps two k-tiles in flight; the
//     weights are read in the packs' layout (W(k, n) at
//     w[(k % kc) * ldw + (k / kc) * kc + n], which also reads fc2's row
//     chunks side by side), with fused f32 epilogues rounded once.  A
//     block streams one k-tile every ~2.5 us, so a phase with few tiles
//     splits each tile's K over several blocks (deterministic split-K,
//     gemm_phase);
//   - int8 weights (the opt-in int8 pack of the per-item kernel: W int8,
//     each column's f32 scale in S row 4): the superblock streams from
//     device memory as int8, 16 bytes of global reads in flight a thread
//     one k-tile ahead in registers, and is converted into the same bf16
//     stage as bf16(float(q) * float(bf16(scale))) (one rounding, the TPU
//     kernel's bf16 product in _wblk); the wgmma path is unchanged;
//   - attention: one 64-row query tile of one (head, item) per block
//     (attention_core.cuh attention_tile), K and V in shared memory.
// So at B = 1 (200 rows, 4 row tiles) a QKV phase has 72 tiles, fc1 96,
// proj and fc2 24.
//
// The barrier: thread 0 of each block arrives on a counter and spins on a
// generation word (release/acquire at GPU scope); the last to arrive resets
// the counter and bumps the generation, so the words are back to (0, g + 1)
// after every barrier.  The C entry point zeroes them before each launch, so
// a launch never depends on the state an earlier one left.  The spin ends
// in __trap() after kBarrierTimeoutNs, so a broken barrier fails loudly
// instead of hanging the card.
//
// Tracing (for measurement; off when Params::trace is null): block 0 writes
// the global timer as it leaves barrier n into trace[n] (trace[0] at the
// start), so trace[n + 1] - trace[n] is phase n plus its barrier.  A traced
// launch first crosses kTraceBarriers empty barriers, which time the bare
// barrier, and ends with one more so the last phase is stamped too.
#pragma once

#include "attention_core.cuh"

namespace vsd {
namespace lowlat {

constexpr int kThreads = 128;  // one warpgroup a block
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64, kBN = 128, kBK = 64, kStages = 4;
constexpr int kAStage = kBM * kBK, kWStage = kBN * kBK;  // elements
constexpr size_t kGemmSmem = static_cast<size_t>(kStages) * (kAStage + kWStage) * sizeof(bf16);
constexpr size_t kSmemAlign = 1024;  // the 128-byte swizzle's period
constexpr unsigned long long kBarrierTimeoutNs = 4000000000ull;
constexpr int kTraceBarriers = 4;
constexpr int kMaxSplit = 8;       // split-K slices of a GEMM tile, at most

// Dynamic shared memory of a block: the GEMM ring, or one head's K and V,
// or the head phase's row, whichever is largest (plus alignment slack).
inline size_t smem_bytes(int tp, int dh, int d) {
  size_t s = kGemmSmem;
  if (att_smem_bytes(tp, dh) > s) s = att_smem_bytes(tp, dh);
  if ((d + 32) * sizeof(float) > s) s = (d + 32) * sizeof(float);
  return s + kSmemAlign;
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  return raw + ((kSmemAlign - (base & (kSmemAlign - 1))) & (kSmemAlign - 1));
}

// ---------------------------------------------------------------------------
// Grid barrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// bar[0]: blocks arrived at the current barrier; bar[1]: its generation
// (the number of barriers crossed in this launch).
__device__ __noinline__ void grid_sync(unsigned* bar, unsigned long long* trace) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);
    __threadfence();  // this block's writes before its arrival
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      st_release(bar + 1, gen + 1);
    } else {
      const unsigned long long t0 = global_ns();
      while (ld_acquire(bar + 1) == gen) {
        __nanosleep(32);
        if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
      }
    }
    __threadfence();
    if (trace && blockIdx.x == 0) trace[gen + 1] = global_ns();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// LayerNorm phase
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ln_phase(const bf16* x, const float* gamma, const float* beta,
                                         bf16* out, int rows, int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = blockIdx.x * kWarps + warp; r < rows; r += gridDim.x * kWarps)
    layernorm_row<false, true>(x + static_cast<size_t>(r) * d, gamma, beta,
                         out + static_cast<size_t>(r) * d, nullptr, nullptr, d, eps, lane);
}

// ---------------------------------------------------------------------------
// GEMM phase
// ---------------------------------------------------------------------------

// Epilogues, in f32, rounded to bf16 once (kF32 stores f32):
enum {
  kBias = 0,     // acc + bias
  kGelu = 1,     // gelu_tanh(acc + bias)
  kRes = 2,      // (r + acc) + bias
  kAux = 3,      // acc + aux[row % aux_rows]
  kF32 = 4,      // acc, f32
  kResPart = 5,  // (r + (part + acc)) + bias
};

// What both kernels take; the fold-ends fields are used by the per-item one.
struct Params {
  const bf16* x_in;  // the input stream [B*Tp, D] (fold-ends: the patch rows)
  bf16* x;           // the residual stream and output [B*Tp, D]
  const bf16* w;     // packs W [3*depth, D, 4D], S [3*depth, 4, 4D]
  const float* s;
  const int8_t* wq;  // or the per-item kernel's int8 pack in place of w, with
                     // S [3*depth, 5, 4D] (the columns' scales as row 4)
  bf16* xn;          // [B*Tp, D]: LN output, then the head outputs
  bf16* qkv;         // [B*Tp, 3D]
  bf16* hid;         // [B*Tp, 4D]
  float* part;       // [B*Tp, D] (batch-grid)
  const bf16* w_end; // fold-ends: [D, D+Hh], [4, 4D], [Tp, D]
  const float* s_end;
  const float* aux;
  float* h1;         // [B, Hh]
  float* logits;     // [B, 2]
  unsigned* bar;     // [2]: the grid barrier
  unsigned* tile_count;       // [splitk_units]: split-K arrivals per tile
  float* splitk;              // [splitk_units, 64, 128]: split-K partials
  int splitk_units;
  unsigned long long* trace;  // per-barrier timestamps, or null
  int depth, batch, tp, d, heads, valid_len, hh;
  float eps, head_eps, scale;
};

// C[m, n] = epilogue(A[m, :] @ W[:, n]) for m < M, n < N over K.
struct Gemm {
  const bf16* a;
  int lda;
  const bf16* w;  // W(k, n) = w[(k % kc) * ldw + (k / kc) * kc + n]
  int ldw, kc;
  const int8_t* wq;     // int8 W in the same layout in place of w, or null,
  const float* wscale;  // with W(k, n)'s scale at wscale[(k / kc) * kc + n]
  const float* bias;  // [N]
  const float* aux;   // [aux_rows, N]
  int aux_rows;
  const bf16* r;      // residual, row stride ldc (may alias c)
  const float* part;  // f32 partial, row stride ldc
  bf16* c;
  float* cf;          // kF32 output, row stride ldc
  int ldc;
  int m, n, k;
};

__device__ __forceinline__ int gemm_tiles(const Gemm& g) {
  return ((g.m + kBM - 1) / kBM) * ((g.n + kBN - 1) / kBN);
}

// The epilogue of one element pair (row, col), (row, col + 1) of C.
template <int EPI>
__device__ __forceinline__ void epilogue(const Gemm& g, int row, int col, float v0, float v1) {
  const size_t off = static_cast<size_t>(row) * g.ldc + col;
  if (EPI == kF32) {
    __stcg(reinterpret_cast<float2*>(g.cf + off), make_float2(v0, v1));
    return;
  }
  if (EPI == kAux) {
    const float2 x = *reinterpret_cast<const float2*>(
        g.aux + static_cast<size_t>(row % g.aux_rows) * g.n + col);
    v0 += x.x;
    v1 += x.y;
  } else {
    const float2 bb = *reinterpret_cast<const float2*>(g.bias + col);
    if (EPI == kRes || EPI == kResPart) {
      if (EPI == kResPart) {
        const float2 p = __ldcg(reinterpret_cast<const float2*>(g.part + off));
        v0 = p.x + v0;
        v1 = p.y + v1;
      }
      const unsigned ru = __ldcg(reinterpret_cast<const unsigned*>(g.r + off));
      const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ru));
      v0 = (r.x + v0) + bb.x;
      v1 = (r.y + v1) + bb.y;
    } else {
      v0 += bb.x;
      v1 += bb.y;
      if (EPI == kGelu) {
        v0 = gelu_tanh(v0);
        v1 = gelu_tanh(v1);
      }
    }
  }
  const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
  __stcg(reinterpret_cast<unsigned*>(g.c + off), *reinterpret_cast<const unsigned*>(&o));
}

// The wgmma accumulator's element pairs: thread t holds, for column group j
// and half h, acc[4j + 2h .. + 1] at tile row (t / 32) * 16 + (t % 32) / 4
// + 8h and tile columns 8j + 2 (t % 4) .. + 1.
__device__ __forceinline__ int frag_row(int h) {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + h * 8;
}
__device__ __forceinline__ int frag_col(int j) { return j * 8 + (threadIdx.x & 3) * 2; }

__device__ __forceinline__ void tile_origin(const Gemm& g, int tile, int& m0, int& n0) {
  const int mtiles = (g.m + kBM - 1) / kBM;
  // consecutive tiles share a weight column tile, which then stays in L2
  m0 = (tile % mtiles) * kBM;
  n0 = (tile / mtiles) * kBN;
}

// Eight int8 weights (one 8-byte chunk) times their columns' scales, as
// bf16: bf16(float(q) * float(bf16(s))), exact in f32 before the one
// rounding (|q| <= 127 times an 8-bit mantissa).
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint4 dequant8(uint2 raw, float4 s0, float4 s1) {
  const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  uint32_t out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t word = j < 2 ? raw.x : raw.y;
    const int sh = (j & 1) * 16;
    const float lo = static_cast<float>(static_cast<int8_t>((word >> sh) & 0xffu));
    const float hi = static_cast<float>(static_cast<int8_t>((word >> (sh + 8)) & 0xffu));
    out[j] = pack_bf16x2(lo * bf16_round(sc[2 * j]), hi * bf16_round(sc[2 * j + 1]));
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// k-tiles kt0 .. kt1 of one 64 x 128 output tile: the epilogue into C, or,
// with a split-K slot, the f32 partial sums into it ([64][128] row-major).
// Q8: the weights come from the int8 pack (g.wq), converted in the stage;
// a template parameter, so the bf16 path holds no int8 registers.
template <int EPI, bool Q8>
__device__ __forceinline__ void gemm_tile(const Gemm& g, int tile, int kt0, int kt1, bf16* As,
                                          bf16* Ws, float* slot) {
  int m0, n0;
  tile_origin(g, tile, m0, n0);
  const int tid = threadIdx.x;

  auto load_tile = [&](int stage, int kt) {  // bf16: A and W by cp.async
    const int k0 = kt * kBK;
    bf16* as = As + stage * kAStage;
    bf16* ws = Ws + stage * kWStage;
#pragma unroll
    for (int i = 0; i < kBM * 8 / kThreads; ++i) {  // row r, chunk ch
      const int c = tid + i * kThreads, r = c >> 3, ch = c & 7;
      bf16* dst = as + r * 64 + ((ch ^ (r & 7)) << 3);
      if (m0 + r < g.m && k0 + ch * 8 < g.k)
        cp_async16(dst, g.a + static_cast<size_t>(m0 + r) * g.lda + k0 + ch * 8);
      else
        store_zero16(dst);
    }
#pragma unroll
    for (int i = 0; i < kBN * 8 / kThreads; ++i) {  // column block nb, k-row kr, chunk ch
      const int c = tid + i * kThreads, nb = c >> 9, kr = (c >> 3) & 63, ch = c & 7;
      bf16* dst = ws + nb * 64 * 64 + kr * 64 + ((ch ^ (kr & 7)) << 3);
      const int k = k0 + kr, col = n0 + nb * 64 + ch * 8;
      if (k < g.k && col < g.n)
        cp_async16(dst, g.w + static_cast<size_t>(k % g.kc) * g.ldw +
                            static_cast<size_t>(k / g.kc) * g.kc + col);
      else
        store_zero16(dst);
    }
  };
  // int8: A by cp.async as above; the k-tile's W bytes into registers
  // (in flight until put_w), then converted with their columns' scales
  // into the stage's swizzled slots
  auto load_a = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    bf16* as = As + stage * kAStage;
#pragma unroll
    for (int i = 0; i < kBM * 8 / kThreads; ++i) {
      const int c = tid + i * kThreads, r = c >> 3, ch = c & 7;
      bf16* dst = as + r * 64 + ((ch ^ (r & 7)) << 3);
      if (m0 + r < g.m && k0 + ch * 8 < g.k)
        cp_async16(dst, g.a + static_cast<size_t>(m0 + r) * g.lda + k0 + ch * 8);
      else
        store_zero16(dst);
    }
  };
  uint2 wreg[kBN * 8 / kThreads];
  auto fetch_w = [&](int kt) {
#pragma unroll
    for (int i = 0; i < kBN * 8 / kThreads; ++i) {
      const int c = tid + i * kThreads, nb = c >> 9, kr = (c >> 3) & 63, ch = c & 7;
      const int k = kt * kBK + kr, col = n0 + nb * 64 + ch * 8;
      wreg[i] = (k < g.k && col < g.n)
                    ? __ldg(reinterpret_cast<const uint2*>(
                          g.wq + static_cast<size_t>(k % g.kc) * g.ldw +
                          static_cast<size_t>(k / g.kc) * g.kc + col))
                    : make_uint2(0u, 0u);
    }
  };
  auto put_w = [&](int stage, int kt) {
    bf16* ws = Ws + stage * kWStage;
#pragma unroll
    for (int i = 0; i < kBN * 8 / kThreads; ++i) {
      const int c = tid + i * kThreads, nb = c >> 9, kr = (c >> 3) & 63, ch = c & 7;
      bf16* dst = ws + nb * 64 * 64 + kr * 64 + ((ch ^ (kr & 7)) << 3);
      const int k = kt * kBK + kr, col = n0 + nb * 64 + ch * 8;
      if (k < g.k && col < g.n) {
        const float* sc = g.wscale + (k / g.kc) * g.kc + col;
        *reinterpret_cast<uint4*>(dst) =
            dequant8(wreg[i], __ldg(reinterpret_cast<const float4*>(sc)),
                     __ldg(reinterpret_cast<const float4*>(sc + 4)));
      } else {
        store_zero16(dst);
      }
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  __syncthreads();  // the ring's previous readers are done
  if constexpr (Q8) {
    load_a(0, kt0);
    fetch_w(kt0);
    put_w(0, kt0);
    cp_async_commit();
    if (kt0 + 1 < kt1) {
      load_a(1, kt0 + 1);
      fetch_w(kt0 + 1);
      put_w(1, kt0 + 1);
    }
    cp_async_commit();
    if (kt0 + 2 < kt1) fetch_w(kt0 + 2);
  } else {
    load_tile(0, kt0);
    cp_async_commit();
    if (kt0 + 1 < kt1) load_tile(1, kt0 + 1);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    cp_async_wait<1>();  // tile kt has landed (this thread's part) ...
    fence_proxy_async(); // (and, int8, this thread's stores reach wgmma)
    __syncthreads();     // ... everyone's, and wgmma kt - 2 has retired
    if constexpr (Q8) {
      if (kt + 2 < kt1) {
        load_a((i + 2) % kStages, kt + 2);
        put_w((i + 2) % kStages, kt + 2);
        if (kt + 3 < kt1) fetch_w(kt + 3);
      }
    } else {
      if (kt + 2 < kt1) load_tile((i + 2) % kStages, kt + 2);
    }
    cp_async_commit();

    const bf16* as = As + (i % kStages) * kAStage;
    const bf16* ws = Ws + (i % kStages) * kWStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n128k16(acc, gmma_desc(as + kk * 16, 16, 1024),
                       gmma_desc(ws + kk * 16 * 64, 8192, 1024));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();

#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(h), c = frag_col(j);
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (slot) {
        __stcg(reinterpret_cast<float2*>(slot + r * kBN + c), make_float2(v0, v1));
      } else if (m0 + r < g.m && n0 + c < g.n) {
        epilogue<EPI>(g, m0 + r, n0 + c, v0, v1);
      }
    }
  }
}

// The split-K fixup of one tile: its `split` partial slots summed in slot
// order (so the result does not depend on which unit came last), every
// load of a slot in flight at once, then the epilogue.
template <int EPI>
__device__ __forceinline__ void reduce_tile(const Gemm& g, int tile, const float* slots,
                                            int split) {
  int m0, n0;
  tile_origin(g, tile, m0, n0);
  float2 v[kBN / 4];
#pragma unroll
  for (int i = 0; i < kBN / 4; ++i)  // i = 2j + h
    v[i] = __ldcg(reinterpret_cast<const float2*>(slots + frag_row(i & 1) * kBN +
                                                  frag_col(i >> 1)));
  for (int s = 1; s < split; ++s) {
    const float* slot = slots + static_cast<size_t>(s) * kBM * kBN;
#pragma unroll
    for (int i = 0; i < kBN / 4; ++i) {
      const float2 q = __ldcg(reinterpret_cast<const float2*>(slot + frag_row(i & 1) * kBN +
                                                              frag_col(i >> 1)));
      v[i].x += q.x;
      v[i].y += q.y;
    }
  }
#pragma unroll
  for (int i = 0; i < kBN / 4; ++i) {
    const int r = frag_row(i & 1), c = frag_col(i >> 1);
    if (m0 + r < g.m && n0 + c < g.n) epilogue<EPI>(g, m0 + r, n0 + c, v[i].x, v[i].y);
  }
}

// One unit of a GEMM phase: slice sl of tile t (of `split`), the fixup by
// the tile's last unit to arrive.
template <int EPI, bool Q8>
__device__ __forceinline__ void gemm_unit(const Params& p, const Gemm& g, int t, int tile,
                                          int sl, int split, int ktiles, bf16* As, bf16* Ws,
                                          unsigned* last) {
  if (split == 1) {
    gemm_tile<EPI, Q8>(g, tile, 0, ktiles, As, Ws, nullptr);
    return;
  }
  float* slots = p.splitk + static_cast<size_t>(t) * split * kBM * kBN;
  gemm_tile<EPI, Q8>(g, tile, sl * ktiles / split, (sl + 1) * ktiles / split, As, Ws,
                 slots + static_cast<size_t>(sl) * kBM * kBN);
  __threadfence();  // this unit's partials before its arrival
  __syncthreads();
  if (threadIdx.x == 0)
    *last = atomicAdd(p.tile_count + t, 1u) == static_cast<unsigned>(split - 1);
  __syncthreads();
  if (*last) {
    __threadfence();
    reduce_tile<EPI>(g, tile, slots, split);
    if (threadIdx.x == 0) p.tile_count[t] = 0;  // clean for the next phase
  }
}

// Every tile of up to two GEMMs of one phase (both of the same K), spread
// over the grid.  Where the phase has fewer tiles than the grid has blocks,
// each tile's k-tiles are split into up to kMaxSplit contiguous slices of
// at least two k-tiles, so that more blocks stream weights at once; every
// (tile, slice) unit writes f32 partials, and the last unit of a tile to
// arrive (a per-tile counter) sums them and applies the epilogue.  This
// changes the f32 summation order only, and repeats bit for bit.  kQ8: the
// phase's weights are the int8 pack (g0.wq; one GEMM a phase), a template
// parameter so that a bf16 kernel compiles no int8 path.
template <int EPI, bool kQ8 = false>
__device__ __forceinline__ void gemm_phase(const Params& p, const Gemm& g0, const Gemm* g1,
                                           unsigned char* smem) {
  __shared__ unsigned last;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = As + kStages * kAStage;
  const int t0 = gemm_tiles(g0), total = t0 + (g1 ? gemm_tiles(*g1) : 0);
  const int ktiles = (g0.k + kBK - 1) / kBK;
  const int room = min(static_cast<int>(gridDim.x), p.splitk_units) / total;
  const int split = max(1, min(min(ktiles / 2, kMaxSplit), room));
  if constexpr (kQ8) {
    for (int u = blockIdx.x; u < total * split; u += gridDim.x)
      gemm_unit<EPI, true>(p, g0, u / split, u / split, u % split, split, ktiles, As, Ws,
                           &last);
    return;
  }
  for (int u = blockIdx.x; u < total * split; u += gridDim.x) {
    const int t = u / split, sl = u % split;
    if (t < t0)
      gemm_unit<EPI, false>(p, g0, t, t, sl, split, ktiles, As, Ws, &last);
    else
      gemm_unit<EPI, false>(p, *g1, t, t - t0, sl, split, ktiles, As, Ws, &last);
  }
}

// ---------------------------------------------------------------------------
// Attention phase
// ---------------------------------------------------------------------------

template <int DH>
__device__ __forceinline__ void attention_phase_dh(const bf16* qkv, bf16* out, int batch,
                                                   int tp, int d, int heads, int valid_len,
                                                   float scale, unsigned char* smem) {
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + att_keys(tp) * (DH + 8);
  const int qtiles = (tp + kWarps * 16 - 1) / (kWarps * 16);
  const int items = batch * heads * qtiles;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int q = it % qtiles, h = (it / qtiles) % heads, b = it / (qtiles * heads);
    __syncthreads();  // the previous tile's K and V reads are done
    attention_tile<DH, true>(qkv, out, tp, d, valid_len, scale, q * kWarps * 16, h, b, Ks, Vs);
  }
}

__device__ __forceinline__ void attention_phase(const bf16* qkv, bf16* out, int batch, int tp,
                                                int d, int heads, int valid_len, float scale,
                                                unsigned char* smem) {
  switch (d / heads) {
    case 16:
      attention_phase_dh<16>(qkv, out, batch, tp, d, heads, valid_len, scale, smem);
      break;
    case 32:
      attention_phase_dh<32>(qkv, out, batch, tp, d, heads, valid_len, scale, smem);
      break;
    default:
      attention_phase_dh<64>(qkv, out, batch, tp, d, heads, valid_len, scale, smem);
      break;
  }
}

// ---------------------------------------------------------------------------
// The encoder's shared parts
// ---------------------------------------------------------------------------

// x <- cur + proj(MHA(LN1(cur))) for superblock w0 / s0 (step 3l), ending
// with a barrier.  cur is x itself after the first layer.
// With the int8 pack (kQ8), q0 is the step's int8 superblock and sc0 its
// scale row (both null for bf16).
template <bool kQ8>
__device__ __forceinline__ void attention_sublayer(const Params& p, const bf16* cur,
                                                   const bf16* w0, const int8_t* q0,
                                                   const float* sc0, const float* s0,
                                                   unsigned char* smem) {
  const int rows = p.batch * p.tp, d = p.d, h4 = 4 * d;
  ln_phase(cur, s0, s0 + h4, p.xn, rows, d, p.eps);
  grid_sync(p.bar, p.trace);
  Gemm qkv{};
  qkv.a = p.xn, qkv.lda = d, qkv.w = w0, qkv.ldw = h4, qkv.kc = d, qkv.bias = s0 + 2 * h4;
  qkv.wq = q0, qkv.wscale = sc0;
  qkv.c = p.qkv, qkv.ldc = 3 * d, qkv.m = rows, qkv.n = 3 * d, qkv.k = d;
  gemm_phase<kBias, kQ8>(p, qkv, nullptr, smem);
  grid_sync(p.bar, p.trace);
  attention_phase(p.qkv, p.xn, p.batch, p.tp, d, p.heads, p.valid_len, p.scale, smem);
  grid_sync(p.bar, p.trace);
  Gemm proj{};
  proj.a = p.xn, proj.lda = d, proj.w = w0 + 3 * d, proj.ldw = h4, proj.kc = d;
  proj.bias = s0 + 3 * h4, proj.r = cur, proj.c = p.x, proj.ldc = d;
  if (q0) proj.wq = q0 + 3 * d, proj.wscale = sc0 + 3 * d;
  proj.m = rows, proj.n = d, proj.k = d;
  gemm_phase<kRes, kQ8>(p, proj, nullptr, smem);
  grid_sync(p.bar, p.trace);
}

// Device side: the start and end of a traced launch (no-ops untraced).
__device__ __forceinline__ void trace_begin(const Params& p) {
  if (!p.trace) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) p.trace[0] = global_ns();
  for (int i = 0; i < kTraceBarriers; ++i) grid_sync(p.bar, p.trace);
}

__device__ __forceinline__ void trace_end(const Params& p) {
  if (p.trace) grid_sync(p.bar, p.trace);
}

// Host side: the cooperative launch of a persistent kernel on every SM,
// as many blocks to an SM as fit.  Returns the launch's error.
inline cudaError_t launch_persistent(const void* kernel, Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.tp, p.d / p.heads, p.d);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // the barrier words and the split-K counters start at zero
  if ((e = cudaMemsetAsync(p.bar, 0, (2 + p.splitk_units) * sizeof(unsigned), stream)) !=
      cudaSuccess)
    return e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, dim3(sms * per_sm), dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Host side: the checks both entry points share.
inline bool valid_shape(int depth, int batch, int tp, int d, int heads, int valid_len) {
  if (depth <= 0 || batch <= 0 || tp <= 0 || tp % 8 || d <= 0 || d % 8 || heads <= 0 ||
      d % heads || valid_len <= 0 || valid_len > tp)
    return false;
  const int dh = d / heads;
  return dh == 16 || dh == 32 || dh == 64;
}

}  // namespace lowlat
}  // namespace vsd

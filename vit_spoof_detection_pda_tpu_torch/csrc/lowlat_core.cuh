// The persistent phase loop of the whole-encoder kernels (lowlat_encoder.cu,
// lowlat_batchgrid.cu): one cooperative launch walks every layer of the
// ViT encoder, one block on every SM, phases separated by a grid barrier.
//
// The residual stream and every intermediate (xn, qkv, the head outputs,
// the MLP hidden, the split-K partial sums) live in device memory and stay
// in the 50 MB L2 at the batch sizes these kernels serve; they are the
// counterpart of the TPU kernels' VMEM scratch.  Data written during the
// launch is read back through L2 only (TMA, cp.async.cg, __ldcg); before
// each barrier every writer orders its stores for the next phase's TMA
// reads (fence.proxy.async.global).
//
// A block is two consumer warpgroups and a producer warpgroup (384
// threads, 225-226 KB of shared memory):
//   - the producer streams the weights.  The weights never depend on the
//     activations, so it walks the launch's GEMM phases on its own, never
//     waits at a grid barrier, and keeps a ring of 16 weight tiles (64 k x
//     64 n, 8 KB) full with TMA loads (cp.async.bulk.tensor over a tensor
//     map of the pack, 128-byte swizzle, L2 evict-first, completion on an
//     mbarrier): a phase's first weights are on chip while the grid still
//     waits at the barrier before it.  bf16: one warp, one thread issuing.
//     int8 pack: the tile lands as int8 bytes with its 64 column scales
//     beside it (a bulk copy; 6 landing slots) and the whole warpgroup
//     converts it into a bf16 slot of a 12-tile ring as bf16(float(q) *
//     float(bf16(scale))), the TPU kernel's _wblk rounding; everything
//     after the ring is the bf16 path;
//   - the consumers run every phase.  A GEMM unit is 128 output columns
//     (64 a warpgroup: m64n64k16 wgmma on its ring tile of each k-step's
//     pair), up to two 64-row m-tiles (A staged once for both warpgroups
//     through a 6-stage TMA ring over 3-D maps of the activations, so k past
//     a K chunk lands as zeros) and a slice of K.  A GEMM followed by a row
//     phase (proj, fc2) splits K (at most 8 slices) so that its units fill
//     the grid and writes f32 partial sums, one slot a slice; the row phase
//     after it sums the slots in slot order (the result does not depend on
//     which unit finished first), adds the bias and the residual, rounds
//     once, and runs the LayerNorm of the next sub-layer on the rounded row
//     (a thread per 8 columns, the LN's sums warp by warp in shared
//     memory).  QKV, fc1 and the stem have no row phase after them: they
//     split M instead and run their epilogue directly.  lowlat_plan
//     (ops/lowlat.py) mirrors make_plan below;
//   - attention: a unit is two 16-row query groups of one (item, head), four
//     warps to a group splitting its keys, over K and V of the head in
//     shared memory (whole up to 208 keys at head dim 64, else in key
//     tiles, both passes reloading them).
// Per layer: ln1 (the previous fc2's fixup + LN1) | qkv | attention | proj
// | ln2 (proj's fixup + LN2) | fc1 | fc2, and one row phase at the end
// (fixup) or the head (fold-ends).
//
// The barrier: consumer thread 0 of each block adds one to a counter of
// the launch's arrivals (after a fence) and spins until it reaches the
// barrier's multiple of the grid (acquire at GPU scope); the arrival that
// completes a barrier publishes it.  The C entry point zeroes the counter
// before each launch.  Every spin (the barrier, an mbarrier) ends in
// __trap() after kTimeoutNs, so a broken wait fails loudly instead of
// hanging the card.
//
// Tracing (for measurement; off when Params::trace is null): block 0 writes
// the global timer as it leaves barrier n into trace[n] (trace[0] at the
// start), so trace[n + 1] - trace[n] is phase n plus its barrier.  A traced
// launch first crosses kTraceBarriers empty barriers, which time the bare
// barrier, and ends with one more so the last phase is stamped too.  With
// unit stamps (Params::unit_base > 0) every block's consumer thread 0 also
// writes, for its first unit of each phase, kUnitStamps timer values at
// trace[unit_base + (phase * grid + block) * kUnitStamps]: 0 the unit's
// start, 1 its first A and weight tiles ready, 2 its k-loop done, 3 its
// epilogue stored, 4 the block's work in the phase done, 5 (the producer)
// the phase's first weight load issued (attention: 1 K and V landed, 2 the
// row stats combined, 3 P V done).
#pragma once

#include <type_traits>

#include "attention_core.cuh"
#include "tma.cuh"  // mbarriers, TMA loads, encode_tiled

namespace vsd {
namespace lowlat {

constexpr int kCons = 256;            // consumer threads: two warpgroups
constexpr int kThreads = kCons + 128;  // and a producer warpgroup
constexpr int kCWarps = kCons / 32;
constexpr int kBM = 64, kBK = 64;
constexpr int kBN = 128;              // a unit's columns: 64 a consumer warpgroup
constexpr int kMtUnit = 2;            // m-tiles of a GEMM unit, at most
constexpr int kAStages = 6;           // the A ring, in k-steps
constexpr int kTileBytes = 64 * 64 * 2;
constexpr int kARegion = kAStages * kMtUnit * kTileBytes;  // 96 KB
constexpr int kLand = 6;              // int8 landing slots: a tile, its 64 scales
constexpr int kLandTile = 64 * 64;
constexpr int kLandBytes = kLandTile + 64 * 4;
constexpr int kMaxSplit = 8;
constexpr size_t kSmemAlign = 1024;   // the 128-byte swizzle's period
constexpr int kTraceBarriers = 4;
constexpr int kUnitStamps = 6;

__host__ __device__ constexpr int w_stages(bool q8) { return q8 ? 12 : 16; }


__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// The plan: how each phase is cut into units (host and device agree; the
// host fills it into Params, and ops/lowlat.py::lowlat_plan mirrors it)
// ---------------------------------------------------------------------------

struct GemmPlan {
  int slabs0, slabs;  // 128-column slabs of segment 0, of both segments
  int mtiles, mgroups, mtpg;  // 64-row m-tiles; m-groups of mtpg m-tiles
  int tpc, ktiles, ksplit;    // k-tiles per K chunk, in all; K slices
  int units;
};

// M rows, N columns (the first nseg from segment 0), K = nchunks chunks of
// kc.  split: a row phase follows, so K may be split into partial sums.
__host__ __device__ inline GemmPlan plan_gemm(int m, int n, int nseg, int kc, int nchunks,
                                              bool split, int grid) {
  GemmPlan g{};
  g.slabs0 = cdiv(nseg, kBN);
  g.slabs = g.slabs0 + cdiv(n - nseg, kBN);
  g.mtiles = cdiv(m, kBM);
  g.tpc = cdiv(kc, kBK);
  g.ktiles = nchunks * g.tpc;
  const int minmg = cdiv(g.mtiles, kMtUnit);
  int mg;
  if (split) {
    mg = minmg;
    const int cap = g.ktiles < kMaxSplit ? g.ktiles : kMaxSplit;
    const int ks = grid / (g.slabs * mg);
    g.ksplit = ks < 1 ? 1 : (ks > cap ? cap : ks);
  } else {
    g.ksplit = 1;
    mg = grid / g.slabs;
    mg = mg < minmg ? minmg : (mg > g.mtiles ? g.mtiles : mg);
  }
  g.mtpg = cdiv(g.mtiles, mg);
  g.mgroups = cdiv(g.mtiles, g.mtpg);
  g.units = g.slabs * g.mgroups * g.ksplit;
  return g;
}

struct Plan {
  int grid, w_stages, smem;
  GemmPlan stem, qkv, proj, fc1, fc2;
  int att_chunks, att_gpc, att_units, att_key_tile, att_key_tiles;
  int head_cgroups, head_units;
  int phases;
  long long splitk_floats;
  int bar_words;
};

// ---------------------------------------------------------------------------
// What both kernels take
// ---------------------------------------------------------------------------

struct Params {
  CUtensorMap wmap;  // the pack: [3*depth*D rows, 4D columns], bf16 or int8
  CUtensorMap emap;  // fold-ends: w_end [D rows, D + hh columns], bf16
  CUtensorMap amap[3];  // the A operands [M rows, chunks, kc]: xn, hid, x_in
  const bf16* x_in;  // the input stream [B*Tp, D] (fold-ends: the patch rows)
  bf16* x;           // the residual stream and output [B*Tp, D]
  const float* s;    // S [3*depth, 4 (int8: 5), 4D]
  bf16* xn;          // [B*Tp, D]: LN output, then the head outputs
  bf16* qkv;         // [B*Tp, 3D]
  bf16* hid;         // [B*Tp, 4D]
  float* part;       // split-K partial sums [slots, B*Tp, D]
  const bf16* w_end; // fold-ends: [D, D+Hh], [4, 4D], [Tp, D]
  const float* s_end;
  const float* aux;
  float* h1;         // [B, Hh]
  float* logits;     // [B, 2]
  unsigned* bar;     // [1 + B]: the grid barrier's count, the head's item counters
  unsigned long long* trace;  // per-barrier timestamps, or null
  int unit_base;              // > 0: unit stamps from trace[unit_base]
  int depth, batch, tp, d, heads, valid_len, hh;
  int batch_grid, fold_ends, srows;
  float eps, head_eps, scale;
  Plan plan;
};

// ---------------------------------------------------------------------------
// Timers, barriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Named barriers (tma.cuh named_sync): 1 = every consumer, 2 + w = consumer
// warpgroup w.
__device__ __forceinline__ void cons_sync() { named_sync(1, kCons); }

// ---------------------------------------------------------------------------
// Shared memory: [A region | descriptors | mbarriers | pad | weight ring |
// int8 landing slots], from the dynamic region aligned to 1024 bytes
// ---------------------------------------------------------------------------

// Epilogues, in f32, rounded to bf16 once (kPart stores the f32 slice sum):
enum {
  kBias = 0,  // acc + bias
  kGelu = 1,  // gelu_tanh(acc + bias)
  kAux = 2,   // acc + aux[row % aux_rows]
  kPart = 3,  // the slice's f32 partial sum into slot ks
};

// C[m, n] = epilogue(A[m, :] @ W[:, n]).  K is nchunks chunks of kc: chunk c
// of A's columns meets rows row + (k % kc) of the map at columns col + (c' *
// kc) + n, where (row, col) is segment 0's (row0, col0) or, for chunks >=
// kseg (c' = c - kseg) or output columns >= nseg (n - nseg), segment 1's.
struct Gemm {
  int amap;  // the A operand's map in Params::amap
  int m, n, nseg, kc, nchunks, kseg;
  int row0, row1, col0, col1;
  const float *bias0, *bias1;  // per output column of the segment
  const float *sc0, *sc1;      // int8: the step's scale row, by map column
  int end_map;                 // the stem: w_end's map (bf16)
  const float* aux;
  int aux_rows;
  bf16* c;
  int ldc;
  float* part;
  GemmPlan pl;
};

// A row phase: x = bf16((res + the `slots` partial slots summed in slot
// order) + bias) written to out (when part is given; else the row is read
// from res), then xn = LN(x) (when gamma is given).
struct RowJob {
  const float* part;
  int slots;
  const bf16* res;
  const float* bias;
  bf16* out;
  const float *gamma, *beta;
  bf16* xn;
};

// What a phase reads of its job, in shared memory: the body writes it
// before the phase (the consumers' by thread 0, the producer's GEMM by its
// lane 0), so that no phase reads it from local memory, which beside 230 KB
// of shared memory has almost no L1 left.
struct Desc {
  Gemm g[2];  // the consumers', the producer's
  RowJob r;
  unsigned epoch;  // grid barriers this block has crossed
};

constexpr int kDescBytes = 512;
static_assert(sizeof(Desc) <= kDescBytes, "the descriptors outgrow their room");
constexpr int kMaxStages = 16;
constexpr int kWRing =
    (kARegion + kDescBytes + (2 * kMaxStages + kLand + kAStages) * 8 + 1023) / 1024 * 1024;

__host__ __device__ constexpr size_t smem_bytes(bool q8) {
  return kWRing + static_cast<size_t>(w_stages(q8)) * kTileBytes +
         (q8 ? kLand * kLandBytes : 0) + kSmemAlign;
}

extern __shared__ unsigned char lowlat_smem[];

__device__ __forceinline__ unsigned char* smem_base() {
  const uint32_t base = smem_addr(lowlat_smem);
  return lowlat_smem + ((kSmemAlign - (base & (kSmemAlign - 1))) & (kSmemAlign - 1));
}
__device__ __forceinline__ Desc* desc() {
  return reinterpret_cast<Desc*>(smem_base() + kARegion);
}
__device__ __forceinline__ uint64_t* full_bars() {
  return reinterpret_cast<uint64_t*>(smem_base() + kARegion + kDescBytes);
}
__device__ __forceinline__ uint64_t* empty_bars() { return full_bars() + kMaxStages; }
__device__ __forceinline__ uint64_t* landed_bars() { return full_bars() + 2 * kMaxStages; }
__device__ __forceinline__ uint64_t* a_bars() { return landed_bars() + kLand; }
__device__ __forceinline__ bf16* w_ring() {
  return reinterpret_cast<bf16*>(smem_base() + kWRing);
}
__device__ __forceinline__ unsigned char* land_slots(bool q8) {
  return smem_base() + kWRing + w_stages(q8) * kTileBytes;
}

enum { kProducer = 0, kConsumer = 1 };

// This block's unit stamps of phase `phase`, or null (see the top).
__device__ __forceinline__ unsigned long long* stamps_of(const Params& p, int phase) {
  return p.unit_base > 0 ? p.trace + p.unit_base +
                               (static_cast<size_t>(phase) * gridDim.x + blockIdx.x) *
                                   kUnitStamps
                         : nullptr;
}

__device__ __forceinline__ void stamp(unsigned long long* st, int i) {
  if (st) st[i] = global_ns();
}

// The consumers' grid barrier: bar[0] counts the blocks' arrivals over the
// launch, so barrier n is crossed when it reaches (n + 1) * grid; the
// arrival that completes it publishes it (no reset, no second word).
// desc()->epoch: the barriers this block has crossed.
__device__ __noinline__ void grid_sync(const Params& p) {
  fence_proxy_async_global();  // this thread's stores before the next phase's TMA reads
  cons_sync();
  if (threadIdx.x == 0) {
    unsigned* bar = p.bar;
    const unsigned n = desc()->epoch++;
    const unsigned target = (n + 1) * gridDim.x;
    __threadfence();  // this block's writes before its arrival
    if (atomicAdd(bar, 1u) + 1 != target) {
      const unsigned long long t0 = global_ns();
      for (unsigned i = 1; static_cast<int>(ld_acquire(bar) - target) < 0; ++i)
        if ((i & 1023) == 0 && global_ns() - t0 > kTimeoutNs) __trap();
    }
    __threadfence();
    if (p.trace && blockIdx.x == 0) p.trace[n + 1] = global_ns();
  }
  cons_sync();
}

// ---------------------------------------------------------------------------
// GEMM phases
// ---------------------------------------------------------------------------

struct Unit {
  int slab, mg, ks, seg, n0, nend, kt0, kt1, mt0, mt1;
};

__device__ __forceinline__ Unit unit_of(const Gemm& g, int u) {
  const GemmPlan& pl = g.pl;
  Unit t;
  t.mg = u % pl.mgroups;
  const int r = u / pl.mgroups;
  t.ks = r % pl.ksplit;
  t.slab = r / pl.ksplit;
  t.seg = t.slab >= pl.slabs0;
  t.n0 = t.seg ? g.nseg + (t.slab - pl.slabs0) * kBN : t.slab * kBN;
  t.nend = t.seg ? g.n : g.nseg;
  t.kt0 = t.ks * pl.ktiles / pl.ksplit;
  t.kt1 = (t.ks + 1) * pl.ktiles / pl.ksplit;
  t.mt0 = t.mg * pl.mtpg;
  t.mt1 = min(t.mt0 + pl.mtpg, pl.mtiles);
  return t;
}

// The map coordinates of k-tile kt of unit t; sc: its int8 scale row.
__device__ __forceinline__ void w_coords(const Gemm& g, const Unit& t, int kt, int& col, int& row,
                                         const float*& sc) {
  const int c = kt / g.pl.tpc, j = kt % g.pl.tpc;
  const bool kseg = c >= g.kseg;
  const bool s1 = kseg || t.seg;
  const int cc = kseg ? c - g.kseg : c;
  row = (s1 ? g.row1 : g.row0) + j * kBK;
  col = (s1 ? g.col1 : g.col0) + cc * g.kc + (t.n0 - (t.seg ? g.nseg : 0));
  sc = s1 ? g.sc1 : g.sc0;
}

// The producer's side of a GEMM phase: every weight tile of this block's
// units, in the order the consumers take them.  bf16: a TMA load straight
// into the ring.  int8 (Q8, not the stem): a TMA load into a landing slot,
// converted, with the scales that land beside it, into the ring kLand - 1
// tiles later (pend holds the tiles
// waiting), so that kLand - 1 loads stay in flight.  The producer
// warpgroup walks the same tiles (its first warp only, with bf16); its
// first thread issues.
struct Pending {
  int col;
  unsigned q;  // its ring position
};

template <bool Q8>
struct Producer {
  Pending pend[kLand];
  int npend = 0;
  unsigned issued = 0;  // int8 tiles issued into the landing slots
  unsigned q = 0;       // ring tiles produced
  uint64_t policy = 0;  // the weights' L2 policy (evict first)

  // The oldest pending int8 tile, converted by the producer warpgroup:
  // thread t takes row t / 2, columns 32 (t % 2) .. + 32.
  __device__ __forceinline__ void convert_oldest(const Params& p) {
    constexpr int kSt = w_stages(Q8);
    const Pending t = pend[0];
    const unsigned li = issued - npend;  // its landing slot's use count
    const int pt = threadIdx.x - kCons, kr = pt >> 1, hb = pt & 1;
    mbar_wait(landed_bars() + li % kLand, (li / kLand) & 1);
    const int s = t.q % kSt;
    mbar_wait(empty_bars() + s, ((t.q / kSt) & 1) ^ 1);
    unsigned char* slot = land_slots(Q8) + (li % kLand) * kLandBytes;
    const unsigned char* src = slot + kr * 64 + hb * 32;
    float* scl = reinterpret_cast<float*>(slot + kLandTile);
    if (pt < 64) scl[pt] = bf16_round(scl[pt]);  // the tile's 64 scales, once
    named_sync(4, 128);
    scl += hb * 32;
    bf16* dst = w_ring() + s * (kTileBytes / 2) + kr * 64;
    const int col = t.col + hb * 32;
    const int limit = 4 * p.d;  // the step's columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + 16 * h);
#pragma unroll
      for (int c8 = 0; c8 < 2; ++c8) {
        const int c = col + 16 * h + 8 * c8;
        float sc[8];
        if (c + 8 <= limit) {
          const float4 a = *reinterpret_cast<const float4*>(scl + 16 * h + 8 * c8);
          const float4 b = *reinterpret_cast<const float4*>(scl + 16 * h + 8 * c8 + 4);
          sc[0] = a.x, sc[1] = a.y, sc[2] = a.z, sc[3] = a.w;
          sc[4] = b.x, sc[5] = b.y, sc[6] = b.z, sc[7] = b.w;
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) sc[i] = 0.f;  // past the step's columns: zeros
        }
        const uint32_t w0 = c8 ? raw.z : raw.x, w1 = c8 ? raw.w : raw.y;
        float f[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t word = i < 4 ? w0 : w1;
          f[i] = static_cast<float>(static_cast<int8_t>((word >> (8 * (i & 3))) & 0xffu)) * sc[i];
        }
        const int chunk = hb * 4 + 2 * h + c8;
        *reinterpret_cast<uint4*>(dst + ((chunk ^ (kr & 7)) << 3)) = pack8(f);
      }
    }
    fence_proxy_async();  // the ring's bf16 for wgmma, the landing slot for TMA
    named_sync(4, 128);   // every producer thread's part
    if (threadIdx.x == kCons) mbar_arrive(full_bars() + s);
    for (int i = 1; i < npend; ++i) pend[i - 1] = pend[i];
    --npend;
  }

  __device__ __forceinline__ void drain(const Params& p) {
    while (npend > 0) convert_oldest(p);
  }

  // The two tiles (64 columns each) of k-tile kt of unit t.
  __device__ __forceinline__ void tile(const Params& p, const Gemm& g, const Unit& t, int kt) {
    int col0, row;
    const float* sc;
    w_coords(g, t, kt, col0, row, sc);
    for (int half = 0; half < 2; ++half)
      tile64(p, g, col0 + 64 * half, row, sc);
  }

  // One 64 x 64 weight tile at map (col, row) into the ring's next slot.
  __device__ __forceinline__ void tile64(const Params& p, const Gemm& g, int col, int row,
                                         const float* sc) {
    constexpr int kSt = w_stages(Q8);
    const bool lane0 = threadIdx.x == kCons;
    if (Q8 && !g.end_map) {
      if (npend == kLand - 1) convert_oldest(p);
      const unsigned li = issued++;
      if (lane0) {  // the tile, and its 64 scales where they lie in the step
        uint64_t* b = landed_bars() + li % kLand;
        unsigned char* slot = land_slots(Q8) + (li % kLand) * kLandBytes;
        const bool scales = col < 4 * p.d;
        mbar_expect_tx(b, kLandTile + (scales ? 256 : 0));
        tma_tile(slot, &p.wmap, col, row, b, policy);
        if (scales) bulk_copy(slot + kLandTile, sc + col, 256, b);
      }
      pend[npend++] = Pending{col, q};
    } else {
      if (Q8) drain(p);
      const int s = q % kSt;
      mbar_wait(empty_bars() + s, ((q / kSt) & 1) ^ 1);
      if (lane0) {
        mbar_expect_tx(full_bars() + s, kTileBytes);
        tma_tile(w_ring() + s * (kTileBytes / 2), g.end_map ? &p.emap : &p.wmap, col, row,
                 full_bars() + s, policy);
      }
    }
    ++q;
  }
};

// d += A (64 x 16, K-major) @ B (16 x 64, N-major), f32 accumulation, one
// warpgroup (the accumulator layout of gemm_core.cuh's wgmma_m64n256k16 with 8
// column groups).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// One unit on the consumers: both warpgroups multiply the unit's m-tiles
// (A, staged once for both), warpgroup w against the unit's columns n0 +
// 64w .. + 64 (ring slot q + w of each k-step's pair).  q: the weight
// ring's position, returned advanced.
template <int EPI, int ST>
__device__ __forceinline__ unsigned gemm_unit(const Params& p, const Gemm& g, const Unit& t,
                                              unsigned q, unsigned& qa,
                                              unsigned long long* st) {
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int cnt = t.mt1 - t.mt0;
  unsigned char* abase = smem_base();
  const bf16* ring = w_ring();
  uint64_t* full = full_bars();
  uint64_t* empty = empty_bars();
  uint64_t* afull = a_bars();
  const int nk = t.kt1 - t.kt0;
  const int m = g.m, tpc = g.pl.tpc;
  const CUtensorMap* amap = &p.amap[g.amap];

  auto load_a = [&](int i) {  // k-step i's A tiles into stage (qa + i) % kAStages, by thread 0
    const unsigned u = qa + i;
    unsigned char* as = abase + (u % kAStages) * kMtUnit * kTileBytes;
    const int kt = t.kt0 + i;
    mbar_expect_tx(afull + u % kAStages, cnt * kTileBytes);
    for (int mm = 0; mm < cnt; ++mm)
      tma_a(as + mm * kTileBytes, amap, (kt % tpc) * kBK, kt / tpc, (t.mt0 + mm) * kBM,
            afull + u % kAStages);
  };

  float acc[kMtUnit][32];
#pragma unroll
  for (int i = 0; i < kMtUnit; ++i)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[i][j] = 0.f;

  // up to kAStages k-steps of A in flight: stage of k-step i - 1 takes k-step
  // i - 1 + kAStages once both warpgroups' wgmma i - 1 has retired
  cons_sync();  // both warpgroups are done with the block's previous unit
  if (tid == 0) {
    fence_proxy_async_global();  // the activations the last phase wrote, for TMA
    for (int i = 0; i < min(kAStages, nk); ++i) load_a(i);
  }
  unsigned prev = 0;
  for (int i = 0; i < nk; ++i) {
    const unsigned u = qa + i;
    mbar_wait(afull + u % kAStages, (u / kAStages) & 1);
    const unsigned s = (q + wg) % ST;
    mbar_wait(full + s, ((q + wg) / ST) & 1);
    if (i == 0) stamp(st, 1);
    const unsigned char* as = abase + (u % kAStages) * kMtUnit * kTileBytes;
    const bf16* ws = ring + s * (kTileBytes / 2);
    wgmma_fence();
#pragma unroll
    for (int mm = 0; mm < kMtUnit; ++mm) {
      if (mm < cnt) {
        const bf16* am = reinterpret_cast<const bf16*>(as + mm * kTileBytes);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n64k16(acc[mm], gmma_desc(am + kk * 16, 16, 1024),
                          gmma_desc(ws + kk * 16 * 64, 8192, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // k-step i - 1 has retired: its W slot and A stage are free
    if (i > 0 && wt == 0) mbar_arrive(empty + prev);
    if (i > 0 && i - 1 + kAStages < nk) {
      cons_sync();  // ... in both warpgroups
      if (tid == 0) load_a(i - 1 + kAStages);
    }
    prev = s;
    q += 2;
  }
  wgmma_wait<0>();
  if (nk > 0 && wt == 0) mbar_arrive(empty + prev);
  qa += nk;
  stamp(st, 2);

  // this thread's bias (or aux) pairs first, every load in flight at once
  const int c0 = t.n0 + 64 * wg + (wt & 3) * 2;
  float2 bb[8];
  if (EPI == kBias || EPI == kGelu) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + j * 8;
      bb[j] = col < t.nend ? __ldg(reinterpret_cast<const float2*>(
                                 t.seg ? g.bias1 + (col - g.nseg) : g.bias0 + col))
                           : make_float2(0.f, 0.f);
    }
  }
#pragma unroll
  for (int mm = 0; mm < kMtUnit; ++mm) {
    if (mm >= cnt) break;
    const int r0 = (t.mt0 + mm) * kBM;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + (wt >> 5) * 16 + ((wt & 31) >> 2) + h * 8;
      if (row >= m) continue;
      float2 ax[8];
      if (EPI == kAux) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + j * 8;
          ax[j] = col < t.nend ? __ldg(reinterpret_cast<const float2*>(
                                     g.aux + static_cast<size_t>(row % g.aux_rows) * g.n + col))
                               : make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + j * 8;
        if (col >= t.nend) continue;
        float v0 = acc[mm][4 * j + 2 * h], v1 = acc[mm][4 * j + 2 * h + 1];
        if (EPI == kPart) {
          float* dst = g.part + (static_cast<size_t>(t.ks) * m + row) * g.n + col;
          __stcg(reinterpret_cast<float2*>(dst), make_float2(v0, v1));
          continue;
        }
        const float2 e = EPI == kAux ? ax[j] : bb[j];
        v0 += e.x;
        v1 += e.y;
        if (EPI == kGelu) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        }
        const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
        __stcg(reinterpret_cast<unsigned*>(g.c + static_cast<size_t>(row) * g.ldc + col),
               *reinterpret_cast<const unsigned*>(&o));
      }
    }
  }
  stamp(st, 3);
  return q;
}

// A GEMM phase of one role, on the descriptor in shared memory (the
// consumers' desc()->g[0], the producer's g[1]); returns the consumers'
// ring position (the producer keeps its own in pr).
template <int ROLE, int EPI, bool Q8>
__device__ __noinline__ unsigned gemm_phase(const Params& p, int phase, unsigned q,
                                            unsigned& qa, Producer<Q8>& pr) {
  const Gemm& g = desc()->g[ROLE == kProducer ? 1 : 0];
  const int lead = ROLE == kProducer ? kCons : 0;
  unsigned long long* st = threadIdx.x == lead ? stamps_of(p, phase) : nullptr;
  const int units = g.pl.units;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit t = unit_of(g, u);
    if (ROLE == kProducer) {
      for (int kt = t.kt0; kt < t.kt1; ++kt) {
        pr.tile(p, g, t, kt);
        stamp(st, 5);
        st = nullptr;
      }
    } else {
      stamp(st, 0);
      q = gemm_unit<EPI, w_stages(Q8)>(p, g, t, q, qa, st);
      stamp(st, 4);
      st = nullptr;
    }
  }
  return q;
}

// ---------------------------------------------------------------------------
// Row phases: a split-K fixup and / or a LayerNorm, a thread per 8 columns
// ---------------------------------------------------------------------------

// A row takes tpr threads (its D / 8 chunks rounded up to whole warps), a
// block kCons / tpr rows at a time.  A thread issues the loads of its
// chunk's residual and of every partial slot together (kMaxSplit at most),
// sums the slots in slot order, rounds once; the LN's sums go warp by warp
// through shared memory, in warp order.
__device__ __noinline__ void row_phase(const Params& p, int phase) {
  unsigned long long* st = threadIdx.x == 0 ? stamps_of(p, phase) : nullptr;
  stamp(st, 0);
  const RowJob& j = desc()->r;
  const float* part = j.part;
  const bf16* res = j.res;
  bf16* out = j.out;
  bf16* xn = j.xn;
  const int slots = j.slots;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int rows = p.batch * p.tp, d = p.d, cpr = d / 8;
  const int tpr = cdiv(cpr, 32) * 32, rpb = kCons / tpr, wpr = tpr / 32;
  const int rl = tid / tpr, ci = tid % tpr, col = ci * 8;
  const bool lane_on = ci < cpr && rl < rpb;
  const size_t plane = static_cast<size_t>(rows) * d;
  float* red_mu = reinterpret_cast<float*>(smem_base());
  float* red_var = red_mu + kCWarps;
  // this thread's columns of the bias, gamma and beta, loaded once
  float bb[8], ga[8], be[8];
  {
    const float* vs[3] = {j.bias, j.gamma, j.beta};
    float* ds[3] = {bb, ga, be};
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      if (lane_on && vs[v]) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(vs[v] + col));
        const float4 b = __ldg(reinterpret_cast<const float4*>(vs[v] + col + 4));
        ds[v][0] = a.x, ds[v][1] = a.y, ds[v][2] = a.z, ds[v][3] = a.w;
        ds[v][4] = b.x, ds[v][5] = b.y, ds[v][6] = b.z, ds[v][7] = b.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) ds[v][i] = 0.f;
      }
    }
  }
  for (int base = blockIdx.x * rpb; base < rows; base += gridDim.x * rpb) {
    const int r = base + rl;
    const bool on = lane_on && r < rows;
    const size_t off = static_cast<size_t>(r) * d + col;
    float f[8];
    float s = 0.f;
    if (on) {
      const uint4 rv = __ldcg(reinterpret_cast<const uint4*>(res + off));
      if (part) {
        float4 ld[kMaxSplit][2];
#pragma unroll
        for (int sl = 0; sl < kMaxSplit; ++sl) {
          if (sl < slots) {
            const float* q = part + sl * plane + off;
            ld[sl][0] = __ldcg(reinterpret_cast<const float4*>(q));
            ld[sl][1] = __ldcg(reinterpret_cast<const float4*>(q + 4));
          }
        }
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int sl = 0; sl < kMaxSplit; ++sl) {  // in slot order
          if (sl < slots) {
            v[0] += ld[sl][0].x, v[1] += ld[sl][0].y, v[2] += ld[sl][0].z;
            v[3] += ld[sl][0].w, v[4] += ld[sl][1].x, v[5] += ld[sl][1].y;
            v[6] += ld[sl][1].z, v[7] += ld[sl][1].w;
          }
        }
        unpack8(rv, f);
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = (f[i] + v[i]) + bb[i];
        const uint4 o = pack8(f);
        __stcg(reinterpret_cast<uint4*>(out + off), o);
        unpack8(o, f);
      } else {
        unpack8(rv, f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s += f[i];
    }
    if (!j.gamma) continue;
    cons_sync();  // the previous rows' readers of red_mu / red_var are done
    s = warp_sum(s);
    if ((tid & 31) == 0) red_mu[warp] = s;
    cons_sync();
    float mu = 0.f;
    for (int w = 0; w < wpr; ++w) mu += red_mu[rl * wpr + w];
    mu /= static_cast<float>(d);
    float v = 0.f;
    if (on)
#pragma unroll
      for (int i = 0; i < 8; ++i) v += (f[i] - mu) * (f[i] - mu);
    v = warp_sum(v);
    if ((tid & 31) == 0) red_var[warp] = v;
    cons_sync();
    float var = 0.f;
    for (int w = 0; w < wpr; ++w) var += red_var[rl * wpr + w];
    const float inv = 1.0f / sqrtf(var / static_cast<float>(d) + p.eps);
    if (on) {
      float gv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) gv[i] = (f[i] - mu) * inv * ga[i] + be[i];
      __stcg(reinterpret_cast<uint4*>(xn + off), pack8(gv));
    }
  }
  stamp(st, 4);
}

// ---------------------------------------------------------------------------
// Attention phase
// ---------------------------------------------------------------------------

// A unit: kAttGroups 16-row query groups of one (item, head), each taken by
// kAttSplit warps that split its keys (64-key chunk c to warp c %
// kAttSplit).  Two passes over the keys in tiles of key_tile (K and V of
// the tile in shared memory, rows past Tp zero), the arithmetic of kernel
// 12's two passes (attention_cp_core.cuh): each warp's row max and sum,
// combined over the group's warps (l = sum of l_w exp(m_w - m), in warp
// order); then the
// normalized weights exp(s - m) / l rounded to bf16 and each warp's P V in
// f32, summed over the group's warps in warp order and rounded once.  The
// exponentials are taken in base 2 on logits scaled by scale * log2 e (as
// kernel 12's cores do), the division by l as a product with 1 / l.
constexpr int kAttSplit = 4;
constexpr int kAttGroups = kCWarps / kAttSplit;

// Q's 32-bit fragments, from L2: qkv is written during the launch.
__device__ __forceinline__ uint32_t ld_cg_u32(const bf16* p) {
  return __ldcg(reinterpret_cast<const unsigned int*>(p));
}

// Shared memory of the attention phase past K and V: the warps' row stats
// and P V partials.
__host__ __device__ constexpr int att_scratch_bytes(int dh) {
  return kAttGroups * kAttSplit * 16 * (dh + 2) * 4;
}

__host__ __device__ inline int att_key_tile(int tp, int dh) {
  const int keys = att_keys(tp);
  const int fit = (kARegion - att_scratch_bytes(dh)) / (2 * (dh + 8) * 2);
  return keys <= fit ? keys : fit / 64 * 64;
}

template <int DH>
__device__ __noinline__ void attention_phase(const Params& p, int phase) {
  constexpr int LD = DH + 8, KK = DH / 16, NO = DH / 8, CPR = DH / 8;
  unsigned long long* st = threadIdx.x == 0 ? stamps_of(p, phase) : nullptr;
  unsigned long long* const stamps_end = st;
  stamp(st, 0);
  const int tp = p.tp, d = p.d, heads = p.heads, valid_len = p.valid_len;
  const int chunks = p.plan.att_chunks, units = p.plan.att_units;
  const int nk = att_keys(tp), kt = p.plan.att_key_tile, ntiles = p.plan.att_key_tiles;
  const float scale = p.scale * kLog2e;
  const size_t stride = 3 * static_cast<size_t>(d);
  bf16* Ks = reinterpret_cast<bf16*>(smem_base());
  bf16* Vs = Ks + kt * LD;
  float* ml = reinterpret_cast<float*>(Vs + kt * LD);  // [groups][split][16][2]
  float* osum = ml + kAttGroups * kAttSplit * 16 * 2;  // [groups][split][16][DH]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gs = warp / kAttSplit, kq = warp % kAttSplit;
  const int g = lane >> 2, t4 = lane & 3;
  const int groups = cdiv(tp, 16);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int chunk = u % chunks, h = (u / chunks) % heads, b = u / (chunks * heads);
    const bf16* base = p.qkv + static_cast<size_t>(b) * tp * stride + static_cast<size_t>(h) * DH;
    const bf16* kb = base + d;
    const bf16* vb = base + 2 * d;
    const int grp = chunk * kAttGroups + gs;
    const bool active = grp < groups;
    const int r0 = grp * 16;

    auto load = [&](int k0) {  // keys k0 .. k0 + kt of K and V
      cons_sync();             // the previous readers of the tile are done
      for (int cc = tid; cc < kt * CPR; cc += kCons) {
        const int r = cc / CPR, col = (cc % CPR) * 8, key = k0 + r;
        bf16* dk = Ks + r * LD + col;
        bf16* dv = Vs + r * LD + col;
        if (key < tp) {
          cp_async16(dk, kb + key * stride + col);
          cp_async16(dv, vb + key * stride + col);
        } else {
          store_zero16(dk);
          store_zero16(dv);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      cons_sync();
    };

    uint32_t qa[KK][4];
    {
      const bf16* qlo = base + static_cast<size_t>(r0 + g) * stride + t4 * 2;
      const bf16* qhi = qlo + 8 * stride;
      const bool lo_in = active && r0 + g < tp, hi_in = active && r0 + g + 8 < tp;
#pragma unroll
      for (int k = 0; k < KK; ++k) {
        qa[k][0] = lo_in ? ld_cg_u32(qlo + k * 16) : 0u;
        qa[k][1] = hi_in ? ld_cg_u32(qhi + k * 16) : 0u;
        qa[k][2] = lo_in ? ld_cg_u32(qlo + k * 16 + 8) : 0u;
        qa[k][3] = hi_in ? ld_cg_u32(qhi + k * 16 + 8) : 0u;
      }
    }
    // s[j][0..1]: row g, keys k0 + kc0 + 8j + 2*t4 + {0, 1}; s[j][2..3]: row g + 8
    auto scores = [&](float (&s)[8][4], int k0, int kc0) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
        const int key0 = kc0 + jj * 8;
        if (key0 < kt) {
          const bf16* kp = Ks + (key0 + g) * LD + t4 * 2;
#pragma unroll
          for (int k = 0; k < KK; ++k)
            mma_16816(s[jj], qa[k], ld_shared_u32(kp + k * 16), ld_shared_u32(kp + k * 16 + 8));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + key0 + t4 * 2 + (e & 1);
          s[jj][e] = key < valid_len ? s[jj][e] * scale : (key < tp ? -1e30f : -CUDART_INF_F);
        }
      }
    };

    // pass 1: this warp's row max and sum over its chunks
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < nk; k0 += kt) {
      load(k0);
      if (k0 == 0) stamp(st, 1);
      if (active) {
        for (int kc0 = kq * kAttKeyChunk; kc0 < kt && k0 + kc0 < nk;
             kc0 += kAttSplit * kAttKeyChunk) {
          float s[8][4];
          scores(s, k0, kc0);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float mx = -CUDART_INF_F;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              mx = fmaxf(mx, fmaxf(s[jj][2 * hr], s[jj][2 * hr + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float mn = fmaxf(m[hr], mx);
            float sum = 0.f;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              sum += exp2f(s[jj][2 * hr] - mn) + exp2f(s[jj][2 * hr + 1] - mn);
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            l[hr] = mn == -CUDART_INF_F ? 0.f : l[hr] * exp2f(m[hr] - mn) + sum;
            m[hr] = mn;
          }
        }
      }
    }
    // the group's row stats: m = max over its warps, l = sum of l_w e^(m_w - m)
    float* mlg = ml + gs * kAttSplit * 32;
    if (t4 == 0) {
      mlg[kq * 32 + g * 2] = m[0], mlg[kq * 32 + g * 2 + 1] = l[0];
      mlg[kq * 32 + (g + 8) * 2] = m[1], mlg[kq * 32 + (g + 8) * 2 + 1] = l[1];
    }
    cons_sync();
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = g + 8 * hr;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kAttSplit; ++w) mx = fmaxf(mx, mlg[w * 32 + row * 2]);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kAttSplit; ++w) {
        const float mw = mlg[w * 32 + row * 2];
        if (mw != -CUDART_INF_F) sum += mlg[w * 32 + row * 2 + 1] * exp2f(mw - mx);
      }
      m[hr] = mx;
      l[hr] = 1.0f / sum;
    }
    stamp(st, 2);
    // pass 2: normalized weights in bf16, this warp's P V over its chunks
    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    for (int k0 = 0; k0 < nk; k0 += kt) {
      if (ntiles > 1) load(k0);
      if (active) {
        for (int kc0 = kq * kAttKeyChunk; kc0 < kt && k0 + kc0 < nk;
             kc0 += kAttSplit * kAttKeyChunk) {
          float s[8][4];
          scores(s, k0, kc0);
#pragma unroll
          for (int qq = 0; qq < kAttKeyChunk / 16; ++qq) {
            const int key0 = kc0 + qq * 16;
            if (key0 < kt) {
              const float(&lo)[4] = s[2 * qq];
              const float(&hi)[4] = s[2 * qq + 1];
              const uint32_t pa[4] = {
                  pack_bf16x2(exp2f(lo[0] - m[0]) * l[0], exp2f(lo[1] - m[0]) * l[0]),
                  pack_bf16x2(exp2f(lo[2] - m[1]) * l[1], exp2f(lo[3] - m[1]) * l[1]),
                  pack_bf16x2(exp2f(hi[0] - m[0]) * l[0], exp2f(hi[1] - m[0]) * l[0]),
                  pack_bf16x2(exp2f(hi[2] - m[1]) * l[1], exp2f(hi[3] - m[1]) * l[1])};
              const bf16* vrow = Vs + (key0 + (lane & 15)) * LD;
#pragma unroll
              for (int n = 0; n < NO; ++n) {
                uint32_t b0, b1;
                ldmatrix_x2_trans(b0, b1, vrow + n * 8);
                mma_16816(o[n], pa, b0, b1);
              }
            }
          }
        }
      }
    }
    stamp(st, 3);
    // the group's P V: the warps' partials summed in warp order, rounded once
    float* og = osum + gs * kAttSplit * 16 * DH;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float* o0 = og + (kq * 16 + g) * DH + n * 8 + t4 * 2;
      o0[0] = o[n][0], o0[1] = o[n][1];
      o0[8 * DH] = o[n][2], o0[8 * DH + 1] = o[n][3];
    }
    cons_sync();
    if (active) {  // warp kq writes rows kq * 4 .. + 3; lane: columns 2 lane, + 1
      for (int rr = 0; rr < 4; ++rr) {
        const int row = kq * 4 + rr;
        if (2 * lane < DH && r0 + row < tp) {
          float v0 = 0.f, v1 = 0.f;
#pragma unroll
          for (int w = 0; w < kAttSplit; ++w) {
            v0 += og[(w * 16 + row) * DH + 2 * lane];
            v1 += og[(w * 16 + row) * DH + 2 * lane + 1];
          }
          *reinterpret_cast<uint32_t*>(p.xn + (static_cast<size_t>(b) * tp + r0 + row) * d +
                                       static_cast<size_t>(h) * DH + 2 * lane) =
              pack_bf16x2(v0, v1);
        }
      }
    }
    st = nullptr;  // the block's first unit only, but its end
  }
  stamp(stamps_end, 4);
}

// ---------------------------------------------------------------------------
// The head (fold-ends): fixup of the CLS rows, both LNs, fc1 over the grid,
// the last block of an item computes its two logits
// ---------------------------------------------------------------------------

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  cons_sync();  // red's previous readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  cons_sync();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kCWarps; ++w) s += red[w];
  return s;
}

// row (f32, in shared memory) <- LN(row) * gamma + beta, in place.
__device__ __forceinline__ void ln_shared(float* row, const float* gamma, const float* beta,
                                          int d, float eps, float* red) {
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kCons) s += row[i];
  const float mu = block_sum(s, red) / static_cast<float>(d);
  float v = 0.f;
  for (int i = threadIdx.x; i < d; i += kCons) v += (row[i] - mu) * (row[i] - mu);
  const float inv = 1.0f / sqrtf(block_sum(v, red) / static_cast<float>(d) + eps);
  cons_sync();  // every thread has read the row
  for (int i = threadIdx.x; i < d; i += kCons)
    row[i] = (row[i] - mu) * inv * gamma[i] + beta[i];
  cons_sync();
}

// Unit u: (item b, 64 columns of fc1).  The fixup (desc()->r): the last
// layer's fc2 slots, its bias and the residual, as the row phase computes
// them, on the item's CLS row.
__device__ __noinline__ void head_phase(const Params& p, int phase) {
  unsigned long long* st = threadIdx.x == 0 ? stamps_of(p, phase) : nullptr;
  stamp(st, 0);
  const RowJob& fix = desc()->r;
  const int d = p.d, h4 = 4 * d, hh = p.hh, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const Plan& pl = p.plan;
  float* row = reinterpret_cast<float*>(smem_base());
  float* red = row + d;
  float* psum = red + 32;  // [kCWarps][64]
  __shared__ unsigned last;
  const size_t plane = static_cast<size_t>(p.batch) * p.tp * d;
  for (int u = blockIdx.x; u < pl.head_units; u += gridDim.x) {
    const int b = u / pl.head_cgroups, j0 = (u % pl.head_cgroups) * 64;
    const size_t off = static_cast<size_t>(b) * p.tp * d;  // row 0 of item b
    cons_sync();  // the previous unit's readers are done
    for (int i = tid; i < d; i += kCons) {
      float v = __ldcg(fix.part + off + i);
      for (int sl = 1; sl < fix.slots; ++sl) v += __ldcg(fix.part + sl * plane + off + i);
      const unsigned short ru = __ldcg(reinterpret_cast<const unsigned short*>(fix.res + off + i));
      const float r = __bfloat162float(__ushort_as_bfloat16(ru));
      row[i] = bf16_round((r + v) + fix.bias[i]);
    }
    cons_sync();
    ln_shared(row, p.s_end, p.s_end + h4, d, p.eps, red);  // vit.norm
    for (int i = tid; i < d; i += kCons) row[i] = bf16_round(row[i]);
    cons_sync();
    ln_shared(row, p.s_end + d, p.s_end + h4 + d, d, p.head_eps, red);  // head.norm
    // warp w: k in [w d / 8, (w + 1) d / 8); lane: columns j0 + 2 lane, + 1
    const int k0 = warp * d / kCWarps, k1 = (warp + 1) * d / kCWarps;
    const int j = j0 + 2 * lane;
    float a0 = 0.f, a1 = 0.f;
    if (j < hh) {
      const bf16* wcol = p.w_end + d + j;
      for (int k = k0; k < k1; ++k) {
        const float2 w = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(wcol + static_cast<size_t>(k) * (d + hh)));
        a0 += row[k] * w.x;
        a1 += row[k] * w.y;
      }
    }
    psum[warp * 64 + 2 * lane] = a0;
    psum[warp * 64 + 2 * lane + 1] = a1;
    cons_sync();
    if (tid < 64 && j0 + tid < hh) {
      float hv = 0.f;
#pragma unroll
      for (int w = 0; w < kCWarps; ++w) hv += psum[w * 64 + tid];
      hv += p.s_end[2 * h4 + j0 + tid];
      __stcg(p.h1 + static_cast<size_t>(b) * hh + j0 + tid, bf16_round(gelu_erf(hv)));
    }
    __threadfence();  // this unit's h1 before its arrival
    cons_sync();
    if (tid == 0)
      last = atomicAdd(p.bar + 1 + b, 1u) == static_cast<unsigned>(pl.head_cgroups - 1);
    cons_sync();
    if (last) {  // every column of item b is written: its logits
      __threadfence();
      float l0 = 0.f, l1 = 0.f;
      for (int i = tid; i < hh; i += kCons) {
        const float hv = __ldcg(p.h1 + static_cast<size_t>(b) * hh + i);
        l0 += hv * p.s_end[2 * d + i];
        l1 += hv * p.s_end[h4 + 2 * d + i];
      }
      l0 = block_sum(l0, red);
      l1 = block_sum(l1, red);
      if (tid == 0) {
        p.logits[2 * b] = l0 + p.s_end[3 * h4];
        p.logits[2 * b + 1] = l1 + p.s_end[3 * h4 + 1];
        p.bar[1 + b] = 0;
      }
    }
  }
  stamp(st, 4);
}

// ---------------------------------------------------------------------------
// The launch: every phase in order, run by both roles
// ---------------------------------------------------------------------------

// The role's descriptor of the next GEMM phase into shared memory.
template <int ROLE, bool Q8>
__device__ __forceinline__ void put_gemm(const Gemm& g) {
  if (ROLE == kProducer) {
    named_sync(4, Q8 ? 128 : 32);
    if (threadIdx.x == kCons) desc()->g[1] = g;
    named_sync(4, Q8 ? 128 : 32);
  } else {
    if (threadIdx.x == 0) desc()->g[0] = g;
    cons_sync();
  }
}

__device__ __forceinline__ void put_rows(const RowJob& r) {
  if (threadIdx.x == 0) desc()->r = r;
  cons_sync();
}

template <int ROLE, bool Q8>
__device__ __forceinline__ void encoder_body(const Params& p) {
  const int m = p.batch * p.tp, d = p.d, h4 = 4 * d;
  const bool bg = p.batch_grid != 0;
  const size_t sstep = static_cast<size_t>(p.srows) * h4;
  const Plan& pl = p.plan;
  auto S = [&](int step) { return p.s + step * sstep; };
  auto sc = [&](int step) { return Q8 ? S(step) + 4 * h4 : nullptr; };
  const bf16* cur = p.x_in;
  Producer<Q8> pr;
  if (ROLE == kProducer) pr.policy = evict_first_policy();
  unsigned q = 0;   // the consumers' weight ring position
  unsigned qa = 0;  // ... and A ring position
  int phase = 0;
  // a phase ends: the consumers cross the grid barrier, the producer only
  // counts it
  auto next = [&]() {
    if (ROLE == kConsumer) grid_sync(p);
    ++phase;
  };
  auto gemm = [&](const Gemm& g, auto epi) {
    put_gemm<ROLE, Q8>(g);
    q = gemm_phase<ROLE, decltype(epi)::value, Q8>(p, phase, q, qa, pr);
  };
  using Bias = std::integral_constant<int, kBias>;
  using Gelu = std::integral_constant<int, kGelu>;
  using Aux = std::integral_constant<int, kAux>;
  using Part = std::integral_constant<int, kPart>;

  if (ROLE == kConsumer && p.trace) {
    if (blockIdx.x == 0 && threadIdx.x == 0) p.trace[0] = global_ns();
    for (int i = 0; i < kTraceBarriers; ++i) grid_sync(p);
  }

  Gemm g{};
  if (p.fold_ends) {  // x = patches @ W_embed + aux
    g = Gemm{};
    g.amap = 2, g.m = m, g.n = d, g.nseg = d, g.kc = d, g.nchunks = 1;
    g.kseg = 1, g.end_map = 1, g.aux = p.aux, g.aux_rows = p.tp, g.c = p.x, g.ldc = d;
    g.pl = pl.stem;
    gemm(g, Aux{});
    next();
    cur = p.x;
  }
  for (int l = 0; l < p.depth; ++l) {
    const int s0 = 3 * l, s1 = s0 + 1, s2 = s0 + 2;
    if (ROLE == kConsumer) {  // ln1: the previous fc2's fixup, LN1
      RowJob r{};
      if (l > 0) {
        r.part = p.part, r.slots = pl.fc2.ksplit, r.res = p.x, r.out = p.x;
        r.bias = bg ? S(s0 - 1) + 3 * h4 : S(s0 - 1);
      } else {
        r.res = cur;
      }
      r.gamma = S(s0), r.beta = S(s0) + h4, r.xn = p.xn;
      put_rows(r);
      row_phase(p, phase);
    }
    next();
    g = Gemm{};  // qkv
    g.amap = 0, g.m = m, g.n = 3 * d, g.nseg = 3 * d, g.kc = d, g.nchunks = 1;
    g.kseg = 1, g.row0 = s0 * d, g.col0 = 0, g.bias0 = S(s0) + 2 * h4, g.sc0 = sc(s0);
    g.c = p.qkv, g.ldc = 3 * d, g.pl = pl.qkv;
    gemm(g, Bias{});
    next();
    if (ROLE == kConsumer) {
      switch (d / p.heads) {
        case 16:
          attention_phase<16>(p, phase);
          break;
        case 32:
          attention_phase<32>(p, phase);
          break;
        default:
          attention_phase<64>(p, phase);
          break;
      }
    }
    next();
    g = Gemm{};  // proj: slices of o @ Wproj
    g.amap = 0, g.m = m, g.n = d, g.nseg = d, g.kc = d, g.nchunks = 1, g.kseg = 1;
    g.row0 = s0 * d, g.col0 = 3 * d, g.sc0 = sc(s0), g.part = p.part, g.pl = pl.proj;
    gemm(g, Part{});
    next();
    if (ROLE == kConsumer) {  // ln2: proj's fixup, LN2
      RowJob r{};
      r.part = p.part, r.slots = pl.proj.ksplit, r.res = cur, r.out = p.x;
      r.bias = S(s0) + 3 * h4, r.gamma = S(s1), r.beta = S(s1) + h4, r.xn = p.xn;
      put_rows(r);
      row_phase(p, phase);
    }
    next();
    cur = p.x;
    g = Gemm{};  // fc1 (batch-grid: both halves, columns 2D.. from the second step)
    g.amap = 0, g.m = m, g.n = h4, g.kc = d, g.nchunks = 1, g.kseg = 1;
    g.nseg = bg ? 2 * d : h4;
    g.row0 = s1 * d, g.col0 = 0, g.bias0 = S(s1) + 2 * h4, g.sc0 = sc(s1);
    g.row1 = s2 * d, g.col1 = 0, g.bias1 = S(s2) + 2 * h4, g.sc1 = sc(s2);
    g.c = p.hid, g.ldc = h4, g.pl = pl.fc1;
    gemm(g, Gelu{});
    next();
    g = Gemm{};  // fc2: K = 4D in four D-row chunks
    g.amap = 1, g.m = m, g.n = d, g.nseg = d, g.kc = d, g.nchunks = 4;
    if (bg) {  // chunks 0, 1 from the first half's columns 2D.., 2, 3 from the second's
      g.kseg = 2, g.row0 = s1 * d, g.col0 = 2 * d, g.sc0 = sc(s1);
      g.row1 = s2 * d, g.col1 = 2 * d, g.sc1 = sc(s2);
    } else {
      g.kseg = 4, g.row0 = s2 * d, g.col0 = 0, g.sc0 = sc(s2);
    }
    g.part = p.part, g.pl = pl.fc2;
    gemm(g, Part{});
    next();
  }
  if (ROLE == kProducer) {
    pr.drain(p);
    return;
  }
  const int last = 3 * (p.depth - 1) + 2;
  RowJob r{};  // the last fc2's fixup
  r.part = p.part, r.slots = pl.fc2.ksplit, r.res = p.x, r.out = p.x;
  r.bias = bg ? S(last) + 3 * h4 : S(last);
  put_rows(r);
  if (p.fold_ends)
    head_phase(p, phase);
  else
    row_phase(p, phase);
  if (p.trace) grid_sync(p);
}

// The kernel of both entry points: the ring's barriers, then the roles.
template <bool Q8>
__device__ __forceinline__ void encoder_kernel_body(const Params& p) {
  if (threadIdx.x == 0) {
    desc()->epoch = 0;
    for (int i = 0; i < kMaxStages; ++i) {
      mbar_init(full_bars() + i, 1);
      mbar_init(empty_bars() + i, 1);  // the consumer warpgroup that read it
    }
    for (int i = 0; i < kLand; ++i) mbar_init(landed_bars() + i, 1);
    for (int i = 0; i < kAStages; ++i) mbar_init(a_bars() + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < kCons)
    encoder_body<kConsumer, Q8>(p);
  else if (Q8 || threadIdx.x < kCons + 32)  // bf16: one producer warp
    encoder_body<kProducer, Q8>(p);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

inline Plan make_plan(bool batch_grid, bool fold_ends, bool q8, int depth, int batch, int tp,
                      int d, int heads, int hh, int sms) {
  Plan p{};
  const int m = batch * tp, h4 = 4 * d, grid = sms;
  p.grid = grid;
  p.w_stages = w_stages(q8);
  p.smem = static_cast<int>(smem_bytes(q8));
  if (fold_ends) p.stem = plan_gemm(m, d, d, d, 1, false, grid);
  p.qkv = plan_gemm(m, 3 * d, 3 * d, d, 1, false, grid);
  p.proj = plan_gemm(m, d, d, d, 1, true, grid);
  p.fc1 = plan_gemm(m, h4, batch_grid ? 2 * d : h4, d, 1, false, grid);
  p.fc2 = plan_gemm(m, d, d, d, 4, true, grid);
  p.att_chunks = cdiv(cdiv(tp, 16), kAttGroups);
  p.att_gpc = kAttGroups;
  p.att_units = batch * heads * p.att_chunks;
  p.att_key_tile = att_key_tile(tp, d / heads);
  p.att_key_tiles = cdiv(att_keys(tp), p.att_key_tile);
  if (fold_ends) {
    p.head_cgroups = cdiv(hh, 64);
    p.head_units = batch * p.head_cgroups;
  }
  p.phases = (fold_ends ? 1 : 0) + 7 * depth + 1;
  const int slots = p.proj.ksplit > p.fc2.ksplit ? p.proj.ksplit : p.fc2.ksplit;
  p.splitk_floats = static_cast<long long>(slots) * m * d;
  p.bar_words = 1 + batch;
  return p;
}

// The plan as integers, in the order ops/lowlat.py::lowlat_launch_config
// reads them.  Returns how many it wrote (at most len).
inline int plan_ints(const Plan& p, int* out, int len) {
  int v[64];
  int n = 0;
  v[n++] = p.grid;
  v[n++] = kThreads;
  v[n++] = p.smem;
  v[n++] = p.w_stages;
  v[n++] = kAStages;
  v[n++] = p.phases;
  const GemmPlan* gs[5] = {&p.stem, &p.qkv, &p.proj, &p.fc1, &p.fc2};
  for (const GemmPlan* g : gs) {
    v[n++] = g->slabs;
    v[n++] = g->mgroups;
    v[n++] = g->mtpg;
    v[n++] = g->ktiles;
    v[n++] = g->ksplit;
    v[n++] = g->units;
  }
  v[n++] = p.att_chunks;
  v[n++] = p.att_gpc;
  v[n++] = p.att_units;
  v[n++] = p.att_key_tile;
  v[n++] = p.att_key_tiles;
  v[n++] = p.head_units;
  v[n++] = static_cast<int>(p.splitk_floats);
  v[n++] = p.bar_words;
  for (int i = 0; i < n && i < len; ++i) out[i] = v[i];
  return n < len ? n : len;
}

// The A operands' maps: [m rows][nchunks chunks of kc][kc] bf16 at row pitch
// lda, 64 x 1 x 64 boxes with the 128-byte swizzle, so that k past a chunk
// lands as zeros.  amap[0] xn [M, D], [1] hid [M, 4D] in four D chunks,
// [2] x_in [M, D].
inline bool encode_a_maps(Params& p) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const long long m = static_cast<long long>(p.batch) * p.tp, d = p.d;
  const void* ptrs[3] = {p.xn, p.hid, p.x_in};
  const long long chunks[3] = {1, 4, 1};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(chunks[i]),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d * 2),
                                   static_cast<cuuint64_t>(d * chunks[i] * 2)};
    const cuuint32_t box[3] = {64, 1, 64};
    const cuuint32_t estr[3] = {1, 1, 1};
    if (fn(&p.amap[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptrs[i]), dims,
           strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
  }
  return true;
}

// The cooperative launch of a persistent kernel, one block on every SM.
inline cudaError_t launch_persistent(const void* kernel, Params& p, bool q8, long long splitk_len,
                                     int trace_len, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return e;
  if (!coop) return cudaErrorNotSupported;
  if (!encode_a_maps(p)) return cudaErrorInvalidValue;
  p.plan = make_plan(p.batch_grid != 0, p.fold_ends != 0, q8, p.depth, p.batch, p.tp, p.d,
                     p.heads, p.hh, sms);
  if (splitk_len < p.plan.splitk_floats) return cudaErrorInvalidValue;
  const int slots = 1 + kTraceBarriers + p.plan.phases;
  p.unit_base = 0;
  if (p.trace) {
    if (trace_len < slots) return cudaErrorInvalidValue;
    if (trace_len >= slots + slots * p.plan.grid * kUnitStamps) p.unit_base = slots;
  }
  const size_t smem = static_cast<size_t>(p.plan.smem);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((e = cudaMemsetAsync(p.bar, 0, p.plan.bar_words * sizeof(unsigned), stream)) !=
      cudaSuccess)
    return e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, dim3(p.plan.grid), dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Host side: the plan for a shape on this card's SM count, or on `sms` SMs
// when sms > 0, as integers (plan_ints); both libraries export it as
// vsd_lowlat_plan, which ops/lowlat.py::lowlat_launch_config reads.
inline int plan_entry(int batch_grid, int fold_ends, int int8, int depth, int batch, int tp,
                      int d, int heads, int hh, int sms, int* out, int len) {
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
  }
  return plan_ints(make_plan(batch_grid != 0, fold_ends != 0, int8 != 0, depth, batch, tp, d,
                             heads, fold_ends ? hh : 0, sms),
                   out, len);
}

// Host side: the checks both entry points share.
inline bool valid_shape(int depth, int batch, int tp, int d, int heads, int valid_len) {
  if (depth <= 0 || batch <= 0 || tp <= 0 || tp % 8 || d <= 0 || d % 16 || d > 1024 || heads <= 0 ||
      d % heads || valid_len <= 0 || valid_len > tp)
    return false;
  const int dh = d / heads;
  return dh == 16 || dh == 32 || dh == 64;
}

}  // namespace lowlat
}  // namespace vsd

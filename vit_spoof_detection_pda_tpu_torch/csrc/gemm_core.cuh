// The bf16 GEMM core of the block kernels (kernels 1, 2, 3 and 7, and the
// standalone entry csrc/gemm.cu), on Hopper:
//
//   C[M, N] = epilogue(A[M, K] @ W[K, N])
//
// A and W bf16 row-major (W in the JAX [in, out] layout), f32 accumulation
// on the tensor cores (wgmma.mma_async m64n256k16).  Epilogues, in f32,
// rounded to bf16 once:
//   kEpiBias          acc + bias
//   kEpiBiasGelu      gelu_tanh(acc + bias) (its sigmoid form,
//                     gelu_tanh_fast, on the special-function unit)
//   kEpiBiasResidual  (residual + acc) + bias
// and the training MLP's stored-hidden epilogues, which write two outputs:
//   kEpiBiasHGeluErf  H = bf16(acc + bias), C = bf16(gelu_erf(H))
//   kEpiBiasHGeluTanh H = bf16(acc + bias), C = bf16(gelu_tanh(H))
// (the GELU reads the rounded hidden, so the stored H, the activation and
// the backward's recompute of the gate all see one tensor; both GELUs in
// their tail forms on the special-function unit, gelu_erf_tail and
// gelu_tanh_tail in common.cuh, within one bf16 ulp of the exact GELU at
// every finite bf16 hidden value).
//
// Bound on the H100: the tensor cores at the block kernels' shapes (ViT-B,
// M = 25,600: QKV 90.6 GFLOP, >= 0.092 ms at 989 TFLOP/s; its 161 MB of
// compulsory traffic 0.048 ms at 3.35 TB/s).  The loads of a 128 x 256
// tile's k-steps (48 KB a 4.2 MFLOP step) need ~11 TB/s from L2 at the
// tensor peak, so the main loop is held by L2 well below it.
//
// Design: a warp-specialised, persistent kernel of 384 threads, one block
// an SM (~225 KB of shared memory):
//   - a producer warpgroup (setmaxnreg down to 40 registers) in which one
//     thread keeps a ring of kGemmStages stages full with TMA loads
//     (cp.async.bulk.tensor over tensor maps of A and W, 64 x 64 boxes with
//     the 128-byte swizzle wgmma reads, completion on the stage's full
//     mbarrier).  A stage is a 128-row x 64-deep A tile and a 64-deep x
//     256-column W tile (48 KB).  Out-of-bounds rows, columns and k land as
//     zeros (TMA's fill), and boxes wholly past M or N are not loaded: they
//     only feed outputs that are never stored;
//   - two consumer warpgroups (setmaxnreg up to 232) that each multiply 64
//     rows of the tile against its 256 columns: per k-tile a wait on the
//     stage's full barrier, four m64n256k16 products, a commit, and after
//     wgmma_wait<1> (the previous k-tile's products retired) one arrive per
//     warpgroup on the previous stage's empty barrier.  No __syncthreads in
//     the loop, and no branch around the accumulator anywhere: ptxas
//     serialises every wgmma of a kernel whose accumulator is touched on a
//     divergent path (C7518), which holds it near 30% of the peak, so
//     one-thread work goes through predicated instructions;
//   - the epilogue goes through shared memory: a warpgroup writes its 64
//     rows, 128 columns at a time (the stored-hidden epilogues: H and C of
//     64 columns at a time), as bf16 into a staging tile of two
//     128-byte-swizzled 64 x 64 boxes (conflict-free from the accumulator
//     layout) and one thread stores them by TMA (cp.async.bulk.tensor,
//     clipped at M and N), which runs on while the warpgroup goes on; the
//     residual tile lands there by TMA first.  Stores straight from the
//     accumulator layout write 8 rows x 16 bytes a warp instruction and
//     cost ~6 us a 128 x 256 tile, about a third of its time at K 768.
//   - the grid is min(tiles, SMs); block b walks tiles b, b + grid, ... in a
//     grouped raster (kGemmGroupM m-tiles sweep the N tiles before the next
//     group), so that concurrent tiles share their A and W tiles in L2.
//     The producer loads the next tile's k-tiles while the consumers run
//     the epilogue.  The ring position (stage, phase parity) runs on across
//     tiles and is never reset: a thread computes it in registers from the
//     tile's place in the block's walk.
// Host side: the tensor maps are encoded per call (encode_map, tma.cuh) and
// passed as __grid_constant__ parameters; the shared-memory attribute is set
// once per instantiation and device.  Each launch adds one to
// g_core_launches[0] (common.cuh).  gemm_plan below is the launcher's choice, which
// vsd_gemm_plan (csrc/gemm.cu) reports and ops/gemm.py::gemm_plan mirrors.
// N and K must be multiples of 8 (TMA's 16-byte strides), any M.
#pragma once

#include "tma.cuh"

namespace vsd {
// Internal linkage: each library (one per csrc/*.cu) keeps its own kernels
// and its own once-per-instantiation state (a function-local static of an
// inline function would be one object across every library loaded).
namespace {

enum {
  kEpiBias = 0,
  kEpiBiasGelu = 1,
  kEpiBiasResidual = 2,
  kEpiBiasHGeluErf = 3,
  kEpiBiasHGeluTanh = 4
};

constexpr int kGemmBM = 128;      // rows of a tile: 64 a consumer warpgroup
constexpr int kGemmBN = 256;      // columns of a tile
constexpr int kGemmBK = 64;       // k of a stage
constexpr int kGemmStages = 4;
constexpr int kGemmThreads = 384; // two consumer warpgroups and a producer
constexpr int kGemmGroupM = 8;    // m-tiles of a raster group
constexpr int kGemmBox = 64 * 64 * 2;                       // one TMA box, bytes
constexpr int kGemmABytes = kGemmBM * kGemmBK * 2;          // a stage's A
constexpr int kGemmStageBytes = kGemmABytes + kGemmBK * kGemmBN * 2;
constexpr int kGemmOutBytes = 2 * kGemmBox;  // a warpgroup's staging: 64 x 128
constexpr int kGemmBarBytes = (2 * kGemmStages + 2) * 8;
// the ring, the two staging tiles, the barriers, and room to align the ring
// to the swizzle's 1024 bytes
constexpr int kGemmSmem =
    kGemmStages * kGemmStageBytes + 2 * kGemmOutBytes + kGemmBarBytes + 1024;
static_assert(kGemmSmem <= static_cast<int>(kMaxSmem), "the GEMM ring outgrows a block");

__host__ __device__ constexpr int gemm_cdiv(int a, int b) { return (a + b - 1) / b; }

// The launcher's choice for an M x N x K product on `sms` SMs.
struct GemmPlan {
  int bm, bn, bk, stages, tiles_m, tiles_n, tiles, grid, smem, group_m, threads;
};

inline GemmPlan gemm_plan(int m, int n, int k, int sms) {
  GemmPlan p{};
  p.bm = kGemmBM;
  p.bn = kGemmBN;
  p.bk = kGemmBK;
  p.stages = kGemmStages;
  p.tiles_m = gemm_cdiv(m, kGemmBM);
  p.tiles_n = gemm_cdiv(n, kGemmBN);
  p.tiles = p.tiles_m * p.tiles_n;
  p.grid = p.tiles < sms ? p.tiles : sms;
  p.smem = kGemmSmem;
  p.group_m = kGemmGroupM;
  p.threads = kGemmThreads;
  (void)k;
  return p;
}

// Tile t's (m-tile, n-tile) in the grouped raster: groups of group_m
// m-tiles, each sweeping every n-tile, m fastest inside a group.
__host__ __device__ __forceinline__ void gemm_tile(int t, int tiles_m, int tiles_n, int group_m,
                                                   int& mt, int& nt) {
  const int per_group = group_m * tiles_n;
  const int g = t / per_group;
  const int first = g * group_m;
  const int gm = tiles_m - first < group_m ? tiles_m - first : group_m;
  const int r = t - g * per_group;
  mt = first + r % gm;
  nt = r / gm;
}

// d += A (64 x 16, K-major) @ B (16 x 256, N-major), f32 accumulation, one
// warpgroup; a and b are shared-memory descriptors (gmma_desc).  Thread t
// of the warpgroup holds, for each 8-column group j, rows 16 * (t / 32) +
// (t % 32) / 4 (+ 8) and columns 8j + 2 * (t % 4) (+ 1) in d[4j .. 4j + 3].
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void setmaxnreg_dec40() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}

__device__ __forceinline__ void setmaxnreg_inc232() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// One-thread work of a warpgroup as predicated instructions (no branch):
// an mbarrier arrive, an expected-bytes arrive, a TMA load or store, the
// bulk group's commit and waits.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* b, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %1, 0;\n@q mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_addr(b)),
      "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx_if(uint64_t* b, unsigned bytes, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(smem_addr(b)),
      "r"(bytes), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d_if(void* dst, const CUtensorMap* map, int col, int row,
                                               uint64_t* b, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
      "@q cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n}\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(b)), "r"(col), "r"(row),
      "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void tma_store_2d_if(const CUtensorMap* map, int col, int row,
                                                const void* src, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %4, 0;\n"
      "@q cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n}\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(col), "r"(row), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void bulk_commit_if(bool pred) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n@q cp.async.bulk.commit_group;\n}\n" ::"r"(
                   static_cast<int>(pred))
               : "memory");
}

// Until this thread's bulk stores have read their shared memory (read) or
// are complete (all).
__device__ __forceinline__ void bulk_wait_read_if(bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n@q cp.async.bulk.wait_group.read 0;\n}\n" ::"r"(
          static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void bulk_wait_all_if(bool pred) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n@q cp.async.bulk.wait_group 0;\n}\n" ::"r"(
                   static_cast<int>(pred))
               : "memory");
}

__device__ __forceinline__ float2 ld_f2_if(const float* p, bool pred) {
  float2 v = make_float2(0.f, 0.f);
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %3, 0;\n@q ld.global.nc.v2.f32 {%0, %1}, [%2];\n}\n"
      : "+f"(v.x), "+f"(v.y)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

// mbar_wait (tma.cuh) as one asm block, its spin loop inside it, so that the
// compiler sees no divergent loop near the products; it traps after
// kTimeoutNs as mbar_wait does.
__device__ __forceinline__ void mbar_wait_spin(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, %2;\n"
      "@p bra LAB_WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(b)),
      "r"(parity), "l"(kTimeoutNs)
      : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// The epilogue of one consumer warpgroup's 64 x kGemmBN accumulator at rows
// row0 .., columns n0 .., 128 columns at a time through the warpgroup's
// staging tile `out` (two swizzled 64 x 64 boxes): kEpiBias, kEpiBiasGelu
// and kEpiBiasResidual.  Per half: its thread 0 waits until the previous
// stores have read the tile, a barrier of the warpgroup; (residual) the
// residual boxes land in it by TMA; each thread writes its bf16 pairs,
// fences them for the async proxy; a barrier; thread 0 stores the boxes by
// TMA.  rphase: the parity of rbar's next completion.
template <int EPI>
__device__ __forceinline__ void gemm_epilogue(
    const float (&acc)[kGemmBN / 2], int row0, int n0, int wg, int wt, unsigned char* out,
    uint64_t* rbar, unsigned& rphase, const CUtensorMap* cmap, const CUtensorMap* rmap,
    const float* __restrict__ bias, int N) {
  const bool lead = wt == 0;
  const int lane = wt & 31;
  const int r_lo = (wt >> 5) * 16 + (lane >> 2);  // rows r_lo, r_lo + 8 of the 64
  const int cq = (lane & 3) * 2;                  // columns cq, cq + 1 of an 8-column group
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c0 = n0 + 128 * half;
    const bool box0 = c0 < N, box1 = c0 + 64 < N;  // boxes wholly past N: no traffic
    bulk_wait_read_if(lead);
    named_sync(1 + wg, 128);
    if (EPI == kEpiBiasResidual) {
      mbar_expect_tx_if(rbar, (box0 + box1) * kGemmBox, lead);
      tma_load_2d_if(out, rmap, c0, row0, rbar, lead && box0);
      tma_load_2d_if(out + kGemmBox, rmap, c0 + 64, row0, rbar, lead && box1);
      mbar_wait_spin(rbar, rphase);
      rphase ^= 1;
    }
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {  // 8-column groups of the half
      const int j = half * 16 + jj;
      const int col = n0 + 8 * j + cq;
      const float2 bb = ld_f2_if(bias + col, col < N);  // N % 8 == 0: col + 1 < N too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_lo + 8 * h;
        uint32_t* slot = reinterpret_cast<uint32_t*>(
            out + (jj >> 3) * kGemmBox + r * 128 + (((jj & 7) ^ (r & 7)) << 4) + cq * 2);
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (EPI == kEpiBiasResidual) {
          uint32_t rb = *slot;
          const float2 rv = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&rb));
          v0 = (rv.x + v0) + bb.x;
          v1 = (rv.y + v1) + bb.y;
        } else {
          v0 += bb.x;
          v1 += bb.y;
          if (EPI == kEpiBiasGelu) {
            v0 = gelu_tanh_fast(v0);
            v1 = gelu_tanh_fast(v1);
          }
        }
        *slot = bf16x2_bits(__floats2bfloat162_rn(v0, v1));
      }
    }
    fence_proxy_async();  // this thread's writes, for the TMA store
    named_sync(1 + wg, 128);
    tma_store_2d_if(cmap, c0, row0, out, lead && box0);
    tma_store_2d_if(cmap, c0 + 64, row0, out + kGemmBox, lead && box1);
    bulk_commit_if(lead);
  }
}

// The stored-hidden epilogue (kEpiBiasHGeluErf, kEpiBiasHGeluTanh) in one
// pass over the accumulator, a 64-column box at a time: thread 0 waits
// until the previous box's stores have read the staging tile, a barrier;
// each thread rounds acc + bias to bf16 once, writes that H into the tile's
// first box and the GELU of the rounded H (gelu_erf_tail / gelu_tanh_tail,
// common.cuh) into its second, in the swizzle of gemm_epilogue; a barrier;
// thread 0 stores both boxes by TMA.  Four waits a tile, as the two passes
// (H, then C) had, but C no longer waits on H's store.
template <int EPI>
__device__ __forceinline__ void gemm_epilogue_hidden(
    const float (&acc)[kGemmBN / 2], int row0, int n0, int wg, int wt, unsigned char* out,
    const CUtensorMap* cmap, const CUtensorMap* hmap, const float* __restrict__ bias, int N) {
  const bool lead = wt == 0;
  const int lane = wt & 31;
  const int r_lo = (wt >> 5) * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int box = 0; box < kGemmBN / 64; ++box) {
    const int c0 = n0 + 64 * box;
    bulk_wait_read_if(lead);
    named_sync(1 + wg, 128);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {  // 8-column groups of the box
      const int j = box * 8 + jj;
      const int col = n0 + 8 * j + cq;
      const float2 bb = ld_f2_if(bias + col, col < N);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_lo + 8 * h;
        const int at = r * 128 + ((jj ^ (r & 7)) << 4) + cq * 2;
        const __nv_bfloat162 hv =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] + bb.x, acc[4 * j + 2 * h + 1] + bb.y);
        const float2 hf = __bfloat1622float2(hv);
        *reinterpret_cast<uint32_t*>(out + at) = bf16x2_bits(hv);
        *reinterpret_cast<uint32_t*>(out + kGemmBox + at) = bf16x2_bits(
            EPI == kEpiBiasHGeluErf
                ? __floats2bfloat162_rn(gelu_erf_tail(hf.x), gelu_erf_tail(hf.y))
                : __floats2bfloat162_rn(gelu_tanh_tail(hf.x), gelu_tanh_tail(hf.y)));
      }
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    tma_store_2d_if(hmap, c0, row0, out, lead && c0 < N);
    tma_store_2d_if(cmap, c0, row0, out + kGemmBox, lead && c0 < N);
    bulk_commit_if(lead);
  }
}

#ifdef VSD_GEMM_STAMPS
// Unit stamps, only in a build with this macro (tests/gemm_stamps.py): per
// block (the first kStampBlocks) and consumer warpgroup, %globaltimer and
// %clock64 where the warpgroup starts and where it ends, and %clock64 at
// each tile's start, when its products are done and when its epilogue is
// (the first kStampTiles tiles of its walk), all written by its thread 0.
constexpr int kStampBlocks = 160, kStampTiles = 48, kStampPer = 4 + 3 * kStampTiles;
__device__ unsigned long long g_gemm_stamps[kStampBlocks * 2 * kStampPer];

__device__ __forceinline__ unsigned long long clock_now() {
  unsigned long long c;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c)::"memory");
  return c;
}

__device__ __forceinline__ void st_u64_if(unsigned long long* p, unsigned long long v, bool pred) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q st.global.u64 [%0], %1;\n}\n" ::"l"(p),
               "l"(v), "r"(static_cast<int>(pred))
               : "memory");
}
#define GEMM_STAMP(k) \
  st_u64_if(stamps + 4 + 3 * ti + (k), clock_now(), stamping && ti < kStampTiles)
#else
#define GEMM_STAMP(k)
#endif

template <int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_tma_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap cmap,
                    const __grid_constant__ CUtensorMap hmap,
                    const __grid_constant__ CUtensorMap rmap, const float* __restrict__ bias,
                    int M, int N, int K, int tiles_m, int tiles_n, int group_m) {
  extern __shared__ __align__(1024) unsigned char gemm_smem_raw[];
  unsigned char* ring =
      gemm_smem_raw + ((1024 - (smem_addr(gemm_smem_raw) & 1023)) & 1023);
  unsigned char* outs = ring + kGemmStages * kGemmStageBytes;  // the staging tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 2 * kGemmOutBytes);
  uint64_t* empty = full + kGemmStages;
  uint64_t* rbars = empty + kGemmStages;  // a residual barrier a warpgroup
  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int tiles = tiles_m * tiles_n;
  const int ktiles = gemm_cdiv(K, kGemmBK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);  // one arrive from each consumer warpgroup
    }
    mbar_init(rbars, 1);
    mbar_init(rbars + 1, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec40();
    if (wt == 0) {
      unsigned q = 0;  // ring position
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mt, nt;
        gemm_tile(t, tiles_m, tiles_n, group_m, mt, nt);
        const int m0 = mt * kGemmBM, n0 = nt * kGemmBN;
        const int na = min(kGemmBM / 64, gemm_cdiv(M - m0, 64));
        const int nw = min(kGemmBN / 64, gemm_cdiv(N - n0, 64));
        const unsigned bytes = static_cast<unsigned>((na + nw) * kGemmBox);
        for (int kt = 0; kt < ktiles; ++kt, ++q) {
          const unsigned s = q % kGemmStages;
          mbar_wait(empty + s, ((q / kGemmStages) & 1) ^ 1);
          unsigned char* st = ring + s * kGemmStageBytes;
          mbar_expect_tx(full + s, bytes);
          for (int i = 0; i < na; ++i)
            tma_load_2d(st + i * kGemmBox, &amap, kt * kGemmBK, m0 + 64 * i, full + s);
          for (int j = 0; j < nw; ++j)
            tma_load_2d(st + kGemmABytes + j * kGemmBox, &wmap, n0 + 64 * j, kt * kGemmBK,
                        full + s);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies rows 64 wg .. + 64 of each tile
  setmaxnreg_inc232();
#ifdef VSD_GEMM_STAMPS
  unsigned long long* stamps =
      g_gemm_stamps + (min(static_cast<int>(blockIdx.x), kStampBlocks - 1) * 2 + wg) * kStampPer;
  const bool stamping = wt == 0 && blockIdx.x < kStampBlocks;
  int ti = 0;
  st_u64_if(stamps, global_ns(), stamping);
  st_u64_if(stamps + 1, clock_now(), stamping);
#endif
  float acc[kGemmBN / 2];
  unsigned q = 0, rphase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int mt, nt;
    gemm_tile(t, tiles_m, tiles_n, group_m, mt, nt);
    const int row0 = mt * kGemmBM + 64 * wg, n0 = nt * kGemmBN;
    GEMM_STAMP(0);
#pragma unroll
    for (int j = 0; j < kGemmBN / 2; ++j) acc[j] = 0.f;
    unsigned prev = 0;
    // no branch around a product: a warpgroup whose rows are all past M
    // multiplies what its stage holds, and TMA stores none of it
    for (int kt = 0; kt < ktiles; ++kt, ++q) {
      const unsigned s = q % kGemmStages;
      mbar_wait_spin(full + s, (q / kGemmStages) & 1);
      const unsigned char* st = ring + s * kGemmStageBytes;
      const bf16* as = reinterpret_cast<const bf16*>(st + wg * kGemmBox);
      const bf16* ws = reinterpret_cast<const bf16*>(st + kGemmABytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 16; ++kk)  // A: 1024 B per 8 rows; W: 8 KB per 64 columns
        wgmma_m64n256k16(acc, gmma_desc(as + kk * 16, 16, 1024),
                         gmma_desc(ws + kk * 16 * 64, 8192, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // k-tile kt - 1 has retired: its stage is free
      mbar_arrive_if(empty + prev, kt > 0 && wt == 0);
      prev = s;
    }
    wgmma_wait<0>();
    mbar_arrive_if(empty + prev, wt == 0);
    GEMM_STAMP(1);
    if constexpr (EPI == kEpiBiasHGeluErf || EPI == kEpiBiasHGeluTanh)
      gemm_epilogue_hidden<EPI>(acc, row0, n0, wg, wt, outs + wg * kGemmOutBytes, &cmap, &hmap,
                                bias, N);
    else
      gemm_epilogue<EPI>(acc, row0, n0, wg, wt, outs + wg * kGemmOutBytes, rbars + wg, rphase,
                         &cmap, &rmap, bias, N);
    GEMM_STAMP(2);
#ifdef VSD_GEMM_STAMPS
    ++ti;
#endif
  }
  bulk_wait_all_if(wt == 0);  // the last stores are done before the block's shared memory goes
#ifdef VSD_GEMM_STAMPS
  st_u64_if(stamps + 2, global_ns(), stamping);
  st_u64_if(stamps + 3, clock_now(), stamping);
#endif
}
#undef GEMM_STAMP

constexpr int kGemmMaxDevices = 64;

// Device dev's SM count, read once per device.
inline int gemm_sm_count(int dev) {
  static int counts[kGemmMaxDevices] = {0};
  if (!counts[dev] &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return counts[dev];
}

// C = epilogue(A @ W) on the caller's stream; H is written only by the
// stored-hidden epilogues, R read only by kEpiBiasResidual.  A, W, R, C and
// H are whole row-major tensors with 16-byte aligned bases.
template <int EPI>
inline cudaError_t launch_gemm(const bf16* A, const bf16* W, const float* bias, const bf16* R,
                               bf16* C, int M, int N, int K, cudaStream_t stream,
                               bf16* H = nullptr) {
  if (M <= 0) return cudaSuccess;
  if (N <= 0 || N % 8 || K <= 0 || K % 8) return cudaErrorInvalidValue;
  const bool hidden = EPI == kEpiBiasHGeluErf || EPI == kEpiBiasHGeluTanh;
  if ((EPI == kEpiBiasResidual && !R) || (hidden && !H)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(W) |
       reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(R) |
       reinterpret_cast<uintptr_t>(H)) & 15)
    return cudaErrorInvalidValue;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kGemmMaxDevices)
    return cudaErrorInvalidDevice;
  const int sms = gemm_sm_count(dev);
  if (sms <= 0) return cudaErrorInvalidDevice;
  const GemmPlan p = gemm_plan(M, N, K, sms);
  // the attribute holds for one device: set once per instantiation (and
  // library) and device
  static bool smem_set[kGemmMaxDevices] = {false};
  if (!smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_tma_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return e;
    smem_set[dev] = true;
  }
  // the outputs' and the residual's maps (a map of C where one is unused)
  CUtensorMap amap, wmap, cmap, hmap, rmap;
  if (!encode_map(&amap, A, M, K, false) || !encode_map(&wmap, W, K, N, false) ||
      !encode_map(&cmap, C, M, N, false) || !encode_map(&hmap, hidden ? H : C, M, N, false) ||
      !encode_map(&rmap, EPI == kEpiBiasResidual ? R : C, M, N, false))
    return cudaErrorInvalidValue;
  gemm_tma_kernel<EPI><<<p.grid, kGemmThreads, p.smem, stream>>>(
      amap, wmap, cmap, hmap, rmap, bias, M, N, K, p.tiles_m, p.tiles_n, p.group_m);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++g_core_launches[0];
  return e;
}

}  // namespace
}  // namespace vsd

// Key-tiled backward of the attention core on Hopper, for every shape the
// one-block-per-head backwards do not hold on chip.  Per head, for tq query
// rows against tk keys,
//
//   w  = softmax(q k^T * s), key columns >= valid_len at -1e30   (f32)
//   dv = cdt(w)^T g,  dw = g v^T,  dl = w (dw - rowsum(dw w))
//   dq = cdt(dl) k * s,  dk = cdt(dl)^T q * s
//
// where cdt is the input type (bf16, or f32 where the rounding is the
// identity).  One source serves three callers, through strides:
//   - kernel 4 (vit_spoof_detection_pda_tpu/ops/attention.py::
//     _attn_qkv_bwd_kernel, :199) past its shared memory or head dims, and
//   - kernel 5 (_attn_qkv_bwd_kernel_phased, :259) past its one launch:
//     the square tq == tk on the fused qkv [B, Tp, 3D] and g [B, Tp, D]
//     into dqkv [B, Tp, 3D] (ops/attention.py::phased_plan's "key_tiled"
//     route);
//   - kernel 13 (_attn_cp_bwd_kernel, :865) past its limits: the local
//     query block q [B, Tq, D] against the gathered kv [B, Tk, 2D] into dq
//     and this rank's partial dkv.
// It keeps kernel 5's rounding points: w = exp2(s2 - m) * (1 / l) in f32
// (the logits in base 2, as kernel 5 takes them), rowsum(dw w) summed as
// written from that w (bf16; f32, where no rounding point depends on it,
// sums it online), dl formed from the f32 w and dw after each row's full
// sum and rounded to cdt only as the operand of dq and dk, w rounded to
// cdt only as the operand of dv, every product summed in f32 and the scale
// applied after the dq and dk products.  Rows with g = 0 give dw =
// 0, hence dl = 0: pad query rows add nothing and their dq is 0; masked
// key columns have w = 0 exactly, so their dk and dv are 0.
//
// Bound on the H100 at ViT-B/16, 384 px (B = 8, Tp 584, 12 heads of 64,
// bf16): the five [Tp, Tp] x Dh products are 21.0 GFLOP, 0.021 ms at 989
// TFLOP/s, against qkv and g in and dqkv out, 50.2 MB (0.015 ms): the
// operations bind.  In f32 the same 21.0 GFLOP on the FMA units take 0.31
// ms at 67 TFLOP/s.
//
// Design.  No block can hold a head's [Tq, Tk] weights past a few hundred
// keys (the one-launch kernel 5 keeps them in registers up to 208 keys),
// and no [Tq, Tk] workspace goes to device memory (the four-launch route
// this replaces wrote and re-read 16 MB of f32 tiles an item at Tp 584).
// Instead two launches, each accumulating its outputs in registers over
// tiles of the other side staged through shared memory by 16-byte
// cp.async, double-buffered (the next tile lands while the current one is
// multiplied):
//   dq launch, grid (query tiles, heads, B), a warp per 16 query rows (bf16;
//   f32: per 16 rows, a lane on 4 of them), its q and g fragments held in
//   registers (f32: read from L1 each chunk), passes over the key tiles:
//     bf16, three (K, and V from pass 2):
//     1. the rows' max m and sum l of exp2(s2 - m), online;
//     2. dd = rowsum(dw w) with w = exp2(s2 - m) / l (s and dw again);
//     3. s and dw again, w and dl in registers, dq += cdt(dl) k;
//     f32, two: 1 and 2 in one online pass (m, l and the sum of
//     exp2(s2 - m) dw, each lane's parts rescaled as m grows and summed
//     across the row's lanes at the end: dd = that sum / l), then 3.  The
//     f32 form is held by its loads and FMAs, and the pass it saves was
//     13% of its time (1.663 against 1.900-1.914 ms at B = 8, Tp 584;
//     PERF.md, PR 11);
//   then dq * s, and each row's (m, 1 / l, dd) to a [B, H, Tq, 4] f32 stats
//   buffer (16 bytes a row; the only scratch).
//   dk / dv launch, grid (key tiles, heads, B), a warp per 16 keys (bf16;
//   f32: per 16 keys, a lane on 4 of them), its k and v fragments held in
//   registers, one pass over query tiles (Q, G and the stats staged):
//   s^T = k q^T and dw^T = v g^T, w and dl from the same f32 operations as
//   the dq launch with that row's stats, dv += cdt(w)^T g, dk += cdt(dl)^T q.
// No atomics and no reduction across blocks: every output element is
// summed by one thread in a fixed order.  The price is the recompute: the
// scores are formed four times and dw three in bf16 (ten products where
// the function needs five; f32 nine), against three launches of reads and
// writes of a [Tp, Tp] workspace.  Key tiles (and query tiles) of 64 rows at bf16,
// mma.sync m16n8k16 with ldmatrix from rows padded to Dh + 8 (any head dim
// that is a multiple of 16, not only powers of two); 32 rows at f32, plain
// FMAs (never TF32), the lanes laid out as kernel 12's f32 forms
// (attention_cp_core.cuh::CpF32): a lane holds 4 rows against every 8th
// key of a 32-key chunk, and the weights pass through a per-warp [32][20]
// buffer to the products with the staged tile.
#include "attention_cp_core.cuh"  // CpF32, cp_async_wait_upto

namespace vsd {
namespace {

constexpr int kKtWarps = 4;      // bf16: warps a block (64 query rows or keys)
constexpr int kKtTile = 64;      // bf16: keys (dq) or query rows (dk, dv) a staged tile
constexpr int kKtF32Warps = 8;   // f32: warps a block (128 query rows or keys)
constexpr int kKtF32Tile = 32;   // f32: keys or query rows a staged tile

// Shared memory of each launch: two buffers of two staged [tile][Dh + pad]
// operands (K and V, or Q and G), and for dk / dv the tile's stats; f32
// also each warp's weight buffers [32][20] (one for dq, two for dk / dv).
__host__ __device__ inline size_t kt_smem_bytes(int dh, bool f32, bool keys) {
  if (!f32) return 2 * 2 * kKtTile * (dh + 8) * sizeof(bf16) + (keys ? 2 * kKtTile * 16 : 0);
  return 2 * 2 * kKtF32Tile * (dh + 4) * sizeof(float) + (keys ? 2 * kKtF32Tile * 16 : 0) +
         kKtF32Warps * (keys ? 2 : 1) * 32 * kCpF32WStride * sizeof(float);
}

// Rows [r0, r0 + n) of one head's DH columns (row r at src + r * ld) into a
// [n][DH + 8] tile by cp.async; rows at or past t are zeros.
template <int DH>
__device__ __forceinline__ void kt_stage(bf16* dst, const bf16* src, int ld, int r0, int t,
                                         int n) {
  constexpr int LD = DH + 8, CPR = DH / 8;
  for (int c = threadIdx.x; c < n * CPR; c += blockDim.x) {
    const int r = c / CPR, col = (c % CPR) * 8;
    bf16* p = dst + r * LD + col;
    if (r0 + r < t)
      cp_async16(p, src + static_cast<size_t>(r0 + r) * ld + col);
    else
      store_zero16(p);
  }
}

// The stats of query rows [r0, r0 + n) into st [n][4]; rows at or past tq
// get (0, 0, 0): with q = 0 there, w = exp2(0) * 0 = 0.
__device__ __forceinline__ void kt_stage_stats(float* dst, const float* st, int r0, int tq,
                                               int n) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float* p = dst + r * 4;
    if (r0 + r < tq)
      cp_async16(p, st + static_cast<size_t>(r0 + r) * 4);
    else
      store_zero16(p);
  }
}

// A fragments of 16 rows r0 .. r0 + 15 (rows at or past t zeros) of a
// [t][DH] operand in device memory, every depth step at once.
template <int KK>
__device__ __forceinline__ void kt_frags(uint32_t (&a)[KK][4], const bf16* base, int ld, int r0,
                                         int t) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bool lo_in = r0 + g < t, hi_in = r0 + g + 8 < t;
  const bf16* lo = base + static_cast<size_t>(r0 + g) * ld + t4 * 2;
  const bf16* hi = lo + 8 * static_cast<size_t>(ld);
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    a[kk][0] = lo_in ? ld_global_u32(lo + kk * 16) : 0u;
    a[kk][1] = hi_in ? ld_global_u32(hi + kk * 16) : 0u;
    a[kk][2] = lo_in ? ld_global_u32(lo + kk * 16 + 8) : 0u;
    a[kk][3] = hi_in ? ld_global_u32(hi + kk * 16 + 8) : 0u;
  }
}

// c[j] = a b^T for 32 rows c0 .. c0 + 31 of a staged [rows][DH + 8] tile b
// (bfrag: this lane's ldmatrix address of the tile's row 0): c[j][0..1]
// fragment row g against tile rows c0 + 8 j + 2 t4 + {0, 1}, c[j][2..3]
// row g + 8.
template <int DH>
__device__ __forceinline__ void kt_by_rows(float (&c)[4][4], const uint32_t (&a)[DH / 16][4],
                                           uint32_t bfrag, int c0) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t b[4];
      ldmatrix_x4_at(b, bfrag + ((c0 + jp * 16) * LD + kk * 16) * 2);
      mma_16816(c[2 * jp], a[kk], b[0], b[1]);
      mma_16816(c[2 * jp + 1], a[kk], b[2], b[3]);
    }
}

// o += p x for the 16 x 16 A fragment pa against tile rows x0 .. x0 + 15 of
// a staged [rows][DH + 8] tile x (xfrag: this lane's ldmatrix.trans address
// of its row 0).
template <int DH>
__device__ __forceinline__ void kt_acc(float (&o)[DH / 8][4], const uint32_t (&pa)[4],
                                       uint32_t xfrag, int x0) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int n = 0; n < DH / 8; n += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans_at(b, xfrag + (x0 * LD + n * 8) * 2);
    mma_16816(o[n], pa, b[0], b[1]);
    mma_16816(o[n + 1], pa, b[2], b[3]);
  }
}

// The bf16 A fragment of two adjacent 8-column C tiles (16 x 16).
__device__ __forceinline__ void kt_pack(uint32_t (&pa)[4], const float (&lo)[4],
                                        const float (&hi)[4]) {
  pa[0] = pack_bf16x2(lo[0], lo[1]);
  pa[1] = pack_bf16x2(lo[2], lo[3]);
  pa[2] = pack_bf16x2(hi[0], hi[1]);
  pa[3] = pack_bf16x2(hi[2], hi[3]);
}

// Head-slice pointers of one (head, item): every operand's row r of head h
// of item b at base + b * bs + r * ld + h * DH.
struct KtArgs {
  const void *q, *k, *v, *g;
  void *dq, *dk, *dv;
  float* stats;  // [B, H, tq, 4]
  int tq, tk, ldq, ldk, ldg, valid_len;
  long long bsq, bsk, bsg;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(kKtWarps * 32)
    kt_dq_kernel(const KtArgs a) {
  constexpr int KK = DH / 16, NO = DH / 8, LD = DH + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t hoff = static_cast<size_t>(h) * DH;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.bsq + hoff;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.bsk + hoff;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.bsk + hoff;
  const bf16* gb = static_cast<const bf16*>(a.g) + b * a.bsg + hoff;
  bf16* dq = static_cast<bf16*>(a.dq) + b * a.bsq + hoff;
  float* st = a.stats + (static_cast<size_t>(b) * gridDim.y + h) * a.tq * 4;
  bf16* Kb = reinterpret_cast<bf16*>(smem);  // [2][kKtTile][LD]
  bf16* Vb = Kb + 2 * kKtTile * LD;          // [2][kKtTile][LD]
  const int tk = a.tk, ntiles = (tk + kKtTile - 1) / kKtTile;
  const float scale2 = a.scale * kLog2e;

  const int r0 = (blockIdx.x * kKtWarps + warp) * 16;
  const bool active = r0 < a.tq;
  uint32_t qa[KK][4], ga[KK][4];
  kt_frags(qa, q, a.ldq, r0, a.tq);
  kt_frags(ga, gb, a.ldg, r0, a.tq);
  const uint32_t bfrag =
      smem_addr(Kb + ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3));
  const uint32_t vfrag = bfrag + kKtTile * 2 * LD * 2;  // the same lane's row of Vb
  const uint32_t xfrag = smem_addr(Kb + (lane & 15) * LD + ((lane >> 4) << 3));

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  float dq_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  for (int pass = 0; pass < 3; ++pass) {
    // K (and V from pass 2) tile by tile, the next in flight
    kt_stage<DH>(Kb, k, a.ldk, 0, tk, kKtTile);
    if (pass) kt_stage<DH>(Vb, v, a.ldk, 0, tk, kKtTile);
    cp_async_commit();
    for (int it = 0; it < ntiles; ++it) {
      const int buf = it & 1, t0 = it * kKtTile;
      if (it + 1 < ntiles) {
        kt_stage<DH>(Kb + (buf ^ 1) * kKtTile * LD, k, a.ldk, t0 + kKtTile, tk, kKtTile);
        if (pass) kt_stage<DH>(Vb + (buf ^ 1) * kKtTile * LD, v, a.ldk, t0 + kKtTile, tk, kKtTile);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const uint32_t boff = buf * kKtTile * LD * 2;
#pragma unroll 1
        for (int c0 = 0; c0 < kKtTile && t0 + c0 < tk; c0 += 32) {
          float s[4][4];
          kt_by_rows<DH>(s, qa, bfrag + boff, c0);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = masked_logit2(s[j][e], t0 + c0 + j * 8 + t4 * 2 + (e & 1), a.valid_len,
                                      tk, scale2);
          if (pass == 0) {  // 1. online row max and sum (a quad shares a row)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float mx = -CUDART_INF_F;
#pragma unroll
              for (int j = 0; j < 4; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
              const float mn = fmaxf(m[hr], mx);
              float sum = 0.f;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                sum += exp2f(s[j][2 * hr] - mn) + exp2f(s[j][2 * hr + 1] - mn);
              sum += __shfl_xor_sync(0xffffffffu, sum, 1);
              sum += __shfl_xor_sync(0xffffffffu, sum, 2);
              l[hr] = l[hr] * exp2f(m[hr] - mn) + sum;  // exp2(-inf) = 0 on the first chunk
              m[hr] = mn;
            }
            continue;
          }
          float dw[4][4];
          kt_by_rows<DH>(dw, ga, vfrag + boff, c0);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - m[e >> 1]) * l[e >> 1];  // w
          if (pass == 1) {  // 2. this lane's part of rowsum(dw w)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) dd[e >> 1] = fmaf(dw[j][e], s[j][e], dd[e >> 1]);
            continue;
          }
          // 3. dl = w (dw - dd); dq += bf16(dl) k
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dw[j][e] = s[j][e] * (dw[j][e] - dd[e >> 1]);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            uint32_t pa[4];
            kt_pack(pa, dw[2 * t], dw[2 * t + 1]);
            kt_acc<DH>(dq_acc, pa, xfrag + boff, c0 + t * 16);
          }
        }
      }
      __syncthreads();  // the buffer is restaged two tiles on
    }
    if (pass == 0) {
      l[0] = 1.f / l[0];
      l[1] = 1.f / l[1];
    } else if (pass == 1) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dd[hr] += __shfl_xor_sync(0xffffffffu, dd[hr], 1);
        dd[hr] += __shfl_xor_sync(0xffffffffu, dd[hr], 2);
      }
    }
  }
  if (!active) return;
  const int rlo = r0 + g;
  bf16* orow = dq + static_cast<size_t>(rlo) * a.ldq + t4 * 2;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (rlo < a.tq)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16x2(dq_acc[n][0] * a.scale, dq_acc[n][1] * a.scale);
    if (rlo + 8 < a.tq)
      *reinterpret_cast<uint32_t*>(orow + 8 * static_cast<size_t>(a.ldq) + n * 8) =
          pack_bf16x2(dq_acc[n][2] * a.scale, dq_acc[n][3] * a.scale);
  }
  if (t4 == 0) {
    if (rlo < a.tq)
      *reinterpret_cast<float4*>(st + static_cast<size_t>(rlo) * 4) =
          make_float4(m[0], l[0], dd[0], 0.f);
    if (rlo + 8 < a.tq)
      *reinterpret_cast<float4*>(st + static_cast<size_t>(rlo + 8) * 4) =
          make_float4(m[1], l[1], dd[1], 0.f);
  }
}

template <int DH>
__global__ void __launch_bounds__(kKtWarps * 32)
    kt_dkv_kernel(const KtArgs a) {
  constexpr int KK = DH / 16, NO = DH / 8, LD = DH + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t hoff = static_cast<size_t>(h) * DH;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.bsq + hoff;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.bsk + hoff;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.bsk + hoff;
  const bf16* gb = static_cast<const bf16*>(a.g) + b * a.bsg + hoff;
  bf16* dk = static_cast<bf16*>(a.dk) + b * a.bsk + hoff;
  bf16* dv = static_cast<bf16*>(a.dv) + b * a.bsk + hoff;
  const float* st = a.stats + (static_cast<size_t>(b) * gridDim.y + h) * a.tq * 4;
  bf16* Qb = reinterpret_cast<bf16*>(smem);                  // [2][kKtTile][LD]
  bf16* Gb = Qb + 2 * kKtTile * LD;                          // [2][kKtTile][LD]
  float* Sb = reinterpret_cast<float*>(Gb + 2 * kKtTile * LD);  // [2][kKtTile][4]
  const int tq = a.tq, tk = a.tk, ntiles = (tq + kKtTile - 1) / kKtTile;
  const float scale2 = a.scale * kLog2e;

  const int k0 = (blockIdx.x * kKtWarps + warp) * 16;
  const bool active = k0 < tk;
  uint32_t ka[KK][4], va[KK][4];
  kt_frags(ka, k, a.ldk, k0, tk);
  kt_frags(va, v, a.ldk, k0, tk);
  const uint32_t bfrag =
      smem_addr(Qb + ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3));
  const uint32_t gfrag = bfrag + kKtTile * 2 * LD * 2;  // the same lane's row of Gb
  const uint32_t qx = smem_addr(Qb + (lane & 15) * LD + ((lane >> 4) << 3));
  const uint32_t gx = qx + kKtTile * 2 * LD * 2;
  // this lane's two key rows, masked as in the dq launch
  const int key_lo = k0 + g, key_hi = k0 + g + 8;

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  kt_stage<DH>(Qb, q, a.ldq, 0, tq, kKtTile);
  kt_stage<DH>(Gb, gb, a.ldg, 0, tq, kKtTile);
  kt_stage_stats(Sb, st, 0, tq, kKtTile);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, t0 = it * kKtTile;
    if (it + 1 < ntiles) {
      const int nb = buf ^ 1;
      kt_stage<DH>(Qb + nb * kKtTile * LD, q, a.ldq, t0 + kKtTile, tq, kKtTile);
      kt_stage<DH>(Gb + nb * kKtTile * LD, gb, a.ldg, t0 + kKtTile, tq, kKtTile);
      kt_stage_stats(Sb + nb * kKtTile * 4, st, t0 + kKtTile, tq, kKtTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const uint32_t boff = buf * kKtTile * LD * 2;
      const float* S = Sb + buf * kKtTile * 4;
#pragma unroll 1
      for (int c0 = 0; c0 < kKtTile && t0 + c0 < tq; c0 += 32) {
        float s[4][4], dw[4][4];  // [keys g, g + 8] x [query rows c0 + 8 j + 2 t4 + {0, 1}]
        kt_by_rows<DH>(s, ka, bfrag + boff, c0);
        kt_by_rows<DH>(dw, va, gfrag + boff, c0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 sr = *reinterpret_cast<const float4*>(S + (c0 + j * 8 + t4 * 2 + (e & 1)) * 4);
            const float s2 = masked_logit2(s[j][e], e < 2 ? key_lo : key_hi, a.valid_len, tk,
                                           scale2);
            const float w = exp2f(s2 - sr.x) * sr.y;
            dw[j][e] = w * (dw[j][e] - sr.z);  // dl
            s[j][e] = w;
          }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          uint32_t pa[4];
          kt_pack(pa, s[2 * t], s[2 * t + 1]);
          kt_acc<DH>(dv_acc, pa, gx + boff, c0 + t * 16);
          kt_pack(pa, dw[2 * t], dw[2 * t + 1]);
          kt_acc<DH>(dk_acc, pa, qx + boff, c0 + t * 16);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  bf16* krow = dk + static_cast<size_t>(key_lo) * a.ldk + t4 * 2;
  bf16* vrow = dv + static_cast<size_t>(key_lo) * a.ldk + t4 * 2;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (key_lo < tk) {
      *reinterpret_cast<uint32_t*>(krow + n * 8) =
          pack_bf16x2(dk_acc[n][0] * a.scale, dk_acc[n][1] * a.scale);
      *reinterpret_cast<uint32_t*>(vrow + n * 8) = pack_bf16x2(dv_acc[n][0], dv_acc[n][1]);
    }
    if (key_hi < tk) {
      *reinterpret_cast<uint32_t*>(krow + 8 * static_cast<size_t>(a.ldk) + n * 8) =
          pack_bf16x2(dk_acc[n][2] * a.scale, dk_acc[n][3] * a.scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * static_cast<size_t>(a.ldk) + n * 8) =
          pack_bf16x2(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: lane (rq = lane / 8, kl = lane % 8) of a warp holds rows 4 rq .. + 3
// of its 16 (query rows in the dq launch, keys in the dk / dv launch)
// against the tile's every 8th row kl, kl + 8, ... of a 32-row chunk.
// ---------------------------------------------------------------------------

// Rows [r0, r0 + n) of a head operand into a [n][DH + 4] tile by cp.async;
// rows at or past t are zeros.
template <int DH>
__device__ __forceinline__ void kt_stage_f32(float* dst, const float* src, int ld, int r0, int t,
                                             int n) {
  CpF32<DH>::stage(dst, src + static_cast<size_t>(r0) * ld, ld, t - r0, 0, n);
}

// s[r][j] = a_r . x_{c0 + 8 j + kl} for this lane's 4 device-memory rows
// a (row r at a + (rb + r) * lda, zeros at or past t) and the staged tile x.
template <int DH>
__device__ __forceinline__ void kt_dots_f32(float (&s)[4][4], const float* a, int lda, int rb,
                                            int t, const float* x, int c0, int kl) {
  using F = CpF32<DH>;
#pragma unroll
  for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DH; c += 4) {
    float4 av[4];
    F::load_q(av, a, lda, rb, t, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(x + (c0 + j * 8 + kl) * F::LD + c);
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r][j] = F::dot4(s[r][j], av[r], xv);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kKtF32Warps * 32)
    kt_dq_f32_kernel(const KtArgs a) {
  using F = CpF32<DH>;
  constexpr int LD = F::LD, NO = F::NO;
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rq = lane >> 3, kl = lane & 7;
  const size_t hoff = static_cast<size_t>(h) * DH;
  const float* q = static_cast<const float*>(a.q) + b * a.bsq + hoff;
  const float* k = static_cast<const float*>(a.k) + b * a.bsk + hoff;
  const float* v = static_cast<const float*>(a.v) + b * a.bsk + hoff;
  const float* gb = static_cast<const float*>(a.g) + b * a.bsg + hoff;
  float* dq = static_cast<float*>(a.dq) + b * a.bsq + hoff;
  float* st = a.stats + (static_cast<size_t>(b) * gridDim.y + h) * a.tq * 4;
  float* Kb = reinterpret_cast<float*>(smem);                // [2][kKtF32Tile][LD]
  float* Vb = Kb + 2 * kKtF32Tile * LD;                      // [2][kKtF32Tile][LD]
  float* wb = Vb + 2 * kKtF32Tile * LD + warp * 32 * kCpF32WStride;  // [32][20]
  const int tq = a.tq, tk = a.tk, ntiles = (tk + kKtF32Tile - 1) / kKtF32Tile;
  const float scale2 = a.scale * kLog2e;

  const int r0 = (blockIdx.x * kKtF32Warps + warp) * 16;
  const int rb = r0 + rq * 4;  // this lane's first query row
  const bool active = r0 < tq;
  float m[4], l[4], dd[4], o[4][NO];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = -CUDART_INF_F, l[r] = 0.f, dd[r] = 0.f;
  F::zero(o);

  for (int pass = 0; pass < 2; ++pass) {
    kt_stage_f32<DH>(Kb, k, a.ldk, 0, tk, kKtF32Tile);
    kt_stage_f32<DH>(Vb, v, a.ldk, 0, tk, kKtF32Tile);
    cp_async_commit();
    for (int it = 0; it < ntiles; ++it) {
      const int buf = it & 1, t0 = it * kKtF32Tile;
      if (it + 1 < ntiles) {
        kt_stage_f32<DH>(Kb + (buf ^ 1) * kKtF32Tile * LD, k, a.ldk, t0 + kKtF32Tile, tk,
                         kKtF32Tile);
        kt_stage_f32<DH>(Vb + (buf ^ 1) * kKtF32Tile * LD, v, a.ldk, t0 + kKtF32Tile, tk,
                         kKtF32Tile);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const float* Kt = Kb + buf * kKtF32Tile * LD;
        const float* Vt = Vb + buf * kKtF32Tile * LD;
        float s[4][4];
        kt_dots_f32<DH>(s, q, a.ldq, rb, tq, Kt, 0, kl);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[r][j] = masked_logit2(s[r][j], t0 + j * 8 + kl, a.valid_len, tk, scale2);
        float dw[4][4];
        kt_dots_f32<DH>(dw, gb, a.ldg, rb, tq, Vt, 0, kl);
        if (pass == 0) {  // 1. online row max, sum and sum of p dw (this lane's parts)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float mn = fmaxf(
                m[r], F::row_max(fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]))));
            const float corr = exp2f(m[r] - mn);
            float sum = 0.f, dsum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float p = exp2f(s[r][j] - mn);
              sum += p;
              dsum = fmaf(p, dw[r][j], dsum);
            }
            l[r] = l[r] * corr + sum;
            dd[r] = dd[r] * corr + dsum;
            m[r] = mn;
          }
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[r][j] = exp2f(s[r][j] - m[r]) * l[r];  // w
          {  // 2. dl = w (dw - dd) through the warp's buffer; dq += dl k
#pragma unroll
            for (int j = 0; j < 4; ++j)
              *reinterpret_cast<float4*>(wb + (j * 8 + kl) * kCpF32WStride + rq * 4) =
                  make_float4(s[0][j] * (dw[0][j] - dd[0]), s[1][j] * (dw[1][j] - dd[1]),
                              s[2][j] * (dw[2][j] - dd[2]), s[3][j] * (dw[3][j] - dd[3]));
            __syncwarp();
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (t0 + j * 8 < tk) F::pv8(o, wb, j * 8, Kt, j * 8, rq, kl);
            __syncwarp();  // wb is rewritten by the next tile
          }
        }
      }
      __syncthreads();
    }
    if (pass == 0)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        l[r] = 1.f / F::row_sum(l[r]);
        dd[r] = F::row_sum(dd[r]) * l[r];
      }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NO; ++i) o[r][i] *= a.scale;
  F::store(o, dq, a.ldq, rb, tq, kl);
  if (kl == 0)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (rb + r < tq)
        *reinterpret_cast<float4*>(st + static_cast<size_t>(rb + r) * 4) =
            make_float4(m[r], l[r], dd[r], 0.f);
}

template <int DH>
__global__ void __launch_bounds__(kKtF32Warps * 32)
    kt_dkv_f32_kernel(const KtArgs a) {
  using F = CpF32<DH>;
  constexpr int LD = F::LD, NO = F::NO;
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kq = lane >> 3, ql = lane & 7;
  const size_t hoff = static_cast<size_t>(h) * DH;
  const float* q = static_cast<const float*>(a.q) + b * a.bsq + hoff;
  const float* k = static_cast<const float*>(a.k) + b * a.bsk + hoff;
  const float* v = static_cast<const float*>(a.v) + b * a.bsk + hoff;
  const float* gb = static_cast<const float*>(a.g) + b * a.bsg + hoff;
  float* dk = static_cast<float*>(a.dk) + b * a.bsk + hoff;
  float* dv = static_cast<float*>(a.dv) + b * a.bsk + hoff;
  const float* st = a.stats + (static_cast<size_t>(b) * gridDim.y + h) * a.tq * 4;
  float* Qb = reinterpret_cast<float*>(smem);                // [2][kKtF32Tile][LD]
  float* Gb = Qb + 2 * kKtF32Tile * LD;                      // [2][kKtF32Tile][LD]
  float* Sb = Gb + 2 * kKtF32Tile * LD;                      // [2][kKtF32Tile][4]
  float* wb = Sb + 2 * kKtF32Tile * 4 + warp * 2 * 32 * kCpF32WStride;  // w [32][20]
  float* lb = wb + 32 * kCpF32WStride;                                  // dl [32][20]
  const int tq = a.tq, tk = a.tk, ntiles = (tq + kKtF32Tile - 1) / kKtF32Tile;
  const float scale2 = a.scale * kLog2e;

  const int k0 = (blockIdx.x * kKtF32Warps + warp) * 16;
  const int kb = k0 + kq * 4;  // this lane's first key
  const bool active = k0 < tk;
  float ok[4][NO], ov[4][NO];
  F::zero(ok);
  F::zero(ov);

  kt_stage_f32<DH>(Qb, q, a.ldq, 0, tq, kKtF32Tile);
  kt_stage_f32<DH>(Gb, gb, a.ldg, 0, tq, kKtF32Tile);
  kt_stage_stats(Sb, st, 0, tq, kKtF32Tile);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, t0 = it * kKtF32Tile;
    if (it + 1 < ntiles) {
      const int nb = buf ^ 1;
      kt_stage_f32<DH>(Qb + nb * kKtF32Tile * LD, q, a.ldq, t0 + kKtF32Tile, tq, kKtF32Tile);
      kt_stage_f32<DH>(Gb + nb * kKtF32Tile * LD, gb, a.ldg, t0 + kKtF32Tile, tq, kKtF32Tile);
      kt_stage_stats(Sb + nb * kKtF32Tile * 4, st, t0 + kKtF32Tile, tq, kKtF32Tile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* Qt = Qb + buf * kKtF32Tile * LD;
      const float* Gt = Gb + buf * kKtF32Tile * LD;
      const float* S = Sb + buf * kKtF32Tile * 4;
      float s[4][4], dw[4][4];  // [keys kb + r] x [query rows t0 + 8 j + ql]
      kt_dots_f32<DH>(s, k, a.ldk, kb, tk, Qt, 0, ql);
      kt_dots_f32<DH>(dw, v, a.ldk, kb, tk, Gt, 0, ql);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 sr = *reinterpret_cast<const float4*>(S + (j * 8 + ql) * 4);
        float w[4], dl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          w[r] = exp2f(masked_logit2(s[r][j], kb + r, a.valid_len, tk, scale2) - sr.x) * sr.y;
          dl[r] = w[r] * (dw[r][j] - sr.z);
        }
        *reinterpret_cast<float4*>(wb + (j * 8 + ql) * kCpF32WStride + kq * 4) =
            make_float4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<float4*>(lb + (j * 8 + ql) * kCpF32WStride + kq * 4) =
            make_float4(dl[0], dl[1], dl[2], dl[3]);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t0 + j * 8 < tq) {
          F::pv8(ov, wb, j * 8, Gt, j * 8, kq, ql);  // dv += w^T g
          F::pv8(ok, lb, j * 8, Qt, j * 8, kq, ql);  // dk += dl^T q
        }
      __syncwarp();
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NO; ++i) ok[r][i] *= a.scale;
  F::store(ok, dk, a.ldk, kb, tk, ql);
  F::store(ov, dv, a.ldk, kb, tk, ql);
}

template <typename Kernel>
cudaError_t kt_launch(Kernel kernel, const KtArgs& a, int rows, int rows_a_block, int threads,
                      size_t smem, int heads, int batch, cudaStream_t stream) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<dim3((rows + rows_a_block - 1) / rows_a_block, heads, batch), threads, smem, stream>>>(
      a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_tiled(const KtArgs& a, bool f32, int heads, int batch, cudaStream_t s) {
  cudaError_t e;
  if (f32) {
    e = kt_launch(kt_dq_f32_kernel<DH>, a, a.tq, 16 * kKtF32Warps, 32 * kKtF32Warps,
                  kt_smem_bytes(DH, true, false), heads, batch, s);
    if (e != cudaSuccess) return e;
    return kt_launch(kt_dkv_f32_kernel<DH>, a, a.tk, 16 * kKtF32Warps, 32 * kKtF32Warps,
                     kt_smem_bytes(DH, true, true), heads, batch, s);
  }
  e = kt_launch(kt_dq_kernel<DH>, a, a.tq, 16 * kKtWarps, 32 * kKtWarps,
                kt_smem_bytes(DH, false, false), heads, batch, s);
  if (e != cudaSuccess) return e;
  return kt_launch(kt_dkv_kernel<DH>, a, a.tk, 16 * kKtWarps, 32 * kKtWarps,
                   kt_smem_bytes(DH, false, true), heads, batch, s);
}

}  // namespace
}  // namespace vsd

// The key-tiled attention backward over head slices.  q, g, dq: rows of
// item b at + b * bsq (g: bsg) + r * ldq (g: ldg); k, v, dk, dv at + b *
// bsk + r * ldk; head h's columns h * dh .. + dh - 1 of each row (dq shares
// q's strides, dk and dv share k's).  All bf16 (dtype 0) or all f32 (dtype
// 1), 16-byte aligned, row strides multiples of 8 (bf16) or 4 (f32).  stats
// is an f32 [B, H, tq, 4] scratch.  Needs a head dim that is a multiple of
// 16 up to 128, 0 < valid_len <= tk, B and H up to 65535, and g zero on
// query rows whose gradient should not count.  Two launches on ``stream``;
// returns the first CUDA error (0 on success).
extern "C" int vsd_attention_bwd_tiled(const void* q, const void* k, const void* v,
                                       const void* g, void* dq, void* dk, void* dv, void* stats,
                                       int dtype, int batch, int heads, int dh, int tq, int tk,
                                       int ldq, int ldk, int ldg, long long bsq, long long bsk,
                                       long long bsg, int valid_len, float scale, void* stream) {
  using namespace vsd;
  const int align = dtype == 0 ? 8 : 4;
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 || tq <= 0 || tk <= 0 ||
      valid_len <= 0 || valid_len > tk || (dtype != 0 && dtype != 1) || ldq % align ||
      ldk % align || ldg % align || ldq < heads * dh || ldk < heads * dh || ldg < heads * dh)
    return cudaErrorInvalidValue;
  const KtArgs a{q,   k,   v,   g,   dq,  dk,        dv,  static_cast<float*>(stats),
                 tq,  tk,  ldq, ldk, ldg, valid_len, bsq, bsk,
                 bsg, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
#define VSD_HEAD_DIM(DH) \
  case DH:               \
    return launch_tiled<DH>(a, dtype == 1, heads, batch, s);
    VSD_HEAD_DIM(16)
    VSD_HEAD_DIM(32)
    VSD_HEAD_DIM(48)
    VSD_HEAD_DIM(64)
    VSD_HEAD_DIM(80)
    VSD_HEAD_DIM(96)
    VSD_HEAD_DIM(112)
    VSD_HEAD_DIM(128)
#undef VSD_HEAD_DIM
    default:
      return cudaErrorInvalidValue;
  }
}

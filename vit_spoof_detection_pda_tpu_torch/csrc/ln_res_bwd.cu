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
// Design: one launch, a grid sized to the card.  ln_plan gives
// min(ceil(rows / 16), k * SMs) blocks of 8 warps, k the blocks of the
// instance that fit an SM (the occupancy API, read once per device), so
// every block runs in the first wave; block i takes the contiguous rows
// [i * rows / blocks, (i + 1) * rows / blocks), its warp w the rows w, w +
// 8, ... of them.  A warp holds a row as each lane's 8 columns of every
// 256, so its two means are two warp reductions.  Its rows stream through a
// two-stage cp.async ring of row tiles (xhat, dxn, g and inv) in shared
// memory: the next row's loads are in flight while it reduces the current
// one, and no register holds them until they are read.  Each lane copies
// and reads only its own columns, so the ring needs no barrier but the
// lane's own wait (and one __syncwarp for inv, which lane 0 copies).
//
// The parameter sums in the same launch, in a fixed order: per lane in
// registers over its warp's rows, then the 8 warps in order through shared
// memory into the block's partial row.  Each block then takes a ticket
// (a counter in device memory, after __threadfence()); the last
// `finishers` (up to 128) blocks to take one wait for the rest and add the
// partial rows in block order, each its own slice of the columns, so the
// tail reads every partial row once across as many SMs, not all of them
// through one SM (a two-level sum, by the last block of each group and
// then by the last group, took 6-8 us on the H100, PERF.md).  The last
// finisher resets the counters, so they (zeroed once by the wrapper) stay
// zero between calls without a memset.  No float atomics, so the sums are
// the same from run to run on one card.
// Rows with dxn = g = 0 (padding) give dx = 0 and add nothing.  D must be a
// multiple of 8 up to 1024.  Types: xhat, g and dx are bf16 (dxn bf16 or
// f32) or all four are f32; one template covers both, so the f32 form sums
// in the same fixed order.
#include "common.cuh"

namespace vsd {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;
constexpr int kMaxD = 1024;
constexpr int kRowsMin = 16;      // rows a block takes at least (two a warp)
constexpr int kFinishers = 128;   // blocks that add the partial rows, at most
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

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

// 8 elements of T from device memory to shared memory, 16 bytes a copy.
template <typename T>
__device__ __forceinline__ void copy8(T* s, const T* g) {
#pragma unroll
  for (int q = 0; q < static_cast<int>(sizeof(T)) / 2; ++q)
    cp_async16(s + q * 16 / sizeof(T), g + q * 16 / sizeof(T));
}

// One warp's stage: [xhat d][dxn d][g d][inv], 16-byte aligned parts.
template <typename TX, typename TD>
__host__ __device__ constexpr long long stage_bytes(int d) {
  return static_cast<long long>(d) * (2 * sizeof(TX) + sizeof(TD)) + 16;
}

template <typename TX, typename TD>
__host__ __device__ constexpr long long smem_bytes(int d) {
  return kWarps * kStages * stage_bytes<TX, TD>(d) + static_cast<long long>(d) * 4;
}

struct LnArgs {
  const void* xh;
  const float* inv;
  const void* dxn;
  const void* g;
  const float* lns;
  void* dx;
  float* partial;     // [2][blocks][d]: the blocks' partial rows
  unsigned* tickets;  // [2]: arrived, finishers done; zero between calls
  float* dscale;
  float* dbias;
  int rows, d, blocks, finishers;
};

// NCH: 256-column chunks of a row (lane holds columns 256j + 8 lane .. + 7).
// TX: the type of xh, g and dx; TD: of dxn.
template <typename TX, typename TD, int NCH>
__global__ void __launch_bounds__(kThreads)
    ln_res_bwd_kernel(const LnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned ticket;
  const int d = a.d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const TX* xh = static_cast<const TX*>(a.xh);
  const TD* dxn = static_cast<const TD*>(a.dxn);
  const TX* g = static_cast<const TX*>(a.g);
  TX* dx = static_cast<TX*>(a.dx);
  const long long sb = stage_bytes<TX, TD>(d);
  float* sc = reinterpret_cast<float*>(smem + kWarps * kStages * sb);  // LN scale [d]
  for (int c = threadIdx.x; c < d; c += kThreads) sc[c] = a.lns[c];

  // this block's rows, and this warp's share of them
  const long long rb = static_cast<long long>(blockIdx.x) * a.rows / a.blocks;
  const long long re = static_cast<long long>(blockIdx.x + 1) * a.rows / a.blocks;
  const int nr = re - rb > warp ? static_cast<int>((re - rb - warp + kWarps - 1) / kWarps) : 0;

  auto stage = [&](int s) { return smem + (warp * kStages + s) * sb; };
  auto issue = [&](int i) {  // row i of this warp into stage i % kStages
    if (i < nr) {
      unsigned char* st = stage(i % kStages);
      const long long row = rb + warp + static_cast<long long>(i) * kWarps;
      const size_t off = static_cast<size_t>(row) * d;
      TX* sx = reinterpret_cast<TX*>(st);
      TD* sd = reinterpret_cast<TD*>(st + d * sizeof(TX));
      TX* sg = reinterpret_cast<TX*>(st + d * (sizeof(TX) + sizeof(TD)));
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int c = 256 * j + lane * 8;
        if (c < d) {
          copy8(sx + c, xh + off + c);
          copy8(sd + c, dxn + off + c);
          copy8(sg + c, g + off + c);
        }
      }
      if (lane == 0) cp_async4(st + sb - 16, a.inv + row);
    }
    cp_async_commit();  // an empty group past the last row keeps the count
  };

  float acc_s[NCH][8], acc_b[NCH][8];
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc_s[j][i] = acc_b[j][i] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages; ++i) issue(i);
  __syncthreads();  // sc
  for (int i = 0; i < nr; ++i) {
    cp_async_wait<kStages - 1>();  // row i has landed (its lane's part)
    __syncwarp();                  // and lane 0's inv
    const unsigned char* st = stage(i % kStages);
    const TX* sx = reinterpret_cast<const TX*>(st);
    const TD* sd = reinterpret_cast<const TD*>(st + d * sizeof(TX));
    const TX* sg = reinterpret_cast<const TX*>(st + d * (sizeof(TX) + sizeof(TD)));
    const float iv = *reinterpret_cast<const float*>(st + sb - 16);
    float s1 = 0.f, s2 = 0.f;
    float xv[NCH][8], dv[NCH][8];  // kept for the second pass
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = 256 * j + lane * 8;
      if (c >= d) continue;
      float sv[8];
      load8(sx + c, xv[j]);
      load8(sd + c, dv[j]);
      load8(sc + c, sv);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float dh = dv[j][q] * sv[q];
        s1 += dh;
        s2 += dh * xv[j][q];
        acc_s[j][q] += dv[j][q] * xv[j][q];
        acc_b[j][q] += dv[j][q];
      }
    }
    const float m1 = warp_sum(s1) / static_cast<float>(d);
    const float m2 = warp_sum(s2) / static_cast<float>(d);
    const size_t off = static_cast<size_t>(rb + warp + static_cast<long long>(i) * kWarps) * d;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = 256 * j + lane * 8;
      if (c >= d) continue;
      float sv[8], gv[8], o[8];
      load8(sc + c, sv);
      load8(sg + c, gv);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        o[q] = gv[q] + iv * ((dv[j][q] * sv[q] - m1) - xv[j][q] * m2);
      store8(dx + off + c, o);
    }
    __syncwarp();  // every lane has read inv before lane 0 refills the stage
    issue(i + kStages);
  }
  cp_async_wait<0>();

  // the block's partial row: each warp's sums in shared memory (the ring's
  // room), then the 8 warps added in order, one column a thread
  __syncthreads();
  float* red_s = reinterpret_cast<float*>(smem);  // [kWarps][d]
  float* red_b = red_s + kWarps * d;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = 256 * j + lane * 8;
    if (c < d) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        red_s[warp * d + c + q] = acc_s[j][q];
        red_b[warp * d + c + q] = acc_b[j][q];
      }
    }
  }
  __syncthreads();
  float* ps = a.partial + static_cast<size_t>(blockIdx.x) * d;
  float* pb = a.partial + (static_cast<size_t>(a.blocks) + blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float ts = 0.f, tb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ts += red_s[w * d + c];
      tb += red_b[w * d + c];
    }
    ps[c] = ts;
    pb[c] = tb;
  }

  // The sums across blocks.  Each block takes a ticket after its partial
  // row is out; the last `finishers` blocks to take one wait until every
  // block has, then each adds its slice of the 2d columns over all blocks'
  // partial rows, in block order: thread (column, chunk) adds a contiguous
  // run of blocks, and the chunks are added in order.  The last finisher
  // past its wait resets both counters.  The grid fits on the card at once
  // (ln_plan), and a finisher waits only for blocks still running or not
  // yet placed, which the exited blocks' room takes, so the wait ends.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(a.tickets, 1u);
  __syncthreads();
  const int rank = static_cast<int>(ticket) - (a.blocks - a.finishers);
  if (rank < 0) return;
  if (threadIdx.x == 0) {
    volatile unsigned* arrived = a.tickets;
    while (*arrived < static_cast<unsigned>(a.blocks)) __nanosleep(32);
    // past its wait: the last finisher here resets both counters (no block
    // reads them again in this launch)
    if (atomicAdd(a.tickets + 1, 1u) == static_cast<unsigned>(a.finishers - 1)) {
      a.tickets[0] = 0u;
      a.tickets[1] = 0u;
    }
  }
  __syncthreads();
  __threadfence();
  const int v0 = static_cast<int>(2LL * d * rank / a.finishers);
  const int nv = static_cast<int>(2LL * d * (rank + 1) / a.finishers) - v0;
  int chunks = kThreads / nv < a.blocks ? kThreads / nv : a.blocks;
  if (chunks < 1) chunks = 1;
  float* part = reinterpret_cast<float*>(smem);  // [chunks][nv]
  for (int i = threadIdx.x; i < chunks * nv; i += kThreads) {
    const int col = i % nv, ch = i / nv;
    const int v = v0 + col;  // [0, d): dscale; [d, 2d): dbias
    const float* src =
        a.partial + (v < d ? v : static_cast<size_t>(a.blocks) * d + (v - d));
    const int k0 = a.blocks * ch / chunks, k1 = a.blocks * (ch + 1) / chunks;
    float acc = 0.f;
#pragma unroll 16
    for (int k = k0; k < k1; ++k) acc += __ldcg(src + static_cast<size_t>(k) * d);
    part[i] = acc;
  }
  __syncthreads();
  for (int col = threadIdx.x; col < nv; col += kThreads) {
    float acc = 0.f;
    for (int ch = 0; ch < chunks; ++ch) acc += part[ch * nv + col];
    const int v = v0 + col;
    if (v < d) a.dscale[v] = acc; else a.dbias[v - d] = acc;
  }
}

// The launch geometry of one call: blocks, finishers (the blocks that add
// the partial rows), the scratch floats ([2][blocks][d] partials), the
// tickets, the instance's blocks an SM, the SMs and the shared memory.
struct LnPlan {
  int blocks, finishers;
  long long scratch, tickets;
  int per_sm, sms;
  long long smem;
};

template <typename TX, typename TD, int NCH>
cudaError_t instance_per_sm(int dev, long long smem, int* per_sm) {
  static int cache[kMaxDevices] = {0};
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!cache[dev]) {
    auto kernel = ln_res_bwd_kernel<TX, TD, NCH>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cache[dev], kernel,
                                                        kThreads,
                                                        static_cast<size_t>(smem));
    if (e != cudaSuccess) return e;
    if (!cache[dev]) return cudaErrorInvalidConfiguration;
  }
  *per_sm = cache[dev];
  return cudaSuccess;
}

int sm_count(int dev) {
  static int counts[kMaxDevices] = {0};
  if (dev < 0 || dev >= kMaxDevices) return 0;
  if (!counts[dev] &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return counts[dev];
}

template <typename TX, typename TD, int NCH>
cudaError_t plan_nch(int rows, int d, LnPlan* p) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  p->sms = sm_count(dev);
  if (!p->sms) return cudaErrorInvalidDevice;
  // occupancy at the widest d of this instance, so that it does not change
  // with d within the instance
  e = instance_per_sm<TX, TD, NCH>(dev, smem_bytes<TX, TD>(256 * NCH), &p->per_sm);
  if (e != cudaSuccess) return e;
  p->smem = smem_bytes<TX, TD>(d);
  const long long want = (static_cast<long long>(rows) + kRowsMin - 1) / kRowsMin;
  const long long cap = static_cast<long long>(p->per_sm) * p->sms;
  p->blocks = static_cast<int>(want < 1 ? 1 : want < cap ? want : cap);
  p->finishers = p->blocks < kFinishers ? p->blocks : kFinishers;
  if (p->finishers > 2 * d) p->finishers = 2 * d;  // at least a column each
  p->scratch = 2LL * p->blocks * d;
  p->tickets = 2;
  return cudaSuccess;
}

template <typename TX, typename TD>
cudaError_t plan(int rows, int d, LnPlan* p) {
  switch ((d + 255) / 256) {
    case 1: return plan_nch<TX, TD, 1>(rows, d, p);
    case 2: return plan_nch<TX, TD, 2>(rows, d, p);
    case 3: return plan_nch<TX, TD, 3>(rows, d, p);
    case 4: return plan_nch<TX, TD, 4>(rows, d, p);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t ln_plan(int rows, int d, int dxn_f32, int x_f32, LnPlan* p) {
  if (rows < 0 || d <= 0 || d % 8 || d > kMaxD || (x_f32 && !dxn_f32))
    return cudaErrorInvalidValue;
  if (x_f32) return plan<float, float>(rows, d, p);
  if (dxn_f32) return plan<bf16, float>(rows, d, p);
  return plan<bf16, bf16>(rows, d, p);
}

template <typename TX, typename TD>
cudaError_t launch(const LnArgs& a, long long smem, cudaStream_t s) {
  const int n = static_cast<int>(smem);
  switch ((a.d + 255) / 256) {
#define VSD_CHUNKS(N)                                                            \
  case N:                                                                        \
    ln_res_bwd_kernel<TX, TD, N><<<a.blocks, kThreads, n, s>>>(a);               \
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

// The launch plan of a call on the current device (the one rule the
// launcher runs): out = [blocks, finishers, scratch floats, tickets, blocks
// an SM, SMs, shared memory bytes].  The wrapper sizes the
// scratch and the ticket counters by it.  Returns a CUDA error (0: ok).
extern "C" int vsd_ln_res_bwd_plan(int rows, int d, int dxn_f32, int x_f32, long long* out) {
  using namespace vsd;
  LnPlan p;
  const cudaError_t e = ln_plan(rows, d, dxn_f32, x_f32, &p);
  if (e != cudaSuccess) return e;
  const long long v[7] = {p.blocks, p.finishers, p.scratch, p.tickets, p.per_sm, p.sms, p.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return cudaSuccess;
}

// xh, g, dx [rows, d] bf16 (x_f32 = 0) or f32 (x_f32 = 1); inv [rows] f32;
// dxn [rows, d] bf16 (dxn_f32 = 0) or f32 (dxn_f32 = 1), f32 when x_f32;
// lns, dscale, dbias [d] f32; scratch: the plan's scratch floats;
// tickets: n_tickets unsigned ints, zero before the first call (each call
// leaves them zero).  16-byte aligned operands.  One launch; returns its
// CUDA error (0 on success).
extern "C" int vsd_ln_res_bwd(const void* xh, const void* inv, const void* dxn, const void* g,
                              const void* lns, void* dx, void* scratch, void* dscale,
                              void* dbias, void* tickets, long long n_scratch,
                              long long n_tickets, int rows, int d, int dxn_f32, int x_f32,
                              void* stream) {
  using namespace vsd;
  LnPlan p;
  cudaError_t e = ln_plan(rows, d, dxn_f32, x_f32, &p);
  if (e != cudaSuccess) return e;
  if (n_scratch < p.scratch || n_tickets < p.tickets) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(xh) | reinterpret_cast<uintptr_t>(dxn) |
       reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx)) & 15)
    return cudaErrorMisalignedAddress;
  LnArgs a;
  a.xh = xh;
  a.inv = static_cast<const float*>(inv);
  a.dxn = dxn;
  a.g = g;
  a.lns = static_cast<const float*>(lns);
  a.dx = dx;
  a.partial = static_cast<float*>(scratch);
  a.tickets = static_cast<unsigned*>(tickets);
  a.dscale = static_cast<float*>(dscale);
  a.dbias = static_cast<float*>(dbias);
  a.rows = rows;
  a.d = d;
  a.blocks = p.blocks;
  a.finishers = p.finishers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) return launch<float, float>(a, p.smem, s);
  if (dxn_f32) return launch<bf16, float>(a, p.smem, s);
  return launch<bf16, bf16>(a, p.smem, s);
}

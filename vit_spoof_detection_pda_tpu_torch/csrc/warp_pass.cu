// One scanline pass of the gather-free warp tower on Hopper:
//
//   rows (along x):  out[b, y, x, :] = img[b, y, x + f[b, y, x], :]
//   cols (along y):  out[b, y, x, :] = img[b, y + f[b, y, x], x, :]
//
// with a 2-tap tent (linear) interpolation and zero fill where the source
// coordinate pos + f lies outside [0, n - 1].  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/warp_pallas.py::_pass_kernel (:58),
// wrappers resample_rows_field_pallas (:71) / resample_cols_field_pallas
// (:113).
//
// What the TPU kernel computes: sum over k in [-kmax, kmax] of
// max(0, 1 - |f - k|) * roll(img, -k)[pos], in f32, the output cast to the
// image dtype; out-of-frame pixels carry the sentinel f = kmax + 4, so no
// tent fires and the output is 0.  Only k0 = floor(f) and k0 + 1 can have a
// nonzero tent, so each route reads those two taps (a tap outside [-kmax,
// kmax] has no term, as in the TPU sum) and adds them in the same order
// with the same f32 roundings (__fmul_rn / __fadd_rn keep nvcc from
// contracting to an FMA), so every route matches
// ops/warp.py::warp_pass_plain bit for bit.  The TPU's roll wraps within
// the line; a wrapped tap carries weight 0 in exact arithmetic (at most
// ~1e-7 after the f32 rounding of pos + f), and the tap index is wrapped
// the same way, so no read leaves the line.  The TPU transposed the image
// for the column pass (Mosaic's sublane rotates were slow or wrong); here
// the column pass reads along y with a stride.
//
// Bound on the H100: bytes.  Image in, field in, image out; at B = 128,
// 224 x 224 x 3 bf16 with a full f32 field that is 38.5 + 25.7 + 38.5 MB,
// >= 0.031 ms at 3.35 TB/s (the rotation passes read a broadcast field of
// B x 224 floats, which the strides below pass without materializing).
//
// Design (routes chosen by shape in warp_plan.cuh, mirrored by
// ops/warp.py::warp_pass_plan): a tile of the staged routes is `lines`
// whole image rows; a block decodes each row's (b, y) once and maps warps
// onto rows and lanes onto x, so no thread divides a pixel index; C is a
// template parameter.  A tile's rows are one contiguous span of the image,
// so it moves through shared memory with 16-byte copies on the span's
// 16-byte grid (a scalar head and tail where the span's ends are off it: a
// 250 x 190 x 3 bf16 row is 1,140 bytes).  Along x (rows_staged) the input
// rows are staged and the taps (wrap included) index the staged row, so
// every source byte leaves device memory once; a persistent grid (the
// blocks that fit the card) walks the tiles through a cp.async ring, the
// next tile's copies in flight while a block computes one.  Along y
// (cols_direct) the taps come straight from device memory, where a warp's
// 32 columns share their tap rows, and a block takes one tile: the smaller
// shared-memory footprint leaves L1 to the taps (a persistent ring there
// doubled the time on a random field).  A contiguous field is staged with
// the image, with 16-byte copies; a broadcast field (stride 0 along x) is
// read once per row.  The output rows are staged and written with 16-byte
// stores.  Shapes past the staged routes' shared memory take the per-pixel
// route, one thread a pixel over a flat grid.  Tried on the card and taken
// out (PERF.md): a column strip staged over all rows, taps read as
// aligned 32-bit pairs, packed output stores, 4- and 2-row tiles, a
// three-stage ring, 512-thread blocks.
#include "common.cuh"
#include "warp_plan.cuh"

namespace vsd {
namespace {

constexpr int kThreads = kWarpThreads;
constexpr int kWarpsLog2 = 3;  // 8 warps: a tile's up to 8 rows, a warp or more each
static_assert(kThreads == 32 << kWarpsLog2, "kWarpsLog2 follows kWarpThreads");
constexpr int kMaxC = 4;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// The two taps of one pixel: line[idx * step + ch] at idx = pos + k,
// wrapped into [0, n), for k = floor(f) and floor(f) + 1 in [-kmax, kmax],
// summed in that order into acc (zero outside the frame).
template <typename T, int C>
__device__ __forceinline__ void tap_sum(const T* line, int step, int n, int pos, float f,
                                        int kmax, float (&acc)[C]) {
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.f;
  const float src = __fadd_rn(static_cast<float>(pos), f);
  if (!(src >= 0.f && src <= static_cast<float>(n - 1))) return;
  const float k0 = floorf(f);
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float k = k0 + static_cast<float>(d);
    if (k < static_cast<float>(-kmax) || k > static_cast<float>(kmax)) continue;
    const float wt = fmaxf(0.f, 1.f - fabsf(f - k));
    int idx = pos + static_cast<int>(k);
    if (static_cast<unsigned>(idx) >= static_cast<unsigned>(n)) {
      idx %= n;
      if (idx < 0) idx += n;
    }
    const T* p = line + idx * step;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = __fadd_rn(acc[ch], __fmul_rn(wt, load_f(p + ch)));
  }
}

// Elements of a T* past its 16-byte grid.
template <typename T>
__device__ __forceinline__ int off_grid(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// The head, 16-byte span count and tail of n elements at g, cut on g's
// 16-byte grid.
template <typename T>
struct Cut {
  int lead, head, nvec, tail;
  __device__ __forceinline__ Cut(const T* g, int n) {
    constexpr int V = 16 / sizeof(T);
    lead = off_grid(g);
    head = lead ? V - lead : 0;
    if (head > n) head = n;
    nvec = (n - head) / V;
    tail = n - head - nvec * V;
  }
};

// Starts copying n elements from device memory g into the shared buffer s
// (16-byte aligned, n + 16 / sizeof(T) elements long) at s + lead, so that
// both sides share one 16-byte grid: cp.async 16-byte copies in between;
// the scalar head and tail wait for finish_in.  Every thread of the block
// takes part.  Returns the buffer's data pointer.
template <typename T>
__device__ __forceinline__ T* start_in(T* s, const T* g, int n) {
  constexpr int V = 16 / sizeof(T);
  const Cut<T> k(g, n);
  T* sd = s + k.lead;
  for (int i = threadIdx.x; i < k.nvec; i += blockDim.x)
    cp_async16(sd + k.head + i * V, g + k.head + i * V);
  return sd;
}

template <typename T>
__device__ __forceinline__ void finish_in(T* sd, const T* g, int n) {
  constexpr int V = 16 / sizeof(T);
  const Cut<T> k(g, n);
  const int t = threadIdx.x;
  if (t < k.head) {
    sd[t] = g[t];
  } else if (t - k.head < k.tail) {
    const int i = k.head + k.nvec * V + (t - k.head);
    sd[i] = g[i];
  }
}

// Writes n elements of the shared buffer (data at s + lead of g) to g:
// 16-byte stores in between, a scalar head and tail.
template <typename T>
__device__ __forceinline__ void write_out(T* g, const T* sd, int n) {
  constexpr int V = 16 / sizeof(T);
  const Cut<T> k(g, n);
  const uint4* src = reinterpret_cast<const uint4*>(sd + k.head);
  uint4* dst = reinterpret_cast<uint4*>(g + k.head);
  for (int i = threadIdx.x; i < k.nvec; i += blockDim.x) dst[i] = src[i];
  const int t = threadIdx.x;
  if (t < k.head) {
    g[t] = sd[t];
  } else if (t - k.head < k.tail) {
    const int i = k.head + k.nvec * V + (t - k.head);
    g[i] = sd[i];
  }
}

// The staged routes: rows_staged (kAlongY = false) and cols_direct (true).
// A tile is `lines` consecutive image rows of the [b * h]; the grid walks
// the tiles (blockIdx.x, + gridDim.x, ...), each block through a
// kWarpStages-stage cp.async ring: the next tiles' input rows (along x) and
// contiguous field rows are in flight while it computes the current one
// into its output buffer, whose rows it then writes with 16-byte stores.
// Along y the grid is a block a tile, so only stage 0 is used.
// field_contig: the field is [b, h, w] contiguous; else it is read through
// its strides.
template <typename T, int C, bool kAlongY>
__global__ void __launch_bounds__(kThreads)
    warp_lines_kernel(const T* __restrict__ img, const float* __restrict__ field,
                      T* __restrict__ out, int h, int w, int rows, int lines_log2, long long fsb,
                      long long fsy, long long fsx, int kmax, int field_contig) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lines = 1 << lines_log2;
  const int wc = w * C;
  const int tiles = (rows + lines - 1) >> lines_log2;
  const long long tile = warp_align16(static_cast<long long>(lines) * wc * sizeof(T) + 16);
  const long long fbytes = warp_align16(static_cast<long long>(lines) * w * 4 + 16);
  // [out][in 0 .. S - 1] (in only along x) [field 0 .. S - 1]
  constexpr int S = kWarpStages;
  T* out_buf = reinterpret_cast<T*>(smem);
  auto in_buf = [&](int st) { return reinterpret_cast<T*>(smem + (1 + st) * tile); };
  auto f_buf = [&](int st) {
    return reinterpret_cast<float*>(smem + (kAlongY ? 1 : 1 + S) * tile + st * fbytes);
  };
  auto count = [&](int t) { return min(lines, rows - (t << lines_log2)); };
  auto start = [&](int t, int st) {  // tile t into stage st
    const int l0 = t << lines_log2;
    if (!kAlongY) start_in(in_buf(st), img + static_cast<long long>(l0) * wc, count(t) * wc);
    if (field_contig)
      start_in(f_buf(st), field + static_cast<long long>(l0) * w, count(t) * w);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_line_log2 = kWarpsLog2 - lines_log2;  // warps a row
  const int li = warp >> per_line_log2;
  const int x_first = ((warp & ((1 << per_line_log2) - 1)) << 5) + lane;
  const int x_step = 32 << per_line_log2;
  const int grid = gridDim.x;
  int t = blockIdx.x;
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {  // tiles t, t + grid, ... into stages 0, 1, ...
    if (t + k * grid < tiles) start(t + k * grid, k);
    cp_async_commit();
  }
  for (int it = 0; t < tiles; ++it, t += grid) {
    const int st = it % S;
    if (t + (S - 1) * grid < tiles) start(t + (S - 1) * grid, (it + S - 1) % S);
    cp_async_commit();
    cp_async_wait<S - 1>();  // tile t's copies (this thread's) have landed
    const int l0 = t << lines_log2;
    const int nl = count(t);
    const long long e0 = static_cast<long long>(l0) * wc;
    const T* in_s = nullptr;
    const float* f_s = nullptr;
    if (!kAlongY) {
      in_s = in_buf(st) + off_grid(img + e0);
      finish_in(const_cast<T*>(in_s), img + e0, nl * wc);
    }
    if (field_contig) {
      const float* fg = field + static_cast<long long>(l0) * w;
      f_s = f_buf(st) + off_grid(fg);
      finish_in(const_cast<float*>(f_s), fg, nl * w);
    }
    T* out_s = out_buf + off_grid(out + e0);
    __syncthreads();  // every thread's copies of tile t are in

    if (li < nl) {
      const int l = l0 + li;
      const int b = l / h, y = l - b * h;
      const float* fl = field_contig ? f_s + li * w : field + b * fsb + y * fsy;
      const bool fconst = !field_contig && fsx == 0;
      const float f_row = fconst ? __ldg(fl) : 0.f;
      const T* line = kAlongY ? img + static_cast<long long>(b) * h * wc : in_s + li * wc;
      T* o_row = out_s + li * wc;
      for (int x = x_first; x < w; x += x_step) {
        const float f = field_contig ? fl[x] : fconst ? f_row : __ldg(fl + x * fsx);
        float acc[C];
        if (kAlongY)
          tap_sum<T, C>(line + x * C, wc, h, y, f, kmax, acc);
        else
          tap_sum<T, C>(line, C, w, x, f, kmax, acc);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) store_f(o_row + x * C + ch, acc[ch]);
      }
    }
    __syncthreads();  // the output rows are in; stage st is free to refill
    write_out(out + e0, out_s, nl * wc);
  }
  cp_async_wait<0>();
}

// per_pixel: one thread per output pixel over a flat grid (any shape).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    warp_pass_kernel(const T* __restrict__ img, const float* __restrict__ field,
                     T* __restrict__ out, int h, int w, int c, long long npix, long long fsb,
                     long long fsy, long long fsx, int kmax, int along_y) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= npix) return;
  const int x = static_cast<int>(i % w);
  const long long t = i / w;
  const int y = static_cast<int>(t % h);
  const long long b = t / h;
  const float f = field[b * fsb + y * fsy + x * fsx];
  const int n = along_y ? h : w;
  const int pos = along_y ? y : x;
  // the line the pass reads: row y of image b, or column x
  const long long row = static_cast<long long>(w) * c;
  const T* line = img + b * h * row + (along_y ? static_cast<long long>(x) * c : y * row);
  const long long step = along_y ? row : c;

  float acc[kMaxC];
#pragma unroll
  for (int ch = 0; ch < kMaxC; ++ch) acc[ch] = 0.f;
  const float src = __fadd_rn(static_cast<float>(pos), f);
  if (src >= 0.f && src <= static_cast<float>(n - 1)) {
    const float k0 = floorf(f);
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const float k = k0 + static_cast<float>(d);
      if (k < static_cast<float>(-kmax) || k > static_cast<float>(kmax)) continue;
      const float wt = fmaxf(0.f, 1.f - fabsf(f - k));
      int idx = (pos + static_cast<int>(k)) % n;
      if (idx < 0) idx += n;
      const T* p = line + idx * step;
#pragma unroll
      for (int ch = 0; ch < kMaxC; ++ch)
        if (ch < c) acc[ch] = __fadd_rn(acc[ch], __fmul_rn(wt, load_f(p + ch)));
    }
  }
  T* o = out + i * c;
#pragma unroll
  for (int ch = 0; ch < kMaxC; ++ch)
    if (ch < c) store_f(o + ch, acc[ch]);
}

template <typename K>
cudaError_t allow_smem(K kernel, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

constexpr int kMaxDevices = 64;

// The persistent grid of the rows_staged kernel: at most `tiles` blocks,
// and no more than fit on the card at once (blocks an SM at this shared
// memory, from the occupancy API, times the SMs), read once per device and
// shared-memory size of the instance.
template <typename T, int C>
cudaError_t rows_grid(long long smem, long long tiles, unsigned* grid) {
  const auto kernel = warp_lines_kernel<T, C, false>;
  static long long seen_smem[kMaxDevices] = {0};
  static long long cap[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (seen_smem[dev] != smem) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = allow_smem(kernel, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        static_cast<size_t>(smem));
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cap[dev] = static_cast<long long>(per_sm) * sms;
    seen_smem[dev] = smem;
  }
  *grid = static_cast<unsigned>(tiles < cap[dev] ? tiles : cap[dev]);
  return cudaSuccess;
}

template <typename T, int C>
cudaError_t launch_c(const WarpPlan& p, const T* img, const float* field, T* out, int b, int h,
                     int w, long long fsb, long long fsy, long long fsx, int kmax,
                     cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(p.tiles);
  const int smem = static_cast<int>(p.smem);
  cudaError_t e = cudaSuccess;
  const int contig = fsx == 1 && fsy == w && fsb == static_cast<long long>(h) * w;
  const int lines_log2 = p.lines == 8 ? 3 : p.lines == 4 ? 2 : p.lines == 2 ? 1 : 0;
  const int rows = b * h;
  unsigned pgrid = 0;
  if (p.route == kWarpRowsStaged) {
    e = rows_grid<T, C>(p.smem, p.tiles, &pgrid);
    if (e == cudaSuccess)
      warp_lines_kernel<T, C, false><<<pgrid, kThreads, smem, s>>>(
          img, field, out, h, w, rows, lines_log2, fsb, fsy, fsx, kmax, contig);
  } else {  // a block a tile: one stage, and L1 left to the taps
    e = allow_smem(warp_lines_kernel<T, C, true>, p.smem);
    if (e == cudaSuccess)
      warp_lines_kernel<T, C, true><<<grid, kThreads, smem, s>>>(
          img, field, out, h, w, rows, lines_log2, fsb, fsy, fsx, kmax, contig);
  }
  return e;
}

template <typename T>
cudaError_t launch(const WarpPlan& p, const void* img_v, const float* field, void* out_v, int b,
                   int h, int w, int c, long long fsb, long long fsy, long long fsx, int kmax,
                   int along_y, cudaStream_t s) {
  const T* img = static_cast<const T*>(img_v);
  T* out = static_cast<T*>(out_v);
  if (p.tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e;
  switch (p.route == kWarpPerPixel ? 0 : c) {
    case 0:
      warp_pass_kernel<T><<<static_cast<unsigned>(p.tiles), kThreads, 0, s>>>(
          img, field, out, h, w, c, static_cast<long long>(b) * h * w, fsb, fsy, fsx, kmax,
          along_y);
      e = cudaSuccess;
      break;
#define VSD_WARP_C(N)                                                                  \
  case N:                                                                              \
    e = launch_c<T, N>(p, img, field, out, b, h, w, fsb, fsy, fsx, kmax, s);           \
    break;
      VSD_WARP_C(1)
      VSD_WARP_C(2)
      VSD_WARP_C(3)
      VSD_WARP_C(4)
#undef VSD_WARP_C
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// The route and geometry of a pass (warp_plan.cuh): out = [route, lines,
// shared memory bytes, tiles].  Returns 0, or cudaErrorInvalidValue for a
// bad shape.
extern "C" int vsd_warp_pass_plan(int b, int h, int w, int c, int is_bf16, int along_y,
                                  long long* out) {
  using namespace vsd;
  if (b < 0 || h <= 0 || w <= 0 || c <= 0 || c > kMaxC) return cudaErrorInvalidValue;
  const WarpPlan p = warp_pass_plan(b, h, w, c, is_bf16 ? 2 : 4, along_y);
  out[0] = p.route;
  out[1] = p.lines;
  out[2] = p.smem;
  out[3] = p.tiles;
  return cudaSuccess;
}

// img, out [b, h, w, c] contiguous, f32 (is_bf16 = 0) or bf16 (1); field f32
// read at field[bi * fsb + y * fsy + x * fsx] (element strides; 0 for a
// broadcast axis); along_y = 0: the pass runs along x, 1: along y.  The
// route is the shape's (warp_plan.cuh).  Returns the launch's CUDA error
// (0 on success).
extern "C" int vsd_warp_pass(const void* img, const void* field, void* out, int b, int h, int w,
                             int c, long long fsb, long long fsy, long long fsx, int kmax,
                             int along_y, int is_bf16, void* stream) {
  using namespace vsd;
  if (b < 0 || h <= 0 || w <= 0 || c <= 0 || c > kMaxC || kmax < 0) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const WarpPlan p = warp_pass_plan(b, h, w, c, is_bf16 ? 2 : 4, along_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(field);
  return is_bf16 ? launch<bf16>(p, img, f, out, b, h, w, c, fsb, fsy, fsx, kmax, along_y, s)
                 : launch<float>(p, img, f, out, b, h, w, c, fsb, fsy, fsx, kmax, along_y, s);
}

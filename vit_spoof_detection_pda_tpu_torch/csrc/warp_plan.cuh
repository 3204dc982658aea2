// The route of one scanline pass of the warp tower (csrc/warp_pass.cu),
// chosen by shape before any launch.  Plain C++ with no CUDA, so that the
// CPU tests can compile it with a host compiler and hold
// ops/warp.py::warp_pass_plan to it; warp_pass.cu launches by it and
// exports it as vsd_warp_pass_plan.
//
// Routes (ids as ops/warp.py::WARP_ROUTES):
//   0 per_pixel    one thread per output pixel over a flat grid; any shape
//   1 rows_staged  along x: a tile of `lines` whole image rows (and their
//                  field) is staged in shared memory with 16-byte copies,
//                  its taps read there, and its rows written back with
//                  16-byte stores; a persistent grid walks the tiles, the
//                  next tile's copies in flight while it computes one
//   2 cols_direct  along y: a block a tile, whose taps come straight from
//                  device memory through L1 (neighbouring x share a tap
//                  row), so only the output and field rows are staged and
//                  L1 keeps the rest of the SM's memory
// A line is one image row, W * C elements.  `lines` is the largest power
// of 2 up to 8 whose rows hold at most kWarpStageBytes; a route whose
// shared memory would pass kWarpMaxSmem, or whose image or line count
// passes 32-bit indices, goes per pixel.
#pragma once

#ifdef __CUDACC__
#define VSD_WARP_HD __host__ __device__
#else
#define VSD_WARP_HD
#endif

namespace vsd {

constexpr int kWarpThreads = 256;          // 8 warps a block, every route
constexpr long long kWarpStageBytes = 16384;
constexpr int kWarpStages = 2;             // the rows_staged ring
constexpr long long kWarpMaxSmem = 98304;
constexpr long long kWarpInt32 = 0x7fffffffLL;

enum WarpRoute { kWarpPerPixel = 0, kWarpRowsStaged = 1, kWarpColsDirect = 2 };

struct WarpPlan {
  int route;
  int lines;       // image rows of a tile (staged routes; 0 per pixel)
  long long smem;  // dynamic shared memory of a block, bytes
  long long tiles;  // staged: tiles of `lines` rows;
                    // per pixel: blocks of kWarpThreads pixels
};

VSD_WARP_HD inline long long warp_align16(long long n) { return (n + 15) / 16 * 16; }

// Shared memory of a staged block: its output rows, and along x
// kWarpStages stages of input rows and of field rows (along y one stage of
// field rows), each with 16 bytes of slack that lines the buffer up with
// the 16-byte grid of its device address.
inline long long warp_staged_smem(int w, int c, int itemsize, int along_y, int lines) {
  const long long tile = warp_align16(static_cast<long long>(lines) * w * c * itemsize + 16);
  const long long field = warp_align16(static_cast<long long>(lines) * w * 4 + 16);
  return along_y ? tile + field : (1 + kWarpStages) * tile + kWarpStages * field;
}

// The route this shape gets, and its geometry.
inline WarpPlan warp_pass_plan(int b, int h, int w, int c, int itemsize, int along_y) {
  WarpPlan p = {kWarpPerPixel, 0, 0, 0};
  const long long pixels = static_cast<long long>(b) * h * w;
  p.tiles = (pixels + kWarpThreads - 1) / kWarpThreads;
  const long long line = static_cast<long long>(w) * c * itemsize;
  int lines = 8;
  while (lines > 1 && lines * line > kWarpStageBytes) lines /= 2;
  const long long smem = warp_staged_smem(w, c, itemsize, along_y, lines);
  const long long rows = static_cast<long long>(b) * h;
  const bool fits = smem <= kWarpMaxSmem && rows <= kWarpInt32 &&
                    static_cast<long long>(h) * w * c <= kWarpInt32;
  if (!fits) return p;
  p.route = along_y ? kWarpColsDirect : kWarpRowsStaged;
  p.lines = lines;
  p.smem = smem;
  p.tiles = (rows + lines - 1) / lines;
  return p;
}

}  // namespace vsd

// Row gather from the device-resident training pool on Hopper:
//
//   out[i, :] = pool[idx[i], :]      (rows of row_bytes bytes)
//
// Replaces the TPU kernel vit_spoof_detection_pda_tpu/ops/gather_pallas.py::
// _kernel (:34, wrapper pool_gather :40).  The TPU kernel rode the index
// vector on scalar prefetch and let Mosaic's BlockSpec index maps DMA one
// lane-packed [row/128, 128] block per row; the lane packing was a TPU
// tiling device (an NHWC pool relayouts on every step there) and is not
// needed here: the pool stays NHWC and a row is one contiguous run of
// bytes.
//
// Bound on the H100: bytes.  Each gathered row is read once and written
// once: 2 * B * row bytes, at B = 128 rows of 224 x 224 x 3 uint8 (150,528
// bytes) 38.5 MB, >= 0.0115 ms at 3.35 TB/s.
// Design: a 2-D grid, blockIdx.y the output row, blockIdx.x a 32 KB slice
// of it, so each row is copied by several blocks (B = 128 rows give 640
// blocks, about five per SM); 16-byte loads and stores when the row and
// both bases are 16-byte aligned, bytes otherwise.  The block reads its
// row's index itself; the wrapper checks every index against N on the host
// before the launch, so no read leaves the pool.
#include "common.cuh"

namespace vsd {
namespace {

constexpr int kThreads = 256;
constexpr int kSliceBytes = 32768;

template <typename V>
__global__ void __launch_bounds__(kThreads)
    pool_gather_kernel(const V* __restrict__ pool, const int* __restrict__ idx,
                       V* __restrict__ out, long long row) {
  constexpr long long kSlice = kSliceBytes / sizeof(V);
  const long long r = blockIdx.y;
  const V* src = pool + static_cast<long long>(idx[r]) * row;
  V* dst = out + r * row;
  const long long lo = blockIdx.x * kSlice;
  const long long hi = lo + kSlice < row ? lo + kSlice : row;
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) dst[j] = src[j];
}

}  // namespace
}  // namespace vsd

// pool [n, row_bytes] bytes, idx [b] int32 on the device (each in [0, n),
// checked by the caller), out [b, row_bytes].  Returns the launch's CUDA
// error (0 on success).
extern "C" int vsd_pool_gather(const void* pool, const void* idx, void* out, int b,
                               long long row_bytes, void* stream) {
  using namespace vsd;
  if (b < 0 || b > 65535 || row_bytes <= 0) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(pool) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((row_bytes + kSliceBytes - 1) / kSliceBytes), b);
  if (vec) {
    pool_gather_kernel<uint4><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(pool), static_cast<const int*>(idx), static_cast<uint4*>(out),
        row_bytes / 16);
  } else {
    pool_gather_kernel<unsigned char><<<grid, kThreads, 0, s>>>(
        static_cast<const unsigned char*>(pool), static_cast<const int*>(idx),
        static_cast<unsigned char*>(out), row_bytes);
  }
  return cudaGetLastError();
}

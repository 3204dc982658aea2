// Hopper's asynchronous copies and the barriers that complete them, shared
// by the cores that feed wgmma through TMA: the whole-encoder kernels
// (lowlat_core.cuh) and the GEMM core of the block kernels (gemm_core.cuh).
//
//   - mbarriers in shared memory (init, arrive, arrive with an expected
//     byte count, a parity wait that ends in __trap() after kTimeoutNs, so a
//     broken wait fails loudly instead of hanging the card);
//   - TMA tile loads (cp.async.bulk.tensor, 2-D and 3-D maps) and a plain
//     bulk copy, each completing on an mbarrier;
//   - encode_tiled: cuTensorMapEncodeTiled, found through the runtime's
//     entry-point lookup, so a library links no libcuda; encode_map, a 2-D
//     map of 64 x 64 boxes.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is found at run time)

#include "common.cuh"

namespace vsd {

constexpr unsigned long long kTimeoutNs = 4000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Named barrier over n threads (id 0 is __syncthreads's).
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* b, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_addr(b)), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits for the phase of parity `parity` of mbarrier b to complete (the
// timer read only every 1024 tries).
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  if (mbar_try(b, parity)) return;
  const unsigned long long t0 = global_ns();
  for (unsigned n = 1; !mbar_try(b, parity); ++n)
    if ((n & 1023) == 0 && global_ns() - t0 > kTimeoutNs) __trap();
}

// A 64 x 64 tile of a 2-D tensor map at (col, row) into shared memory,
// completing on mbarrier b, under L2 cache policy `policy` (the weights:
// evict first, so the stream does not push the activations out of L2).
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, int col, int row,
                                         uint64_t* b, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(b)), "r"(col), "r"(row),
      "l"(policy)
      : "memory");
}

// A 64-row x 64-deep A tile of a 3-D map (k in the chunk, chunk, row): k
// past the chunk and rows past M land as zeros.
__device__ __forceinline__ void tma_a(void* dst, const CUtensorMap* map, int k, int chunk,
                                      int row, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(b)), "r"(k), "r"(chunk), "r"(row)
      : "memory");
}

// n bytes (a multiple of 16) from global to shared memory, completing on b.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int n, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(n), "r"(smem_addr(b))
      : "memory");
}

// Orders this thread's generic-proxy global accesses with async-proxy (TMA)
// ones: the activations written in a phase are read by TMA in the next.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// A 2-D TMA tile at (col, row) of a map into shared memory, completing on
// mbarrier b (the default L2 policy).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int col, int row,
                                            uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(b)), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled by the runtime's entry-point lookup (the library
// links no libcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 2-D map of rows x cols elements (row pitch cols), 64 x 64 boxes: bf16
// with the 128-byte swizzle wgmma reads, or int8 bytes as they are.
inline bool encode_map(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                       bool int8) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * (int8 ? 1 : 2)};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace vsd

// Rectangular attention for sequence parallelism on Hopper (kernel 12):
//
//   out[b, :, h] = softmax(Q[b, :, h] K[b, :, h]^T * scale) V[b, :, h]
//
// for a local block of Tq query rows q [B, Tq, D] against the gathered
// keys and values kv [B, Tk, 2D] ([k | v], heads contiguous inside each),
// key columns at or past valid_len masked at -1e30, written as the
// concatenated head outputs out [B, Tq, D], in bf16 or f32.  Replaces the
// TPU kernel vit_spoof_detection_pda_tpu/ops/attention.py::_attn_cp_kernel
// (:836; wrapper fused_attention_qkv_cp :987, forward _forward_cp :912),
// which the sequence-parallel attention (_sp_sharded :1024) runs on each
// device's query block against the all-gathered K and V.
//
// The TPU kernel pads Tq and Tk to multiples of 8 with zeros; this one
// takes the rows as they are (keys past Tk are zero rows with no weight,
// query rows past Tq are neither read nor written), which equals the
// padded form because pad keys are masked and pad queries are sliced off.
// Rounding points are the TPU kernel's: f32 logits q . k * Dh^-0.5, the
// f32 softmax, the weights normalised and then rounded to v's dtype before
// @ v, f32 sums, the output rounded once.
//
// Bound on the H100 at the sequence-parallel step's shape (ViT-B/16, two
// sequence ranks: B = 128, Tq = 104, Tk = 208, 12 heads of 64, bf16): q in,
// kv in and out are 20.4 + 81.8 + 20.4 = 122.7 MB, 0.037 ms at 3.35 TB/s,
// against 8.06 GFLOP over the 197 real keys, 0.008 ms at 989 TFLOP/s: the
// bytes bind.  In f32 (B = 32) the 2.01 GFLOP on the FMA units (67
// TFLOP/s) take 0.030 ms against 61.3 MB (0.018 ms): the operations bind.
//
// Design (csrc/attention_cp_core.cuh), grid (query tiles, heads, B): a
// block stages one head's K and V once for up to 7 (bf16) or 8 (f32) groups
// of 16 query rows (Tq = 104: one tile of 7 groups), so the gathered kv is
// read once.  The first design (kernel 8's core) ran two passes, Q K^T in
// each, over K and V copied whole before any product: 0.167 ms bf16 at the
// shape above (3.3x SDPA on the same keys).
//   bf16, one pass where the keys fit the registers (Tk rounded to 16 <=
//   208: the sequence-parallel blocks of ViT-B/16, Tq 104 or 52): Q is
//   staged once by 16-byte cp.async and read by ldmatrix; K arrives in
//   64-key chunks, each its own cp.async group, and Q K^T (mma.sync
//   m16n8k16) runs on a chunk as soon as it lands while the next ones are
//   in flight; V, the last group, lands during the softmax.  Each warp
//   keeps its 16 rows' f32 scores in registers (104 a thread at 208 keys),
//   takes the exact row max and sum, normalises, rounds to bf16 and packs
//   the P fragments (52 registers) before P V, so scores and the output
//   sums are never live together.  The softmax runs in base 2 (the scale
//   times log2 e folded into the logits, exp2f, one reciprocal a row): with
//   IEEE expf and a division per weight it was most of the instructions.
//   The output goes through the warp's own Q rows to 16-byte row stores.
//   Budget at DH 64, Tk 208, 7 warps: 74 KB of shared memory (Q 16 KB, K
//   and V 58 KB) and 128 registers a thread (launch bounds of 2 blocks of
//   224 threads, which ptxas sizes as 256; ~200 B of spills): 2 blocks an
//   SM, up to 148 KB of loads in flight on each.  A third block would need
//   fewer than 100 registers a thread, below the scores alone: the issue of
//   loads ahead of the products is what keeps the bytes moving instead.
//   bf16, two passes for longer key blocks: Q fragments from device
//   memory, pass 1 the online max and sum, pass 2 the scores again.  Where
//   K and V fit (Tk up to 800 at DH 64) they are staged once, K then V in
//   two groups; past that the key-tiled form stages them in tiles of 256
//   keys (74 KB at DH 64: several blocks an SM), K tile by tile in pass 1
//   and K and V in pass 2, so any Tk runs.
//   f32, in FMAs: a lane holds 4 query rows against every 8th key, so each
//   16-byte K read feeds 16 FMAs (the first design read Q from shared
//   memory for every key: 80 loads for 256 FMAs); the weights go through a
//   per-warp buffer to P V, where a lane sums 4 rows by DH / 8 columns,
//   read 16 bytes at a time.  One pass at Tk rounded to 8 <= 208: two warps
//   share each 16-row group, one on the even 8-key tiles, one on the odd,
//   and trade row max and sum and the second's partial output through
//   shared memory (16 warps, 14 busy at Tq 104; one warp a group left 7 an
//   SM); K arrives in 16-column groups (every key), so each q read feeds
//   all of a warp's keys while the next columns land.  Loops around the
//   unrolled key tiles stay rolled: fully unrolled, the code outgrew the
//   instruction cache and ran 1.5x slower.  Past 208 keys (or where that
//   block does not fit), two passes over 32-key chunks, a warp a group, K
//   and V whole where they fit (Tk up to 384 at DH 64) and past that in
//   tiles of 128 keys as in bf16 (two blocks an SM: 1.6x faster at Tq 296,
//   Tk 592 than tiles of the 384 keys that fit; PERF.md, PR 11).
//   The shared-memory pipe, not the FMAs, sets the pace: a lane reads 4
//   floats of q and 52 of K for 208 FMAs in Q K^T, and 12 for 32 in P V,
//   each lane of a quad of rows reading the same K and V values.  Budget at
//   DH 64, Tk 208: 185 KB (K and V 110 KB, weight chunks 40 KB, partial
//   outputs 32 KB), one block of 16 warps an SM, 118 registers a thread.
#include "attention_cp_core.cuh"

namespace vsd {
namespace {

template <int DH, int KEYS>
__global__ void __launch_bounds__(kCpMaxWarps * 32, KEYS > 0 ? 2 : 1)
    attention_cp_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                        bf16* __restrict__ out, int tq, int tk, int d, int valid_len,
                        float scale, int kt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t hoff = static_cast<size_t>(h) * DH;
  const bf16* kb = kv + static_cast<size_t>(b) * tk * 2 * d + hoff;
  const bf16* qb = q + static_cast<size_t>(b) * tq * d + hoff;
  bf16* ob = out + static_cast<size_t>(b) * tq * d + hoff;
  const int q0 = blockIdx.x * (blockDim.x >> 5) * 16;
  if constexpr (KEYS > 0)
    cp_rows_bf16<DH, KEYS>(qb, d, kb, kb + d, 2 * d, ob, d, tq, tk, valid_len, scale, q0,
                           reinterpret_cast<bf16*>(smem));
  else
    cp_rows_bf16_tiles<DH>(qb, d, kb, kb + d, 2 * d, ob, d, tq, tk, valid_len, scale, q0, kt,
                           reinterpret_cast<bf16*>(smem));
}

template <int DH, int KEYS>
__global__ void __launch_bounds__(KEYS > 0 ? kCpF32SplitWarps * 32 : kCpF32Warps * 32, 1)
    attention_cp_f32_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                            float* __restrict__ out, int tq, int tk, int d, int valid_len,
                            float scale, int kt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t hoff = static_cast<size_t>(h) * DH;
  const float* kb = kv + static_cast<size_t>(b) * tk * 2 * d + hoff;
  const float* qb = q + static_cast<size_t>(b) * tq * d + hoff;
  float* ob = out + static_cast<size_t>(b) * tq * d + hoff;
  const int q0 = blockIdx.x * 8 * 16;  // 8 row groups a block in both forms
  if constexpr (KEYS > 0)
    cp_rows_f32_split<DH, KEYS>(qb, d, kb, kb + d, 2 * d, ob, d, tq, tk, valid_len, scale, q0,
                                reinterpret_cast<float*>(smem));
  else
    cp_rows_f32_two_pass<DH>(qb, d, kb, kb + d, 2 * d, ob, d, tq, tk, valid_len, scale, q0, kt,
                             reinterpret_cast<float*>(smem));
}

template <int DH>
cudaError_t launch_cp(const void* q, const void* kv, void* out, int dtype, int batch, int tq,
                      int tk, int heads, int valid_len, float scale, cudaStream_t stream) {
  const int d = heads * DH;
  int tiles, warps;
  cudaError_t e;
  if (dtype == 0) {
    cp_tiles(tq, kCpMaxWarps, &tiles, &warps);
    const bool one_pass = cp_keys16(tk) <= kCpOnePassKeys;
    const int kt = cp_key_tile(tk, DH, false);
    const size_t smem = cp_smem_bytes(one_pass, warps, one_pass ? tk : kt, DH);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    auto kernel = one_pass ? attention_cp_kernel<DH, kCpOnePassKeys> : attention_cp_kernel<DH, 0>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kernel<<<dim3(tiles, heads, batch), warps * 32, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kv), static_cast<bf16*>(out), tq,
        tk, d, valid_len, scale, kt);
    return cudaGetLastError();
  }
  cp_tiles(tq, 8, &tiles, &warps);
  const bool one_pass =
      cp_keys8(tk) <= kCpOnePassKeys && cp_f32_split_smem_bytes(tk, DH) <= kMaxSmem;
  const int kt = cp_key_tile(tk, DH, true);
  const size_t smem = one_pass ? cp_f32_split_smem_bytes(tk, DH) : cp_f32_smem_bytes(kt, DH);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = one_pass ? attention_cp_f32_kernel<DH, kCpOnePassKeys>
                         : attention_cp_f32_kernel<DH, 0>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // a block holds 8 row groups: a warp each (two-pass) or two (one pass)
  kernel<<<dim3(tiles, heads, batch), (one_pass ? kCpF32SplitWarps : kCpF32Warps) * 32, smem,
           stream>>>(static_cast<const float*>(q), static_cast<const float*>(kv),
                     static_cast<float*>(out), tq, tk, d, valid_len, scale, kt);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// q [B, Tq, D], kv [B, Tk, 2D] and out [B, Tq, D], all bf16 (dtype 0) or all
// f32 (dtype 1), contiguous and 16-byte aligned.  Needs a head dim that is
// a multiple of 16 up to 128 and 0 < valid_len <= Tk; any Tq and Tk.
// Returns the launch's CUDA error (0 on success).
extern "C" int vsd_attention_cp(const void* q, const void* kv, void* out, int dtype, int batch,
                                int tq, int tk, int d, int num_heads, int valid_len, float scale,
                                void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || tq <= 0 || tk <= 0 || d <= 0 || num_heads <= 0 ||
      num_heads > 65535 || d % num_heads || valid_len <= 0 || valid_len > tk ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / num_heads) {
#define VSD_HEAD_DIM(DH) \
  case DH:               \
    return launch_cp<DH>(q, kv, out, dtype, batch, tq, tk, num_heads, valid_len, scale, s);
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

// The attention core of the ViT's module path on Hopper (kernel 8):
//
//   out[b, :, h] = softmax(Q_h K_h^T * scale) V_h
//
// per head h on the fused projection qkv [B, T, 3D] (q | k | v, heads
// contiguous inside each), written as the concatenated head outputs
// [B, T, D], in bf16 or f32.  Key columns at or past valid_len are masked
// at -1e30.  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_qkv_kernel (:119).
// Kernel 9 (csrc/attention.cu) computes the same on q/k/v views; both run
// the routes of attention_self.cuh, and only the addressing differs.
//
// The TPU kernel pads T = 197 to 200 rows for its 8-row tiling; this one
// takes T rows as they are (the cores zero-fill rows past T and give
// columns past T no weight), and the results equal the padded form's
// because masked columns add exactly 0.  Rounding points are the TPU
// kernel's: f32 logits, the f32 softmax, the weights normalised and then
// rounded to v's dtype (a no-op at f32), f32 sums, the output rounded once.
//
// Bound on the H100 at the module path's shape (ViT-B/16, T = 197, 12
// heads of 64).  bf16 at B = 128: 154.9 MB of compulsory traffic (qkv in,
// out) = 0.046 ms at 3.35 TB/s against 15.3 GFLOP = 0.015 ms at 989
// TFLOP/s: the bytes bind.  f32 at B = 32: 3.81 GFLOP = 0.057 ms at 67
// TFLOP/s against 77.5 MB = 0.023 ms: the f32 operations bind.
//
// Design.  Up to 208 keys (ViT-B/16 at 224 px: T 197) both dtypes run
// kernel 12's one-pass core (attention_cp_core.cuh, designed in
// attention_cp.cu) with Tq = Tk = T.  The first design (kernel 1's
// attention core alone) took two passes over the keys, computing Q K^T in
// both, read Q's fragments from device memory in 32-bit loads and copied K
// and V whole before the first product: 0.304 ms bf16 at B = 128 (3.3x
// SDPA); its f32 form read q, K and V from shared memory for every FMA
// (0.353 ms at B = 32).  Now:
//   bf16: a block of up to 7 warps of 16 query rows (T 197: two tiles of
//   7 warps, one warp idle; each tile stages the head's K and V, the
//   second from L2) stages Q once by 16-byte cp.async, K in 64-key groups
//   that Q K^T (mma.sync m16n8k16, ldmatrix) takes as each lands, and V
//   during the softmax; each warp keeps its rows' f32 scores in registers,
//   takes the exact softmax in base 2, rounds the normalised weights to
//   bf16 and runs P V.  Two blocks an SM (128 registers a thread, ~200 B
//   of spills).  One block of 13 warps holding the whole (head, item),
//   K and V staged once, launch bounds (416, 1) and no spills, ran 7%
//   slower in turns (0.142-0.144 against 0.134-0.135 ms; PERF.md §6):
//   one block an SM cannot hide its loads behind another's softmax.  Tiles
//   of 5 warps, three blocks an SM, gained nothing (0.134-0.137).
//   f32: plain FMAs, never TF32 (it would round q, k and the weights to 10
//   mantissa bits); two warps share each 16-row group, each 16-byte K read
//   feeds 16 FMAs, the weights pass through a per-warp buffer to P V.
//   One block of 16 warps an SM (185 KB at head dim 64).
// Past 208 keys the routes of module_attention_plan (ops/attention.py),
// each chosen by timing the candidates in turns at B = 8, T 257, 325 and
// 577 (tests/torch_kernel_ab.py; PERF.md §6):
//   bf16: kernel 12's two passes (cp_rows_bf16_tiles) with K and V whole
//   up to T 800 at head dim 64, then over tiles of 256 keys.  Kernel 1's
//   two-pass core, the route before, took up to 1.6x as long (0.199-0.206
//   against 0.124-0.130 ms at T 577): the base-2 softmax, ldmatrix.x4 K
//   fragments and V landing during pass 1;
//   f32: the whole two-pass core (attention_f32.cuh::attention_f32_rows,
//   T up to 333 at head dim 64), then its key-tiled form (tiles of 128
//   keys, an online softmax).  Kernel 12's f32 two passes took 1.6-2x as
//   long (0.27-0.29 against 0.136-0.146 ms at T 257): they re-read q for
//   every 32-key chunk.
// Any T.
#include "attention_self.cuh"

// qkv [B, T, 3D] and out [B, T, D], both bf16 (dtype 0) or f32 (dtype 1),
// contiguous and 16-byte aligned.  Needs a head dim that is a multiple of
// 16 up to 128 and 0 < valid_len <= T; any T.  Returns the launch's CUDA
// error (0 on success).
extern "C" int vsd_attention_qkv(const void* qkv, void* out, int dtype, int batch, int t, int d,
                                 int num_heads, int valid_len, float scale, void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || t <= 0 || d <= 0 || num_heads <= 0 ||
      num_heads > 65535 || d % num_heads || valid_len <= 0 || valid_len > t ||
      (dtype != 0 && dtype != 1) || 3LL * d > 0x7fffffff)
    return cudaErrorInvalidValue;
  const size_t third = static_cast<size_t>(d) * (dtype == 0 ? sizeof(bf16) : sizeof(float));
  const char* q = static_cast<const char*>(qkv);
  return attention_self(q, q + third, q + 2 * third, out, dtype, batch, t, num_heads,
                        d / num_heads, 3 * d, 3LL * t * d, valid_len, scale,
                        static_cast<cudaStream_t>(stream));
}

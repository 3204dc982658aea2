// Rectangular backward of the sequence-parallel attention on Hopper
// (kernel 13): given a local block of Tq query rows q [B, Tq, D], the
// gathered keys and values kv [B, Tk, 2D] ([k | v], heads contiguous
// inside each) and the cotangent g [B, Tq, D] of kernel 12's output (zero
// on pad query rows), per head
//
//   w  = softmax(q k^T * s), key columns >= valid_len at -1e30   (f32)
//   dv = cdt(w)^T g,  dw = g v^T,  dl = w (dw - rowsum(dw w))
//   dq = cdt(dl) k * s,  dk = cdt(dl)^T q * s
//
// into dq [B, Tq, D] and this rank's partial dkv [B, Tk, 2D] (its
// contribution to every key; the reduce-scatter of the all-gather's
// backward sums the ranks' partials), cdt being the input type (bf16, or
// f32 where the rounding is the identity).  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_cp_bwd_kernel (:865;
// the custom VJP _cp_bwd :1000 of fused_attention_qkv_cp :987) and keeps
// its rounding points: w rounded to cdt before dv, dl from the f32 w and dw
// after each row's full sum and rounded to cdt before dq and dk, the scale
// applied after the dq and dk products, every product summed in f32.  Key
// columns at or past valid_len have w = 0 exactly, so their dk and dv are
// exactly 0; pad query rows carry g = 0 and add nothing.
//
// The arithmetic is kernel 4's on a [Tq, Tk] tile, and so is the code:
// bf16 runs attention_bwd_core.cuh::attention_bwd_rows (one block per
// (head, item); w and dl [Tq, Tk] held as bf16 in shared memory, 104 x 208
// at two sequence ranks and 56 x 224 at four, beside one pair of [Tk, Dh]
// operands; part A by query rows, part B by keys), f32 the two launches of
// attention_bwd_f32.cuh (rows: dq and each row's softmax stats; keys: dk
// and dv), as attention_qkv_bwd.cu and attention_qkv_bwd_f32.cu run them on
// the square.
//
// Bound on the H100 at the sequence-parallel step's shape (ViT-B/16, two
// sequence ranks: B = 128, Tq = 104, Tk = 208, 12 heads of 64, bf16): q, kv
// and g in, dq and dkv out, 20.4 + 81.8 + 20.4 + 20.4 + 81.8 = 224.9 MB,
// 0.067 ms at 3.35 TB/s, against the five [Tq, Tk] x Dh products' 21.3 GFLOP
// (0.022 ms at 989 TFLOP/s): the bytes bind.  f32 at B = 32: 5.3 GFLOP on
// the FMA units, 0.079 ms at 67 TFLOP/s, against 112 MB (0.034 ms).  This
// first design recomputes the scores and dw (7 products instead of 5) and
// runs one block per SM, as kernel 4 does.
#include "attention_bwd_core.cuh"
#include "attention_bwd_f32.cuh"

namespace vsd {
namespace {

template <int DH>
__global__ void __launch_bounds__(kBwdMaxWarps * 32, 1)
    attention_cp_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                            const bf16* __restrict__ g, bf16* __restrict__ dq,
                            bf16* __restrict__ dkv, int tq, int tk, int d, int valid_len,
                            float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t hoff = static_cast<size_t>(h) * DH;
  const size_t qoff = static_cast<size_t>(b) * tq * d + hoff;
  const size_t koff = static_cast<size_t>(b) * tk * 2 * d + hoff;
  attention_bwd_rows<DH, true>(q + qoff, d, kv + koff, 2 * d, g + qoff, d, dq + qoff, d, dkv + koff,
                         2 * d, d, tq, tk, valid_len, scale, smem);
}

template <int DH>
__global__ void __launch_bounds__(kBwdF32Warps * 32)
    attention_cp_bwd_rows_f32(const float* __restrict__ q, const float* __restrict__ kv,
                              const float* __restrict__ g, float* __restrict__ dq,
                              float* __restrict__ stats, int tq, int tk, int d, int valid_len,
                              float scale, int tile_rows) {
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const size_t hoff = static_cast<size_t>(h) * DH;
  const size_t qoff = static_cast<size_t>(b) * tq * d + hoff;
  const float* kb = kv + static_cast<size_t>(b) * tk * 2 * d + hoff;
  bwd_rows_f32<DH>(q + qoff, d, kb, kb + d, 2 * d, g + qoff, d, dq + qoff, d,
                   stats + (static_cast<size_t>(b) * heads + h) * tq * 4, tq, tk, valid_len,
                   scale, tile_rows);
}

template <int DH>
__global__ void __launch_bounds__(kBwdF32Warps * 32)
    attention_cp_bwd_keys_f32(const float* __restrict__ q, const float* __restrict__ kv,
                              const float* __restrict__ g, float* __restrict__ dkv,
                              const float* __restrict__ stats, int tq, int tk, int d,
                              int valid_len, float scale, int tile_keys) {
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const size_t hoff = static_cast<size_t>(h) * DH;
  const size_t qoff = static_cast<size_t>(b) * tq * d + hoff;
  const size_t koff = static_cast<size_t>(b) * tk * 2 * d + hoff;
  bwd_keys_f32<DH>(q + qoff, d, kv + koff, kv + koff + d, 2 * d, g + qoff, d, dkv + koff,
                   dkv + koff + d, 2 * d, stats + (static_cast<size_t>(b) * heads + h) * tq * 4,
                   tq, tk, valid_len, scale, tile_keys);
}

template <int DH>
cudaError_t launch_cp_bwd(const bf16* q, const bf16* kv, const bf16* g, bf16* dq, bf16* dkv,
                          int batch, int tq, int tk, int heads, int valid_len, float scale,
                          cudaStream_t stream) {
  size_t smem;
  int warps;
  cudaError_t e = prepare_bwd<DH>(reinterpret_cast<const void*>(attention_cp_bwd_kernel<DH>),
                                  tq, tk, &smem, &warps);
  if (e != cudaSuccess) return e;
  attention_cp_bwd_kernel<DH><<<dim3(heads, batch), warps * 32, smem, stream>>>(
      q, kv, g, dq, dkv, tq, tk, heads * DH, valid_len, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_cp_bwd_f32(const float* q, const float* kv, const float* g, float* dq,
                              float* dkv, float* stats, int batch, int tq, int tk, int heads,
                              int valid_len, float scale, cudaStream_t stream) {
  const int d = heads * DH;
  const size_t smem = bwd_f32_smem_bytes(tq > tk ? tq : tk, DH);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_cp_bwd_rows_f32<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attention_cp_bwd_keys_f32<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = bwd_f32_tile(tq), keys = bwd_f32_tile(tk);
  attention_cp_bwd_rows_f32<DH>
      <<<dim3((tq + rows - 1) / rows, heads, batch), kBwdF32Warps * 32, smem, stream>>>(
          q, kv, g, dq, stats, tq, tk, d, valid_len, scale, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attention_cp_bwd_keys_f32<DH>
      <<<dim3((tk + keys - 1) / keys, heads, batch), kBwdF32Warps * 32, smem, stream>>>(
          q, kv, g, dkv, stats, tq, tk, d, valid_len, scale, keys);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// q, g, dq [B, Tq, D] and kv, dkv [B, Tk, 2D], all bf16 (dtype 0) or all f32
// (dtype 1), contiguous and 16-byte aligned; stats [B, H, Tq, 4] f32 scratch
// (f32 only, else unused).  bf16 needs a head dim of 16, 32 or 64 and
// 2 (2 max(nq, nk) Dh + 2 nq nk) bytes of shared memory (nq, nk: Tq, Tk
// rounded up to 16, at most 256); f32 a head dim that is a multiple of 16
// up to 128 and 4 (2 t (Dh + 4) + 4 t + 8 (8 Dh + 8 t)) bytes, t =
// max(Tq, Tk).  0 < valid_len <= Tk.  Returns the first CUDA error of the
// launches (0 on success).
extern "C" int vsd_attention_cp_bwd(const void* q, const void* kv, const void* g, void* dq,
                                    void* dkv, void* stats, int dtype, int batch, int tq, int tk,
                                    int d, int num_heads, int valid_len, float scale,
                                    void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || tq <= 0 || tk <= 0 || d <= 0 || num_heads <= 0 ||
      num_heads > 65535 || d % num_heads || valid_len <= 0 || valid_len > tk)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dh = d / num_heads;
  if (dtype == 0) {
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(kv),
               *gb = static_cast<const bf16*>(g);
    bf16 *dqb = static_cast<bf16*>(dq), *dkb = static_cast<bf16*>(dkv);
    switch (dh) {
      case 16:
        return launch_cp_bwd<16>(qb, kb, gb, dqb, dkb, batch, tq, tk, num_heads, valid_len,
                                 scale, s);
      case 32:
        return launch_cp_bwd<32>(qb, kb, gb, dqb, dkb, batch, tq, tk, num_heads, valid_len,
                                 scale, s);
      case 64:
        return launch_cp_bwd<64>(qb, kb, gb, dqb, dkb, batch, tq, tk, num_heads, valid_len,
                                 scale, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(kv),
              *gf = static_cast<const float*>(g);
  float *dqf = static_cast<float*>(dq), *dkf = static_cast<float*>(dkv),
        *st = static_cast<float*>(stats);
  switch (dh) {
#define VSD_HEAD_DIM(DH)                                                                        \
  case DH:                                                                                      \
    return launch_cp_bwd_f32<DH>(qf, kf, gf, dqf, dkf, st, batch, tq, tk, num_heads, valid_len, \
                                 scale, s);
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

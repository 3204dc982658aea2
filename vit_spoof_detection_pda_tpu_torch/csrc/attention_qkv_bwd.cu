// Backward of the attention core on Hopper: given the fused projection
// qkv [B, Tp, 3D] (q | k | v, heads contiguous inside each) and the
// cotangent g [B, Tp, D] of the concatenated head outputs (zero on pad
// rows), per head
//
//   w  = softmax(q k^T * s), key columns >= valid_len at -1e30   (f32)
//   dv = bf16(w)^T g,  dw = g v^T,  dl = w (dw - rowsum(dw w))
//   dq = bf16(dl) k * s,  dk = bf16(dl)^T q * s
//
// into dqkv [B, Tp, 3D] bf16.  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_qkv_bwd_kernel (:199)
// and keeps its rounding points: w is rounded to bf16 before dv, dl is
// formed from the f32 w and dw after each row's full sum, and rounded to
// bf16 before dq and dk; every product accumulates in f32.
//
// Bound on the H100: bytes.  At ViT-B, B = 128, Tp = 200 it reads qkv and g
// and writes dqkv, about 275 MB, >= 0.082 ms at 3.35 TB/s; its five
// [Tp, Tp] x Dh products are 39-47 GFLOP (0.04-0.05 ms at the bf16 peak).
//
// Design (a first, simple one): one block per (head, item), one warp per
// 16 rows of the Tp rows rounded up to 16 (13 warps at Tp = 200).  The TPU
// kernel held one head's f32 [Tp, Tp] weights in VMEM (160 KB); a block
// here keeps the bf16 weights and dl [tk, tk] (173 KB at tk = 208) and one
// pair of [tk, Dh] operands (53 KB) in shared memory, with a 16-byte-chunk
// XOR swizzle in place of padding so that Tp = 200 fits in 227 KB:
//   A. K and V staged; each warp owns 16 query rows, Q and G fragments in
//      registers: pass 1 over the keys (mma.sync) gives the row max, the
//      softmax sum and rowsum(dw w) online; pass 2 recomputes the scores
//      and dw, forms w and dl in f32, stores both as bf16 and accumulates
//      dq = dl k in registers.
//   B. Q and G staged where K and V were; each warp owns 16 keys and
//      accumulates dv = w^T g and dk = dl^T q over all the query rows in
//      registers (ldmatrix.trans reads w^T and dl^T from the stored tiles).
// The scores are computed twice and dw twice (7 products instead of the
// TPU kernel's 5); one block per SM.  Making it fast is later work.  The
// body is attention_bwd_core.cuh::attention_bwd_rows, which kernel 13
// (attention_cp_bwd.cu) runs on a rectangle of local queries against the
// gathered keys.
#include "attention_bwd_core.cuh"

namespace vsd {
namespace {

template <int DH>
__global__ void __launch_bounds__(kBwdMaxWarps * 32, 1)
    attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gout,
                         bf16* __restrict__ dqkv, int tp, int d, int valid_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t stride = 3 * static_cast<size_t>(d);
  const bf16* qbase = qkv + static_cast<size_t>(b) * tp * stride + static_cast<size_t>(h) * DH;
  const bf16* gbase = gout + static_cast<size_t>(b) * tp * d + static_cast<size_t>(h) * DH;
  bf16* obase = dqkv + static_cast<size_t>(b) * tp * stride + static_cast<size_t>(h) * DH;
  attention_bwd_rows<DH, false>(qbase, 3 * d, qbase + d, 3 * d, gbase, d, obase, 3 * d, obase + d, 3 * d, d,
                         tp, tp, valid_len, scale, smem);
}

template <int DH>
cudaError_t launch_bwd(const bf16* qkv, const bf16* g, bf16* dqkv, int batch, int tp, int d,
                       int heads, int valid_len, float scale, cudaStream_t stream) {
  size_t smem;
  int warps;
  cudaError_t e = prepare_bwd<DH>(reinterpret_cast<const void*>(attention_bwd_kernel<DH>), tp,
                                  tp, &smem, &warps);
  if (e != cudaSuccess) return e;
  attention_bwd_kernel<DH><<<dim3(heads, batch), warps * 32, smem, stream>>>(
      qkv, g, dqkv, tp, d, valid_len, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// qkv, dqkv [B, Tp, 3D] bf16; g [B, Tp, D] bf16, zero on rows >= valid_len.
// Needs a head dim of 16, 32 or 64, Tp % 8 == 0, 0 < valid_len <= Tp, and
// the block's shared memory (2 (2 tk Dh + 2 tk^2) bytes, tk = Tp rounded up
// to 16) within the card's.  Returns the launch's CUDA error (0 on success).
extern "C" int vsd_attention_qkv_bwd(const void* qkv, const void* g, void* dqkv, int batch,
                                     int tp, int d, int num_heads, int valid_len, float scale,
                                     void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || tp <= 0 || tp % 8 || d <= 0 || num_heads <= 0 ||
      num_heads > 65535 || d % num_heads || valid_len <= 0 || valid_len > tp)
    return cudaErrorInvalidValue;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* gb = static_cast<const bf16*>(g);
  bf16* out = static_cast<bf16*>(dqkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / num_heads) {
    case 16:
      return launch_bwd<16>(q, gb, out, batch, tp, d, num_heads, valid_len, scale, s);
    case 32:
      return launch_bwd<32>(q, gb, out, batch, tp, d, num_heads, valid_len, scale, s);
    case 64:
      return launch_bwd<64>(q, gb, out, batch, tp, d, num_heads, valid_len, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

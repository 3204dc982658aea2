// Backward of the attention core on Hopper (kernel 4): given the fused
// projection qkv [B, Tp, 3D] (q | k | v, heads contiguous inside each) and
// the cotangent g [B, Tp, D] of the concatenated head outputs (zero on pad
// rows), per head
//
//   w  = softmax(q k^T * s), key columns >= valid_len at -1e30   (f32)
//   dv = cdt(w)^T g,  dw = g v^T,  dl = w (dw - rowsum(dw w))
//   dq = cdt(dl) k * s,  dk = cdt(dl)^T q * s
//
// into dqkv [B, Tp, 3D], cdt being the input type (bf16, or f32 where the
// rounding is the identity).  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_qkv_bwd_kernel (:199)
// and keeps its rounding points: w rounded to cdt before dv, dl formed from
// the f32 w and dw after each row's full sum and rounded to cdt before dq
// and dk, every product summed in f32.
//
// Bound on the H100: bf16 at ViT-B, B = 128, Tp = 200 reads qkv and g and
// writes dqkv, about 275 MB, >= 0.082 ms at 3.35 TB/s (the five products
// over the 197 real tokens, 38 GFLOP, 0.04 ms at the bf16 peak; pad rows
// and masked keys add zeros).  f32 at B = 32: the five products are 9.5
// GFLOP on the FMA units, >= 0.142 ms at 67 TFLOP/s.
//
// Design: the one-launch on-chip backward of attention_bwd_onchip.cuh on the
// square Tq = Tk = Tp, the thirds of qkv and dqkv as its q, k, v and dq,
// dk, dv (row stride 3D).  Each of the five products is computed once, the
// head stays on chip from the first product to the last, and nothing goes
// through device memory but the inputs and dqkv.  Kernel 5
// (attention_qkv_bwd_phased.cu) launches the same core; the shapes past it
// take the key-tiled backward (attention_bwd_tiled.cu), chosen by
// ops/attention.py::attention_qkv_bwd_plan before any launch.  Built into
// one library with kernels 5 and 13 (attention_bwd_onchip.cu).
#include "attention_bwd_onchip.cuh"

// qkv, dqkv [B, Tp, 3D] and g [B, Tp, D], all bf16 (f32 == 0) or all f32
// (f32 == 1), contiguous and 16-byte aligned; g zero on rows >= valid_len.
// Needs a head dim of 16, 32 or 64, 0 < valid_len <= Tp, B and H up to
// 65535, and Tp within the core's limits (bf16: Tp rounded up to 16 at
// most 208, the block's tiles within shared memory; f32: Tp up to 320, 448
// or 576 at head dims 64, 32 and 16).  One launch on ``stream``; returns
// its CUDA error (0 on success).
extern "C" int vsd_attention_qkv_bwd(const void* qkv, const void* g, void* dqkv, int f32,
                                     int batch, int tp, int d, int num_heads, int valid_len,
                                     float scale, void* stream) {
  return vsd::onchip_qkv_bwd(qkv, g, dqkv, f32, batch, tp, d, num_heads, valid_len, scale,
                             stream);
}

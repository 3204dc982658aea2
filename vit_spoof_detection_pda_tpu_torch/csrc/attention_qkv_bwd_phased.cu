// Phase-split backward of the attention core on Hopper (kernel 5): the same
// function as attention_qkv_bwd.cu (kernel 4).  Given the fused projection
// qkv [B, Tp, 3D] and the cotangent g [B, Tp, D] of the concatenated head
// outputs (zero on pad rows), per head
//
//   w  = softmax(q k^T * s), key columns >= valid_len at -1e30   (f32)
//   dv = cdt(w)^T g,  dw = g v^T,  dl = w (dw - rowsum(dw w))
//   dq = cdt(dl) k * s,  dk = cdt(dl)^T q * s
//
// into dqkv [B, Tp, 3D], cdt being the input type (bf16, or f32 where the
// rounding is the identity).  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_qkv_bwd_kernel_phased
// (:259), the opt-in form of kernel 4 selected by BWD_PHASED, and keeps its
// rounding points (w rounded to cdt only as the operand of dv, dl formed
// from the f32 w and dw after each row's full sum and rounded to cdt only
// as the operand of dq and dk; every product summed in f32).
//
// Bound on the H100: the same work as kernel 4 (bf16 at ViT-B, B = 128, Tp
// = 200: about 275 MB, >= 0.082 ms at 3.35 TB/s; f32 at B = 32: 9.5 GFLOP
// over the 197 real tokens, >= 0.142 ms at 67 TFLOP/s).
//
// What "phased" means here.  The TPU schedule computes each (item, head)'s
// softmax once and then issues all products of one kind back to back out of
// VMEM.  On this card that is attention_bwd_onchip.cuh: one launch, one
// block per (head, item) that keeps the head on chip, each of the five
// products computed once, no workspace in device memory.  Kernel 4 launches
// the same core (the JAX package has two kernels here, and the port keeps
// two entry points and two launch counts); the shapes past it take the
// key-tiled backward (attention_bwd_tiled.cu), chosen by
// ops/attention.py::phased_plan before any launch.  Built into one library
// with kernels 4 and 13 (attention_bwd_onchip.cu).
#include "attention_bwd_onchip.cuh"

// qkv, dqkv [B, Tp, 3D] and g [B, Tp, D], all bf16 (f32 == 0) or all f32
// (f32 == 1), contiguous and 16-byte aligned; g zero on rows >= valid_len.
// The limits of vsd_attention_qkv_bwd.  One launch on ``stream``; returns
// its CUDA error (0 on success).
extern "C" int vsd_attention_qkv_bwd_phased(const void* qkv, const void* g, void* dqkv, int f32,
                                            int batch, int tp, int d, int num_heads,
                                            int valid_len, float scale, void* stream) {
  return vsd::onchip_qkv_bwd(qkv, g, dqkv, f32, batch, tp, d, num_heads, valid_len, scale,
                             stream);
}

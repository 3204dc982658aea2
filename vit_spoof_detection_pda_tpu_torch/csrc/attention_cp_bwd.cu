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
// Bound on the H100 at the sequence-parallel step's shape (ViT-B/16, two
// sequence ranks: B = 128, Tq = 104, Tk = 208, 12 heads of 64, bf16): q, kv
// and g in, dq and dkv out, 20.4 + 81.8 + 20.4 + 20.4 + 81.8 = 224.9 MB,
// 0.067 ms at 3.35 TB/s, against the five [Tq, Tk] x Dh products' 21.3 GFLOP
// (0.022 ms at 989 TFLOP/s): the bytes bind.  f32 at B = 32: 5.3 GFLOP on
// the FMA units, 0.079 ms at 67 TFLOP/s, against 112 MB (0.034 ms).
//
// Design: the one-launch on-chip backward of attention_bwd_onchip.cuh on
// the [Tq, Tk] rectangle, with q, g and dq at row stride D and the halves of
// kv and dkv at row stride 2D.  Each of the five products is computed once;
// in bf16 part A's Tq / 16 row groups (7 at Tq 104: one round of the 7-warp
// block) and part B's Tk / 16 key groups each have the warps to themselves,
// and Q and G land in tiles of their own while part A runs.  The shapes
// past the core take the key-tiled backward's rectangular instance
// (attention_bwd_tiled.cu), chosen by ops/attention.py::cp_bwd_plan before
// any launch.  Built into one library with kernels 4 and 5
// (attention_bwd_onchip.cu).
#include "attention_bwd_onchip.cuh"

// q, g, dq [B, Tq, D] and kv, dkv [B, Tk, 2D], all bf16 (dtype 0) or all f32
// (dtype 1), contiguous and 16-byte aligned.  Needs a head dim of 16, 32 or
// 64, 0 < valid_len <= Tk, B and H up to 65535, and Tk within the core's
// limits (bf16: Tk rounded up to 16 at most 208 and the block's tiles
// within shared memory; f32: Tk up to 320, 448 or 576 at head dims 64, 32
// and 16, any Tq).  One launch on ``stream``; returns its CUDA error (0 on
// success).
extern "C" int vsd_attention_cp_bwd(const void* q, const void* kv, const void* g, void* dq,
                                    void* dkv, int dtype, int batch, int tq, int tk, int d,
                                    int num_heads, int valid_len, float scale, void* stream) {
  using namespace vsd;
  if (tq <= 0 || tk <= 0 || d <= 0 || num_heads <= 0 || d % num_heads || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const size_t es = dtype ? sizeof(float) : sizeof(bf16);
  const char* k = static_cast<const char*>(kv);
  char* dk = static_cast<char*>(dkv);
  const long long bsq = static_cast<long long>(tq) * d, bsk = static_cast<long long>(tk) * 2 * d;
  const OnArgs a{q,  k,  k + d * es, g,     dq,  dk,  dk + d * es, tq,    tk,
                 d,  2 * d, d,       valid_len, bsq, bsk, bsq,       scale};
  return launch_onchip_bwd(a, dtype == 1, batch, num_heads, d / num_heads,
                           static_cast<cudaStream_t>(stream));
}

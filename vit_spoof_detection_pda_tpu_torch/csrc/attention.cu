// Generic attention on Hopper (kernel 9):
//
//   out[b, :, h, :] = softmax(Q[b, :, h] K[b, :, h]^T * scale) V[b, :, h]
//
// over three tensors q, k and v of shape [B, T, H, Dh] that share their
// strides (heads and head columns contiguous, a row stride ld and a batch
// stride bs, in elements), written as a contiguous [B, T, H, Dh], in bf16
// or f32.  Replaces the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_kernel (:58; wrapper
// fused_attention :1076, forward _forward :83), which the int8 module path
// (models/serving.py) and models/vit.py::dot_product_attention run.
//
// The TPU kernel pads T to a multiple of 8 rows and masks keys at or past
// T at -1e30; this one takes the T rows as they are (the cores zero-fill
// rows past T and give them no weight), which equals the padded form
// because masked columns add exactly 0.  Rounding points are the TPU
// kernel's: f32 logits q . k * Dh^-0.5, the f32 softmax (e / l), the
// weights rounded to v's dtype, P V summed in f32 and rounded once.
//
// The arithmetic and the routes are kernel 8's (csrc/attention_qkv.cu,
// which computes the same core on one fused [B, T, 3D] row): both run
// attention_self.cuh, kernel 12's one-pass core up to 208 keys (bf16 on
// mma.sync, f32 on FMAs) and past that the routes
// ops/attention.py::module_attention_plan names.  Only the addressing
// differs: the int8 path's q, k and v are the three slices of one
// [B, T, 3, H, Dh] projection (ld = 3D), and the one-pass core's 16-byte
// cp.async of Q, K and V needs ld a multiple of 8 (bf16) or 4 (f32) and
// 16-byte aligned bases, which the wrapper checks.
//
// Bound on the H100 at the int8 module path's shape (ViT-B, B = 128,
// T = 197, 12 heads of 64, bf16): q, k, v and the output are
// 4 x 128 x 197 x 768 x 2 B = 154.9 MB, 0.046 ms at 3.35 TB/s, against
// 4 B H T^2 Dh = 15.3 GFLOP, 0.015 ms at 989 TFLOP/s: the bytes bind.  In
// f32 at B = 32, 3.81 GFLOP at 67 TFLOP/s (0.057 ms) binds.
#include "attention_self.cuh"

// q, k, v [B, T, H, Dh] sharing strides (element (b, t, h, c) at
// b * bs + t * ld + h * Dh + c), all bf16 (dtype 0) or f32 (dtype 1),
// 16-byte aligned with ld a multiple of 8 (bf16) or 4 (f32); out a
// contiguous [B, T, H, Dh] of the same dtype.  Needs a head dim that is a
// multiple of 16 up to 128; any T.  Returns the launch's CUDA error (0 on
// success).
extern "C" int vsd_attention(const void* q, const void* k, const void* v, void* out, int dtype,
                             int batch, int t, int heads, int dh, long long ld, long long bs,
                             float scale, void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || t <= 0 || heads <= 0 || heads > 65535 ||
      (dtype != 0 && dtype != 1) || ld < static_cast<long long>(heads) * dh ||
      ld > 0x7fffffff || ld % (dtype == 0 ? 8 : 4) ||
      bs < ld * (t - 1) + static_cast<long long>(heads) * dh)
    return cudaErrorInvalidValue;
  return attention_self(q, k, v, out, dtype, batch, t, heads, dh, static_cast<int>(ld), bs, t,
                        scale, static_cast<cudaStream_t>(stream));
}

// The whole ViT encoder in one launch, for B = 1 serving, on Hopper:
//
//   encoder-only:  x [B, Tp, D] -> every layer of the per-item pack -> x
//   fold-ends:     patch rows [B, Tp, D] -> patch-embed + aux -> every layer
//                  -> final LN of the CLS row -> anti-spoof head -> logits [B, 2]
//
// Replaces the TPU kernel vit_spoof_detection_pda_tpu/ops/lowlat.py::
// _encoder_kernel (:94; wrappers forward_lowlat_e2e :570 and
// encoder_forward_lowlat :634).
//
// Bound on the H100 at ViT-B, B = 1: the bytes.  One forward reads the 36
// superblocks W [768, 3072] bf16 (169.9 MB) and the 2.0 MB stem/head block,
// 0.051 ms at 3.35 TB/s; its 35.5 GFLOP of products take 0.036 ms at
// 989 TFLOP/s.  With the int8 pack (ops/lowlat.py pack_encoder_weights
// weight_dtype=int8; the TPU kernel's _wblk branch, :197) the stream is
// 84.9 MB of int8 plus 2.2 MB of S, 0.026 ms; the weights land as int8 and
// are converted to bf16 in the weight ring (lowlat_core.cuh), so
// everything after the ring is the bf16 kernel's.
//
// Design (lowlat_core.cuh has the phase loop): one cooperative launch, one
// block on every SM, a producer streaming every weight tile by TMA
// ahead of the grid barriers, phases per layer ln1 | qkv | attention | proj
// | ln2 | fc1 | fc2 (the split-K fixups in the row phases), with the stem
// before the first layer and the head after the last.  The B items are
// computed together (B * Tp rows); each weight tile serves every m-tile of
// its unit's rows.
//
// Rounding points follow the TPU kernel: LN, softmax and every sum in f32;
// xn, qkv, the softmax weights, the head outputs, the GELU output and each
// sub-layer's output rounded to bf16 once.  Stem: patches @ W_embed in f32
// plus aux, rounded once.  Head: final LN, a bf16 round trip, head LN (eps
// head_eps), fc1 in f32 against the bf16 weights, erf GELU (erff, where the
// TPU kernel used an A&S rational) rounded to bf16, the two fc2 dot
// products in f32.
#include "lowlat_core.cuh"

namespace vsd {
namespace lowlat {
namespace {

// Q8: the encoder's superblocks come from the int8 pack; the bf16
// instantiation compiles no int8 path.
template <bool Q8>
__global__ void __launch_bounds__(kThreads, 1) lowlat_encoder_kernel(const __grid_constant__ Params p) {
  encoder_kernel_body<Q8>(p);
}

}  // namespace
}  // namespace lowlat
}  // namespace vsd

// x_in [B, Tp, D] bf16 (fold-ends: patch rows, row 0 zeros); x [B, Tp, D]
// bf16 out; the per-item pack: w [3*depth, D, 4D] bf16 and s [3*depth, 4,
// 4D] f32, or (w_int8 = 1) w [3*depth, D, 4D] int8 and s [3*depth, 5, 4D]
// f32 with the columns' scales as row 4; w_end [D, D+hh] bf16, s_end [4,
// 4D] f32, aux [Tp, D] f32 for fold-ends (all three null for encoder-only);
// scratch xn [B*Tp, D], qkv [B*Tp, 3D], hid [B*Tp, 4D] bf16, h1 [B, hh]
// f32; logits [B, 2] f32 out (fold-ends); bar: 1 + B 32-bit words; splitk:
// splitk_len f32 (at least the plan's splitk_floats); trace: null, or
// trace_len 64-bit timestamps (lowlat_core.cuh).  Needs a head dim of 16,
// 32 or 64, D a multiple of 16, Tp a multiple of 8, 0 < valid_len <= Tp;
// fold-ends also hh % 8 == 0 and 2D + hh <= 4D.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int vsd_lowlat_encoder(const void* x_in, void* x, const void* w, int w_int8,
                                  const void* s, const void* w_end, const void* s_end,
                                  const void* aux, void* xn, void* qkv, void* hid, void* h1,
                                  void* logits, void* bar, void* splitk, long long splitk_len,
                                  void* trace, int trace_len, int depth, int batch, int tp, int d,
                                  int heads, int valid_len, int hh, float eps, float head_eps,
                                  float scale, void* stream) {
  using namespace vsd;
  using namespace vsd::lowlat;
  if (!valid_shape(depth, batch, tp, d, heads, valid_len)) return cudaErrorInvalidValue;
  const bool fold_ends = w_end != nullptr;
  if (fold_ends && (!s_end || !aux || hh <= 0 || hh % 8 || 2 * d + hh > 4 * d))
    return cudaErrorInvalidValue;
  Params p{};
  if (!encode_map(&p.wmap, w, 3LL * depth * d, 4LL * d, w_int8 != 0))
    return cudaErrorInvalidValue;
  if (fold_ends && !encode_map(&p.emap, w_end, d, d + hh, false)) return cudaErrorInvalidValue;
  p.x_in = static_cast<const bf16*>(x_in);
  p.x = static_cast<bf16*>(x);
  p.s = static_cast<const float*>(s);
  p.xn = static_cast<bf16*>(xn);
  p.qkv = static_cast<bf16*>(qkv);
  p.hid = static_cast<bf16*>(hid);
  p.part = static_cast<float*>(splitk);
  p.w_end = static_cast<const bf16*>(w_end);
  p.s_end = static_cast<const float*>(s_end);
  p.aux = static_cast<const float*>(aux);
  p.h1 = static_cast<float*>(h1);
  p.logits = static_cast<float*>(logits);
  p.bar = static_cast<unsigned*>(bar);
  p.trace = static_cast<unsigned long long*>(trace);
  p.depth = depth, p.batch = batch, p.tp = tp, p.d = d, p.heads = heads;
  p.valid_len = valid_len, p.hh = fold_ends ? hh : 0;
  p.batch_grid = 0, p.fold_ends = fold_ends, p.srows = w_int8 ? 5 : 4;
  p.eps = eps, p.head_eps = head_eps, p.scale = scale;
  const void* kernel = w_int8 ? reinterpret_cast<const void*>(&lowlat_encoder_kernel<true>)
                              : reinterpret_cast<const void*>(&lowlat_encoder_kernel<false>);
  return launch_persistent(kernel, p, w_int8 != 0, splitk_len, trace_len,
                           static_cast<cudaStream_t>(stream));
}

// The launcher's plan for a shape (lowlat_core.cuh plan_ints) on this
// card's SM count, or on `sms` SMs when sms > 0: ops/lowlat.py::
// lowlat_launch_config reads it.  Returns how many integers it wrote.
extern "C" int vsd_lowlat_plan(int batch_grid, int fold_ends, int int8, int depth, int batch,
                               int tp, int d, int heads, int hh, int sms, int* out, int len) {
  return vsd::lowlat::plan_entry(batch_grid, fold_ends, int8, depth, batch, tp, d, heads, hh, sms,
                                 out, len);
}

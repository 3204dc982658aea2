// The whole ViT encoder for a chunk of up to 4 items in one launch, for
// B = 2-16 serving, on Hopper, over the batch-grid pack:
//
//   x [b, Tp, D] -> per layer: attention sub-layer; MLP half A into an f32
//   partial; x + (A + B) + b2 rounded once -> x
//
// Replaces the TPU kernel vit_spoof_detection_pda_tpu/ops/lowlat.py::
// _encoder_batchgrid_kernel (:241; wrapper encoder_forward_lowlat_batchgrid
// :354, pack pack_encoder_weights_batchgrid :311).
//
// Bound on the H100 at ViT-B, a chunk of 2 items: the tensor cores.  Its
// 70.9 GFLOP of products take 0.072 ms at 989 TFLOP/s; the 169.9 MB of
// superblocks take 0.051 ms at 3.35 TB/s.
//
// Design (lowlat_core.cuh has the phase loop): one cooperative launch of a
// persistent grid, per layer LN1 | QKV | attention | proj + residual | LN2 |
// fc1 of both halves + GELU | fc2 half A -> f32 partial | fc2 half B +
// partial + residual.  The TPU kernel split the MLP in halves so that no
// [Tp, 4D] hidden had to persist in VMEM between grid steps; here the
// hidden of the whole chunk (4.9 MB at 4 items) stays in L2, so both fc1
// halves run in one phase and only fc2 keeps the split and its f32 partial
// sum.  Each superblock is read from device memory once per chunk.
//
// Rounding points follow the TPU kernel: as lowlat_encoder.cu; the MLP
// output is x + (A + B) + b2 in f32, rounded once.  Zero pad items (the
// serving wrapper's last chunk) are computed like real ones: LN of a zero
// row is its bias.
#include "lowlat_core.cuh"

namespace vsd {
namespace lowlat {
namespace {

__global__ void __launch_bounds__(kThreads) lowlat_batchgrid_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int rows = p.batch * p.tp, d = p.d, h4 = 4 * d;
  const bf16* cur = p.x_in;
  trace_begin(p);
  for (int l = 0; l < p.depth; ++l) {
    const bf16* w0 = p.w + static_cast<size_t>(3 * l) * d * h4;
    const float* s0 = p.s + static_cast<size_t>(3 * l) * 4 * h4;
    const bf16 *wa = w0 + static_cast<size_t>(d) * h4, *wb = wa + static_cast<size_t>(d) * h4;
    const float *sa = s0 + 4 * h4, *sb = sa + 4 * h4;
    attention_sublayer(p, cur, w0, s0, smem);
    cur = p.x;
    ln_phase(p.x, sa, sa + h4, p.xn, rows, d, p.eps);
    grid_sync(p.bar, p.trace);
    Gemm fa{};  // hidden columns 0 .. 2D from half A, 2D .. 4D from half B
    fa.a = p.xn, fa.lda = d, fa.w = wa, fa.ldw = h4, fa.kc = d, fa.bias = sa + 2 * h4;
    fa.c = p.hid, fa.ldc = h4, fa.m = rows, fa.n = 2 * d, fa.k = d;
    Gemm fb = fa;
    fb.w = wb, fb.bias = sb + 2 * h4, fb.c = p.hid + 2 * d;
    gemm_phase<kGelu>(p, fa, &fb, smem);
    grid_sync(p.bar, p.trace);
    Gemm ga{};  // fc2 rows 0 .. 2D: two D-row chunks in columns 2D .. 4D of wa
    ga.a = p.hid, ga.lda = h4, ga.w = wa + 2 * d, ga.ldw = h4, ga.kc = d;
    ga.cf = p.part, ga.ldc = d, ga.m = rows, ga.n = d, ga.k = 2 * d;
    gemm_phase<kF32>(p, ga, nullptr, smem);
    grid_sync(p.bar, p.trace);
    Gemm gb = ga;  // fc2 rows 2D .. 4D, plus the partial, the residual, b2
    gb.a = p.hid + 2 * d, gb.w = wb + 2 * d, gb.cf = nullptr, gb.part = p.part;
    gb.bias = sb + 3 * h4, gb.r = p.x, gb.c = p.x;
    gemm_phase<kResPart>(p, gb, nullptr, smem);
    if (l + 1 < p.depth) grid_sync(p.bar, p.trace);
  }
  trace_end(p);
}

}  // namespace
}  // namespace lowlat
}  // namespace vsd

// x_in, x [b, Tp, D] bf16 (in, out); w [3*depth, D, 4D] bf16, s [3*depth,
// 4, 4D] f32 (the batch-grid pack); scratch xn [b*Tp, D], qkv [b*Tp, 3D],
// hid [b*Tp, 4D] bf16, part [b*Tp, D] f32; bar: 2 + splitk_units 32-bit
// words; splitk [splitk_units, 64, 128] f32 scratch; trace: null, or
// 64-bit timestamps, one per barrier (lowlat_core.cuh).  Needs
// 1 <= b <= 4, a head dim of 16, 32 or 64, D and Tp multiples of 8 and
// 0 < valid_len <= Tp.  Returns the CUDA error of the launch (0 on success).
extern "C" int vsd_lowlat_batchgrid(const void* x_in, void* x, const void* w, const void* s,
                                    void* xn, void* qkv, void* hid, void* part, void* bar,
                                    void* splitk, int splitk_units, void* trace, int depth,
                                    int batch, int tp, int d, int heads, int valid_len,
                                    float eps, float scale, void* stream) {
  using namespace vsd;
  using namespace vsd::lowlat;
  if (batch > 4 || splitk_units < 0 || !valid_shape(depth, batch, tp, d, heads, valid_len))
    return cudaErrorInvalidValue;
  Params p{};
  p.x_in = static_cast<const bf16*>(x_in);
  p.x = static_cast<bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.s = static_cast<const float*>(s);
  p.xn = static_cast<bf16*>(xn);
  p.qkv = static_cast<bf16*>(qkv);
  p.hid = static_cast<bf16*>(hid);
  p.part = static_cast<float*>(part);
  p.bar = static_cast<unsigned*>(bar);
  p.tile_count = p.bar + 2;
  p.splitk = static_cast<float*>(splitk);
  p.splitk_units = splitk_units;
  p.trace = static_cast<unsigned long long*>(trace);
  p.depth = depth, p.batch = batch, p.tp = tp, p.d = d, p.heads = heads;
  p.valid_len = valid_len;
  p.eps = eps, p.scale = scale;
  return launch_persistent(reinterpret_cast<const void*>(&lowlat_batchgrid_kernel), p,
                           static_cast<cudaStream_t>(stream));
}

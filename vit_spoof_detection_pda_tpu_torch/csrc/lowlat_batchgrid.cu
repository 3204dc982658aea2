// The whole ViT encoder for a chunk of up to 4 items in one launch, for
// B = 2-16 serving, on Hopper, over the batch-grid pack:
//
//   x [b, Tp, D] -> per layer: attention sub-layer; fc1 of both MLP halves;
//   x + (A + B) + b2 rounded once -> x
//
// Replaces the TPU kernel vit_spoof_detection_pda_tpu/ops/lowlat.py::
// _encoder_batchgrid_kernel (:241; wrapper encoder_forward_lowlat_batchgrid
// :354, pack pack_encoder_weights_batchgrid :311).
//
// Bound on the H100 at ViT-B, a chunk of 2 items: the tensor cores.  Its
// 70.9 GFLOP of products take 0.072 ms at 989 TFLOP/s; the 169.9 MB of
// superblocks take 0.051 ms at 3.35 TB/s.
//
// Design: the per-item kernel's (lowlat_core.cuh), on the batch-grid pack.
// The TPU kernel split the MLP in halves so that no [Tp, 4D] hidden had to
// persist in VMEM between grid steps; here the hidden of the whole chunk
// (4.9 MB at 4 items) stays in L2, so fc1 runs both halves as one GEMM
// (hidden columns 2D.. from the second half's step) and fc2 one GEMM over
// K = 4D (chunks 0-1 from the first half's fc2 columns, 2-3 from the
// second's), its slices summed in the next row phase.  Each superblock
// tile is staged once per unit of rows.
//
// Rounding points follow the TPU kernel: as lowlat_encoder.cu; the MLP
// output is x + (A + B) + b2 in f32, rounded once.  Zero pad items (the
// serving wrapper's last chunk) are computed like real ones: LN of a zero
// row is its bias.
#include "lowlat_core.cuh"

namespace vsd {
namespace lowlat {
namespace {

__global__ void __launch_bounds__(kThreads, 1)
    lowlat_batchgrid_kernel(const __grid_constant__ Params p) {
  encoder_kernel_body<false>(p);
}

}  // namespace
}  // namespace lowlat
}  // namespace vsd

// x_in, x [b, Tp, D] bf16 (in, out); w [3*depth, D, 4D] bf16, s [3*depth,
// 4, 4D] f32 (the batch-grid pack); scratch xn [b*Tp, D], qkv [b*Tp, 3D],
// hid [b*Tp, 4D] bf16; bar: 1 + b 32-bit words; splitk: splitk_len f32 (at
// least the plan's splitk_floats); trace: null, or trace_len 64-bit
// timestamps (lowlat_core.cuh).  Needs 1 <= b <= 4, a head dim of 16, 32
// or 64, D a multiple of 16, Tp a multiple of 8 and 0 < valid_len <= Tp.
// Returns the CUDA error of the launch (0 on success).
extern "C" int vsd_lowlat_batchgrid(const void* x_in, void* x, const void* w, const void* s,
                                    void* xn, void* qkv, void* hid, void* bar, void* splitk,
                                    long long splitk_len, void* trace, int trace_len, int depth,
                                    int batch, int tp, int d, int heads, int valid_len,
                                    float eps, float scale, void* stream) {
  using namespace vsd;
  using namespace vsd::lowlat;
  if (batch > 4 || !valid_shape(depth, batch, tp, d, heads, valid_len))
    return cudaErrorInvalidValue;
  Params p{};
  if (!encode_map(&p.wmap, w, 3LL * depth * d, 4LL * d, false)) return cudaErrorInvalidValue;
  p.x_in = static_cast<const bf16*>(x_in);
  p.x = static_cast<bf16*>(x);
  p.s = static_cast<const float*>(s);
  p.xn = static_cast<bf16*>(xn);
  p.qkv = static_cast<bf16*>(qkv);
  p.hid = static_cast<bf16*>(hid);
  p.part = static_cast<float*>(splitk);
  p.bar = static_cast<unsigned*>(bar);
  p.trace = static_cast<unsigned long long*>(trace);
  p.depth = depth, p.batch = batch, p.tp = tp, p.d = d, p.heads = heads;
  p.valid_len = valid_len;
  p.batch_grid = 1, p.fold_ends = 0, p.srows = 4;
  p.eps = eps, p.scale = scale;
  return launch_persistent(reinterpret_cast<const void*>(&lowlat_batchgrid_kernel), p, false,
                           splitk_len, trace_len, static_cast<cudaStream_t>(stream));
}

// The launcher's plan (lowlat_encoder.cu vsd_lowlat_plan, the same core).
extern "C" int vsd_lowlat_plan(int batch_grid, int fold_ends, int int8, int depth, int batch,
                               int tp, int d, int heads, int hh, int sms, int* out, int len) {
  return vsd::lowlat::plan_entry(batch_grid, fold_ends, int8, depth, batch, tp, d, heads, hh, sms,
                                 out, len);
}

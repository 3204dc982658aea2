// Backward of the attention core in f32 on Hopper: given the fused
// projection qkv [B, Tp, 3D] f32 (q | k | v, heads contiguous inside each)
// and the cotangent g [B, Tp, D] f32 of the concatenated head outputs (zero
// on pad rows), per head
//
//   w  = softmax(q k^T * s), key columns >= valid_len at -1e30
//   dv = w^T g,  dw = g v^T,  dl = w (dw - rowsum(dw w))
//   dq = dl k * s,  dk = dl^T q * s
//
// into dqkv [B, Tp, 3D] f32.  Replaces the f32 form of the TPU kernel
// vit_spoof_detection_pda_tpu/ops/attention.py::_attn_qkv_bwd_kernel (:199),
// whose f32 dots keep exact products; so does this one (plain f32 FMAs,
// never TF32).
//
// Bound on the H100: the f32 FMA rate.  At ViT-B, B = 32, Tp = 200 the five
// [Tp, Tp] x Dh products per head are 9.8 GFLOP, >= 0.147 ms at 67 TFLOP/s;
// qkv and g in and dqkv out are 72 MB (0.021 ms at 3.35 TB/s).
//
// Design.  The bf16 kernel (attention_qkv_bwd.cu) holds a head's whole
// [Tp, Tp] w and dl in shared memory; in f32 those alone take 320 KB at
// Tp = 200, over the card's 227 KB.  So f32 runs two launches, each of
// which holds one head's operands [Tp][Dh + 4] in shared memory and keeps
// only a warp's 4 rows (or 4 keys) of w and dl, [Tp][4] each:
//   A. rows: grid (query tiles, heads, B), K and V staged.  A warp takes 4
//      query rows at a time: its lanes score their keys (s = q k * s) and
//      form dw = g v, the row max m and sum l (warp reductions) give
//      w = exp(s - m) / l, then dd = rowsum(dw w), dl = w (dw - dd), and
//      dq = dl K * s with each lane owning columns lane, lane + 32, ...
//      m, l and dd of every row go to a small stats buffer [B, H, Tp, 4].
//   B. keys: grid (key tiles, heads, B), Q, G and the rows' stats staged.
//      A warp takes 4 keys at a time: its lanes take the query rows
//      (lane, lane + 32, ...) and recompute s, w = exp(s - m) / l, dw and
//      dl = w (dw - dd) with the same f32 operations in the same order as
//      launch A (so the same bits), then dv = w^T G and dk = dl^T Q * s
//      with each lane owning columns.
// The scores and dw are computed twice (7 products instead of 5).  Rows
// with g = 0 give dw = 0, hence dd = 0 and dl = 0: pad rows add nothing;
// masked key columns have w = 0 exactly, so their dk and dv are 0.  The
// two launches' bodies are attention_bwd_f32.cuh::bwd_rows_f32 and
// bwd_keys_f32, which kernel 13's f32 form (attention_cp_bwd.cu) runs on a
// rectangle of local queries against the gathered keys.
#include "attention_bwd_f32.cuh"

namespace vsd {
namespace {

template <int DH>
__global__ void __launch_bounds__(kBwdF32Warps * 32)
    attn_bwd_rows_f32(const float* __restrict__ qkv, const float* __restrict__ gout,
                      float* __restrict__ dqkv, float* __restrict__ stats, int t, int d,
                      int valid_len, float scale, int tile_rows) {
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const size_t stride = 3 * static_cast<size_t>(d);
  const float* base = qkv + static_cast<size_t>(b) * t * stride + static_cast<size_t>(h) * DH;
  bwd_rows_f32<DH>(base, stride, base + d, base + 2 * d, stride,
                   gout + static_cast<size_t>(b) * t * d + static_cast<size_t>(h) * DH, d,
                   dqkv + static_cast<size_t>(b) * t * stride + static_cast<size_t>(h) * DH,
                   stride, stats + (static_cast<size_t>(b) * heads + h) * t * 4, t, t,
                   valid_len, scale, tile_rows);
}

template <int DH>
__global__ void __launch_bounds__(kBwdF32Warps * 32)
    attn_bwd_keys_f32(const float* __restrict__ qkv, const float* __restrict__ gout,
                      float* __restrict__ dqkv, const float* __restrict__ stats, int t, int d,
                      int valid_len, float scale, int tile_keys) {
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const size_t stride = 3 * static_cast<size_t>(d);
  const float* base = qkv + static_cast<size_t>(b) * t * stride + static_cast<size_t>(h) * DH;
  float* obase = dqkv + static_cast<size_t>(b) * t * stride + static_cast<size_t>(h) * DH;
  bwd_keys_f32<DH>(base, stride, base + d, base + 2 * d, stride,
                   gout + static_cast<size_t>(b) * t * d + static_cast<size_t>(h) * DH, d,
                   obase + d, obase + 2 * d, stride,
                   stats + (static_cast<size_t>(b) * heads + h) * t * 4, t, t, valid_len, scale,
                   tile_keys);
}

template <int DH>
cudaError_t launch_bwd_f32(const float* qkv, const float* g, float* dqkv, float* stats,
                           int batch, int t, int d, int heads, int valid_len, float scale,
                           cudaStream_t stream) {
  const size_t smem = bwd_f32_smem_bytes(t, DH);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_rows_f32<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attn_bwd_keys_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = bwd_f32_tile(t);
  const dim3 grid((t + rows - 1) / rows, heads, batch);
  attn_bwd_rows_f32<DH><<<grid, kBwdF32Warps * 32, smem, stream>>>(qkv, g, dqkv, stats, t, d,
                                                                   valid_len, scale, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_keys_f32<DH><<<grid, kBwdF32Warps * 32, smem, stream>>>(qkv, g, dqkv, stats, t, d,
                                                                   valid_len, scale, rows);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vsd

// qkv, dqkv [B, Tp, 3D] f32; g [B, Tp, D] f32, zero on rows >= valid_len;
// stats [B, H, Tp, 4] f32 scratch.  Needs a head dim that is a multiple of
// 16 up to 128, 0 < valid_len <= Tp and the launches' shared memory
// (4 (2 Tp (Dh + 4) + 4 Tp + 8 (8 Dh + 8 Tp)) bytes) within the card's.
// Returns the first CUDA error of the two launches (0 on success).
extern "C" int vsd_attention_qkv_bwd_f32(const void* qkv, const void* g, void* dqkv,
                                         void* stats, int batch, int tp, int d, int num_heads,
                                         int valid_len, float scale, void* stream) {
  using namespace vsd;
  if (batch <= 0 || batch > 65535 || tp <= 0 || d <= 0 || num_heads <= 0 ||
      num_heads > 65535 || d % num_heads || valid_len <= 0 || valid_len > tp)
    return cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(qkv);
  const float* gf = static_cast<const float*>(g);
  float* out = static_cast<float*>(dqkv);
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / num_heads) {
#define VSD_HEAD_DIM(DH) \
  case DH:               \
    return launch_bwd_f32<DH>(q, gf, out, st, batch, tp, d, num_heads, valid_len, scale, s);
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

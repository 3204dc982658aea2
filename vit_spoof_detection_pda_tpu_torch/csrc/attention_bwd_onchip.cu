// The library of the on-chip attention backward (attention_bwd_onchip.cuh):
// the entry points of kernels 4 (attention_qkv_bwd.cu), 5
// (attention_qkv_bwd_phased.cu) and 13 (attention_cp_bwd.cu), each in its
// own launcher file, built as one translation unit so the core's template
// instances compile once; and the report of what a launch would run.
#include "attention_cp_bwd.cu"
#include "attention_qkv_bwd.cu"
#include "attention_qkv_bwd_phased.cu"

// What a launch of the core for tq query rows against tk keys at head dim
// dh (bf16, or f32 with f32 == 1) runs: its instance (*keys), warps a block
// (*warps) and dynamic shared memory in bytes (*smem).  Launches nothing.
// Returns 0, or cudaErrorInvalidValue where the core does not hold the
// head (the outputs then untouched).
extern "C" int vsd_onchip_bwd_config(int tq, int tk, int dh, int f32, int* keys, int* warps,
                                     long long* smem) {
  vsd::OnConfig c;
  if (!vsd::onchip_config(tq, tk, dh, f32 != 0, &c)) return cudaErrorInvalidValue;
  *keys = c.keys;
  *warps = c.warps;
  *smem = static_cast<long long>(c.smem);
  return 0;
}

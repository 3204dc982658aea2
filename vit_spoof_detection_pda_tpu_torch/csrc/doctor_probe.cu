// The doctor's toolchain probe on Hopper: o = 2 x over f32 elements.
//
// Replaces the TPU kernel vit_spoof_detection_pda_tpu/cli/doctor.py::
// check_pallas (:115), which lowers a trivial Pallas kernel to show that
// Mosaic works on the machine.  Here it shows that nvcc builds a kernel for
// sm_90a, that ctypes loads it and that it launches and computes: the
// doctor's `pallas` check calls it on an [8, 128] f32 array of ones and
// asks for a sum of exactly 2048.
//
// Bound on the H100: bytes (n f32 in, n out; 8 KB at [8, 128], where the
// launch itself is the cost).  Design: one thread an element.
#include "common.cuh"

namespace vsd {
namespace {

__global__ void doctor_probe_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.f * x[i];
}

}  // namespace
}  // namespace vsd

// x, o: n f32 on the card.  Returns the launch's CUDA error (0 on success).
extern "C" int vsd_doctor_probe(const void* x, void* o, int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  vsd::doctor_probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return cudaGetLastError();
}

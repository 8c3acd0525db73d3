// The card's dependent-load latency: one thread follows a cyclic chain of
// indices through a buffer, the address of each load the value of the
// one before, so no two loads overlap.  Over a buffer far larger than the
// 50 MB L2 (loads cached in L2 only) nearly every step is a round trip
// to HBM.  It ports no TPU kernel: chip_smoke times it to put a latency
// floor beside the bound of the kernels that walk version chains.
#include <cuda_runtime.h>

namespace {

__global__ void pointer_chase_kernel(const int* __restrict__ next, int start,
                                     int steps, int* __restrict__ out) {
  int i = start;
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  *out = i;
}

}  // namespace

extern "C" int uruv_pointer_chase(const int* next, int start, int steps,
                                  int* out, void* stream) {
  if (steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  pointer_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      next, start, steps, out);
  return static_cast<int>(cudaGetLastError());
}

// The card's dependent-load latency: one thread follows a cyclic chain of
// indices through a buffer, the address of each load the value of the
// one before, so no two loads overlap.  Loads are cached in L2 only, so
// over a buffer far larger than the 50 MB L2 nearly every step is a round
// trip to HBM, and over a warm buffer of a few MiB every step is an L2
// hit.  It ports no TPU kernel: chip_smoke times it both ways to put a
// latency floor beside the bound of the kernels that walk version chains
// (HBM) and of search_positions, whose directory sits in L2.
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

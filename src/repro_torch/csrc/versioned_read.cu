// Snapshot version resolution for Hopper: the paper's versioned read.
//
// Replaces the Pallas TPU kernel versioned_read
// (src/repro/kernels/versioned_read/versioned_read.py).  The TPU version
// pins the whole version pool in VMEM and runs a fixed max_chain unroll
// of vectorised gathers.  Here one thread walks one query's chain from
// its head while the version is newer than the snapshot, stopping at the
// first step that does not advance (the unroll's fixed point) or after
// max_chain steps.  It is bound by dependent-gather latency: each step
// reads 8 bytes (ts, next) from a pool far larger than L2, and a chain
// is usually 0 to 2 steps long; thousands of independent queries per
// launch hide the latency.
#include <cuda_runtime.h>

#include "uruv_common.cuh"

namespace {

__global__ void versioned_read_kernel(const int* __restrict__ vhead,
                                      const int* __restrict__ snap_ts, int n,
                                      const int* __restrict__ ver_ts,
                                      const int* __restrict__ ver_next,
                                      const int* __restrict__ ver_value,
                                      int n_ver, int max_chain,
                                      int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = uruv::resolve_chain(vhead[i], snap_ts[i], ver_ts, ver_next,
                               ver_value, n_ver, max_chain);
}

}  // namespace

extern "C" int uruv_versioned_read(const int* vhead, const int* snap_ts,
                                   int n, const int* ver_ts,
                                   const int* ver_next, const int* ver_value,
                                   int n_ver, int max_chain, int* out,
                                   void* stream) {
  constexpr int kThreads = 256;
  versioned_read_kernel<<<uruv::blocks_for(n, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      vhead, snap_ts, n, ver_ts, ver_next, ver_value, n_ver, max_chain, out);
  return static_cast<int>(cudaGetLastError());
}

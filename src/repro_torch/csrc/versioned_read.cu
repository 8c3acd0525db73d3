// Snapshot version resolution for Hopper: the paper's versioned read.
//
// Replaces the Pallas TPU kernel versioned_read
// (src/repro/kernels/versioned_read/versioned_read.py).  The TPU version
// pins the whole version pool in VMEM and runs a fixed max_chain unroll
// of vectorised gathers.  Here one thread walks one query's chain from
// its head while the version is newer than the snapshot, stopping at the
// first step that does not advance (the unroll's fixed point) or after
// max_chain steps.  It is bound by the latency of dependent loads, not by
// bytes: a chain is usually 0 to 2 steps long in a pool far larger than
// L2.  So each hop loads ts, next and value together
// (uruv::resolve_chains): after the head and snapshot, a chain that
// advances h times costs h + 1 round trips.  The snapshot is one per
// query (stride 1) or one for all (stride 0, no [P] copy of a scalar).
// Thousands of independent queries per launch hide the latency.
//
// The lookup path does not launch this kernel: leaf_slots_at walks the
// hit's chain in the same launch as the in-leaf rank (uruv_search.cu).
// The single-interval range scan (scan_page) does.
#include <cuda_runtime.h>

#include "uruv_common.cuh"

namespace {

__global__ void versioned_read_kernel(const int* __restrict__ vhead,
                                      const int* __restrict__ snap_ts,
                                      int snap_stride, int n,
                                      const int* __restrict__ ver_ts,
                                      const int* __restrict__ ver_next,
                                      const int* __restrict__ ver_value,
                                      int n_ver, int max_chain,
                                      int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = uruv::resolve_chain(__ldg(vhead + i),
                               __ldg(snap_ts + i * snap_stride), ver_ts,
                               ver_next, ver_value, n_ver, max_chain);
}

}  // namespace

extern "C" int uruv_versioned_read(const int* vhead, const int* snap_ts,
                                   int snap_stride, int n, const int* ver_ts,
                                   const int* ver_next, const int* ver_value,
                                   int n_ver, int max_chain, int* out,
                                   void* stream) {
  if (n < 1 || n_ver < 1 || (snap_stride != 0 && snap_stride != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 256;
  versioned_read_kernel<<<uruv::blocks_for(n, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      vhead, snap_ts, snap_stride, n, ver_ts, ver_next, ver_value, n_ver,
      max_chain, out);
  return static_cast<int>(cudaGetLastError());
}

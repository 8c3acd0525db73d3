// Fused range-scan candidate phase for Hopper (paper Sec 3.4).
//
// Replaces the Pallas TPU kernel range_scan
// (src/repro/kernels/uruv_range/uruv_range.py).  The TPU version pins
// the leaf and version pools in VMEM and loops over a query tile's window
// slots.  Here one thread takes one candidate (query row q, window slot
// s, leaf slot j) of the Q x S x L grid: it gathers the leaf's key and
// count, masks by pvalid, slot < count and k1 <= key <= k2, walks the
// candidate's version chain to its query's snapshot, and writes the key
// and value (KEY_MAX / NOT_FOUND for a non-hit).  Consecutive threads
// read consecutive keys of one leaf row, so the leaf gather is
// coalesced.  It is bound by bytes: the two Q x S x L int32 outputs and
// the gathered leaf rows dominate; chain steps touch only candidates.
#include <cuda_runtime.h>

#include "uruv_common.cuh"

namespace {

__global__ void range_scan_kernel(
    const int* __restrict__ lids, const unsigned char* __restrict__ pvalid,
    const int* __restrict__ k1, const int* __restrict__ k2,
    const int* __restrict__ snap_ts, long long total, int window,
    const int* __restrict__ leaf_keys, const int* __restrict__ leaf_vhead,
    const int* __restrict__ leaf_count, int n_leaf, int width,
    const int* __restrict__ ver_ts, const int* __restrict__ ver_next,
    const int* __restrict__ ver_value, int n_ver, int max_chain,
    int* __restrict__ out_keys, int* __restrict__ out_vals) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= total) return;
  const int j = static_cast<int>(t % width);
  const long long qs = t / width;            // (query, window slot)
  const long long q = qs / window;
  const int lid = uruv::jax_index(__ldg(lids + qs), n_leaf);
  const long long at = static_cast<long long>(lid) * width + j;
  const int key = __ldg(leaf_keys + at);
  const bool cand = pvalid[qs] && j < __ldg(leaf_count + lid) &&
                    key >= k1[q] && key <= k2[q];
  int val = uruv::kNotFound;
  if (cand) {
    val = uruv::resolve_chain(__ldg(leaf_vhead + at), snap_ts[q], ver_ts,
                              ver_next, ver_value, n_ver, max_chain);
  }
  const bool hit = cand && val != uruv::kNotFound;
  out_keys[t] = hit ? key : uruv::kKeyMax;
  out_vals[t] = hit ? val : uruv::kNotFound;
}

}  // namespace

extern "C" int uruv_range_scan(const int* lids, const unsigned char* pvalid,
                               const int* k1, const int* k2,
                               const int* snap_ts, int n_query, int window,
                               const int* leaf_keys, const int* leaf_vhead,
                               const int* leaf_count, int n_leaf, int width,
                               const int* ver_ts, const int* ver_next,
                               const int* ver_value, int n_ver, int max_chain,
                               int* out_keys, int* out_vals, void* stream) {
  constexpr int kThreads = 256;
  const long long total = static_cast<long long>(n_query) * window * width;
  range_scan_kernel<<<uruv::blocks_for(total, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      lids, pvalid, k1, k2, snap_ts, total, window, leaf_keys, leaf_vhead,
      leaf_count, n_leaf, width, ver_ts, ver_next, ver_value, n_ver,
      max_chain, out_keys, out_vals);
  return static_cast<int>(cudaGetLastError());
}

// Uruv locate kernels for Hopper: the multi-level fat-node descent and the
// in-leaf rank.
//
// index_descend replaces the Pallas TPU kernel index_descend
// (src/repro/kernels/uruv_search/uruv_search.py).  The TPU version pins
// every index level in VMEM and descends a tile of queries with
// vectorised row gathers.  Here one thread descends one query: per level
// it reads the F keys of its node row (64 contiguous bytes at F = 16),
// counts live keys <= q, and gathers one child id.  What bounds it is D
// dependent gathers per query, i.e. memory latency; the upper levels are
// a few KiB and stay in L2 (50 MB), and only the bottom level misses.
// Enough independent queries (one per thread, thousands per launch) are
// in flight to hide that latency.
//
// leaf_slots replaces the Pallas TPU kernel leaf_slots (same file).  One
// warp takes one query: the warp reads the gathered leaf row coalesced
// (L = 64 int32 is two 128-byte lines), each lane compares one key, and
// __ballot_sync + __popc give the rank #(row < q).  It is bound by the
// P * L * 4 bytes of gathered rows.
#include <cuda_runtime.h>

#include "uruv_common.cuh"

namespace {

constexpr int kMaxDepth = 32;

struct Levels {
  const int* keys[kMaxDepth];   // level l: [cap[l], F], l = 0 is the bottom
  const int* child[kMaxDepth];  // level l: [cap[l], F]; l = 0 holds leaf ids
  int cap[kMaxDepth];
};

__global__ void index_descend_kernel(Levels lv, int depth, int fanout,
                                     const int* __restrict__ queries, int n,
                                     int* __restrict__ bnode,
                                     int* __restrict__ bslot,
                                     int* __restrict__ leaf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int q = queries[i];
  int cur = 0;  // the root is node 0 of the top level
  int slot = 0;
  int nxt = 0;
  for (int l = depth - 1; l >= 0; --l) {
    const long long row = static_cast<long long>(uruv::jax_index(cur, lv.cap[l])) * fanout;
    const int* keys = lv.keys[l] + row;
    int cnt = 0;
    for (int j = 0; j < fanout; ++j) {
      const int k = __ldg(keys + j);
      cnt += (k <= q) & (k < uruv::kKeyMax);  // KEY_MAX is padding
    }
    slot = cnt > 0 ? cnt - 1 : 0;
    nxt = __ldg(lv.child[l] + row + slot);
    if (l > 0) cur = nxt;
  }
  bnode[i] = cur;
  bslot[i] = slot;
  leaf[i] = nxt;
}

__global__ void leaf_slots_kernel(const int* __restrict__ rows,
                                  const int* __restrict__ queries, int n,
                                  int width, int* __restrict__ slot_out,
                                  unsigned char* __restrict__ exists_out) {
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;  // uniform across the warp
  const int q = queries[warp];
  const int* row = rows + warp * width;
  int cnt = 0;
  for (int base = 0; base < width; base += 32) {
    const int j = base + lane;
    const bool lt = j < width && __ldg(row + j) < q;
    cnt += __popc(__ballot_sync(0xffffffffu, lt));
  }
  if (lane == 0) {
    const int hit = __ldg(row + (cnt < width ? cnt : width - 1));
    slot_out[warp] = cnt;
    exists_out[warp] = (cnt < width) && (hit == q);
  }
}

}  // namespace

extern "C" int uruv_index_descend(const long long* key_ptrs,
                                  const long long* child_ptrs,
                                  const int* caps, int depth, int fanout,
                                  const int* queries, int n, int* bnode,
                                  int* bslot, int* leaf, void* stream) {
  if (depth < 1 || depth > kMaxDepth) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  for (int l = 0; l < depth; ++l) {
    lv.keys[l] = reinterpret_cast<const int*>(key_ptrs[l]);
    lv.child[l] = reinterpret_cast<const int*>(child_ptrs[l]);
    lv.cap[l] = caps[l];
  }
  constexpr int kThreads = 256;
  index_descend_kernel<<<uruv::blocks_for(n, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lv, depth, fanout, queries, n, bnode, bslot, leaf);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int uruv_leaf_slots(const int* rows, const int* queries, int n,
                               int width, int* slot_out,
                               unsigned char* exists_out, void* stream) {
  constexpr int kThreads = 256;  // 8 queries per block
  leaf_slots_kernel<<<uruv::blocks_for(32LL * n, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rows, queries, n, width, slot_out, exists_out);
  return static_cast<int>(cudaGetLastError());
}

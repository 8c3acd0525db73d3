// Fused range-scan candidate phase for Hopper (paper Sec 3.4).
//
// Replaces the Pallas TPU kernel range_scan
// (src/repro/kernels/uruv_range/uruv_range.py).  The TPU version pins
// the leaf and version pools in VMEM and loops over a query tile's window
// slots.  Here the work is rows: row r = (query q, window slot s) of the
// Q x S grid gathers leaf row lids[r], masks its L candidates by pvalid,
// slot < count and k1 <= key <= k2, walks each candidate's version chain
// to its query's snapshot, and writes L keys and values (KEY_MAX /
// NOT_FOUND for a non-hit).
//
// What bounds it is bytes: the two Q x S x L int32 outputs (16 MiB at the
// main path's worklist of 32,768 rows x 64), and on the main path most
// rows are padding (a range of 1,000 keys covers about a dozen leaves of
// the window a query may take).  So:
//   * a group of G lanes takes a row, each lane VEC = 4 consecutive slots
//     (16 lanes x int4 at L = 64, two rows a warp, as leaf_slots does);
//     lanes never talk to each other, so a group finishes on its own;
//   * the first round trip loads the row's leaf id and pvalid and its
//     query's k1, k2 and snapshot; a row whose pvalid is false writes
//     its padding with 16-byte stores and gathers nothing;
//   * a valid row's second round trip loads its key chunk, version-head
//     chunk and leaf count together, and the VEC chains of a lane are
//     walked together, each hop's ts, next and value loaded together
//     (uruv::resolve_chains);
//   * index math is 32-bit (the wrapper checks the sizes).
// VEC = 4 needs L % 4 == 0 and 16-byte aligned leaf pools; otherwise the
// wrapper picks VEC = 1 (4-byte loads and stores), the same kernel.
// G = min(32, pow2ceil(L / VEC)); wider rows loop over their chunks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "uruv_common.cuh"

namespace {

constexpr int kThreads = 128;

struct Pools {
  const int* keys;   // [n_leaf, W]
  const int* vhead;  // [n_leaf, W]
  const int* count;  // [n_leaf]
  const int* ver_ts;
  const int* ver_next;
  const int* ver_value;
  int n_leaf;
  int n_ver;
  int max_chain;
};

template <int VEC>
__device__ __forceinline__ void load_chunk(const int* p, int (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_chunk(int* p, const int (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int G, int VEC>
__global__ void __launch_bounds__(kThreads)
    range_scan_kernel(const int* __restrict__ lids,
                      const unsigned char* __restrict__ pvalid,
                      const int* __restrict__ k1, const int* __restrict__ k2,
                      const int* __restrict__ snap_ts, int n_rows,
                      int window, int W, Pools pl,
                      int* __restrict__ out_keys,
                      int* __restrict__ out_vals) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  const int r = static_cast<int>(t / G);
  const int g = static_cast<int>(t % G);
  if (r >= n_rows) return;
  const int q = r / window;
  const int lid = __ldg(lids + r);
  const bool valid = __ldg(pvalid + r) != 0;
  const int lo = __ldg(k1 + q);
  const int hi = __ldg(k2 + q);
  const int snap = __ldg(snap_ts + q);
  int* ok = out_keys + r * W;
  int* ov = out_vals + r * W;
  const int nch = W / VEC;
  int kv[VEC], vv[VEC];
  if (!valid) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      kv[e] = uruv::kKeyMax;
      vv[e] = uruv::kNotFound;
    }
    for (int c = g; c < nch; c += G) {
      store_chunk<VEC>(ok + c * VEC, kv);
      store_chunk<VEC>(ov + c * VEC, vv);
    }
    return;
  }
  const int li = uruv::jax_index(lid, pl.n_leaf);
  const int row = li * W;
  const int cnt = __ldg(pl.count + li);
  for (int c = g; c < nch; c += G) {
    load_chunk<VEC>(pl.keys + row + c * VEC, kv);
    load_chunk<VEC>(pl.vhead + row + c * VEC, vv);
    int head[VEC], val[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const bool cand = c * VEC + e < cnt && kv[e] >= lo && kv[e] <= hi;
      head[e] = cand ? vv[e] : -1;
    }
    uruv::resolve_chains<VEC>(head, snap, pl.ver_ts, pl.ver_next,
                              pl.ver_value, pl.n_ver, pl.max_chain, val);
    // a non-candidate walked no chain and reads NOT_FOUND
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const bool hit = val[e] != uruv::kNotFound;
      kv[e] = hit ? kv[e] : uruv::kKeyMax;
    }
    store_chunk<VEC>(ok + c * VEC, kv);
    store_chunk<VEC>(ov + c * VEC, val);
  }
}

// lanes per row: the power of two covering a row's chunks, at most 32
int group_for(int chunks) {
  int g = 1;
  while (g < chunks && g < 32) g <<= 1;
  return g;
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

template <int G, int VEC>
int launch(const int* lids, const unsigned char* pvalid, const int* k1,
           const int* k2, const int* snap_ts, int n_rows, int window, int W,
           const Pools& pl, int* out_keys, int* out_vals, cudaStream_t s) {
  range_scan_kernel<G, VEC>
      <<<uruv::blocks_for(static_cast<long long>(n_rows) * G, kThreads),
         kThreads, 0, s>>>(lids, pvalid, k1, k2, snap_ts, n_rows, window, W,
                           pl, out_keys, out_vals);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int dispatch(int G, const int* lids, const unsigned char* pvalid,
             const int* k1, const int* k2, const int* snap_ts, int n_rows,
             int window, int W, const Pools& pl, int* out_keys,
             int* out_vals, cudaStream_t s) {
#define URUV_RANGE(g)                                                      \
  launch<g, VEC>(lids, pvalid, k1, k2, snap_ts, n_rows, window, W, pl,     \
                 out_keys, out_vals, s)
  switch (G) {
    case 1: return URUV_RANGE(1);
    case 2: return URUV_RANGE(2);
    case 4: return URUV_RANGE(4);
    case 8: return URUV_RANGE(8);
    case 16: return URUV_RANGE(16);
    default: return URUV_RANGE(32);
  }
#undef URUV_RANGE
}

}  // namespace

// lids, pvalid [n_query, window]; k1, k2, snap_ts [n_query]; leaf pools
// [n_leaf, width] and [n_leaf]; version pools [n_ver]; outputs
// [n_query, window * width].  vec is 4 (16-byte loads and stores) or 1.
// Every product of sizes must fit in 31 bits.
extern "C" int uruv_range_scan(const int* lids, const unsigned char* pvalid,
                               const int* k1, const int* k2,
                               const int* snap_ts, int n_query, int window,
                               const int* leaf_keys, const int* leaf_vhead,
                               const int* leaf_count, int n_leaf, int width,
                               int vec, const int* ver_ts,
                               const int* ver_next, const int* ver_value,
                               int n_ver, int max_chain, int* out_keys,
                               int* out_vals, void* stream) {
  const long long n_rows = static_cast<long long>(n_query) * window;
  const long long lanes = static_cast<long long>(width < 32 ? 32 : width);
  if (n_query < 1 || window < 1 || width < 1 || n_leaf < 1 || n_ver < 1 ||
      max_chain < 0 || (vec != 1 && vec != 4) || width % vec != 0 ||
      n_rows * lanes >= (1LL << 31) ||
      static_cast<long long>(n_leaf) * width >= (1LL << 31) ||
      (vec == 4 && (misaligned(leaf_keys) || misaligned(leaf_vhead) ||
                    misaligned(out_keys) || misaligned(out_vals))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Pools pl = {leaf_keys, leaf_vhead, leaf_count, ver_ts, ver_next,
                    ver_value, n_leaf, n_ver, max_chain};
  const int G = group_for(width / vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return dispatch<4>(G, lids, pvalid, k1, k2, snap_ts,
                       static_cast<int>(n_rows), window, width, pl, out_keys,
                       out_vals, s);
  return dispatch<1>(G, lids, pvalid, k1, k2, snap_ts,
                     static_cast<int>(n_rows), window, width, pl, out_keys,
                     out_vals, s);
}

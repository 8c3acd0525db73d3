// Uruv locate kernels for Hopper: the multi-level fat-node descent, the
// in-leaf rank (on gathered rows, or in place on the leaf pool) and the
// flat-directory rank (splitters staged in shared memory, then one
// window).
//
// index_descend replaces the Pallas TPU kernel index_descend
// (src/repro/kernels/uruv_search/uruv_search.py).  The TPU version pins
// every index level in VMEM and descends a tile of queries with
// vectorised row gathers.  Here what bounds the descent is latency: D
// dependent row reads per query, a few hundred bytes in all.  So:
//   * a group of G lanes takes one query; lane g reads chunk g of the
//     node's key row AND chunk g of its child row in the same step (16
//     bytes each at F = 16, G = 4: 8 queries per warp), so a level costs
//     one round trip, not two;
//   * the live-key count #(k <= q, k < KEY_MAX) is summed by xor shuffles
//     inside the group, and the child at max(count - 1, 0) comes by a
//     shuffle from the lane that loaded it;
//   * P = 4096 queries x 4 lanes fill 128 blocks of 128 threads;
//   * the next level's key and child pointers and capacity (indexed
//     reads of the kernel's parameters, independent of the query) are
//     read while this level's rows are in flight, so they do not add to
//     the chain of dependent reads (5-9 % off the plain loop at the main
//     store's shape).  Unrolling the loop over kMaxDepth measured 47 %
//     slower than the plain loop, and templating it on the depth no
//     faster than this (PERF.md keeps the readings);
//   * no level is staged in shared memory: at the main store's shape
//     (depth 6, warm L2) staging the top 3 or 4 levels with cp.async
//     measured slower than reading them from L2, since the staging
//     barrier keeps the root row's load (its address does not depend on
//     the query) from overlapping the query's load.
// VEC = 4 (16-byte loads) needs F % 4 == 0 and every level 16-byte
// aligned; otherwise the wrapper picks VEC = 1 (4-byte loads), the same
// kernel.  G = min(32, pow2ceil(F / VEC)); when a row has more chunks
// than the group has lanes, the lanes loop over the chunks and the child
// is read after the count (a second round trip).
//
// leaf_slots replaces the Pallas TPU kernel leaf_slots (same file), which
// takes leaf rows that XLA gathered for it (a TPU kernel cannot gather a
// row by a data-dependent index).  Here one template serves two entries:
// on gathered rows [P, L] (the TPU kernel's signature), and in place on
// the leaf pool, where query i loads row jax_index(leaf_id[i], ML) itself
// and also returns that row's version head at the hit, -1 where the key
// is absent (the JAX package's backend.locate with its two gathers
// folded in).  A group of G = L / 4 lanes reads the row as 16-byte
// vectors (two queries per warp at L = 64), and the in-place entry reads
// the same chunk of the version-head row in the same step; the rank
// #(row < q) is summed by shuffles over all L entries (unsorted rows
// too), and the hit key and version head come by a shuffle from the lane
// holding column min(slot, L - 1).  It is bound by latency too: the
// leaf id, then one round trip for both rows.
//
// The in-place entry also takes a snapshot per query (or one for all)
// and the version pools: the lane that writes the result walks the hit's
// version chain from the head it already holds (uruv::resolve_chain: ts,
// next and value of a hop loaded together) and writes a fourth output,
// the value at that snapshot (NOT_FOUND where the key is absent).  It
// replaces the versioned_read launch that followed every lookup's locate
// (src/repro/kernels/versioned_read/versioned_read.py), and its inputs:
// no vhead masking, no [P] copy of the snapshot.  A lookup is then the
// descent and this one launch; a chain of h hops adds h + 1 round trips
// after the leaf row's.
//
// In both kernels, lanes past P follow the last query and write nothing,
// so every lane of a warp takes part in every shuffle.
//
// search_positions replaces the Pallas TPU kernel search_positions (same
// file), which counts #(dir <= q) by comparing every query with every
// directory tile in VMEM.  Here the directory (512 KiB at ML = 131,072)
// sits in L2, and a one-thread binary search is a chain of log2(ML)
// dependent L2 round trips (17 at ML = 131,072).  What bounds the rank is
// that chain's length, not bytes, so the search takes two round trips:
//   * a block of 32 warps stages K <= 1024 splitters dir[0], dir[S],
//     dir[2S], ... in shared memory, one independent load a thread, in
//     flight with the queries' loads (the whole directory, S = 1, when
//     it fits);
//   * each warp takes one query: two 32-way ballot steps over the shared
//     splitters give the last one <= q (the splitters are sorted, so a
//     ballot is a prefix of lanes), none when q < dir[0];
//   * the warp reads that splitter's window of S entries, S / 128
//     16-byte loads a lane all in flight at once, and sums the entries
//     <= q with __reduce_add_sync.  Runs of equal keys (the KEY_MAX
//     padding) need nothing more: a splitter past the last entry <= q is
//     > q, so no entry after its window's start counts.
// A block fetches about K + S cache lines: one per staged splitter, S / 32
// for each of its 32 windows.  So the C entry takes the power-of-two
// multiple S of 128 with K <= 1024 and K + S least: S = 256, K = 512 at
// ML = 131,072 (768 lines; S = 128 and S = 512 measured slower), S = 128,
// K = 176 at the 22,430-leaf directory.  A directory off a 16-byte
// boundary takes the 4-byte variant (VEC = 1), the same kernel.  The count
// is exact for every n_dir and query, KEY_MAX included; the directory must
// be sorted, as the reference's searchsorted needs it to be.
#include <cuda_runtime.h>
#include <stdint.h>

#include "uruv_common.cuh"

namespace {

constexpr int kMaxDepth = 32;
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// The version pools and snapshots of the in-place entry's chain walk;
// snap[i * snap_stride] is query i's snapshot (stride 0: one for all).
struct Versions {
  const int* ts;
  const int* next;
  const int* value;
  const int* snap;
  int snap_stride;
  int n;
  int max_chain;
};

struct Levels {
  const int* keys[kMaxDepth];   // level l: [cap[l], F], l = 0 is the bottom
  const int* child[kMaxDepth];  // level l: [cap[l], F]; l = 0 holds leaf ids
  int cap[kMaxDepth];
};

// VEC consecutive ints at p (16-byte aligned when VEC == 4), by the
// read-only path
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

// v[e] without indexing the array by a register (that would spill it)
template <int VEC>
__device__ __forceinline__ int pick(const int (&v)[VEC], int e) {
  int x = v[0];
#pragma unroll
  for (int k = 1; k < VEC; ++k) x = e == k ? v[k] : x;
  return x;
}

template <int G>
__device__ __forceinline__ int group_sum(int x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o, G);
  return x;
}

// One level for the query q held by a group of G lanes (this is lane g):
// returns the child id at slot = max(#(k <= q, k < KEY_MAX) - 1, 0) of
// the node row at `keys` / `child` (F ints each, F % VEC == 0).
template <int G, int VEC>
__device__ __forceinline__ int descend_level(const int* keys,
                                             const int* child, int F, int q,
                                             int g, int& slot) {
  const int nch = F / VEC;
  const bool fused = nch <= G;  // one chunk per lane: child rides along
  int cv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) cv[e] = 0;
  int cnt = 0;
  for (int c = g; c < nch; c += G) {
    int kv[VEC];
    load_chunk<VEC>(keys + c * VEC, kv);
    if (fused) load_chunk<VEC>(child + c * VEC, cv);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      cnt += (kv[e] <= q) & (kv[e] < uruv::kKeyMax);  // KEY_MAX is padding
  }
  cnt = group_sum<G>(cnt);
  slot = cnt > 0 ? cnt - 1 : 0;
  if (fused)
    return __shfl_sync(kFull, pick<VEC>(cv, slot % VEC), slot / VEC, G);
  return __ldg(child + slot);
}

template <int G, int VEC>
__global__ void __launch_bounds__(kThreads)
    index_descend_kernel(Levels lv, int depth, int F,
                         const int* __restrict__ queries, int n,
                         int* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int g = threadIdx.x % G;
  const bool live = t / G < n;
  const int i = live ? static_cast<int>(t / G) : n - 1;
  const int q = __ldg(queries + i);

  int cur = 0;  // the root is node 0 of the top level
  int slot = 0;
  int nxt = 0;
  const int* kp = lv.keys[depth - 1];
  const int* cp = lv.child[depth - 1];
  int cap = lv.cap[depth - 1];
  for (int l = depth - 1; l >= 0; --l) {
    const long long row =
        static_cast<long long>(uruv::jax_index(cur, cap)) * F;
    const int* kr = kp + row;
    const int* cr = cp + row;
    // the next level's pointers do not depend on the query: read them
    // while this level's rows are in flight
    const int ln = l > 0 ? l - 1 : 0;
    kp = lv.keys[ln];
    cp = lv.child[ln];
    cap = lv.cap[ln];
    nxt = descend_level<G, VEC>(kr, cr, F, q, g, slot);
    if (l > 0) cur = nxt;
  }
  if (live && g == 0) {
    out[i] = cur;
    out[static_cast<long long>(n) + i] = slot;
    out[2LL * n + i] = nxt;
  }
}

// kAt: in place on the leaf pool, with the hit's chain walked; else the
// gathered rows, query i ranking row i
template <int G, int VEC, bool kAt>
__global__ void __launch_bounds__(kThreads)
    leaf_slots_kernel(const int* __restrict__ keys,
                      const int* __restrict__ vhead,
                      const int* __restrict__ ids, int n_rows, int W,
                      const int* __restrict__ queries, int n,
                      Versions ver, int* __restrict__ slot_out,
                      unsigned char* __restrict__ exists_out,
                      int* __restrict__ vhead_out,
                      int* __restrict__ val_out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int g = threadIdx.x % G;
  const bool live = t / G < n;
  const int i = live ? static_cast<int>(t / G) : n - 1;
  const int q = __ldg(queries + i);
  // read with the query, so the snapshot adds no round trip
  const int snap = kAt ? __ldg(ver.snap + i * ver.snap_stride) : 0;
  const long long row =
      static_cast<long long>(kAt ? uruv::jax_index(__ldg(ids + i), n_rows)
                                 : i) * W;
  const int* kr = keys + row;
  const int nch = W / VEC;
  const bool fused = nch <= G;
  int kv[VEC];
  int vv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) kv[e] = vv[e] = 0;
  int cnt = 0;
  for (int c = g; c < nch; c += G) {
    load_chunk<VEC>(kr + c * VEC, kv);
    if (kAt && fused) load_chunk<VEC>(vhead + row + c * VEC, vv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) cnt += kv[e] < q;
  }
  cnt = group_sum<G>(cnt);
  const int at = cnt < W ? cnt : W - 1;
  int hit;
  int vh = -1;
  if (fused) {
    hit = __shfl_sync(kFull, pick<VEC>(kv, at % VEC), at / VEC, G);
    if (kAt) vh = __shfl_sync(kFull, pick<VEC>(vv, at % VEC), at / VEC, G);
  } else {
    hit = __ldg(kr + at);
    if (kAt) vh = __ldg(vhead + row + at);
  }
  const bool exists = cnt < W && hit == q;
  if (live && g == 0) {
    slot_out[i] = cnt;
    exists_out[i] = exists;
    if (kAt) {
      vh = exists ? vh : -1;
      vhead_out[i] = vh;
      val_out[i] = uruv::resolve_chain(vh, snap, ver.ts, ver.next, ver.value,
                                       ver.n, ver.max_chain);
    }
  }
}

// search_positions: kSpThreads / 32 queries a block, one warp each.
constexpr int kSpThreads = 1024;
constexpr int kSpMax = 1024;    // splitters a block stages: K <= kSpMax
constexpr int kSpWindow = 128;  // the least window: 32 lanes x 16 bytes

// the shared-memory slot of splitter k: a pad word after every 32, so the
// first search step (lane l reads splitter 32 l) hits 32 banks
__device__ __forceinline__ int sp_slot(int k) { return k + (k >> 5); }

// #(dir[k] <= q) for k in [lo, hi), summed over the warp (lo a multiple
// of VEC, dir 16-byte aligned when VEC == 4).  A pass reads NC chunks of
// VEC ints a lane, all in flight together; a window of at most
// 32 NC VEC entries takes one pass, one round trip.  Only the
// directory's last chunk can be partial.
template <int VEC, int NC>
__device__ __forceinline__ int window_count(const int* __restrict__ dir,
                                            long long lo, long long hi,
                                            int q, int lane) {
  int cnt = 0;
  for (long long pass = lo; pass < hi; pass += 32LL * VEC * NC) {
    int v[NC][VEC];
    int live[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const long long b = pass + static_cast<long long>(c * 32 + lane) * VEC;
      live[c] = b + VEC <= hi ? VEC : (b < hi ? static_cast<int>(hi - b) : 0);
      if (live[c] == VEC) {
        load_chunk<VEC>(dir + b, v[c]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          v[c][e] = e < live[c] ? __ldg(dir + b + e) : 0;
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) cnt += (e < live[c]) & (v[c][e] <= q);
  }
  return __reduce_add_sync(kFull, cnt);
}

// Splitter k is dir[k * S], k < K = ceil(n_dir / S).  The block stages
// them in shared memory (one load a thread, in flight with the queries),
// each warp finds its query's last splitter j <= q in two 32-way ballot
// steps (K <= 1024), and counts the window [j S, min((j + 1) S, n_dir))
// in one round trip when S <= 32 NC VEC.  S == 1 stages the whole
// directory: no window.
template <int VEC, int NC>
__global__ void __launch_bounds__(kSpThreads)
    search_positions_kernel(const int* __restrict__ dir, int n_dir, int S,
                            int K, const int* __restrict__ queries, int n,
                            int* __restrict__ pos) {
  __shared__ int sp[kSpMax + kSpMax / 32];
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * (kSpThreads / 32) + threadIdx.x / 32;
  const bool live = i < n;
  const int q = __ldg(queries + (live ? i : n - 1));
  if (threadIdx.x < K)
    sp[sp_slot(threadIdx.x)] =
        __ldg(dir + static_cast<long long>(threadIdx.x) * S);
  __syncthreads();
  // the splitters form a sorted run, so each ballot is a prefix of lanes
  const unsigned top = __ballot_sync(
      kFull, lane * 32 < K && sp[sp_slot(lane * 32)] <= q);
  int count = 0;  // q below dir[0] (or no directory): 0
  if (top != 0) {
    const int j1 = __popc(top) - 1;
    const int k = j1 * 32 + lane;
    const int j = j1 * 32 - 1 +
                  __popc(__ballot_sync(kFull, k < K && sp[sp_slot(k)] <= q));
    // every entry before splitter j is <= q; every entry from splitter
    // j + 1 on is > q
    const long long lo = static_cast<long long>(j) * S;
    const long long hi = lo + S < n_dir ? lo + S : n_dir;
    count = static_cast<int>(
        S == 1 ? lo + 1 : lo + window_count<VEC, NC>(dir, lo, hi, q, lane));
  }
  if (live && lane == 0) pos[i] = count > 0 ? count - 1 : 0;
}

template <int VEC>
int launch_search(int NC, const int* dir, int n_dir, int S, int K,
                  const int* queries, int n, int* pos, cudaStream_t s) {
  const unsigned blocks = uruv::blocks_for(n, kSpThreads / 32);
  switch (NC) {
    case 1:
      search_positions_kernel<VEC, 1>
          <<<blocks, kSpThreads, 0, s>>>(dir, n_dir, S, K, queries, n, pos);
      break;
    case 2:
      search_positions_kernel<VEC, 2>
          <<<blocks, kSpThreads, 0, s>>>(dir, n_dir, S, K, queries, n, pos);
      break;
    default:
      search_positions_kernel<VEC, 4>
          <<<blocks, kSpThreads, 0, s>>>(dir, n_dir, S, K, queries, n, pos);
  }
  return static_cast<int>(cudaGetLastError());
}

// lanes per query: the power of two covering a row's chunks, at most 32
int group_for(int chunks) {
  int g = 1;
  while (g < chunks && g < 32) g <<= 1;
  return g;
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

template <int G, int VEC>
int launch_descend(const Levels& lv, int depth, int F, const int* queries,
                   int n, int* out, cudaStream_t s) {
  index_descend_kernel<G, VEC>
      <<<uruv::blocks_for(static_cast<long long>(n) * G, kThreads), kThreads,
         0, s>>>(lv, depth, F, queries, n, out);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int dispatch_descend(int G, const Levels& lv, int depth, int F,
                     const int* queries, int n, int* out, cudaStream_t s) {
  switch (G) {
    case 1: return launch_descend<1, VEC>(lv, depth, F, queries, n, out, s);
    case 2: return launch_descend<2, VEC>(lv, depth, F, queries, n, out, s);
    case 4: return launch_descend<4, VEC>(lv, depth, F, queries, n, out, s);
    case 8: return launch_descend<8, VEC>(lv, depth, F, queries, n, out, s);
    case 16: return launch_descend<16, VEC>(lv, depth, F, queries, n, out, s);
    default: return launch_descend<32, VEC>(lv, depth, F, queries, n, out, s);
  }
}

template <int G, int VEC, bool kAt>
int launch_slots(const int* keys, const int* vhead, const int* ids,
                 int n_rows, int W, const int* queries, int n,
                 const Versions& ver, int* slot, unsigned char* exists,
                 int* vhead_out, int* val_out, cudaStream_t s) {
  leaf_slots_kernel<G, VEC, kAt>
      <<<uruv::blocks_for(static_cast<long long>(n) * G, kThreads), kThreads,
         0, s>>>(keys, vhead, ids, n_rows, W, queries, n, ver, slot, exists,
                 vhead_out, val_out);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, bool kAt>
int dispatch_slots(int G, const int* keys, const int* vhead, const int* ids,
                   int n_rows, int W, const int* queries, int n,
                   const Versions& ver, int* slot, unsigned char* exists,
                   int* vhead_out, int* val_out, cudaStream_t s) {
#define URUV_SLOTS(g)                                                      \
  launch_slots<g, VEC, kAt>(keys, vhead, ids, n_rows, W, queries, n, ver, \
                            slot, exists, vhead_out, val_out, s)
  switch (G) {
    case 1: return URUV_SLOTS(1);
    case 2: return URUV_SLOTS(2);
    case 4: return URUV_SLOTS(4);
    case 8: return URUV_SLOTS(8);
    case 16: return URUV_SLOTS(16);
    default: return URUV_SLOTS(32);
  }
#undef URUV_SLOTS
}

template <bool kAt>
int slots_entry(const int* keys, const int* vhead, const int* ids,
                int n_rows, int width, int vec, const int* queries, int n,
                const Versions& ver, int* slot_out,
                unsigned char* exists_out, int* vhead_out, int* val_out,
                void* stream) {
  if (width < 1 || n < 1 || (vec != 1 && vec != 4) || width % vec != 0 ||
      (vec == 4 && (misaligned(keys) || (kAt && misaligned(vhead)))) ||
      (kAt && (vhead == nullptr || vhead_out == nullptr || n_rows < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = group_for(width / vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return dispatch_slots<4, kAt>(G, keys, vhead, ids, n_rows, width, queries,
                                  n, ver, slot_out, exists_out, vhead_out,
                                  val_out, s);
  return dispatch_slots<1, kAt>(G, keys, vhead, ids, n_rows, width, queries, n,
                                ver, slot_out, exists_out, vhead_out, val_out,
                                s);
}

}  // namespace

// pos[i] = max(#(dir <= queries[i]) - 1, 0) over the sorted directory
// dir [n_dir].  vec 4 takes 16-byte window loads (dir 16-byte aligned),
// vec 1 4-byte ones.  The splitter stride S and count K follow from
// n_dir: the whole directory (S = 1) when it fits in kSpMax; else the
// power-of-two multiple S of kSpWindow with K <= kSpMax and K + S least
// (the smaller S on a tie).  A block fetches about K + S cache lines (K
// splitters, 32 windows of S / 32 lines), so K + S is the cost.
extern "C" int uruv_search_positions(const int* dir, int n_dir, int vec,
                                     const int* queries, int n, int* pos,
                                     void* stream) {
  if (n_dir < 0 || n < 1 || (vec != 1 && vec != 4) ||
      (vec == 4 && misaligned(dir)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto splitters = [n_dir](long long S) {
    return (n_dir + S - 1) / S;
  };
  long long S = 1;
  if (n_dir > kSpMax) {
    S = kSpWindow;
    while (splitters(S) > kSpMax ||
           splitters(2 * S) + 2 * S < splitters(S) + S)
      S *= 2;
  }
  const int K = static_cast<int>(splitters(S));
  // chunks a lane reads in one pass over the window: S / (32 vec), at
  // most 4 (the 4-byte variant past S = 128 takes more passes)
  const long long chunks = S / (32 * vec);
  const int NC = chunks >= 4 ? 4 : (chunks >= 2 ? 2 : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return launch_search<4>(NC, dir, n_dir, static_cast<int>(S), K, queries,
                            n, pos, s);
  return launch_search<1>(NC, dir, n_dir, static_cast<int>(S), K, queries, n,
                          pos, s);
}

// levels: depth key-level pointers, depth child-level pointers, depth
// capacities (level 0, the bottom, first in each run).  out is [3, n]:
// bottom node, bottom slot, leaf id.
extern "C" int uruv_index_descend(const long long* levels, int depth,
                                  int fanout, int vec, const int* queries,
                                  int n, int* out, void* stream) {
  if (depth < 1 || depth > kMaxDepth || fanout < 1 ||
      (vec != 1 && vec != 4) || fanout % vec != 0 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  for (int l = 0; l < depth; ++l) {
    lv.keys[l] = reinterpret_cast<const int*>(levels[l]);
    lv.child[l] = reinterpret_cast<const int*>(levels[depth + l]);
    lv.cap[l] = static_cast<int>(levels[2 * depth + l]);
    if (lv.cap[l] < 1 ||
        (vec == 4 && (misaligned(lv.keys[l]) || misaligned(lv.child[l]))))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = group_for(fanout / vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return dispatch_descend<4>(G, lv, depth, fanout, queries, n, out, s);
  return dispatch_descend<1>(G, lv, depth, fanout, queries, n, out, s);
}

// The in-leaf rank on gathered rows: keys is [n, width], and query i
// ranks row i.
extern "C" int uruv_leaf_slots(const int* keys, int width, int vec,
                               const int* queries, int n, int* slot_out,
                               unsigned char* exists_out, void* stream) {
  return slots_entry<false>(keys, nullptr, nullptr, 0, width, vec, queries,
                            n, Versions{}, slot_out, exists_out, nullptr,
                            nullptr, stream);
}

// The in-leaf rank in place, with the hit's chain walked in the same
// launch: keys and vhead are the leaf pool [n_rows, width], query i ranks
// row jax_index(ids[i], n_rows), vhead_out gets its version head at the
// hit (-1 where the key is absent), and val_out[i] the value at
// snap[i * snap_stride] (snap_stride 0 or 1) along the chain from that
// head through the pools [n_ver], at most max_chain steps.
extern "C" int uruv_leaf_slots_read(
    const int* keys, const int* vhead, const int* ids, int n_rows,
    int width, int vec, const int* queries, int n, const int* snap,
    int snap_stride, const int* ver_ts, const int* ver_next,
    const int* ver_value, int n_ver, int max_chain, int* slot_out,
    unsigned char* exists_out, int* vhead_out, int* val_out, void* stream) {
  if (ids == nullptr || snap == nullptr || val_out == nullptr ||
      n_ver < 1 || max_chain < 0 || (snap_stride != 0 && snap_stride != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Versions ver = {ver_ts, ver_next, ver_value, snap, snap_stride,
                        n_ver, max_chain};
  return slots_entry<true>(keys, vhead, ids, n_rows, width, vec, queries, n,
                           ver, slot_out, exists_out, vhead_out, val_out,
                           stream);
}

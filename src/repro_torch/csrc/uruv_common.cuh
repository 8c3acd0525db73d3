// Shared definitions of the Uruv CUDA kernels (sm_90a).
//
// The sentinels match repro_torch/core/ref.py.  Gathers follow the JAX
// reference's index semantics exactly: a negative index wraps once by
// the table size, then the index is clamped into the table.  On a valid
// store every index is already in range, so this costs two integer ops
// and never changes an answer; on the random pools of the parity tests
// it keeps the kernels bit-equal to their plain twins.
#pragma once

#include <cuda_runtime.h>

namespace uruv {

constexpr int kKeyMax = 0x7fffffff;
constexpr int kTombstone = -0x7fffffff;  // -(2**31) + 1
constexpr int kNotFound = -1;

__device__ __forceinline__ int jax_index(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ int visible(int v) {
  return v == kTombstone ? kNotFound : v;
}

// N version chains at one snapshot: out[e] is the value of the first
// version with ts <= snap along the chain from cur[e], walking at most
// `max_chain` steps; NOT_FOUND when no such version is reached or it is
// a tombstone.  (The TPU kernel's fixed unroll stops changing once a step
// does not advance, so stopping there is the same function; the bound
// stays exact because random chains may cycle.)
//
// What bounds a walk is the latency of dependent loads, so each hop
// issues the loads of ts, next AND value of every live chain together and
// decides after they land: a chain that advances h times costs h + 1
// round trips (about 2h + 2 when next or value waits on ts), and the N
// chains of one thread overlap.  Only a chain still newer than the
// snapshot after max_chain steps pays one more read of ts and value.
template <int N>
__device__ __forceinline__ void resolve_chains(
    const int (&head)[N], int snap, const int* __restrict__ ver_ts,
    const int* __restrict__ ver_next, const int* __restrict__ ver_value,
    int n_ver, int max_chain, int (&out)[N]) {
  int cur[N];
  bool live[N];
  bool any = false;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    cur[e] = head[e];
    live[e] = head[e] >= 0;
    out[e] = kNotFound;
    any |= live[e];
  }
  for (int s = 0; s < max_chain && any; ++s) {
    int ts[N], nx[N], v[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (live[e]) {
        const int c = cur[e] < n_ver ? cur[e] : n_ver - 1;
        ts[e] = __ldg(ver_ts + c);
        nx[e] = __ldg(ver_next + c);
        v[e] = __ldg(ver_value + c);
      }
    }
    any = false;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (live[e]) {
        if (ts[e] <= snap) {
          out[e] = visible(v[e]);
          live[e] = false;
        } else {
          cur[e] = nx[e];
          live[e] = nx[e] >= 0;
        }
      }
      any |= live[e];
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (live[e]) {  // max_chain steps, all newer: the unroll's last read
      const int c = cur[e] < n_ver ? cur[e] : n_ver - 1;
      const int ts = __ldg(ver_ts + c);
      const int v = __ldg(ver_value + c);
      out[e] = ts <= snap ? visible(v) : kNotFound;
    }
  }
}

__device__ __forceinline__ int resolve_chain(
    int head, int snap, const int* __restrict__ ver_ts,
    const int* __restrict__ ver_next, const int* __restrict__ ver_value,
    int n_ver, int max_chain) {
  const int h[1] = {head};
  int out[1];
  resolve_chains<1>(h, snap, ver_ts, ver_next, ver_value, n_ver, max_chain,
                    out);
  return out[0];
}

inline unsigned int blocks_for(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace uruv

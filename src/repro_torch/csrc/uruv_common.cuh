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

// First version with ts <= snap along the chain from `cur`, walking at
// most `max_chain` steps (the TPU kernel's fixed unroll stops changing
// once a step does not advance, so stopping there is the same function;
// the bound stays exact because random chains may cycle).  NOT_FOUND when
// no such version is reached or it is a tombstone.
__device__ __forceinline__ int resolve_chain(
    int cur, int snap, const int* __restrict__ ver_ts,
    const int* __restrict__ ver_next, const int* __restrict__ ver_value,
    int n_ver, int max_chain) {
  for (int s = 0; s < max_chain; ++s) {
    if (cur < 0) break;
    const int c = cur < n_ver ? cur : n_ver - 1;
    if (__ldg(ver_ts + c) <= snap) break;
    cur = __ldg(ver_next + c);
  }
  if (cur < 0) return kNotFound;
  const int c = cur < n_ver ? cur : n_ver - 1;
  if (__ldg(ver_ts + c) > snap) return kNotFound;
  const int v = __ldg(ver_value + c);
  return v == kTombstone ? kNotFound : v;
}

inline unsigned int blocks_for(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace uruv

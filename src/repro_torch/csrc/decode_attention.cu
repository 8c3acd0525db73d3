// Decode attention for Hopper: one new token per sequence against a KV
// cache with per-sequence lengths, plus the softmax stats (m, l).
//
// Replaces the Pallas TPU kernel decode_attention
// (src/repro/kernels/decode_attention/decode_attention.py:86, its
// pallas_call at :108).  The TPU grid walks (b, kv head, kv tile) in order
// with the G = H / KVH query heads of one kv head resident in VMEM and
// (m, l, acc) carried in scratch across the kv axis.
//
// Bound: decode streams the cache once, 2·len·KVH·D elements per sequence,
// for ~4·len·H·D flops: about 4·G flops per cache element, far below the
// ~295 flops per byte at which the H100's bf16 tensor cores, not HBM, would
// bound it.  So the design stays on the CUDA cores and moves bytes well:
//
//   - Split-KV.  The grid is (n_splits, KVH, B): a block takes one chunk
//     of `chunk` cache rows of one (b, kv head) and scores each row it
//     reads against all G query heads of that kv head, so every K/V row
//     is read once.  The wrapper derives n_splits and chunk from the
//     shapes alone (S, B·KVH) so that the grid holds about two blocks per
//     SM (8 splits of 64 rows at B = 4, KVH = 8, S = 512: 256 blocks); it
//     never reads `lengths` on the host.  A block whose chunk starts at or
//     past lengths[b] writes m = NEG_INF, l = 0 and exits.
//   - Loads.  A chunk is walked in tiles of kTR = 32 rows, copied into
//     shared memory by 16-byte cp.async (plain loads when a row is not a
//     whole number of 16-byte pieces), double-buffered so tile t + 1
//     loads while tile t is scored.  Tile rows are padded by 16 bytes so
//     the 16-byte reads of 8 neighbouring rows fall in distinct banks.
//   - Compute.  Scores: one (head, row) pair per thread and step, 16-byte
//     shared reads of the row against the fp32 query.  Softmax: one warp
//     per head, online across tiles.  P V: one pair of head dims of one
//     head per thread, the probabilities broadcast from shared memory.
//   - Combine.  With more than one split, each split writes its (m, l,
//     acc) partials to fp32 scratch the wrapper allocates, and a second
//     launch from the same C entry, one block per (b, q head), writes
//     m = max m_i, l = sum l_i·e^{m_i - m} and out = sum acc_i·e^{m_i - m}
//     / (l or 1); splits with l_i = 0 (empty) are left out.  With one
//     split the first kernel writes the result itself.
//
//   - Sliding window.  With a `starts` array (gemma3's local layers) a
//     sequence attends to rows [starts[b], lengths[b]) only.  The kernel
//     reads starts[b] on the card, as it reads lengths[b]: a block's rows
//     are its chunk cut to that interval, so a split wholly below the
//     window takes the empty-chunk exit and loads nothing, and the first
//     live tile simply starts at starts[b] (rows are staged one by one, so
//     an unaligned start needs no mask).  The window is a template
//     variant (kWindow): without `starts` the kernel is the code it was.
//
// Edge conventions follow the TPU kernel: masked scores are NEG_INF =
// -1e30, masked probabilities 0, a sequence with no row (length 0, or a
// window start at or past its length) writes 0 with m = NEG_INF and l = 0
// (also when every split is empty), a length past S counts as S and a
// negative start as 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 32;               // cache rows per tile (one per lane)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// q (fp32, scaled) . row over dims [0, n), n a multiple of 8 / 4 elements,
// 16 bytes at a time
__device__ __forceinline__ float dot16(const float* qs,
                                       const __nv_bfloat16* row, int n) {
  float a0 = 0.f, a1 = 0.f;
  for (int d = 0; d < n; d += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + d);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 x = *reinterpret_cast<const float4*>(qs + d);
    const float4 y = *reinterpret_cast<const float4*>(qs + d + 4);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
    a0 = fmaf(x.x, f0.x, a0);
    a1 = fmaf(x.y, f0.y, a1);
    a0 = fmaf(x.z, f1.x, a0);
    a1 = fmaf(x.w, f1.y, a1);
    a0 = fmaf(y.x, f2.x, a0);
    a1 = fmaf(y.y, f2.y, a1);
    a0 = fmaf(y.z, f3.x, a0);
    a1 = fmaf(y.w, f3.y, a1);
  }
  return a0 + a1;
}
__device__ __forceinline__ float dot16(const float* qs, const float* row,
                                       int n) {
  float a0 = 0.f, a1 = 0.f;
  for (int d = 0; d < n; d += 8) {
    const float4 r0 = *reinterpret_cast<const float4*>(row + d);
    const float4 x0 = *reinterpret_cast<const float4*>(qs + d);
    a0 = fmaf(x0.x, r0.x, a0);
    a1 = fmaf(x0.y, r0.y, a1);
    a0 = fmaf(x0.z, r0.z, a0);
    a1 = fmaf(x0.w, r0.w, a1);
    if (d + 4 < n) {
      const float4 r1 = *reinterpret_cast<const float4*>(row + d + 4);
      const float4 x1 = *reinterpret_cast<const float4*>(qs + d + 4);
      a0 = fmaf(x1.x, r1.x, a0);
      a1 = fmaf(x1.y, r1.y, a1);
      a0 = fmaf(x1.z, r1.z, a0);
      a1 = fmaf(x1.w, r1.w, a1);
    }
  }
  return a0 + a1;
}

__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Stage cache rows [r0, r0 + rows) of one (b, kv head) into a [kTR][ld]
// tile (columns < D).  With `async` a thread copies one 16-byte piece of
// every (kThreads / pieces per row)-th row.
template <typename T>
__device__ __forceinline__ void stage(T* tile, const T* src, int r0,
                                      int rows, int D, int ld, bool async) {
  const int tid = threadIdx.x;
  if (async) {
    constexpr int kVec = 16 / sizeof(T);
    const int cpr = D / kVec, step = kThreads / cpr;
    const int j = (tid % cpr) * kVec;
    if (tid >= step * cpr) return;
    for (int r = tid / cpr; r < rows; r += step)
      cp_async16(tile + r * ld + j,
                 src + static_cast<size_t>(r0 + r) * D + j);
  } else {
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      tile[r * ld + d] = src[static_cast<size_t>(r0 + r) * D + d];
    }
  }
}

// Shared memory: K and V tiles [2][kTR][ld] each in T, then fp32 q [G][Dp],
// acc [G][Dp], scores / probabilities [G][kTR], and m, l, alpha [G] each.
// Dp = D rounded up to 16 bytes of T; ld = Dp + 16 bytes of T.
template <typename T>
size_t smem_bytes(int G, int Dp) {
  const int ld = Dp + 16 / static_cast<int>(sizeof(T));
  return sizeof(T) * 4 * kTR * ld +
         sizeof(float) * (2 * G * Dp + G * kTR + 3 * G);
}

template <typename T, bool kWindow>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ lengths,
             const int* __restrict__ starts, T* __restrict__ out,
             float* __restrict__ m_out, float* __restrict__ l_out,
             float* __restrict__ part, int H,
             int KVH, int S, int D, int chunk, int async, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  const int G = H / KVH;
  const int Dp = (D + kVec - 1) / kVec * kVec;
  const int ld = Dp + kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);        // [2][kTR][ld]
  T* sv = sk + 2 * kTR * ld;                     // [2][kTR][ld]
  float* sq = reinterpret_cast<float*>(sv + 2 * kTR * ld);  // [G][Dp]
  float* sacc = sq + G * Dp;                     // [G][Dp]
  float* ss = sacc + G * Dp;                     // [G][kTR]
  float* sm = ss + G * kTR;                      // [G]
  float* sl = sm + G;                            // [G]
  float* sa = sl + G;                            // [G]

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x, B = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), S);
  // rows of this split: its chunk, cut to [starts[b], len)
  const int c0 = split * chunk;
  const int r_begin = kWindow ? max(c0, starts[b]) : c0;
  const int r_end = min(c0 + chunk, len);
  const size_t bh0 = static_cast<size_t>(b) * H + kh * G;  // first q head
  // partials: acc [B*H][n_splits][D], then m and l [B*H][n_splits]
  float* pacc = part;
  float* pm = part + static_cast<size_t>(B) * H * n_splits * D;
  float* pl = pm + static_cast<size_t>(B) * H * n_splits;

  if (r_begin >= r_end) {  // nothing of this sequence in this chunk
    if (n_splits == 1) {
      for (int i = tid; i < G * D; i += kThreads)
        out[bh0 * D + i] = from_f<T>(0.f);
      for (int g = tid; g < G; g += kThreads) {
        m_out[bh0 + g] = kNegInf;
        l_out[bh0 + g] = 0.f;
      }
    } else {
      for (int g = tid; g < G; g += kThreads) {
        pm[(bh0 + g) * n_splits + split] = kNegInf;
        pl[(bh0 + g) * n_splits + split] = 0.f;
      }
    }
    return;
  }

  const T* kb = k + (static_cast<size_t>(b) * KVH + kh) * S * D;
  const T* vb = v + (static_cast<size_t>(b) * KVH + kh) * S * D;
  const int n_tiles = (r_end - r_begin + kTR - 1) / kTR;
  stage(sk, kb, r_begin, min(kTR, r_end - r_begin), D, ld, async);
  stage(sv, vb, r_begin, min(kTR, r_end - r_begin), D, ld, async);
  cp_async_commit();

  for (int i = tid; i < G * Dp; i += kThreads) {
    const int g = i / Dp, d = i - g * Dp;
    sq[i] = d < D ? to_f(q[(bh0 + g) * D + d]) * scale : 0.f;
    sacc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    sm[g] = kNegInf;
    sl[g] = 0.f;
  }
  if (Dp > D) {  // pad columns the 16-byte reads see: zero once
    const int w = Dp - D;
    for (int i = tid; i < 4 * kTR * w; i += kThreads) {
      const int r = i / w;
      sk[r * ld + D + (i - r * w)] = from_f<T>(0.f);  // sk, sv contiguous
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = r_begin + t * kTR, nr = min(kTR, r_end - r0);
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      const int r1 = r0 + kTR, n1 = min(kTR, r_end - r1);
      stage(sk + (buf ^ 1) * kTR * ld, kb, r1, n1, D, ld, async);
      stage(sv + (buf ^ 1) * kTR * ld, vb, r1, n1, D, ld, async);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tk = sk + buf * kTR * ld;
    const T* tv = sv + buf * kTR * ld;

    // scores of every (head, row) pair of the tile
    for (int i = tid; i < G * kTR; i += kThreads) {
      const int g = i / kTR, r = i % kTR;
      ss[i] = r < nr ? dot16(sq + g * Dp, tk + r * ld, Dp) : kNegInf;
    }
    __syncthreads();
    // online softmax, one warp per head, one row per lane
    for (int g = warp; g < G; g += kWarps) {
      const bool ok = lane < nr;
      const float s = ss[g * kTR + lane];
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      ss[g * kTR + lane] = p;
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        sa[g] = a;
        sl[g] = sl[g] * a + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V, two head dims of one head per thread
    const int half = Dp >> 1;
    for (int i = tid; i < G * half; i += kThreads) {
      const int g = i / half, d = (i - g * half) << 1;
      const float* pg = ss + g * kTR;
      float a0 = 0.f, a1 = 0.f;
      for (int r = 0; r < nr; ++r) {
        const float p = pg[r];
        const float2 x = pair(tv + r * ld + d);
        a0 = fmaf(p, x.x, a0);
        a1 = fmaf(p, x.y, a1);
      }
      float* acc = sacc + g * Dp + d;
      const float al = sa[g];
      acc[0] = fmaf(acc[0], al, a0);
      acc[1] = fmaf(acc[1], al, a1);
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  if (n_splits == 1) {
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      const float l = sl[g];
      out[bh0 * D + i] = from_f<T>(sacc[g * Dp + d] / (l == 0.f ? 1.f : l));
    }
    for (int g = tid; g < G; g += kThreads) {
      m_out[bh0 + g] = sm[g];
      l_out[bh0 + g] = sl[g];
    }
  } else {
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      pacc[((bh0 + g) * n_splits + split) * D + d] = sacc[g * Dp + d];
    }
    for (int g = tid; g < G; g += kThreads) {
      pm[(bh0 + g) * n_splits + split] = sm[g];
      pl[(bh0 + g) * n_splits + split] = sl[g];
    }
  }
}

__device__ __forceinline__ float block_reduce(float x, float* red, bool mx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = mx ? warp_max(x) : warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float y = red[0];
  for (int w = 1; w < kWarps; ++w) y = mx ? fmaxf(y, red[w]) : y + red[w];
  __syncthreads();  // red is reused
  return y;
}

// One block per (b, q head): fold the n_splits partials into out, m, l.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part, T* __restrict__ out,
               float* __restrict__ m_out, float* __restrict__ l_out, int BH,
               int n_splits, int D) {
  extern __shared__ float sw[];        // [n_splits] weights e^{m_i - m}
  __shared__ float red[kWarps];
  const int bh = blockIdx.x, tid = threadIdx.x;
  const float* pacc = part + static_cast<size_t>(bh) * n_splits * D;
  const float* pm = part + static_cast<size_t>(BH) * n_splits * D +
                    static_cast<size_t>(bh) * n_splits;
  const float* pl = pm + static_cast<size_t>(BH) * n_splits;
  float mx = kNegInf;
  for (int s = tid; s < n_splits; s += kThreads) mx = fmaxf(mx, pm[s]);
  mx = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int s = tid; s < n_splits; s += kThreads) {
    const float ls = pl[s];
    const float w = ls > 0.f ? expf(pm[s] - mx) : 0.f;  // empty: left out
    sw[s] = w;
    sum += ls * w;
  }
  sum = block_reduce(sum, red, false);   // its barrier publishes sw
  const float div = sum == 0.f ? 1.f : sum;
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = sw[s];
      if (w != 0.f) o = fmaf(pacc[static_cast<size_t>(s) * D + d], w, o);
    }
    out[static_cast<size_t>(bh) * D + d] = from_f<T>(o / div);
  }
  if (tid == 0) {
    m_out[bh] = mx;
    l_out[bh] = sum;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           const int* starts, void* out, float* m, float* l, float* part,
           int B, int H, int KVH, int S, int D, int chunk, int n_splits,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int G = H / KVH;
  const int Dp = (D + kVec - 1) / kVec * kVec;
  const size_t smem = smem_bytes<T>(G, Dp);
  // the window only where it is asked for: the unwindowed kernel stays the
  // code it was without one
  auto kern = starts != nullptr ? split_kernel<T, true>
                                : split_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int async = D % kVec == 0 && aligned(k) && aligned(v);
  kern<<<dim3(n_splits, KVH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, starts, static_cast<T*>(out), m, l,
      part, H, KVH, S, D, chunk, async,
      1.0f / sqrtf(static_cast<float>(D)));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  combine_kernel<T><<<B * H, kThreads, sizeof(float) * n_splits, stream>>>(
      part, static_cast<T*>(out), m, l, B * H, n_splits, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  The
// wrapper picks chunk and n_splits (n_splits * chunk >= S) from the shapes
// and, when n_splits > 1, passes fp32 scratch of B*H*n_splits*(D + 2)
// floats as `part`.  starts: null (no window), or int32 [B], the first
// cache row each sequence attends to.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, const int* starts,
                                void* out, float* m, float* l, float* part,
                                int B, int H, int KVH, int S, int D,
                                int chunk, int n_splits, int dtype,
                                void* stream) {
  if (D < 1 || D > 256 || KVH < 1 || H % KVH != 0 || H / KVH > 32 ||
      chunk < 1 || n_splits < 1 || static_cast<long>(chunk) * n_splits < S ||
      (n_splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, starts, out, m, l, part, B, H,
                         KVH, S, D, chunk, n_splits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lengths, starts, out, m, l, part,
                                 B, H, KVH, S, D, chunk, n_splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

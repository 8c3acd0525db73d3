// Prefill attention for Hopper: causal / sliding-window GQA attention with
// an online softmax.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention/flash_attention.py).  The TPU grid
// walks (b, h, q tile, kv tile) in order and carries m, l and acc in VMEM
// scratch across the kv axis.  Here one block owns (b, h, a tile of
// kBQ = 16 query rows) and loops over kv tiles of kBK = 32 keys itself, so
// the carry lives in registers: each of the 4 warps owns 4 query rows, and
// a lane keeps m and l of each row (replicated across the warp) plus the
// accumulator of the head dims lane, lane + 32, ...  A kv tile is staged
// in shared memory as fp32 (k rows padded to D + 1 floats, so lane j
// reading key j's dims hits distinct banks); lane j scores key j, the
// warp reduces max and sum with shuffles, then broadcasts each key's
// probability to accumulate p @ v over the lane's dims.
//
// Tiles wholly beyond the causal frontier, below the window floor or past
// Skv are never loaded.  Edge conventions follow the TPU kernel exactly: a
// masked score is NEG_INF = -1e30, a masked probability is 0, and a row
// with l == 0 (no unmasked key) writes 0.
//
// Bound: at prefill widths (Sq = Skv of a few hundred, D = 64) the work is
// ~4·Sq·Skv·D flops per head against a few MB of q, k, v, so the tensor
// cores would bound it; this first version uses plain fp32 FMAs (no
// wgmma), so it runs far above that bound by design — correct first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 16;
constexpr int kBK = 32;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBQ / kWarps;
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

// DC = head-dim chunks of 32 a lane accumulates (D <= 32 * DC)
template <typename T, int DC>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int KVH,
             int Sq, int Skv, int D, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* sq = smem;                   // [kBQ][D]   scaled queries
  float* sk = sq + kBQ * D;           // [kBK][D+1] keys (padded rows)
  float* sv = sk + kBK * (D + 1);     // [kBK][D]   values
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int q0 = qt * kBQ;
  const T* qb = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * KVH + kh) * Skv * D;
  const T* vb = v + (static_cast<size_t>(b) * KVH + kh) * Skv * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, qi = q0 + r;
    sq[i] = qi < Sq ? to_f(qb[static_cast<size_t>(qi) * D + i % D]) * scale
                    : 0.f;
  }
  // kv tiles that can hold an unmasked key for some row of this q tile
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  kv_lo = (kv_lo / kBK) * kBK;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and sq written)
    for (int i = tid; i < kBK * D; i += blockDim.x) {
      const int r = i / D, d = i % D, ki = k0 + r;
      const size_t g = static_cast<size_t>(ki) * D + d;
      sk[r * (D + 1) + d] = ki < Skv ? to_f(kb[g]) : 0.f;
      sv[r * D + d] = ki < Skv ? to_f(vb[g]) : 0.f;
    }
    __syncthreads();
    const int ki = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr, qi = q0 + r;
      const float* qr = sq + r * D;
      const float* kr = sk + lane * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      bool ok = ki < Skv;
      if (causal) ok = ok && qi >= ki;
      if (window > 0) ok = ok && (qi - ki < window);
      s = ok ? s : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float alpha = expf(m[rr] - m_new);
      const float p = ok ? expf(s - m_new) : 0.f;
      l[rr] = l[rr] * alpha + warp_sum(p);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[rr][c] *= alpha;
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[rr][c] = fmaf(pj, sv[j * D + d], acc[rr][c]);
        }
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= Sq) continue;
    const float div = l[rr] == 0.f ? 1.f : l[rr];
    T* orow = out + ((static_cast<size_t>(b) * H + h) * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = from_f<T>(acc[rr][c] / div);
    }
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KVH, int Sq, int Skv, int D, int causal, int window,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D);
  auto kern = flash_kernel<T, DC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KVH, Sq, Skv, D,
      causal, window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int KVH, int Sq, int Skv, int D, int causal, int window,
             cudaStream_t s) {
  if (D <= 32) return launch<T, 1>(q, k, v, out, B, H, KVH, Sq, Skv, D,
                                   causal, window, s);
  if (D <= 64) return launch<T, 2>(q, k, v, out, B, H, KVH, Sq, Skv, D,
                                   causal, window, s);
  if (D <= 128) return launch<T, 4>(q, k, v, out, B, H, KVH, Sq, Skv, D,
                                    causal, window, s);
  return launch<T, 8>(q, k, v, out, B, H, KVH, Sq, Skv, D, causal, window,
                      s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it)
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int KVH, int Sq,
                               int Skv, int D, int causal, int window,
                               int dtype, void* stream) {
  if (D < 1 || D > 256 || KVH < 1 || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, H, KVH, Sq, Skv, D, causal,
                           window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, H, KVH, Sq, Skv, D,
                                   causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

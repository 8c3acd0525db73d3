// Decode attention for Hopper: one new token per sequence against a KV
// cache with per-sequence lengths, plus the softmax stats (m, l).
//
// Replaces the Pallas TPU kernel decode_attention
// (src/repro/kernels/decode_attention/decode_attention.py).  The TPU grid
// walks (b, kv head, kv tile) in order with the G = H / KVH query heads of
// one kv head resident in VMEM and (m, l, acc) carried in scratch.  Here
// one block owns (b, kv head) and loops over the sequence's first
// lengths[b] cache rows (clamped to S) in tiles of kBK = 32 rows; each of
// its G warps owns one query head.  A tile of k and v is staged in shared
// memory as fp32 (k rows padded to D + 1 floats against bank conflicts);
// lane j scores row j, the warp reduces max and sum with shuffles, and
// each lane accumulates p @ v over the head dims lane, lane + 32, ...
//
// Edge conventions follow the TPU kernel: masked scores are NEG_INF =
// -1e30, masked probabilities 0, and a sequence of length 0 writes 0 with
// m = NEG_INF and l = 0.
//
// Bound: decode streams the cache once (2·len·KVH·D elements per
// sequence) for ~4·len·H·D flops — a few flops per byte, so HBM bandwidth
// bounds it.  This first version reads each cache row once per block
// (one block per kv head), which is the bytes bound's access pattern, but
// with only B·KVH blocks and no load pipelining it cannot fill the card
// at small batch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 32;
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
__global__ void decode_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ lengths,
                              T* __restrict__ out, float* __restrict__ m_out,
                              float* __restrict__ l_out, int H, int KVH,
                              int S, int D, float scale) {
  extern __shared__ float smem[];
  const int G = H / KVH;
  float* sq = smem;                   // [G][D]     scaled queries
  float* sk = sq + G * D;             // [kBK][D+1] keys (padded rows)
  float* sv = sk + kBK * (D + 1);     // [kBK][D]   values
  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, g = tid >> 5;
  const int h = kh * G + g;
  const T* qb = q + (static_cast<size_t>(b) * H + kh * G) * D;
  const T* kb = k + (static_cast<size_t>(b) * KVH + kh) * S * D;
  const T* vb = v + (static_cast<size_t>(b) * KVH + kh) * S * D;
  const int len = min(max(lengths[b], 0), S);

  for (int i = tid; i < G * D; i += blockDim.x) sq[i] = to_f(qb[i]) * scale;

  float m = kNegInf, l = 0.f, acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < len; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and sq written)
    for (int i = tid; i < kBK * D; i += blockDim.x) {
      const int r = i / D, d = i % D, ki = k0 + r;
      const size_t gi = static_cast<size_t>(ki) * D + d;
      sk[r * (D + 1) + d] = ki < len ? to_f(kb[gi]) : 0.f;
      sv[r * D + d] = ki < len ? to_f(vb[gi]) : 0.f;
    }
    __syncthreads();
    const int ki = k0 + lane;
    const float* qr = sq + g * D;
    const float* kr = sk + lane * (D + 1);
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
    const bool ok = ki < len;
    s = ok ? s : kNegInf;
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc[c] = fmaf(pj, sv[j * D + d], acc[c]);
      }
    }
    m = m_new;
  }

  const float div = l == 0.f ? 1.f : l;
  T* orow = out + (static_cast<size_t>(b) * H + h) * D;
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int d = lane + 32 * c;
    if (d < D) orow[d] = from_f<T>(acc[c] / div);
  }
  if (lane == 0) {
    m_out[static_cast<size_t>(b) * H + h] = m;
    l_out[static_cast<size_t>(b) * H + h] = l;
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* m, float* l, int B, int H, int KVH, int S,
           int D, cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem = sizeof(float) * (G * D + kBK * (D + 1) + kBK * D);
  auto kern = decode_kernel<T, DC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(KVH, B);
  kern<<<grid, G * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), m, l, H, KVH,
      S, D, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* len,
             void* out, float* m, float* l, int B, int H, int KVH, int S,
             int D, cudaStream_t s) {
  if (D <= 32) return launch<T, 1>(q, k, v, len, out, m, l, B, H, KVH, S, D,
                                   s);
  if (D <= 64) return launch<T, 2>(q, k, v, len, out, m, l, B, H, KVH, S, D,
                                   s);
  if (D <= 128) return launch<T, 4>(q, k, v, len, out, m, l, B, H, KVH, S,
                                    D, s);
  return launch<T, 8>(q, k, v, len, out, m, l, B, H, KVH, S, D, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it)
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, void* out, float* m,
                                float* l, int B, int H, int KVH, int S, int D,
                                int dtype, void* stream) {
  if (D < 1 || D > 256 || KVH < 1 || H % KVH != 0 || H / KVH > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, lengths, out, m, l, B, H, KVH, S, D, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, lengths, out, m, l, B, H, KVH, S,
                                   D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

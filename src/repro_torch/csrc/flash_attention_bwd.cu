// The gradient of the prefill attention (flash_attention.cu) for Hopper:
// dq, dk and dv of causal / sliding-window GQA attention, recomputing the
// probabilities from the forward's logsumexp.
//
// The TPU package has no backward kernel: its models take XLA's gradient
// of their jnp attention (src/repro/models/common.py:111 _sdpa), and its
// Pallas flash_attention (src/repro/kernels/flash_attention/
// flash_attention.py:105, pallas_call at :130) is forward only.  This is
// the gradient of that kernel's function, the one jax.vjp takes of _sdpa
// wherever a row sees a key (keep a key when qi >= ki under causal and
// qi - ki < window when window > 0; a row with no key has lse = -inf, P =
// 0 and contributes nothing).
//
// Three kernels, launched in order on one stream from one C entry:
//   (a) delta_kernel: D_i = rowsum(dO ⊙ O) in fp32, one warp a row.
//   (b) dkdv_kernel: one block owns a tile of kBK keys of one (b, kv
//       head) and loops over the q tiles of every q head of its GQA group
//       that can see them.  Per q tile it recomputes S = Q K^T and P =
//       exp(S·scale - lse), dP = dO V^T and dS = P ⊙ (dP - D), and adds
//       dV += P^T dO and dK += dS^T Q · scale.  The group's sum happens in
//       the block's registers, so no two blocks write one element and
//       nothing needs a floating-point atomic: the gradient is the same,
//       bit for bit, on every run (a restarted trainer replays the same
//       trajectory).
//   (c) dq_kernel: one block owns a tile of kBQ query rows of one (b, h)
//       and loops over the kv tiles it can see: dQ += dS K · scale, S and
//       P recomputed as in (b).
// Both (b) and (c) recompute S and dP: 7 tile products a (q, kv) tile
// pair instead of FA2's 5, the price of having no atomics.
//
// This first design is scalar: fp32 FMAs on tiles staged as fp32 in
// shared memory (bf16 inputs are widened as they are staged), fp32
// accumulation, outputs rounded once to the inputs' dtype.  Tile products
// of 32 x 32 x D: a warp takes one key per lane and four query rows, so a
// key row is read once for four rows and a query row is a broadcast; the
// accumulation gives each thread BK·DMAX/256 (or BQ·DMAX/256) outputs.
// Rows are padded to DMAX + 1 floats so a warp's 32 keys fall in 32 banks.
// Head dims up to 256 (DMAX 32, 64, 128, 256).
//
// Bound: ~2.5x the forward's tensor-core FLOPs (4·Sq·Skv·D a head,
// halved by a causal mask) against q, k, v, o, dO, lse read once and dq,
// dk, dv written once: the tensor cores bound it.  Scalar fp32 FMAs run at
// a fraction of that (PERF.md); an mma.sync / wgmma design is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;              // query rows of a tile
constexpr int kBK = 32;              // keys of a tile
constexpr int kThreads = 256;        // 8 warps
constexpr int kRows = kBQ / (kThreads / 32);   // query rows a warp scores

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [r0, r0 + ROWS) of a [n, D] matrix into a [ROWS][LD] fp32 tile;
// rows >= n are zero
template <typename T, int ROWS>
__device__ __forceinline__ void stage(float* tile, const T* src, int r0,
                                      int n, int D, int LD) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, d = i - r * D, ri = r0 + r;
    tile[r * LD + d] = ri < n ? ld(src + static_cast<size_t>(ri) * D + d)
                              : 0.f;
  }
}

// (a) D_i = sum_d dO[i, d] · O[i, d], one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + static_cast<size_t>(row) * D;
  const T* drow = dout + static_cast<size_t>(row) * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(ld(drow + d), ld(orow + d), acc);
  for (int x = 16; x > 0; x >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) delta[row] = acc;
}

// Shared memory of (b) and (c): four [32][LD] fp32 tiles (Q, dO, K, V),
// P and dS [kBQ][kBK + 1], lse and D of the q tile.
struct Smem {
  float *q, *dout, *k, *v, *p, *ds, *lse, *delta;
  __device__ Smem(float* base, int LD) {
    q = base;
    dout = q + kBQ * LD;
    k = dout + kBQ * LD;
    v = k + kBK * LD;
    p = v + kBK * LD;
    ds = p + kBQ * (kBK + 1);
    lse = ds + kBQ * (kBK + 1);
    delta = lse + kBQ;
  }
};

__host__ __device__ constexpr size_t smem_bytes(int LD) {
  return sizeof(float) *
         (static_cast<size_t>(2 * kBQ + 2 * kBK) * LD +
          2 * kBQ * (kBK + 1) + 2 * kBQ);
}

// P and dS of the staged (q tile at q0, kv tile at k0) pair into sm.p and
// sm.ds: lane = key, the warp's kRows rows.  A masked pair, a row >= Sq
// and a key >= Skv give 0.
__device__ __forceinline__ void pair_tile(const Smem& sm, int q0, int k0,
                                          int Sq, int Skv, int D, int LD,
                                          int causal, int window,
                                          float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* kr = sm.k + lane * LD;
  const float* vr = sm.v + lane * LD;
  float s[kRows], dp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float kd = kr[d], vd = vr[d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = warp + r * (kThreads / 32);
      s[r] = fmaf(sm.q[i * LD + d], kd, s[r]);
      dp[r] = fmaf(sm.dout[i * LD + d], vd, dp[r]);
    }
  }
  const int ki = k0 + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = warp + r * (kThreads / 32), qi = q0 + i;
    bool ok = qi < Sq && ki < Skv;
    if (causal) ok = ok && qi >= ki;
    if (window > 0) ok = ok && qi - ki < window;
    const float p = ok ? expf(s[r] * scale - sm.lse[i]) : 0.f;
    sm.p[i * (kBK + 1) + lane] = p;
    sm.ds[i * (kBK + 1) + lane] = p * (dp[r] - sm.delta[i]);
  }
}

// stage the q side of a pair: Q, dO, lse and D of rows [q0, q0 + kBQ) of
// one (b, h); rows >= Sq are zero (their P is masked anyway)
template <typename T>
__device__ __forceinline__ void stage_q(const Smem& sm, const T* qb,
                                        const T* db, const float* lb,
                                        const float* deb, int q0, int Sq,
                                        int D, int LD) {
  stage<T, kBQ>(sm.q, qb, q0, Sq, D, LD);
  stage<T, kBQ>(sm.dout, db, q0, Sq, D, LD);
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const int qi = q0 + i;
    sm.lse[i] = qi < Sq ? lb[qi] : 0.f;
    sm.delta[i] = qi < Sq ? deb[qi] : 0.f;
  }
}

// (b) dK, dV of one kv tile of one (b, kv head), summed over its group
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int H, int KVH, int Sq,
            int Skv, int D, int causal, int window, float scale) {
  constexpr int LD = DMAX + 1;
  constexpr int NACC = kBK * DMAX / kThreads;
  extern __shared__ float smem[];
  const Smem sm(smem, LD);
  const int k0 = blockIdx.x * kBK, kh = blockIdx.y, b = blockIdx.z;
  const int group = H / KVH;
  const size_t kvoff = (static_cast<size_t>(b) * KVH + kh) * Skv;
  stage<T, kBK>(sm.k, k + kvoff * D, k0, Skv, D, LD);
  stage<T, kBK>(sm.v, v + kvoff * D, k0, Skv, D, LD);

  // the q rows that can see a key of this tile
  const int k_last = min(k0 + kBK, Skv) - 1;
  int q_lo = causal ? k0 : 0;
  q_lo = (q_lo / kBQ) * kBQ;
  int q_hi = Sq;
  if (window > 0) q_hi = min(q_hi, k_last + window);

  float adk[NACC], adv[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) adk[e] = adv[e] = 0.f;
  for (int g = 0; g < group; ++g) {
    const int h = kh * group + g;
    const size_t qoff = (static_cast<size_t>(b) * H + h) * Sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += kBQ) {
      __syncthreads();        // the previous pair is consumed
      stage_q(sm, q + qoff * D, dout + qoff * D, lse + qoff, delta + qoff,
              q0, Sq, D, LD);
      __syncthreads();
      pair_tile(sm, q0, k0, Sq, Skv, D, LD, causal, window, scale);
      __syncthreads();
      // thread t owns (j, d) = divmod(t + kThreads e, DMAX)
#pragma unroll
      for (int e = 0; e < NACC; ++e) {
        const int idx = threadIdx.x + kThreads * e;
        const int j = idx / DMAX, d = idx % DMAX;
        if (d < D) {
          float sdv = adv[e], sdk = adk[e];
#pragma unroll 8
          for (int i = 0; i < kBQ; ++i) {
            sdv = fmaf(sm.p[i * (kBK + 1) + j], sm.dout[i * LD + d], sdv);
            sdk = fmaf(sm.ds[i * (kBK + 1) + j], sm.q[i * LD + d], sdk);
          }
          adv[e] = sdv;
          adk[e] = sdk;
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < NACC; ++e) {
    const int idx = threadIdx.x + kThreads * e;
    const int j = idx / DMAX, d = idx % DMAX, ki = k0 + j;
    if (d < D && ki < Skv) {
      const size_t at = (kvoff + ki) * D + d;
      st(dk + at, adk[e] * scale);
      st(dv + at, adv[e]);
    }
  }
}

// (c) dQ of one q tile of one (b, h)
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int H, int KVH, int Sq, int Skv, int D,
          int causal, int window, float scale) {
  constexpr int LD = DMAX + 1;
  constexpr int NACC = kBQ * DMAX / kThreads;
  extern __shared__ float smem[];
  const Smem sm(smem, LD);
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const size_t qoff = (static_cast<size_t>(b) * H + h) * Sq;
  const size_t kvoff = (static_cast<size_t>(b) * KVH + kh) * Skv;
  stage_q(sm, q + qoff * D, dout + qoff * D, lse + qoff, delta + qoff, q0,
          Sq, D, LD);

  // the kv tiles that can hold a key some row of this tile sees
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q_last + 1);
  int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_lo = (kv_lo / kBK) * kBK;

  float acc[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0.f;
  for (int k0 = kv_lo; k0 < kv_hi; k0 += kBK) {
    __syncthreads();          // the previous tile is consumed
    stage<T, kBK>(sm.k, k + kvoff * D, k0, Skv, D, LD);
    stage<T, kBK>(sm.v, v + kvoff * D, k0, Skv, D, LD);
    __syncthreads();
    pair_tile(sm, q0, k0, Sq, Skv, D, LD, causal, window, scale);
    __syncthreads();
    // thread t owns (i, d) = divmod(t + kThreads e, DMAX)
#pragma unroll
    for (int e = 0; e < NACC; ++e) {
      const int idx = threadIdx.x + kThreads * e;
      const int i = idx / DMAX, d = idx % DMAX;
      if (d < D) {
        float s = acc[e];
#pragma unroll 8
        for (int j = 0; j < kBK; ++j)
          s = fmaf(sm.ds[i * (kBK + 1) + j], sm.k[j * LD + d], s);
        acc[e] = s;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < NACC; ++e) {
    const int idx = threadIdx.x + kThreads * e;
    const int i = idx / DMAX, d = idx % DMAX, qi = q0 + i;
    if (d < D && qi < Sq) st(dq + (qoff + qi) * D + d, acc[e] * scale);
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KVH, int Sq, int Skv, int D,
           int causal, int window, cudaStream_t s) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const size_t smem = smem_bytes(DMAX + 1);
  cudaError_t e = allow_smem(dkdv_kernel<T, DMAX>, smem);
  if (e == cudaSuccess) e = allow_smem(dq_kernel<T, DMAX>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = B * H * Sq;
  if (rows > 0) {
    const int per = kThreads / 32;
    delta_kernel<T><<<(rows + per - 1) / per, kThreads, 0, s>>>(
        static_cast<const T*>(o), tdo, delta, rows, D);
    dq_kernel<T, DMAX><<<dim3((Sq + kBQ - 1) / kBQ, H, B), kThreads, smem,
                         s>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq),
                              H, KVH, Sq, Skv, D, causal, window, scale);
  }
  if (B * KVH * Skv > 0)
    dkdv_kernel<T, DMAX><<<dim3((Skv + kBK - 1) / kBK, KVH, B), kThreads,
                           smem, s>>>(tq, tk, tv, tdo, lse, delta,
                                      static_cast<T*>(dk), static_cast<T*>(dv),
                                      H, KVH, Sq, Skv, D, causal, window,
                                      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, float* delta, void* dq,
             void* dk, void* dv, int B, int H, int KVH, int Sq, int Skv,
             int D, int causal, int window, cudaStream_t s) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KVH,
                         Sq, Skv, D, causal, window, s);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KVH,
                         Sq, Skv, D, causal, window, s);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H,
                          KVH, Sq, Skv, D, causal, window, s);
  return launch<T, 256>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H, KVH,
                        Sq, Skv, D, causal, window, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, shared by q, k, v, o, dout, dq, dk and
// dv; lse (the forward's, natural log) and delta (scratch, [B, H, Sq]) are
// fp32.  dq, dk and dv are written whole (no zero-fill needed).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int H, int KVH, int Sq, int Skv,
                                   int D, int causal, int window, int dtype,
                                   void* stream) {
  if (D < 1 || D > 256 || KVH < 1 || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* de = static_cast<float*>(delta);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, l, dout, de, dq, dk, dv, B, H, KVH,
                           Sq, Skv, D, causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, l, dout, de, dq, dk, dv, B, H,
                                   KVH, Sq, Skv, D, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

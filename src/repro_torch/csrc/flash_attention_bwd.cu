// The gradient of the prefill attention (flash_attention.cu) for Hopper:
// dq, dk and dv of causal / sliding-window GQA attention, recomputing the
// probabilities from the forward's logsumexp.
//
// Replaces no TPU kernel.  The TPU package has no backward kernel: its
// models take XLA's gradient of their jnp attention
// (src/repro/models/common.py:111 _sdpa), and its Pallas flash_attention
// (src/repro/kernels/flash_attention/flash_attention.py:105, pallas_call
// at :130) is forward only.  This is the gradient of that kernel's
// function, the one jax.vjp takes of _sdpa wherever a row sees a key
// (keep a key when qi >= ki under causal, qi - ki < window when window >
// 0, qi < Sq and ki < Skv; a row with no key has lse = -inf, P = 0 and
// adds nothing).
//
// Bound, at the train shape (B 8, H 32, KVH 8, Sq = Skv 256, D 64,
// causal, bf16): q, k, v, o, dO and lse read once and dq, dk, dv written
// once are 42.2 MB, 0.012599 ms at 3.35 TB/s; the tile products over the
// 8.42 M unmasked (b, h, q, k) pairs are 5.4 GFLOP at FA2's 5 a pair
// (0.0054 ms at 989 TFLOP/s) and 7.5 GFLOP at the 7 done here (0.0076
// ms).  The bytes bound it.  What the card shows is latency: the
// heaviest (b) blocks walk their q tiles in order, one warp per scheduler,
// and the products run far below the tensor cores' rate (PERF.md).
//
// Two kernels, launched in order on one stream from one C entry, and no
// floating-point atomics: no two blocks write one element, so the
// gradient is the same, bit for bit, on every run (a restarted trainer
// replays the same trajectory).  Both recompute S and dP: 7 tile products
// a (q, kv) tile pair instead of FA2's 5; deterministic dQ partials would
// move more bytes than the two extra products cost.
//   (c) dq_kernel, launched first: a block owns a q tile of one (b, h) and
//       loops over the kv tiles its rows see: S = Q K^T, dP = dO V^T,
//       dS = P ⊙ (dP - D), dQ += dS K · scale.  It also computes D_i =
//       rowsum(dO ⊙ O) of its rows (O read beside the staged dO) and
//       writes it for (b).
//   (b) dkdv_kernel: a block owns a kv tile of one (b, kv head) and loops
//       over the q tiles of every q head of its GQA group that can see it:
//       S^T, dP^T, dV += P^T dO, dK += dS^T Q · scale.  The group's sum
//       stays in the block's registers.
//
// bf16, D <= 128: tensor cores.  Every tile product is mma.sync.m16n8k16
// (bf16 in, fp32 accumulate) fed by ldmatrix, with the forward's helpers
// and layouts (copied here, so the forward's code does not move).  A
// block is 4 warps; each warp owns 16 rows of the block's tile: 16 q rows
// in (c), 16 keys in (b).  (b) works key-major: S^T = K Q^T and dP^T = V
// dO^T take K and V as A operands (plain ldmatrix), Q and dO as B
// operands.  The fp32 C fragments of P^T and dS^T are packed, in
// registers, into the A fragments of dV += P^T dO and dK += dS^T Q, whose
// B operands come through ldmatrix.trans, as V does in the forward; (c)
// packs dS into the A fragments of dQ += dS K the same way.  P and dS
// never go through shared memory.  The block's own tile (K and V in (b);
// Q, dO in (c)) is staged once; the streamed operand (Q, dO, lse and D in
// (b); K and V in (c)) arrives by cp.async into a ring of 2 stages, one
// tile ahead of the one in use.  Rows are padded by 16 bytes so the 8 rows
// an ldmatrix reads fall in distinct banks, a head dim below DMAX (32, 64
// or 128) is zero-padded in shared memory, rows past Sq / Skv are
// zero-filled, and when D % 8 != 0 or a pointer is not 16-byte aligned
// the same kernels stage with plain loads.  Tiles: 64 q rows x 64 keys in
// (c); 64 keys x 64 q rows in (b), 32 q rows at D > 64 so that dK, dV and
// S^T, dP^T stay in registers.  The grid starts the heaviest tiles first:
// in (c) the last q tile of every head, in (b) kv tile 0 of every head.
// Numerics: S is scaled by 1/sqrt(D)·log2(e) in fp32 after the product
// (q · scale is never rounded to bf16: for D != 64 the scale is not a
// power of 2) and P = 2^(S·c - lse·log2 e) (ex2.approx); P and dS are
// rounded once to bf16 as A operands, everything else accumulates in
// fp32, and the outputs are rounded once to bf16, dK after its scale.  A
// masked pair, a row past Sq and a row whose lse is -inf give P = 0;
// masks are evaluated only on tiles that cross the causal diagonal, the
// window floor or an edge.
//
// fp32, and bf16 with 128 < D <= 256: the scalar kernels of the first
// design, a dispatch on the dtype and the head dim, not a fallback.  In
// fp32, tensor cores mean TF32, which cannot hold the fp32 gate (1e-4 of
// the largest gradient element).  Above D = 128 the accumulators of a
// 16-row warp no longer fit in registers (2 x 16 x 256 / 32 = 256 fp32 a
// thread).  The scalar design: (a) delta_kernel, D_i in fp32, one warp a
// row; then (c) and (b) as above with fp32 FMAs on tiles widened to fp32
// in shared memory, 32 x 32 tiles, a warp taking one key per lane and four
// query rows; rows padded to DMAX + 1 floats; head dims up to 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// fp32, and bf16 above D = 128: scalar kernels
// ---------------------------------------------------------------------------
namespace scalar {

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

}  // namespace scalar

// ---------------------------------------------------------------------------
// bf16, D <= 128: tensor-core kernels (mma.sync m16n8k16, ldmatrix,
// cp.async)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;   // a block's own rows: q rows in (c),
                                     // keys in (b)
constexpr int kPad = 8;              // bf16 elements (16 bytes) per row
constexpr int kStages = 2;           // streamed tiles in shared memory
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared, zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 -> one register of two bf16 (x0 in the low half)
__device__ __forceinline__ uint32_t pack_bf16x2(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the A fragment (16 x 16) of columns [16 kc, 16 kc + 16) of a 16-row C
// tile held as n8 fragments c[2 kc], c[2 kc + 1]: the C layout of one
// mma is the A layout of the next, so P and dS stay in registers
template <int N>
__device__ __forceinline__ void a_from_c(uint32_t a[4], const float (&c)[N][4],
                                         int kc) {
  a[0] = pack_bf16x2(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16x2(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16x2(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16x2(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf gives +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// an lse in the exponent's base-2 units; a row with no key (lse = -inf)
// gets +inf, so its every P is 2^-inf = 0
__device__ __forceinline__ float lse2(float l) {
  return l == -inf() ? inf() : l * kLog2e;
}

// Stage rows [r0, r0 + ROWS) of a [n, D] bf16 matrix into a [ROWS][LD]
// tile (columns < D); rows >= n are zero.  With `async` (D % 8 == 0 and
// 16-byte aligned rows) a thread copies the 16-byte piece j = tid %
// (DMAX / 8) of every (kThreads / (DMAX / 8))-th row; else plain loads.
template <int DMAX, int ROWS>
__device__ __forceinline__ void stage(bf16* tile, const bf16* src, int r0,
                                      int n, int D, bool async) {
  constexpr int LD = DMAX + kPad;
  constexpr int kPieces = DMAX / 8;            // 16-byte pieces per row
  constexpr int kRowStep = kThreads / kPieces;
  const int tid = threadIdx.x;
  if (async) {
    const int j = (tid % kPieces) << 3, r1 = tid / kPieces;
    if (j < D) {
#pragma unroll
      for (int r = r1; r < ROWS; r += kRowStep) {
        const int ri = r0 + r;
        const bool ok = ri < n;
        cp_async16(tile + r * LD + j,
                   src + static_cast<size_t>(ok ? ri : 0) * D + j, ok);
      }
    }
  } else {
    for (int i = tid; i < ROWS * D; i += kThreads) {
      const int r = i / D, d = i - r * D, ri = r0 + r;
      tile[r * LD + d] = ri < n ? src[static_cast<size_t>(ri) * D + d]
                                : __float2bfloat16(0.f);
    }
  }
}

// zero columns [D, DMAX) of `rows` consecutive [LD] rows once: the MMAs
// read them, no load writes them
template <int DMAX>
__device__ __forceinline__ void zero_pad(bf16* base, int rows, int D) {
  constexpr int LD = DMAX + kPad;
  const int dpad = DMAX - D;
  if (dpad <= 0) return;
  const bf16 z = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < rows * dpad; i += kThreads) {
    const int r = i / dpad;
    base[r * LD + D + (i - r * dpad)] = z;
  }
}

// rows row0 and row0 + 8 (those < n) of a [n, D] matrix from a warp's C
// fragments acc[j][e] (row row0 + 8 (e >> 1), column 8 j + 2 (lane % 4) +
// (e & 1)), times mul, rounded once to bf16
template <int DT>
__device__ __forceinline__ void store_rows(bf16* base, int row0, int n,
                                           int D, const float (&acc)[DT][4],
                                           float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= n) continue;
    bf16* row = base + static_cast<size_t>(r) * D;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = j * 8 + ((lane & 3) << 1);
      if (d >= D) continue;
      const float o0 = acc[j][2 * i] * mul, o1 = acc[j][2 * i + 1] * mul;
      if (d + 1 < D && (D & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(row + d) =
            __floats2bfloat162_rn(o0, o1);
      } else {
        row[d] = __float2bfloat16(o0);
        if (d + 1 < D) row[d + 1] = __float2bfloat16(o1);
      }
    }
  }
}

// (c) dQ of one q tile (kTile rows) of one (b, h), and D_i of its rows.
// DMAX: head dims the registers hold (D <= DMAX); BK: keys per kv tile
template <int DMAX, int BK>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ o,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, bf16* __restrict__ dq, int H, int KVH,
          int Sq, int Skv, int D, int causal, int window, float scale,
          int async) {
  constexpr int LD = DMAX + kPad;
  constexpr int NT = BK / 8;          // n8 tiles of S and dP per warp
  constexpr int DT = DMAX / 8;        // n8 tiles of dQ per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);   // [kTile][LD]
  bf16* sdo = sq + kTile * LD;                    // [kTile][LD]
  bf16* sk = sdo + kTile * LD;                    // [kStages][BK][LD]
  bf16* sv = sk + kStages * BK * LD;              // [kStages][BK][LD]

  // the last q tiles see the most keys under a causal mask: the grid
  // starts them first, for every head
  const int qt = gridDim.z - 1 - blockIdx.z, h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (H / KVH);
  const int q0 = qt * kTile;
  const size_t qoff = (static_cast<size_t>(b) * H + h) * Sq;
  const size_t kvoff = (static_cast<size_t>(b) * KVH + kh) * Skv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // kv tiles that can hold an unmasked key for some row of this q tile
  const int q_last = min(q0 + kTile, Sq) - 1;
  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q_last + 1);
  int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_lo = (kv_lo / BK) * BK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  // prologue: Q, dO, O (into the last K stage, free until the loop) and
  // kv tile 0, then tiles 1 .. kStages - 2, one commit group each
  static_assert(BK >= kTile, "a K stage holds the O tile");
  bf16* so = sk + (kStages - 1) * BK * LD;
  zero_pad<DMAX>(sq, 2 * kTile + 2 * kStages * BK, D);
  stage<DMAX, kTile>(sq, q + qoff * D, q0, Sq, D, async);
  stage<DMAX, kTile>(sdo, dout + qoff * D, q0, Sq, D, async);
  stage<DMAX, kTile>(so, o + qoff * D, q0, Sq, D, async);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      stage<DMAX, BK>(sk + t * BK * LD, k + kvoff * D, kv_lo + t * BK, Skv,
                      D, async);
      stage<DMAX, BK>(sv + t * BK * LD, v + kvoff * D, kv_lo + t * BK, Skv,
                      D, async);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();       // Q, dO, O and tile 0 have landed
  __syncthreads();

  // D_i = rowsum(dO ⊙ O) of this warp's 16 rows, two lanes a row, each
  // half a row (fp32, a fixed order; pad columns and rows past Sq are
  // zero); written for (b), and kept for this lane's C rows
  const int rmin = q0 + warp * 16, rmax = rmin + 15;
  const int row0 = rmin + (lane >> 2);      // C rows row0, row0 + 8
  float dl[2], ls[2];
  {
    const int r = warp * 16 + (lane >> 1), qi = q0 + r;
    const int c0 = (lane & 1) * (DMAX / 2);
    const __nv_bfloat162* orow =
        reinterpret_cast<const __nv_bfloat162*>(so + r * LD + c0);
    const __nv_bfloat162* drow =
        reinterpret_cast<const __nv_bfloat162*>(sdo + r * LD + c0);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < DMAX / 4; ++i) {
      const float2 a = __bfloat1622float2(drow[i]);
      const float2 c = __bfloat1622float2(orow[i]);
      acc = fmaf(a.x, c.x, acc);
      acc = fmaf(a.y, c.y, acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0 && qi < Sq) delta[qoff + qi] = acc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dl[i] = __shfl_sync(0xffffffffu, acc, 2 * ((lane >> 2) + 8 * i));
      const int ri = row0 + 8 * i;
      ls[i] = ri < Sq ? lse2(lse[qoff + ri]) : inf();
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float c2 = scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();     // tile t has landed
    __syncthreads();                  // ... and every warp is past t - 1
    const int nt = t + kStages - 1;   // into the stage tile t - 1 held
    if (nt < n_tiles) {
      const int st = nt % kStages;
      stage<DMAX, BK>(sk + st * BK * LD, k + kvoff * D, kv_lo + nt * BK, Skv,
                      D, async);
      stage<DMAX, BK>(sv + st * BK * LD, v + kvoff * D, kv_lo + nt * BK, Skv,
                      D, async);
    }
    cp_async_commit();
    const int k0 = kv_lo + t * BK;
    const bf16* tk = sk + (t % kStages) * BK * LD;
    const bf16* tv = sv + (t % kStages) * BK * LD;
    // a warp whose keys are all masked for all its rows skips the tile
    bool live = k0 < Skv && rmin < Sq;
    if (causal) live = live && k0 <= rmax;
    if (window > 0) live = live && rmin - (k0 + BK - 1) < window;
    if (!live) continue;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows and BK keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DMAX / 16; ++kc) {  // pad columns are zero
      uint32_t aq[4], ad[4];
      const int arow = (warp * 16 + (lane & 15)) * LD + kc * 16 +
                       ((lane >> 4) << 3);
      ldsm_x4(aq, sq + arow);
      ldsm_x4(ad, sdo + arow);
#pragma unroll
      for (int jn = 0; jn < BK / 16; ++jn) {
        uint32_t bk[4], bv[4];
        const int brow = (jn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                         kc * 16 + (((lane >> 3) & 1) << 3);
        ldsm_x4(bk, tk + brow);
        ldsm_x4(bv, tv + brow);
        mma16816(s[2 * jn], aq, bk[0], bk[1]);
        mma16816(s[2 * jn + 1], aq, bk[2], bk[3]);
        mma16816(dp[2 * jn], ad, bv[0], bv[1]);
        mma16816(dp[2 * jn + 1], ad, bv[2], bv[3]);
      }
    }

    // P = 2^(S·c - lse·log2 e) and dS = P ⊙ (dP - D), in place of S;
    // element (j, e) is row row0 + 8 (e >> 1), key kl + 8 j + (e & 1).
    // Masks only where some pair of this warp's rows and keys is masked
    bool edge = k0 + BK > Skv;
    if (causal) edge = edge || k0 + BK - 1 > rmin;
    if (window > 0) edge = edge || rmax - k0 >= window;
    const int kl = k0 + ((lane & 3) << 1);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * c2 - ls[e >> 1];
        if (edge) {
          const int ki = kl + 8 * j + (e & 1), qi = row0 + 8 * (e >> 1);
          const bool ok = ki < Skv && (!causal || qi >= ki) &&
                          (window <= 0 || qi - ki < window);
          x = ok ? x : -inf();
        }
        s[j][e] = ex2(x) * (dp[j][e] - dl[e >> 1]);
      }
    }

    // dQ += dS K: dS from registers (one bf16 rounding), K through
    // ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      a_from_c(a, s, kc);
#pragma unroll
      for (int jd = 0; jd < DMAX / 16; ++jd) {
        uint32_t bb[4];
        ldsm_x4_t(bb, tk + (kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                               LD + jd * 16 + ((lane >> 4) << 3));
        mma16816(acc[2 * jd], a, bb[0], bb[1]);
        mma16816(acc[2 * jd + 1], a, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();
  store_rows(dq + qoff * D, row0, Sq, D, acc, scale);
}

// (b) dK, dV of one kv tile (kTile keys) of one (b, kv head), summed over
// its group.  BQ: q rows per streamed tile
template <int DMAX, int BQ>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KVH,
            int Sq, int Skv, int D, int causal, int window, float scale,
            int async) {
  constexpr int LD = DMAX + kPad;
  constexpr int NT = BQ / 8;          // n8 tiles of S^T and dP^T per warp
  constexpr int DT = DMAX / 8;        // n8 tiles of dK and dV per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);   // [kTile][LD]
  bf16* sv = sk + kTile * LD;                     // [kTile][LD]
  bf16* sq = sv + kTile * LD;                     // [kStages][BQ][LD]
  bf16* sdo = sq + kStages * BQ * LD;             // [kStages][BQ][LD]
  float* slse = reinterpret_cast<float*>(sdo + kStages * BQ * LD);
  float* sdl = slse + kStages * BQ;               // [kStages][BQ] each

  // kv tile 0 is seen by the most q rows under a causal mask: the grid
  // starts it first, for every head
  const int k0 = blockIdx.z * kTile, kh = blockIdx.x, b = blockIdx.y;
  const int group = H / KVH;
  const size_t kvoff = (static_cast<size_t>(b) * KVH + kh) * Skv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the q tiles that can see a key of this kv tile, in every head of the
  // group: iteration it is q tile it % n_qt of head kh·group + it / n_qt
  const int k_last = min(k0 + kTile, Skv) - 1;
  int q_lo = causal ? k0 : 0;
  q_lo = (q_lo / BQ) * BQ;
  int q_hi = Sq;
  if (window > 0) q_hi = min(q_hi, k_last + window);
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int n_it = group * n_qt;

  auto issue = [&](int it) {          // Q, dO, lse, D of iteration it
    const int g = it / n_qt, qt = it - g * n_qt, st = it % kStages;
    const int q0 = q_lo + qt * BQ;
    const size_t qoff =
        (static_cast<size_t>(b) * H + kh * group + g) * Sq;
    stage<DMAX, BQ>(sq + st * BQ * LD, q + qoff * D, q0, Sq, D, async);
    stage<DMAX, BQ>(sdo + st * BQ * LD, dout + qoff * D, q0, Sq, D, async);
    for (int i = tid; i < BQ; i += kThreads) {
      const int qi = q0 + i;
      const bool ok = qi < Sq;
      const size_t at = qoff + (ok ? qi : 0);
      cp_async4(slse + st * BQ + i, lse + at, ok);
      cp_async4(sdl + st * BQ + i, delta + at, ok);
    }
  };

  zero_pad<DMAX>(sk, 2 * kTile + 2 * kStages * BQ, D);
  stage<DMAX, kTile>(sk, k + kvoff * D, k0, Skv, D, async);
  stage<DMAX, kTile>(sv, v + kvoff * D, k0, Skv, D, async);
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {  // with K and V: group 0
    if (it < n_it) issue(it);
    cp_async_commit();
  }

  const int kmin = k0 + warp * 16, kmax = kmin + 15;
  const int krow0 = kmin + (lane >> 2);     // C rows krow0, krow0 + 8
  float adk[DT][4], adv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;
  const float c2 = scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 2>();     // iteration it has landed
    __syncthreads();                  // ... and every warp is past it - 1
    if (it + kStages - 1 < n_it) issue(it + kStages - 1);
    cp_async_commit();                // (into the stage it - 1 held)
    const int st = it % kStages;
    const int q0 = q_lo + (it % n_qt) * BQ, qmax = q0 + BQ - 1;
    // a warp whose keys are all masked for all the tile's rows skips it
    bool live = kmin < Skv && q0 < Sq;
    if (causal) live = live && qmax >= kmin;
    if (window > 0) live = live && q0 - kmax < window;
    if (!live) continue;
    const bf16* tq = sq + st * BQ * LD;
    const bf16* tdo = sdo + st * BQ * LD;
    const float* tl = slse + st * BQ;
    const float* td = sdl + st * BQ;

    // key-major: S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
    // and the tile's BQ q rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DMAX / 16; ++kc) {  // pad columns are zero
      uint32_t ak[4], av[4];
      const int arow = (warp * 16 + (lane & 15)) * LD + kc * 16 +
                       ((lane >> 4) << 3);
      ldsm_x4(ak, sk + arow);
      ldsm_x4(av, sv + arow);
#pragma unroll
      for (int jn = 0; jn < BQ / 16; ++jn) {
        uint32_t bq[4], bd[4];
        const int brow = (jn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                         kc * 16 + (((lane >> 3) & 1) << 3);
        ldsm_x4(bq, tq + brow);
        ldsm_x4(bd, tdo + brow);
        mma16816(s[2 * jn], ak, bq[0], bq[1]);
        mma16816(s[2 * jn + 1], ak, bq[2], bq[3]);
        mma16816(dp[2 * jn], av, bd[0], bd[1]);
        mma16816(dp[2 * jn + 1], av, bd[2], bd[3]);
      }
    }

    // P^T in place of S^T, dS^T = P^T ⊙ (dP^T - D) in place of dP^T;
    // element (j, e) is key krow0 + 8 (e >> 1), q row ql + 8 j + (e & 1)
    bool edge = kmax >= Skv || qmax >= Sq;
    if (causal) edge = edge || q0 < kmax;
    if (window > 0) edge = edge || qmax - kmin >= window;
    const int ql = (lane & 3) << 1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(tl + 8 * j + ql);
      const float2 d2 = *reinterpret_cast<const float2*>(td + 8 * j + ql);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * c2 - lse2((e & 1) ? l2.y : l2.x);
        if (edge) {
          const int qi = q0 + ql + 8 * j + (e & 1), ki = krow0 + 8 * (e >> 1);
          const bool ok = ki < Skv && qi < Sq && (!causal || qi >= ki) &&
                          (window <= 0 || qi - ki < window);
          x = ok ? x : -inf();
        }
        const float p = ex2(x);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
      }
    }

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T from registers (one
    // bf16 rounding each), dO and Q through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t ap[4], ads[4];
      a_from_c(ap, s, kc);
      a_from_c(ads, dp, kc);
#pragma unroll
      for (int jd = 0; jd < DMAX / 16; ++jd) {
        uint32_t bd[4], bq[4];
        const int brow = (kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                             LD + jd * 16 + ((lane >> 4) << 3);
        ldsm_x4_t(bd, tdo + brow);
        ldsm_x4_t(bq, tq + brow);
        mma16816(adv[2 * jd], ap, bd[0], bd[1]);
        mma16816(adv[2 * jd + 1], ap, bd[2], bd[3]);
        mma16816(adk[2 * jd], ads, bq[0], bq[1]);
        mma16816(adk[2 * jd + 1], ads, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait<0>();
  store_rows(dk + kvoff * D, krow0, Skv, D, adk, scale);
  store_rows(dv + kvoff * D, krow0, Skv, D, adv, 1.f);
}

template <int DMAX, int BK, int BQ>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KVH, int Sq, int Skv, int D,
           int causal, int window, cudaStream_t s) {
  constexpr int LD = DMAX + kPad;
  const size_t smem_c = sizeof(bf16) * (2 * kTile + 2 * kStages * BK) * LD;
  const size_t smem_b = sizeof(bf16) * (2 * kTile + 2 * kStages * BQ) * LD +
                        sizeof(float) * 2 * kStages * BQ;
  cudaError_t e = allow_smem(dq_kernel<DMAX, BK>, smem_c);
  if (e == cudaSuccess) e = allow_smem(dkdv_kernel<DMAX, BQ>, smem_b);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int async = D % 8 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                    aligned(o) && aligned(dout);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  if (B * H * Sq > 0)
    dq_kernel<DMAX, BK><<<dim3(H, B, (Sq + kTile - 1) / kTile), kThreads,
                          smem_c, s>>>(
        tq, tk, tv, static_cast<const bf16*>(o), tdo, lse, delta,
        static_cast<bf16*>(dq), H, KVH, Sq, Skv, D, causal, window, scale,
        async);
  if (B * KVH * Skv > 0)
    dkdv_kernel<DMAX, BQ><<<dim3(KVH, B, (Skv + kTile - 1) / kTile),
                            kThreads, smem_b, s>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), H, KVH, Sq, Skv, D, causal, window, scale,
        async);
  return static_cast<int>(cudaGetLastError());
}

// D <= 128 only: above it the scalar kernels serve bf16 too
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, float* delta, void* dq,
             void* dk, void* dv, int B, int H, int KVH, int Sq, int Skv,
             int D, int causal, int window, cudaStream_t s) {
  if (D <= 32)
    return launch<32, 64, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H,
                              KVH, Sq, Skv, D, causal, window, s);
  if (D <= 64)
    return launch<64, 64, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H,
                              KVH, Sq, Skv, D, causal, window, s);
  return launch<128, 64, 32>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, H,
                             KVH, Sq, Skv, D, causal, window, s);
}

}  // namespace tc

// bf16 with D <= 128 runs the tensor-core kernels; fp32, and bf16 above
// D = 128, the scalar ones
bool tensor_cores(int D, int dtype) { return dtype == 1 && D <= 128; }

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
    return scalar::dispatch<float>(q, k, v, o, l, dout, de, dq, dk, dv, B, H,
                                   KVH, Sq, Skv, D, causal, window, s);
  if (tensor_cores(D, dtype))
    return tc::dispatch(q, k, v, o, l, dout, de, dq, dk, dv, B, H, KVH, Sq,
                        Skv, D, causal, window, s);
  if (dtype == 1)
    return scalar::dispatch<__nv_bfloat16>(q, k, v, o, l, dout, de, dq, dk,
                                           dv, B, H, KVH, Sq, Skv, D, causal,
                                           window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// 1 when a call of this head dim and dtype runs the tensor-core kernels,
// 0 when it runs the scalar ones
extern "C" int flash_attention_bwd_route(int D, int dtype) {
  return tensor_cores(D, dtype) ? 1 : 0;
}

// Prefill attention for Hopper: causal / sliding-window GQA attention with
// an online softmax.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention/flash_attention.py:105, its
// pallas_call at :130).  The TPU grid walks (b, h, q tile, kv tile) in
// order and carries m, l and acc in VMEM scratch across the kv axis.  Here
// one block owns (b, h, a q tile) and loops over the kv tiles itself, so
// the carry lives in registers.  The kernel is dispatched by dtype:
//
// bf16 (the serve path): an FA2-style tensor-core kernel.  A block owns
// 64 query rows of one (b, h) and walks kv tiles of 128 keys (64 for head
// dims above 64, 32 above 128, to keep the accumulator in registers).  Its
// 8 warps are 4 row groups of 16 rows times 2 key halves: each warp keeps
// its own online softmax over its half of every tile, and the halves are
// merged through shared memory at the end; the two warps that share a
// scheduler (warp % 4) hold different row groups.  Q, K and V tiles stay
// bf16 in shared memory, each row padded by 16 bytes so the 8 rows an
// ldmatrix reads fall in distinct banks; they arrive by 16-byte cp.async
// with zero-fill past Sq / Skv into a ring of 3 K/V stages, two tiles
// ahead of the one in use.  The grid starts the heaviest (last) q tile of
// every head first, and the ring's ~120 KB of shared memory keeps one
// block per SM, so light tiles backfill SMs instead of slowing a heavy
// one.  S = Q K^T and O += P V run as
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), fed by ldmatrix (.trans
// for V).  mma.sync rather than wgmma + TMA: a first tensor-core design
// with the register-level control that the split of P below needs; at
// the serve shape (Sq ~ 300, D = 64) the last q tile's walk over 3 kv
// tiles is the critical path, and wgmma's doubled rate is later work.
// Numerics, chosen to hold one bf16 rounding step of the fp32 twin:
//   - S is scaled by 1/sqrt(D)·log2(e) in fp32 after the product (q ·
//     scale is never rounded to bf16: for D != 64 the scale is not a
//     power of 2), and the softmax runs in base 2 (ex2.approx);
//   - the softmax runs in fp32 on the C fragments; a row's max and sum
//     reduce across its quad with __shfl_xor_sync 1 and 2;
//   - P is split into two bf16 operands, P = P_hi + P_lo, and both go
//     through the tensor cores into the same fp32 accumulator: one bf16
//     rounding of P alone moves the output by ~4e-3;
//   - a masked probability is 2^(-1e30 - m) = 0; a row that has seen only
//     masked keys (m = NEG_INF) takes its exponents against 0, so a
//     masked key never gets 2^0 = 1.  Masks are evaluated only on tiles
//     that cross the causal diagonal, the window floor or Skv.
// A head dim that is not a multiple of 16 is zero-padded in shared memory.
// When D is not a multiple of 8 (or a pointer is not 16-byte aligned) the
// rows cannot be copied in 16-byte pieces, and the same kernel stages its
// tiles with plain loads instead.
//
// fp32 (phase 8's check of the model): the scalar kernel of the first
// port, fp32 FMAs on fp32 tiles.  Tensor cores in fp32 mean TF32, which
// holds neither the fp32 gate nor the model's fp32 logits gate.
//
// lse: with a non-null pointer both kernels also write each row's
// logsumexp of its scaled scores, fp32 [B, H, Sq], in the natural log
// (the bf16 kernel's base-2 running max and sum are converted after the
// key splits merge), -inf for a row with no unmasked key.  The backward
// (flash_attention_bwd.cu) recomputes P = exp(S·scale - lse) from it.  The
// write is a template variant (kLse): the serve path passes no pointer
// and runs the kernel compiled without it (a runtime branch on the
// pointer cost its bf16 kernel ~3 % on the card, PERF.md).
//
// Tiles wholly beyond the causal frontier, below the window floor or past
// Skv are never loaded.  Edge conventions follow the TPU kernel exactly: a
// masked score is NEG_INF = -1e30, a masked probability is 0, a row with
// l == 0 (no unmasked key) writes 0, and the causal mask is top-left
// aligned (qi >= ki) also when Sq != Skv.
//
// Bound: ~4·Sq·Skv·D/2 flops per head (causal) against a few MB of q, k,
// v: the bf16 tensor-core rate bounds it at under a microsecond at the
// serve shape, far below a launch.  What the card shows instead is the
// last q tile's serial walk over its kv tiles (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
// the lse of a row with no unmasked key: -inf
__device__ __forceinline__ float lse_none() {
  return __int_as_float(0xff800000);
}

// ---------------------------------------------------------------------------
// fp32: scalar kernel.  One block owns (b, h, kBQ = 16 query rows); each of
// the 4 warps owns 4 rows, a lane keeps m and l of each row plus the
// accumulator of the head dims lane, lane + 32, ...  A kv tile of 32 keys
// is staged as fp32 (k rows padded to D + 1 floats); lane j scores key j.
// ---------------------------------------------------------------------------
namespace scalar {

constexpr int kBQ = 16;
constexpr int kBK = 32;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBQ / kWarps;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// DC = head-dim chunks of 32 a lane accumulates (D <= 32 * DC); kLse:
// also write each row's lse
template <int DC, bool kLse>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             float* __restrict__ lse, int H, int KVH, int Sq, int Skv, int D,
             int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* sq = smem;                   // [kBQ][D]   scaled queries
  float* sk = sq + kBQ * D;           // [kBK][D+1] keys (padded rows)
  float* sv = sk + kBK * (D + 1);     // [kBK][D]   values
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int q0 = qt * kBQ;
  const float* qb = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const float* kb = k + (static_cast<size_t>(b) * KVH + kh) * Skv * D;
  const float* vb = v + (static_cast<size_t>(b) * KVH + kh) * Skv * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, qi = q0 + r;
    sq[i] = qi < Sq ? qb[static_cast<size_t>(qi) * D + i % D] * scale : 0.f;
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
      sk[r * (D + 1) + d] = ki < Skv ? kb[g] : 0.f;
      sv[r * D + d] = ki < Skv ? vb[g] : 0.f;
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
    const size_t row = (static_cast<size_t>(b) * H + h) * Sq + qi;
    if (kLse && lane == 0)
      lse[row] = l[rr] == 0.f ? lse_none() : m[rr] + logf(l[rr]);
    float* orow = out + row * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = acc[rr][c] / div;
    }
  }
}

template <int DC>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int KVH, int Sq, int Skv, int D,
           int causal, int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D);
  // the lse variant only where it is asked for: the serve path's kernel
  // stays the code it was without one
  auto kern = lse != nullptr ? flash_kernel<DC, true>
                              : flash_kernel<DC, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, KVH,
      Sq, Skv, D, causal, window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int H, int KVH, int Sq, int Skv, int D,
             int causal, int window, cudaStream_t s) {
  if (D <= 32) return launch<1>(q, k, v, out, lse, B, H, KVH, Sq, Skv, D,
                                causal, window, s);
  if (D <= 64) return launch<2>(q, k, v, out, lse, B, H, KVH, Sq, Skv, D,
                                causal, window, s);
  if (D <= 128) return launch<4>(q, k, v, out, lse, B, H, KVH, Sq, Skv, D,
                                 causal, window, s);
  return launch<8>(q, k, v, out, lse, B, H, KVH, Sq, Skv, D, causal, window,
                   s);
}

}  // namespace scalar

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int RG = 4;                // row groups of 16 query rows
constexpr int KS = 2;                // warps (key splits) per row group
constexpr int BQ = 16 * RG;          // query rows per block
constexpr int kThreads = RG * KS * 32;
constexpr int kPad = 8;              // bf16 elements (16 bytes) per row
constexpr int kStages = 3;           // kv tiles in shared memory
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
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

// two fp32 -> one register of two bf16 (x0 in the low half), and the
// bf16 residual x - bf16(x) of each
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Stage rows [r0, r0 + ROWS) of a [n, D] bf16 matrix into a [ROWS][LD]
// tile (columns < D); rows >= n are zero.  With `async` (D % 8 == 0) a
// thread copies the 16-byte piece j = tid % (DMAX / 8) of every
// (kThreads / (DMAX / 8))-th row, so no index needs a division.
template <int DMAX, int ROWS>
__device__ __forceinline__ void stage(__nv_bfloat16* tile,
                                      const __nv_bfloat16* src, int r0,
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

__device__ __forceinline__ float ex2(float x) {  // 2^x; -1e30 gives +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// DMAX: head dims the registers hold (D <= DMAX); BK: keys per kv tile,
// of which each of a row group's KS warps takes BK / KS; kLse: also write
// each row's lse
template <int DMAX, int BK, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int H, int KVH, int Sq, int Skv, int D, int causal,
                int window, float scale, int async) {
  constexpr int LD = DMAX + kPad;
  constexpr int KH = BK / KS;         // keys of a tile per warp
  constexpr int NT = KH / 8;          // n8 tiles of S per warp
  constexpr int DT = DMAX / 8;        // n8 tiles of O per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + BQ * LD;   // [kStages][BK][LD]
  __nv_bfloat16* sv = sk + kStages * BK * LD;

  // the last q tiles see the most keys under a causal mask: the grid
  // starts them first, for every head, and the light tiles backfill
  const int qt = gridDim.y - 1 - blockIdx.y, h = blockIdx.x, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int q0 = qt * BQ;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * KVH + kh) * Skv * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * KVH + kh) * Skv * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // row group and key split; the two warps on a scheduler (warp % 4)
  // hold different row groups
  const int wr = warp / KS, wk = warp % KS;

  // kv tiles that can hold an unmasked key for some row of this q tile
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  kv_lo = (kv_lo / BK) * BK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  // pad columns [D, DMAX) read by the MMAs: zero once, loads skip them
  const int dpad = DMAX - D;
  if (dpad > 0) {
    const __nv_bfloat16 z = __float2bfloat16(0.f);
    for (int i = tid; i < (BQ + 2 * kStages * BK) * dpad; i += kThreads) {
      const int r = i / dpad;
      sq[r * LD + D + (i - r * dpad)] = z;  // sq, sk, sv are contiguous
    }
  }
  // prologue: Q with tile 0, then tile 1, one commit group each
  if (n_tiles > 0) stage<DMAX, BQ>(sq, qb, q0, Sq, D, async);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      stage<DMAX, BK>(sk + t * BK * LD, kb, kv_lo + t * BK, Skv, D, async);
      stage<DMAX, BK>(sv + t * BK * LD, vb, kv_lo + t * BK, Skv, D, async);
    }
    cp_async_commit();
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // running max in the log2 domain (scores times scale·log2 e) and sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float c2 = scale * kLog2e;
  const int rmin = q0 + wr * 16, rmax = rmin + 15;
  // this lane's C-fragment rows: row0 and row0 + 8
  const int row0 = rmin + (lane >> 2);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();     // tile t (and Q) have landed
    __syncthreads();                  // ... and every warp is past tile t - 1
    const int nt = t + kStages - 1;   // into the stage tile t - 1 held
    if (nt < n_tiles) {
      const int st = nt % kStages;
      stage<DMAX, BK>(sk + st * BK * LD, kb, kv_lo + nt * BK, Skv, D, async);
      stage<DMAX, BK>(sv + st * BK * LD, vb, kv_lo + nt * BK, Skv, D, async);
    }
    cp_async_commit();
    const int k0 = kv_lo + t * BK + wk * KH;  // this warp's first key
    const __nv_bfloat16* tk = sk + (t % kStages) * BK * LD + wk * KH * LD;
    const __nv_bfloat16* tv = sv + (t % kStages) * BK * LD + wk * KH * LD;
    // a warp whose keys are all masked for all its rows skips the tile
    bool live = k0 < Skv && rmin < Sq;
    if (causal) live = live && k0 <= rmax;
    if (window > 0) live = live && rmin - (k0 + KH - 1) < window;
    if (live) {
      // S = Q K^T for this warp's 16 rows and KH keys
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DMAX / 16; ++kc) {  // pad columns are zero
        uint32_t a[4];
        ldsm_x4(a, sq + (wr * 16 + (lane & 15)) * LD + kc * 16 +
                       ((lane >> 4) << 3));
#pragma unroll
        for (int jn = 0; jn < KH / 16; ++jn) {
          uint32_t bb[4];
          ldsm_x4(bb, tk + (jn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kc * 16 + (((lane >> 3) & 1) << 3));
          mma16816(s[2 * jn], a, bb[0], bb[1]);
          mma16816(s[2 * jn + 1], a, bb[2], bb[3]);
        }
      }

      // scale into the log2 domain in fp32; mask only where some key of
      // this warp's slice is masked for some row.  Element (j, e) holds
      // row row0 + 8 (e >> 1) and key kl + 8 j + (e & 1).
      bool edge = k0 + KH > Skv;
      if (causal) edge = edge || k0 + KH - 1 > rmin;
      if (window > 0) edge = edge || rmax - k0 >= window;
      const int kl = k0 + ((lane & 3) << 1);
      const int room = Skv - kl, dq0 = row0 - kl;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * c2;
          if (edge) {
            const int dk = 8 * j + (e & 1);
            const int dq = dq0 + 8 * (e >> 1) - dk;   // qi - ki
            const bool ok = dk < room && (!causal || dq >= 0) &&
                            (window <= 0 || dq < window);
            x = ok ? x : kNegInf;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      // a row that has seen only masked keys keeps m = NEG_INF; its
      // exponents are taken against 0 so that a masked key's 2^(s - m)
      // is 2^(-1e30) = 0, never 2^0 = 1
      float alpha[2], mb[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mb[i] = mx[i] == kNegInf ? 0.f : mx[i];
        alpha[i] = ex2(m[i] - mb[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

      // per 16 keys: P = 2^(s - m), then O += P V with P as two bf16
      // operands (hi + lo) into one fp32 sum; the exponentials of the next
      // 16 keys can issue while these products run on the tensor cores
#pragma unroll
      for (int kc = 0; kc < KH / 16; ++kc) {
#pragma unroll
        for (int j = 2 * kc; j < 2 * kc + 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(s[j][e] - mb[e >> 1]);
            s[j][e] = p;
            sum[e >> 1] += p;
          }
        }
        uint32_t ph[4], pl[4];
        split_bf16x2(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
        split_bf16x2(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
        split_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
        split_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int jd = 0; jd < DMAX / 16; ++jd) {
          uint32_t bb[4];
          ldsm_x4_t(bb, tv + (kc * 16 + (lane & 7) +
                              (((lane >> 3) & 1) << 3)) * LD +
                            jd * 16 + ((lane >> 4) << 3));
          mma16816(acc[2 * jd], ph, bb[0], bb[1]);
          mma16816(acc[2 * jd + 1], ph, bb[2], bb[3]);
          mma16816(acc[2 * jd], pl, bb[0], bb[1]);
          mma16816(acc[2 * jd + 1], pl, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is past the tiles (and the pad zeroing)

  // the key splits of each row group meet: splits 1.. hand their (m, l,
  // acc) to split 0 through shared memory (the drained K/V stages)
  constexpr int XW = 4 + 4 * DT;      // floats per lane and split
  float* xch = reinterpret_cast<float*>(sk);  // [RG][KS - 1][XW][32]
  if (wk > 0) {
    float* mine = xch + ((wr * (KS - 1) + wk - 1) * XW) * 32 + lane;
    mine[0] = m[0];
    mine[32] = m[1];
    mine[64] = l[0];
    mine[96] = l[1];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 + j * 4 + e) * 32] = acc[j][e];
  }
  __syncthreads();
  if (wk > 0) return;
  const float* theirs = xch + (wr * (KS - 1) * XW) * 32 + lane;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mm = m[i];
#pragma unroll
    for (int w = 0; w < KS - 1; ++w) mm = fmaxf(mm, theirs[(w * XW + i) * 32]);
    // every split NEG_INF: weights 1, with l = 0 and acc = 0
    const float a0 = exp2f(m[i] - mm);
    float ll = l[i] * a0;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][2 * i] *= a0;
      acc[j][2 * i + 1] *= a0;
    }
#pragma unroll
    for (int w = 0; w < KS - 1; ++w) {
      const float* o = theirs + w * XW * 32;
      const float a = exp2f(o[i * 32] - mm);
      ll += o[(2 + i) * 32] * a;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][2 * i] += o[(4 + j * 4 + 2 * i) * 32] * a;
        acc[j][2 * i + 1] += o[(4 + j * 4 + 2 * i + 1) * 32] * a;
      }
    }
    inv[i] = 1.f / (ll == 0.f ? 1.f : ll);   // a row with no key writes 0
    // the natural-log lse of the merged row: (mm + log2 ll) · ln 2
    const int qi = row0 + i * 8;
    if (kLse && (lane & 3) == 0 && qi < Sq)
      lse[(static_cast<size_t>(b) * H + h) * Sq + qi] =
          ll == 0.f ? lse_none() : (mm + log2f(ll)) * 0.6931471805599453f;
  }

  // out = acc / l, rounded once to bf16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + i * 8;
    if (qi >= Sq) continue;
    __nv_bfloat16* orow =
        out + ((static_cast<size_t>(b) * H + h) * Sq + qi) * D;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = j * 8 + ((lane & 3) << 1);
      if (d >= D) continue;
      const float o0 = acc[j][2 * i] * inv[i];
      const float o1 = acc[j][2 * i + 1] * inv[i];
      if (d + 1 < D && (D & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(o0, o1);
      } else {
        orow[d] = __float2bfloat16(o0);
        if (d + 1 < D) orow[d + 1] = __float2bfloat16(o1);
      }
    }
  }
}

template <int DMAX, int BK>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int KVH, int Sq, int Skv, int D,
           int causal, int window, cudaStream_t stream) {
  constexpr int LD = DMAX + kPad;
  const size_t smem = sizeof(__nv_bfloat16) * (BQ + 2 * kStages * BK) * LD;
  static_assert(sizeof(__nv_bfloat16) * 2 * kStages * BK * LD >=
                    sizeof(float) * RG * (KS - 1) * (4 + DMAX / 2) * 32,
                "the K/V stages hold the key splits' exchange");
  auto kern = lse != nullptr ? flash_tc_kernel<DMAX, BK, true>
                              : flash_tc_kernel<DMAX, BK, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int async = D % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  const dim3 grid(H, (Sq + BQ - 1) / BQ, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, H, KVH, Sq, Skv, D, causal, window,
      1.0f / sqrtf(static_cast<float>(D)), async);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int H, int KVH, int Sq, int Skv, int D,
             int causal, int window, cudaStream_t s) {
  if (D <= 32) return launch<32, 128>(q, k, v, out, lse, B, H, KVH, Sq, Skv,
                                      D, causal, window, s);
  if (D <= 64) return launch<64, 128>(q, k, v, out, lse, B, H, KVH, Sq, Skv,
                                      D, causal, window, s);
  if (D <= 128) return launch<128, 64>(q, k, v, out, lse, B, H, KVH, Sq, Skv,
                                       D, causal, window, s);
  return launch<256, 32>(q, k, v, out, lse, B, H, KVH, Sq, Skv, D, causal,
                         window, s);
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor cores); q, k, v
// and out share it.  lse: null, or fp32 [B, H, Sq] to receive each row's
// logsumexp (natural log) for the backward
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, int B, int H, int KVH,
                               int Sq, int Skv, int D, int causal, int window,
                               int dtype, void* stream) {
  if (D < 1 || D > 256 || KVH < 1 || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return scalar::dispatch(q, k, v, out, l, B, H, KVH, Sq, Skv, D, causal,
                            window, s);
  if (dtype == 1)
    return tc::dispatch(q, k, v, out, l, B, H, KVH, Sq, Skv, D, causal,
                        window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

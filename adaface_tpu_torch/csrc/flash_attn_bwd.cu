// Flash-attention backward for Hopper (sm_90a), bf16, plain CUDA C++.
//
// Replaces `_flash_bwd` of adaface_tpu/ops/attention.py (:384-447), the XLA
// backward of both Pallas forward kernels (_flash_t_kernel, _flash_kernel):
// for out = softmax(s) v with s = scale q k^T (+ key mask, + causal rule)
//     p  = softmax(s);  dv = p^T g;  dp = g v^T;  delta = rowsum(g o out)
//     ds = p o (dp - delta);  dq = scale ds k;  dk = scale ds^T q
// recomputed tile by tile from q, k, v, out and g: no [Sq, Sk] tensor is
// ever stored. Tensors are read at their strides (the forward writes `out`
// as [B, S, H, D] memory under a [B, H, S, D] view, and the gradients that
// reach it arrive the same way); dq, dk, dv are written at the strides the
// caller gives.
//
// Shapes on the UNet's training path (bf16, H = 8, B = batch x teacher steps
// = 8, 12 or 16): self-attention (Sq, Sk, D) = (4096, 4096, 40),
// (1024, 1024, 80), (256, 256, 160); cross-attention the same Sq with
// Sk = 77.
//
// What bounds it: operations. Five products of 2 Sq Sk D each (S = q k^T,
// dp = g v^T, dv, dk, dq) plus the recompute of the row statistics (a sixth,
// q k^T again), at B 16, S 4096, D 40 some 1.03 TFLOP with D padded to 48,
// against the card's 989 TFLOP/s. Three launches:
//   flash_bwd_prep  a block per (b h, 64 query rows): the rows' softmax
//       statistics over all keys (running maximum m in log2 units with the
//       scale folded in, and 1/l), and delta = sum_d g o out. m and 1/l are
//       kept apart rather than as one log-sum-exp: a row whose keys are all
//       masked has every logit at -1e30, where m + log2(l) rounds back to
//       -1e30 and exp2(x - lse) would give 1 instead of 1/Sk.
//   flash_bwd_dkdv  a block per (b h, 64 keys[, head-dim slice]), looping
//       over query tiles: p^T = exp2(scale log2e k q^T - m) / l and
//       dp^T = v g^T for its 64 keys and 64 queries, then dv += p^T g and
//       dk += ds^T q accumulated in registers.
//   flash_bwd_dq    a block per (b h, 64 queries), looping over key tiles:
//       dq += ds k in registers.
// The design, in every kernel: four warps, 16 rows each; mma.sync m16n8k16
// bf16 with fp32 accumulation (fragments by ldmatrix from shared memory,
// rows padded by 16 bytes so the eight rows of an ldmatrix fall on distinct
// banks); the head dim padded with zeros to a multiple of 16 (40 -> 48);
// the tiles the loop walks over in a ring of two stages filled by 16-byte
// cp.async copies, tile t + 1 loading while tile t computes. p and ds go
// from the accumulators of one product straight into the A fragments of the
// next (the m16n8 C layout of two neighbouring n-tiles is the m16k16 A
// layout), rounded to bf16 as the forward rounds p. At D = 160 the dk, dv
// accumulators of 64 keys would not fit the registers next to p and dp, so
// the keys' blocks are cut in two head-dim slices that each recompute p and
// dp. No atomics: dq, dk and dv each have one writer, so two runs give the
// same bits.
//
// Masking follows the forward kernels and the JAX backward: a key with
// kv_mask <= 0, or one the causal rule (key <= row + Sk - Sq) excludes,
// takes the logit -1e30; keys past Sk and query rows past Sq take no part.
//
// Entry points: flash_bwd_prep(), flash_bwd_dkdv() and flash_bwd_dq(),
// plain C functions that take device pointers, element strides and the
// stream; they launch on that stream, allocate nothing and return
// cudaGetLastError(). Head dims 40, 48 (any D of 33..48), 80 (65..80) and
// 160 (145..160) have instances; the wrapper refuses others.

#include "flash_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // rows of a block (queries or keys), and of a tile it loops over
constexpr int kThreads = 128;

struct BwdParams {
  const bf16 *q, *k, *v, *o, *g;
  const float* mask;  // [B, Sk] or null
  bf16 *dq, *dk, *dv;
  float *m, *inv_l, *delta;  // [B, H, Sq]
  // element strides (batch, head, sequence): q k v o g dq dk dv
  int64_t st[8][3];
  int h, sq, sk, d, causal, vec16;
  float scale, scale_log2;
};

enum { Q, K, V, O, G, DQ, DK, DV };

// (b, h)'s rows of one of the eight tensors
template <typename T>
__device__ __forceinline__ T* at(const BwdParams& p, T* base, int which, int64_t b, int64_t hh) {
  return base + b * p.st[which][0] + hh * p.st[which][1];
}

// acc[8][4] = A (the warp's 16 rows of `a`) . B^T (the 64 rows of `b`), both
// [rows][STR] bf16 in shared memory, over KS k-steps of 16 columns.
template <int KS, int STR>
__device__ __forceinline__ void rows_by_rows(float (&acc)[8][4], const bf16* a, const bf16* b,
                                             int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bf16* a_lane = a + ((lane & 7) + ((lane >> 3) & 1) * 8) * STR + (lane >> 4) * 8;
  const bf16* b_lane = b + ((lane & 7) + (lane >> 4) * 8) * STR + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint32_t af[4];
    ldmatrix_x4(af, a_lane + s * 16);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, b_lane + np * 16 * STR + s * 16);
      mma_bf16_16816(acc[2 * np], af, bfr[0], bfr[1]);
      mma_bf16_16816(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// The accumulators of a 16 x 64 product as the A fragments of four 16 x 16
// k-steps, rounded to bf16.
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a[s][0] = pack_bf16(c[2 * s][0], c[2 * s][1]);
    a[s][1] = pack_bf16(c[2 * s][2], c[2 * s][3]);
    a[s][2] = pack_bf16(c[2 * s + 1][0], c[2 * s + 1][1]);
    a[s][3] = pack_bf16(c[2 * s + 1][2], c[2 * s + 1][3]);
  }
}

// acc[NT][4] += A (16 x 64, fragments) . B (64 rows of `b` [rows][STR],
// columns c0 .. c0 + 8 NT - 1).
template <int NT, int STR>
__device__ __forceinline__ void frags_by_rows(float (&acc)[NT][4], const uint32_t (&a)[4][4],
                                              const bf16* b, int c0, int lane) {
  const bf16* b_lane = b + (lane & 15) * STR + c0 + (lane >> 4) * 8;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, b_lane + s * 16 * STR + np * 16);
      mma_bf16_16816(acc[2 * np], a[s], bfr[0], bfr[1]);
      mma_bf16_16816(acc[2 * np + 1], a[s], bfr[2], bfr[3]);
    }
  }
}

// Rows [r0, r0 + 16) of a [16][8 NT] fp32 accumulator, times `mult`, into
// bf16 `dst` rows (row stride `rs`), columns c0 + ..., those below `rows`
// and `d` only.
template <int NT>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t rs, const float (&acc)[NT][4],
                                           int r0, int rows, int c0, int d, float mult,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + (e >> 1) * 8;
      const int c = c0 + n * 8 + 2 * t + (e & 1);
      if (r < rows && c < d) dst[(int64_t)r * rs + c] = __float2bfloat16(acc[n][e] * mult);
    }
  }
}

template <int KS>
struct Shape {
  static constexpr int DP = 16 * KS;  // padded head dim
  static constexpr int STR = DP + 8;  // shared-memory row stride, elements
  static constexpr int TILE = kRows * STR;
};

// ---------------------------------------------------------------------------
// prep: m, 1/l and delta of 64 query rows
// ---------------------------------------------------------------------------

template <int KS>
__global__ void __launch_bounds__(kThreads) flash_bwd_prep_kernel(const BwdParams p) {
  using S = Shape<KS>;
  constexpr int DP = S::DP, STR = S::STR;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [64][STR]
  bf16* ks = qs + S::TILE;                         // [2][64][STR]
  float* ms = reinterpret_cast<float*>(ks + 2 * S::TILE);  // [2][64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.y, b = bh / p.h, hh = bh % p.h;
  const int row0 = blockIdx.x * kRows;
  const bf16* k = at(p, p.k, K, b, hh);
  const float* mask = p.mask ? p.mask + b * p.sk : nullptr;
  const int ntiles = (p.sk + kRows - 1) / kRows;
  const bool vec16 = p.vec16 != 0;

  auto load_tile = [&](int i) {
    const int t0 = i * kRows;
    stage_rows<DP, STR, kRows, kThreads>(ks + (i & 1) * S::TILE, k + (int64_t)t0 * p.st[K][2],
                                         p.st[K][2], p.sk - t0, p.d, vec16);
    if (threadIdx.x < kRows) {
      const int j = t0 + threadIdx.x;
      ms[(i & 1) * kRows + threadIdx.x] = (mask != nullptr && j < p.sk) ? mask[j] : 1.f;
    }
  };
  stage_rows<DP, STR, kRows, kThreads>(qs, at(p, p.q, Q, b, hh) + (int64_t)row0 * p.st[Q][2],
                                       p.st[Q][2], p.sq - row0, p.d, vec16);
  load_tile(0);
  cp_async_commit();

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int i0 = row0 + warp * 16 + g, i1 = i0 + 8;
  const int off = p.sk - p.sq;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < ntiles) load_tile(i + 1);
    cp_async_commit();
    const int t0 = i * kRows;
    const float* mst = ms + (i & 1) * kRows;
    float acc[8][4];
    rows_by_rows<KS, STR>(acc, qs + warp * 16 * STR, ks + (i & 1) * S::TILE, lane);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = n * 8 + 2 * t + (e & 1), j = t0 + jl;
        float x = acc[n][e] * p.scale_log2;
        if (j >= p.sk)
          x = -INFINITY;
        else if (mst[jl] <= 0.f || (p.causal && j > (e < 2 ? i0 : i1) + off))
          x = kNegInf;
        acc[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: key 0 is real
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s0 += fast_exp2(acc[n][0] - mn0) + fast_exp2(acc[n][1] - mn0);
      s1 += fast_exp2(acc[n][2] - mn1) + fast_exp2(acc[n][3] - mn1);
    }
    l0 = l0 * fast_exp2(m0 - mn0) + s0;
    l1 = l1 * fast_exp2(m1 - mn1) + s1;
    m0 = mn0;
    m1 = mn1;
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int64_t rbase = bh * p.sq;
  if (t == 0) {
    if (i0 < p.sq) {
      p.m[rbase + i0] = m0;
      p.inv_l[rbase + i0] = 1.f / l0;
    }
    if (i1 < p.sq) {
      p.m[rbase + i1] = m1;
      p.inv_l[rbase + i1] = 1.f / l1;
    }
  }
  // delta = sum_d g o out: two threads a row, halves summed by shuffle
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = row0 + r;
  float dl = 0.f;
  if (row < p.sq) {
    const bf16* gr = at(p, p.g, G, b, hh) + (int64_t)row * p.st[G][2];
    const bf16* orow = at(p, p.o, O, b, hh) + (int64_t)row * p.st[O][2];
    for (int c = half; c < p.d; c += 2) dl += __bfloat162float(gr[c]) * __bfloat162float(orow[c]);
  }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  if (half == 0 && row < p.sq) p.delta[rbase + row] = dl;
}

// ---------------------------------------------------------------------------
// dk, dv of 64 keys (one head-dim slice of NO n-tiles)
// ---------------------------------------------------------------------------

template <int KS, int NO>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const BwdParams p) {
  using S = Shape<KS>;
  constexpr int DP = S::DP, STR = S::STR;
  constexpr int SLICES = DP / (8 * NO);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][STR]
  bf16* vs = ks + S::TILE;                        // [64][STR]
  bf16* qg = vs + S::TILE;                        // [2 stages][q, g][64][STR]
  float* rs = reinterpret_cast<float*>(qg + 4 * S::TILE);  // [2 stages][m, 1/l, delta][64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.y, b = bh / p.h, hh = bh % p.h;
  const int key0 = (blockIdx.x / SLICES) * kRows;
  const int c0 = (blockIdx.x % SLICES) * 8 * NO;
  const bf16* q = at(p, p.q, Q, b, hh);
  const bf16* gg = at(p, p.g, G, b, hh);
  const int64_t rbase = bh * p.sq;
  const int nq = (p.sq + kRows - 1) / kRows;
  const bool vec16 = p.vec16 != 0;

  stage_rows<DP, STR, kRows, kThreads>(ks, at(p, p.k, K, b, hh) + (int64_t)key0 * p.st[K][2],
                                       p.st[K][2], p.sk - key0, p.d, vec16);
  stage_rows<DP, STR, kRows, kThreads>(vs, at(p, p.v, V, b, hh) + (int64_t)key0 * p.st[V][2],
                                       p.st[V][2], p.sk - key0, p.d, vec16);
  auto load_tile = [&](int i) {
    const int r0 = i * kRows;
    bf16* st = qg + (i & 1) * 2 * S::TILE;
    stage_rows<DP, STR, kRows, kThreads>(st, q + (int64_t)r0 * p.st[Q][2], p.st[Q][2],
                                         p.sq - r0, p.d, vec16);
    stage_rows<DP, STR, kRows, kThreads>(st + S::TILE, gg + (int64_t)r0 * p.st[G][2],
                                         p.st[G][2], p.sq - r0, p.d, vec16);
    if (threadIdx.x < kRows) {
      // rows past Sq: 1/l = 0, so their p is 0 and they add nothing
      const int i_ = r0 + threadIdx.x;
      const bool ok = i_ < p.sq;
      float* r = rs + (i & 1) * 3 * kRows + threadIdx.x;
      r[0] = ok ? p.m[rbase + i_] : 0.f;
      r[kRows] = ok ? p.inv_l[rbase + i_] : 0.f;
      r[2 * kRows] = ok ? p.delta[rbase + i_] : 0.f;
    }
  };
  load_tile(0);
  cp_async_commit();

  // this thread's two keys: their validity and mask never change
  const int j0 = key0 + warp * 16 + g, j1 = j0 + 8;
  const bool in0 = j0 < p.sk, in1 = j1 < p.sk;
  const bool mk0 = in0 && p.mask != nullptr && p.mask[b * p.sk + j0] <= 0.f;
  const bool mk1 = in1 && p.mask != nullptr && p.mask[b * p.sk + j1] <= 0.f;
  const int off = p.sk - p.sq;

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = 0; i < nq; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < nq) load_tile(i + 1);
    cp_async_commit();
    const bf16* qst = qg + (i & 1) * 2 * S::TILE;
    const bf16* gst = qst + S::TILE;
    const float* rst = rs + (i & 1) * 3 * kRows;
    const int r0 = i * kRows;
    float sp[8][4], dp[8][4];
    rows_by_rows<KS, STR>(sp, ks + warp * 16 * STR, qst, lane);  // s^T: keys x queries
    rows_by_rows<KS, STR>(dp, vs + warp * 16 * STR, gst, lane);  // dp^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = n * 8 + 2 * t + (e & 1);
        const bool hi = e >= 2;
        float pr = 0.f;
        if (hi ? in1 : in0) {
          float x = sp[n][e] * p.scale_log2;
          if ((hi ? mk1 : mk0) || (p.causal && (hi ? j1 : j0) > r0 + il + off)) x = kNegInf;
          pr = fast_exp2(x - rst[il]) * rst[kRows + il];
        }
        sp[n][e] = pr;
        dp[n][e] = pr * (dp[n][e] - rst[2 * kRows + il]);
      }
    }
    uint32_t pa[4][4], da[4][4];
    to_a_frags(pa, sp);
    to_a_frags(da, dp);
    frags_by_rows<NO, STR>(dv, pa, gst, c0, lane);
    frags_by_rows<NO, STR>(dk, da, qst, c0, lane);
  }
  store_rows<NO>(at(p, p.dk, DK, b, hh), p.st[DK][2], dk, key0 + warp * 16, p.sk, c0, p.d,
                 p.scale, lane);
  store_rows<NO>(at(p, p.dv, DV, b, hh), p.st[DV][2], dv, key0 + warp * 16, p.sk, c0, p.d, 1.f,
                 lane);
}

// ---------------------------------------------------------------------------
// dq of 64 queries
// ---------------------------------------------------------------------------

template <int KS>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  using S = Shape<KS>;
  constexpr int DP = S::DP, STR = S::STR, NT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][STR]
  bf16* gs = qs + S::TILE;                        // [64][STR]
  bf16* kv = gs + S::TILE;                        // [2 stages][k, v][64][STR]
  float* ms = reinterpret_cast<float*>(kv + 4 * S::TILE);  // [2][64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.y, b = bh / p.h, hh = bh % p.h;
  const int row0 = blockIdx.x * kRows;
  const bf16* k = at(p, p.k, K, b, hh);
  const bf16* v = at(p, p.v, V, b, hh);
  const float* mask = p.mask ? p.mask + b * p.sk : nullptr;
  const int ntiles = (p.sk + kRows - 1) / kRows;
  const bool vec16 = p.vec16 != 0;

  stage_rows<DP, STR, kRows, kThreads>(qs, at(p, p.q, Q, b, hh) + (int64_t)row0 * p.st[Q][2],
                                       p.st[Q][2], p.sq - row0, p.d, vec16);
  stage_rows<DP, STR, kRows, kThreads>(gs, at(p, p.g, G, b, hh) + (int64_t)row0 * p.st[G][2],
                                       p.st[G][2], p.sq - row0, p.d, vec16);
  auto load_tile = [&](int i) {
    const int t0 = i * kRows;
    bf16* st = kv + (i & 1) * 2 * S::TILE;
    stage_rows<DP, STR, kRows, kThreads>(st, k + (int64_t)t0 * p.st[K][2], p.st[K][2],
                                         p.sk - t0, p.d, vec16);
    stage_rows<DP, STR, kRows, kThreads>(st + S::TILE, v + (int64_t)t0 * p.st[V][2],
                                         p.st[V][2], p.sk - t0, p.d, vec16);
    if (threadIdx.x < kRows) {
      const int j = t0 + threadIdx.x;
      ms[(i & 1) * kRows + threadIdx.x] = (mask != nullptr && j < p.sk) ? mask[j] : 1.f;
    }
  };
  load_tile(0);
  cp_async_commit();

  const int64_t rbase = bh * p.sq;
  const int i0 = row0 + warp * 16 + g, i1 = i0 + 8;
  const float m0 = i0 < p.sq ? p.m[rbase + i0] : 0.f, m1 = i1 < p.sq ? p.m[rbase + i1] : 0.f;
  const float il0 = i0 < p.sq ? p.inv_l[rbase + i0] : 0.f;
  const float il1 = i1 < p.sq ? p.inv_l[rbase + i1] : 0.f;
  const float dl0 = i0 < p.sq ? p.delta[rbase + i0] : 0.f;
  const float dl1 = i1 < p.sq ? p.delta[rbase + i1] : 0.f;
  const int off = p.sk - p.sq;

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < ntiles) load_tile(i + 1);
    cp_async_commit();
    const bf16* kst = kv + (i & 1) * 2 * S::TILE;
    const bf16* vst = kst + S::TILE;
    const float* mst = ms + (i & 1) * kRows;
    const int t0 = i * kRows;
    float sp[8][4], dp[8][4];
    rows_by_rows<KS, STR>(sp, qs + warp * 16 * STR, kst, lane);
    rows_by_rows<KS, STR>(dp, gs + warp * 16 * STR, vst, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = n * 8 + 2 * t + (e & 1), j = t0 + jl;
        const bool hi = e >= 2;
        float pr = 0.f;
        if (j < p.sk) {
          float x = sp[n][e] * p.scale_log2;
          if (mst[jl] <= 0.f || (p.causal && j > (hi ? i1 : i0) + off)) x = kNegInf;
          pr = fast_exp2(x - (hi ? m1 : m0)) * (hi ? il1 : il0);
        }
        dp[n][e] = pr * (dp[n][e] - (hi ? dl1 : dl0));
      }
    }
    uint32_t da[4][4];
    to_a_frags(da, dp);
    frags_by_rows<NT, STR>(dq, da, kst, 0, lane);
  }
  store_rows<NT>(at(p, p.dq, DQ, b, hh), p.st[DQ][2], dq, row0 + warp * 16, p.sq, 0, p.d,
                 p.scale, lane);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int KS>
constexpr size_t prep_smem() {
  return sizeof(bf16) * 3 * Shape<KS>::TILE + sizeof(float) * 2 * kRows;
}
template <int KS>
constexpr size_t dkdv_smem() {
  return sizeof(bf16) * 6 * Shape<KS>::TILE + sizeof(float) * 6 * kRows;
}
template <int KS>
constexpr size_t dq_smem() {
  return sizeof(bf16) * 6 * Shape<KS>::TILE + sizeof(float) * 2 * kRows;
}

// The block's shared memory is raised above the 48 KB default once per
// kernel, at its first launch.
template <auto Kernel, size_t Smem>
cudaError_t launch(dim3 grid, const BwdParams& p, cudaStream_t s) {
  static const cudaError_t set =
      Smem > 48 * 1024
          ? cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem)
          : cudaSuccess;
  if (set != cudaSuccess) return set;
  Kernel<<<grid, kThreads, Smem, s>>>(p);
  return cudaGetLastError();
}

// the instance a head dim takes: ceil(D / 16) in {3, 5, 10}, else 0
int ksteps(int d) {
  const int ks = (d + 15) / 16;
  return (ks == 3 || ks == 5 || ks == 10) ? ks : 0;
}

bool fill(BwdParams& p, const void* q, const void* k, const void* v, const void* o,
          const void* g, const float* mask, void* dq, void* dk, void* dv, float* stats,
          const int64_t* strides, int b, int h, int sq, int sk, int d, int causal, float scale) {
  if (b < 1 || h < 1 || (int64_t)b * h > 65535 || sq < 1 || sk < 1 || !ksteps(d)) return false;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(o);
  p.g = static_cast<const bf16*>(g);
  p.mask = mask;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  const int64_t rows = (int64_t)b * h * sq;
  p.m = stats;
  p.inv_l = stats + rows;
  p.delta = stats + 2 * rows;
  bool vec16 = d % 8 == 0;
  const void* in[5] = {q, k, v, o, g};
  for (int i = 0; i < 5; ++i) vec16 = vec16 && reinterpret_cast<uintptr_t>(in[i]) % 16 == 0;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) {
      p.st[i][j] = strides[3 * i + j];
      if (i < 5) vec16 = vec16 && (p.st[i][j] * 2) % 16 == 0;
    }
  p.vec16 = vec16;
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return true;
}

}  // namespace

#define FLASH_BWD_ARGS                                                                     \
  const void *q, const void *k, const void *v, const void *o, const void *g,              \
      const float *mask, void *dq, void *dk, void *dv, float *stats, const int64_t *strides, \
      int b, int h, int sq, int sk, int d, int causal, float scale, void *stream
#define FLASH_BWD_FILL                                                                      \
  BwdParams p;                                                                              \
  if (!fill(p, q, k, v, o, g, mask, dq, dk, dv, stats, strides, b, h, sq, sk, d, causal,    \
            scale))                                                                         \
    return (int)cudaErrorInvalidValue;                                                      \
  cudaStream_t s = static_cast<cudaStream_t>(stream)

// All three take the same arguments: q, k, v, out, g [B, H, S, D] bf16 at
// `strides` (24 element strides: batch, head, sequence of q, k, v, out, g,
// dq, dk, dv), the key mask [B, Sk] fp32 or null, dq, dk, dv bf16 out,
// stats [3, B, H, Sq] fp32 (m, 1/l, delta: written by flash_bwd_prep, read
// by the other two).
extern "C" int flash_bwd_prep(FLASH_BWD_ARGS) {
  FLASH_BWD_FILL;
  const dim3 grid((sq + kRows - 1) / kRows, b * h);
  switch (ksteps(d)) {
    case 3: return (int)launch<flash_bwd_prep_kernel<3>, prep_smem<3>()>(grid, p, s);
    case 5: return (int)launch<flash_bwd_prep_kernel<5>, prep_smem<5>()>(grid, p, s);
    default: return (int)launch<flash_bwd_prep_kernel<10>, prep_smem<10>()>(grid, p, s);
  }
}

extern "C" int flash_bwd_dkdv(FLASH_BWD_ARGS) {
  FLASH_BWD_FILL;
  const int tiles = (sk + kRows - 1) / kRows;
  switch (ksteps(d)) {
    case 3: return (int)launch<flash_bwd_dkdv_kernel<3, 6>, dkdv_smem<3>()>(dim3(tiles, b * h), p, s);
    case 5:
      return (int)launch<flash_bwd_dkdv_kernel<5, 10>, dkdv_smem<5>()>(dim3(tiles, b * h), p, s);
    default:  // D = 160: two head-dim slices of 80
      return (int)launch<flash_bwd_dkdv_kernel<10, 10>, dkdv_smem<10>()>(dim3(2 * tiles, b * h),
                                                                         p, s);
  }
}

extern "C" int flash_bwd_dq(FLASH_BWD_ARGS) {
  FLASH_BWD_FILL;
  const dim3 grid((sq + kRows - 1) / kRows, b * h);
  switch (ksteps(d)) {
    case 3: return (int)launch<flash_bwd_dq_kernel<3>, dq_smem<3>()>(grid, p, s);
    case 5: return (int)launch<flash_bwd_dq_kernel<5>, dq_smem<5>()>(grid, p, s);
    default: return (int)launch<flash_bwd_dq_kernel<10>, dq_smem<10>()>(grid, p, s);
  }
}

// Flash-attention backward for Hopper (sm_90a), bf16, plain CUDA C++, at the
// VAE's head dim 512 (497..512). The UNet's head dims (40, 80, 160) take the
// wgmma kernels of flash_attn_bwd_wg.cu.
//
// Replaces `_flash_bwd` of adaface_tpu/ops/attention.py (:384-447), the XLA
// backward of the Pallas forward kernel _flash_kernel at that head dim:
// for out = softmax(s) v with s = scale q k^T (+ key mask, + causal rule)
//     p  = softmax(s);  dv = p^T g;  dp = g v^T;  delta = rowsum(g o out)
//     ds = p o (dp - delta);  dq = scale ds k;  dk = scale ds^T q
// recomputed tile by tile from q, k, v, out and g: no [Sq, Sk] tensor is
// ever stored. Tensors are read at their strides; dq, dk, dv are written at
// the strides the caller gives. The VAE's mid-block attention (B 2, H 1,
// S 4096, all three gradients) is the one caller on the path; the VAE's
// forward goes through the wide kernel (flash_attn_wide.cu), which keeps no
// row statistics, so they are rebuilt here.
//
// What bounds it: operations, five products of 2 Sq Sk D each, plus the
// recompute of the row statistics (a sixth). Three launches:
//   flash_bwd_prep  a block per (b h, 64 query rows), four warps of 16 rows,
//       mma.sync m16n8k16: the rows' softmax statistics over all keys
//       (running maximum m in log2 units with the scale folded in, and 1/l),
//       and delta = sum_d g o out. m and 1/l are kept apart rather than as
//       one log-sum-exp: a row whose keys are all masked has every logit at
//       -1e30, where m + log2(l) rounds back to -1e30 and exp2(x - lse) would
//       give 1 instead of 1/Sk. A 64-row tile is 64 KB: three fit a block.
//   flash_bwd_dkdv_wide, flash_bwd_dq_wide  the wide kernel further down:
//       16 own rows a block, the head dim over 8 warps.
// The tiles the loops walk over come in a ring of two stages filled by
// 16-byte cp.async copies, tile t + 1 loading while tile t computes. No
// atomics: dq, dk and dv each have one writer, so two runs give the same bits.
//
// Masking follows the forward kernels and the JAX backward: a key with
// kv_mask <= 0, or one the causal rule (key <= row + Sk - Sq) excludes,
// takes the logit -1e30; keys past Sk and query rows past Sq take no part.
//
// Entry points: flash_bwd_prep(), flash_bwd_dkdv_wide() and
// flash_bwd_dq_wide(), plain C functions that take device pointers, element
// strides and the stream; they launch on that stream, allocate nothing and
// return cudaGetLastError(). They refuse other head dims.

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

// acc[2 NP][4] = A (the warp's 16 rows of `a`) . B^T (the 16 NP rows of `b`),
// both [rows][STR] bf16 in shared memory, over KS k-steps of 16 columns.
template <int KS, int STR, int NP = 4>
__device__ __forceinline__ void rows_by_rows(float (&acc)[2 * NP][4], const bf16* a,
                                             const bf16* b, int lane) {
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bf16* a_lane = a + ((lane & 7) + ((lane >> 3) & 1) * 8) * STR + (lane >> 4) * 8;
  const bf16* b_lane = b + ((lane & 7) + (lane >> 4) * 8) * STR + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint32_t af[4];
    ldmatrix_x4(af, a_lane + s * 16);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, b_lane + np * 16 * STR + s * 16);
      mma_bf16_16816(acc[2 * np], af, bfr[0], bfr[1]);
      mma_bf16_16816(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// acc[NT][4] += A (16 x 16 KST, fragments) . B (16 KST rows of `b`
// [rows][STR], columns c0 .. c0 + 8 NT - 1).
template <int NT, int STR, int KST = 4>
__device__ __forceinline__ void frags_by_rows(float (&acc)[NT][4], const uint32_t (&a)[KST][4],
                                              const bf16* b, int c0, int lane) {
  const bf16* b_lane = b + (lane & 15) * STR + c0 + (lane >> 4) * 8;
#pragma unroll
  for (int s = 0; s < KST; ++s) {
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
// prep: m, 1/l and delta of 64 query rows (D 512)
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
// D 512: dk, dv of 16 keys, or dq of 16 queries, the head dim over 8 warps
// ---------------------------------------------------------------------------
//
// At D 512 a 64-row tile is 64 KB of shared memory and the dk, dv of 64 keys
// 256 KB of fp32, more than the register file. So a block owns 16 rows (keys
// for dk, dv; queries for dq) and walks over tiles of 32 rows of the other
// side, and each of its 8 warps owns 64 columns of the head dim: of its
// accumulators, and of the two products over D (s and dp), whose partial
// sums the warps add through shared memory. A tile step:
//   1. each warp: its partial s and dp [16 x 32] over its 64 columns
//      (own rows . tile rows^T), into shared memory;
//   2. barrier; each thread adds the 8 partials of 2 elements, masks, and
//      writes p and ds = p (dp - delta) as bf16 (as the UNet's kernels round
//      them);
//   3. barrier; each warp: dv += p^T g, dk += ds^T q (or dq += ds k) on its
//      64 columns, 2 k-steps of 16 tile rows.
// The tiles come in a ring of two stages by cp.async, as above. One writer
// for every output element: no atomics.

constexpr int kWRows = 16;   // own rows of a block
constexpr int kWTile = 32;   // rows of a tile the loop walks over
constexpr int kWWarps = 8;   // one per 64 columns of the head dim
constexpr int kWThreads = 32 * kWWarps;
constexpr int kWDP = 512, kWSTR = kWDP + 8;
constexpr int kWPart = kWTile + 8;  // row stride of the fp32 partials (no bank conflicts)
constexpr int kWPStr = kWTile + 8;  // row stride of the bf16 p and ds tiles

constexpr size_t wide_smem() {
  return sizeof(bf16) * (2 * kWRows + 4 * kWTile) * kWSTR       // own rows, two tile stages
         + sizeof(float) * kWWarps * 2 * kWRows * kWPart        // partial s, dp
         + sizeof(bf16) * 2 * kWRows * kWPStr                   // p, ds
         + sizeof(float) * 256;                                 // row statistics, key mask
}

template <bool DKDV>
__global__ void __launch_bounds__(kWThreads, 1) flash_bwd_wide_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* own = reinterpret_cast<bf16*>(smem_raw);  // [2][16][STR]: k, v (dkdv) or q, g (dq)
  bf16* stg = own + 2 * kWRows * kWSTR;           // [2 stages][2][32][STR]: q, g or k, v
  float* part = reinterpret_cast<float*>(stg + 4 * kWTile * kWSTR);  // [8][s, dp][16][kWPart]
  bf16* pd = reinterpret_cast<bf16*>(part + kWWarps * 2 * kWRows * kWPart);  // [p, ds][16][PStr]
  // dkdv: [2 stages][m, 1/l, delta][32] of the tile's queries, then [16] own keys' mask;
  // dq: [m, 1/l, delta][16] of the own queries, then [2 stages][32] tile keys' mask
  float* rs = reinterpret_cast<float*>(pd + 2 * kWRows * kWPStr);
  float* kmask = rs + (DKDV ? 6 * kWTile : 3 * kWRows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.y, b = bh / p.h, hh = bh % p.h;
  const int own0 = blockIdx.x * kWRows;
  const int n_own = DKDV ? p.sk : p.sq, n_tile = DKDV ? p.sq : p.sk;
  const int c0 = warp * 64;
  const bool vec16 = p.vec16 != 0;
  const int64_t rbase = bh * p.sq;
  const int off = p.sk - p.sq;
  const int o0 = DKDV ? K : Q, o1 = DKDV ? V : G, t0w = DKDV ? Q : K, t1w = DKDV ? G : V;
  const bf16* own_src0 = at(p, DKDV ? p.k : p.q, o0, b, hh);
  const bf16* own_src1 = at(p, DKDV ? p.v : p.g, o1, b, hh);
  const bf16* tile_src0 = at(p, DKDV ? p.q : p.k, t0w, b, hh);
  const bf16* tile_src1 = at(p, DKDV ? p.g : p.v, t1w, b, hh);
  const float* mask = p.mask ? p.mask + b * p.sk : nullptr;

  stage_rows<kWDP, kWSTR, kWRows, kWThreads>(own, own_src0 + (int64_t)own0 * p.st[o0][2],
                                             p.st[o0][2], n_own - own0, p.d, vec16);
  stage_rows<kWDP, kWSTR, kWRows, kWThreads>(own + kWRows * kWSTR,
                                             own_src1 + (int64_t)own0 * p.st[o1][2],
                                             p.st[o1][2], n_own - own0, p.d, vec16);
  if (threadIdx.x < kWRows) {  // read after the loop's first barrier
    const int r = own0 + threadIdx.x;
    if (DKDV) {
      kmask[threadIdx.x] = (mask != nullptr && r < p.sk) ? mask[r] : 1.f;
    } else {
      const bool ok = r < p.sq;
      rs[threadIdx.x] = ok ? p.m[rbase + r] : 0.f;
      rs[kWRows + threadIdx.x] = ok ? p.inv_l[rbase + r] : 0.f;
      rs[2 * kWRows + threadIdx.x] = ok ? p.delta[rbase + r] : 0.f;
    }
  }
  auto load_tile = [&](int i) {
    const int r0 = i * kWTile;
    bf16* st = stg + (i & 1) * 2 * kWTile * kWSTR;
    stage_rows<kWDP, kWSTR, kWTile, kWThreads>(st, tile_src0 + (int64_t)r0 * p.st[t0w][2],
                                               p.st[t0w][2], n_tile - r0, p.d, vec16);
    stage_rows<kWDP, kWSTR, kWTile, kWThreads>(st + kWTile * kWSTR,
                                               tile_src1 + (int64_t)r0 * p.st[t1w][2],
                                               p.st[t1w][2], n_tile - r0, p.d, vec16);
    if (threadIdx.x < kWTile) {
      const int j = r0 + threadIdx.x;
      if (DKDV) {  // queries past Sq: 1/l = 0, so their p is 0
        const bool ok = j < p.sq;
        float* r = rs + (i & 1) * 3 * kWTile + threadIdx.x;
        r[0] = ok ? p.m[rbase + j] : 0.f;
        r[kWTile] = ok ? p.inv_l[rbase + j] : 0.f;
        r[2 * kWTile] = ok ? p.delta[rbase + j] : 0.f;
      } else {
        kmask[(i & 1) * kWTile + threadIdx.x] = (mask != nullptr && j < p.sk) ? mask[j] : 1.f;
      }
    }
  };
  load_tile(0);
  cp_async_commit();

  float acc0[8][4], acc1[8][4];  // dk, dv (dkdv) or dq (acc0)
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[n][e] = acc1[n][e] = 0.f;

  const int ntiles = (n_tile + kWTile - 1) / kWTile;
  // the element pair this thread reduces: own row rr, tile columns cc, cc + 1
  const int rr = threadIdx.x >> 4, cc = 2 * (threadIdx.x & 15);
  float* pw = part + warp * 2 * kWRows * kWPart;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < ntiles) load_tile(i + 1);
    cp_async_commit();
    const bf16* st0 = stg + (i & 1) * 2 * kWTile * kWSTR;
    const bf16* st1 = st0 + kWTile * kWSTR;
    const int r0 = i * kWTile;
    {
      float sp[4][4], dp[4][4];
      rows_by_rows<4, kWSTR, 2>(sp, own + c0, st0 + c0, lane);
      rows_by_rows<4, kWSTR, 2>(dp, own + kWRows * kWSTR + c0, st1 + c0, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int idx = (g + 8 * h2) * kWPart + n * 8 + 2 * t;
          *reinterpret_cast<float2*>(pw + idx) = make_float2(sp[n][2 * h2], sp[n][2 * h2 + 1]);
          *reinterpret_cast<float2*>(pw + kWRows * kWPart + idx) =
              make_float2(dp[n][2 * h2], dp[n][2 * h2 + 1]);
        }
    }
    __syncthreads();
    {
      float s2[2] = {0.f, 0.f}, d2[2] = {0.f, 0.f};
#pragma unroll
      for (int w = 0; w < kWWarps; ++w) {
        const float* pp = part + w * 2 * kWRows * kWPart + rr * kWPart + cc;
        const float2 a = *reinterpret_cast<const float2*>(pp);
        const float2 c = *reinterpret_cast<const float2*>(pp + kWRows * kWPart);
        s2[0] += a.x;
        s2[1] += a.y;
        d2[0] += c.x;
        d2[1] += c.y;
      }
      float pr[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = cc + e;
        // (key j, query q) of this element, the query's statistics, the key's mask
        const int j = DKDV ? own0 + rr : r0 + col, q = DKDV ? r0 + col : own0 + rr;
        const float* st = DKDV ? rs + (i & 1) * 3 * kWTile + col : rs + rr;
        const int sstr = DKDV ? kWTile : kWRows;
        const float km = DKDV ? kmask[rr] : kmask[(i & 1) * kWTile + col];
        pr[e] = 0.f;
        if (j < p.sk) {
          float x = s2[e] * p.scale_log2;
          if (km <= 0.f || (p.causal && j > q + off)) x = kNegInf;
          pr[e] = fast_exp2(x - st[0]) * st[sstr];
        }
        ds[e] = pr[e] * (d2[e] - st[2 * sstr]);
      }
      *reinterpret_cast<uint32_t*>(pd + rr * kWPStr + cc) = pack_bf16(pr[0], pr[1]);
      *reinterpret_cast<uint32_t*>(pd + (kWRows + rr) * kWPStr + cc) = pack_bf16(ds[0], ds[1]);
    }
    __syncthreads();
    const bf16* a_lane = pd + ((lane & 7) + ((lane >> 3) & 1) * 8) * kWPStr + (lane >> 4) * 8;
    uint32_t da[2][4];
    ldmatrix_x4(da[0], a_lane + kWRows * kWPStr);
    ldmatrix_x4(da[1], a_lane + kWRows * kWPStr + 16);
    frags_by_rows<8, kWSTR, 2>(acc0, da, st0, c0, lane);  // dk += ds^T q, or dq += ds k
    if (DKDV) {
      uint32_t pa[2][4];
      ldmatrix_x4(pa[0], a_lane);
      ldmatrix_x4(pa[1], a_lane + 16);
      frags_by_rows<8, kWSTR, 2>(acc1, pa, st1, c0, lane);  // dv += p^T g
    }
  }
  if (DKDV) {
    store_rows<8>(at(p, p.dk, DK, b, hh), p.st[DK][2], acc0, own0, p.sk, c0, p.d, p.scale, lane);
    store_rows<8>(at(p, p.dv, DV, b, hh), p.st[DV][2], acc1, own0, p.sk, c0, p.d, 1.f, lane);
  } else {
    store_rows<8>(at(p, p.dq, DQ, b, hh), p.st[DQ][2], acc0, own0, p.sq, c0, p.d, p.scale, lane);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int KS>
constexpr size_t prep_smem() {
  return sizeof(bf16) * 3 * Shape<KS>::TILE + sizeof(float) * 2 * kRows;
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

// the instance a head dim takes: ceil(D / 16) = 32 (D 497..512), else 0
int ksteps(int d) { return (d + 15) / 16 == 32 ? 32 : 0; }

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
  return (int)launch<flash_bwd_prep_kernel<32>, prep_smem<32>()>(grid, p, s);
}

// D 497..512 (ceil(D / 16) = 32): dk, dv and dq by the wide kernel, after
// flash_bwd_prep. Same arguments as above.
extern "C" int flash_bwd_dkdv_wide(FLASH_BWD_ARGS) {
  FLASH_BWD_FILL;
  if (ksteps(d) != 32) return (int)cudaErrorInvalidValue;
  const dim3 grid((sk + kWRows - 1) / kWRows, b * h);
  static const cudaError_t set = cudaFuncSetAttribute(
      flash_bwd_wide_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wide_smem());
  if (set != cudaSuccess) return (int)set;
  flash_bwd_wide_kernel<true><<<grid, kWThreads, wide_smem(), s>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dq_wide(FLASH_BWD_ARGS) {
  FLASH_BWD_FILL;
  if (ksteps(d) != 32) return (int)cudaErrorInvalidValue;
  const dim3 grid((sq + kWRows - 1) / kWRows, b * h);
  static const cudaError_t set = cudaFuncSetAttribute(
      flash_bwd_wide_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wide_smem());
  if (set != cudaSuccess) return (int)set;
  flash_bwd_wide_kernel<false><<<grid, kWThreads, wide_smem(), s>>>(p);
  return (int)cudaGetLastError();
}

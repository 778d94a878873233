// Flash-attention backward on Hopper's warpgroup matrix unit (wgmma) and
// tensor memory accelerator (TMA): bf16, the SD1.5 UNet's head dims (33..48,
// 65..80 and 145..160: D = 40, 80, 160), rows on 16-byte boundaries. The
// VAE's head dim 512 takes the cluster kernels of flash_attn_bwd.cu after
// the delta kernel here (8 threads a row there).
//
// Replaces `_flash_bwd` of adaface_tpu/ops/attention.py (:384-447), the XLA
// backward of the Pallas forward kernels _flash_t_kernel and _flash_kernel:
// for out = softmax(s) v with s = scale q k^T (+ key mask, + causal rule)
//     p  = softmax(s);  dv = p^T g;  dp = g v^T;  delta = rowsum(g o out)
//     ds = p o (dp - delta);  dq = scale ds k;  dk = scale ds^T q
// recomputed tile by tile: no [Sq, Sk] tensor is stored. Masking as in the
// forward kernels: a key with kv_mask <= 0, or one the causal rule (key <=
// row + Sk - Sq) excludes, takes the logit -1e30; a row whose keys are all
// masked then still gets p = 1/Sk; keys past Sk and rows past Sq take no part.
//
// What bounds it: operations. Five products of 2 Sq Sk D each are the
// function's own (s, dp, dv, dk, dq); at B 16, H 8, S 4096, D 40 (48 padded)
// that is 0.86 TFLOP, 0.87 ms at 989 TFLOP/s. The design:
//   - the rows' softmax statistics come from the forward: the wgmma forward
//     (flash_attn_wgmma.cu) writes each row's m (log2 units, the scale folded
//     in) and 1/l when asked, and autograd keeps them. m and 1/l stay apart,
//     not one log-sum-exp: a row whose keys are all masked has every logit at
//     -1e30, where m + log2(l) rounds back to -1e30 and exp2(x - lse) would
//     give 1 instead of 1/Sk. The prep kernel that rebuilt them with a product
//     over all keys is gone; what is left of it is flash_bwd_delta, delta =
//     sum_d g o out, a pass bound by bytes;
//   - flash_bwd_dkdv_wg: a warpgroup owns 64 keys, its K and V tiles in
//     shared memory for the whole loop over query tiles. A tile step is four
//     products: S^T = K Q^T and dP^T = V g^T (both operands read from shared
//     memory by descriptor), so that the accumulators' rows are keys; then
//     P^T = exp2(S^T scale log2e - m) / l and dS^T = P^T o (dP^T - delta),
//     rounded to bf16 and taken straight from the accumulators' registers as
//     the A operand of dV += P^T g and dK += dS^T Q, where Q and g are read
//     as MN-major B from the same tiles that served as K-major B. The block's
//     key mask is read once; a block with no masked key (and no causal rule)
//     skips masking;
//   - flash_bwd_dq_wg: a warpgroup owns 64 queries, Q and g staged once, and
//     loops over key tiles: S = Q K^T, dP = g V^T, then dQ += dS K with K as
//     MN-major B. Three products a tile. dq, dk and dv each have one writer,
//     so two runs give the same bits (no float atomics);
//   - products a (64 key x 64 query) tile, over the three launches: 7 (dkdv
//     4, dq 3), where the mma.sync kernels this design replaced took 8 (prep
//     1, dkdv 4, dq 3) and 10 at D 160 (dk/dv in two head-dim slices that
//     each recomputed s and dp). At D 160 the four accumulators take 255
//     registers without a spill (ptxas), so no slices: a sliced instance
//     measured no faster at any path shape but one (PERF.md, PR 12);
//   - the tiles come by TMA: one thread starts the copies of a stage (Q and g
//     tiles and the 64 rows' m, 1/l and delta in the dkdv kernel; K and V in
//     the dq kernel), and the stage's mbarrier counts their bytes down, in a
//     ring of two stages. The tensor maps are those of the forward's cache
//     (flash_wgmma.cuh: tensor_map), keyed on address and layout, so the
//     backward's lookups of q, k and v hit the maps the forward made;
//   - 64 or 128 rows a block (one warpgroup, or two sharing the stages that
//     the loop walks), picked by flash_bwd_plan (ops/attention.py): two
//     where such blocks still give an SM 0.7 blocks or more.
// Registers: four accumulators live at once in the dkdv kernel (S^T, dP^T,
// dK, dV: 32 + 32 + DP/2 + DP/2 fp32 a thread, 224 at D 160).

#include <type_traits>

#include "flash_bwd.cuh"

namespace {

// Warpgroups that must fit on an SM together, which caps a thread's
// registers (3: 168, 2: 255).
template <int KS, int NWG>
constexpr int dkdv_min_blocks() {
  return NWG == 2 ? 1 : (KS <= 3 ? 3 : 2);
}
template <int KS, int NWG>
constexpr int dq_min_blocks() {
  return NWG == 2 ? 1 : (KS <= 5 ? 3 : 2);
}

template <int KS, int NWG>
struct WgBwdShape {
  static constexpr int DP = 16 * KS;             // head dim padded to a k-step
  static constexpr int TILE = kRows * DP * 2;    // bytes of one 64-row tile
  // [NWG][own two tiles] [kStages][two streamed tiles] [kStages][3][64] fp32
  // [kStages + 1] barriers
  static constexpr size_t smem = (size_t)(NWG + kStages) * 2 * TILE +
                                 sizeof(float) * kStages * 3 * kRows +
                                 sizeof(uint64_t) * (kStages + 1);
};

// ---------------------------------------------------------------------------
// dk, dv of 64 NWG keys
// ---------------------------------------------------------------------------

template <int KS, int NWG>
__global__ void __launch_bounds__(NWG * 128, dkdv_min_blocks<KS, NWG>())
flash_bwd_dkdv_wg_kernel(const WgBwdParams p, const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_g) {
  using Shape = WgBwdShape<KS, NWG>;
  constexpr int DP = Shape::DP, TILE = Shape::TILE, NST = kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* kv = smem_raw;                                // [NWG][K, V][TILE]
  unsigned char* qg = kv + NWG * 2 * TILE;                     // [NST][Q, g][TILE]
  float* rst = reinterpret_cast<float*>(qg + NST * 2 * TILE);  // [NST][m, 1/l, delta][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(rst + NST * 3 * kRows);  // [NST] tiles, K/V

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;  // warp w of a warpgroup owns its rows 16 w ..
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int key0 = blockIdx.x * kRows * NWG;
  const int64_t bh = (int64_t)b * p.h + h;
  const int nq = p.sqp / kRows;
  const float* m_src = p.m + bh * p.sqp;
  const float* il_src = p.inv_l + bh * p.sqp;
  const float* dl_src = p.delta + bh * p.sqp;

  // thread 0: query tile t (Q, g and the rows' m, 1/l, delta) -> stage t % NST
  auto load_q = [&](int t) {
    const int stage = t % NST;
    unsigned char* dst = qg + stage * 2 * TILE;
    float* r = rst + stage * 3 * kRows;
    mbar_expect_tx(&bar[stage], 2 * TILE + 3 * kRows * (int)sizeof(float));
    tma_load_5d(dst, &map_q, &bar[stage], 0, t * kRows, 0, h, b);
    tma_load_5d(dst + TILE, &map_g, &bar[stage], 0, t * kRows, 0, h, b);
    bulk_load(r, m_src + t * kRows, kRows * sizeof(float), &bar[stage]);
    bulk_load(r + kRows, il_src + t * kRows, kRows * sizeof(float), &bar[stage]);
    bulk_load(r + 2 * kRows, dl_src + t * kRows, kRows * sizeof(float), &bar[stage]);
  };
  if (threadIdx.x == 0) {
    prefetch_map(&map_q);
    prefetch_map(&map_g);
    mbar_init_all(bar, NST + 1);
    mbar_expect_tx(&bar[NST], NWG * 2 * TILE);
    for (int w = 0; w < NWG; ++w) {
      tma_load_5d(kv + w * 2 * TILE, &map_k, &bar[NST], 0, key0 + w * kRows, 0, h, b);
      tma_load_5d(kv + w * 2 * TILE + TILE, &map_v, &bar[NST], 0, key0 + w * kRows, 0, h, b);
    }
    for (int t = 0; t < NST - 1 && t < nq; ++t) load_q(t);
  }

  // this thread's two keys and their mask, fixed for the whole loop
  const int kr0 = key0 + wg * kRows + warp * 16 + g, kr1 = kr0 + 8;
  const float* mask = p.mask ? p.mask + (int64_t)b * p.sk : nullptr;
  const bool mk0 = mask != nullptr && kr0 < p.sk && mask[kr0] <= 0.f;
  const bool mk1 = mask != nullptr && kr1 < p.sk && mask[kr1] <= 0.f;
  // a block barrier (the barriers are initialised) that also tells whether
  // any key of the block is masked
  const bool plain = !__syncthreads_or(mk0 || mk1) && !p.causal;

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t k_addr = smem_addr(kv) + wg * 2 * TILE, v_addr = k_addr + TILE;
  const uint32_t qg_addr = smem_addr(qg);
  const float sl2 = p.scale_log2;
  const int off = p.sk - p.sq;
  mbar_wait(&bar[NST], 0);  // K and V have landed

  for (int t = 0; t < nq; ++t) {
    __syncthreads();  // stage (t - 1) % NST is no longer read
    if (threadIdx.x == 0 && t + NST - 1 < nq) load_q(t + NST - 1);
    mbar_wait(&bar[t % NST], (t / NST) & 1);  // tile t has landed
    const uint32_t q_addr = qg_addr + (t % NST) * 2 * TILE, g_addr = q_addr + TILE;
    const float* r = rst + (t % NST) * 3 * kRows;

    float s[32], dp[32];  // S^T and dP^T: keys x queries
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(s, kmajor(k_addr, kk), kmajor(q_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(dp, kmajor(v_addr, kk), kmajor(g_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T in place. Rows past Sq have 1/l = 0 (and zero Q and g):
    // they add nothing.
    if (plain)
      dkdv_probs<false>(s, dp, r, tq, kr0, mk0, mk1, 0, 0, sl2);
    else
      dkdv_probs<true>(s, dp, r, tq, kr0, mk0, mk1, p.causal, t * kRows + off, sl2);
    uint32_t pa[4][4], da[4][4];
    acc_to_a(pa, s);
    acc_to_a(da, dp);

    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_o<DP>(dv, pa[kk], mnmajor(g_addr, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_o<DP>(dk, da[kk], mnmajor(q_addr, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
  }

  store_acc<DP>(p.dk + b * p.st[DK][0] + h * p.st[DK][1], p.st[DK][2], dk, kr0, p.sk, 0, p.d,
                p.scale, tq);
  store_acc<DP>(p.dv + b * p.st[DV][0] + h * p.st[DV][1], p.st[DV][2], dv, kr0, p.sk, 0, p.d,
                1.f, tq);
}

// ---------------------------------------------------------------------------
// dq of 64 NWG queries
// ---------------------------------------------------------------------------

template <int KS, int NWG>
__global__ void __launch_bounds__(NWG * 128, dq_min_blocks<KS, NWG>())
flash_bwd_dq_wg_kernel(const WgBwdParams p, const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_g) {
  using Shape = WgBwdShape<KS, NWG>;
  constexpr int DP = Shape::DP, TILE = Shape::TILE, NST = kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* qg = smem_raw;                                // [NWG][Q, g][TILE]
  unsigned char* kv = qg + NWG * 2 * TILE;                     // [NST][K, V][TILE]
  float* ms = reinterpret_cast<float*>(kv + NST * 2 * TILE);   // [NST][64] key mask (of 3 x 64)
  uint64_t* bar = reinterpret_cast<uint64_t*>(ms + NST * 3 * kRows);  // [NST] tiles, Q/g

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kRows * NWG;
  const int64_t bh = (int64_t)b * p.h + h;
  const int ntiles = (p.sk + kRows - 1) / kRows;
  const float* mask = p.mask ? p.mask + (int64_t)b * p.sk : nullptr;

  // tile t of K and V -> stage t % NST by thread 0's two TMA copies; the key
  // mask by plain stores, visible after the next block barrier
  auto load_kv = [&](int t) {
    const int stage = t % NST;
    if (threadIdx.x == 0) {
      unsigned char* dst = kv + stage * 2 * TILE;
      mbar_expect_tx(&bar[stage], 2 * TILE);
      tma_load_5d(dst, &map_k, &bar[stage], 0, t * kRows, 0, h, b);
      tma_load_5d(dst + TILE, &map_v, &bar[stage], 0, t * kRows, 0, h, b);
    }
    if (mask != nullptr && threadIdx.x < kRows) {
      const int j = t * kRows + threadIdx.x;
      ms[stage * kRows + threadIdx.x] = j < p.sk ? mask[j] : 1.f;
    }
  };
  if (threadIdx.x == 0) {
    prefetch_map(&map_k);
    prefetch_map(&map_v);
    mbar_init_all(bar, NST + 1);
    mbar_expect_tx(&bar[NST], NWG * 2 * TILE);
    for (int w = 0; w < NWG; ++w) {
      tma_load_5d(qg + w * 2 * TILE, &map_q, &bar[NST], 0, row0 + w * kRows, 0, h, b);
      tma_load_5d(qg + w * 2 * TILE + TILE, &map_g, &bar[NST], 0, row0 + w * kRows, 0, h, b);
    }
  }
#pragma unroll
  for (int t = 0; t < NST - 1; ++t)
    if (t < ntiles) load_kv(t);

  // this thread's two query rows and their statistics (zeros past Sqp)
  const int qr0 = row0 + wg * kRows + warp * 16 + g, qr1 = qr0 + 8;
  const int64_t rb = bh * p.sqp;
  const float m0 = qr0 < p.sqp ? p.m[rb + qr0] : 0.f, m1 = qr1 < p.sqp ? p.m[rb + qr1] : 0.f;
  const float il0 = qr0 < p.sqp ? p.inv_l[rb + qr0] : 0.f;
  const float il1 = qr1 < p.sqp ? p.inv_l[rb + qr1] : 0.f;
  const float dl0 = qr0 < p.sqp ? p.delta[rb + qr0] : 0.f;
  const float dl1 = qr1 < p.sqp ? p.delta[rb + qr1] : 0.f;
  __syncthreads();  // the barriers are initialised

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  const uint32_t q_addr = smem_addr(qg) + wg * 2 * TILE, g_addr = q_addr + TILE;
  const uint32_t kv_addr = smem_addr(kv);
  const float sl2 = p.scale_log2;
  const int off = p.sk - p.sq;
  mbar_wait(&bar[NST], 0);  // Q and g have landed

  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();  // stage (t - 1) % NST is no longer read
    if (t + NST - 1 < ntiles) load_kv(t + NST - 1);
    mbar_wait(&bar[t % NST], (t / NST) & 1);
    const uint32_t k_addr = kv_addr + (t % NST) * 2 * TILE, v_addr = k_addr + TILE;
    const float* mst = ms + (t % NST) * kRows;
    const int t0 = t * kRows;
    const int nk = min(kRows, p.sk - t0);

    float s[32], dp[32];  // S and dP: queries x keys
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n64(s, kmajor(q_addr, kk), kmajor(k_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(dp, kmajor(g_addr, kk), kmajor(v_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS in place; element i: query row (i & 2 ? qr1 : qr0), key column
    // 8 (i >> 2) + 2 tq + (i & 1) of the tile
    if (mask == nullptr && !p.causal && nk == kRows) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = i & 2;
        const float pr = fast_exp2(fmaf(s[i], sl2, -(hi ? m1 : m0))) * (hi ? il1 : il0);
        dp[i] = pr * (dp[i] - (hi ? dl1 : dl0));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = i & 2;
        const int jl = (i >> 2) * 8 + 2 * tq + (i & 1);
        float x = s[i] * sl2;
        if (jl >= nk)
          x = -INFINITY;  // past Sk: no weight at all
        else if ((mask != nullptr && mst[jl] <= 0.f) ||
                 (p.causal && t0 + jl > (hi ? qr1 : qr0) + off))
          x = kNegInf;
        const float pr = fast_exp2(x - (hi ? m1 : m0)) * (hi ? il1 : il0);
        dp[i] = pr * (dp[i] - (hi ? dl1 : dl0));
      }
    }
    uint32_t da[4][4];
    acc_to_a(da, dp);

    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // MN-major K: k-step kk is keys 16 kk ..
      if (kk * 16 < nk) wgmma_o<DP>(dq, da[kk], mnmajor(k_addr, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
  }

  store_acc<DP>(p.dq + b * p.st[DQ][0] + h * p.st[DQ][1], p.st[DQ][2], dq, qr0, p.sq, 0, p.d,
                p.scale, tq);
}

// ---------------------------------------------------------------------------
// delta = sum_d g o out, TPR threads a row (1 at the UNet's head dims; 8 at
// D 512, whose 1 KB rows one thread would walk alone, leaving the card idle)
// ---------------------------------------------------------------------------

template <int TPR>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ gr, float* __restrict__ delta,
    int64_t o_sb, int64_t o_sh, int64_t o_ss, int64_t g_sb, int64_t g_sh, int64_t g_ss, int h,
    int sq, int sqp, int d, int64_t rows) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / TPR;
  const int part = TPR == 1 ? 0 : threadIdx.x % TPR;
  if (i >= rows) return;  // whole rows: TPR divides the block
  const int64_t bh = i / sqp;
  const int r = (int)(i - bh * sqp);
  const int64_t b = bh / h, hh = bh - b * h;
  float acc = 0.f;
  if (r < sq) {
    const uint4* op = reinterpret_cast<const uint4*>(o + b * o_sb + hh * o_sh + r * o_ss);
    const uint4* gp = reinterpret_cast<const uint4*>(gr + b * g_sb + hh * g_sh + r * g_ss);
    for (int c = part; c < d / 8; c += TPR) {
      const uint4 x = __ldg(op + c), y = __ldg(gp + c);
      const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(xs[e]), c2 = __bfloat1622float2(ys[e]);
        acc = fmaf(a.x, c2.x, acc);
        acc = fmaf(a.y, c2.y, acc);
      }
    }
  }
#pragma unroll
  for (int w = TPR / 2; w > 0; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (part == 0) delta[i] = acc;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <auto Kernel, size_t Smem>
int launch(dim3 grid, int threads, const WgBwdParams& p, const CUtensorMap (&maps)[4],
           cudaStream_t s) {
  static const cudaError_t set =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem);
  if (set != cudaSuccess) return (int)set;
  Kernel<<<grid, threads, Smem, s>>>(p, maps[0], maps[1], maps[2], maps[3]);
  return (int)cudaGetLastError();
}

template <int KS, int NWG>
int launch_dkdv(const WgBwdParams& p, const CUtensorMap (&maps)[4], int b, int h,
                cudaStream_t s) {
  const int blocks = (p.sk + kRows * NWG - 1) / (kRows * NWG);
  return launch<flash_bwd_dkdv_wg_kernel<KS, NWG>, WgBwdShape<KS, NWG>::smem>(
      dim3(blocks, h, b), NWG * 128, p, maps, s);
}

template <int KS, int NWG>
int launch_dq(const WgBwdParams& p, const CUtensorMap (&maps)[4], int b, int h, cudaStream_t s) {
  const int blocks = (p.sq + kRows * NWG - 1) / (kRows * NWG);
  return launch<flash_bwd_dq_wg_kernel<KS, NWG>, WgBwdShape<KS, NWG>::smem>(
      dim3(blocks, h, b), NWG * 128, p, maps, s);
}

}  // namespace

#define FLASH_BWD_WG_PREAMBLE(DQ_, DK_, DV_)                                               \
  WgBwdParams p;                                                                           \
  const int ks = (d + 15) / 16;                                                            \
  if (!(ks == 3 || ks == 5 || ks == 10) ||                                                 \
      !fill(p, q, k, v, g, mask, stats, delta, DQ_, DK_, DV_, strides, b, h, sq, sk, d,    \
            causal, scale))                                                                \
    return (int)cudaErrorInvalidValue;                                                     \
  CUtensorMap maps[4];                                                                     \
  const void* const in[4] = {q, k, v, g};                                                  \
  if (const int rc = make_maps(maps, in, strides, b, h, sq, sk, d, 2 * ks)) return rc;     \
  cudaStream_t s = static_cast<cudaStream_t>(stream)

// q, k, v, g [B, H, S, D] bf16 at `strides` (see fill), the key mask [B, Sk]
// fp32 or null, stats [2, B, H, Sqp] fp32 (m, 1/l, as the wgmma forward
// writes them; Sqp = Sq rounded up to 64, zeros past Sq), delta [B, H, Sqp]
// (flash_bwd_delta), dk and dv bf16 out. key_block: 64 or 128 keys a block.
extern "C" int flash_bwd_dkdv_wg(const void* q, const void* k, const void* v, const void* g,
                                 const float* mask, const float* stats, const float* delta,
                                 void* dk, void* dv, const int64_t* strides, int b, int h, int sq,
                                 int sk, int d, int causal, float scale, int key_block,
                                 void* stream) {
  FLASH_BWD_WG_PREAMBLE(nullptr, dk, dv);
  const bool two = key_block == 128;
  if (!two && key_block != 64) return (int)cudaErrorInvalidValue;
  switch ((d + 15) / 16) {
    case 3: return two ? launch_dkdv<3, 2>(p, maps, b, h, s) : launch_dkdv<3, 1>(p, maps, b, h, s);
    case 5: return two ? launch_dkdv<5, 2>(p, maps, b, h, s) : launch_dkdv<5, 1>(p, maps, b, h, s);
    default:
      return two ? launch_dkdv<10, 2>(p, maps, b, h, s) : launch_dkdv<10, 1>(p, maps, b, h, s);
  }
}

// The same inputs; dq bf16 out. query_block: 64 or 128 queries a block.
extern "C" int flash_bwd_dq_wg(const void* q, const void* k, const void* v, const void* g,
                               const float* mask, const float* stats, const float* delta,
                               void* dq, const int64_t* strides, int b, int h, int sq, int sk,
                               int d, int causal, float scale, int query_block, void* stream) {
  FLASH_BWD_WG_PREAMBLE(dq, nullptr, nullptr);
  const bool two = query_block == 128;
  if (!two && query_block != 64) return (int)cudaErrorInvalidValue;
  switch ((d + 15) / 16) {
    case 3: return two ? launch_dq<3, 2>(p, maps, b, h, s) : launch_dq<3, 1>(p, maps, b, h, s);
    case 5: return two ? launch_dq<5, 2>(p, maps, b, h, s) : launch_dq<5, 1>(p, maps, b, h, s);
    default: return two ? launch_dq<10, 2>(p, maps, b, h, s) : launch_dq<10, 1>(p, maps, b, h, s);
  }
}

// delta [B, H, Sqp] fp32 (Sqp = Sq rounded up to 64; zeros past Sq) of out
// and g [B, H, Sq, D] bf16 at `strides` (6 element strides: batch, head,
// sequence of out, then of g); D a multiple of 8, rows on 16-byte boundaries.
extern "C" int flash_bwd_delta(const void* o, const void* g, float* delta, const int64_t* strides,
                               int b, int h, int sq, int d, void* stream) {
  if (b < 1 || h < 1 || sq < 1 || d < 8 || d % 8 != 0 ||
      reinterpret_cast<uintptr_t>(o) % 16 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 6; ++i)
    if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  const int sqp = (sq + kRows - 1) / kRows * kRows;
  const int64_t rows = (int64_t)b * h * sqp;
  const int tpr = d >= 256 ? 8 : 1;
  auto kernel = tpr == 8 ? flash_bwd_delta_kernel<8> : flash_bwd_delta_kernel<1>;
  kernel<<<(unsigned)((rows * tpr + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(g), delta, strides[0], strides[1],
      strides[2], strides[3], strides[4], strides[5], h, sq, sqp, d, rows);
  return (int)cudaGetLastError();
}

// Flash-attention backward at the VAE's head dim 512 (497..512, a multiple
// of 8) on Hopper (sm_90a): wgmma on TMA-fed tiles over a thread-block
// cluster that splits the head dim. The UNet's head dims (40, 80, 160) take
// the kernels of flash_attn_bwd_wg.cu; both share flash_bwd.cuh and the
// delta kernel (flash_bwd_delta, 8 threads a row at this head dim).
//
// Replaces `_flash_bwd` of adaface_tpu/ops/attention.py (:384-447), the XLA
// backward of the Pallas forward kernel _flash_kernel at that head dim:
// for out = softmax(s) v with s = scale q k^T (+ key mask, + causal rule)
//     p  = softmax(s);  dv = p^T g;  dp = g v^T;  delta = rowsum(g o out)
//     ds = p o (dp - delta);  dq = scale ds k;  dk = scale ds^T q
// recomputed tile by tile: no [Sq, Sk] tensor is stored. The one caller on
// the path is the VAE decoder's mid-block attention (B 2-3, H 1, S 4096).
//
// What bounds it: operations. Five products of 2 Sq Sk D each (s, dp, dv,
// dk, dq): 0.17 TFLOP at B 2, 0.174 ms at 989 TFLOP/s. What is hard at D 512
// is room: the dk and dv of 64 keys are 64 x 512 x 2 fp32 = 256 KB, the
// whole register file of an SM, and a 64-row tile of Q or K is 64 KB. The
// design:
//   - the rows' softmax statistics (m in log2 units with the scale folded
//     in, and 1/l, kept apart as flash_attn_bwd_wg.cu says why) come from the
//     wide forward (flash_attn_wide.cu), which writes them when autograd
//     records the call; no product rebuilds them;
//   - a cluster of kCluster = 2 blocks owns 64 keys (flash_bwd_dkdv_cl) or
//     64 queries (flash_bwd_dq_cl), and block `rank` owns the columns
//     [rank C, rank C + C) of the head dim, C = 256: of K, V, dK, dV, or of
//     Q, g, dQ, so a block's accumulators fit its registers (64 x 256 fp32 of
//     dV in one warpgroup, of dK in the other);
//   - a tile step of 64 rows from the other side: the block's two
//     warpgroups compute its partial S^T = K_c Q_c^T and dP^T = V_c g_c^T over
//     its C columns (one each, both operands from TMA-filled shared memory).
//     Each block then reduces 32 of the 64 rows (those of its warps
//     [2 rank, 2 rank + 2) in each warpgroup): the other block leaves its
//     partials of those rows in its shared memory, and after a cluster
//     barrier the owning warps read them through distributed shared memory
//     and add the two partials in rank order, so
//     each value is summed once, in a fixed order, and two runs give the
//     same bits. Warpgroup 0's owning warps form P^T = exp2(S^T scale log2e -
//     m) / l, warpgroup 1's (from warpgroup 0's fp32 P^T in shared memory)
//     dS^T = P^T o (dP^T - delta); both are rounded to bf16 where the
//     D <= 160 kernels round them, and the rounded A operands are published;
//     after a second cluster barrier the other warps fetch theirs from the
//     owning block. Then dV_c += P^T g_c (warpgroup 0), dK_c += dS^T Q_c
//     (warpgroup 1) from registers. The dq kernel's owning warps form P and
//     dS the same way, and each warpgroup adds dS K_c to its half of dQ_c.
//     Exchanging the bf16 operands, which are what the products read, costs
//     no accuracy, and a block reads 24 KB of the other's shared
//     memory a step where every block adding every partial read 48 (dkdv) or
//     64 (dq);
//   - tiles come by TMA in a ring of two stages counted down on mbarriers
//     (the Q and g slices and the rows' m, 1/l, delta in the dkdv kernel; K,
//     V in the dq kernel), as boxes of 64 rows by 64 columns in the 128-byte
//     swizzle (flash_wgmma.cuh: tensor_map_sw128, kept in the forward's
//     cache), which wgmma reads as it lies: a box is 64 requests of 128 bytes
//     where the UNet kernels' unswizzled layout takes 512 of 16;
//   - no float atomics: dq, dk and dv each have one writer.
// Masking as in flash_attn_bwd_wg.cu: a key with kv_mask <= 0, or one the
// causal rule (key <= row + Sk - Sq) excludes, takes the logit -1e30; keys
// past Sk and rows past Sq take no part.
// Shared memory a block: K_c and V_c 64 KB, two stages of Q_c and
// g_c 128 KB, the two partials 32 KB (whose own-row slots also carry the
// fp32 P and the published operands): 230,936 bytes with the rows' values
// and barriers, one block an SM.
// Measured on an H100 SXM, 700 W, at B 2, H 1, S 4096 (PERF.md §6):
// dkdv 0.54 ms and dq 0.49 of device time, where the mma.sync kernels this
// design replaced took 1.32 and 1.07, and where every block adding every
// partial took 0.64 and 0.66; a cluster of 4 (128 columns a block) took
// 2.5-3.1x as long as 2 at B 1-3.
// What limits it: a step's chain (partials, exchange, reduction, products)
// runs in one block an SM with nothing to overlap it. A handoff on mbarriers
// in place of the cluster barriers measured no faster; unswizzled 16-byte
// boxes took 1.3x as long.

#include <cooperative_groups.h>

#include "flash_bwd.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWideDim = 512;  // the head dim, padded
constexpr int kThreads = 256;  // two warpgroups
constexpr int kPart = kRows * kRows;  // floats of one 64 x 64 partial
constexpr int kCluster = 2;            // blocks that split the head dim
constexpr int kCols = kWideDim / kCluster;  // head-dim columns of a block
constexpr int kTile = kRows * kCols * 2;     // bytes of one 64-row tile's slice
// [own two tiles] [kStages][two streamed tiles] [S, dP partials]
// [kStages][3][64] fp32 [kStages + 1] barriers
constexpr size_t kSmem = (size_t)(1 + kStages) * 2 * kTile + sizeof(float) * 2 * kPart +
                         sizeof(float) * kStages * 3 * kRows + sizeof(uint64_t) * (kStages + 1);

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A warpgroup's 64 x 64 accumulator (32 floats a thread) into `part`:
// thread t's float4 j at [j][t], so a warp's loads and stores are whole
// lines.
__device__ __forceinline__ void put_part(float* part, const float (&x)[32], int t) {
  float4* dst = reinterpret_cast<float4*>(part);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    dst[j * 128 + t] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
}

// The block that reduces the rows of thread t's accumulator elements: the
// 32 rows of warps [2 r, 2 r + 2) of each warpgroup belong to block r.
__device__ __forceinline__ int owner(int t) { return t / (128 / kCluster); }

// x (this block's partial of thread t's 32 elements) := the cluster's
// partials of them added in rank order, the other's read from `part` (the
// same offset in every block's shared memory) of the other block
__device__ __forceinline__ void reduce_rows(float (&x)[32], float* part, int t, int rank,
                                            cg::cluster_group& cluster) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float4 v = r == rank ? make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3])
                                 : reinterpret_cast<const float4*>(
                                       cluster.map_shared_rank(part, r))[j * 128 + t];
      if (r == 0) {
        sum = v;
      } else {
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    }
    x[4 * j] = sum.x;
    x[4 * j + 1] = sum.y;
    x[4 * j + 2] = sum.z;
    x[4 * j + 3] = sum.w;
  }
}

// thread t's bf16 A operand (16 words) into slots j0 .. j0 + 3 of `part`, and
// back from block `from`'s
__device__ __forceinline__ void publish(float* part, const uint32_t (&a)[4][4], int j0, int t) {
  uint4* dst = reinterpret_cast<uint4*>(part);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    dst[(j0 + k) * 128 + t] = make_uint4(a[k][0], a[k][1], a[k][2], a[k][3]);
}
__device__ __forceinline__ void gather(uint32_t (&a)[4][4], float* part, int j0, int t, int from,
                                       int rank, cg::cluster_group& cluster) {
  const uint4* src =
      reinterpret_cast<const uint4*>(from == rank ? part : cluster.map_shared_rank(part, from));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 v = src[(j0 + k) * 128 + t];
    a[k][0] = v.x;
    a[k][1] = v.y;
    a[k][2] = v.z;
    a[k][3] = v.w;
  }
}

// one thread: rows row0 .. row0 + 63, columns col0 .. col0 + kCols - 1 of
// the (b, h) slice -> dst, kCols / 64 swizzled atoms; the bytes count down on bar
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int col0, int row0, int h, int b) {
#pragma unroll
  for (int a = 0; a < kCols / 64; ++a)
    tma_load_4d(dst + a * kAtom, map, bar, col0 + 64 * a, row0, h, b);
}

// ---------------------------------------------------------------------------
// dk, dv of 64 keys: a cluster of kCluster blocks, block `rank` the columns
// [rank C, rank C + C)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_cl_kernel(const WgBwdParams p, const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_g) {
  constexpr int C = kCols, KS = kCols / 16, TILE = kTile, NST = kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* kv = smem_raw;                                     // [K, V][TILE]
  unsigned char* qg = kv + 2 * TILE;                                // [NST][Q, g][TILE]
  float* part = reinterpret_cast<float*>(qg + NST * 2 * TILE);      // [S^T, dP^T][64 x 64]
  float* rst = part + 2 * kPart;                                    // [NST][m, 1/l, delta][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(rst + NST * 3 * kRows);  // [NST] tiles, K/V

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = (threadIdx.x >> 5) & 3;  // warp w of a warpgroup owns its rows 16 w ..
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int key0 = (blockIdx.x / kCluster) * kRows;
  const int col0 = rank * C;
  const int64_t bh = (int64_t)b * p.h + h;
  const int nq = p.sqp / kRows;
  const float* m_src = p.m + bh * p.sqp;
  const float* il_src = p.inv_l + bh * p.sqp;
  const float* dl_src = p.delta + bh * p.sqp;

  // thread 0: query tile i (the block's columns of Q and g, and the rows' m,
  // 1/l, delta) -> stage i % NST
  auto load_q = [&](int i) {
    const int stage = i % NST;
    unsigned char* dst = qg + stage * 2 * TILE;
    float* r = rst + stage * 3 * kRows;
    mbar_expect_tx(&bar[stage], 2 * TILE + 3 * kRows * (int)sizeof(float));
    load_tile(dst, &map_q, &bar[stage], col0, i * kRows, h, b);
    load_tile(dst + TILE, &map_g, &bar[stage], col0, i * kRows, h, b);
    bulk_load(r, m_src + i * kRows, kRows * sizeof(float), &bar[stage]);
    bulk_load(r + kRows, il_src + i * kRows, kRows * sizeof(float), &bar[stage]);
    bulk_load(r + 2 * kRows, dl_src + i * kRows, kRows * sizeof(float), &bar[stage]);
  };
  if (threadIdx.x == 0) {
    prefetch_map(&map_q);
    prefetch_map(&map_g);
    mbar_init_all(bar, NST + 1);
    mbar_expect_tx(&bar[NST], 2 * TILE);
    load_tile(kv, &map_k, &bar[NST], col0, key0, h, b);
    load_tile(kv + TILE, &map_v, &bar[NST], col0, key0, h, b);
    for (int i = 0; i < NST - 1 && i < nq; ++i) load_q(i);
  }

  // this thread's two keys (the same in both warpgroups) and their mask
  const int kr0 = key0 + warp * 16 + g, kr1 = kr0 + 8;
  const float* mask = p.mask ? p.mask + (int64_t)b * p.sk : nullptr;
  const bool mk0 = mask != nullptr && kr0 < p.sk && mask[kr0] <= 0.f;
  const bool mk1 = mask != nullptr && kr1 < p.sk && mask[kr1] <= 0.f;
  // a block barrier (the barriers are initialised) that also tells whether
  // any key of the block is masked; the cluster's blocks share their keys,
  // so they take the same branch
  const bool plain = !__syncthreads_or(mk0 || mk1) && !p.causal;

  // warpgroup 0: S^T = K_c Q_c^T, then dV_c += P^T g_c; warpgroup 1:
  // dP^T = V_c g_c^T, then dK_c += dS^T Q_c
  float acc[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
  const uint32_t k_addr = smem_addr(kv), v_addr = k_addr + TILE;
  const uint32_t a_addr = wg == 0 ? k_addr : v_addr;
  const uint32_t qg_addr = smem_addr(qg);
  float* mine = part + wg * kPart;
  const float sl2 = p.scale_log2;
  const int off = p.sk - p.sq;
  mbar_wait(&bar[NST], 0);  // K and V have landed

  for (int i = 0; i < nq; ++i) {
    __syncthreads();  // stage (i - 1) % NST is no longer read
    if (threadIdx.x == 0 && i + NST - 1 < nq) load_q(i + NST - 1);
    mbar_wait(&bar[i % NST], (i / NST) & 1);  // tile i has landed
    const uint32_t q_addr = qg_addr + (i % NST) * 2 * TILE, g_addr = q_addr + TILE;
    const uint32_t b_addr = wg == 0 ? q_addr : g_addr;
    const float* r = rst + (i % NST) * 3 * kRows;

    float s[32];  // S^T (warpgroup 0) or dP^T (warpgroup 1): keys x queries
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(s, kmajor128(a_addr, kk), kmajor128(b_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // the rows another block reduces go to it; this block's own rows are
    // reduced here: warpgroup 0 adds S^T and forms P^T, warpgroup 1 adds
    // dP^T and forms dS^T, and both publish their bf16 A operand
    const int own = owner(t);
    uint32_t a[4][4];
    if (own != rank) put_part(mine, s, t);
    cluster_arrive();
    cluster_wait();  // every block's partials of tile i are in
    if (own == rank) {
      reduce_rows(s, mine, t, rank, cluster);
      if (wg == 0) {
        // P^T in place. Rows past Sq have 1/l = 0 (and zero Q and g): they
        // add nothing.
        if (plain)
          dkdv_probs<false, false>(s, s, r, tq, kr0, mk0, mk1, 0, 0, sl2);
        else
          dkdv_probs<true, false>(s, s, r, tq, kr0, mk0, mk1, p.causal, i * kRows + off, sl2);
        put_part(part, s, t);  // fp32 P^T for warpgroup 1, in the thread's own slots
        acc_to_a(a, s);
        publish(part + kPart, a, 0, t);
      }
    }
    __syncthreads();  // warpgroup 0's P^T is in
    if (own == rank && wg == 1) {
      // dS^T = P^T o (dP^T - delta); element e: query 8 (e >> 2) + 2 tq + (e & 1)
      const float4* pt = reinterpret_cast<const float4*>(part);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pr = pt[j * 128 + t];
        const float2 dl = *reinterpret_cast<const float2*>(r + 2 * kRows + 8 * j + 2 * tq);
        s[4 * j] = pr.x * (s[4 * j] - dl.x);
        s[4 * j + 1] = pr.y * (s[4 * j + 1] - dl.y);
        s[4 * j + 2] = pr.z * (s[4 * j + 2] - dl.x);
        s[4 * j + 3] = pr.w * (s[4 * j + 3] - dl.y);
      }
      acc_to_a(a, s);
      publish(part + kPart, a, 4, t);
    }
    cluster_arrive();
    cluster_wait();  // every block's bf16 P^T and dS^T of tile i are in
    if (own != rank) gather(a, part + kPart, wg == 0 ? 0 : 4, t, own, rank, cluster);

    const uint32_t o_addr = wg == 0 ? g_addr : q_addr;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_o<C>(acc, a[kk], mnmajor128(o_addr, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cluster_arrive();
  cluster_wait();  // no block leaves while another may still read its operands

  if (wg == 0)
    store_acc<C>(p.dv + b * p.st[DV][0] + h * p.st[DV][1], p.st[DV][2], acc, kr0, p.sk, col0,
                 p.d, 1.f, tq);
  else
    store_acc<C>(p.dk + b * p.st[DK][0] + h * p.st[DK][1], p.st[DK][2], acc, kr0, p.sk, col0,
                 p.d, p.scale, tq);
}

// ---------------------------------------------------------------------------
// dq of 64 queries: the same cluster; warpgroup w adds into the columns
// [rank C + w C / 2, rank C + (w + 1) C / 2) of dQ
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_cl_kernel(const WgBwdParams p, const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_g) {
  constexpr int C = kCols, KS = kCols / 16, TILE = kTile, NST = kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qg = smem_raw;                                     // [Q, g][TILE]
  unsigned char* kv = qg + 2 * TILE;                                // [NST][K, V][TILE]
  float* part = reinterpret_cast<float*>(kv + NST * 2 * TILE);      // [S, dP][64 x 64]
  float* ms = part + 2 * kPart;                                     // [NST][64] key mask
  uint64_t* bar = reinterpret_cast<uint64_t*>(ms + NST * 3 * kRows);  // [NST] tiles, Q/g

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = (blockIdx.x / kCluster) * kRows;
  const int col0 = rank * C;
  const int64_t bh = (int64_t)b * p.h + h;
  const int ntiles = (p.sk + kRows - 1) / kRows;
  const float* mask = p.mask ? p.mask + (int64_t)b * p.sk : nullptr;

  // tile i of K and V (the block's columns) -> stage i % NST by thread 0's
  // two TMA copies; the key mask by plain stores, visible after the next
  // block barrier
  auto load_kv = [&](int i) {
    const int stage = i % NST;
    if (threadIdx.x == 0) {
      unsigned char* dst = kv + stage * 2 * TILE;
      mbar_expect_tx(&bar[stage], 2 * TILE);
      load_tile(dst, &map_k, &bar[stage], col0, i * kRows, h, b);
      load_tile(dst + TILE, &map_v, &bar[stage], col0, i * kRows, h, b);
    }
    if (mask != nullptr && threadIdx.x < kRows) {
      const int j = i * kRows + threadIdx.x;
      ms[stage * kRows + threadIdx.x] = j < p.sk ? mask[j] : 1.f;
    }
  };
  if (threadIdx.x == 0) {
    prefetch_map(&map_k);
    prefetch_map(&map_v);
    mbar_init_all(bar, NST + 1);
    mbar_expect_tx(&bar[NST], 2 * TILE);
    load_tile(qg, &map_q, &bar[NST], col0, row0, h, b);
    load_tile(qg + TILE, &map_g, &bar[NST], col0, row0, h, b);
  }
#pragma unroll
  for (int i = 0; i < NST - 1; ++i)
    if (i < ntiles) load_kv(i);

  // this thread's two query rows and their statistics (zeros past Sqp)
  const int qr0 = row0 + warp * 16 + g, qr1 = qr0 + 8;
  const int64_t rb = bh * p.sqp;
  const float m0 = qr0 < p.sqp ? p.m[rb + qr0] : 0.f, m1 = qr1 < p.sqp ? p.m[rb + qr1] : 0.f;
  const float il0 = qr0 < p.sqp ? p.inv_l[rb + qr0] : 0.f;
  const float il1 = qr1 < p.sqp ? p.inv_l[rb + qr1] : 0.f;
  const float dl0 = qr0 < p.sqp ? p.delta[rb + qr0] : 0.f;
  const float dl1 = qr1 < p.sqp ? p.delta[rb + qr1] : 0.f;
  __syncthreads();  // the barriers are initialised

  // warpgroup 0: S = Q_c K_c^T, warpgroup 1: dP = g_c V_c^T; then each
  // dQ_c[:, its half] += dS K_c[:, its half]
  constexpr int HALF = C / 2;
  float acc[HALF / 2];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) acc[i] = 0.f;
  const uint32_t q_addr = smem_addr(qg), g_addr = q_addr + TILE;
  const uint32_t a_addr = wg == 0 ? q_addr : g_addr;
  const uint32_t kv_addr = smem_addr(kv);
  float* mine = part + wg * kPart;
  const float sl2 = p.scale_log2;
  const int off = p.sk - p.sq;
  mbar_wait(&bar[NST], 0);  // Q and g have landed

  for (int i = 0; i < ntiles; ++i) {
    __syncthreads();  // stage (i - 1) % NST is no longer read
    if (i + NST - 1 < ntiles) load_kv(i + NST - 1);
    mbar_wait(&bar[i % NST], (i / NST) & 1);
    const uint32_t k_addr = kv_addr + (i % NST) * 2 * TILE, v_addr = k_addr + TILE;
    const uint32_t b_addr = wg == 0 ? k_addr : v_addr;
    const float* mst = ms + (i % NST) * kRows;
    const int t0 = i * kRows;
    const int nk = min(kRows, p.sk - t0);

    float s[32];  // S (warpgroup 0) or dP (warpgroup 1): queries x keys
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(s, kmajor128(a_addr, kk), kmajor128(b_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // this block's own rows: warpgroup 0 adds S and forms P, warpgroup 1
    // adds dP and forms dS, which both warpgroups of every block take
    const int own = owner(t);
    if (own != rank) put_part(mine, s, t);
    cluster_arrive();
    cluster_wait();  // every block's partials of tile i are in
    if (own == rank) {
      reduce_rows(s, mine, t, rank, cluster);
      if (wg == 0) {
        // P in place; element e: query row (e & 2 ? qr1 : qr0), key column
        // 8 (e >> 2) + 2 tq + (e & 1) of the tile
        if (mask == nullptr && !p.causal && nk == kRows) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const bool hi = e & 2;
            s[e] = fast_exp2(fmaf(s[e], sl2, -(hi ? m1 : m0))) * (hi ? il1 : il0);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const bool hi = e & 2;
            const int jl = (e >> 2) * 8 + 2 * tq + (e & 1);
            float x = s[e] * sl2;
            if (jl >= nk)
              x = -INFINITY;  // past Sk: no weight at all
            else if ((mask != nullptr && mst[jl] <= 0.f) ||
                     (p.causal && t0 + jl > (hi ? qr1 : qr0) + off))
              x = kNegInf;
            s[e] = fast_exp2(x - (hi ? m1 : m0)) * (hi ? il1 : il0);
          }
        }
        put_part(part, s, t);  // fp32 P for warpgroup 1, in the thread's own slots
      }
    }
    __syncthreads();  // warpgroup 0's P is in
    uint32_t da[4][4];
    if (own == rank && wg == 1) {
      const float4* pt = reinterpret_cast<const float4*>(part);
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // dS = P o (dP - delta)
        const float4 pr = pt[j * 128 + t];
        s[4 * j] = pr.x * (s[4 * j] - dl0);
        s[4 * j + 1] = pr.y * (s[4 * j + 1] - dl0);
        s[4 * j + 2] = pr.z * (s[4 * j + 2] - dl1);
        s[4 * j + 3] = pr.w * (s[4 * j + 3] - dl1);
      }
      acc_to_a(da, s);
      publish(part + kPart, da, 4, t);
    }
    cluster_arrive();
    cluster_wait();  // every block's bf16 dS of tile i is in
    if (own != rank || wg == 0) gather(da, part + kPart, 4, t, own, rank, cluster);

    // MN-major K: k-step kk is keys 16 kk .., this warpgroup's half of the
    // columns starts HALF / 64 atoms in
    const uint32_t kh_addr = k_addr + wg * (HALF / 64) * kAtom;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk * 16 < nk) wgmma_o<HALF>(acc, da[kk], mnmajor128(kh_addr, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cluster_arrive();
  cluster_wait();  // no block leaves while another may still read its operands

  store_acc<HALF>(p.dq + b * p.st[DQ][0] + h * p.st[DQ][1], p.st[DQ][2], acc, qr0, p.sq,
                  col0 + wg * HALF, p.d, p.scale, tq);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// grid (kCluster x tiles of 64 rows of the owning side, H, B), clusters of
// kCluster
template <bool DKDV>
int launch_cl(const WgBwdParams& p, const CUtensorMap (&maps)[4], int b, int h,
              cudaStream_t s) {
  auto kernel = DKDV ? flash_bwd_dkdv_cl_kernel : flash_bwd_dq_cl_kernel;
  static const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (set != cudaSuccess) return (int)set;
  const int tiles = ((DKDV ? p.sk : p.sq) + kRows - 1) / kRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * kCluster), (unsigned)h, (unsigned)b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p, maps[0], maps[1], maps[2], maps[3]);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <bool DKDV>
int launch(const void* q, const void* k, const void* v, const void* g, const float* mask,
           const float* stats, const float* delta, void* dq, void* dk, void* dv,
           const int64_t* strides, int b, int h, int sq, int sk, int d, int causal, float scale,
           void* stream) {
  WgBwdParams p;
  if ((d + 15) / 16 != kWideDim / 16 ||
      !fill(p, q, k, v, g, mask, stats, delta, dq, dk, dv, strides, b, h, sq, sk, d, causal,
            scale))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* const in[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i)
    if (const int rc = tensor_map_sw128(&maps[i], in[i], strides[3 * i], strides[3 * i + 1],
                                        strides[3 * i + 2], b, h, (i == 1 || i == 2) ? sk : sq,
                                        d))
      return rc;
  return launch_cl<DKDV>(p, maps, b, h, static_cast<cudaStream_t>(stream));
}

}  // namespace

// q, k, v, g [B, H, S, D] bf16 at `strides` (21 element strides, see fill in
// flash_bwd.cuh), D 497..512 a multiple of 8, rows on 16-byte boundaries; the
// key mask [B, Sk] fp32 or null; stats [2, B, H, Sqp] fp32 (m, 1/l, as the
// wide forward writes them; Sqp = Sq rounded up to 64, zeros past Sq); delta
// [B, H, Sqp] (flash_bwd_delta); dk and dv bf16 out.
extern "C" int flash_bwd_dkdv_cl(const void* q, const void* k, const void* v, const void* g,
                                 const float* mask, const float* stats, const float* delta,
                                 void* dk, void* dv, const int64_t* strides, int b, int h, int sq,
                                 int sk, int d, int causal, float scale, void* stream) {
  return launch<true>(q, k, v, g, mask, stats, delta, nullptr, dk, dv, strides, b, h, sq, sk, d,
                      causal, scale, stream);
}

// The same inputs; dq bf16 out.
extern "C" int flash_bwd_dq_cl(const void* q, const void* k, const void* v, const void* g,
                               const float* mask, const float* stats, const float* delta,
                               void* dq, const int64_t* strides, int b, int h, int sq, int sk,
                               int d, int causal, float scale, void* stream) {
  return launch<false>(q, k, v, g, mask, stats, delta, dq, nullptr, nullptr, strides, b, h, sq,
                       sk, d, causal, scale, stream);
}

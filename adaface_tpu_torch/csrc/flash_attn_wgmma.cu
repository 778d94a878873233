// Flash-attention forward on Hopper's warpgroup matrix unit (wgmma): bf16,
// head dims of the SD1.5 UNet (33..48, 65..80 and 145..160: D = 40, 80, 160)
// and of SDXL's UNet and SD3's MMDiT (49..64: D = 64), rows aligned to 16
// bytes. Same function and masking rules as
// flash_attn_fwd.cu states. Every other bf16 tensor takes the mma.sync kernel
// of flash_attn_wide.cu; the wrapper picks between the two by shape and
// alignment alone (adaface_tpu_torch/ops/attention.py: flash_plan).
//
// Replaces the Pallas TPU kernels _flash_t_kernel and, at D = 160,
// _flash_kernel of adaface_tpu/ops/attention.py.
//
// Bound at S = 4096, D = 40, B*H = 16: 42.9 GFLOP, 0.043 ms at 989 TFLOP/s;
// the 268 M exponentials need ~0.06 ms of the SFUs (16 a clock an SM), so
// the softmax, not the matrix unit, is what this shape can be held to. The
// Sk = 77 shapes are bound by bytes (10.7 MB at D = 40: 0.003 ms) and in
// practice by a block's start-up. The design:
//   - one warpgroup (4 warps) owns 64 query rows; a block has NWG of them
//     and shares its K/V stages between them;
//   - S = Q K^T is KS wgmma m64n64k16 with Q's A fragments in registers
//     (loaded once through ldmatrix) and the K tile read from shared memory
//     by descriptor; O += P V is 4 wgmma m64nDPk16 with P, rounded to bf16,
//     as the register A operand in the layout the S accumulator already has,
//     and V read from shared memory by descriptor in its own "MN-major"
//     (transposed) form, so V is never transposed. The matrix unit takes 6 to
//     14 instructions a tile where mma.sync took 48 to 160 and their ldmatrix
//     loads, which leaves the schedulers' slots to the softmax;
//   - K/V tiles of 64 keys in a ring of two stages, stored as wgmma's
//     unswizzled core matrices (8 rows x 16 bytes, contiguous): the 16-byte
//     column c of row r lies at c * 1024 + r * 16. One layout serves K
//     (K-major B: LBO 1024 between the two columns of a k-step, SBO 128
//     between 8-key groups) and V (MN-major B: SBO 1024 between head-dim
//     columns, LBO 128 between 8-key groups). The head dim is padded to a
//     multiple of 16 only (40 -> 48); the 128-byte swizzled layouts would pad
//     it to 64;
//   - the tiles come by TMA: one thread starts two copies a tile, and a
//     stage's mbarrier counts their bytes down. TMA writes a box row by row,
//     so the tensor map describes [B,H,S,D] as (8 elements, S rows, D/8
//     columns 16 bytes apart, H, B) with a box of (8, 64, DP/8, 1, 1): the
//     "rows" of the box are then the 64 keys of one 16-byte column, which is
//     the layout above, and rows past Sk and columns past D arrive as zeros.
//     The map is made on the host by cuTensorMapEncodeTiled (a libcuda entry
//     point, found through cudaGetDriverEntryPoint) and kept per (pointer,
//     shape, strides): two encodings a launch cost the host ~5 us, a hit
//     costs a hash lookup, and over three 25-step requests of the serving
//     path 2220 of 2250 lookups were hits (flash_tensor_map_stats). Against the same kernel fed by every thread's
//     cp.async copies (H100 SXM, 700 W, device time): 0.169 against 0.209 ms
//     at S = 4096, D = 40; 0.023 against 0.029 ms at S = 1024, D = 80. What
//     the copies cost was not their instructions (a cheaper addressing
//     changed nothing) but their presence in the warps that also run the
//     softmax; without any loads the kernel took 0.147 ms;
//   - a call of one or two tiles (Sk = 77) keeps the cp.async copies into the
//     same layout (template flag TMA, picked from Sk alone): there a block's
//     first TMA copy waits on the fetch of its tensor map longer than the
//     whole block otherwise runs (0.025 against 0.018 ms at Sq = 4096,
//     D = 40). A thread's copies are made visible to the matrix unit with
//     fence.proxy.async before the block barrier;
//   - softmax in log2 units with the scale folded into the exponent's FMA;
//     masks only in tiles that need them;
//   - where the caller asks (autograd records the call), each row's final m
//     and 1/l go to `stats` after O, for the backward (flash_attn_bwd_wg.cu),
//     which then needs no product to rebuild them; O is the same bits with
//     or without;
//   - 128 query rows a block (two warpgroups) where such blocks reach about
//     every SM, else 64; registers capped so that four warpgroups (D <= 48)
//     or three (D <= 80, 64-row blocks) are resident on an SM: a warpgroup
//     runs its two matrix products and its softmax one after the other, and
//     only other warpgroups fill the gaps (uncapped, 150 registers and two
//     resident warpgroups: 0.30 ms at S = 4096, D = 40 with cp.async copies;
//     capped: 0.21 ms).
// Measured on an H100 SXM, 700 W, device time per launch (CUDA graph of 20):
// 0.169 ms at S = 4096, D = 40 (the library's FlashAttention-2 call:
// 0.161 ms), 0.023 ms at S = 1024, D = 80 (0.020), 0.011 ms at S = 256,
// D = 160 (0.011), 0.009-0.018 ms at Sk = 77 (0.009-0.015). What limits it
// now: the softmax's ~180 instructions a tile a warp (34 of them ex2, at 4
// lanes a clock a scheduler) with four warps a scheduler to hide them behind;
// a tile's matrix work is ~190 clocks of the SM's tensor cores. Tried and
// dropped, no gain: a third stage; 256-row blocks; skipping O's rescale when
// no maximum moved. Tried and lost: issuing tile t + 1's Q K^T before tile
// t's softmax inside one warpgroup (two S accumulators that change roles,
// three stages). ptxas serialized the wgmma pipeline in every form of it
// (C7511 "insufficient register resources", with Q from registers or by
// descriptor from shared memory, with the registers capped at 128, 168 or
// not at all), so nothing overlapped and the occupancy was lost: 0.30-0.34 ms
// at S = 4096, D = 40 with two or three resident warpgroups, 1.3 ms at the
// 128-register cap (1.1-1.2 KB of spills); 0.025-0.041 against 0.022 ms at
// S = 1024, D = 80. Q read by descriptor alone (no look-ahead) measured
// 0.177 against 0.168 ms. What is left to try is a block with a producer
// warp and two consumer warpgroups that take turns on the matrix unit through
// named barriers, with setmaxnreg moving registers to the consumers.

#include <mutex>
#include <unordered_map>

#include "flash_wgmma.cuh"

namespace {

using namespace flash;

constexpr int kWgKeys = kWgRows;
constexpr int kWgStages = 2;

template <int KS, int NWG>
struct WgShape {
  static constexpr int DP = 16 * KS;
  static constexpr int QSTR = DP + 8;           // Q row stride (elements), for ldmatrix
  static constexpr int ROWS = 64 * NWG;
  static constexpr int TILE = kWgKeys * DP * 2;  // bytes of one K or V tile
  static constexpr size_t smem = (size_t)kWgStages * 2 * TILE + (size_t)ROWS * QSTR * 2 +
                                 sizeof(float) * kWgStages * kWgKeys +
                                 sizeof(uint64_t) * kWgStages;
};

// Warpgroups that must fit on an SM together, which caps a thread's
// registers: 4 (128 registers) at head dims <= 48, 3 (168) at <= 80. The
// softmax of one warpgroup hides behind the matrix work and the barriers of
// the others only if enough of them are resident. The D 64 instance takes
// the D 80 rule: ptxas gives it 112-127 registers whatever the cap, and
// caps of 2-4 blocks (64 rows) and 1-2 (128 rows) timed alike
// (chip_compare.py --d64-caps).
template <int KS, int NWG>
constexpr int wg_min_blocks() {
  return KS <= 3 ? 4 / NWG : (KS <= 5 && NWG == 1 ? 3 : 1);
}

// TMA: K/V tiles come by TMA (one thread, mbarriers); else by every thread's
// cp.async copies, for calls of one or two tiles (Sk = 77), where a block's
// first TMA copy waits on the fetch of its tensor map longer than the whole
// block otherwise runs.
template <int KS, int NWG, bool TMA>
__global__ void __launch_bounds__(NWG * 128, wg_min_blocks<KS, NWG>())
flash_fwd_wg_kernel(const FlashParams p, const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v) {
  using Shape = WgShape<KS, NWG>;
  constexpr int DP = Shape::DP, QSTR = Shape::QSTR, ROWS = Shape::ROWS, TILE = Shape::TILE;
  constexpr int NT = NWG * 128;
  constexpr int KT = kWgKeys, NST = kWgStages;
  constexpr int CH = DP / 8;       // 16-byte chunks of a row
  constexpr int CHUNK = KT * 16;   // bytes of one 16-byte column of a tile: 64 rows
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* kvs = smem_raw;                                              // [NST][2][TILE]
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(kvs + NST * 2 * TILE);  // [ROWS][QSTR]
  float* ms = reinterpret_cast<float*>(qs + ROWS * QSTR);                      // [NST][KT]
  uint64_t* full = reinterpret_cast<uint64_t*>(ms + NST * KT);                 // [NST]

  const int warp = threadIdx.x >> 5;  // warp w of warpgroup g owns rows 64 g + 16 w ..
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int64_t b = blockIdx.z;
  const int64_t h = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int d = p.d;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* mask = p.mask ? p.mask + b * p.sk : nullptr;
  const int ntiles = (p.sk + KT - 1) / KT;

  // cp.async flavour: a thread copies row ld_r's 16-byte columns ld_c0 +
  // j * CSTEP of every tile (two neighbouring threads take the two halves of
  // a 32-byte sector), zeros outside n_rows x d
  constexpr int CSTEP = 2 * (NT / 128);
  const int ld_r = (threadIdx.x >> 1) & 63;
  const int ld_c0 = 2 * (threadIdx.x >> 7) + (threadIdx.x & 1);
  auto stage_cols = [&](unsigned char* dst, const __nv_bfloat16* src, int64_t stride,
                        int n_rows) {
    const bool row_ok = ld_r < n_rows;
    const __nv_bfloat16* row = row_ok ? src + (int64_t)ld_r * stride : src;
#pragma unroll
    for (int j = 0; j * CSTEP < CH; ++j) {
      const int c = ld_c0 + j * CSTEP;
      if (c < CH) {
        const bool ok = row_ok && c * 8 < d;
        cp_async16(dst + c * CHUNK + ld_r * 16, ok ? row + c * 8 : src, ok ? 16 : 0);
      }
    }
  };
  // tile t of K and V -> stage t % NST: by one thread's two TMA copies, which
  // count down on the stage's barrier, or by cp.async (the caller commits).
  // Rows past Sk and head-dim columns past D arrive as zeros. The key mask
  // goes by plain stores, visible after the next block barrier.
  auto load_tile = [&](int t) {
    const int t0 = t * KT;
    const int stage = t % NST;
    unsigned char* ks = kvs + stage * 2 * TILE;
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(&full[stage], 2 * TILE);
        tma_load_5d(ks, &map_k, &full[stage], 0, t0, 0, (int)h, (int)b);
        tma_load_5d(ks + TILE, &map_v, &full[stage], 0, t0, 0, (int)h, (int)b);
      }
    } else {
      stage_cols(ks, k + (int64_t)t0 * p.k_ss, p.k_ss, p.sk - t0);
      stage_cols(ks + TILE, v + (int64_t)t0 * p.v_ss, p.v_ss, p.sk - t0);
    }
    if (mask != nullptr && threadIdx.x < KT) {
      const int j = threadIdx.x;
      ms[stage * KT + j] = t0 + j < p.sk ? mask[t0 + j] : 1.f;
    }
  };

  // the first tiles are on their way before Q is: thread 0 initialises the
  // barriers and starts the copies itself, the others meet them only after
  // the block barrier below
  if (TMA && threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_k)));
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_v)));
#pragma unroll
    for (int i = 0; i < NST; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if constexpr (TMA) {
#pragma unroll
    for (int t = 0; t < NST - 1; ++t)
      if (t < ntiles) load_tile(t);
  }
  stage_rows<DP, QSTR, ROWS, NT>(qs, q + (int64_t)row0 * p.q_ss, p.q_ss, p.sq - row0, d, true);
  cp_async_commit();
  if constexpr (!TMA) {
#pragma unroll
    for (int t = 0; t < NST - 1; ++t) {
      if (t < ntiles) load_tile(t);
      cp_async_commit();
    }
  }
  cp_async_wait<TMA ? 0 : NST - 1>();  // Q's copies, the oldest group
  __syncthreads();  // Q is staged, the barriers are initialised

  uint32_t qf[KS][4];
  float o[DP / 2];  // o[4 j + e]: n-tile j of the head dim, as an mma C fragment
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // m in log2 units
  const float scale_log2 = p.scale * kLog2e;
  const int qr0 = row0 + warp * 16 + g;
  const int qr1 = qr0 + 8;
  const int causal_off = p.sk - p.sq;
  const __nv_bfloat16* q_lane =
      qs + (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * QSTR + (lane >> 4) * 8;
  const uint32_t kvs_addr = smem_addr(kvs);

  for (int t = 0; t < ntiles; ++t) {
    if constexpr (!TMA) {
      cp_async_wait<NST - 2>();  // this thread's copies of tile t have landed
      fence_proxy_async();
    }
    __syncthreads();  // stage (t - 1) % NST is no longer read
    if (t + NST - 1 < ntiles) load_tile(t + NST - 1);
    if constexpr (TMA)
      mbar_wait(&full[t % NST], (t / NST) & 1);  // tile t has landed
    else
      cp_async_commit();
    // Q's A fragments: once, at the first tile; the D 64 instance reloads
    // them every tile, as ptxas gives their registers to the softmax's
    // temporaries and to P after the first tile's product there (loaded once,
    // before or inside the loop, its output was wrong from the second tile on)
    if (KS == 4 || t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[kk], q_lane + kk * 16);
    }
    const int t0 = t * KT;
    const int nk = min(KT, p.sk - t0);
    const uint32_t k_addr = kvs_addr + (t % NST) * 2 * TILE;
    const uint32_t v_addr = k_addr + TILE;
    const float* mst = ms + (t % NST) * KT;

    float s[KT / 2];  // s[4 nt + e]: key n-tile nt, as an mma C fragment
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)  // K-major B: k-step kk is columns 2 kk, 2 kk + 1
      wgmma_s_n64(s, qf[kk], make_desc(k_addr + kk * 2 * CHUNK, CHUNK, 128), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    float sc = scale_log2;
    if (mask != nullptr || p.causal || nk < KT || !(scale_log2 > 0.f)) {
      sc = 1.f;
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const int j = (i >> 2) * 8 + 2 * tq + (i & 1);  // key within the tile
        const int qr = (i & 2) ? qr1 : qr0;
        float x = s[i] * scale_log2;
        if (j >= nk)
          x = -INFINITY;  // past Sk: no weight at all
        else if ((mask != nullptr && mst[j] <= 0.f) || (p.causal && t0 + j > qr + causal_off))
          x = kNegInf;
        s[i] = x;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY, mx2 = -INFINITY, mx3 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < KT / 8; nt += 2) {  // two chains a row: shorter dependences
      mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
      mx2 = fmaxf(mx2, fmaxf(s[4 * nt + 4], s[4 * nt + 5]));
      mx3 = fmaxf(mx3, fmaxf(s[4 * nt + 6], s[4 * nt + 7]));
    }
    mx0 = fmaxf(mx0, mx2);
    mx1 = fmaxf(mx1, mx3);
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * sc);  // finite: every tile has a real key
    const float mn1 = fmaxf(m1, mx1 * sc);
    const float corr0 = fast_exp2(m0 - mn0);
    const float corr1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f, ps2 = 0.f, ps3 = 0.f;
    uint32_t pa[KT / 16][4];  // P as the A fragments of the 4 k-steps of P V
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
      const float p0 = fast_exp2(fmaf(s[4 * nt], sc, -mn0));
      const float p1 = fast_exp2(fmaf(s[4 * nt + 1], sc, -mn0));
      const float p2 = fast_exp2(fmaf(s[4 * nt + 2], sc, -mn1));
      const float p3 = fast_exp2(fmaf(s[4 * nt + 3], sc, -mn1));
      if (nt & 1) {
        ps2 += p0 + p1;
        ps3 += p2 + p3;
      } else {
        ps0 += p0 + p1;
        ps1 += p2 + p3;
      }
      pa[nt >> 1][2 * (nt & 1)] = pack_bf16(p0, p1);
      pa[nt >> 1][2 * (nt & 1) + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * corr0 + (ps0 + ps2);
    l1 = l1 * corr1 + (ps1 + ps3);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= (i & 2) ? corr1 : corr0;

    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)  // MN-major B: k-step kk is key groups 2 kk, 2 kk + 1
      if (kk * 16 < nk) wgmma_o<DP>(o, pa[kk], make_desc(v_addr + kk * 256, 128, CHUNK));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  // d % 8 == 0 here; pairs of columns go out as 4-byte stores where aligned
  const bool pairs = p.o_sb % 2 == 0 && p.o_sh % 2 == 0 && p.o_ss % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(p.o) % 4 == 0;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    const int c = dt * 8 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? qr1 : qr0;
      const float inv = half ? inv1 : inv0;
      if (row >= p.sq || c >= d) continue;
      __nv_bfloat16* dst = out + (int64_t)row * p.o_ss + c;
      const float x0 = o[4 * dt + 2 * half] * inv, x1 = o[4 * dt + 2 * half + 1] * inv;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
      } else {
        dst[0] = __float2bfloat16(x0);
        dst[1] = __float2bfloat16(x1);
      }
    }
  }
  // the rows' statistics for the backward (flash_attn_bwd_wg.cu): m and 1/l
  // of rows < Sq, zeros for the rows up to Sq rounded up to 64
  if (p.stats != nullptr && tq == 0) {
    const int sqp = (p.sq + kWgRows - 1) / kWgRows * kWgRows;
    const int64_t bh = b * gridDim.y + h;
    float* st_m = p.stats + bh * sqp;
    float* st_il = p.stats + ((int64_t)gridDim.y * gridDim.z + bh) * sqp;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? qr1 : qr0;
      const bool real = row < p.sq;
      if (row < sqp) {
        st_m[row] = real ? (half ? m1 : m0) : 0.f;
        st_il[row] = real ? (half ? inv1 : inv0) : 0.f;
      }
    }
  }
}

// The tensor maps (flash_wgmma.cuh: tensor_map) depend on the address and
// the layout alone, and the allocator hands a model the same addresses step
// after step, so maps are kept (encoding one costs the host a few
// microseconds); flash_tensor_map_stats() counts the lookups that found a map
// and those that had to encode one. The cache is cleared when it reaches
// kMaxMaps entries.
struct MapKey {
  const void* ptr;
  int64_t sb, sh, ss;
  int b, h, s, d, ch;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && sb == o.sb && sh == o.sh && ss == o.ss && b == o.b && h == o.h &&
           s == o.s && d == o.d && ch == o.ch;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t x = reinterpret_cast<size_t>(k.ptr);
    for (int64_t v : {k.sb, k.sh, k.ss, (int64_t)k.b, (int64_t)k.h, (int64_t)k.s, (int64_t)k.d,
                      (int64_t)k.ch})
      x = x * 1099511628211ull ^ (size_t)v;
    return x;
  }
};
constexpr size_t kMaxMaps = 4096;
std::mutex map_mu;
int64_t map_hits = 0, map_misses = 0;

template <int KS, int NWG, bool TMA>
int launch_wg(const FlashParams& p, int b, int h, cudaStream_t stream) {
  const size_t smem = WgShape<KS, NWG>::smem;
  auto kernel = flash_fwd_wg_kernel<KS, NWG, TMA>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  CUtensorMap map_k{}, map_v{};
  if (TMA) {
    int rc = tensor_map(&map_k, p.k, p.k_sb, p.k_sh, p.k_ss, b, h, p.sk, p.d, 2 * KS);
    if (rc == 0) rc = tensor_map(&map_v, p.v, p.v_sb, p.v_sh, p.v_ss, b, h, p.sk, p.d, 2 * KS);
    if (rc != 0) return rc;
  }
  const dim3 grid((p.sq + 64 * NWG - 1) / (64 * NWG), h, b);
  kernel<<<grid, NWG * 128, smem, stream>>>(p, map_k, map_v);
  return (int)cudaGetLastError();
}

template <int NWG, bool TMA>
int dispatch_wg(const FlashParams& p, int b, int h, cudaStream_t stream) {
  switch ((p.d + 15) / 16) {
    case 3: return launch_wg<3, NWG, TMA>(p, b, h, stream);
    case 4: return launch_wg<4, NWG, TMA>(p, b, h, stream);
    case 5: return launch_wg<5, NWG, TMA>(p, b, h, stream);
    case 10: return launch_wg<10, NWG, TMA>(p, b, h, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// cuTensorMapEncodeTiled belongs to libcuda; it is looked up through the
// runtime so that the library links against the runtime alone
flash::EncodeTiled flash::encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

namespace {

// the map of `key` from the cache, or encoded by encode(map, entry point)
// and kept
template <class Encode>
int cached_map(CUtensorMap* map, const MapKey& key, Encode&& encode) {
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  std::lock_guard<std::mutex> lock(map_mu);
  auto it = maps.find(key);
  if (it != maps.end()) {
    ++map_hits;
    *map = it->second;
    return 0;
  }
  ++map_misses;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 20000;
  const CUresult rc = encode(map, fn);
  if (rc != CUDA_SUCCESS) return 20000 + (int)rc;
  if (maps.size() >= kMaxMaps) maps.clear();
  maps.emplace(key, *map);
  return 0;
}

}  // namespace

int flash::tensor_map(CUtensorMap* map, const void* ptr, int64_t sb, int64_t sh, int64_t ss,
                      int b, int h, int s, int d, int ch) {
  return cached_map(map, MapKey{ptr, sb, sh, ss, b, h, s, d, ch}, [&](CUtensorMap* m,
                                                                        EncodeTiled encode) {
    const cuuint64_t dims[5] = {8, (cuuint64_t)s, (cuuint64_t)(d / 8), (cuuint64_t)h,
                                (cuuint64_t)b};
    const cuuint64_t strides[4] = {(cuuint64_t)(s > 1 ? ss * 2 : 16), 16,
                                   (cuuint64_t)(h > 1 ? sh * 2 : 16),
                                   (cuuint64_t)(b > 1 ? sb * 2 : 16)};
    const cuuint32_t box[5] = {8, (cuuint32_t)kWgRows, (cuuint32_t)ch, 1, 1};
    const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
    return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims, strides,
                  box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  });
}

int flash::tensor_map_sw128(CUtensorMap* map, const void* ptr, int64_t sb, int64_t sh,
                            int64_t ss, int b, int h, int s, int d) {
  // ch 0 marks the swizzled map in the cache's key
  return cached_map(map, MapKey{ptr, sb, sh, ss, b, h, s, d, 0}, [&](CUtensorMap* m,
                                                                       EncodeTiled encode) {
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h, (cuuint64_t)b};
    const cuuint64_t strides[3] = {(cuuint64_t)(s > 1 ? ss * 2 : 16),
                                   (cuuint64_t)(h > 1 ? sh * 2 : 16),
                                   (cuuint64_t)(b > 1 ? sb * 2 : 16)};
    const cuuint32_t box[4] = {64, (cuuint32_t)kWgRows, 1, 1};
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                  box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  });
}

// bf16; head dim a multiple of 8 in 33..48, 49..64, 65..80 or 145..160; q, k, v rows
// on 16-byte boundaries (else cudaErrorInvalidValue: the wrapper sends such
// tensors to flash_fwd_bf16_wide). block_rows: 64 or 128. stats: null, or
// [2, B, H, Sqp] fp32 (Sqp = Sq rounded up to 64) that receives each row's m
// (log2 units, the scale folded in) and 1/l, zeros past Sq: what the
// backward reads. O is the same with or without.
extern "C" int flash_fwd_bf16_wg(const void* q, const void* k, const void* v, const float* mask,
                                 void* out, const int64_t* strides, int b, int h, int sq, int sk,
                                 int d, int causal, float scale, int block_rows, float* stats,
                                 void* stream) {
  FlashParams p;
  if (!fill_params(p, q, k, v, mask, out, strides, b, h, sq, sk, d, 160, causal, scale, 2) ||
      !p.vec16)
    return (int)cudaErrorInvalidValue;
  p.stats = stats;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tma = sk > 2 * kWgKeys;  // more than two tiles
  if (block_rows == 128) return tma ? dispatch_wg<2, true>(p, b, h, s) : dispatch_wg<2, false>(p, b, h, s);
  if (block_rows == 64) return tma ? dispatch_wg<1, true>(p, b, h, s) : dispatch_wg<1, false>(p, b, h, s);
  return (int)cudaErrorInvalidValue;
}

// Lookups of the tensor-map cache since the last reset: stats[0] found a map,
// stats[1] encoded one.
extern "C" void flash_tensor_map_stats(int64_t* stats, int reset) {
  std::lock_guard<std::mutex> lock(map_mu);
  stats[0] = map_hits;
  stats[1] = map_misses;
  if (reset) map_hits = map_misses = 0;
}

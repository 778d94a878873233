// Flash-attention forward for wide heads on Hopper (sm_90a): bf16, head dim
// <= 512, and the kernel that combines split-keys partials.
//
// Replaces the Pallas TPU kernel _flash_kernel of
// adaface_tpu/ops/attention.py at the one wide shape of the serving path:
// the VAE mid-block's single head of D = 512 over S = 4096 tokens
// (q, k, v [1,1,4096,512], contiguous). Same function, same masking rules
// as flash_attn_fwd.cu states. It is also the route of every bf16 tensor the
// wgmma kernel of flash_attn_wgmma.cu has no instance for (head dims other
// than 40, 80, 160; rows off 16-byte boundaries), which no path sends.
//
// Bound: 34.4 GFLOP is 0.035 ms at the card's 989 TFLOP/s bf16 peak (the
// 12.6 MB of q, k, v, out: 0.004 ms). What is hard at D = 512 is room: the
// output accumulator of 64 query rows is 64 x 512 fp32 = 128 KB of
// registers, and Q plus one 64-key K and V tile are 192 KB of shared memory.
// The design:
//   - one block = 64 query rows, 16 warps as a 4 x 4 grid: warp (wr, wc)
//     owns rows wr*16..+15 and the head-dim slice wc*DP/4..+DP/4-1 of O
//     (16 x 128 fp32 at D = 512: 64 registers a thread, under the 128 that
//     512 threads may have);
//   - S = Q K^T over the whole head dim is computed once, not per slice:
//     of a 32-key tile, warp (wr, wc) computes the 8 keys wc*8..+7 for its
//     16 rows with mma.sync m16n8k16 (Q and K fragments by ldmatrix from
//     shared memory, four accumulators to shorten the dependent chains). The
//     four warps of a row group exchange their row maxima through shared
//     memory, so all four hold the same running maximum, and write their
//     probabilities (bf16) into a 64 x 32 tile of shared memory from which
//     every warp reads the A fragments of P V for its rows;
//   - O slice += P V_slice with V's B fragments from ldmatrix.x4.trans;
//   - K/V tiles of 32 keys in a ring of two stages filled by 16-byte
//     cp.async copies (2 x 2 x 32.5 KB beside Q's 65 KB at D = 512): tile
//     t + 1 loads while tile t computes;
//   - split keys: B*H*ceil(Sq/64) = 64 blocks would leave half the SMs idle,
//     so the wrapper splits the key tiles over nsplit blocks per query tile;
//     each writes its unnormalized O, its row maximum and row sum (fp32) to
//     scratch, and flash_combine() merges them in a fixed order (no atomics:
//     outputs repeat bit for bit);
//   - where autograd records the call, the rows' m (log2 units, the scale
//     folded in) and 1/l go to `stats` for the backward (flash_attn_bwd.cu),
//     written by the kernel itself or, with split keys, by flash_combine();
//     serving passes none, and O is the same bits either way.
// Measured on an H100 SXM, 700 W, at the VAE's shape, device time: 0.31 ms,
// the combine included (the library's FlashAttention-2 call: 0.33 ms; the
// CUDA-core kernel that served this shape before: 6.42 ms), 9x the bound.
// What limits it now: ldmatrix traffic in Q K^T (one Q fragment load per
// mma; Q does not fit in registers) and three block barriers per tile.
// wgmma with Q and K read by descriptor from shared memory would remove the
// first; it is not done here.
// Tensors whose rows are not 16-byte aligned (or D % 8 != 0) take the same
// kernel with plain element copies into the same stages.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kWideRows = 64;
constexpr int kWideKeys = 32;
constexpr int kWideStages = 2;
constexpr int kWideThreads = 512;
constexpr int kWideMaxDim = 512;
constexpr int kPStr = kWideKeys + 8;  // P tile row stride (elements)

template <int DQ>
struct WideShape {
  static constexpr int DP = 64 * DQ;  // padded head dim
  static constexpr int STR = DP + 8;
  static constexpr size_t smem =
      sizeof(__nv_bfloat16) *
          ((size_t)(kWideRows + 2 * kWideStages * kWideKeys) * STR + kWideRows * kPStr) +
      sizeof(float) * (kWideRows * 4 + kWideStages * kWideKeys);
};

template <int DQ>
__global__ void __launch_bounds__(kWideThreads)
flash_fwd_wide_kernel(const FlashParams p) {
  using Shape = WideShape<DQ>;
  constexpr int DP = Shape::DP, STR = Shape::STR;
  constexpr int ROWS = kWideRows, KT = kWideKeys, NST = kWideStages, NT = kWideThreads;
  constexpr int KS = DP / 16;  // k-steps of Q K^T (a multiple of 4)
  constexpr int SL = DP / 4;   // head-dim slice of a warp
  constexpr int DT = SL / 8;   // n-tiles of the slice (even)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ROWS][STR]
  __nv_bfloat16* kvs = qs + ROWS * STR;                             // [NST][2][KT][STR]
  __nv_bfloat16* ps = kvs + NST * 2 * KT * STR;                     // [ROWS][kPStr]
  float* mxs = reinterpret_cast<float*>(ps + ROWS * kPStr);         // [ROWS][4]
  float* ms = mxs + ROWS * 4;                                       // [NST][KT]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp >> 2;  // row group
  const int wc = warp & 3;   // key slice of S, head-dim slice of O
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int64_t b = blockIdx.z;
  const int64_t h = blockIdx.y;
  const int split = blockIdx.x % p.nsplit;
  const int row0 = (blockIdx.x / p.nsplit) * ROWS;
  const int d = p.d;
  const bool vec16 = p.vec16 != 0;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* mask = p.mask ? p.mask + b * p.sk : nullptr;
  // this block's share of the key tiles (never empty: the host checks)
  const int ntiles_all = (p.sk + KT - 1) / KT;
  const int per = (ntiles_all + p.nsplit - 1) / p.nsplit;
  const int t_begin = split * per;
  const int ntiles = min(ntiles_all, t_begin + per) - t_begin;

  // tile i of this block's share -> stage i % NST
  auto load_tile = [&](int i) {
    const int t0 = (t_begin + i) * KT;
    const int nk = min(KT, p.sk - t0);
    __nv_bfloat16* ks = kvs + (i % NST) * 2 * KT * STR;
    stage_rows<DP, STR, KT, NT>(ks, k + (int64_t)t0 * p.k_ss, p.k_ss, nk, d, vec16);
    stage_rows<DP, STR, KT, NT>(ks + KT * STR, v + (int64_t)t0 * p.v_ss, p.v_ss, nk, d, vec16);
    if (mask != nullptr && threadIdx.x < KT) {
      const int j = threadIdx.x;
      ms[(i % NST) * KT + j] = j < nk ? mask[t0 + j] : 1.f;
    }
  };

  stage_rows<DP, STR, ROWS, NT>(qs, q + (int64_t)row0 * p.q_ss, p.q_ss, p.sq - row0, d, vec16);
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // m in log2 units
  const float scale_log2 = p.scale * kLog2e;
  const int r0 = wr * 16 + g;  // rows of this thread's fragments, within the block
  const int r1 = r0 + 8;
  const int causal_off = p.sk - p.sq;
  // ldmatrix row addresses (see flash_attn_fwd.cu): A-side tiles of Q and P,
  // K's 8 keys x 32 head-dim columns, V's 16 keys x 16 columns
  const int a_row = wr * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const __nv_bfloat16* q_lane = qs + a_row * STR + (lane >> 4) * 8;
  const __nv_bfloat16* p_lane = ps + a_row * kPStr + (lane >> 4) * 8;
  const int k_lane = (wc * 8 + (lane & 7)) * STR + (lane >> 3) * 8;
  const int v_lane = (lane & 15) * STR + wc * SL + (lane >> 4) * 8;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<NST - 2>();  // this thread's copies of tile i have landed
    __syncthreads();           // everyone's have; stage (i - 1) % NST is no longer read
    if (i + NST - 1 < ntiles) load_tile(i + NST - 1);
    cp_async_commit();
    const int t0 = (t_begin + i) * KT;
    const int nk = min(KT, p.sk - t0);
    const __nv_bfloat16* ks = kvs + (i % NST) * 2 * KT * STR;
    const __nv_bfloat16* vs = ks + KT * STR;
    const float* mst = ms + (i % NST) * KT;

    // S[16 rows, keys wc*8..+7] over the whole head dim
    float sa[4][4];  // four accumulators: four short dependent chains
#pragma unroll
    for (int a = 0; a < 4; ++a) sa[a][0] = sa[a][1] = sa[a][2] = sa[a][3] = 0.f;
    if (wc * 8 < nk) {
#pragma unroll 2
      for (int k4 = 0; k4 < KS / 4; ++k4) {  // 64 head-dim columns a step
        uint32_t kb[2][4], qa[4][4];
        ldmatrix_x4(kb[0], ks + k_lane + k4 * 64);
        ldmatrix_x4(kb[1], ks + k_lane + k4 * 64 + 32);
#pragma unroll
        for (int a = 0; a < 4; ++a) ldmatrix_x4(qa[a], q_lane + k4 * 64 + a * 16);
#pragma unroll
        for (int a = 0; a < 4; ++a)
          mma_bf16_16816(sa[a], qa[a], kb[a / 2][2 * (a % 2)], kb[a / 2][2 * (a % 2) + 1]);
      }
    }
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = wc * 8 + 2 * tq + (e & 1);  // key within the tile
      const int qr = row0 + (e < 2 ? r0 : r1);
      x[e] = ((sa[0][e] + sa[1][e]) + (sa[2][e] + sa[3][e])) * scale_log2;
      if (j >= nk)
        x[e] = -INFINITY;  // past Sk: no weight at all
      else if ((mask != nullptr && mst[j] <= 0.f) || (p.causal && t0 + j > qr + causal_off))
        x[e] = kNegInf;
    }
    float mx0 = fmaxf(x[0], x[1]), mx1 = fmaxf(x[2], x[3]);
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    if (tq == 0) {
      mxs[r0 * 4 + wc] = mx0;
      mxs[r1 * 4 + wc] = mx1;
    }
    __syncthreads();  // the row maxima of all four key slices are in
    const float4 q0 = *reinterpret_cast<const float4*>(mxs + r0 * 4);
    const float4 q1 = *reinterpret_cast<const float4*>(mxs + r1 * 4);
    // finite: key 0 of every tile is a real key
    const float mn0 = fmaxf(m0, fmaxf(fmaxf(q0.x, q0.y), fmaxf(q0.z, q0.w)));
    const float mn1 = fmaxf(m1, fmaxf(fmaxf(q1.x, q1.y), fmaxf(q1.z, q1.w)));
    const float corr0 = fast_exp2(m0 - mn0);
    const float corr1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    x[0] = fast_exp2(x[0] - mn0);
    x[1] = fast_exp2(x[1] - mn0);
    x[2] = fast_exp2(x[2] - mn1);
    x[3] = fast_exp2(x[3] - mn1);
    l0 = l0 * corr0 + (x[0] + x[1]);  // partial sums over this warp's keys
    l1 = l1 * corr1 + (x[2] + x[3]);
    *reinterpret_cast<uint32_t*>(ps + r0 * kPStr + wc * 8 + 2 * tq) = pack_bf16(x[0], x[1]);
    *reinterpret_cast<uint32_t*>(ps + r1 * kPStr + wc * 8 + 2 * tq) = pack_bf16(x[2], x[3]);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= corr0;
      o[dt][1] *= corr0;
      o[dt][2] *= corr1;
      o[dt][3] *= corr1;
    }
    __syncthreads();  // P is whole (and mxs is read before the next tile writes it)

#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {  // 16 keys per k-step
      if (kk * 16 < nk) {
        uint32_t pa[4];
        ldmatrix_x4(pa, p_lane + kk * 16);
        const __nv_bfloat16* vrow = vs + kk * 16 * STR + v_lane;
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vrow + dt * 8);
          mma_bf16_16816(o[dt], pa, bv[0], bv[1]);
          mma_bf16_16816(o[dt + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }

  // row sums: over the 4 threads of a group, then over the 4 key slices
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  __syncthreads();
  if (tq == 0) {
    mxs[r0 * 4 + wc] = l0;
    mxs[r1 * 4 + wc] = l1;
  }
  __syncthreads();
  {
    const float4 q0 = *reinterpret_cast<const float4*>(mxs + r0 * 4);
    const float4 q1 = *reinterpret_cast<const float4*>(mxs + r1 * 4);
    l0 = (q0.x + q0.y) + (q0.z + q0.w);
    l1 = (q1.x + q1.y) + (q1.z + q1.w);
  }

  if (p.nsplit == 1) {
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
    const bool pairs = d % 2 == 0 && p.o_sb % 2 == 0 && p.o_sh % 2 == 0 && p.o_ss % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(p.o) % 4 == 0;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = wc * SL + dt * 8 + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + (half ? r1 : r0);
        const float inv = half ? inv1 : inv0;
        if (row >= p.sq) continue;
        __nv_bfloat16* dst = out + (int64_t)row * p.o_ss + c;
        const float x0 = o[dt][2 * half] * inv, x1 = o[dt][2 * half + 1] * inv;
        if (pairs) {
          if (c < d) *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
        } else {
          if (c < d) dst[0] = __float2bfloat16(x0);
          if (c + 1 < d) dst[1] = __float2bfloat16(x1);
        }
      }
    }
    // the rows' statistics for the backward (flash_attn_bwd.cu): m and 1/l
    // of rows < Sq, zeros for the rows up to Sq rounded up to 64
    if (p.stats != nullptr && wc == 0 && tq == 0) {
      const int sqp = (p.sq + ROWS - 1) / ROWS * ROWS;
      const int64_t bh = b * gridDim.y + h;
      float* st_m = p.stats + bh * sqp;
      float* st_il = p.stats + ((int64_t)gridDim.y * gridDim.z + bh) * sqp;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + (half ? r1 : r0);
        const bool real = row < p.sq;
        st_m[row] = real ? (half ? m1 : m0) : 0.f;
        st_il[row] = real ? (half ? inv1 : inv0) : 0.f;
      }
    }
  } else {
    // partials: [nsplit, B, H, Sq] rows of D (O) or one value (m, l)
    const int64_t prow0 =
        (((int64_t)split * gridDim.z + b) * gridDim.y + h) * (int64_t)p.sq + row0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (row0 + r >= p.sq) continue;
      float* dst = p.o_part + (prow0 + r) * d;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int c = wc * SL + dt * 8 + 2 * tq;
        if (c < d) dst[c] = o[dt][2 * half];
        if (c + 1 < d) dst[c + 1] = o[dt][2 * half + 1];
      }
      if (wc == 0 && tq == 0) {
        p.m_part[prow0 + r] = half ? m1 : m0;
        p.l_part[prow0 + r] = half ? l1 : l0;
      }
    }
  }
}

template <int DQ>
cudaError_t launch_wide(const FlashParams& p, int b, int h, cudaStream_t stream) {
  const size_t smem = WideShape<DQ>::smem;
  auto kernel = flash_fwd_wide_kernel<DQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((p.sq + kWideRows - 1) / kWideRows) * p.nsplit, h, b);
  kernel<<<grid, kWideThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// out[row, :] = sum_s w_s O_s[row, :] / sum_s w_s l_s, w_s = 2^(m_s - max m),
// splits taken in order; one thread per (row, 4 columns). stats, where not
// null: the row's max m and 1 / sum_s w_s l_s, as the nsplit = 1 kernel
// writes them
__global__ void __launch_bounds__(256)
flash_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                     const float* __restrict__ l_part, void* out, int64_t o_sb, int64_t o_sh,
                     int64_t o_ss, int nsplit, int64_t rows, int h, int sq, int d, int is_bf16,
                     float* __restrict__ stats) {
  const int nq = (d + 3) / 4;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * nq) return;
  const int64_t row = idx / nq;
  const int c0 = (int)(idx - row * nq) * 4;
  float mmax = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mmax = fmaxf(mmax, m_part[s * rows + row]);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float l = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = fast_exp2(m_part[s * rows + row] - mmax);
    l = fmaf(w, l_part[s * rows + row], l);
    const float* src = o_part + (s * rows + row) * d + c0;
    if (d % 4 == 0) {  // rows of o_part are then 16-byte aligned
      const float4 x = *reinterpret_cast<const float4*>(src);
      acc[0] = fmaf(w, x.x, acc[0]);
      acc[1] = fmaf(w, x.y, acc[1]);
      acc[2] = fmaf(w, x.z, acc[2]);
      acc[3] = fmaf(w, x.w, acc[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + e < d) acc[e] = fmaf(w, src[e], acc[e]);
    }
  }
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  const int64_t bh = row / sq;
  const int64_t off = (bh / h) * o_sb + (bh % h) * o_sh + (row % sq) * o_ss + c0;
  if (stats != nullptr && c0 == 0) {
    // [2, B, H, Sqp]; the last row of each (b, h) also zeros the rows past Sq
    const int sqp = (sq + 63) / 64 * 64, r = (int)(row % sq);
    float* st_m = stats + bh * sqp;
    float* st_il = stats + (rows / sq + bh) * sqp;
    st_m[r] = mmax;
    st_il[r] = inv;
    if (r == sq - 1)
      for (int z = sq; z < sqp; ++z) st_m[z] = st_il[z] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (c0 + e >= d) break;
    if (is_bf16)
      static_cast<__nv_bfloat16*>(out)[off + e] = __float2bfloat16(acc[e] * inv);
    else
      static_cast<float*>(out)[off + e] = acc[e] * inv;
  }
}

}  // namespace

// bf16, 160 < head dim <= 512 (smaller head dims are accepted and padded to
// 64). nsplit > 1: the key tiles (32 keys each) are split over nsplit blocks
// per query tile, every share non-empty, and the partial results go to
// o_part [nsplit,B,H,Sq,D], m_part, l_part [nsplit,B,H,Sq] (fp32) for
// flash_combine(); out is then not written. stats: null, or (nsplit = 1)
// [2, B, H, Sqp] fp32 (Sqp = Sq rounded up to 64) that receives each row's m
// (log2 units, the scale folded in) and 1/l, zeros past Sq, for the backward;
// O is the same either way.
extern "C" int flash_fwd_bf16_wide(const void* q, const void* k, const void* v,
                                   const float* mask, void* out, const int64_t* strides, int b,
                                   int h, int sq, int sk, int d, int causal, float scale,
                                   int nsplit, float* o_part, float* m_part, float* l_part,
                                   float* stats, void* stream) {
  FlashParams p;
  if (!fill_params(p, q, k, v, mask, out, strides, b, h, sq, sk, d, kWideMaxDim, causal, scale,
                   2))
    return (int)cudaErrorInvalidValue;
  const int ntiles = (sk + kWideKeys - 1) / kWideKeys;
  if (nsplit < 1 || (nsplit - 1) * ((ntiles + nsplit - 1) / nsplit) >= ntiles ||
      (nsplit > 1 && (!o_part || !m_part || !l_part || stats)))
    return (int)cudaErrorInvalidValue;
  p.nsplit = nsplit;
  p.stats = stats;
  p.o_part = o_part;
  p.m_part = m_part;
  p.l_part = l_part;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
    case 1: return (int)launch_wide<1>(p, b, h, s);
    case 2: return (int)launch_wide<2>(p, b, h, s);
    case 3: return (int)launch_wide<3>(p, b, h, s);
    case 4: return (int)launch_wide<4>(p, b, h, s);
    case 5: return (int)launch_wide<5>(p, b, h, s);
    case 6: return (int)launch_wide<6>(p, b, h, s);
    case 7: return (int)launch_wide<7>(p, b, h, s);
    case 8: return (int)launch_wide<8>(p, b, h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Merge split-keys partials into out [B,H,Sq,D] (strides in elements; bf16
// or fp32); stats: null, or [2, B, H, Sqp] fp32 that receives the rows' m and
// 1/l as flash_fwd_bf16_wide describes.
extern "C" int flash_combine(const float* o_part, const float* m_part, const float* l_part,
                             void* out, const int64_t* out_strides, int nsplit, int b, int h,
                             int sq, int d, int is_bf16, float* stats, void* stream) {
  if (nsplit < 1 || b < 1 || h < 1 || sq < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)b * h * sq;
  const int64_t threads = rows * ((d + 3) / 4);
  const int64_t blocks = (threads + 255) / 256;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  flash_combine_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      o_part, m_part, l_part, out, out_strides[0], out_strides[1], out_strides[2], nsplit, rows,
      h, sq, d, is_bf16, stats);
  return (int)cudaGetLastError();
}

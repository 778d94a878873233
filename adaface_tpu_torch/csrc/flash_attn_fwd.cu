// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the two Pallas TPU kernels of adaface_tpu/ops/attention.py:
//   _flash_t_kernel (transposed layout, head dim < 128, non-causal) and
//   _flash_kernel   (standard layout, causal flag, head dim >= 128).
// Both compute one function, out = softmax(q k^T * scale (+ mask)) v with an
// fp32 online softmax, so one kernel takes both here. The transposed layout
// was a trick against the TPU's 128-lane padding of small head dims and has
// no counterpart on this card.
//
// Shapes on the SD1.5 serving path: q [B,H,Sq,D], k/v [B,H,Sk,D] with
// D = 40 (Sq 4096), 80 (Sq 1024), 160 (Sq 256) in the UNet, Sk = Sq for
// self-attention or 77 for cross-attention, and D = 512, H = 1, Sq = Sk = 4096
// in the VAE mid-block.
//
// Two variants, picked by dtype and head dim:
//   - bf16 with D <= 160 (the UNet): tensor cores, mma.sync m16n8k16 in the
//     FlashAttention-2 layout (flash_fwd_tc_kernel, below). At B*H = 16,
//     S = 4096, D = 40 a call is ~0.05 TFLOP of (padded) matmul and ~270 M
//     exponentials; it takes ~0.66 ms on an H100 SXM (700 W), ~8% of the
//     bf16 matrix peak: single-stage tiles (load, barrier, math, barrier)
//     leave the staging latency and the softmax exponentials exposed, so
//     those bound it, not the matrix rate. Double-buffered tiles (cp.async
//     or TMA) and wgmma are later work.
//   - fp32, and bf16 above 160 (the VAE mid-block's D = 512, which no
//     usual flash tile fits): CUDA cores in fp32 (flash_fwd_kernel). It is
//     bound by instruction issue (score dot products, shuffles handing each
//     key's probability to all lanes, shared-memory reads of K and V):
//       - one warp per query row, 16 rows per block; K and V come through
//         shared memory in tiles of 32 keys, converted to fp32 once;
//       - scores: lane j owns key j of the tile and computes its full dot
//         product against the row's q (in shared memory, read as a
//         broadcast); the K tile's odd row stride puts the 32 lanes on 32
//         banks;
//       - online softmax per tile with two warp reductions (max, sum);
//       - P V: lanes split the head dim (ceil(D/32) fp32 accumulators per
//         lane, 16 at D = 512), each key's probability broadcast by shuffle.
//     Its ~164 KB of shared memory at D = 512 is above the 48 KB default,
//     so the launch raises the block's dynamic shared-memory limit.
//
// Masking follows the JAX reference: a key with kv_mask <= 0, or one the
// causal rule (key <= row + Sk - Sq) excludes, gets the logit -1e30, so a
// fully masked row averages V like the plain version does. Keys past Sk (the
// ragged last tile, e.g. Sk = 77) take no part at all. The row sum l is
// guarded (l == 0 -> 1) as in the TPU kernel.
//
// Entry point: flash_attn_fwd(), a plain C function. It takes device
// pointers, element strides of the batch, head and sequence axes of q, k, v
// and out (the head dim must be contiguous), and the stream; it launches on
// that stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;   // query rows per block, one warp each
constexpr int kTile = 32;    // keys per shared-memory tile, one per lane
constexpr int kMaxAcc = 16;  // accumulators per lane: head dim <= 512
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // [B, Sk] or null
  void* o;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int sq, sk, d, kstr;
  int causal;
  int vec16;  // q/k/v rows start on 16-byte boundaries and d % 8 == 0
  float scale;
};

template <typename T, int NACC>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const FlashParams p) {
  extern __shared__ float smem[];
  const int d = p.d;
  float* qs = smem;                 // [kWarps][d]
  float* ks = qs + kWarps * d;      // [kTile][kstr]
  float* vs = ks + kTile * p.kstr;  // [kTile][d]
  float* ms = vs + kTile * d;       // [kTile]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.z;
  const int64_t h = blockIdx.y;
  const int row = blockIdx.x * kWarps + warp;
  const bool row_ok = row < p.sq;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* mask = p.mask ? p.mask + b * p.sk : nullptr;

  float* my_q = qs + warp * d;
  if (row_ok) {
    for (int c = lane; c < d; c += 32) my_q[c] = to_f(q[(int64_t)row * p.q_ss + c]);
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  const int causal_off = p.sk - p.sq;

  for (int t0 = 0; t0 < p.sk; t0 += kTile) {
    const int nk = min(kTile, p.sk - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kTile * d; i += blockDim.x) {
      const int j = i / d;
      const int c = i - j * d;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        kv = to_f(k[(int64_t)(t0 + j) * p.k_ss + c]);
        vv = to_f(v[(int64_t)(t0 + j) * p.v_ss + c]);
      }
      ks[j * p.kstr + c] = kv;
      vs[j * d + c] = vv;
    }
    if (threadIdx.x < kTile) {
      const int j = threadIdx.x;
      ms[j] = (mask != nullptr && j < nk) ? mask[t0 + j] : 1.f;
    }
    __syncthreads();
    if (!row_ok) continue;

    float s = -INFINITY;  // keys past Sk: probability exactly 0
    if (lane < nk) {
      const float* kr = ks + lane * p.kstr;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int c = 0;
      for (; c + 3 < d; c += 4) {
        a0 = fmaf(my_q[c], kr[c], a0);
        a1 = fmaf(my_q[c + 1], kr[c + 1], a1);
        a2 = fmaf(my_q[c + 2], kr[c + 2], a2);
        a3 = fmaf(my_q[c + 3], kr[c + 3], a3);
      }
      for (; c < d; ++c) a0 = fmaf(my_q[c], kr[c], a0);
      s = ((a0 + a1) + (a2 + a3)) * p.scale;
      if (ms[lane] <= 0.f) s = kNegInf;
      if (p.causal && t0 + lane > row + causal_off) s = kNegInf;
    }
    float tmax = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);  // finite: every tile has a real key
    const float corr = __expf(m - m_new);
    const float pj = __expf(s - m_new);
    float psum = pj;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= corr;
    for (int j = 0; j < nk; ++j) {
      const float pb = __shfl_sync(0xffffffffu, pj, j);
      const float* vr = vs + j * d;
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int c = lane + 32 * i;
        if (c < d) acc[i] = fmaf(pb, vr[c], acc[i]);
      }
    }
  }
  if (!row_ok) return;
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + (int64_t)row * p.o_ss;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int c = lane + 32 * i;
    if (c < d) o[c] = from_f<T>(acc[i] * inv);
  }
}

template <typename T, int NACC>
cudaError_t launch(const FlashParams& p, int b, int h, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kWarps * p.d + (size_t)kTile * p.kstr + (size_t)kTile * p.d + kTile);
  auto kernel = flash_fwd_kernel<T, NACC>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.sq + kWarps - 1) / kWarps, h, b);
  kernel<<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const FlashParams& p, int b, int h, cudaStream_t stream) {
  switch ((p.d + 31) / 32) {
    case 1: return launch<T, 1>(p, b, h, stream);
    case 2: return launch<T, 2>(p, b, h, stream);
    case 3: return launch<T, 3>(p, b, h, stream);
    case 4: return launch<T, 4>(p, b, h, stream);
    case 5: return launch<T, 5>(p, b, h, stream);
    case 6: return launch<T, 6>(p, b, h, stream);
    case 7: return launch<T, 7>(p, b, h, stream);
    case 8: return launch<T, 8>(p, b, h, stream);
    case 9: return launch<T, 9>(p, b, h, stream);
    case 10: return launch<T, 10>(p, b, h, stream);
    case 11: return launch<T, 11>(p, b, h, stream);
    case 12: return launch<T, 12>(p, b, h, stream);
    case 13: return launch<T, 13>(p, b, h, stream);
    case 14: return launch<T, 14>(p, b, h, stream);
    case 15: return launch<T, 15>(p, b, h, stream);
    case 16: return launch<T, 16>(p, b, h, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core variant: bf16, head dim <= 160 (the UNet's 40, 80 and 160).
//
// FlashAttention-2 layout on mma.sync m16n8k16 (bf16 in, fp32 accumulate):
// 4 warps x 16 query rows per block; K, V tiles of 64 keys staged row-major
// in shared memory (16-byte copies when the rows are aligned); the head dim
// is zero-padded to a multiple of 16. S = Q K^T stays in registers, its
// C-fragment layout is reused as the A fragment of P V (P rounded to bf16,
// as the plain version rounds its probabilities to v's dtype); V's B
// fragments come from ldmatrix.trans. The online softmax runs in log2 units
// with exp2f. A row stride of DP + 8 elements spreads the 8 rows a fragment
// load touches over distinct banks.
// Single-stage: loads and math do not overlap (later work: cp.async or TMA
// double buffering, then wgmma).
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;  // query rows per block
constexpr int kTcKeys = 64;             // keys per tile
constexpr int kTcMaxDim = 160;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// Four 8x8 bf16 tiles, transposed: lanes 8i..8i+7 give the row addresses of
// tile i; each thread gets tile i's (col 2*(lane%4)+{0,1}, row lane/4) pair.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// rows x DP tile of src (row stride src_stride) → dst (row stride DST),
// zero outside n_rows x d; 16-byte copies when vec16
template <int DP, int DST>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t src_stride, int rows, int n_rows, int d,
                                           bool vec16) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (vec16) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
      const int r = i / CH;
      const int c = (i - r * CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < n_rows && c < d)
        val = *reinterpret_cast<const uint4*>(src + (int64_t)r * src_stride + c);
      *reinterpret_cast<uint4*>(dst + r * DST + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += blockDim.x) {
      const int r = i / DP;
      const int c = i - r * DP;
      dst[r * DST + c] = (r < n_rows && c < d) ? src[(int64_t)r * src_stride + c] : zero;
    }
  }
}

template <int KS>
struct TcShape {
  static constexpr int DP = 16 * KS;   // padded head dim
  static constexpr int STR = DP + 8;   // Q, K and V row stride (elements)
  static constexpr size_t smem =
      sizeof(__nv_bfloat16) * (size_t)(kTcRows + 2 * kTcKeys) * STR + sizeof(float) * kTcKeys;
};

template <int KS>
__global__ void __launch_bounds__(kTcWarps * 32)
flash_fwd_tc_kernel(const FlashParams p) {
  constexpr int DP = TcShape<KS>::DP, STR = TcShape<KS>::STR;
  constexpr int NT = kTcKeys / 8;  // key n-tiles of S
  constexpr int DT = DP / 8;       // head-dim n-tiles of O (even)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kTcRows][STR]
  __nv_bfloat16* ks = qs + kTcRows * STR;                           // [kTcKeys][STR]
  __nv_bfloat16* vs = ks + kTcKeys * STR;                           // [kTcKeys][STR]
  float* ms = reinterpret_cast<float*>(vs + kTcKeys * STR);         // [kTcKeys]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int tq = lane & 3;  // thread in group
  const int64_t b = blockIdx.z;
  const int64_t h = blockIdx.y;
  const int row0 = blockIdx.x * kTcRows;
  const int d = p.d;
  const bool vec16 = p.vec16 != 0;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* mask = p.mask ? p.mask + b * p.sk : nullptr;

  stage_rows<DP, STR>(qs, q + (int64_t)row0 * p.q_ss, p.q_ss, kTcRows, p.sq - row0, d, vec16);

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float scale_log2 = p.scale * 1.4426950408889634f;
  const int qr0 = row0 + warp * 16 + g;  // query rows of this thread's fragments
  const int qr1 = qr0 + 8;
  const int causal_off = p.sk - p.sq;
  const __nv_bfloat16* qw = qs + warp * 16 * STR;

  for (int t0 = 0; t0 < p.sk; t0 += kTcKeys) {
    const int nk = min(kTcKeys, p.sk - t0);
    __syncthreads();  // the previous tile is no longer read (and Q is staged)
    stage_rows<DP, STR>(ks, k + (int64_t)t0 * p.k_ss, p.k_ss, kTcKeys, nk, d, vec16);
    stage_rows<DP, STR>(vs, v + (int64_t)t0 * p.v_ss, p.v_ss, kTcKeys, nk, d, vec16);
    if (threadIdx.x < kTcKeys) {
      const int j = threadIdx.x;
      ms[j] = (mask != nullptr && j < nk) ? mask[t0 + j] : 1.f;
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c0 = kk * 16 + 2 * tq;
      const uint32_t a0 = lds32(qw + g * STR + c0);
      const uint32_t a1 = lds32(qw + (g + 8) * STR + c0);
      const uint32_t a2 = lds32(qw + g * STR + c0 + 8);
      const uint32_t a3 = lds32(qw + (g + 8) * STR + c0 + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * STR + c0;
        mma_bf16_16816(s[nt], a0, a1, a2, a3, lds32(kr), lds32(kr + 8));
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * tq + (e & 1);  // key within the tile
        const int qr = e < 2 ? qr0 : qr1;
        float x = s[nt][e] * scale_log2;
        if (j >= nk)
          x = -INFINITY;  // past Sk: no weight at all
        else if (ms[j] <= 0.f || (p.causal && t0 + j > qr + causal_off))
          x = kNegInf;
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // the 4 threads of a group hold one row's 64 columns between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);  // finite: every tile has a real key
    const float mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0);
    const float corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * corr0 + ps0;  // per-thread partial row sums, summed at the end
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= corr0;
      o[dt][1] *= corr0;
      o[dt][2] *= corr1;
      o[dt][3] *= corr1;
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {  // 16 keys per k-step
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // lanes 0-15 address keys kk*16 + 0..15 at columns dt*8, lanes 16-31
      // the same keys at dt*8 + 8: B fragments of head-dim tiles dt, dt + 1
      const __nv_bfloat16* vrow = vs + (kk * 16 + (lane & 15)) * STR + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + dt * 8);
        mma_bf16_16816(o[dt], a0, a1, a2, a3, bv[0], bv[1]);
        mma_bf16_16816(o[dt + 1], a0, a1, a2, a3, bv[2], bv[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? qr0 : qr1;
      const int c = dt * 8 + 2 * tq + (e & 1);
      if (row < p.sq && c < d)
        out[(int64_t)row * p.o_ss + c] = __float2bfloat16(o[dt][e] * (e < 2 ? inv0 : inv1));
    }
  }
}

template <int KS>
cudaError_t launch_tc(const FlashParams& p, int b, int h, cudaStream_t stream) {
  const size_t smem = TcShape<KS>::smem;
  auto kernel = flash_fwd_tc_kernel<KS>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.sq + kTcRows - 1) / kTcRows, h, b);
  kernel<<<grid, kTcWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const FlashParams& p, int b, int h, cudaStream_t stream) {
  switch ((p.d + 15) / 16) {
    case 1: return launch_tc<1>(p, b, h, stream);
    case 2: return launch_tc<2>(p, b, h, stream);
    case 3: return launch_tc<3>(p, b, h, stream);
    case 4: return launch_tc<4>(p, b, h, stream);
    case 5: return launch_tc<5>(p, b, h, stream);
    case 6: return launch_tc<6>(p, b, h, stream);
    case 7: return launch_tc<7>(p, b, h, stream);
    case 8: return launch_tc<8>(p, b, h, stream);
    case 9: return launch_tc<9>(p, b, h, stream);
    case 10: return launch_tc<10>(p, b, h, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v, out in turn.
// is_bf16: 1 for bfloat16 tensors, 0 for float32.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const float* mask,
                              void* out, const int64_t* strides, int b, int h, int sq, int sk,
                              int d, int causal, float scale, int is_bf16, void* stream) {
  if (d < 1 || d > 32 * kMaxAcc || sq < 1 || sk < 1 || b < 1 || h < 1 || b > 65535 ||
      h > 65535)
    return (int)cudaErrorInvalidValue;
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.o = out;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_ss = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.kstr = d | 1;  // odd row stride: lanes reading one column hit distinct banks
  p.causal = causal;
  p.scale = scale;
  const int elem = is_bf16 ? 2 : 4;
  bool vec16 = d % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec16 = vec16 && (strides[i] * elem) % 16 == 0;
  p.vec16 = vec16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // bf16 at head dim <= 160 (the UNet) takes the tensor cores; fp32, and
  // bf16 above 160 (the VAE's 512), the CUDA-core kernel
  cudaError_t err;
  if (is_bf16 && d <= kTcMaxDim)
    err = dispatch_tc(p, b, h, s);
  else
    err = is_bf16 ? dispatch<__nv_bfloat16>(p, b, h, s) : dispatch<float>(p, b, h, s);
  return (int)err;
}

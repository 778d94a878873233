// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the two Pallas TPU kernels of adaface_tpu/ops/attention.py:
//   _flash_t_kernel (transposed layout, head dim < 128, non-causal) and
//   _flash_kernel   (standard layout, causal flag, head dim >= 128).
// Both compute one function, out = softmax(q k^T * scale (+ mask)) v with an
// fp32 online softmax, so the kernels here are split by what the card needs
// (element type and head dim), not by the TPU's layouts. The transposed
// layout was a trick against the TPU's 128-lane padding of small head dims
// and has no counterpart on this card.
//
// Shapes on the SD1.5 serving path: q [B,H,Sq,D], k/v [B,H,Sk,D] with
// D = 40 (Sq 4096), 80 (Sq 1024), 160 (Sq 256) in the UNet, Sk = Sq for
// self-attention or 77 for cross-attention, all views of [B,S,H*D] storage
// (sequence stride H*D, head stride D), and D = 512, H = 1, Sq = Sk = 4096
// in the VAE mid-block.
//
// Four kernels and the split-keys combine, in three sources; the wrapper
// picks by element type, head dim and alignment alone
// (adaface_tpu_torch/ops/attention.py: flash_plan):
//   - bf16, D = 40, 80, 160 (ceil(D/16) in 3, 5, 10), rows on 16-byte
//     boundaries: the wgmma kernel of flash_attn_wgmma.cu. The UNet's path.
//   - every other bf16 tensor (160 < D <= 512: the VAE; other head dims;
//     rows off 16-byte boundaries): the wide-head mma.sync kernel of
//     flash_attn_wide.cu, which pads the head dim to a multiple of 64.
//   - fp32, D <= 512: flash_fwd_fp32 here (flash_fwd_kernel, CUDA cores). No
//     path of the port runs attention in fp32 on the card; it is the exact
//     reference route. It served every shape before the tensor-core kernels
//     and is bound by instruction dispatch: at the VAE's shape 6.4 ms (H100
//     SXM, 700 W) where 34.4 GFLOP bound the bf16 kernels at 0.035 ms.
// A pipelined mma.sync kernel for D <= 160 (cp.async ring of two stages,
// ldmatrix.x4 fragments, registers capped at 128) stood here until the wgmma
// kernel measured faster at every UNet shape (same card, device time per
// launch: 0.312 against 0.169 ms at S = 4096, D = 40; 0.036 against 0.023 ms
// at S = 1024, D = 80); no shape of a path reached it any more.
//
// Masking follows the JAX reference: a key with kv_mask <= 0, or one the
// causal rule (key <= row + Sk - Sq) excludes, gets the logit -1e30, so a
// fully masked row averages V like the plain version does. Keys past Sk (the
// ragged last tile, e.g. Sk = 77) take no part at all. The row sum l is
// guarded (l == 0 -> 1) as in the TPU kernel.
//
// Entry points: plain C functions. They take device pointers, element
// strides of the batch, head and sequence axes of q, k, v and out (the head
// dim must be contiguous), and the stream; they launch on that stream,
// allocate nothing and return cudaGetLastError().

#include "flash_common.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------------
// CUDA-core variant, fp32: one warp per query row, 16 rows per block; K and V
// come through shared memory in tiles of 32 keys; lane j owns key j of the
// tile and computes its full dot product against the row's q (in shared
// memory, read as a broadcast; the K tile's odd row stride puts the 32 lanes
// on 32 banks); online softmax per tile with two warp reductions; P V with
// the lanes splitting the head dim (ceil(D/32) accumulators per lane), each
// key's probability broadcast by shuffle. Bound by instruction dispatch. Its
// ~164 KB of shared memory at D = 512 is above the 48 KB default, so the
// launch raises the block's dynamic shared-memory limit.
// ---------------------------------------------------------------------------

constexpr int kWarps = 16;   // query rows per block, one warp each
constexpr int kTile = 32;    // keys per shared-memory tile, one per lane
constexpr int kMaxAcc = 16;  // accumulators per lane: head dim <= 512

template <int NACC>
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

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* mask = p.mask ? p.mask + b * p.sk : nullptr;

  float* my_q = qs + warp * d;
  if (row_ok) {
    for (int c = lane; c < d; c += 32) my_q[c] = q[(int64_t)row * p.q_ss + c];
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
        kv = k[(int64_t)(t0 + j) * p.k_ss + c];
        vv = v[(int64_t)(t0 + j) * p.v_ss + c];
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
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + (int64_t)row * p.o_ss;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int c = lane + 32 * i;
    if (c < d) o[c] = acc[i] * inv;
  }
}

template <int NACC>
cudaError_t launch(const FlashParams& p, int b, int h, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kWarps * p.d + (size_t)kTile * p.kstr + (size_t)kTile * p.d + kTile);
  auto kernel = flash_fwd_kernel<NACC>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.sq + kWarps - 1) / kWarps, h, b);
  kernel<<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const FlashParams& p, int b, int h, cudaStream_t stream) {
  switch ((p.d + 31) / 32) {
    case 1: return launch<1>(p, b, h, stream);
    case 2: return launch<2>(p, b, h, stream);
    case 3: return launch<3>(p, b, h, stream);
    case 4: return launch<4>(p, b, h, stream);
    case 5: return launch<5>(p, b, h, stream);
    case 6: return launch<6>(p, b, h, stream);
    case 7: return launch<7>(p, b, h, stream);
    case 8: return launch<8>(p, b, h, stream);
    case 9: return launch<9>(p, b, h, stream);
    case 10: return launch<10>(p, b, h, stream);
    case 11: return launch<11>(p, b, h, stream);
    case 12: return launch<12>(p, b, h, stream);
    case 13: return launch<13>(p, b, h, stream);
    case 14: return launch<14>(p, b, h, stream);
    case 15: return launch<15>(p, b, h, stream);
    case 16: return launch<16>(p, b, h, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// fp32, head dim <= 512.
extern "C" int flash_fwd_fp32(const void* q, const void* k, const void* v, const float* mask,
                              void* out, const int64_t* strides, int b, int h, int sq, int sk,
                              int d, int causal, float scale, void* stream) {
  FlashParams p;
  if (!fill_params(p, q, k, v, mask, out, strides, b, h, sq, sk, d, 32 * kMaxAcc, causal, scale,
                   4))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(p, b, h, static_cast<cudaStream_t>(stream));
}

// Int8 post-training-quantized convolution for Hopper (sm_90a), plain CUDA C++.
//
// Replaces no Pallas kernel: the JAX package's int8 serving path is XLA
// (adaface_tpu/ops/quant.py: _quantize_act :58, int8_conv2d :67, int8_dense
// :85), and PyTorch has no eager int8 convolution on CUDA, so these kernels
// are the port's int8 path. Three launches per quantized layer:
//
// quant_amax: the whole tensor's max |x| of a bf16 activation (the scale
//   is one for the whole CFG batch, as in JAX). Each block folds its
//   grid-stride share with fmaxf, then one atomicMax on the bits of the
//   non-negative float: unsigned order is float order there, and a maximum
//   does not depend on the order of the updates, so every run writes the
//   same bits. The wrapper never reads it on the host: the scale stays on
//   the device, and a step that runs these kernels can be captured.
// quant_act: x_q = clip(rint(x / s), -127, 127), s = max(amax, 1e-8) / 127,
//   into an int8 copy of x in the same (channels-last) layout. IEEE
//   division and round-half-to-even, as `jnp.round(xf / scale)` and the
//   plain version compute it.
// int8_conv_igemm: an implicit-GEMM convolution of the channels-last int8
//   map [N, H, W, I] with weights [O, kh, kw, I] (3x3 at stride 1 or 2
//   with padding 1, and 1x1; a dense layer is a 1x1 convolution over its
//   rows). GEMM rows are output pixels, columns output channels, the
//   reduction (ky, kx, i) in 32-channel steps (I must be a multiple of 32).
//   mma.sync m16n8k32 s8 x s8 -> s32: the sums are exact integers (a 3x3
//   over 1280 channels reaches ~1.9e8, past fp32's 2^24). Epilogue, in
//   fp32 and in JAX's order: (float)acc * (x_scale * w_scale[o]), then
//   + bias[o] (the products and the sum rounded on their own: no FMA
//   contraction), stored as bf16 channels-last [N, Ho, Wo, O].
//
// Tiles: 128 pixels x 128 channels a block, 8 warps of 64 x 32, 32-byte
// reduction steps through a 3-stage cp.async ring (16-byte copies; a
// padding tap or a row past the end is a zero-filled copy). Shared rows
// are 48 bytes apart, so the 32-bit fragment loads of a warp hit 32
// different banks. Where the tiles are too few to fill the card (the 8² and
// 16² maps at CFG batch 2: 10-40 tiles over 11,520-23,040 reduction bytes),
// the wrapper splits the reduction over `splits` blocks a tile (grid z):
// each writes its int32 partial tile to the launch's workspace, counts
// itself in the tile's counter (the workspace's tail, zeroed on the stream by
// the entry point), and the block that counts last adds the partials (exact:
// integers, so the order does not change a bit) and runs the epilogue.
//
// What bounds it: int8 operations at the UNet's 3x3 convolutions (the
// tensor cores' 1979 TOP/s on an H100), bytes at the 1x1 and dense layers
// of small maps; the quantization passes are bytes (read 2 B, write 1 B an
// element). mma.sync reaches only part of Hopper's int8 rate (wgmma and TMA
// are the redesign's; ROADMAP).
//
// Entry points: plain C functions that take device pointers and the stream,
// launch on that stream, allocate nothing and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output pixels a block
constexpr int kBN = 128;      // output channels a block
constexpr int kBK = 32;       // bytes of the reduction a step
constexpr int kRow = 48;      // bytes between shared rows: 32 + 16 of padding
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kAmaxThreads = 256;
constexpr int kActThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const uint8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__global__ void __launch_bounds__(kAmaxThreads)
quant_amax_kernel(const __nv_bfloat16* __restrict__ x, int64_t n, unsigned* __restrict__ amax) {
  float m = 0.f;
  const int64_t packs = n / 8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < packs;
       i += stride) {
    uint4 v = __ldg(xv + i);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(__bfloat162float(e[j])));
  }
  for (int64_t i = packs * 8 + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    m = fmaxf(m, fabsf(__bfloat162float(x[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kAmaxThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = warp_max[0];
    for (int w = 1; w < kAmaxThreads / 32; ++w) b = fmaxf(b, warp_max[w]);
    atomicMax(amax, __float_as_uint(b));
  }
}

__device__ __forceinline__ float act_scale(const unsigned* amax) {
  return fmaxf(__uint_as_float(*amax), 1e-8f) / 127.0f;
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

__global__ void __launch_bounds__(kActThreads)
quant_act_kernel(const __nv_bfloat16* __restrict__ x, const unsigned* __restrict__ amax,
                 int8_t* __restrict__ xq, int64_t n) {
  const float s = act_scale(amax);
  const int64_t packs = n / 8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint2* qv = reinterpret_cast<uint2*>(xq);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < packs;
       i += stride) {
    uint4 v = __ldg(xv + i);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    uint2 q;
    int8_t* qe = reinterpret_cast<int8_t*>(&q);
#pragma unroll
    for (int j = 0; j < 8; ++j) qe[j] = quantize(__bfloat162float(e[j]), s);
    qv[i] = q;
  }
  for (int64_t i = packs * 8 + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    xq[i] = quantize(__bfloat162float(x[i]), s);
}

struct ConvGeom {
  int N, H, W, I, O, kh, kw, stride, pad, Ho, Wo;
};

// One thread's share of a reduction step: 16 bytes of its A row (a pixel's
// channels at one tap, zero-filled off the map or past the last pixel) and
// 16 bytes of its B row (an output channel's weights at the same tap).
struct LoadRow {
  bool a_valid, b_valid;
  int pn, hi0, wi0, po, half;
};

__device__ __forceinline__ void load_step(uint8_t* a_dst, uint8_t* b_dst,
                                          const int8_t* __restrict__ xq,
                                          const int8_t* __restrict__ wq, const ConvGeom& g,
                                          const LoadRow& r, int kt, int cblocks) {
  const int tap = kt / cblocks, c0 = (kt - tap * cblocks) * kBK + r.half * 16;
  const int ky = tap / g.kw, kx = tap - ky * g.kw;
  const int hi = r.hi0 + ky, wi = r.wi0 + kx;
  const bool av = r.a_valid && hi >= 0 && hi < g.H && wi >= 0 && wi < g.W;
  const int8_t* asrc =
      av ? xq + ((static_cast<int64_t>(r.pn) * g.H + hi) * g.W + wi) * g.I + c0 : xq;
  cp_async16(a_dst, asrc, av);
  const int8_t* bsrc =
      r.b_valid ? wq + static_cast<int64_t>(r.po) * g.kh * g.kw * g.I +
                      static_cast<int64_t>(tap) * g.I + c0
                : wq;
  cp_async16(b_dst, bsrc, r.b_valid);
}

// two blocks an SM (at most 128 registers a thread): at one block, the 8
// warps alone could not hide the cp.async ring's latency
__global__ void __launch_bounds__(kThreads, 2)
int8_conv_igemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                       const float* __restrict__ w_scale, const float* __restrict__ bias,
                       const unsigned* __restrict__ amax, __nv_bfloat16* __restrict__ y,
                       ConvGeom g, int splits, int* __restrict__ ws, int* __restrict__ counters) {
  __shared__ __align__(16) uint8_t As[kStages][kBM * kRow];
  __shared__ __align__(16) uint8_t Bs[kStages][kBN * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 1, warp_n = warp >> 1;  // 2 x 4 warps of 64 x 32
  const int gq = lane >> 2, tq = lane & 3;           // the fragments' group and thread
  const int64_t M = static_cast<int64_t>(g.N) * g.Ho * g.Wo;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int o0 = blockIdx.y * kBN;

  // each thread copies one 16-byte half of one A row (a pixel) and of one B
  // row (an output channel) a step
  const int ld_row = tid >> 1;
  const int ld_off = ld_row * kRow + (tid & 1) * 16;
  LoadRow r{false, false, 0, 0, 0, o0 + ld_row, tid & 1};
  const int64_t pm = m0 + ld_row;
  r.a_valid = pm < M;
  if (r.a_valid) {
    r.pn = static_cast<int>(pm / (static_cast<int64_t>(g.Ho) * g.Wo));
    const int rem = static_cast<int>(pm - static_cast<int64_t>(r.pn) * g.Ho * g.Wo);
    r.hi0 = (rem / g.Wo) * g.stride - g.pad;
    r.wi0 = (rem % g.Wo) * g.stride - g.pad;
  }
  r.b_valid = r.po < g.O;
  const int cblocks = g.I / kBK;
  const int ksteps = g.kh * g.kw * cblocks;
  // this block's share of the reduction steps
  const int k0 = static_cast<int>(static_cast<int64_t>(blockIdx.z) * ksteps / splits);
  const int kn = static_cast<int>(static_cast<int64_t>(blockIdx.z + 1) * ksteps / splits) - k0;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kn) load_step(&As[s][ld_off], &Bs[s][ld_off], xq, wq, g, r, k0 + s, cblocks);
    cp_async_commit();
  }
  for (int kt = 0; kt < kn; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < kn)
      load_step(&As[next % kStages][ld_off], &Bs[next % kStages][ld_off], xq, wq, g, r,
                k0 + next, cblocks);
    cp_async_commit();
    const uint8_t* a_s = As[kt % kStages];
    const uint8_t* b_s = Bs[kt % kStages];
    unsigned af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const uint8_t* r0 = a_s + (warp_m * 64 + mi * 16 + gq) * kRow + tq * 4;
      af[mi][0] = lds32(r0);
      af[mi][1] = lds32(r0 + 8 * kRow);
      af[mi][2] = lds32(r0 + 16);
      af[mi][3] = lds32(r0 + 8 * kRow + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint8_t* r0 = b_s + (warp_n * 32 + ni * 8 + gq) * kRow + tq * 4;
      bf[ni][0] = lds32(r0);
      bf[ni][1] = lds32(r0 + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
  }
  cp_async_wait<0>();

  if (splits > 1) {
    // publish this split's partial tile; the last block of the tile adds them
    int* part = ws + static_cast<int64_t>(blockIdx.z) * M * g.O;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = o0 + warp_n * 32 + ni * 8 + tq * 2;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = m0 + warp_m * 64 + mi * 16 + gq + h * 8;
          if (row < M && col < g.O)
            *reinterpret_cast<int2*>(part + row * g.O + col) =
                make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
    }
    __threadfence();
    __syncthreads();
    __shared__ int is_last;
    int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) is_last = atomicAdd(counter, 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // the tile's sums, 4 channels of a row a chunk, 16 chunks a thread: the
    // chunks' loads of one split are independent and in flight together
    constexpr int kChunks = kBM * kBN / 4 / kThreads;
    int4 sum[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) sum[c] = make_int4(0, 0, 0, 0);
    for (int z = 0; z < splits; ++z) {
      const int* pz = ws + static_cast<int64_t>(z) * M * g.O;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int idx = tid + c * kThreads;
        const int64_t row = m0 + idx / (kBN / 4);
        const int col = o0 + (idx % (kBN / 4)) * 4;
        if (row < M && col < g.O) {
          const int4 v = __ldcg(reinterpret_cast<const int4*>(pz + row * g.O + col));
          sum[c].x += v.x;
          sum[c].y += v.y;
          sum[c].z += v.z;
          sum[c].w += v.w;
        }
      }
    }
    const float xs = act_scale(amax);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int idx = tid + c * kThreads;
      const int64_t row = m0 + idx / (kBN / 4);
      const int col = o0 + (idx % (kBN / 4)) * 4;
      if (row >= M || col >= g.O) continue;
      const int v[4] = {sum[c].x, sum[c].y, sum[c].z, sum[c].w};
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[j] = __fadd_rn(__fmul_rn(static_cast<float>(v[j]), __fmul_rn(xs, w_scale[col + j])),
                         bias[col + j]);
      __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(y + row * g.O + col);
      out[0] = __halves2bfloat162(__float2bfloat16_rn(f[0]), __float2bfloat16_rn(f[1]));
      out[1] = __halves2bfloat162(__float2bfloat16_rn(f[2]), __float2bfloat16_rn(f[3]));
    }
    return;
  }

  const float xs = act_scale(amax);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = o0 + warp_n * 32 + ni * 8 + tq * 2;
    if (col >= g.O) continue;
    const float s0 = __fmul_rn(xs, w_scale[col]), s1 = __fmul_rn(xs, w_scale[col + 1]);
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = m0 + warp_m * 64 + mi * 16 + gq + h * 8;
        if (row >= M) continue;
        const float v0 = __fadd_rn(__fmul_rn(static_cast<float>(acc[mi][ni][2 * h]), s0), b0);
        const float v1 =
            __fadd_rn(__fmul_rn(static_cast<float>(acc[mi][ni][2 * h + 1]), s1), b1);
        *reinterpret_cast<__nv_bfloat162*>(y + row * g.O + col) =
            __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
      }
    }
  }
}

int grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = 132 * 8;  // a few waves: the loops are grid-stride
  return static_cast<int>(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

}  // namespace

extern "C" int quant_amax(const void* x, int64_t n, void* amax, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_amax_kernel<<<grid_for((n + 7) / 8, kAmaxThreads), kAmaxThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), n, static_cast<unsigned*>(amax));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quant_act(const void* x, const void* amax, void* xq, int64_t n,
                         cudaStream_t stream) {
  quant_act_kernel<<<grid_for((n + 7) / 8, kActThreads), kActThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned*>(amax),
      static_cast<int8_t*>(xq), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int int8_conv_igemm(const void* xq, const void* wq, const void* w_scale,
                               const void* bias, const void* amax, void* y, int N, int H, int W,
                               int I, int O, int kh, int kw, int stride, int pad, int Ho, int Wo,
                               int splits, void* ws, cudaStream_t stream) {
  // ws (splits > 1): splits x M x O int32 partial sums, then one int32 counter a tile
  if (I % kBK != 0 || O % 8 != 0 || splits < 1 || (splits > 1 && !ws))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvGeom g{N, H, W, I, O, kh, kw, stride, pad, Ho, Wo};
  const int64_t M = static_cast<int64_t>(N) * Ho * Wo;
  dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), static_cast<unsigned>((O + kBN - 1) / kBN),
            static_cast<unsigned>(splits));
  int* counters = nullptr;
  if (splits > 1) {
    counters = static_cast<int*>(ws) + splits * M * O;
    cudaError_t err =
        cudaMemsetAsync(counters, 0, sizeof(int) * grid.x * grid.y, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int8_conv_igemm_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      static_cast<const unsigned*>(amax), static_cast<__nv_bfloat16*>(y), g, splits,
      static_cast<int*>(ws), counters);
  return static_cast<int>(cudaGetLastError());
}

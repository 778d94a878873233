// Int8 post-training-quantized convolution for Hopper (sm_90a), plain CUDA C++.
//
// Replaces no Pallas kernel: the JAX package's int8 serving path is XLA
// (adaface_tpu/ops/quant.py: _quantize_act :58, int8_conv2d :67, int8_dense
// :85), and PyTorch has no eager int8 convolution on CUDA, so these kernels
// are the port's int8 path. Two launches per quantized layer, no memset:
//
// quant_act: one cooperative launch (every block resident, a grid barrier
//   between its two passes). First each block folds its grid-stride share of
//   a bf16 activation to max |x| and writes it to its own slot of the
//   layer's scale buffer (the scale is one for the whole CFG batch, as in
//   JAX); then every block folds the slots to the tensor's max |x| (a
//   maximum: the same bits in any order), block 0 writes its bits to the
//   buffer's first word, and each block writes its share of the int8 copy,
//   x_q = clip(rint(x / s), -127, 127), s = max(amax, 1e-8) / 127: IEEE
//   division and round-half-to-even, as `jnp.round(xf / scale)` and the
//   plain version compute it. Every launch writes every slot it reads, so
//   nothing is zeroed beforehand, and two launches on two streams, or two
//   replays of a graph, share nothing (the barrier's state is the launch's
//   own). The scale never leaves the device. The pair of launches it
//   replaced (maxima, then the copy) took the same device time.
// int8_conv_igemm: an implicit-GEMM convolution of the channels-last int8
//   map [N, H, W, I] with weights [O, kh, kw, I] (a dense layer is a 1x1
//   convolution over its rows). GEMM rows are output pixels, columns output
//   channels, the reduction (ky, kx, i) in 128-byte steps. The sums are
//   exact int32 (a 3x3 over 1280 channels reaches ~1.9e8, past fp32's 2^24).
//   Epilogue, in fp32 and in JAX's order: (float)acc * (x_scale *
//   w_scale[o]), then + bias[o] (each rounded on its own: no FMA
//   contraction), stored as bf16 channels-last [N, Ho, Wo, O].
//
// The product's design (int8_wgmma.cuh has the instruction and layouts; the
// measurements behind each choice are `chip_compare.py --int8-plans` runs,
// PERF.md):
//   - a block owns 128 output pixels x N output channels (N = 128 or 160:
//     the plan's, ops/quant.py igemm_plan; 160 divides every quantized width
//     of the SD1.5 UNet, 320, 640 and 1280, where 128 does not divide 320).
//     Two warpgroups of 64 pixels each run wgmma m64nNk32 s8 x s8 -> s32,
//     both operands read from shared memory by descriptor;
//   - the tiles come by TMA into a ring of `stages` stages counted on
//     mbarriers: a stage is the step's 128 x 128-byte tile of pixels and
//     N x 128-byte tile of weights, both with the 128-byte swizzle. The
//     pixels of a 3x3 (or strided) convolution come through TMA's im2col
//     mode: one box is 128 consecutive output pixels (row after row, image
//     after image) at one filter tap, the padding taps and the pixels past
//     the last image arriving as zeros, stride 2 as the map's traversal
//     stride. A 1x1 convolution at stride 1 and a dense layer read plain
//     [rows, I] tiles. The weights are a 3-d map [O, taps, I], so both
//     operands zero-fill a tap's channel tail (320 and 960 channels end in
//     a half-empty step) and the rows past O. Nothing in the block computes
//     an address. 64-byte steps (the 64-byte swizzle) lost at 88 of 96 path
//     shapes;
//   - thread 0 issues the first `stages` steps' copies before the loop;
//     after that, of the two warpgroups, the second to let a stage go (a
//     counter a stage in shared memory) issues the step that refills it, so
//     neither waits for the other. A block is 256 threads, so two blocks
//     share an SM (at most 128 registers a thread: the register file's four
//     partitions hold four warps of 128 each), one block's epilogue beside
//     the other's products. Measured and dropped: a producer warp of its
//     own (nine warps a block: ptxas held to 96 registers for two blocks an
//     SM, too few for N 160, so one block an SM: 4% quicker summed over the
//     CFG batch-2 shapes, no quicker at batch 16); thread 0 waiting for the
//     other warpgroup's release, or testing for it without waiting (1.1-1.35x
//     slower); N 256 (one block an SM; never the quickest summed);
//   - the epilogue stages the bf16 tile in shared memory (over the drained
//     ring, rows padded by 16 bytes) and writes it in 16-byte stores, the
//     neighbouring threads on neighbouring bytes of an output row (stores of
//     4 bytes straight from the accumulators ran the bytes-bound 1x1 and
//     dense layers at 20-25% of their bound);
//   - where output tiles are few (the 8x8-32x32 maps at CFG batch 2, the
//     stride-2 downsamples, the dense layers' few rows) the plan splits the
//     reduction over the `split` blocks of a thread-block cluster (grid z):
//     each block writes its int32 partial tile into its own shared memory
//     (over the drained ring), and after a cluster barrier block r folds the
//     8-column groups r, r + split, ... of every block's tile, in rank
//     order, through distributed shared memory, into registers; after a
//     second cluster barrier it stages and writes those groups. No global
//     workspace, no counters, nothing to zero.
//
// What bounds it: int8 operations at the UNet's 3x3 convolutions (the
// tensor cores' 1979 TOP/s on an H100), bytes at the 1x1 and dense layers of
// small maps; the quantization passes are bytes (read 2 B, write 1 B an
// element, and the maxima pass reads x once more).
//
// Entry points: plain C functions that take device pointers and the stream,
// launch on that stream, allocate nothing and return cudaGetLastError() (or
// 20000 + the CUresult of a tensor map's encoding).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>
#include <vector>

#include "int8_wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace int8mm;

constexpr int kQuantThreads = 256;
constexpr int kMaxSlots = 1024;      // blocks of the quantization passes: one maximum each
constexpr int kRows = 128;           // output pixels a block: two warpgroups of 64
constexpr int kStep = 128;           // bytes of the reduction a stage
constexpr int kThreads = 256;        // two warpgroups; thread 0 also issues the copies
constexpr int kMaxSplit = 16;        // a cluster above 8 blocks is "non-portable": this card takes it
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 227 * 1024;

// ---------------------------------------------------------------------------
// quantization of the activation
// ---------------------------------------------------------------------------

__device__ __forceinline__ float block_max(float m, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ __forceinline__ float max8(float m, const uint4& v) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(__bfloat162float(e[j])));
  return m;
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

__device__ __forceinline__ uint2 quantize8(const uint4& v, float s) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
  uint2 q;
  int8_t* qe = reinterpret_cast<int8_t*>(&q);
#pragma unroll
  for (int j = 0; j < 8; ++j) qe[j] = quantize(__bfloat162float(e[j]), s);
  return q;
}

// quant_act: both passes in one cooperative launch (every block resident),
// a grid barrier between them. Thread t takes the 8-value packs t, t + T,
// t + 2T, ... (T the grid's threads), then the tail values likewise; its
// first kHeld packs stay in its registers across the barrier (4.3 M values
// at two blocks an SM: every input of a CFG batch-2 UNet call but the two
// widest of the 64x64 level is read once), the rest are read
// again, kBatch loads in flight a thread.
constexpr int kHeld = 8;
constexpr int kBatch = 4;

__global__ void __launch_bounds__(kQuantThreads)
quant_act_kernel(const __nv_bfloat16* __restrict__ x, unsigned* __restrict__ amax,
                 int8_t* __restrict__ xq, int64_t n) {
  __shared__ float red[kQuantThreads / 32];
  const int64_t packs = n / 8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 held[kHeld];
  float m = 0.f;
#pragma unroll
  for (int t = 0; t < kHeld; ++t) {
    const int64_t i = i0 + t * stride;
    held[t] = i < packs ? __ldg(xv + i) : zero;
    m = max8(m, held[t]);
  }
  for (int64_t i = i0 + kHeld * stride; i < packs; i += kBatch * stride) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = i + u * stride < packs ? __ldg(xv + i + u * stride) : zero;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) m = max8(m, v[u]);
  }
  for (int64_t i = packs * 8 + i0; i < n; i += stride) m = fmaxf(m, fabsf(__bfloat162float(x[i])));
  m = block_max(m, red);
  if (threadIdx.x == 0) amax[1 + blockIdx.x] = __float_as_uint(m);
  __syncthreads();  // red is written again below
  cg::this_grid().sync();

  m = 0.f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += blockDim.x)
    m = fmaxf(m, __uint_as_float(__ldcg(amax + 1 + i)));
  m = block_max(m, red);
  if (blockIdx.x == 0 && threadIdx.x == 0) amax[0] = __float_as_uint(m);
  const float s = fmaxf(m, 1e-8f) / 127.0f;
  uint2* qv = reinterpret_cast<uint2*>(xq);
#pragma unroll
  for (int t = 0; t < kHeld; ++t) {
    const int64_t i = i0 + t * stride;
    if (i < packs) qv[i] = quantize8(held[t], s);
  }
  for (int64_t i = i0 + kHeld * stride; i < packs; i += kBatch * stride) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = i + u * stride < packs ? __ldg(xv + i + u * stride) : zero;
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i + u * stride < packs) qv[i + u * stride] = quantize8(v[u], s);
  }
  for (int64_t i = packs * 8 + i0; i < n; i += stride) xq[i] = quantize(__bfloat162float(x[i]), s);
}

// blocks of quant_act: two an SM (its 93 registers a thread leave room for
// two resident blocks, and a cooperative launch needs every block
// resident), fewer for a small tensor; one slot each
int quant_blocks(int64_t n) {
  static const int cap = [] {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return 2 * sms < kMaxSlots ? 2 * sms : kMaxSlots;
  }();
  const int64_t blocks = (n / 8 + kQuantThreads - 1) / kQuantThreads;
  return static_cast<int>(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

// ---------------------------------------------------------------------------
// the product
// ---------------------------------------------------------------------------

template <int N>
struct Tile {
  static constexpr int A = kRows * kStep;             // bytes of a stage's pixel tile
  static constexpr int B = N * kStep;                 // and of its weight tile
  static constexpr int STAGE = A + B;                 // a multiple of 1024
  static constexpr int PART = kThreads * (N / 2) * 4;  // a block's int32 partial tile
  static constexpr int OUT = kRows * (2 * N + 16);       // the staged bf16 output tile
  static_assert(OUT <= PART, "the staged output tile fits where the partial tile lies");
  // bytes of the ring, or of what the epilogue lays over it where that is larger
  static int body(int stages, int split) {
    const int ring = stages * STAGE, over = split > 1 ? PART : OUT;
    return over > ring ? over : ring;
  }
  // the body, the barriers and the slack that aligns the body to 1024 bytes
  static int smem(int stages, int split) {
    return body(stages, split) + 2 * kMaxStages * 8 + 1024;
  }
};

struct IgemmArgs {
  const float* w_scale;
  const float* bias;
  const unsigned* amax;  // the bits of max |x|
  __nv_bfloat16* y;
  int64_t rows;          // output pixels (or a dense layer's rows)
  int o;                 // output channels
  int cblocks;           // steps of a tap: ceil(I / step)
  int taps, kw;          // kh * kw, kw
  int ho, wo, stride, pad;
  int im2col;            // the pixels through the im2col map, else the [rows, I] map
  int stages;
  int body;              // Tile::body: where the barriers start
};

// the epilogue of one 8-column group j of a thread's accumulators (acc[4 j ..
// 4 j + 3]: tile rows r and r + 8, columns c and c + 1) into the bf16 output
// tile in shared memory (rows `ostride` bytes apart)
__device__ __forceinline__ void stage_group(const IgemmArgs& p, int j, int v0, int v1, int v2,
                                            int v3, float xs, int r, int o0, unsigned char* out,
                                            int ostride) {
  const int c = 8 * j + 2 * (threadIdx.x & 3);
  const int col = min(o0 + c, p.o - 2);  // past O: any column's scale, the store skips it
  const float s0 = __fmul_rn(xs, p.w_scale[col]), s1 = __fmul_rn(xs, p.w_scale[col + 1]);
  const float b0 = p.bias[col], b1 = p.bias[col + 1];
  *reinterpret_cast<__nv_bfloat162*>(out + r * ostride + 2 * c) = __halves2bfloat162(
      __float2bfloat16_rn(__fadd_rn(__fmul_rn(static_cast<float>(v0), s0), b0)),
      __float2bfloat16_rn(__fadd_rn(__fmul_rn(static_cast<float>(v1), s1), b1)));
  *reinterpret_cast<__nv_bfloat162*>(out + (r + 8) * ostride + 2 * c) = __halves2bfloat162(
      __float2bfloat16_rn(__fadd_rn(__fmul_rn(static_cast<float>(v2), s0), b0)),
      __float2bfloat16_rn(__fadd_rn(__fmul_rn(static_cast<float>(v3), s1), b1)));
}

// the output tile's 8-column groups rank, rank + split, ... of every row,
// shared memory -> y in 16-byte stores, neighbouring threads on neighbouring
// groups of a row (rows past the end and columns past O left out)
template <int N>
__device__ __forceinline__ void write_tile(const IgemmArgs& p, const unsigned char* out,
                                           int ostride, int64_t m0, int o0, int rank, int split) {
  const int groups = (N / 8 - rank + split - 1) / split;
  for (int c = threadIdx.x; c < kRows * groups; c += kThreads) {
    const int r = c / groups, j = rank + (c - r * groups) * split;
    const int64_t row = m0 + r;
    const int col = o0 + 8 * j;
    if (row < p.rows && col < p.o)
      *reinterpret_cast<uint4*>(p.y + row * p.o + col) =
          *reinterpret_cast<const uint4*>(out + r * ostride + 16 * j);
  }
}

// Two blocks an SM (at most 128 registers a thread: the register file's four
// partitions hold four warps of 128 each).
template <int N>
__global__ void __launch_bounds__(kThreads, 2)
int8_conv_igemm_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b, const IgemmArgs p) {
  using T = Tile<N>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles want their atoms on atom boundaries of the shared
  // window: the body starts on 1024
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.body);
  int* released = reinterpret_cast<int*>(full + kMaxStages);  // releases of a stage, all uses

  const int warp = threadIdx.x >> 5;
  const int split = gridDim.z, rank = blockIdx.z;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int o0 = blockIdx.y * N;
  const int ksteps = p.taps * p.cblocks;
  const int k0 = static_cast<int>(static_cast<int64_t>(rank) * ksteps / split);
  const int kn = static_cast<int>(static_cast<int64_t>(rank + 1) * ksteps / split) - k0;
  const bool issuer = (threadIdx.x & 127) == 0;  // thread 0 of each warpgroup

  // base coordinates of the tile's first pixel (im2col: its filter window's
  // top-left corner, padding included)
  int n0 = 0, hb = 0, wb = 0;
  if (issuer && p.im2col) {
    const int64_t per = static_cast<int64_t>(p.ho) * p.wo;
    n0 = static_cast<int>(m0 / per);
    const int rem = static_cast<int>(m0 - n0 * per);
    hb = (rem / p.wo) * p.stride - p.pad;
    wb = (rem % p.wo) * p.stride - p.pad;
  }
  // step `it` of this block's share into its stage: the pixel tile and the
  // weight tile, both counted on the stage's barrier
  auto issue = [&](int it) {
    const int s = it % p.stages;
    const int kstep = k0 + it;
    const int tap = kstep / p.cblocks;
    const int c0 = (kstep - tap * p.cblocks) * kStep;
    unsigned char* a = smem + s * T::STAGE;
    flash::mbar_expect_tx(&full[s], T::STAGE);
    if (p.im2col) {
      const int ky = tap / p.kw, kx = tap - ky * p.kw;
      tma_load_im2col(a, &map_a, &full[s], c0, wb, hb, n0, static_cast<uint16_t>(kx),
                      static_cast<uint16_t>(ky));
    } else {
      tma_load_2d(a, &map_a, &full[s], c0, static_cast<int>(m0));
    }
    tma_load_3d(a + T::A, &map_b, &full[s], c0, tap, o0);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      flash::mbar_init(&full[s], 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    flash::prefetch_map(&map_a);
    flash::prefetch_map(&map_b);
    for (int it = 0; it < p.stages && it < kn; ++it) issue(it);
  }
  __syncthreads();

  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  {
    // each warpgroup: 64 of the tile's pixels against all N channels
    const uint32_t ring = smem_addr(smem);
    const uint32_t a_off = (warp >> 2) * 64 * kStep;
    for (int it = 0; it < kn; ++it) {
      const int s = it % p.stages;
      flash::mbar_wait(&full[s], (it / p.stages) & 1);
      const uint32_t a = ring + s * T::STAGE + a_off;
      const uint32_t b = ring + s * T::STAGE + T::A;
      fence_acc(acc);
      flash::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 32; ++kk)
        wgmma_s8<N>(acc, kmajor128(a, kk), kmajor128(b, kk));
      flash::wgmma_commit();
      wgmma_wait<1>();  // the step before this one has been read: its stage is free
      fence_acc(acc);
      // the second warpgroup to let step it - 1 go (an odd count: the stage's
      // counter grows by two a use) refills its stage with step it - 1 +
      // stages: neither waits for the other
      if (it > 0 && issuer) {
        const int ps = (it - 1) % p.stages;
        __threadfence_block();
        if (atomicAdd(&released[ps], 1) & 1) {
          __threadfence_block();
          if (it - 1 + p.stages < kn) issue(it - 1 + p.stages);
        }
      }
      __syncwarp();
    }
    wgmma_wait<0>();
    fence_acc(acc);
  }

  // the epilogue
  const float xs = fmaxf(__uint_as_float(*p.amax), 1e-8f) / 127.0f;
  const int lane = threadIdx.x & 31;
  // a thread's tile rows: r and r + 8 of its warp's 16 in its warpgroup's 64
  const int r = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  // the bf16 output tile, rows padded by 16 bytes (conflict-free staging),
  // over the drained ring or the partial tile: smaller than either
  constexpr int ostride = 2 * N + 16;
  unsigned char* out = smem;
  __syncthreads();  // every wgmma has read its stage: the ring is free
  if (split == 1) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      stage_group(p, j, acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3], xs, r, o0,
                  out, ostride);
  } else {
    // split reduction through the cluster's shared memory: the partial
    // tile, group j of consumer t at part[j * 256 + t], over the drained ring
    int4* part = reinterpret_cast<int4*>(smem);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      part[j * kThreads + threadIdx.x] =
          make_int4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's partial tile is in its shared memory
    // this block's groups rank, rank + split, ... folded in rank order
    int4 sum[N / 16];
#pragma unroll
    for (int t = 0; t < N / 16; ++t) {
      sum[t] = make_int4(0, 0, 0, 0);
      const int j = rank + t * split;
      if (j < N / 8) {
        for (int q = 0; q < split; ++q) {
          const int4 v = cluster.map_shared_rank(part, q)[j * kThreads + threadIdx.x];
          sum[t].x += v.x;
          sum[t].y += v.y;
          sum[t].z += v.z;
          sum[t].w += v.w;
        }
      }
    }
    cluster.sync();  // every block has read the partial tiles: the shared memory is free
#pragma unroll
    for (int t = 0; t < N / 16; ++t) {
      const int j = rank + t * split;
      if (j < N / 8)
        stage_group(p, j, sum[t].x, sum[t].y, sum[t].z, sum[t].w, xs, r, o0, out, ostride);
    }
  }
  __syncthreads();  // the tile is staged
  write_tile<N>(p, out, ostride, m0, o0, rank, split);
}

// ---------------------------------------------------------------------------
// tensor maps, kept per (pointer, shape): the allocator hands a model the
// same addresses step after step, and an encoding costs the host a few us
// ---------------------------------------------------------------------------

using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeIm2col encode_im2col() {
  static EncodeIm2col fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeIm2col>(ptr);
  }();
  return fn;
}

enum MapKind { kRowsMap = 0, kIm2colMap = 1, kWeightMap = 2 };

struct MapKey {
  const void* ptr;
  int64_t v[7];
  bool operator==(const MapKey& o) const {
    if (ptr != o.ptr) return false;
    for (int i = 0; i < 7; ++i)
      if (v[i] != o.v[i]) return false;
    return true;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t x = reinterpret_cast<size_t>(k.ptr);
    for (int64_t v : k.v) x = x * 1099511628211ull ^ static_cast<size_t>(v);
    return x;
  }
};
constexpr size_t kMaxMaps = 4096;
std::mutex map_mu;

// the map of `key` from the cache, or made by encode(map) and kept: 0, or
// 20000 + the CUresult (20000 alone: the driver's entry point was not found)
template <class Encode>
int cached_map(CUtensorMap* map, const MapKey& key, Encode&& encode) {
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  std::lock_guard<std::mutex> lock(map_mu);
  auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return 0;
  }
  const int rc = encode(map);
  if (rc != 0) return rc;
  if (maps.size() >= kMaxMaps) maps.clear();
  maps.emplace(key, *map);
  return 0;
}

// [rows, i] int8 rows, box (128 bytes, 128 rows), the 128-byte swizzle
int rows_map(CUtensorMap* map, const void* ptr, int64_t rows, int i) {
  return cached_map(map, MapKey{ptr, {kRowsMap, rows, i, 0, 0, 0, 0}}, [&](CUtensorMap* m) {
    const flash::EncodeTiled encode = flash::encode_tiled();
    if (encode == nullptr) return 20000;
    const cuuint64_t dims[2] = {(cuuint64_t)i, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)i};
    const cuuint32_t box[2] = {kStep, kRows};
    const cuuint32_t ones[2] = {1, 1};
    const CUresult rc = encode(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                               strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return rc == CUDA_SUCCESS ? 0 : 20000 + (int)rc;
  });
}

// [n, h, w, i] int8 map in im2col mode for a k x k filter at `stride` with
// `pad`: the bounding box of the filter windows' top-left corners runs from
// -pad to (extent - 1) + pad - (k - 1) along W and H, walked at the stride;
// a box is 128 pixels of 128 channels
int im2col_map(CUtensorMap* map, const void* ptr, int n, int h, int w, int i, int k, int stride,
               int pad) {
  return cached_map(map, MapKey{ptr, {kIm2colMap, n, h, w, i, k * 16 + stride, pad}},
                    [&](CUtensorMap* m) {
    const EncodeIm2col encode = encode_im2col();
    if (encode == nullptr) return 20000;
    const cuuint64_t dims[4] = {(cuuint64_t)i, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
    const cuuint64_t strides[3] = {(cuuint64_t)i, (cuuint64_t)w * i, (cuuint64_t)h * w * i};
    const int lower[2] = {-pad, -pad};
    const int upper[2] = {pad - (k - 1), pad - (k - 1)};
    const cuuint32_t traversal[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
    const CUresult rc = encode(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr), dims,
                               strides, lower, upper, kStep, kRows, traversal,
                               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc != CUDA_SUCCESS) return 20000 + (int)rc;
    // CUTLASS's encoder (cute/atom/copy_traits_sm90_im2col.hpp) clears this
    // bit of an im2col map over fewer than 128 KiB on drivers up to 13.1
    int driver = 0;
    if (cudaDriverGetVersion(&driver) == cudaSuccess && driver <= 13010 &&
        (int64_t)n * h * w * i < 131072)
      reinterpret_cast<uint64_t*>(m)[1] &= ~(1ull << 21);
    return 0;
  });
}

// weights [o, taps, i] int8, box (128 bytes, 1 tap, tile_n channels)
int weight_map(CUtensorMap* map, const void* ptr, int o, int taps, int i, int tile_n) {
  return cached_map(map, MapKey{ptr, {kWeightMap, o, taps, i, tile_n, 0, 0}},
                    [&](CUtensorMap* m) {
    const flash::EncodeTiled encode = flash::encode_tiled();
    if (encode == nullptr) return 20000;
    const cuuint64_t dims[3] = {(cuuint64_t)i, (cuuint64_t)taps, (cuuint64_t)o};
    const cuuint64_t strides[2] = {(cuuint64_t)i, (cuuint64_t)taps * i};
    const cuuint32_t box[3] = {kStep, 1, (cuuint32_t)tile_n};
    const cuuint32_t ones[3] = {1, 1, 1};
    const CUresult rc = encode(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims,
                               strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return rc == CUDA_SUCCESS ? 0 : 20000 + (int)rc;
  });
}

// the instance's attributes, once: up to kMaxSmem of dynamic shared memory,
// clusters of up to 16, and the SM's whole carveout as shared memory (two
// blocks of ~110 KB an SM)
template <int N>
cudaError_t prepare_igemm() {
  static const cudaError_t prepared = [] {
    cudaError_t e = cudaFuncSetAttribute(int8_conv_igemm_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(int8_conv_igemm_kernel<N>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(int8_conv_igemm_kernel<N>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return prepared;
}

template <int N>
int launch_igemm(const CUtensorMap& map_a, const CUtensorMap& map_b, IgemmArgs p, int split,
                 cudaStream_t stream) {
  using T = Tile<N>;
  const cudaError_t prepared = prepare_igemm<N>();
  if (prepared != cudaSuccess) return (int)prepared;
  p.body = T::body(p.stages, split);
  const int smem = T::smem(p.stages, split);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((p.rows + kRows - 1) / kRows), (unsigned)((p.o + N - 1) / N),
                     (unsigned)split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;  // a block alone is its own cluster
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, int8_conv_igemm_kernel<N>, map_a, map_b, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// x: n bf16 values on 16 bytes; amax: 1 + 1024 words, the bits of max |x|
// into the first, the blocks' maxima after it; xq: n int8. One cooperative
// launch of quant_act.
extern "C" int int8_quantize(const void* x, int64_t n, void* amax, void* xq,
                             cudaStream_t stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quant_act_kernel, kQuantThreads, 0);
    return sms * per_sm;
  }();
  int blocks = quant_blocks(n);
  if (blocks > resident) blocks = resident;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  unsigned* words = static_cast<unsigned*>(amax);
  int8_t* q = static_cast<int8_t*>(xq);
  void* args[] = {&xb, &words, &q, &n};
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(quant_act_kernel),
                                                    dim3(blocks), dim3(kQuantThreads), args, 0,
                                                    stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

namespace {

using LaunchFn = int (*)(const CUtensorMap&, const CUtensorMap&, IgemmArgs, int, cudaStream_t);

// the instance of a tile width, or null
LaunchFn instance(int tile_n) {
  return tile_n == 128 ? launch_igemm<128> : tile_n == 160 ? launch_igemm<160> : nullptr;
}

// One layer's launch, kept by int8_igemm_prepare: everything but the
// activation, its scale and the output.
struct IgemmLaunch {
  IgemmArgs p;
  CUtensorMap map_b;
  LaunchFn launch;
  int n, h, w, i, k, split;
};
std::mutex launch_mu;
std::vector<IgemmLaunch> launches;

int launch_prepared(const IgemmLaunch& l, const void* xq, const void* amax, void* y,
                    cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(xq) % 16 != 0) return (int)cudaErrorInvalidValue;
  IgemmArgs p = l.p;
  p.amax = static_cast<const unsigned*>(amax);
  p.y = static_cast<__nv_bfloat16*>(y);
  CUtensorMap map_a;
  const int rc = p.im2col ? im2col_map(&map_a, xq, l.n, l.h, l.w, l.i, l.k, p.stride, p.pad)
                          : rows_map(&map_a, xq, p.rows, l.i);
  if (rc != 0) return rc;
  return l.launch(map_a, l.map_b, p, l.split, stream);
}

}  // namespace

// Keeps the launch of one layer at one input shape and returns its handle
// (>= 0), or minus a cudaError_t / 20000 + the CUresult of the weights' map.
// wq: int8 [o, k, k, i]; w_scale, bias: fp32 [o]; the activation int8 [n, h,
// w, i] (a dense layer: [rows, 1, 1, i]) and the output bf16 [n, ho, wo, o]
// come with each launch. i a multiple of 16, o of 8, wq on 16 bytes; tile_n
// 128 or 160; stages 2..8; split 1..16 (blocks of a cluster that split the
// reduction). The wrapper keeps the handles per
// (weights, shape, plan): a launch then passes four pointers.
extern "C" int64_t int8_igemm_prepare(const void* wq, const void* w_scale, const void* bias,
                                      int n, int h, int w, int i, int o, int k, int stride,
                                      int pad, int ho, int wo, int tile_n, int stages, int split) {
  IgemmLaunch l;
  l.launch = instance(tile_n);
  if (i < 16 || i % 16 != 0 || o < 8 || o % 8 != 0 || k < 1 || stride < 1 || pad < 0 ||
      split < 1 || split > kMaxSplit || stages < 2 || stages > kMaxStages ||
      l.launch == nullptr || reinterpret_cast<uintptr_t>(wq) % 16 != 0)
    return -(int64_t)cudaErrorInvalidValue;
  l.p.w_scale = static_cast<const float*>(w_scale);
  l.p.bias = static_cast<const float*>(bias);
  l.p.amax = nullptr;
  l.p.y = nullptr;
  l.p.rows = static_cast<int64_t>(n) * ho * wo;
  l.p.o = o;
  l.p.cblocks = (i + kStep - 1) / kStep;
  l.p.taps = k * k;
  l.p.kw = k;
  l.p.ho = ho;
  l.p.wo = wo;
  l.p.stride = stride;
  l.p.pad = pad;
  l.p.im2col = !(k == 1 && stride == 1 && pad == 0);
  l.p.stages = stages;
  l.p.body = 0;
  l.n = n;
  l.h = h;
  l.w = w;
  l.i = i;
  l.k = k;
  l.split = split;
  const int rc = weight_map(&l.map_b, wq, o, k * k, i, tile_n);
  if (rc != 0) return -(int64_t)rc;
  std::lock_guard<std::mutex> lock(launch_mu);
  launches.push_back(l);
  return static_cast<int64_t>(launches.size()) - 1;
}

// xq: the int8 activation on 16 bytes; amax: its scale's words (the bits of
// max |x| first, as int8_quantize writes them); y: the bf16 output.
extern "C" int int8_conv_igemm(int64_t handle, const void* xq, const void* amax, void* y,
                               cudaStream_t stream) {
  IgemmLaunch l;
  {
    std::lock_guard<std::mutex> lock(launch_mu);
    if (handle < 0 || handle >= static_cast<int64_t>(launches.size()))
      return (int)cudaErrorInvalidValue;
    l = launches[handle];
  }
  return launch_prepared(l, xq, amax, y, stream);
}

// Blocks of an instance one SM holds at once (cudaOccupancy...), into
// *blocks, for a plan's tile width, stages and split; returns a cudaError_t.
extern "C" int int8_igemm_occupancy(int tile_n, int stages, int split, int* blocks) {
  if (tile_n == 128 && prepare_igemm<128>() == cudaSuccess)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, int8_conv_igemm_kernel<128>, kThreads, Tile<128>::smem(stages, split));
  if (tile_n == 160 && prepare_igemm<160>() == cudaSuccess)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, int8_conv_igemm_kernel<160>, kThreads, Tile<160>::smem(stages, split));
  return (int)cudaErrorInvalidValue;
}

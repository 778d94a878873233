// Train-mode batch norm statistics and normalize + leaky-ReLU for Hopper
// (sm_90a), plain CUDA C++.
//
// Replaces the two Pallas TPU kernels of adaface_tpu/ops/fused_norm.py:
//   _stats_kernel    -> bn_partial_kernel + bn_finalize_kernel (`bn_stats`):
//                       per-channel mean and rstd of x [R, C];
//   _norm_act_kernel -> bn_norm_act_kernel (`bn_norm_act`):
//                       (x - mean) * rstd * scale + bias, then leaky-ReLU.
// The TPU kernel carried one running sum through a sequential grid of row
// blocks. Blocks on the card run in parallel and in no order, so here the
// rows are cut into a fixed number of chunks; each block sums one chunk for
// 32 channels into a caller-allocated [2, chunks, C] fp32 workspace, and a
// second small pass adds the chunks in a fixed order (in fp64) and forms
// mean and rstd = 1/sqrt(E[x^2] - mean^2 + eps), the TPU kernel's formula.
// No float atomics: the sums repeat bit for bit from run to run, which a
// kernels-vs-plain comparison of a whole train step needs.
//
// What bounds it: both passes over x are memory bound (two flops per
// element for the statistics, five for the normalize). The statistics pass
// reads x once; lanes of a warp read neighbouring channels of one row, so a
// warp's load is one contiguous span of the row. The wrapper picks the
// chunk count so that about 8 blocks per SM are in flight at the largest
// shapes (R = 802,816 rows of the BiSeNet stem at batch 16, 448x448) and a
// single block at the smallest (R = 16, the 1x1 attention maps). The
// normalize pass is a grid-stride elementwise loop with 16-byte loads and
// stores where C and the pointers allow (4 fp32 or 8 bf16 channels).
//
// Entry points: bn_stats() and bn_norm_act(), plain C functions that take
// device pointers and the stream, launch on that stream, allocate nothing
// and return the first CUDA error of their launches (0 if none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStatsCh = 32;    // channels per statistics block, one per lane
constexpr int kStatsRows = 8;   // row lanes per statistics block (warps)
constexpr int kFinalThreads = 256;
constexpr int kNormThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

// psum/psq [chunks, C]: sums of x and x^2 over rows [k*rows_per_chunk, ...)
// for the block's 32 channels.
template <typename T>
__global__ void __launch_bounds__(kStatsCh * kStatsRows)
bn_partial_kernel(const T* __restrict__ x, float* __restrict__ psum, float* __restrict__ psq,
                  int64_t rows, int c, int64_t rows_per_chunk) {
  __shared__ float red_s[kStatsRows][kStatsCh];
  __shared__ float red_q[kStatsRows][kStatsCh];
  const int ch = blockIdx.y * kStatsCh + threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;
  float s = 0.f, q = 0.f;
  if (ch < c) {
#pragma unroll 4
    for (int64_t r = r0 + threadIdx.y; r < r1; r += kStatsRows) {
      const float v = to_f(x[r * c + ch]);
      s += v;
      q = fmaf(v, v, q);
    }
  }
  red_s[threadIdx.y][threadIdx.x] = s;
  red_q[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
#pragma unroll
    for (int i = 1; i < kStatsRows; ++i) {
      s += red_s[i][threadIdx.x];
      q += red_q[i][threadIdx.x];
    }
    psum[(int64_t)blockIdx.x * c + ch] = s;
    psq[(int64_t)blockIdx.x * c + ch] = q;
  }
}

// stats [2, C]: mean, then rstd.
__global__ void __launch_bounds__(kFinalThreads)
bn_finalize_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
                   float* __restrict__ stats, int chunks, int c, int64_t rows, float eps) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  double s = 0.0, q = 0.0;
  for (int k = 0; k < chunks; ++k) {
    s += psum[(int64_t)k * c + ch];
    q += psq[(int64_t)k * c + ch];
  }
  const double mean = s / (double)rows;
  const double var = q / (double)rows - mean * mean;
  stats[ch] = (float)mean;
  stats[c + ch] = (float)(1.0 / sqrt(var + (double)eps));
}

// x, y: [R, C] contiguous, taken as nvec packs of V channels of one row.
template <typename T, int V>
__global__ void __launch_bounds__(kNormThreads)
bn_norm_act_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                   const float* __restrict__ rstd, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y, int64_t nvec, int c,
                   float slope) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = i * V;
    const int ch = (int)(e % c);
    const Pack<T, V> in = *reinterpret_cast<const Pack<T, V>*>(x + e);
    Pack<T, V> out;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = (to_f(in.v[j]) - mean[ch + j]) * rstd[ch + j];
      v = fmaf(v, scale[ch + j], bias[ch + j]);
      out.v[j] = from_f<T>(v >= 0.f ? v : v * slope);
    }
    *reinterpret_cast<Pack<T, V>*>(y + e) = out;
  }
}

template <typename T, int V>
void launch_norm_act(const void* x, const float* mean, const float* rstd, const float* scale,
                     const float* bias, void* y, int64_t n, int c, float slope,
                     cudaStream_t s) {
  const int64_t nvec = n / V;
  int64_t blocks = (nvec + kNormThreads - 1) / kNormThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond a few waves
  bn_norm_act_kernel<T, V><<<(unsigned)blocks, kNormThreads, 0, s>>>(
      static_cast<const T*>(x), mean, rstd, scale, bias, static_cast<T*>(y), nvec, c, slope);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x: [rows, c] contiguous; partial: 2*chunks*c floats of scratch; stats:
// 2*c floats out (mean, then rstd).
extern "C" int bn_stats(const void* x, float* partial, float* stats, int64_t rows, int c,
                        int chunks, float eps, int is_bf16, void* stream) {
  if (rows < 1 || c < 1 || chunks < 1 || (c + kStatsCh - 1) / kStatsCh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows_per_chunk = (rows + chunks - 1) / chunks;
  const dim3 grid((unsigned)chunks, (unsigned)((c + kStatsCh - 1) / kStatsCh));
  const dim3 block(kStatsCh, kStatsRows);
  float* psum = partial;
  float* psq = partial + (int64_t)chunks * c;
  if (is_bf16)
    bn_partial_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), psum, psq, rows, c, rows_per_chunk);
  else
    bn_partial_kernel<float><<<grid, block, 0, s>>>(static_cast<const float*>(x), psum, psq,
                                                    rows, c, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_finalize_kernel<<<(c + kFinalThreads - 1) / kFinalThreads, kFinalThreads, 0, s>>>(
      psum, psq, stats, chunks, c, rows, eps);
  return (int)cudaGetLastError();
}

// x, y: [rows, c] contiguous of one dtype; mean, rstd, scale, bias: [c] fp32.
extern "C" int bn_norm_act(const void* x, const float* mean, const float* rstd,
                           const float* scale, const float* bias, void* y, int64_t rows,
                           int c, float slope, int is_bf16, void* stream) {
  if (rows < 1 || c < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = rows * c;
  const bool vec = aligned16(x) && aligned16(y);
  if (is_bf16) {
    if (vec && c % 8 == 0)
      launch_norm_act<__nv_bfloat16, 8>(x, mean, rstd, scale, bias, y, n, c, slope, s);
    else
      launch_norm_act<__nv_bfloat16, 1>(x, mean, rstd, scale, bias, y, n, c, slope, s);
  } else {
    if (vec && c % 4 == 0)
      launch_norm_act<float, 4>(x, mean, rstd, scale, bias, y, n, c, slope, s);
    else
      launch_norm_act<float, 1>(x, mean, rstd, scale, bias, y, n, c, slope, s);
  }
  return (int)cudaGetLastError();
}

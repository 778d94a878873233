// LayerNorm over the last axis for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel _ln_kernel of adaface_tpu/ops/fused_ln.py:
// each row of x [rows, C] gets fp32 statistics (the mean, then the centred
// sum of squares: the plain version's `var`), then (x - mean) * rstd *
// weight + bias, in x's dtype. The TPU kernel held a block of rows in VMEM.
//
// ln_fwd_rows, the kernel of the UNet's widths. The row lives in registers:
// LPR lanes of a warp share a row (8, 16 or 32), each lane holds PPL 16-byte
// packs (8 bf16 or 4 fp32 channels) that lie LPR packs apart, so that
// neighbouring lanes read neighbouring packs; C = V * PPL * LPR exactly, one
// instance for each (PPL, LPR). A lane starts all its loads of x, then of
// weight and bias, before the first use; both statistics come from the
// registers through sub-warp shuffles; x is read from device memory once
// and nothing is read again. Lanes are fitted to the row: C = 320 in bf16 is
// 40 packs = 8 lanes x 5 (four rows a warp, every lane busy, 80 bytes a lane
// in flight), 640 is 16 x 5, 1280 is 32 x 5, 320 in fp32 16 x 5. The
// wrapper's plan picks the block so that the grid covers the card.
//
// ln_fwd_split, for few wide rows (the UNet's 512 and 128 rows of 1280): a
// row over WPR warps of one block, one pack a lane (C = V * 32 * WPR), the
// warps' sums exchanged through shared memory, twice. A lane then has one
// load and eight adds before the first reduction, not five and forty, and
// the card holds five times the warps: measured 0.2-0.3 us ahead of one warp
// a row at both shapes.
//
// What bounds it: memory at the UNet's 8192 x 320 rows (a few flops an
// element), and below ~2 MB the chain of one launch, one round trip to
// device memory, two reductions and the store; an empty kernel's own time in
// the same CUDA graph (launch_floor.cu) is the floor there.
//
// ln_fwd_loop takes every other width, and rows off 16 bytes (V = 1): one
// warp a row, the row read three times (device memory, then L1 twice) in
// loops of c / V packs.
//
// Entry point: layer_norm(), a plain C function that takes device pointers
// and the stream, launches on that stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLoopWarps = 8;
constexpr int kMaxPacks = 8;  // packs a lane holds at the most
constexpr int kMaxSplit = 8;  // warps a row is split over at the most

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

// Sum over the W lanes (a power of two) that share a row; every lane of the
// warp takes part and gets its own group's sum.
template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// x, y: [rows, V * PPL * LPR]; blockDim.x / LPR rows a block.
template <typename T, int V, int PPL, int LPR>
__global__ void __launch_bounds__(256)
ln_fwd_rows(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
            T* __restrict__ y, int64_t rows, float eps) {
  constexpr int C = V * PPL * LPR;
  const int lane = threadIdx.x % LPR;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / LPR) + threadIdx.x / LPR;
  const bool live = row < rows;  // a dead group still takes part in the shuffles

  Pack<T, V> px[PPL], pw[PPL], pb[PPL];
  if (live) {
    const Pack<T, V>* xr = reinterpret_cast<const Pack<T, V>*>(x + row * C);
#pragma unroll
    for (int i = 0; i < PPL; ++i) px[i] = xr[lane + i * LPR];
  } else {
#pragma unroll
    for (int i = 0; i < PPL; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) px[i].v[j] = from_f<T>(0.f);
  }
  const Pack<T, V>* wp = reinterpret_cast<const Pack<T, V>*>(w);
  const Pack<T, V>* bp = reinterpret_cast<const Pack<T, V>*>(b);
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    pw[i] = wp[lane + i * LPR];
    pb[i] = bp[lane + i * LPR];
  }

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PPL; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) s += to_f(px[i].v[j]);
  const float mean = group_sum<LPR>(s) / (float)C;

  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PPL; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = to_f(px[i].v[j]) - mean;
      q = fmaf(d, d, q);
    }
  const float rstd = rsqrtf(group_sum<LPR>(q) / (float)C + eps);

  if (!live) return;
  Pack<T, V>* yr = reinterpret_cast<Pack<T, V>*>(y + row * C);
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    Pack<T, V> out;
#pragma unroll
    for (int j = 0; j < V; ++j)
      out.v[j] = from_f<T>(
          fmaf((to_f(px[i].v[j]) - mean) * rstd, to_f(pw[i].v[j]), to_f(pb[i].v[j])));
    yr[lane + i * LPR] = out;
  }
}

// x, y: [rows, V * 32 * WPR]; one row a block of WPR warps.
template <typename T, int V, int WPR>
__global__ void __launch_bounds__(32 * WPR)
ln_fwd_split(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
             T* __restrict__ y, float eps) {
  constexpr int C = V * 32 * WPR;
  __shared__ float part_s[WPR], part_q[WPR];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x;
  const Pack<T, V> px = reinterpret_cast<const Pack<T, V>*>(x + row * C)[threadIdx.x];
  const Pack<T, V> pw = reinterpret_cast<const Pack<T, V>*>(w)[threadIdx.x];
  const Pack<T, V> pb = reinterpret_cast<const Pack<T, V>*>(b)[threadIdx.x];

  float s = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) s += to_f(px.v[j]);
  s = group_sum<32>(s);
  if (lane == 0) part_s[warp] = s;
  __syncthreads();
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < WPR; ++p) sum += part_s[p];
  const float mean = sum / (float)C;

  float q = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = to_f(px.v[j]) - mean;
    q = fmaf(d, d, q);
  }
  q = group_sum<32>(q);
  if (lane == 0) part_q[warp] = q;
  __syncthreads();
  sum = 0.f;
#pragma unroll
  for (int p = 0; p < WPR; ++p) sum += part_q[p];
  const float rstd = rsqrtf(sum / (float)C + eps);

  Pack<T, V> out;
#pragma unroll
  for (int j = 0; j < V; ++j)
    out.v[j] = from_f<T>(fmaf((to_f(px.v[j]) - mean) * rstd, to_f(pw.v[j]), to_f(pb.v[j])));
  reinterpret_cast<Pack<T, V>*>(y + row * C)[threadIdx.x] = out;
}

__device__ __forceinline__ float warp_sum(float v) { return group_sum<32>(v); }

// Any width: one warp a row, the row read three times.
template <typename T, int V>
__global__ void __launch_bounds__(32 * kLoopWarps)
ln_fwd_loop(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
            T* __restrict__ y, int64_t rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kLoopWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const Pack<T, V>* xr = reinterpret_cast<const Pack<T, V>*>(x + row * c);
  const int nv = c / V;

  float s = 0.f;
  for (int i = lane; i < nv; i += 32) {
    const Pack<T, V> p = xr[i];
#pragma unroll
    for (int j = 0; j < V; ++j) s += to_f(p.v[j]);
  }
  const float mean = warp_sum(s) / (float)c;

  float q = 0.f;
  for (int i = lane; i < nv; i += 32) {
    const Pack<T, V> p = xr[i];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = to_f(p.v[j]) - mean;
      q = fmaf(d, d, q);
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)c + eps);

  const Pack<T, V>* wp = reinterpret_cast<const Pack<T, V>*>(w);
  const Pack<T, V>* bp = reinterpret_cast<const Pack<T, V>*>(b);
  Pack<T, V>* yr = reinterpret_cast<Pack<T, V>*>(y + row * c);
  for (int i = lane; i < nv; i += 32) {
    const Pack<T, V> p = xr[i], pw = wp[i], pb = bp[i];
    Pack<T, V> out;
#pragma unroll
    for (int j = 0; j < V; ++j)
      out.v[j] = from_f<T>(fmaf((to_f(p.v[j]) - mean) * rstd, to_f(pw.v[j]), to_f(pb.v[j])));
    yr[i] = out;
  }
}

template <typename T, int V>
cudaError_t launch_loop(const void* x, const void* w, const void* b, void* y, int64_t rows,
                        int c, float eps, cudaStream_t s) {
  const int64_t blocks = (rows + kLoopWarps - 1) / kLoopWarps;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  ln_fwd_loop<T, V><<<(unsigned)blocks, 32 * kLoopWarps, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), rows, c, eps);
  return cudaGetLastError();
}

template <typename T, int V, int PPL, int LPR>
cudaError_t launch_rows(const void* x, const void* w, const void* b, void* y, int64_t rows,
                        int threads, float eps, cudaStream_t s) {
  const int rows_per_block = threads / LPR;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  ln_fwd_rows<T, V, PPL, LPR><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), rows, eps);
  return cudaGetLastError();
}

template <typename T, int V, int PPL>
cudaError_t launch_rows_lpr(const void* x, const void* w, const void* b, void* y, int64_t rows,
                            int lpr, int threads, float eps, cudaStream_t s) {
  switch (lpr) {
    case 8: return launch_rows<T, V, PPL, 8>(x, w, b, y, rows, threads, eps, s);
    case 16: return launch_rows<T, V, PPL, 16>(x, w, b, y, rows, threads, eps, s);
    case 32: return launch_rows<T, V, PPL, 32>(x, w, b, y, rows, threads, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int V>
cudaError_t launch_rows_ppl(const void* x, const void* w, const void* b, void* y, int64_t rows,
                            int ppl, int lpr, int threads, float eps, cudaStream_t s) {
  switch (ppl) {
    case 1: return launch_rows_lpr<T, V, 1>(x, w, b, y, rows, lpr, threads, eps, s);
    case 2: return launch_rows_lpr<T, V, 2>(x, w, b, y, rows, lpr, threads, eps, s);
    case 3: return launch_rows_lpr<T, V, 3>(x, w, b, y, rows, lpr, threads, eps, s);
    case 4: return launch_rows_lpr<T, V, 4>(x, w, b, y, rows, lpr, threads, eps, s);
    case 5: return launch_rows_lpr<T, V, 5>(x, w, b, y, rows, lpr, threads, eps, s);
    case 6: return launch_rows_lpr<T, V, 6>(x, w, b, y, rows, lpr, threads, eps, s);
    case 7: return launch_rows_lpr<T, V, 7>(x, w, b, y, rows, lpr, threads, eps, s);
    case 8: return launch_rows_lpr<T, V, 8>(x, w, b, y, rows, lpr, threads, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int V, int WPR>
cudaError_t launch_split_one(const void* x, const void* w, const void* b, void* y, int64_t rows,
                             float eps, cudaStream_t s) {
  ln_fwd_split<T, V, WPR><<<(unsigned)rows, 32 * WPR, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), eps);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_split(const void* x, const void* w, const void* b, void* y, int64_t rows,
                         int warps, float eps, cudaStream_t s) {
  if (rows > 2147483647LL) return cudaErrorInvalidValue;
  switch (warps) {
    case 2: return launch_split_one<T, V, 2>(x, w, b, y, rows, eps, s);
    case 3: return launch_split_one<T, V, 3>(x, w, b, y, rows, eps, s);
    case 4: return launch_split_one<T, V, 4>(x, w, b, y, rows, eps, s);
    case 5: return launch_split_one<T, V, 5>(x, w, b, y, rows, eps, s);
    case 6: return launch_split_one<T, V, 6>(x, w, b, y, rows, eps, s);
    case 7: return launch_split_one<T, V, 7>(x, w, b, y, rows, eps, s);
    case 8: return launch_split_one<T, V, 8>(x, w, b, y, rows, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x, y: [rows, c] contiguous; w, b: [c]; all of one dtype. Geometry from the
// wrapper's plan: packs > 0 and warps = 1 takes ln_fwd_rows with `packs`
// 16-byte packs a lane, `lanes` lanes a row (c = vec * packs * lanes) and
// `threads` a block (a multiple of 32, at most 256); warps > 1 takes
// ln_fwd_split with a row over `warps` warps (packs = 1, lanes = 32, c = vec
// * 32 * warps); both want all pointers 16-byte aligned. packs = 0 takes
// ln_fwd_loop, with 16-byte packs where c and the pointers allow.
extern "C" int layer_norm(const void* x, const void* w, const void* b, void* y, int64_t rows,
                          int c, int packs, int lanes, int warps, int threads, float eps,
                          int is_bf16, void* stream) {
  if (rows < 1 || c < 1 || packs < 0 || packs > kMaxPacks || warps < 1 || warps > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(w) && aligned16(b) && aligned16(y);
  const int pack = is_bf16 ? 8 : 4;
  if (warps > 1) {
    if (!vec || packs != 1 || lanes != 32 || (int64_t)pack * 32 * warps != c ||
        threads != 32 * warps)
      return (int)cudaErrorInvalidValue;
    return (int)(is_bf16 ? launch_split<__nv_bfloat16, 8>(x, w, b, y, rows, warps, eps, s)
                         : launch_split<float, 4>(x, w, b, y, rows, warps, eps, s));
  }
  if (packs > 0) {
    if (!vec || (int64_t)pack * packs * lanes != c || threads < 32 || threads > 256 ||
        threads % 32)
      return (int)cudaErrorInvalidValue;
    return (int)(is_bf16 ? launch_rows_ppl<__nv_bfloat16, 8>(x, w, b, y, rows, packs, lanes,
                                                             threads, eps, s)
                         : launch_rows_ppl<float, 4>(x, w, b, y, rows, packs, lanes, threads,
                                                     eps, s));
  }
  if (is_bf16)
    return (int)(vec && c % 8 == 0 ? launch_loop<__nv_bfloat16, 8>(x, w, b, y, rows, c, eps, s)
                                   : launch_loop<__nv_bfloat16, 1>(x, w, b, y, rows, c, eps, s));
  return (int)(vec && c % 4 == 0 ? launch_loop<float, 4>(x, w, b, y, rows, c, eps, s)
                                 : launch_loop<float, 1>(x, w, b, y, rows, c, eps, s));
}

// LayerNorm over the last axis for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel _ln_kernel of adaface_tpu/ops/fused_ln.py:
// each row of x [rows, C] gets fp32 statistics, then (x - mean) * rstd *
// weight + bias, in x's dtype. The TPU kernel held a block of rows in VMEM
// and took var = E[x^2] - mean^2 across the lanes. Here one warp owns one
// row: it reads the row for the mean, again for the centred sum of squares
// (the plain version's `var`), and a third time to write the output.
//
// What bounds it: memory (a few flops per element). The UNet's rows are at
// most 1280 bf16 = 2.5 KB, so the second and third reads of a row come from
// L1, and device memory sees one read and one write per element. Lanes read
// 16-byte packs (8 bf16 or 4 fp32 channels) where C and the pointers allow,
// neighbouring lanes on neighbouring packs. Eight rows per 256-thread block:
// the UNet's 8192 x 320 rows at CFG batch 2 are 1024 blocks, its 128 x 1280
// rows only 16, which leaves most of the card idle for that call.
//
// Entry point: layer_norm(), a plain C function that takes device pointers
// and the stream, launches on that stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                  T* __restrict__ y, int64_t rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
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
void launch(const void* x, const void* w, const void* b, void* y, int64_t rows, int c,
            float eps, cudaStream_t s) {
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  layer_norm_kernel<T, V><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), rows, c, eps);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x, y: [rows, c] contiguous; w, b: [c]; all of one dtype.
extern "C" int layer_norm(const void* x, const void* w, const void* b, void* y, int64_t rows,
                          int c, float eps, int is_bf16, void* stream) {
  if (rows < 1 || c < 1 || (rows + kWarps - 1) / kWarps > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(w) && aligned16(b) && aligned16(y);
  if (is_bf16) {
    if (vec && c % 8 == 0)
      launch<__nv_bfloat16, 8>(x, w, b, y, rows, c, eps, s);
    else
      launch<__nv_bfloat16, 1>(x, w, b, y, rows, c, eps, s);
  } else {
    if (vec && c % 4 == 0)
      launch<float, 4>(x, w, b, y, rows, c, eps, s);
    else
      launch<float, 1>(x, w, b, y, rows, c, eps, s);
  }
  return (int)cudaGetLastError();
}

// Train-mode batch norm statistics and normalize + leaky-ReLU for Hopper
// (sm_90a), plain CUDA C++.
//
// Replaces the two Pallas TPU kernels of adaface_tpu/ops/fused_norm.py:
//   _stats_kernel    -> bn_stats_kernel (`bn_stats`): per-channel mean and
//                       rstd = 1/sqrt(E[x^2] - mean^2 + eps) of x [R, C], the
//                       TPU kernel's formula, in one launch;
//   _norm_act_kernel -> bn_norm_act_kernel (`bn_norm_act`):
//                       (x - mean) * rstd * scale + bias, then leaky-ReLU.
// The TPU kernel carried one running sum through a sequential grid of row
// blocks. Blocks on the card run in parallel and in no order, so the rows
// are cut into `chunks` spans, one block each.
//
// bn_stats_kernel. A block covers a tile of channels of its rows (the plan
// gives it 128 bytes of a row, 32 fp32 or 64 bf16 channels; blockIdx.y walks
// the tiles). `lanes` threads lie side by side on a row, each on one 16-byte
// pack (4 fp32 or 8 bf16 channels); the block's other threads take further
// rows (`row lanes`), and a thread walks down its rows with eight
// independent loads in flight, summing x and x^2 in fp32 registers. Row lanes
// of one warp fold by shuffles, warps through shared memory in warp order,
// and the block writes its sums to psum/psq [chunks, C]. Then it takes a
// ticket of its channel tile with an integer atomicInc (after
// __threadfence); the block that draws a tile's last ticket folds the tile's
// partials: `klanes` threads a channel each add every klanes-th chunk in
// index order in fp64, a shared-memory tree of fixed shape adds the klanes
// sums, and mean and rstd are formed in fp64. The order depends on indices
// only, never on which block arrived when, and there is no float atomic: the
// statistics repeat bit for bit from run to run, which a kernels-vs-plain
// comparison of a whole train step needs. A counter wraps to 0 on the last
// ticket, so it needs no reset; the wrapper gives every stream counters of
// its own. A map of one chunk skips partials and ticket: its block's sums
// are the map's.
//
// What bounds it: memory. The statistics read x once (two flops an element);
// one block an SM with 16-byte loads streams at 2.5-2.9 TB/s on an H100, and
// a ring of bulk copies (TMA) into shared memory measured no faster. What is
// left at the small maps is one launch plus the fold, and the fold is bound
// by what one SM can pull from L2 (about 0.1 TB/s): a block that folded all
// C channels of a few hundred chunks alone would read up to 0.8 MB (13-30 us
// measured at 12544 x 256 and 3136 x 512 with whole-row tiles, 6-7 us with
// narrow ones). So the channel tiles are narrow and each tile has its own
// ticket: the folds of a wide map run on as many SMs as it has tiles, each
// over at most (blocks / tiles) chunks of a tile's channels, and the
// partials' loads are started eight at a time by hand (`__ldcg` in a loop of
// dependent adds serialized to 0.23 us a chunk). The earlier design gave the
// fold one thread a channel in a second launch: 1.4 us + 0.0475 us a chunk,
// 26.5 us at 528 chunks of 64 channels, more than the streaming pass at
// every shape but the two largest. The normalize pass is a grid-stride
// elementwise loop with 16-byte loads and stores where C and the pointers
// allow; it reads x from L2 where the map fits.
//
// Entry points: bn_stats() and bn_norm_act(), plain C functions that take
// device pointers and the stream, launch on that stream, allocate nothing
// and return the first CUDA error of their launch (0 if none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStatsMaxThreads = 512;
constexpr int kStatsUnroll = 8;  // independent loads a thread keeps in flight
constexpr int kFoldBatch = 8;    // chunks a thread of the fold loads at once
constexpr int kTickets = 32;     // counters a launch may use: BN_TICKETS of the wrapper
constexpr int kNormThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

// Add rows r, r + step, ... below r1 of one pack of channels to s (sum) and q
// (sum of squares) while U of them are left, U loads in flight, rows in
// order; returns the first row not taken.
template <typename T, int V, int U>
__device__ __forceinline__ int64_t sum_rows(const T* __restrict__ xc, int64_t r, int64_t r1,
                                            int64_t step, int c, float (&s)[V], float (&q)[V]) {
  for (; r + (U - 1) * step < r1; r += U * step) {
    Pack<T, V> in[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      in[u] = *reinterpret_cast<const Pack<T, V>*>(xc + (r + u * step) * c);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = to_f(in[u].v[j]);
        s[j] += v;
        q[j] = fmaf(v, v, q[j]);
      }
  }
  return r;
}

// After the rows: s, q (a thread's sums of its pack of channels) to the
// block's sums, the ticket, and the last block's fold (see the header).
// `smem_d`: max(2 * row_lanes * lanes * V floats, 2 * blockDim doubles).
template <int V>
__device__ __forceinline__ void finish_stats(float (&s)[V], float (&q)[V], double* smem_d,
                                             float* psum, float* psq, float* __restrict__ stats,
                                             unsigned int* ticket, int64_t rows, int c, int lanes,
                                             float eps) {
  float* red = reinterpret_cast<float*>(smem_d);
  __shared__ bool is_last;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int row_lanes = threads / lanes;
  const int lane = tid % lanes, rl = tid / lanes;
  const int tile_c = lanes * V;
  const int chunks = gridDim.x;

  // Row lanes to one sum a channel. Where a warp holds whole rows of lanes
  // (lanes divides 32) its row lanes fold by shuffles first, and `parts`
  // warps are left; else all `row_lanes` go through shared memory.
  const bool by_warp = lanes < 32 && 32 % lanes == 0;
  if (by_warp) {
    for (int off = 16; off >= lanes; off >>= 1)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] += __shfl_down_sync(0xffffffffu, s[j], off);
        q[j] += __shfl_down_sync(0xffffffffu, q[j], off);
      }
  }
  const int parts = by_warp ? threads / 32 : row_lanes;
  const int part = by_warp ? tid / 32 : rl;
  float* red_s = red;
  float* red_q = red + parts * tile_c;
  if (part < parts && (!by_warp || (tid & 31) < lanes)) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red_s[part * tile_c + lane * V + j] = s[j];
      red_q[part * tile_c + lane * V + j] = q[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < tile_c; i += threads) {
    const int ch = blockIdx.y * tile_c + i;
    float a = red_s[i], b = red_q[i];
    for (int k = 1; k < parts; ++k) {
      a += red_s[k * tile_c + i];
      b += red_q[k * tile_c + i];
    }
    if (ch < c) {
      if (chunks == 1) {  // the block's sums are the map's: no partials, no ticket
        const double mean = (double)a / (double)rows;
        const double var = (double)b / (double)rows - mean * mean;
        stats[ch] = (float)mean;
        stats[c + ch] = (float)(1.0 / sqrt(var + (double)eps));
      } else {
        psum[(int64_t)blockIdx.x * c + ch] = a;
        psq[(int64_t)blockIdx.x * c + ch] = b;
      }
    }
  }
  if (chunks == 1) return;

  // The ticket: every thread's partials are visible device-wide before the
  // block counts itself in. Channel tile y counts on ticket y % kTickets,
  // with the other tiles that share it.
  const int tickets = gridDim.y < kTickets ? gridDim.y : kTickets;
  const int tk = blockIdx.y % tickets;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned int total = gridDim.x * ((gridDim.y - tk + tickets - 1) / tickets);
    is_last = atomicInc(ticket + tk, total - 1) == total - 1;  // wraps to 0 on the last
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The fold of this ticket's channel tiles: klanes threads a channel, chunks
  // kl, kl + klanes, ... in index order in fp64 (kFoldBatch loads in flight),
  // then a tree over the klanes sums.
  const int nch = tile_c < threads ? tile_c : threads;
  int klanes = 1;
  while (klanes * 2 * nch <= threads) klanes *= 2;
  double* fold_s = smem_d;
  double* fold_q = smem_d + threads;
  const int fc = tid % nch, kl = tid / nch;
  for (int tile = tk; tile < (int)gridDim.y; tile += tickets) {
    const int tile_end = (tile + 1) * tile_c < c ? (tile + 1) * tile_c : c;
    for (int cb = tile * tile_c; cb < tile_end; cb += nch) {
      const int ch = cb + fc;
      const bool on = kl < klanes && ch < tile_end;
      double a = 0.0, b = 0.0;
      if (on) {
        const float* ps = psum + ch;
        const float* pq = psq + ch;
        int k = kl;
        for (; k + (kFoldBatch - 1) * klanes < chunks; k += kFoldBatch * klanes) {
          float fa[kFoldBatch], fb[kFoldBatch];
#pragma unroll
          for (int u = 0; u < kFoldBatch; ++u) {
            fa[u] = __ldcg(ps + (int64_t)(k + u * klanes) * c);
            fb[u] = __ldcg(pq + (int64_t)(k + u * klanes) * c);
          }
#pragma unroll
          for (int u = 0; u < kFoldBatch; ++u) {
            a += (double)fa[u];
            b += (double)fb[u];
          }
        }
        for (; k < chunks; k += klanes) {
          a += (double)__ldcg(ps + (int64_t)k * c);
          b += (double)__ldcg(pq + (int64_t)k * c);
        }
      }
      __syncthreads();  // the sums of the channels before are read
      if (kl < klanes) {
        fold_s[kl * nch + fc] = a;
        fold_q[kl * nch + fc] = b;
      }
      __syncthreads();
      for (int half = klanes / 2; half > 0; half >>= 1) {
        if (kl < half) {
          fold_s[kl * nch + fc] += fold_s[(kl + half) * nch + fc];
          fold_q[kl * nch + fc] += fold_q[(kl + half) * nch + fc];
        }
        __syncthreads();
      }
      if (on && kl == 0) {
        const double mean = fold_s[fc] / (double)rows;
        const double var = fold_q[fc] / (double)rows - mean * mean;
        stats[ch] = (float)mean;
        stats[c + ch] = (float)(1.0 / sqrt(var + (double)eps));
      }
    }
  }
}

// One launch: per-chunk sums, then the last block's fold (see the header).
// grid (chunks, channel tiles of lanes * V channels); dynamic shared memory
// as `finish_stats` wants it. psum/psq [chunks, C]; stats [2, C]: mean, then
// rstd.
template <typename T, int V>
__global__ void __launch_bounds__(kStatsMaxThreads)
bn_stats_kernel(const T* __restrict__ x, float* psum, float* psq, float* __restrict__ stats,
                unsigned int* ticket, int64_t rows, int c, int64_t rows_per_chunk, int lanes,
                float eps) {
  extern __shared__ double smem_d[];
  const int tid = threadIdx.x;
  const int row_lanes = blockDim.x / lanes;
  const int lane = tid % lanes, rl = tid / lanes;
  const int ch0 = blockIdx.y * lanes * V + lane * V;  // C % V == 0: a pack is inside C or outside
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;

  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.f;
  if (rl < row_lanes && ch0 < c) {
    const T* xc = x + ch0;
    const int64_t step = row_lanes;
    int64_t r = r0 + rl;
    r = sum_rows<T, V, kStatsUnroll>(xc, r, r1, step, c, s, q);
    r = sum_rows<T, V, 4>(xc, r, r1, step, c, s, q);
    r = sum_rows<T, V, 2>(xc, r, r1, step, c, s, q);
    sum_rows<T, V, 1>(xc, r, r1, step, c, s, q);
  }
  finish_stats<V>(s, q, smem_d, psum, psq, stats, ticket, rows, c, lanes, eps);
}

template <typename T, int V>
cudaError_t launch_stats(const void* x, float* partial, float* stats, unsigned int* ticket,
                         int64_t rows, int c, int chunks, int64_t rows_per_chunk, int threads,
                         int lanes, float eps, cudaStream_t s) {
  const int tile_c = lanes * V;
  const int ctiles = (c + tile_c - 1) / tile_c;
  if (ctiles > 65535) return cudaErrorInvalidValue;
  const size_t sum_bytes = (size_t)2 * (threads / lanes) * tile_c * sizeof(float);
  const size_t fold_bytes = (size_t)2 * threads * sizeof(double);
  const size_t smem = sum_bytes > fold_bytes ? sum_bytes : fold_bytes;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  bn_stats_kernel<T, V><<<dim3((unsigned)chunks, (unsigned)ctiles), threads, smem, s>>>(
      static_cast<const T*>(x), partial, partial + (int64_t)chunks * c, stats, ticket, rows, c,
      rows_per_chunk, lanes, eps);
  return cudaGetLastError();
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
// 2*c floats out (mean, then rstd); ticket: kTickets counters at 0 that no
// other stream uses (the kernel leaves them at 0). Geometry from the wrapper's plan:
// `chunks` blocks along the rows, each on `chunk_rows` rows, `threads` a
// block (a multiple of 32), `lanes` of them side by side on a row, each on
// `vec` channels: 4 fp32 or 8 bf16 (x 16-byte aligned, c a multiple), or 1,
// the scalar instance.
extern "C" int bn_stats(const void* x, float* partial, float* stats, void* ticket, int64_t rows,
                        int c, int chunks, int64_t chunk_rows, int threads, int lanes, int vec,
                        float eps, int is_bf16, void* stream) {
  const int pack = is_bf16 ? 8 : 4;
  if (rows < 1 || c < 1 || chunks < 1 || chunk_rows < 1 || chunks * chunk_rows < rows ||
      threads < 32 || threads > kStatsMaxThreads ||
      threads % 32 || lanes < 1 || lanes > threads || (vec != 1 && vec != pack) ||
      (vec != 1 && (c % vec || !aligned16(x))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* t = static_cast<unsigned int*>(ticket);
  cudaError_t err;
  if (is_bf16)
    err = vec == 1 ? launch_stats<__nv_bfloat16, 1>(x, partial, stats, t, rows, c, chunks,
                                                    chunk_rows, threads, lanes, eps, s)
                   : launch_stats<__nv_bfloat16, 8>(x, partial, stats, t, rows, c, chunks,
                                                    chunk_rows, threads, lanes, eps, s);
  else
    err = vec == 1 ? launch_stats<float, 1>(x, partial, stats, t, rows, c, chunks, chunk_rows,
                                            threads, lanes, eps, s)
                   : launch_stats<float, 4>(x, partial, stats, t, rows, c, chunks, chunk_rows,
                                            threads, lanes, eps, s);
  return (int)err;
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

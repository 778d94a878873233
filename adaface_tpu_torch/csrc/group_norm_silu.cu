// GroupNorm (+ optional SiLU) for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the two Pallas TPU kernels of adaface_tpu/ops/fused_gn.py:
//   _stats_kernel: per-channel sums over row blocks of an NHWC map, folded
//                  into group statistics between the two calls;
//   _norm_kernel:  (x - mean) * rstd * scale + bias, then SiLU when asked.
// Like them, the kernels here read a map as [B, rows = H*W, C] rows: the
// port keeps its activations in channels-last memory, the layout in which
// this card's convolutions run without transposes.
//
// What bounds it: bytes. The function needs x read once and y written once
// (a few operations per element). Three kernels share one arithmetic:
//   gn_fused_kernel  one launch, x read from device memory once. A thread
//       block cluster owns (sample, channel slab); each block copies its
//       share of the rows into shared memory (16-byte cp.async), reduces
//       it, leaves its group partials in its own shared memory, reads the
//       other blocks' partials through distributed shared memory, and
//       normalizes from shared memory.
//   gn_stats_kernel + gn_norm_kernel  for maps that do not fit the
//       cluster's shared memory: (sample, slab, row chunk) blocks write
//       group partials to a workspace; the normalize kernel's prologue folds
//       the partials of its own groups (no third launch), its body is one
//       16-byte pass. Three passes over x in all.
// The design, in every kernel:
//   - a thread owns one 16-byte pack of channels (8 bf16, 4 fp32) and walks
//     down rows, so its channels never change, the row is a loop counter,
//     and neighbouring threads read neighbouring addresses. No integer
//     division per element: a few per thread before the loops.
//   - a slab is a whole number of groups and of packs (channels per group
//     of 10 or 30 make a pack straddle two groups), at least 64 channels
//     wide where the map has them (128 for the split pair, which streams
//     from device memory), so a row segment is whole cache lines.
//     Channel sums are folded into groups in shared memory after the row
//     loop.
//   - variance that survives a large mean without a second pass over x: a
//     block sums (x - p) and (x - p)^2 per channel with the pivot p = the
//     channel's value in the block's first row, which gives the chunk's
//     (n, mean, M2) per channel; channels fold into groups and chunks into
//     the whole by  mean = sum n_k mean_k / N,
//     M2 = sum (M2_k + n_k (mean_k - mean)^2), the exact two-pass form on
//     partials. Never E[x^2] - mean^2 of raw values.
//   - no float atomics: every sum is taken in a fixed order (per-thread row
//     order, lanes in order through shared memory, shuffle trees), so two
//     runs give the same bits.
//   - rows are cut over blocks so that the grid fills the 132 SMs at batch
//     1: the caller picks slab, chunk count and threads per shape
//     (`gn_plan` in ops/fused_gn.py) and this file only checks them.
//
// Where autograd records a forward, gn_fused and gn_norm also write the
// (mean, rstd) they used to stats[B, G, 2] (gn_fused: the cluster's rank-0
// block; gn_norm: the chunk-0 block after its prologue's fold); with a null
// pointer they write nothing and their output is the same.
//
// The backward (replaces the XLA `_gn_bwd` of the same file, :143-148, the
// VJP of `_gn_silu_ref`) reads those statistics: it never computes them
// again. With x^ = (x - mean) rstd, z = x^ g + b and dz = dy silu'(z) (or
// dy), dx = rstd (g dz - mean_g(g dz) - x^ mean_g(g dz x^)), the means over
// each (sample, group); dbeta = sum dz, dgamma = sum dz x^. Bound by bytes:
// x and dy read once and dx written once is the function's least traffic.
//   gn_bwd_fused_kernel  one launch for every map a cluster's shared memory
//       holds (every UNet map, the VAE's 64x64): a cluster owns (sample,
//       slab); one thread of each block asks for all of the block's rows of
//       x and dy at once, as TMA boxes of a 3-d tensor map (C, rows, B), one
//       box of each a stage, up to 8 stages on one mbarrier each, so that
//       the whole tile is in flight (one bulk copy a row segment instead
//       measured 1.8x slower: 512 small requests a block); the block sums
//       each stage (sum dz and sum dz x^ per channel) as it lands, folds
//       them into gamma-weighted group sums, reads the other blocks' through
//       distributed shared memory in rank order, and writes dx from the
//       tile: 3 passes, the bound.
//   gn_bwd_reduce_kernel + gn_bwd_dx_kernel  for larger maps: (sample, slab,
//       row chunk) blocks, four rows a thread in flight. The reduce writes
//       each chunk's group sums to a [B, G, chunks, 2] workspace; the dx
//       kernel's prologue folds its groups' (a warp a group, lanes over
//       chunks), then writes dx. 5 passes.
// Per-(sample, channel) sums of dz and dz x^ (dbeta, dgamma before the sum
// over samples, and over chunks for the pair) are written only when a
// pointer is given. No float atomics: every sum in a fixed order.
//
// Entry points: gn_fused(), gn_stats(), gn_norm(), gn_bwd_fused(),
// gn_bwd_reduce() and gn_bwd_dx(), plain C functions that take device
// pointers and the stream, launch on that stream, allocate nothing and return
// cudaGetLastError(); gn_bwd_fused_clusters() asks the occupancy of a cluster.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wgmma.cuh"  // mbarrier and TMA helpers

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may ask for
constexpr int kMaxCluster = 16;   // above 8 is "non-portable": this card takes it
constexpr int kMaxThreads = 512;

struct Geom {
  int rows;      // H*W
  int c;         // channels
  int cpg;       // channels per group
  int slab;      // channels per block: a multiple of cpg and of a pack
  int rows_per;  // rows per block
  int nchunks;   // blocks that share the rows of one (sample, slab)
};

// What this block and this thread work on.
struct Where {
  int b, chunk, c0, row0, nrows, lanes, pack, lane;
  bool active;
};

template <int VEC>
__device__ __forceinline__ Where locate(const Geom& g) {
  Where w;
  w.b = blockIdx.y;
  w.chunk = blockIdx.x % g.nchunks;
  w.c0 = (blockIdx.x / g.nchunks) * g.slab;
  w.row0 = w.chunk * g.rows_per;
  w.nrows = min(g.rows_per, g.rows - w.row0);
  const int ps = g.slab / VEC;
  w.lanes = blockDim.x / ps;
  w.pack = threadIdx.x % ps;
  w.lane = threadIdx.x / ps;
  w.active = w.lane < w.lanes;
  return w;
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
  v[4] = __uint_as_float(u.z << 16);
  v[5] = __uint_as_float(u.z & 0xffff0000u);
  v[6] = __uint_as_float(u.w << 16);
  v[7] = __uint_as_float(u.w & 0xffff0000u);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]),
                    bf16x2(v[6], v[7]));
}

__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 ld16(const char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Floats of shared memory the statistics need, after the fused kernel's tile.
struct Scratch {
  float *red_s, *red_q, *mid_s, *mid_q, *piv, *cmean, *cm2, *part, *fin;
  int mids;  // the lanes' sums are added in `mids` interleaved shares first
};

__host__ __device__ inline int mid_shares(int threads, int lanes, int slab) {
  const int shares = threads / slab;
  return shares < 1 ? 1 : (shares > lanes ? lanes : shares);
}

__host__ __device__ inline int scratch_floats(int threads, int lanes, int slab, int gps) {
  return 2 * (lanes + mid_shares(threads, lanes, slab)) * slab + 3 * slab + 4 * gps;
}

__device__ __forceinline__ Scratch carve(float* sm, int lanes, int slab, int gps) {
  Scratch s;
  s.mids = mid_shares(blockDim.x, lanes, slab);
  s.red_s = sm;
  s.red_q = s.red_s + lanes * slab;
  s.mid_s = s.red_q + lanes * slab;
  s.mid_q = s.mid_s + s.mids * slab;
  s.piv = s.mid_q + s.mids * slab;
  s.cmean = s.piv + slab;
  s.cm2 = s.cmean + slab;
  s.part = s.cm2 + slab;
  s.fin = s.part + 2 * gps;
  return s;
}

template <int VEC>
__device__ __forceinline__ void accumulate(const uint4& u, const float (&p)[VEC],
                                           float (&s)[VEC], float (&q)[VEC]) {
  float v[VEC];
  unpack(u, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float d = v[i] - p[i];
    s[i] += d;
    q[i] = fmaf(d, d, q[i]);
  }
}

// Group partials (mean, M2) of this block's rows of its slab, into part[2*gps]
// (shared or global memory). base points at the block's first row, first
// channel of the slab; rows are row_bytes apart (device memory or the tile).
// pivot: this thread's pack of the block's first row.
template <int VEC>
__device__ void chunk_partials(const char* base, int64_t row_bytes, const uint4& pivot,
                               const Geom& g, const Where& w, const Scratch& sm, float* part) {
  if (w.active) {
    float p[VEC], s[VEC], q[VEC];
    const char* src = base + w.pack * 16;
    unpack(pivot, p);
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
    int r = w.lane;
    for (; r + 3 * w.lanes < w.nrows; r += 4 * w.lanes) {
      const uint4 u0 = ld16(src + (int64_t)r * row_bytes);
      const uint4 u1 = ld16(src + (int64_t)(r + w.lanes) * row_bytes);
      const uint4 u2 = ld16(src + (int64_t)(r + 2 * w.lanes) * row_bytes);
      const uint4 u3 = ld16(src + (int64_t)(r + 3 * w.lanes) * row_bytes);
      accumulate<VEC>(u0, p, s, q);
      accumulate<VEC>(u1, p, s, q);
      accumulate<VEC>(u2, p, s, q);
      accumulate<VEC>(u3, p, s, q);
    }
    for (; r < w.nrows; r += w.lanes) accumulate<VEC>(ld16(src + (int64_t)r * row_bytes), p, s, q);
    float* rs = sm.red_s + w.lane * g.slab + w.pack * VEC;
    float* rq = sm.red_q + w.lane * g.slab + w.pack * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      rs[i] = s[i];
      rq[i] = q[i];
    }
    if (w.lane == 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm.piv[w.pack * VEC + i] = p[i];
    }
  }
  __syncthreads();
  // the lanes' sums in a fixed order, in two steps so that the whole block
  // shares the additions: share j of a channel adds lanes j, j + mids, ...
  for (int item = threadIdx.x; item < sm.mids * g.slab; item += blockDim.x) {
    const int j = item / g.slab;
    const int ch = item - j * g.slab;
    float s = 0.f, q = 0.f;
    for (int l = j; l < w.lanes; l += sm.mids) {
      s += sm.red_s[l * g.slab + ch];
      q += sm.red_q[l * g.slab + ch];
    }
    sm.mid_s[item] = s;
    sm.mid_q[item] = q;
  }
  __syncthreads();
  // the chunk's (mean, M2) per channel
  const float n = (float)w.nrows;
  const float inv_n = 1.f / n;
  for (int ch = threadIdx.x; ch < g.slab; ch += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int j = 0; j < sm.mids; ++j) {
      s += sm.mid_s[j * g.slab + ch];
      q += sm.mid_q[j * g.slab + ch];
    }
    sm.cmean[ch] = sm.piv[ch] + s * inv_n;
    sm.cm2[ch] = fmaxf(q - s * s * inv_n, 0.f);
  }
  __syncthreads();
  // channels into groups, one warp a group
  const int lane32 = threadIdx.x & 31;
  const int gps = g.slab / g.cpg;
  for (int gl = threadIdx.x >> 5; gl < gps; gl += blockDim.x >> 5) {
    const float* cm = sm.cmean + gl * g.cpg;
    const float* c2 = sm.cm2 + gl * g.cpg;
    float m = 0.f;
    for (int i = lane32; i < g.cpg; i += 32) m += cm[i];
    m = warp_sum(m) / (float)g.cpg;
    float v = 0.f;
    for (int i = lane32; i < g.cpg; i += 32) {
      const float d = cm[i] - m;
      v += c2[i] + n * d * d;
    }
    v = warp_sum(v);
    if (lane32 == 0) {
      part[2 * gl] = m;
      part[2 * gl + 1] = v;
    }
  }
}

// Fold the chunks' partials of this block's groups into (mean, rstd) in
// fin[2*gps]. kCluster: chunk k's partials lie in the shared memory of the
// cluster's block k, at part[2 * group]; else in device memory, at
// part[(group * nchunks + k) * 2], so that a warp reads neighbouring chunks.
template <bool kCluster>
__device__ void combine_chunks(float* part, const Geom& g, float eps, float* fin) {
  const int lane32 = threadIdx.x & 31;
  const int gps = g.slab / g.cpg;
  const float total = (float)g.rows * (float)g.cpg;
  for (int gl = threadIdx.x >> 5; gl < gps; gl += blockDim.x >> 5) {
    auto partial = [&](int k) {
      const float* pk = kCluster ? cg::this_cluster().map_shared_rank(part, k) + 2 * gl
                                 : part + ((int64_t)gl * g.nchunks + k) * 2;
      return *reinterpret_cast<const float2*>(pk);
    };
    auto count = [&](int k) {
      return (float)(min(g.rows_per, g.rows - k * g.rows_per) * g.cpg);
    };
    // the first chunk of each lane stays in registers: with at most 32
    // chunks (every cluster) the partials are read once
    const float2 first = lane32 < g.nchunks ? partial(lane32) : make_float2(0.f, 0.f);
    const float nfirst = lane32 < g.nchunks ? count(lane32) : 0.f;
    float wm = nfirst * first.x;
    for (int k = lane32 + 32; k < g.nchunks; k += 32) wm += count(k) * partial(k).x;
    const float mean = warp_sum(wm) / total;
    float d = first.x - mean;
    float v = first.y + nfirst * d * d;
    for (int k = lane32 + 32; k < g.nchunks; k += 32) {
      const float2 pk = partial(k);
      d = pk.x - mean;
      v += pk.y + count(k) * d * d;
    }
    v = warp_sum(v);
    if (lane32 == 0) {
      fin[2 * gl] = mean;
      fin[2 * gl + 1] = rsqrtf(v / total + eps);
    }
  }
}

// y * sigmoid(y). The special-function unit does 16 operations a clock on an
// SM, and exp + reciprocal are two for each element: at 8 elements a pack it,
// not the memory, bounds the normalize pass of a map that sits in L2. For a
// bf16 output sigmoid(y) = 0.5 + 0.5 tanh(y / 2) with tanh.approx (one
// operation, relative error 2^-11, under bf16's 2^-9 rounding); an fp32
// output keeps exp and a division.
template <int VEC>
__device__ __forceinline__ float silu(float y) {
  if (VEC == 8) {
    float t;
    asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * y));
    return y * fmaf(0.5f, t, 0.5f);
  }
  return __fdividef(y, 1.f + __expf(-y));
}

template <int VEC>
__device__ __forceinline__ uint4 normalized(const uint4& u, const float (&mean)[VEC],
                                            const float (&a)[VEC], const float (&bias)[VEC],
                                            int apply_silu) {
  float v[VEC];
  unpack(u, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float y = fmaf(v[i] - mean[i], a[i], bias[i]);
    v[i] = apply_silu ? silu<VEC>(y) : y;
  }
  return pack(v);
}

// y rows of this block from src rows (device memory or the tile).
template <typename T, int VEC>
__device__ void normalize_rows(const char* src_base, int64_t src_row_bytes, char* dst_base,
                               int64_t dst_row_bytes, const T* scale, const T* bias,
                               const float* fin, const Geom& g, const Where& w,
                               int apply_silu) {
  if (!w.active) return;
  float mean[VEC], a[VEC], bi[VEC];
  unpack(ld16(reinterpret_cast<const char*>(scale + w.c0) + w.pack * 16), a);
  unpack(ld16(reinterpret_cast<const char*>(bias + w.c0) + w.pack * 16), bi);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int gl = (w.pack * VEC + i) / g.cpg;
    mean[i] = fin[2 * gl];
    a[i] *= fin[2 * gl + 1];
  }
  const char* src = src_base + w.pack * 16;
  char* dst = dst_base + w.pack * 16;
  int r = w.lane;
  for (; r + 3 * w.lanes < w.nrows; r += 4 * w.lanes) {
    const uint4 u0 = ld16(src + (int64_t)r * src_row_bytes);
    const uint4 u1 = ld16(src + (int64_t)(r + w.lanes) * src_row_bytes);
    const uint4 u2 = ld16(src + (int64_t)(r + 2 * w.lanes) * src_row_bytes);
    const uint4 u3 = ld16(src + (int64_t)(r + 3 * w.lanes) * src_row_bytes);
    *reinterpret_cast<uint4*>(dst + (int64_t)r * dst_row_bytes) =
        normalized<VEC>(u0, mean, a, bi, apply_silu);
    *reinterpret_cast<uint4*>(dst + (int64_t)(r + w.lanes) * dst_row_bytes) =
        normalized<VEC>(u1, mean, a, bi, apply_silu);
    *reinterpret_cast<uint4*>(dst + (int64_t)(r + 2 * w.lanes) * dst_row_bytes) =
        normalized<VEC>(u2, mean, a, bi, apply_silu);
    *reinterpret_cast<uint4*>(dst + (int64_t)(r + 3 * w.lanes) * dst_row_bytes) =
        normalized<VEC>(u3, mean, a, bi, apply_silu);
  }
  for (; r < w.nrows; r += w.lanes)
    *reinterpret_cast<uint4*>(dst + (int64_t)r * dst_row_bytes) =
        normalized<VEC>(ld16(src + (int64_t)r * src_row_bytes), mean, a, bi, apply_silu);
}

// The statistics a forward used, (mean, rstd) of this block's groups, to
// stats[B, G, 2] for the backward: written by one block of each (sample, slab).
__device__ __forceinline__ void write_stats(float* stats, const float* fin, const Geom& g,
                                            const Where& w) {
  const int64_t group0 = (int64_t)w.b * (g.c / g.cpg) + w.c0 / g.cpg;
  for (int i = threadIdx.x; i < 2 * (g.slab / g.cpg); i += blockDim.x) stats[group0 * 2 + i] = fin[i];
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

// One launch: a cluster of g.nchunks blocks owns (sample, slab).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_fused_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                const T* __restrict__ bias, T* __restrict__ y, float* __restrict__ stats, Geom g,
                float eps, int apply_silu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const Where w = locate<VEC>(g);
  const int64_t row_bytes = (int64_t)g.c * sizeof(T);
  const int64_t tile_row_bytes = (int64_t)g.slab * sizeof(T);
  const int64_t first = (((int64_t)w.b * g.rows + w.row0) * g.c + w.c0) * sizeof(T);
  char* tile = reinterpret_cast<char*>(smem);
  const Scratch sm = carve(reinterpret_cast<float*>(smem + (int64_t)g.rows_per * tile_row_bytes),
                           w.lanes, g.slab, g.slab / g.cpg);
  if (w.active) {
    const char* src = reinterpret_cast<const char*>(x) + first + w.pack * 16;
    for (int r = w.lane; r < w.nrows; r += w.lanes)
      cp_async16(tile + r * tile_row_bytes + w.pack * 16, src + (int64_t)r * row_bytes);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the pivot row was copied by the threads of lane 0
  const uint4 pivot = w.active ? ld16(tile + w.pack * 16) : make_uint4(0, 0, 0, 0);
  chunk_partials<VEC>(tile, tile_row_bytes, pivot, g, w, sm, sm.part);
  cg::this_cluster().sync();  // every block's partials are in its shared memory
  combine_chunks<true>(sm.part, g, eps, sm.fin);
  // this block has read the others' partials; it may not exit before they
  // have read its own: arrive here, wait after the stores
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  if (stats != nullptr && w.chunk == 0) write_stats(stats, sm.fin, g, w);
  normalize_rows<T, VEC>(tile, tile_row_bytes, reinterpret_cast<char*>(y) + first, row_bytes,
                         scale, bias, sm.fin, g, w, apply_silu);
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Split pair, first launch: group partials of (sample, slab, row chunk) to
// part[B, G, nchunks, 2].
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, Geom g) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const Where w = locate<VEC>(g);
  const Scratch sm = carve(reinterpret_cast<float*>(smem), w.lanes, g.slab, g.slab / g.cpg);
  const int64_t first = (((int64_t)w.b * g.rows + w.row0) * g.c + w.c0) * sizeof(T);
  const char* src = reinterpret_cast<const char*>(x) + first;
  const uint4 pivot = w.active ? ld16(src + w.pack * 16) : make_uint4(0, 0, 0, 0);
  chunk_partials<VEC>(src, (int64_t)g.c * sizeof(T), pivot, g, w, sm, sm.part);
  __syncthreads();
  const int gps = g.slab / g.cpg;
  const int64_t group0 = (int64_t)w.b * (g.c / g.cpg) + w.c0 / g.cpg;
  for (int i = threadIdx.x; i < 2 * gps; i += blockDim.x)
    part[((group0 + (i >> 1)) * g.nchunks + w.chunk) * 2 + (i & 1)] = sm.part[i];
}

// Split pair, second launch: fold the partials of this block's groups, then
// normalize its rows.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_norm_kernel(const T* __restrict__ x, float* __restrict__ part, const T* __restrict__ scale,
               const T* __restrict__ bias, T* __restrict__ y, float* __restrict__ stats, Geom g,
               float eps, int apply_silu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const Where w = locate<VEC>(g);
  float* fin = reinterpret_cast<float*>(smem);
  const int64_t group0 = (int64_t)w.b * (g.c / g.cpg) + w.c0 / g.cpg;
  combine_chunks<false>(part + group0 * g.nchunks * 2, g, eps, fin);
  __syncthreads();
  if (stats != nullptr && w.chunk == 0) write_stats(stats, fin, g, w);
  const int64_t row_bytes = (int64_t)g.c * sizeof(T);
  const int64_t first = (((int64_t)w.b * g.rows + w.row0) * g.c + w.c0) * sizeof(T);
  normalize_rows<T, VEC>(reinterpret_cast<const char*>(x) + first, row_bytes,
                         reinterpret_cast<char*>(y) + first, row_bytes, scale, bias, fin, g, w,
                         apply_silu);
}

// The geometry the caller asked for, or rows = 0 when the kernels do not take it.
Geom geometry(int64_t batch, int rows, int c, int groups, int slab, int nchunks, int threads,
              int vec) {
  Geom g = {0, 0, 0, 0, 0, 0};
  if (batch < 1 || batch > 65535 || rows < 1 || c < 1 || groups < 1 || c % groups != 0 ||
      slab < 1 || nchunks < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return g;
  const int cpg = c / groups;
  if (c % slab != 0 || slab % cpg != 0 || slab % vec != 0 || threads < slab / vec) return g;
  const int rows_per = (rows + nchunks - 1) / nchunks;
  if ((int64_t)(nchunks - 1) * rows_per >= rows) return g;  // an empty chunk
  if ((int64_t)nchunks * (c / slab) > 2147483647LL) return g;
  g = {rows, c, cpg, slab, rows_per, nchunks};
  return g;
}

int fused_smem(const Geom& g, int threads, int vec, int elem) {
  const int lanes = threads / (g.slab / vec);
  const int64_t bytes = (int64_t)g.rows_per * g.slab * elem +
                        4LL * scratch_floats(threads, lanes, g.slab, g.slab / g.cpg);
  return bytes > kMaxSmem ? -1 : (int)bytes;
}

template <typename T>
cudaError_t prepare_fused() {
  static const cudaError_t rc = [] {
    cudaError_t e = cudaFuncSetAttribute(gn_fused_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(gn_fused_kernel<T>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return rc;
}

template <typename T>
cudaError_t launch_fused(const void* x, const void* scale, const void* bias, void* y,
                         float* stats, int64_t batch, const Geom& g, int threads, int smem,
                         float eps, int apply_silu, cudaStream_t s) {
  cudaError_t e = prepare_fused<T>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g.nchunks * (g.c / g.slab)), (unsigned)batch);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.nchunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (g.nchunks == 1) cfg.numAttrs = 0;  // a block alone is its own cluster
  return cudaLaunchKernelEx(&cfg, gn_fused_kernel<T>, static_cast<const T*>(x),
                            static_cast<const T*>(scale), static_cast<const T*>(bias),
                            static_cast<T*>(y), stats, g, eps, apply_silu);
}


// ---- backward ----

constexpr int kMaxStages = 8;  // mbarriers of a fused backward block: its rows land in <= 8 stages

// sigmoid(z) for silu'(z). bf16: 0.5 + 0.5 tanh(z / 2) with tanh.approx, one
// special-function operation (relative error 2^-11, under bf16's 2^-9
// rounding of dx), as the bf16 forward; fp32 keeps exp and a division.
template <int VEC>
__device__ __forceinline__ float sigmoid_of(float z) {
  if (VEC == 8) {
    float t;
    asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * z));
    return fmaf(0.5f, t, 0.5f);
  }
  return 1.f / (1.f + __expf(-z));
}

// x^, z = x^ g + b and dz = dy silu'(z) (or dy) of one pack.
template <int VEC>
__device__ __forceinline__ void bwd_pack(const uint4& xu, const uint4& gu, const float (&mean)[VEC],
                                         const float (&rstd)[VEC], const float (&ga)[VEC],
                                         const float (&be)[VEC], int apply_silu,
                                         float (&xh)[VEC], float (&dz)[VEC]) {
  float xv[VEC], gv[VEC];
  unpack(xu, xv);
  unpack(gu, gv);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    xh[i] = (xv[i] - mean[i]) * rstd[i];
    if (apply_silu) {
      const float z = fmaf(xh[i], ga[i], be[i]);
      const float sg = sigmoid_of<VEC>(z);
      dz[i] = gv[i] * sg * fmaf(z, 1.f - sg, 1.f);
    } else {
      dz[i] = gv[i];
    }
  }
}

template <int VEC>
__device__ __forceinline__ void add_sums(const float (&xh)[VEC], const float (&dz)[VEC],
                                         float (&s1)[VEC], float (&s2)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s1[i] += dz[i];
    s2[i] = fmaf(dz[i], xh[i], s2[i]);
  }
}

// dx of one pack: rstd (g dz - mean_g(g dz) - x^ mean_g(g dz x^)).
template <int VEC>
__device__ __forceinline__ uint4 dx_pack(const uint4& xu, const uint4& gu, const float (&mean)[VEC],
                                         const float (&rstd)[VEC], const float (&ga)[VEC],
                                         const float (&be)[VEC], const float (&c1)[VEC],
                                         const float (&c2)[VEC], int apply_silu) {
  float xh[VEC], dz[VEC], o[VEC];
  bwd_pack<VEC>(xu, gu, mean, rstd, ga, be, apply_silu, xh, dz);
#pragma unroll
  for (int i = 0; i < VEC; ++i) o[i] = rstd[i] * (fmaf(ga[i], dz[i], -c1[i]) - xh[i] * c2[i]);
  return pack(o);
}

// This thread's channels: mean and rstd from `fin` (its groups' statistics
// in shared memory), scale and bias from device memory.
template <typename T, int VEC>
__device__ __forceinline__ void channel_params(const T* scale, const T* bias, const float* fin,
                                               const Geom& g, const Where& w, float (&mean)[VEC],
                                               float (&rstd)[VEC], float (&ga)[VEC],
                                               float (&be)[VEC]) {
  unpack(ld16(reinterpret_cast<const char*>(scale + w.c0) + w.pack * 16), ga);
  unpack(ld16(reinterpret_cast<const char*>(bias + w.c0) + w.pack * 16), be);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int gl = (w.pack * VEC + i) / g.cpg;
    mean[i] = fin[2 * gl];
    rstd[i] = fin[2 * gl + 1];
  }
}

// The per-group pair in `pairs` [gps][2] of each of this thread's channels.
template <int VEC>
__device__ __forceinline__ void group_pairs(const float* pairs, const Geom& g, const Where& w,
                                            float (&a)[VEC], float (&b)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int gl = (w.pack * VEC + i) / g.cpg;
    a[i] = pairs[2 * gl];
    b[i] = pairs[2 * gl + 1];
  }
}

// The forward's (mean, rstd) of this block's groups, from stats[B, G, 2].
__device__ __forceinline__ void load_stats(const float* stats, const Geom& g, const Where& w,
                                           float* fin) {
  const int64_t group0 = (int64_t)w.b * (g.c / g.cpg) + w.c0 / g.cpg;
  for (int i = threadIdx.x; i < 2 * (g.slab / g.cpg); i += blockDim.x) fin[i] = stats[group0 * 2 + i];
}

template <typename T>
__device__ __forceinline__ float to_float(const T* p, int i) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  else
    return reinterpret_cast<const float*>(p)[i];
}

// After the row loops: each thread's (sum dz, sum dz x^) in red[2][lanes][slab]
// -> chs[slab][2], the lanes added in order; then the groups' gamma-weighted
// sums part[gps][2] = (sum_c g_c sum dz, sum_c g_c sum dz x^), one warp a group.
template <typename T, int VEC>
__device__ void block_sums(float* red, const float (&s1)[VEC], const float (&s2)[VEC],
                           const T* scale, const Geom& g, const Where& w, float* chs,
                           float* part) {
  if (w.active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[w.lane * g.slab + w.pack * VEC + i] = s1[i];
      red[(w.lanes + w.lane) * g.slab + w.pack * VEC + i] = s2[i];
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < g.slab; ch += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int l = 0; l < w.lanes; ++l) {
      a += red[l * g.slab + ch];
      q += red[(w.lanes + l) * g.slab + ch];
    }
    chs[2 * ch] = a;
    chs[2 * ch + 1] = q;
  }
  __syncthreads();
  const int lane32 = threadIdx.x & 31;
  for (int gl = threadIdx.x >> 5; gl < g.slab / g.cpg; gl += blockDim.x >> 5) {
    float a = 0.f, q = 0.f;
    for (int i = lane32; i < g.cpg; i += 32) {
      const int ch = gl * g.cpg + i;
      const float gc = to_float(scale, w.c0 + ch);
      a = fmaf(gc, chs[2 * ch], a);
      q = fmaf(gc, chs[2 * ch + 1], q);
    }
    a = warp_sum(a);
    q = warp_sum(q);
    if (lane32 == 0) {
      part[2 * gl] = a;
      part[2 * gl + 1] = q;
    }
  }
}

// One thread: the box of a 3-d tensor map (C, rows, B) at (c, row, b) ->
// dst; its bytes count down on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(flash::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(flash::smem_addr(bar)), "r"(c), "r"(row), "r"(b)
      : "memory");
}

// Waits for the phase of parity 0 of a stage's barrier (each completes once a
// launch). A copy that never lands traps after ~2^35 clocks (~19 s) rather
// than hang the card.
__device__ __forceinline__ void wait_landed(uint64_t* bar) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(flash::smem_addr(bar))
        : "memory");
    if (!done && clock64() - t0 > (1LL << 35)) __trap();
  } while (!done);
}

// One launch: a cluster of g.nchunks blocks owns (sample, slab); each block
// holds its rows of x and dy in shared memory.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_fused_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_g, const float* __restrict__ stats,
                    const T* __restrict__ scale, const T* __restrict__ bias, T* __restrict__ dx,
                    float* __restrict__ csums, Geom g, int stage_rows, int apply_silu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const Where w = locate<VEC>(g);
  const int gps = g.slab / g.cpg;
  const int tile_row = g.slab * (int)sizeof(T);
  const int64_t row_bytes = (int64_t)g.c * sizeof(T);
  const int64_t first = (((int64_t)w.b * g.rows + w.row0) * g.c + w.c0) * sizeof(T);
  const int tile_rows = (g.rows_per + stage_rows - 1) / stage_rows * stage_rows;
  char* tx = reinterpret_cast<char*>(smem);
  char* tg = tx + (int64_t)tile_rows * tile_row;
  uint64_t* bars = reinterpret_cast<uint64_t*>(tg + (int64_t)tile_rows * tile_row);
  float* red = reinterpret_cast<float*>(bars + kMaxStages);  // [2][lanes][slab]
  float* chs = red + 2 * w.lanes * g.slab;                   // [slab][2] this block's sums
  float* part = chs + 2 * g.slab;                            // [gps][2] its group sums
  float* fin = part + 2 * gps;                               // [gps][2] mean, rstd
  float* coef = fin + 2 * gps;                               // [gps][2] the group means
  const int nstages = (w.nrows + stage_rows - 1) / stage_rows;
  if (threadIdx.x == 0) {
    flash::mbar_init_all(bars, nstages);
    flash::prefetch_map(&map_x);
    flash::prefetch_map(&map_g);
  }
  load_stats(stats, g, w, fin);
  __syncthreads();
  // one thread asks for all of the block's rows of both tiles at once, a box
  // of stage_rows rows a stage and tensor; a stage's barrier completes when
  // its two boxes have landed (rows past the map arrive as zeros)
  if (threadIdx.x == 0) {
    for (int s = 0; s < nstages; ++s) {
      const int off = s * stage_rows * tile_row;
      flash::mbar_expect_tx(&bars[s], 2 * stage_rows * tile_row);
      tma_load_3d(tx + off, &map_x, &bars[s], w.c0, w.row0 + s * stage_rows, w.b);
      tma_load_3d(tg + off, &map_g, &bars[s], w.c0, w.row0 + s * stage_rows, w.b);
    }
  }
  float mean[VEC], rstd[VEC], ga[VEC], be[VEC], s1[VEC], s2[VEC], xh[VEC], dz[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  if (w.active) channel_params<T, VEC>(scale, bias, fin, g, w, mean, rstd, ga, be);
  // each stage's sums as soon as it lands, while the later stages stream in
  for (int s = 0; s < nstages; ++s) {
    wait_landed(&bars[s]);
    if (!w.active) continue;
    const int end = min((s + 1) * stage_rows, w.nrows);
    for (int r = s * stage_rows + w.lane; r < end; r += w.lanes) {
      bwd_pack<VEC>(ld16(tx + r * tile_row + w.pack * 16), ld16(tg + r * tile_row + w.pack * 16),
                    mean, rstd, ga, be, apply_silu, xh, dz);
      add_sums<VEC>(xh, dz, s1, s2);
    }
  }
  block_sums<T, VEC>(red, s1, s2, scale, g, w, chs, part);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's sums are in its shared memory
  // the cluster's group sums in rank order, and the channels' where dgamma or
  // dbeta is asked for (rank r takes every nchunks-th share of the channels)
  const float inv_n = 1.f / ((float)g.rows * (float)g.cpg);
  for (int i = threadIdx.x; i < 2 * gps; i += blockDim.x) {
    float v = 0.f;
    for (int k = 0; k < g.nchunks; ++k) v += cluster.map_shared_rank(part, k)[i];
    coef[i] = v * inv_n;
  }
  if (csums != nullptr) {
    const int64_t plane = (int64_t)gridDim.y * g.c;
    float* out = csums + (int64_t)w.b * g.c + w.c0;
    for (int i = threadIdx.x + w.chunk * blockDim.x; i < 2 * g.slab;
         i += g.nchunks * blockDim.x) {
      float v = 0.f;
      for (int k = 0; k < g.nchunks; ++k) v += cluster.map_shared_rank(chs, k)[i];
      out[(i & 1) * plane + (i >> 1)] = v;
    }
  }
  // this block has read the others' sums; it may not exit before they have
  // read its own: arrive here, wait after the stores
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  if (w.active) {
    float c1[VEC], c2[VEC];
    group_pairs<VEC>(coef, g, w, c1, c2);
    char* ds = reinterpret_cast<char*>(dx) + first + w.pack * 16;
    for (int r = w.lane; r < w.nrows; r += w.lanes)
      *reinterpret_cast<uint4*>(ds + r * row_bytes) =
          dx_pack<VEC>(ld16(tx + r * tile_row + w.pack * 16),
                       ld16(tg + r * tile_row + w.pack * 16), mean, rstd, ga, be, c1, c2,
                       apply_silu);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Split backward, first launch: per (sample, slab, row chunk), the group sums
// to gpart[B, G, nchunks, 2] and, where csums is not null, the channels' to
// csums[2, B, nchunks, C] (the planes of sum dz and sum dz x^). Four rows a
// thread in flight.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ stats, const T* __restrict__ scale,
                     const T* __restrict__ bias, float* __restrict__ gpart,
                     float* __restrict__ csums, Geom g, int apply_silu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const Where w = locate<VEC>(g);
  const int gps = g.slab / g.cpg;
  float* fin = reinterpret_cast<float*>(smem);  // [gps][2]
  float* red = fin + 2 * gps;                   // [2][lanes][slab]
  float* chs = red + 2 * w.lanes * g.slab;      // [slab][2]
  float* part = chs + 2 * g.slab;               // [gps][2]
  load_stats(stats, g, w, fin);
  __syncthreads();
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  if (w.active) {
    float mean[VEC], rstd[VEC], ga[VEC], be[VEC], xh[VEC], dz[VEC];
    channel_params<T, VEC>(scale, bias, fin, g, w, mean, rstd, ga, be);
    const int64_t row_bytes = (int64_t)g.c * sizeof(T);
    const int64_t first = (((int64_t)w.b * g.rows + w.row0) * g.c + w.c0) * sizeof(T) + w.pack * 16;
    const char* xs = reinterpret_cast<const char*>(x) + first;
    const char* gs = reinterpret_cast<const char*>(dy) + first;
    int r = w.lane;
    for (; r + 3 * w.lanes < w.nrows; r += 4 * w.lanes) {
      uint4 xu[4], gu[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xu[j] = ld16(xs + (int64_t)(r + j * w.lanes) * row_bytes);
        gu[j] = ld16(gs + (int64_t)(r + j * w.lanes) * row_bytes);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bwd_pack<VEC>(xu[j], gu[j], mean, rstd, ga, be, apply_silu, xh, dz);
        add_sums<VEC>(xh, dz, s1, s2);
      }
    }
    for (; r < w.nrows; r += w.lanes) {
      bwd_pack<VEC>(ld16(xs + (int64_t)r * row_bytes), ld16(gs + (int64_t)r * row_bytes), mean,
                    rstd, ga, be, apply_silu, xh, dz);
      add_sums<VEC>(xh, dz, s1, s2);
    }
  }
  block_sums<T, VEC>(red, s1, s2, scale, g, w, chs, part);
  __syncthreads();
  if (csums != nullptr) {
    const int64_t plane = (int64_t)gridDim.y * g.nchunks * g.c;
    float* out = csums + ((int64_t)w.b * g.nchunks + w.chunk) * g.c + w.c0;
    for (int i = threadIdx.x; i < 2 * g.slab; i += blockDim.x)
      out[(i & 1) * plane + (i >> 1)] = chs[i];
  }
  const int64_t group0 = (int64_t)w.b * (g.c / g.cpg) + w.c0 / g.cpg;
  for (int i = threadIdx.x; i < 2 * gps; i += blockDim.x)
    gpart[((group0 + (i >> 1)) * g.nchunks + w.chunk) * 2 + (i & 1)] = part[i];
}

// Split backward, second launch: the prologue folds the chunks' group sums
// of this block's groups (a warp a group, lanes over chunks), then dx of its
// rows, four in flight a thread. (Running the blocks in the reverse of the
// reduce's order, to read first what the reduce left in L2, measured no
// faster.)
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ stats,
                 const float* __restrict__ gpart, const T* __restrict__ scale,
                 const T* __restrict__ bias, T* __restrict__ dx, Geom g, int apply_silu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const Where w = locate<VEC>(g);
  const int gps = g.slab / g.cpg;
  float* fin = reinterpret_cast<float*>(smem);  // [gps][2] mean, rstd
  float* coef = fin + 2 * gps;                  // [gps][2] mean_g(g dz), mean_g(g dz x^)
  load_stats(stats, g, w, fin);
  const int lane32 = threadIdx.x & 31;
  const float inv_n = 1.f / ((float)g.rows * (float)g.cpg);
  const int64_t group0 = (int64_t)w.b * (g.c / g.cpg) + w.c0 / g.cpg;
  for (int gl = threadIdx.x >> 5; gl < gps; gl += blockDim.x >> 5) {
    const float2* pg = reinterpret_cast<const float2*>(gpart) + (group0 + gl) * g.nchunks;
    float a = 0.f, q = 0.f;
    for (int k = lane32; k < g.nchunks; k += 32) {
      const float2 p = pg[k];
      a += p.x;
      q += p.y;
    }
    a = warp_sum(a);
    q = warp_sum(q);
    if (lane32 == 0) {
      coef[2 * gl] = a * inv_n;
      coef[2 * gl + 1] = q * inv_n;
    }
  }
  __syncthreads();
  if (!w.active) return;
  float mean[VEC], rstd[VEC], ga[VEC], be[VEC], c1[VEC], c2[VEC];
  channel_params<T, VEC>(scale, bias, fin, g, w, mean, rstd, ga, be);
  group_pairs<VEC>(coef, g, w, c1, c2);
  const int64_t row_bytes = (int64_t)g.c * sizeof(T);
  const int64_t first = (((int64_t)w.b * g.rows + w.row0) * g.c + w.c0) * sizeof(T) + w.pack * 16;
  const char* xs = reinterpret_cast<const char*>(x) + first;
  const char* gs = reinterpret_cast<const char*>(dy) + first;
  char* ds = reinterpret_cast<char*>(dx) + first;
  int r = w.lane;
  for (; r + 3 * w.lanes < w.nrows; r += 4 * w.lanes) {
    uint4 xu[4], gu[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xu[j] = ld16(xs + (int64_t)(r + j * w.lanes) * row_bytes);
      gu[j] = ld16(gs + (int64_t)(r + j * w.lanes) * row_bytes);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint4*>(ds + (int64_t)(r + j * w.lanes) * row_bytes) =
          dx_pack<VEC>(xu[j], gu[j], mean, rstd, ga, be, c1, c2, apply_silu);
  }
  for (; r < w.nrows; r += w.lanes)
    *reinterpret_cast<uint4*>(ds + (int64_t)r * row_bytes) =
        dx_pack<VEC>(ld16(xs + (int64_t)r * row_bytes), ld16(gs + (int64_t)r * row_bytes), mean,
                     rstd, ga, be, c1, c2, apply_silu);
}

cudaError_t smem_up_to(const void* kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

// Bytes of dynamic shared memory of a fused backward block: both tiles (whole
// stages of rows), the stages' barriers, then the sums. -1 where that is
// more than a block has.
int bwd_fused_smem(const Geom& g, int threads, int stage_rows, int vec, int elem) {
  const int lanes = threads / (g.slab / vec);
  const int tile_rows = (g.rows_per + stage_rows - 1) / stage_rows * stage_rows;
  const int64_t bytes = 2LL * tile_rows * g.slab * elem + 8LL * kMaxStages +
                        4LL * (2 * lanes * g.slab + 2 * g.slab + 6 * (g.slab / g.cpg));
  return bytes > kMaxSmem ? -1 : (int)bytes;
}

template <typename T>
cudaError_t prepare_bwd_fused() {
  static const cudaError_t rc = [] {
    cudaError_t e = cudaFuncSetAttribute(gn_bwd_fused_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(gn_bwd_fused_kernel<T>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return rc;
}

// A [B, rows, C] map as a 3-d tensor map (C, rows, B), box (slab, stage
// rows, 1): a box lands as stage_rows rows of slab contiguous elements.
// Returns 0, or 20000 + the CUresult (20000 alone: no entry point).
int rows_map(CUtensorMap* map, const void* ptr, int64_t batch, int rows, int c, int slab,
             int stage_rows, int is_bf16) {
  const flash::EncodeTiled encode = flash::encode_tiled();
  if (encode == nullptr) return 20000;
  const int elem = is_bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)c * elem, (cuuint64_t)rows * c * elem};
  const cuuint32_t box[3] = {(cuuint32_t)slab, (cuuint32_t)stage_rows, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
      const_cast<void*>(ptr), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : 20000 + (int)rc;
}

// The launch of a fused backward: grid (cluster x slabs, batch), one cluster
// a (sample, slab).
cudaLaunchConfig_t bwd_fused_config(cudaLaunchAttribute* attr, int64_t batch, int slabs,
                                    int cluster, int threads, int smem, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * slabs), (unsigned)batch);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// x, y: [B, rows, C] (a channels-last map); scale, bias: [C] of x's dtype.
// One cluster of `cluster` blocks per (sample, slab of `slab` channels).
// stats: [B, G, 2] floats out, the (mean, rstd) used, or null.
extern "C" int gn_fused(const void* x, const void* scale, const void* bias, void* y, float* stats,
                        int64_t batch, int rows, int c, int groups, int slab, int cluster,
                        int threads, float eps, int apply_silu, int is_bf16, void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  const Geom g = geometry(batch, rows, c, groups, slab, cluster, threads, vec);
  const int smem = g.rows ? fused_smem(g, threads, vec, is_bf16 ? 2 : 4) : -1;
  if (smem < 0 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch_fused<__nv_bfloat16>(x, scale, bias, y, stats, batch, g, threads, smem,
                                            eps, apply_silu, s)
              : launch_fused<float>(x, scale, bias, y, stats, batch, g, threads, smem, eps,
                                    apply_silu, s);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// part: [B, G, nchunks, 2] floats out, (mean, M2) of each chunk's groups.
extern "C" int gn_stats(const void* x, float* part, int64_t batch, int rows, int c, int groups,
                        int slab, int nchunks, int threads, int is_bf16, void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  const Geom g = geometry(batch, rows, c, groups, slab, nchunks, threads, vec);
  if (!g.rows) return (int)cudaErrorInvalidValue;
  const int lanes = threads / (slab / vec);
  const int smem = 4 * scratch_floats(threads, lanes, slab, slab / g.cpg);  // <= 40 KB
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(nchunks * (c / slab)), (unsigned)batch);
  if (is_bf16)
    gn_stats_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), part, g);
  else
    gn_stats_kernel<float><<<grid, threads, smem, s>>>(static_cast<const float*>(x), part, g);
  return (int)cudaGetLastError();
}

// part from gn_stats with the same slab and nchunks; stats as gn_fused's.
extern "C" int gn_norm(const void* x, float* part, const void* scale, const void* bias, void* y,
                       float* stats, int64_t batch, int rows, int c, int groups, int slab,
                       int nchunks, int threads, float eps, int apply_silu, int is_bf16,
                       void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  const Geom g = geometry(batch, rows, c, groups, slab, nchunks, threads, vec);
  if (!g.rows) return (int)cudaErrorInvalidValue;
  const int smem = 4 * 2 * (slab / g.cpg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(nchunks * (c / slab)), (unsigned)batch);
  if (is_bf16)
    gn_norm_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), part, static_cast<const __nv_bfloat16*>(scale),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), stats, g, eps,
        apply_silu);
  else
    gn_norm_kernel<float><<<grid, threads, smem, s>>>(
        static_cast<const float*>(x), part, static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<float*>(y), stats, g, eps, apply_silu);
  return (int)cudaGetLastError();
}


// Backward, one launch. x, dy, dx: [B, rows, C]; stats: [B, G, 2] from the
// forward; csums: [2, B, C] floats out (the planes of sum dz and sum dz x^)
// or null. A cluster
// of `cluster` blocks a (sample, slab); a block's rows land in stages of
// `stage_rows`.
extern "C" int gn_bwd_fused(const void* x, const void* dy, const float* stats, const void* scale,
                            const void* bias, void* dx, float* csums, int64_t batch, int rows,
                            int c, int groups, int slab, int cluster, int threads,
                            int stage_rows, int apply_silu, int is_bf16, void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  const Geom g = geometry(batch, rows, c, groups, slab, cluster, threads, vec);
  const int smem = g.rows ? bwd_fused_smem(g, threads, stage_rows, vec, is_bf16 ? 2 : 4) : -1;
  // stages of whole 8-row groups keep every box on the 128 bytes TMA wants
  if (smem < 0 || cluster > kMaxCluster || stage_rows < 8 || stage_rows > 256 ||
      stage_rows % 8 != 0 || slab > 256 || (g.rows_per + stage_rows - 1) / stage_rows > kMaxStages)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_g;
  int rc = rows_map(&map_x, x, batch, rows, c, slab, stage_rows, is_bf16);
  if (rc == 0) rc = rows_map(&map_g, dy, batch, rows, c, slab, stage_rows, is_bf16);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = bwd_fused_config(attr, batch, c / slab, cluster, threads, smem, s);
  cudaError_t e;
  if (is_bf16) {
    using T = __nv_bfloat16;
    e = prepare_bwd_fused<T>();
    if (e == cudaSuccess)
      e = cudaLaunchKernelEx(&cfg, gn_bwd_fused_kernel<T>, map_x, map_g, stats,
                             static_cast<const T*>(scale), static_cast<const T*>(bias),
                             static_cast<T*>(dx), csums, g, stage_rows, apply_silu);
  } else {
    e = prepare_bwd_fused<float>();
    if (e == cudaSuccess)
      e = cudaLaunchKernelEx(&cfg, gn_bwd_fused_kernel<float>, map_x, map_g, stats,
                             static_cast<const float*>(scale), static_cast<const float*>(bias),
                             static_cast<float*>(dx), csums, g, stage_rows, apply_silu);
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// How many clusters of the fused backward with this geometry the card holds
// at once (cudaOccupancyMaxActiveClusters), into *active; 0 means it cannot
// schedule one. Returns the CUDA error code.
extern "C" int gn_bwd_fused_clusters(int cluster, int threads, int smem, int is_bf16, int* active) {
  cudaLaunchAttribute attr[1];
  cudaError_t e;
  if (is_bf16) {
    e = prepare_bwd_fused<__nv_bfloat16>();
    if (e != cudaSuccess) return (int)e;
    const cudaLaunchConfig_t cfg =
        bwd_fused_config(attr, 1, 1, cluster, threads, smem, nullptr);
    e = cudaOccupancyMaxActiveClusters(active, gn_bwd_fused_kernel<__nv_bfloat16>, &cfg);
  } else {
    e = prepare_bwd_fused<float>();
    if (e != cudaSuccess) return (int)e;
    const cudaLaunchConfig_t cfg =
        bwd_fused_config(attr, 1, 1, cluster, threads, smem, nullptr);
    e = cudaOccupancyMaxActiveClusters(active, gn_bwd_fused_kernel<float>, &cfg);
  }
  return (int)e;
}

// Split backward, first launch. gpart: [B, G, nchunks, 2] floats out;
// csums: [2, B, nchunks, C] floats out or null.
extern "C" int gn_bwd_reduce(const void* x, const void* dy, const float* stats, const void* scale,
                             const void* bias, float* gpart, float* csums, int64_t batch,
                             int rows, int c, int groups, int slab, int nchunks, int threads,
                             int apply_silu, int is_bf16, void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  const Geom g = geometry(batch, rows, c, groups, slab, nchunks, threads, vec);
  if (!g.rows) return (int)cudaErrorInvalidValue;
  const int lanes = threads / (slab / vec);
  const int smem = 4 * (4 * (slab / g.cpg) + 2 * lanes * slab + 2 * slab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(nchunks * (c / slab)), (unsigned)batch);
  cudaError_t e;
  if (is_bf16) {
    using T = __nv_bfloat16;
    e = smem_up_to((const void*)gn_bwd_reduce_kernel<T>, smem);
    if (e != cudaSuccess) return (int)e;
    gn_bwd_reduce_kernel<T><<<grid, threads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), stats, static_cast<const T*>(scale),
        static_cast<const T*>(bias), gpart, csums, g, apply_silu);
  } else {
    e = smem_up_to((const void*)gn_bwd_reduce_kernel<float>, smem);
    if (e != cudaSuccess) return (int)e;
    gn_bwd_reduce_kernel<float><<<grid, threads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), stats,
        static_cast<const float*>(scale), static_cast<const float*>(bias), gpart, csums, g,
        apply_silu);
  }
  return (int)cudaGetLastError();
}

// Split backward, second launch: dx [B, rows, C] of x's dtype, from the
// forward's stats and gn_bwd_reduce's gpart of the same geometry.
extern "C" int gn_bwd_dx(const void* x, const void* dy, const float* stats, const float* gpart,
                         const void* scale, const void* bias, void* dx, int64_t batch, int rows,
                         int c, int groups, int slab, int nchunks, int threads, int apply_silu,
                         int is_bf16, void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  const Geom g = geometry(batch, rows, c, groups, slab, nchunks, threads, vec);
  if (!g.rows) return (int)cudaErrorInvalidValue;
  const int smem = 4 * 4 * (slab / g.cpg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(nchunks * (c / slab)), (unsigned)batch);
  if (is_bf16) {
    using T = __nv_bfloat16;
    gn_bwd_dx_kernel<T><<<grid, threads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), stats, gpart,
        static_cast<const T*>(scale), static_cast<const T*>(bias), static_cast<T*>(dx), g,
        apply_silu);
  } else {
    gn_bwd_dx_kernel<float><<<grid, threads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), stats, gpart,
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<float*>(dx), g, apply_silu);
  }
  return (int)cudaGetLastError();
}

// Shared pieces of the flash-attention forward kernels (flash_attn_fwd.cu,
// flash_attn_wgmma.cu, flash_attn_wide.cu): the launch parameters, the bf16 tensor-core and
// ldmatrix wrappers, 16-byte asynchronous copies (cp.async) and the staging
// of a tile of rows into shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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
  // split keys (flash_attn_wide.cu): partial results per split, or null
  int nsplit;
  float* o_part;  // [nsplit, B, H, Sq, D] unnormalized
  float* m_part;  // [nsplit, B, H, Sq] row maxima, log2 units
  float* l_part;  // [nsplit, B, H, Sq] row sums
  // the wgmma kernel (flash_attn_wgmma.cu): the rows' m and 1/l, or null
  float* stats;  // [2, B, H, Sq rounded up to 64]
};

// strides: 12 element strides, (batch, head, seq) for q, k, v, out in turn;
// elem: bytes per element. False if a shape is out of range.
inline bool fill_params(FlashParams& p, const void* q, const void* k, const void* v,
                        const float* mask, void* out, const int64_t* strides, int b, int h,
                        int sq, int sk, int d, int max_d, int causal, float scale, int elem) {
  if (d < 1 || d > max_d || sq < 1 || sk < 1 || b < 1 || h < 1 || b > 65535 || h > 65535)
    return false;
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
  p.kstr = d | 1;
  p.causal = causal;
  p.scale = scale;
  bool vec16 = d % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec16 = vec16 && (strides[i] * elem) % 16 == 0;
  p.vec16 = vec16;
  p.nsplit = 1;
  p.o_part = nullptr;
  p.m_part = nullptr;
  p.l_part = nullptr;
  p.stats = nullptr;
  return true;
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one SFU instruction; 2^-inf = +0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// Four 8x8 bf16 tiles: lanes 8i..8i+7 give the row addresses of tile i; each
// thread gets tile i's (row lane/4, cols 2*(lane%4)+{0,1}) pair in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
}

// The same, each tile transposed: thread gets (col 2*(lane%4)+{0,1}, row lane/4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
}

// 16 bytes global -> shared without passing through registers; bytes = 0
// reads nothing and fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS x DP tile of src (row stride src_stride elements) -> dst (row stride
// STR), zero outside n_rows x d, by all NT threads of the block. With vec16
// the copies are asynchronous (the caller commits and waits); else they are
// plain element loads and stores, visible after the next block barrier.
template <int DP, int STR, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t src_stride, int n_rows, int d, bool vec16) {
  if (vec16) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
      const int r = i / CH;
      const int c = (i - r * CH) * 8;
      const bool ok = r < n_rows && c < d;
      cp_async16(dst + r * STR + c, ok ? src + (int64_t)r * src_stride + c : src, ok ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int r = i / DP;
      const int c = i - r * DP;
      dst[r * STR + c] = (r < n_rows && c < d) ? src[(int64_t)r * src_stride + c] : zero;
    }
  }
}

}  // namespace flash

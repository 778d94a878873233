// Shared pieces of the flash-attention backward on wgmma (flash_attn_bwd_wg.cu
// at the UNet's head dims, flash_attn_bwd.cu at the VAE's 512): the launch
// parameters, the store of an accumulator, the probabilities of a key-major
// tile, and the host's checks and tensor maps.

#pragma once

#include "flash_wgmma.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int kRows = kWgRows;  // rows of a warpgroup, and of a tile the loops walk over
constexpr int kStages = 2;

struct WgBwdParams {
  const float* mask;   // [B, Sk] or null
  const float* m;      // [B, H, Sqp]: the rows' maxima, log2 units, scale folded in
  const float* inv_l;  // [B, H, Sqp]: 1 / the rows' sums
  const float* delta;  // [B, H, Sqp]
  bf16 *dq, *dk, *dv;
  int64_t st[3][3];  // element strides (batch, head, sequence) of dq, dk, dv
  int h, sq, sk, sqp, d, causal;
  float scale, scale_log2;
};
enum { DQ, DK, DV };

// rows r0 and r0 + 8 of a 64 x N accumulator, times mult, into bf16 dst (row
// stride rs) at columns c0 + ..., for rows below `rows` and columns below d
// (a multiple of 8) only; pairs of columns as 4-byte stores
template <int N>
__device__ __forceinline__ void store_acc(bf16* dst, int64_t rs, const float (&acc)[N / 2], int r0,
                                          int rows, int c0, int d, float mult, int tq) {
#pragma unroll
  for (int dt = 0; dt < N / 8; ++dt) {
    const int c = c0 + dt * 8 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= rows || c >= d) continue;
      *reinterpret_cast<uint32_t*>(dst + (int64_t)row * rs + c) =
          pack_bf16(acc[4 * dt + 2 * half] * mult, acc[4 * dt + 2 * half + 1] * mult);
    }
  }
}

// P^T = exp2(S^T scale log2e - m) / l and dS^T = P^T o (dP^T - delta) in
// place of S^T and dP^T (keys x queries). Element i of a thread: key row
// kr0 (+ 8 where i & 2), query column 8 (i >> 2) + 2 tq + (i & 1) of the
// tile, whose m, 1/l, delta are r[col], r[64 + col], r[128 + col]. MASKED: the
// thread's keys masked (mk0, mk1), and the causal rule (key > query + qoff
// with qoff = the tile's first query + Sk - Sq) take the logit -1e30.
// DS false: P^T alone (dP^T is not read).
template <bool MASKED, bool DS = true>
__device__ __forceinline__ void dkdv_probs(float (&s)[32], float (&dp)[32], const float* r,
                                           int tq, int kr0, bool mk0, bool mk1, int causal,
                                           int qoff, float sl2) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int cl = nt * 8 + 2 * tq;
    const float2 mm = *reinterpret_cast<const float2*>(r + cl);
    const float2 il = *reinterpret_cast<const float2*>(r + kRows + cl);
    const float2 dl = *reinterpret_cast<const float2*>(r + 2 * kRows + cl);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * nt + e;
      const float mq = (e & 1) ? mm.y : mm.x, ilq = (e & 1) ? il.y : il.x;
      const float dlq = (e & 1) ? dl.y : dl.x;
      float pr;
      if constexpr (MASKED) {
        float x = s[i] * sl2;
        if (((e & 2) ? mk1 : mk0) || (causal && kr0 + (e & 2) * 4 - qoff > cl + (e & 1)))
          x = kNegInf;
        pr = fast_exp2(x - mq) * ilq;
      } else {
        pr = fast_exp2(fmaf(s[i], sl2, -mq)) * ilq;
      }
      if constexpr (DS) dp[i] = pr * (dp[i] - dlq);
      s[i] = pr;
    }
  }
}

// strides: 21 element strides, (batch, head, sequence) of q, k, v, g, dq, dk,
// dv in turn. The inputs are read by TMA: rows on 16-byte boundaries and D a
// multiple of 8 (the wrapper copies other layouts); the outputs are written
// as pairs of columns. False where the call is out of range (the entry
// points check the head dims their instances take).
bool fill(WgBwdParams& p, const void* q, const void* k, const void* v, const void* g,
          const float* mask, const float* stats, const float* delta, void* dq, void* dk, void* dv,
          const int64_t* strides, int b, int h, int sq, int sk, int d, int causal, float scale) {
  if (b < 1 || h < 1 || b > 65535 || h > 65535 || sq < 1 || sk < 1 || d % 8 != 0) return false;
  const void* in[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(in[i]) % 16 != 0) return false;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] % 8 != 0) return false;
  }
  void* out[3] = {dq, dk, dv};
  for (int i = 0; i < 3; ++i) {
    if (reinterpret_cast<uintptr_t>(out[i]) % 4 != 0) return false;
    for (int j = 0; j < 3; ++j) {
      p.st[i][j] = strides[12 + 3 * i + j];
      if (out[i] != nullptr && p.st[i][j] % 2 != 0) return false;
    }
  }
  p.mask = mask;
  p.sqp = (sq + kRows - 1) / kRows * kRows;
  p.m = stats;
  p.inv_l = stats + (int64_t)b * h * p.sqp;
  p.delta = delta;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return true;
}

// the four tensor maps of q, k, v, g (box of 64 rows, ch columns of 16 bytes)
int make_maps(CUtensorMap (&maps)[4], const void* const (&in)[4], const int64_t* strides, int b,
              int h, int sq, int sk, int d, int ch) {
  for (int i = 0; i < 4; ++i) {
    const int rc = tensor_map(&maps[i], in[i], strides[3 * i], strides[3 * i + 1],
                              strides[3 * i + 2], b, h, (i == 1 || i == 2) ? sk : sq, d, ch);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

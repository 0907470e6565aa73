// bf16 tensor-core building blocks for Hopper (sm_90a), shared by the
// hand-written flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// 16-byte cp.async copies into padded shared tiles, ldmatrix (plain and
// .trans) and mma.sync m16n8k16 bf16 -> f32, with the fragment layouts the
// kernels hand between products. Every helper assumes a CTA of NT threads
// (4 warps, 16 rows each) and rows padded by PAD elements.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;  // 4 warps, 16 rows of the CTA's 64 each
constexpr int PAD = 8;   // bf16 pad per shared row: 16 bytes

// a warp holds its 16 rows of the operand that stays (q in the forward, q/dO
// in dq, k/v in dkv) as A fragments; at D = 128 it reads them per k-step
template <int D>
constexpr bool HOLD_ROWS = D <= 64;

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; 16 zero bytes where !ok (src-size 0)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes (one f32 of lse or D); zero where !ok
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}

// c (16×8 f32) += a (16×16 bf16, row-major) · b (16×8 bf16, col-major)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts of m16n8k16 (lane = 4·g + t): A holds (row g | g+8, cols
// 2t, 2t+1 | 2t+8, 2t+9); B holds (k rows 2t, 2t+1 | 2t+8, 2t+9, col g); the
// accumulator holds (row g, cols 2t, 2t+1) in c[0..1], row g+8 in c[2..3].

// the A fragment of rows [r0, r0+16), cols [c0, c0+16) of a row-major tile
template <int P>
__device__ __forceinline__ void lds_a(uint32_t (&a)[4], const bf16* tile,
                                      int r0, int c0, int lane) {
  ldsm4(a, tile + (r0 + (lane & 15)) * P + c0 + (lane >> 4) * 8);
}

// B fragments of tile rows [n0, n0+16) as the n side, cols [c0, c0+16) as the
// k side (B[k][n] = tile[n][k]): b[0..1] for n0..n0+7, b[2..3] for n0+8..
template <int P>
__device__ __forceinline__ void lds_b(uint32_t (&b)[4], const bf16* tile,
                                      int n0, int c0, int lane) {
  ldsm4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * P + c0 +
               ((lane >> 3) & 1) * 8);
}

// B fragments of tile rows [k0, k0+16) as the k side, cols [n0, n0+16) as the
// n side (B[k][n] = tile[k][n], ldmatrix.trans): b[0..1] for cols n0..n0+7,
// b[2..3] for n0+8..
template <int P>
__device__ __forceinline__ void lds_bt(uint32_t (&b)[4], const bf16* tile,
                                       int k0, int n0, int lane) {
  ldsm4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + n0 +
                 (lane >> 4) * 8);
}

// acc (16 × W) += A rows · Bt[0..W)ᵀ over D: A is the warp's 16 rows, held as
// fragments or read from `at` at row r0; Bt a W × D tile
template <int D, int W, bool HOLD>
__device__ __forceinline__ void scores(float (&acc)[W / 8][4],
                                       const uint32_t (&held)[HOLD ? D / 16 : 1][4],
                                       const bf16* at, int r0, const bf16* bt,
                                       int lane) {
  constexpr int P = D + PAD;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    if constexpr (HOLD) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = held[kk][i];
    } else {
      lds_a<P>(a, at, r0, kk * 16, lane);
    }
#pragma unroll
    for (int np = 0; np < W / 16; ++np) {
      uint32_t b[4];
      lds_b<P>(b, bt, np * 16, kk * 16, lane);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 × D) += X (16 × W, bf16 fragments from registers) · Bt (W × D tile)
template <int D, int W>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const uint32_t (&x)[W / 16][4],
                                           const bf16* bt, int lane) {
  constexpr int P = D + PAD;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t b[4];
      lds_bt<P>(b, bt, kk * 16, nd * 16, lane);
      mma(acc[2 * nd], x[kk], b[0], b[1]);
      mma(acc[2 * nd + 1], x[kk], b[2], b[3]);
    }
}

// the score accumulators (16 × W f32) as bf16 A fragments over W
template <int W>
__device__ __forceinline__ void to_a(uint32_t (&x)[W / 16][4],
                                     const float (&s)[W / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    x[kk][0] = pack(s[2 * kk][0], s[2 * kk][1]);
    x[kk][1] = pack(s[2 * kk][2], s[2 * kk][3]);
    x[kk][2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    x[kk][3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

template <int W>
__device__ __forceinline__ void zero(float (&x)[W][4]) {
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// rows [r0, r0 + R) of a (B, L, H, D) bf16 tensor (base at (b, 0, h, 0),
// position stride sl) into an R × (D + PAD) tile, by 16-byte cp.async; rows
// past L are zero-filled
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          long long sl, int r0, int L) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  static_assert((R * CPR) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < R * CPR / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / CPR, c = i % CPR, g = r0 + r;
    const bool ok = g < L;
    cp16(dst + r * (D + PAD) + c * 8, base + (ok ? g * sl : 0) + c * 8, ok);
  }
}

}  // namespace tc
}  // namespace

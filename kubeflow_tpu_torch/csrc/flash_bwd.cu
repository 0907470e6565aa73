// Flash-attention backward for Hopper (sm_90a), written by hand: three
// kernels in one library, each with its own C entry point.
//
// Replaces the Pallas TPU backward of kubeflow_tpu/parallel/ring_attention.py
// (folded there to (B·H, L, D); here read in the public layout):
//
//   flash_bwd_dd   the inner `kernel` of `_dd_prekernel` (:1279, launched at
//                  :1283):  D = Σ_d dO∘O, f32, one value per (b·h, query row)
//   flash_bwd_dq   `_flash_dq_kernel` (:748, at :1368), `_flash_dq_loop_kernel`
//                  (:961, at :1222) and, with D from O, `_flash_dq_loop2_kernel`
//                  (:1058, at :1165):
//                    p  = exp(s − lse),  s = q·kᵀ/√D + bias + mask
//                    ds = p∘(dO·vᵀ − D);  dq = Σ_k ds·k / √D
//   flash_bwd_dkv  `_flash_dkv_kernel` (:786, at :1387), `_flash_dkv_loop_kernel`
//                  (:1003, at :1241) and, with D from O,
//                  `_flash_dkv_loop2_kernel` (:1102, at :1184):
//                    dv = Σ_q pᵀ·dO;  dk = Σ_q dsᵀ·q / √D;  dbias_bh = Σ_q ds
//
// The mask is the TPU kernels': causal adds −1e9 where col > row (rows and
// cols both counted from 0, also when Lq ≠ Lk), the sliding window (only with
// causal) where row − col ≥ window, and tiles no pair of which is live are
// skipped (`_block_live`, :571). Keys past Lk and queries past Lq weigh exactly
// 0: the ragged edge is bounds-checked here, where the TPU wrapper fell back to
// a plain scan. Rounding follows the TPU kernels: p goes to the dO dtype before
// pᵀ·dO (:812), ds to the k dtype before ds·k (:771) and to the q dtype before
// dsᵀ·q (:816); scores, D, dbias and every sum stay f32. All of q, k, v, o, dO
// share one dtype (f32 or bf16), read by stride from (B, L, H, D) with a unit
// stride on D ∈ {16, 32, 64, 128}; bias is (B, 1, 1, Lk) contiguous; lse and
// D are (B, H, Lq) f32; dq/dk/dv are written contiguous (B, L, H, D), dbias_bh
// as (B·H, Lk) f32 (the wrapper sums it over heads, as the JAX wrapper does at
// :1411-1413).
//
// What bounds them on the H100: dq does 3 products per live (q, k) pair and d
// (q·kᵀ, dO·vᵀ, ds·k) and dkv 4 (q·kᵀ, dO·vᵀ, pᵀ·dO, dsᵀ·q), i.e. about 6 and 8
// operations per (q, k, d); against ~L·H·D·8 bytes per row that must move, that
// is operation-bound at every training length: on the tensor cores in bf16
// (989 TFLOP/s), on the CUDA cores in f32 (67 TFLOP/s). dd reads dO and O once
// and does 2 operations per element: bound by bytes. It reads O and dO 16
// bytes a lane where their rows allow (the vector form), one element a lane
// otherwise (the scalar form).
//
// Both dtypes share the TPU kernels' two-pass structure: the TPU kernels
// carried dq (or dk/dv/dbias) in VMEM scratch across a sequential grid axis;
// CTAs cannot, so each CTA loops over the opposite axis itself with its
// accumulators in registers. dq loops over KV tiles, dk/dv over Q tiles, each
// recomputing p from the forward's lse. No CTA writes what another CTA writes,
// so there are no atomics and the results are deterministic.
//
// f32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): 256 threads per CTA, 64×64
// tiles, f32 copies of the tiles in shared memory (odd pitches keep the rows
// in different banks), each thread owning a 4×4 block of the score tile and 4
// rows × D/16 columns of its accumulators; f32 FMA on the CUDA cores, level
// with SDPA's f32 backward, so TF32 would only change the numbers.
//
// bf16 (flash_bwd_dq_tc_kernel, flash_bwd_dkv_tc_kernel), FlashAttention-2
// style: every product is mma.sync m16n8k16 with bf16 operands and f32
// accumulation, the TPU kernels' bf16 dot_general with
// preferred_element_type=f32 (:765-773, :806-817). 4 warps per CTA, each
// owning 16 rows of the CTA's 64 (queries in dq, keys in dkv) and all D
// columns of its sums. Tiles arrive by 16-byte cp.async into bf16 shared
// memory, two stages deep (the next K/V tile, or Q/dO/lse/D tile, is in
// flight while the current one computes), rows padded by 16 bytes so ldmatrix
// reads 8 rows from 8 different bank groups; rows past Lq/Lk are zero-filled.
// ldmatrix feeds B non-transposed where the product reduces over D (q·kᵀ,
// dO·vᵀ; k·qᵀ, v·dOᵀ) and transposed where it reduces over keys or queries (K
// in ds·k; dO in pᵀ·dO and Q in dsᵀ·q). p and ds go from the score
// accumulators to the next product's A fragments in registers, rounded to
// bf16 there (the TPU kernels' rounding points); dbias takes the f32 ds. A
// warp keeps its 16 rows of q/dO (dq) or k/v (dkv) as fragments at D ≤ 64 and
// reads them per k-step at D = 128, where dkv also takes 32-query tiles, so
// that the dk and dv sums (16 × 128 f32 each a warp) fit the registers. The
// mask is applied element by element only on tiles that cross the diagonal,
// the window edge or the ragged end; dead tiles are skipped. wgmma with TMA
// and warp specialisation, and a single-pass backward with atomic dq (not
// deterministic), are left for later PRs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "tc_bf16.cuh"

// The argument block of every entry point (mirrored by a ctypes.Structure in
// kubeflow_tpu_torch/kernels/flash_bwd.py; keep the two in the same order).
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;
  const void* o;
  const void* dout;
  const float* lse;   // (B, H, Lq)
  const float* dd;    // (B, H, Lq); null when D is computed from O
  void* dq;
  void* dk;
  void* dv;
  float* dbias;       // (B·H, Lk) or null when bias needs no grad
  float* dd_out;      // flash_bwd_dd's output (B, H, Lq)
  long long sq[3];    // element strides of (B, L, H); D's stride is 1
  long long sk[3];
  long long sv[3];
  long long so[3];
  long long sdo[3];
  int B, H, Lq, Lk, D, dtype, causal, window;
  float scale;
};

namespace {

constexpr int BQ = 64;                       // query rows per tile
constexpr int BK = 64;                       // keys per tile
constexpr int NT = 256;                      // threads per CTA
constexpr int COL_LANES = 16;                // tid % 16
constexpr int ROW_GROUPS = NT / COL_LANES;   // tid / 16: 16
constexpr int RPT = 64 / ROW_GROUPS;         // tile rows per thread: 4
constexpr int CPT = 64 / COL_LANES;          // tile cols per thread: 4
constexpr int WARPS = NT / 32;
constexpr float NEG_INF = -1e9f;             // the TPU kernels' mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// x rounded to T and back: the TPU kernels' `.astype(ref.dtype)` before a
// product whose other operand is of type T
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ bool masked(int row, int col, int causal,
                                       int window) {
  return causal && (col > row || (window > 0 && row - col >= window));
}

// rows [r0, r0 + 64) of a (B, L, H, D) tensor at (b, ·, h, ·) into a 64×D
// f32 tile of pitch D + 1; rows past L read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long sl, int r0, int L) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D, g = r0 + r;
    dst[r * (D + 1) + c] = g < L ? to_f32(base[g * sl + c]) : 0.f;
  }
}

// D = Σ_d dO∘O for the 64 rows of a tile whose dO is already in shared
// memory (the loop2 form): one warp per row, f32 throughout
template <typename T, int D>
__device__ __forceinline__ void tile_dd(float* Ds, const float* dOs,
                                        const T* ob, long long sl, int r0,
                                        int L) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < 64; r += WARPS) {
    float acc = 0.f;
    const int g = r0 + r;
    if (g < L)
      for (int c = lane; c < D; c += 32)
        acc = fmaf(dOs[r * (D + 1) + c], to_f32(ob[g * sl + c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) Ds[r] = acc;
  }
}

// ------------------------------------------------------------------ dd

// the scalar form, for o and dO whose rows the vector form cannot read 16
// bytes at a time: one warp per (b·h, query row), WARPS rows per CTA
template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dd_kernel(BwdArgs a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long idx = (long long)blockIdx.x * WARPS + warp;
  if (idx >= (long long)a.B * a.H * a.Lq) return;  // uniform per warp
  const int row = (int)(idx % a.Lq);
  const int bh = (int)(idx / a.Lq);
  const int b = bh / a.H, h = bh % a.H;
  const T* orow = static_cast<const T*>(a.o) + b * a.so[0] + row * a.so[1] +
                  h * a.so[2];
  const T* grow = static_cast<const T*>(a.dout) + b * a.sdo[0] +
                  row * a.sdo[1] + h * a.sdo[2];
  float acc = 0.f;
  for (int c = lane; c < a.D; c += 32)
    acc = fmaf(to_f32(grow[c]), to_f32(orow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.dd_out[idx] = acc;
}

// Σ of the products of the 16 bytes of x and y, in f32
__device__ __forceinline__ float dot16(const float4& x, const float4& y,
                                       float) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, x.x * y.x)));
}
__device__ __forceinline__ float dot16(const float4& x, const float4& y,
                                       __nv_bfloat16) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(a[i]), w = __bfloat1622float2(b[i]);
    acc = fmaf(u.y, w.y, fmaf(u.x, w.x, acc));
  }
  return acc;
}

// the vector form: each lane reads 16 bytes of O and of dO (8 bf16 or 4
// f32), D / that many lanes a row, so a warp reduces DD_ROWS rows at once.
// Rows go in (b, position, head) order: for a contiguous (B, L, H, D) tensor
// a warp reads one 512-byte run of each. D's (B, H, Lq) writes are 4-byte
// stores H·Lq apart (0.4 MB at the training shape, merged in L2).
template <typename T, int D>
constexpr int DD_ROWS = 32 / (D * (int)sizeof(T) / 16);

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dd_vec_kernel(BwdArgs a) {
  constexpr int LPR = 32 / DD_ROWS<T, D>;  // lanes a row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r =
      ((long long)blockIdx.x * WARPS + warp) * DD_ROWS<T, D> + lane / LPR;
  const bool live = r < (long long)a.B * a.Lq * a.H;
  const int h = (int)(r % a.H);
  const int pos = (int)(r / a.H % a.Lq), b = (int)(r / a.H / a.Lq);
  float acc = 0.f;
  if (live) {
    const int c = (lane % LPR) * (16 / (int)sizeof(T));
    const float4 x = __ldg(reinterpret_cast<const float4*>(
        static_cast<const T*>(a.o) + b * a.so[0] + pos * a.so[1] +
        h * a.so[2] + c));
    const float4 y = __ldg(reinterpret_cast<const float4*>(
        static_cast<const T*>(a.dout) + b * a.sdo[0] + pos * a.sdo[1] +
        h * a.sdo[2] + c));
    acc = dot16(y, x, T{});
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && lane % LPR == 0)
    a.dd_out[((long long)b * a.H + h) * a.Lq + pos] = acc;
}

// ------------------------------------------------------------------ dq

template <int D>
constexpr size_t dq_smem_floats() {
  // Qs, dOs, Ks, Vs (pitch D+1), dS (pitch BK+1), bias, lse, D
  return (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + BK +
                  2 * BQ);
}

template <typename T, int D, bool DD_FROM_O>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int P = D + 1;
  constexpr int SP = BK + 1;
  constexpr int DPT = D / COL_LANES;  // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * P;
  float* Ks = dOs + BQ * P;
  float* Vs = Ks + BK * P;
  float* dSs = Vs + BK * P;
  float* Bs = dSs + BQ * SP;
  float* Ls = Bs + BK;
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x;
  const int tr = tid / COL_LANES;
  const int tc = tid % COL_LANES;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int Lq = a.Lq, Lk = a.Lk;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const T* gb = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[2];
  const T* biasb = static_cast<const T*>(a.bias) + (long long)b * Lk;

  load_tile<T, D>(Qs, qb, a.sq[1], q0, Lq);
  load_tile<T, D>(dOs, gb, a.sdo[1], q0, Lq);
  for (int r = tid; r < BQ; r += NT) {
    const int g = q0 + r;
    Ls[r] = g < Lq ? a.lse[(long long)bh * Lq + g] : 0.f;
    if (!DD_FROM_O) Ds[r] = g < Lq ? a.dd[(long long)bh * Lq + g] : 0.f;
  }
  if (DD_FROM_O) {
    __syncthreads();  // dOs complete
    const T* ob = static_cast<const T*>(a.o) + b * a.so[0] + h * a.so[2];
    tile_dd<T, D>(Ds, dOs, ob, a.so[1], q0, Lq);
  }

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;

  // the live KV tiles of this Q tile, as the forward and the TPU loop
  // kernels bound them (:983-990)
  const int q_last = min(q0 + BQ, Lq) - 1;
  int kt_end = (Lk + BK - 1) / BK;
  int kt_begin = 0;
  if (a.causal) {
    kt_end = min(kt_end, q_last / BK + 1);
    const int oldest = q0 - (a.window - 1);
    if (a.window > 0 && oldest > 0) kt_begin = oldest / BK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks/Vs/dSs are no longer read
    load_tile<T, D>(Ks, kb, a.sk[1], k0, Lk);
    load_tile<T, D>(Vs, vb, a.sv[1], k0, Lk);
    for (int i = tid; i < BK; i += NT)
      Bs[i] = k0 + i < Lk ? to_f32(biasb[k0 + i]) : 0.f;
    __syncthreads();

    // s = q·kᵀ and dp = dO·vᵀ for rows tr + 16i, cols tc + 16j
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RPT], gv[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = Qs[(tr + ROW_GROUPS * i) * P + c];
        gv[i] = dOs[(tr + ROW_GROUPS * i) * P + c];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = Ks[(tc + COL_LANES * j) * P + c];
        vv[j] = Vs[(tc + COL_LANES * j) * P + c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int lr = tr + ROW_GROUPS * i;
      const int row = q0 + lr;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int lc = tc + COL_LANES * j;
        const int col = k0 + lc;
        float ds = 0.f;  // past Lk or Lq: weight exactly 0
        if (col < Lk && row < Lq) {
          float x = s[i][j] * a.scale + Bs[lc];
          if (masked(row, col, a.causal, a.window)) x += NEG_INF;
          const float p = expf(x - Ls[lr]);
          ds = p * (dp[i][j] - Ds[lr]);
        }
        dSs[lr * SP + lc] = round_to<T>(ds);  // ds.astype(k.dtype)
      }
    }
    __syncthreads();

    // dq += ds·k for rows tr + 16i, cols tc + 16e
    const int kn = min(BK, Lk - k0);
    for (int j = 0; j < kn; ++j) {
      float kv[DPT];
#pragma unroll
      for (int e = 0; e < DPT; ++e) kv[e] = Ks[j * P + tc + COL_LANES * e];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float d = dSs[(tr + ROW_GROUPS * i) * SP + j];
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(d, kv[e], acc[i][e]);
      }
    }
  }

  T* dqb = static_cast<T*>(a.dq);
  const long long pos_stride = (long long)a.H * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + tr + ROW_GROUPS * i;
    if (row >= Lq) continue;
    T* out = dqb + ((long long)b * Lq + row) * pos_stride + (long long)h * D;
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      out[tc + COL_LANES * e] = from_f32<T>(acc[i][e] * a.scale);
  }
}

// ------------------------------------------------------------------ dkv

template <int D>
constexpr size_t dkv_smem_floats() {
  // Ks, Vs, Qs, dOs (pitch D+1), P and dS (pitch BQ+1), bias, lse, D
  return (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) +
                  BK + 2 * BQ);
}

template <typename T, int D, bool DD_FROM_O>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int P = D + 1;
  constexpr int SP = BQ + 1;
  constexpr int DPT = D / COL_LANES;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * P;
  float* Qs = Vs + BK * P;
  float* dOs = Qs + BQ * P;
  float* Ps = dOs + BQ * P;   // [key][query], p in the dO dtype
  float* dSs = Ps + BK * SP;  // [key][query], ds in the q dtype
  float* Bs = dSs + BK * SP;
  float* Ls = Bs + BK;
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x;
  const int tr = tid / COL_LANES;  // key rows tr + 16i
  const int tc = tid % COL_LANES;  // query cols tc + 16j; D cols tc + 16e
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int Lq = a.Lq, Lk = a.Lk;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* kb = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const T* gb = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[2];
  const T* ob = static_cast<const T*>(a.o) + b * a.so[0] + h * a.so[2];
  const T* biasb = static_cast<const T*>(a.bias) + (long long)b * Lk;

  load_tile<T, D>(Ks, kb, a.sk[1], k0, Lk);
  load_tile<T, D>(Vs, vb, a.sv[1], k0, Lk);
  for (int i = tid; i < BK; i += NT)
    Bs[i] = k0 + i < Lk ? to_f32(biasb[k0 + i]) : 0.f;

  float dk[RPT][DPT], dv[RPT][DPT], db[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    db[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) dk[i][e] = dv[i][e] = 0.f;
  }

  // the live Q tiles of this KV tile (:1039-1046): at or below the diagonal
  // of its first key, and not wholly past its last key's window
  const int nqt = (Lq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = nqt;
  if (a.causal) {
    qt_begin = k0 / BQ;
    if (a.window > 0) {
      const int k_last = min(k0 + BK, Lk) - 1;
      qt_end = min(nqt, (k_last + a.window - 1) / BQ + 1);
    }
  }

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's Qs/dOs/Ps/dSs are no longer read
    load_tile<T, D>(Qs, qb, a.sq[1], q0, Lq);
    load_tile<T, D>(dOs, gb, a.sdo[1], q0, Lq);
    for (int r = tid; r < BQ; r += NT) {
      const int g = q0 + r;
      Ls[r] = g < Lq ? a.lse[(long long)bh * Lq + g] : 0.f;
      if (!DD_FROM_O) Ds[r] = g < Lq ? a.dd[(long long)bh * Lq + g] : 0.f;
    }
    if (DD_FROM_O) {
      __syncthreads();  // dOs complete
      tile_dd<T, D>(Ds, dOs, ob, a.so[1], q0, Lq);
    }
    __syncthreads();

    // sᵀ = k·qᵀ and dpᵀ = v·dOᵀ for keys tr + 16i, queries tc + 16j
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float kv[RPT], vv[RPT], qv[CPT], gv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        kv[i] = Ks[(tr + ROW_GROUPS * i) * P + c];
        vv[i] = Vs[(tr + ROW_GROUPS * i) * P + c];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        qv[j] = Qs[(tc + COL_LANES * j) * P + c];
        gv[j] = dOs[(tc + COL_LANES * j) * P + c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int lk = tr + ROW_GROUPS * i;
      const int col = k0 + lk;
      float dsum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int lq = tc + COL_LANES * j;
        const int row = q0 + lq;
        float p = 0.f, ds = 0.f;  // past Lk or Lq: weight exactly 0
        if (col < Lk && row < Lq) {
          float x = s[i][j] * a.scale + Bs[lk];
          if (masked(row, col, a.causal, a.window)) x += NEG_INF;
          p = expf(x - Ls[lq]);
          ds = p * (dp[i][j] - Ds[lq]);
        }
        dsum += ds;
        Ps[lk * SP + lq] = round_to<T>(p);    // p.astype(dO.dtype)
        dSs[lk * SP + lq] = round_to<T>(ds);  // ds.astype(q.dtype)
      }
      // dbias: the f32 ds summed over this tile's queries (16 lanes share a
      // key row), as the TPU kernel's ds.sum(axis=0)
#pragma unroll
      for (int off = COL_LANES / 2; off > 0; off >>= 1)
        dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
      db[i] += dsum;
    }
    __syncthreads();

    // dv += pᵀ·dO and dk += dsᵀ·q for keys tr + 16i, cols tc + 16e
    const int qn = min(BQ, Lq - q0);
    for (int j = 0; j < qn; ++j) {
      float qv[DPT], gv[DPT];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        qv[e] = Qs[j * P + tc + COL_LANES * e];
        gv[e] = dOs[j * P + tc + COL_LANES * e];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(tr + ROW_GROUPS * i) * SP + j];
        const float d = dSs[(tr + ROW_GROUPS * i) * SP + j];
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          dv[i][e] = fmaf(p, gv[e], dv[i][e]);
          dk[i][e] = fmaf(d, qv[e], dk[i][e]);
        }
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk);
  T* dvb = static_cast<T*>(a.dv);
  const long long pos_stride = (long long)a.H * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + tr + ROW_GROUPS * i;
    if (key >= Lk) continue;
    const long long off = ((long long)b * Lk + key) * pos_stride +
                          (long long)h * D;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      dkb[off + tc + COL_LANES * e] = from_f32<T>(dk[i][e] * a.scale);
      dvb[off + tc + COL_LANES * e] = from_f32<T>(dv[i][e]);
    }
    if (a.dbias != nullptr && tc == 0)
      a.dbias[(long long)bh * Lk + key] = db[i];
  }
}

// ------------------------------------------------------- bf16: tensor cores

namespace tc {

constexpr int ROWS = 64;  // Q rows of a dq CTA, keys of a dkv CTA
constexpr int BK = 64;    // keys per KV tile of the dq loop

// queries per Q tile of the dkv loop: 32 at D = 128 keeps the dk and dv sums
// and the score tiles of a warp within the registers
template <int D>
constexpr int DKV_BQ = D > 64 ? 32 : 64;

// f32 r of a (B·H, Lq) row (lse or D) from position r0; zero past Lq
__device__ __forceinline__ void load_stat(float* dst, const float* row,
                                          int r0, int Lq, int r) {
  const bool ok = r0 + r < Lq;
  cp4(dst + r, row + (ok ? r0 + r : 0), ok);
}

// D = Σ_d dO∘O in f32 for the R rows of a tile pair in shared memory (the
// loop2 form; zero rows give 0): NT / R threads a row
template <int D, int R>
__device__ __forceinline__ void tile_dd(float* Ds, const bf16* dOs,
                                        const bf16* Os) {
  constexpr int TPR = NT / R, SPAN = D / TPR;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const bf16* x = dOs + r * (D + PAD) + part * SPAN;
  const bf16* y = Os + r * (D + PAD) + part * SPAN;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < SPAN; ++c)
    acc = fmaf(__bfloat162float(x[c]), __bfloat162float(y[c]), acc);
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) Ds[r] = acc;
}

// the tile pair (q rows [q0, q0 + bq), keys [k0, k0 + bk)) has a pair the
// mask or the ragged end touches
__device__ __forceinline__ bool edge_tile(const BwdArgs& a, int q0, int bq,
                                          int k0, int bk) {
  return q0 + bq > a.Lq || k0 + bk > a.Lk ||
         (a.causal && (k0 + bk - 1 > q0 ||
                       (a.window > 0 && q0 + bq - 1 - k0 >= a.window)));
}

template <int D, bool FROM_O>
constexpr size_t dq_smem_bytes() {
  // Q, dO, [O] once; K, V two stages each; bias two stages; lse, D
  return sizeof(bf16) * (2 + 4 + (FROM_O ? 1 : 0)) * ROWS * (D + PAD) +
         sizeof(float) * (2 * BK + 2 * ROWS);
}

template <int D, bool FROM_O>
__global__ void __launch_bounds__(NT) flash_bwd_dq_tc_kernel(BwdArgs a) {
  constexpr int P = D + PAD, BQ = ROWS, NB = BK / 8;
  constexpr bool HOLD = HOLD_ROWS<D>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dOs = Qs + BQ * P;
  bf16* Ks = dOs + BQ * P;  // 2 stages
  bf16* Vs = Ks + 2 * BK * P;
  bf16* Os = Vs + 2 * BK * P;  // loop2 form only
  float* Bs = reinterpret_cast<float*>(Os + (FROM_O ? BQ * P : 0));
  float* Ls = Bs + 2 * BK;
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int Lq = a.Lq, Lk = a.Lk;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const bf16* gb =
      static_cast<const bf16*>(a.dout) + b * a.sdo[0] + h * a.sdo[2];
  const bf16* biasb = static_cast<const bf16*>(a.bias) + (long long)b * Lk;

  // the live KV tiles of this Q tile, as the FMA kernel bounds them
  const int q_last = min(q0 + BQ, Lq) - 1;
  int kt_end = (Lk + BK - 1) / BK;
  int kt_begin = 0;
  if (a.causal) {
    kt_end = min(kt_end, q_last / BK + 1);
    const int oldest = q0 - (a.window - 1);
    if (a.window > 0 && oldest > 0) kt_begin = oldest / BK;
  }

  load_rows<D, BQ>(Qs, qb, a.sq[1], q0, Lq);
  load_rows<D, BQ>(dOs, gb, a.sdo[1], q0, Lq);
  if (FROM_O) {
    const bf16* ob = static_cast<const bf16*>(a.o) + b * a.so[0] +
                     h * a.so[2];
    load_rows<D, BQ>(Os, ob, a.so[1], q0, Lq);
  }
  if (tid < BQ)
    load_stat(Ls, a.lse + (long long)bh * Lq, q0, Lq, tid);
  else if (!FROM_O && tid < 2 * BQ)
    load_stat(Ds, a.dd + (long long)bh * Lq, q0, Lq, tid - BQ);
  if (kt_begin < kt_end) {
    const int k0 = kt_begin * BK;
    load_rows<D, BK>(Ks, kb, a.sk[1], k0, Lk);
    load_rows<D, BK>(Vs, vb, a.sv[1], k0, Lk);
    if (tid < BK)
      Bs[tid] = k0 + tid < Lk ? __bfloat162float(biasb[k0 + tid]) : 0.f;
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();
  if (FROM_O) {
    tile_dd<D, BQ>(Ds, dOs, Os);
    __syncthreads();
  }

  const int r_lo = warp * 16 + g;  // this lane's rows: r_lo and r_lo + 8
  const float lse[2] = {Ls[r_lo], Ls[r_lo + 8]};
  const float dd[2] = {Ds[r_lo], Ds[r_lo + 8]};
  uint32_t qf[HOLD ? D / 16 : 1][4], gf[HOLD ? D / 16 : 1][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      lds_a<P>(qf[kk], Qs, warp * 16, kk * 16, lane);
      lds_a<P>(gf[kk], dOs, warp * 16, kk * 16, lane);
    }
  }
  float acc[D / 8][4];
  zero(acc);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1, k0 = kt * BK;
    if (kt > kt_begin) {
      cp_wait_all();  // this tile's K/V
      __syncthreads();  // ... for every warp; the other stage is free
    }
    float bias_next = 0.f;
    if (kt + 1 < kt_end) {
      const int k1 = k0 + BK;
      load_rows<D, BK>(Ks + (st ^ 1) * BK * P, kb, a.sk[1], k1, Lk);
      load_rows<D, BK>(Vs + (st ^ 1) * BK * P, vb, a.sv[1], k1, Lk);
      if (tid < BK && k1 + tid < Lk)
        bias_next = __bfloat162float(biasb[k1 + tid]);
    }
    cp_commit();
    const bf16* Kt = Ks + st * BK * P;
    const bf16* Vt = Vs + st * BK * P;
    const float* Bt = Bs + st * BK;

    float s[NB][4], dp[NB][4];
    zero(s);
    zero(dp);
    scores<D, BK, HOLD>(s, qf, Qs, warp * 16, Kt, lane);   // q·kᵀ
    scores<D, BK, HOLD>(dp, gf, dOs, warp * 16, Vt, lane);  // dO·vᵀ

    // p = exp(s·scale + bias + mask − lse); ds = p∘(dp − D), into s
    const bool edge = edge_tile(a, q0, BQ, k0, BK);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lc = n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * a.scale + Bt[lc];
        float p;
        if (edge) {
          const int row = q0 + r_lo + (e >> 1) * 8, col = k0 + lc;
          if (masked(row, col, a.causal, a.window)) x += NEG_INF;
          p = row < Lq && col < Lk ? expf(x - lse[e >> 1]) : 0.f;
        } else {
          p = expf(x - lse[e >> 1]);
        }
        s[n][e] = p * (dp[n][e] - dd[e >> 1]);
      }

    // dq += ds·k, ds rounded to bf16 (ds.astype(k.dtype), :771)
    uint32_t dsf[BK / 16][4];
    to_a<BK>(dsf, s);
    accumulate<D, BK>(acc, dsf, Kt, lane);
    if (kt + 1 < kt_end && tid < BK) Bs[(st ^ 1) * BK + tid] = bias_next;
  }

  bf16* dqb = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r_lo + half * 8;
    if (row >= Lq) continue;
    bf16* out = dqb + (((long long)b * Lq + row) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) =
          pack(acc[n][2 * half] * a.scale, acc[n][2 * half + 1] * a.scale);
  }
}

template <int D, bool FROM_O>
constexpr size_t dkv_smem_bytes() {
  // K, V once; Q, dO, [O] two stages each; lse, D two stages
  constexpr int BQ = DKV_BQ<D>;
  return sizeof(bf16) *
             (2 * ROWS + 2 * (2 + (FROM_O ? 1 : 0)) * BQ) * (D + PAD) +
         sizeof(float) * 4 * BQ;
}

template <int D, bool FROM_O>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_tc_kernel(BwdArgs a) {
  constexpr int P = D + PAD, BKV = ROWS, BQ = DKV_BQ<D>, NB = BQ / 8;
  constexpr bool HOLD = HOLD_ROWS<D>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* Vs = Ks + BKV * P;
  bf16* Qs = Vs + BKV * P;  // 2 stages
  bf16* dOs = Qs + 2 * BQ * P;
  bf16* Os = dOs + 2 * BQ * P;  // loop2 form only, 2 stages
  float* Ls = reinterpret_cast<float*>(Os + (FROM_O ? 2 * BQ * P : 0));
  float* Ds = Ls + 2 * BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BKV;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int Lq = a.Lq, Lk = a.Lk;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const bf16* gb =
      static_cast<const bf16*>(a.dout) + b * a.sdo[0] + h * a.sdo[2];
  const bf16* ob = static_cast<const bf16*>(a.o) + b * a.so[0] + h * a.so[2];
  const bf16* biasb = static_cast<const bf16*>(a.bias) + (long long)b * Lk;
  const float* lse_row = a.lse + (long long)bh * Lq;
  const float* dd_row = FROM_O ? nullptr : a.dd + (long long)bh * Lq;

  // the live Q tiles of this KV tile (:1039-1046): at or below the diagonal
  // of its first key, and not wholly past its last key's window
  const int nqt = (Lq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = nqt;
  if (a.causal) {
    qt_begin = k0 / BQ;
    if (a.window > 0) {
      const int k_last = min(k0 + BKV, Lk) - 1;
      qt_end = min(nqt, (k_last + a.window - 1) / BQ + 1);
    }
  }

  // Q, dO, [O], lse and [D] of Q tile qt into stage st
  auto fetch = [&](int qt, int st) {
    const int q0 = qt * BQ;
    load_rows<D, BQ>(Qs + st * BQ * P, qb, a.sq[1], q0, Lq);
    load_rows<D, BQ>(dOs + st * BQ * P, gb, a.sdo[1], q0, Lq);
    if (FROM_O) load_rows<D, BQ>(Os + st * BQ * P, ob, a.so[1], q0, Lq);
    if (tid < BQ)
      load_stat(Ls + st * BQ, lse_row, q0, Lq, tid);
    else if (!FROM_O && tid < 2 * BQ)
      load_stat(Ds + st * BQ, dd_row, q0, Lq, tid - BQ);
  };

  load_rows<D, BKV>(Ks, kb, a.sk[1], k0, Lk);
  load_rows<D, BKV>(Vs, vb, a.sv[1], k0, Lk);
  if (qt_begin < qt_end) fetch(qt_begin, 0);
  cp_commit();

  const int r_lo = warp * 16 + g;  // this lane's keys: r_lo and r_lo + 8
  float bias[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + r_lo + half * 8;
    bias[half] = key < Lk ? __bfloat162float(biasb[key]) : 0.f;
  }
  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  float db[2] = {0.f, 0.f};

  cp_wait_all();
  __syncthreads();
  uint32_t kf[HOLD ? D / 16 : 1][4], vf[HOLD ? D / 16 : 1][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      lds_a<P>(kf[kk], Ks, warp * 16, kk * 16, lane);
      lds_a<P>(vf[kk], Vs, warp * 16, kk * 16, lane);
    }
  }

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int st = (qt - qt_begin) & 1, q0 = qt * BQ;
    if (qt > qt_begin) {
      cp_wait_all();  // this tile's Q/dO/lse/D
      __syncthreads();  // ... for every warp; the other stage is free
    }
    if (qt + 1 < qt_end) fetch(qt + 1, st ^ 1);
    cp_commit();
    const bf16* Qt = Qs + st * BQ * P;
    const bf16* dOt = dOs + st * BQ * P;
    const float* Lt = Ls + st * BQ;
    float* Dt = Ds + st * BQ;
    if (FROM_O) {
      tile_dd<D, BQ>(Dt, dOt, Os + st * BQ * P);
      __syncthreads();
    }

    // sᵀ = k·qᵀ; p = exp(sᵀ·scale + bias + mask − lse), in place
    float s[NB][4];
    zero(s);
    scores<D, BQ, HOLD>(s, kf, Ks, warp * 16, Qt, lane);
    const bool edge = edge_tile(a, q0, BQ, k0, BKV);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lq = n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * a.scale + bias[e >> 1];
        if (edge) {
          const int row = q0 + lq, col = k0 + r_lo + (e >> 1) * 8;
          if (masked(row, col, a.causal, a.window)) x += NEG_INF;
          s[n][e] = row < Lq && col < Lk ? expf(x - Lt[lq]) : 0.f;
        } else {
          s[n][e] = expf(x - Lt[lq]);
        }
      }

    // dv += pᵀ·dO, p rounded to bf16 (p.astype(dO.dtype), :812)
    uint32_t xf[BQ / 16][4];
    to_a<BQ>(xf, s);
    accumulate<D, BQ>(dv, xf, dOt, lane);

    // dpᵀ = v·dOᵀ; ds = p∘(dp − D), into dp; dbias takes the f32 ds
    float dp[NB][4];
    zero(dp);
    scores<D, BQ, HOLD>(dp, vf, Vs, warp * 16, dOt, lane);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lq = n * 8 + 2 * t + (e & 1);
        dp[n][e] = s[n][e] * (dp[n][e] - Dt[lq]);
        db[e >> 1] += dp[n][e];
      }

    // dk += dsᵀ·q, ds rounded to bf16 (ds.astype(q.dtype), :816)
    to_a<BQ>(xf, dp);
    accumulate<D, BQ>(dk, xf, Qt, lane);
  }

  // dbias: the 4 lanes of a quad share a key row
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    db[half] += __shfl_xor_sync(0xffffffffu, db[half], 1);
    db[half] += __shfl_xor_sync(0xffffffffu, db[half], 2);
  }
  bf16* dkb = static_cast<bf16*>(a.dk);
  bf16* dvb = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + r_lo + half * 8;
    if (key >= Lk) continue;
    const long long off = (((long long)b * Lk + key) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkb + off + c) =
          pack(dk[n][2 * half] * a.scale, dk[n][2 * half + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + off + c) =
          pack(dv[n][2 * half], dv[n][2 * half + 1]);
    }
    if (a.dbias != nullptr && t == 0)
      a.dbias[(long long)bh * Lk + key] = db[half];
  }
}

}  // namespace tc

// ------------------------------------------------------------------ launch

template <typename Kern>
cudaError_t launch(Kern kern, dim3 grid, int threads, size_t smem,
                   const BwdArgs& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// bf16 goes to the tensor-core kernels, f32 to the FMA kernels
template <typename T>
constexpr bool on_tensor_cores() {
  return std::is_same<T, __nv_bfloat16>::value;
}

template <typename T, int D, bool FROM_O>
struct Dq {
  static size_t smem() {
    if constexpr (on_tensor_cores<T>())
      return tc::dq_smem_bytes<D, FROM_O>();
    else
      return sizeof(float) * dq_smem_floats<D>();
  }
  static cudaError_t run(const BwdArgs& a, cudaStream_t s) {
    if constexpr (on_tensor_cores<T>()) {
      const dim3 grid((a.Lq + tc::ROWS - 1) / tc::ROWS, a.B * a.H);
      return launch(tc::flash_bwd_dq_tc_kernel<D, FROM_O>, grid, tc::NT,
                    smem(), a, s);
    } else {
      const dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H);
      return launch(flash_bwd_dq_kernel<T, D, FROM_O>, grid, NT, smem(), a,
                    s);
    }
  }
};

template <typename T, int D, bool FROM_O>
struct Dkv {
  static size_t smem() {
    if constexpr (on_tensor_cores<T>())
      return tc::dkv_smem_bytes<D, FROM_O>();
    else
      return sizeof(float) * dkv_smem_floats<D>();
  }
  static cudaError_t run(const BwdArgs& a, cudaStream_t s) {
    if constexpr (on_tensor_cores<T>()) {
      const dim3 grid((a.Lk + tc::ROWS - 1) / tc::ROWS, a.B * a.H);
      return launch(tc::flash_bwd_dkv_tc_kernel<D, FROM_O>, grid, tc::NT,
                    smem(), a, s);
    } else {
      const dim3 grid((a.Lk + BK - 1) / BK, a.B * a.H);
      return launch(flash_bwd_dkv_kernel<T, D, FROM_O>, grid, NT, smem(), a,
                    s);
    }
  }
};

template <typename T, int D>
cudaError_t launch_dd_vec(const BwdArgs& a, cudaStream_t s) {
  const long long rows = (long long)a.B * a.H * a.Lq;
  const int per_cta = WARPS * DD_ROWS<T, D>;
  const dim3 grid((unsigned)((rows + per_cta - 1) / per_cta));
  return launch(flash_bwd_dd_vec_kernel<T, D>, grid, NT, 0, a, s);
}

template <typename T>
cudaError_t dd_vec(const BwdArgs& a, cudaStream_t s) {
  switch (a.D) {
    case 16: return launch_dd_vec<T, 16>(a, s);
    case 32: return launch_dd_vec<T, 32>(a, s);
    case 64: return launch_dd_vec<T, 64>(a, s);
    case 128: return launch_dd_vec<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// one switch over (dtype, D, D-from-O) for both tiled kernels: f(Op<T, D,
// FROM_O>{}), or `bad` for a combination that has no kernel
template <template <typename, int, bool> class Op, typename R, typename F>
R dispatch(int dtype, int d, bool from_o, R bad, F f) {
#define KFT_CASE(T, DIM)                                                   \
  if (d == DIM) return from_o ? f(Op<T, DIM, true>{}) : f(Op<T, DIM, false>{});
  if (dtype == 0) {
    KFT_CASE(float, 16) KFT_CASE(float, 32) KFT_CASE(float, 64)
    KFT_CASE(float, 128)
  } else if (dtype == 1) {
    KFT_CASE(__nv_bfloat16, 16) KFT_CASE(__nv_bfloat16, 32)
    KFT_CASE(__nv_bfloat16, 64) KFT_CASE(__nv_bfloat16, 128)
  }
#undef KFT_CASE
  return bad;
}

}  // namespace

// Plain C entry points, bound with ctypes (kubeflow_tpu_torch/kernels/).
// Each launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t (0 = success). dtype: 0 = f32, 1 = bf16.

// vector: 1 runs the 16-byte-load form (the caller checked that o's and dO's
// rows allow it and D is one of 16, 32, 64, 128), 0 the scalar form
extern "C" int kft_flash_bwd_dd(const BwdArgs* a, int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vector) {
    if (a->dtype == 0) return dd_vec<float>(*a, s);
    if (a->dtype == 1) return dd_vec<__nv_bfloat16>(*a, s);
    return cudaErrorInvalidValue;
  }
  const long long rows = (long long)a->B * a->H * a->Lq;
  const dim3 grid((unsigned)((rows + WARPS - 1) / WARPS));
  if (a->dtype == 0)
    return launch(flash_bwd_dd_kernel<float>, grid, NT, 0, *a, s);
  if (a->dtype == 1)
    return launch(flash_bwd_dd_kernel<__nv_bfloat16>, grid, NT, 0, *a, s);
  return cudaErrorInvalidValue;
}

// from_o: 0 reads D from a->dd; 1 computes it per tile from a->o (loop2)
extern "C" int kft_flash_bwd_dq(const BwdArgs* a, int from_o, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<Dq>(a->dtype, a->D, from_o != 0, cudaErrorInvalidValue,
                      [&](auto op) { return op.run(*a, s); });
}

extern "C" int kft_flash_bwd_dkv(const BwdArgs* a, int from_o, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<Dkv>(a->dtype, a->D, from_o != 0, cudaErrorInvalidValue,
                       [&](auto op) { return op.run(*a, s); });
}

// the dynamic shared memory (bytes) a launch of dq (kernel 0) or dkv (1)
// takes for this dtype, head_dim and D form; -1 where there is no kernel
extern "C" long long kft_flash_bwd_smem(int kernel, int dtype, int d,
                                        int from_o) {
  auto bytes = [](auto op) { return (long long)op.smem(); };
  if (kernel == 0) return dispatch<Dq>(dtype, d, from_o != 0, -1LL, bytes);
  if (kernel == 1) return dispatch<Dkv>(dtype, d, from_o != 0, -1LL, bytes);
  return -1;
}

extern "C" const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

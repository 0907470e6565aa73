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
// is operation-bound on the CUDA cores at every training length. dd reads dO
// and O once and does 2 operations per element: bound by bytes.
//
// The design, simple first, like the forward (csrc/flash_fwd.cu): the TPU
// kernels carried dq (or dk/dv/dbias) in VMEM scratch across a sequential grid
// axis; CTAs cannot, so each CTA loops over the opposite axis itself with its
// accumulators in registers. Two passes, as the TPU kernels do: dq over KV
// tiles, dk/dv over Q tiles, each recomputing p from the forward's lse. No CTA
// writes what another CTA writes, so there are no atomics and the results are
// deterministic. 256 threads per CTA, 64×64 tiles, f32 copies of the tiles in
// shared memory (odd pitches keep the rows in different banks), each thread
// owning a 4×4 block of the score tile and 4 rows × D/16 columns of its
// accumulators: at D = 128 the dk and dv sums take 64 registers a thread, no
// more. Arithmetic is f32 FMA on the CUDA cores for both dtypes. Tensor cores
// (wgmma), TMA pipelining and a single-pass backward with atomic dq are left
// for the PRs that make it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dd_kernel(BwdArgs a) {
  // one warp per (b·h, query row), WARPS rows per CTA
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

// ------------------------------------------------------------------ launch

template <typename Kern>
cudaError_t launch(Kern kern, dim3 grid, size_t smem, const BwdArgs& a,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool FROM_O>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H);
  return launch(flash_bwd_dq_kernel<T, D, FROM_O>, grid,
                sizeof(float) * dq_smem_floats<D>(), a, stream);
}

template <typename T, int D, bool FROM_O>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  const dim3 grid((a.Lk + BK - 1) / BK, a.B * a.H);
  return launch(flash_bwd_dkv_kernel<T, D, FROM_O>, grid,
                sizeof(float) * dkv_smem_floats<D>(), a, stream);
}

// one switch over (dtype, D, D-from-O) for both tiled kernels
template <template <typename, int, bool> class Launch>
cudaError_t dispatch(const BwdArgs& a, bool from_o, cudaStream_t stream) {
#define KFT_CASE(T, DIM)                                                   \
  if (a.D == DIM)                                                          \
    return from_o ? Launch<T, DIM, true>::run(a, stream)                   \
                  : Launch<T, DIM, false>::run(a, stream);
  if (a.dtype == 0) {
    KFT_CASE(float, 16) KFT_CASE(float, 32) KFT_CASE(float, 64)
    KFT_CASE(float, 128)
  } else if (a.dtype == 1) {
    KFT_CASE(__nv_bfloat16, 16) KFT_CASE(__nv_bfloat16, 32)
    KFT_CASE(__nv_bfloat16, 64) KFT_CASE(__nv_bfloat16, 128)
  }
#undef KFT_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int D, bool FROM_O>
struct DqLaunch {
  static cudaError_t run(const BwdArgs& a, cudaStream_t s) {
    return launch_dq<T, D, FROM_O>(a, s);
  }
};

template <typename T, int D, bool FROM_O>
struct DkvLaunch {
  static cudaError_t run(const BwdArgs& a, cudaStream_t s) {
    return launch_dkv<T, D, FROM_O>(a, s);
  }
};

}  // namespace

// Plain C entry points, bound with ctypes (kubeflow_tpu_torch/kernels/).
// Each launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t (0 = success). dtype: 0 = f32, 1 = bf16.

extern "C" int kft_flash_bwd_dd(const BwdArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)a->B * a->H * a->Lq;
  const dim3 grid((unsigned)((rows + WARPS - 1) / WARPS));
  if (a->dtype == 0) return launch(flash_bwd_dd_kernel<float>, grid, 0, *a, s);
  if (a->dtype == 1)
    return launch(flash_bwd_dd_kernel<__nv_bfloat16>, grid, 0, *a, s);
  return cudaErrorInvalidValue;
}

// from_o: 0 reads D from a->dd; 1 computes it per tile from a->o (loop2)
extern "C" int kft_flash_bwd_dq(const BwdArgs* a, int from_o, void* stream) {
  return dispatch<DqLaunch>(*a, from_o != 0, static_cast<cudaStream_t>(stream));
}

extern "C" int kft_flash_bwd_dkv(const BwdArgs* a, int from_o, void* stream) {
  return dispatch<DkvLaunch>(*a, from_o != 0,
                             static_cast<cudaStream_t>(stream));
}

extern "C" const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

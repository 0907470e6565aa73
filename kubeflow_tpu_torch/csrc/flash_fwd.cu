// Flash-attention forward for Hopper (sm_90a), written by hand: one C entry
// point, two kernels.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (kubeflow_tpu/parallel/ring_attention.py:584) as `_flash_forward` launches
// it (ring_attention.py:688). Same function:
//
//   O   = softmax(q·kᵀ/√D + bias + mask) · v          (input dtype)
//   lse = m + log(max(l, 1e-30))                        (f32, per query row)
//
// with the causal mask (col > row), the sliding window (row − col ≥ window,
// only with causal) added as −1e9 like the TPU kernel, and whole KV tiles that
// no query of the Q tile can see skipped (`_block_live`, :571). Layout is the
// public one: q (B, Lq, H, D), k/v (B, Lk, H, D), bias (B, 1, 1, Lk), all
// contiguous and of one dtype (f32 or bf16); O (B, Lq, H, D); lse (B, H, Lq).
// Any Lq, Lk >= 1: the ragged edge is bounds-checked here, where the TPU
// wrapper fell back to a plain scan. D ∈ {16, 32, 64, 128}. The rounding
// points are the TPU kernel's (:605-628): s = (q·kᵀ in f32)·scale + bias, the
// mask added to s, l summing the f32 p, only the operand of p·v rounded to
// the value dtype, acc and l rescaled by exp(m_prev − m_new).
//
// What bounds it on the H100: the work is 4·B·H·Lq·Lk·D operations (2 for
// q·kᵀ, 2 for p·v; about half of that under causal) against about
// 4·B·L·H·D·sizeof(T) bytes that must move (q, k, v in, O out). Per byte that
// is ~L/8 operations in f32 causal and ~L/4 in bf16, so at the serving and
// training shapes (L 128..2048) it is bound by operations: on the CUDA cores
// in f32 (67 TFLOP/s), on the tensor cores in bf16 (989 TFLOP/s).
//
// Both kernels run one CTA of 128 threads per (b·h, 64-row Q tile), looping
// over 64-key KV tiles with the running max m, sum l and output acc in
// registers (the TPU kernel kept them in VMEM scratch across grid steps; CTAs
// cannot carry state across a grid, so the loop lives inside the CTA). The
// score tile never leaves the SM.
//
// f32 (flash_fwd_kernel): each K/V tile is read into shared memory as f32 and
// reused by all 64 query rows; each thread owns an 8x4 micro-tile of scores
// and an 8x(D/16) tile of O, so a shared-memory load feeds several FMAs. f32
// FMA on the CUDA cores: f32 inputs need f32 products to hold the 1e-4
// tolerance (TF32 would change the numbers).
//
// bf16 (tc::flash_fwd_tc_kernel), FlashAttention-2 style, with the building
// blocks of tc_bf16.cuh: each of the 4 warps owns 16 query rows; both products
// are mma.sync m16n8k16 with bf16 operands and f32 accumulation, the TPU
// kernel's bf16 dot_general with preferred_element_type=f32. The warp holds
// its q rows as ldmatrix-loaded A fragments across all K/V tiles at D ≤ 64
// and reads them per k-step at D = 128. K/V tiles arrive by 16-byte cp.async
// into padded bf16 shared tiles, two stages deep (the next tile is in flight
// while the current one computes), rows past Lk zero-filled; bias is staged
// through a register. s = q·kᵀ takes K through plain ldmatrix; scale, bias
// and mask are applied to the f32 accumulators, the mask element by element
// only on tiles that cross the diagonal, the window edge or the ragged end.
// The online softmax runs in registers (a row's scores sit in the 4 lanes of
// a quad: two shuffles); p is rounded to bf16 in registers and repacked from
// the score accumulators into the A fragments of p·v, V through
// ldmatrix.trans, so p never goes to shared memory. O is written once, after
// dividing by l. The grid is (B·H, Q tiles) with the longest causal Q tiles
// first, so the short ones fill the tail. wgmma with TMA loads and warp
// specialisation are left for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tc_bf16.cuh"

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per KV tile
constexpr int NT = 128;         // threads per CTA
constexpr int COL_LANES = 16;   // lanes sharing one row group (tid % 16)
constexpr int ROW_GROUPS = NT / COL_LANES;        // 8 (tid / 16)
constexpr int RPT = BQ / ROW_GROUPS;              // rows per thread: 8
constexpr int CPT = BK / COL_LANES;               // score cols per thread: 4
constexpr float NEG_INF = -1e9f;                  // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <typename T, int D>
constexpr size_t smem_bytes() {
  // Qs, Ks (pitch D+1), Vs (pitch D), Ps (pitch BK+1), bias tile
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ bias,
                     T* __restrict__ o, float* __restrict__ lse, int H, int Lq,
                     int Lk, float scale, int causal, int window) {
  constexpr int QP = D + 1;  // odd pitch: neighbouring rows in other banks
  constexpr int PP = BK + 1;
  constexpr int DPT = D / COL_LANES;  // O columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * QP;
  float* Ps = Vs + BK * D;
  float* Bs = Ps + BQ * PP;

  const int tid = threadIdx.x;
  const int tr = tid / COL_LANES;
  const int tc = tid % COL_LANES;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int64_t pos_stride = (int64_t)H * D;  // between sequence positions
  const T* qb = q + (int64_t)b * Lq * pos_stride + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Lk * pos_stride + (int64_t)h * D;
  const T* vb = v + (int64_t)b * Lk * pos_stride + (int64_t)h * D;
  const T* biasb = bias + (int64_t)b * Lk;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, gr = q0 + r;
    Qs[r * QP + c] = gr < Lq ? to_f32(qb[gr * pos_stride + c]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  // the live KV tiles of this Q tile (`_block_live`): at or below the
  // diagonal of its last row, and not wholly older than its first row's window
  const int q_last = min(q0 + BQ, Lq) - 1;
  int kt_end = (Lk + BK - 1) / BK;
  int kt_begin = 0;
  if (causal) {
    kt_end = min(kt_end, q_last / BK + 1);
    const int oldest = q0 - (window - 1);
    if (window > 0 && oldest > 0) kt_begin = oldest / BK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, gk = k0 + r;
      const bool in = gk < Lk;
      Ks[r * QP + c] = in ? to_f32(kb[gk * pos_stride + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[gk * pos_stride + c]) : 0.f;
    }
    for (int i = tid; i < BK; i += NT)
      Bs[i] = k0 + i < Lk ? to_f32(biasb[k0 + i]) : 0.f;
    __syncthreads();

    // scores: rows tr + 8i, cols tc + 16j of the tile
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(tr + ROW_GROUPS * i) * QP + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tc + COL_LANES * j) * QP + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; a row's 64 scores sit in the 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int lr = tr + ROW_GROUPS * i;
      const int row = q0 + lr;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int lc = tc + COL_LANES * j;
        const int col = k0 + lc;
        float x = -INFINITY;  // past Lk: no key, weight exactly 0
        if (col < Lk) {
          x = s[i][j] * scale + Bs[lc];
          if (causal && (col > row || (window > 0 && row - col >= window)))
            x += NEG_INF;
        }
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = COL_LANES / 2; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        // p·v takes p in the value dtype, as the TPU kernel's p.astype(v.dtype)
        Ps[lr * PP + tc + COL_LANES * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = COL_LANES / 2; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

    const int kn = min(BK, Lk - k0);
    for (int j = 0; j < kn; ++j) {
      float vv[DPT];
#pragma unroll
      for (int e = 0; e < DPT; ++e) vv[e] = Vs[j * D + tc + COL_LANES * e];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(tr + ROW_GROUPS * i) * PP + j];
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + tr + ROW_GROUPS * i;
    if (row >= Lq) continue;
    T* orow = o + ((int64_t)b * Lq + row) * pos_stride + (int64_t)h * D;
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      orow[tc + COL_LANES * e] = from_f32<T>(acc[i][e] / l[i]);
    if (tc == 0)
      lse[(int64_t)bh * Lq + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ------------------------------------------------------- bf16: tensor cores

namespace tc {

// Q, K (2 stages), V (2 stages) as padded bf16 rows; bias, 2 stages of f32
template <int D>
constexpr size_t FWD_SMEM =
    sizeof(bf16) * 5 * BQ * (D + PAD) + sizeof(float) * 2 * BK;

template <int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ bias, bf16* __restrict__ o,
                        float* __restrict__ lse, int H, int Lq, int Lk,
                        float scale, int causal, int window) {
  constexpr int P = D + PAD, NB = BK / 8;
  constexpr bool HOLD = HOLD_ROWS<D>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Ks = Qs + BQ * P;      // 2 stages
  bf16* Vs = Ks + 2 * BK * P;  // 2 stages
  float* Bs = reinterpret_cast<float*>(Vs + 2 * BK * P);  // 2 stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int b = bh / H, h = bh % H;
  const long long sl = (long long)H * D;  // between sequence positions
  const bf16* qb = q + (long long)b * Lq * sl + (long long)h * D;
  const bf16* kb = k + (long long)b * Lk * sl + (long long)h * D;
  const bf16* vb = v + (long long)b * Lk * sl + (long long)h * D;
  const bf16* biasb = bias + (long long)b * Lk;

  // the live KV tiles of this Q tile, as the f32 kernel bounds them
  const int q_last = min(q0 + BQ, Lq) - 1;
  int kt_end = (Lk + BK - 1) / BK;
  int kt_begin = 0;
  if (causal) {
    kt_end = min(kt_end, q_last / BK + 1);
    const int oldest = q0 - (window - 1);
    if (window > 0 && oldest > 0) kt_begin = oldest / BK;
  }

  load_rows<D, BQ>(Qs, qb, sl, q0, Lq);
  {
    const int k0 = kt_begin * BK;
    load_rows<D, BK>(Ks, kb, sl, k0, Lk);
    load_rows<D, BK>(Vs, vb, sl, k0, Lk);
    if (tid < BK)
      Bs[tid] = k0 + tid < Lk ? __bfloat162float(biasb[k0 + tid]) : 0.f;
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();

  const int r_lo = warp * 16 + g;  // this lane's rows: r_lo and r_lo + 8
  uint32_t qf[HOLD ? D / 16 : 1][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      lds_a<P>(qf[kk], Qs, warp * 16, kk * 16, lane);
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero(acc);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1, k0 = kt * BK;
    if (kt > kt_begin) {
      cp_wait_all();    // this tile's K/V
      __syncthreads();  // ... for every warp; the other stage is free
    }
    float bias_next = 0.f;
    if (kt + 1 < kt_end) {
      const int k1 = k0 + BK;
      load_rows<D, BK>(Ks + (st ^ 1) * BK * P, kb, sl, k1, Lk);
      load_rows<D, BK>(Vs + (st ^ 1) * BK * P, vb, sl, k1, Lk);
      if (tid < BK && k1 + tid < Lk)
        bias_next = __bfloat162float(biasb[k1 + tid]);
    }
    cp_commit();
    const bf16* Kt = Ks + st * BK * P;
    const bf16* Vt = Vs + st * BK * P;
    const float* Bt = Bs + st * BK;

    // s = (q·kᵀ in f32)·scale + bias (+ mask); keys past Lk weigh exactly 0
    float s[NB][4];
    zero(s);
    scores<D, BK, HOLD>(s, qf, Qs, warp * 16, Kt, lane);
    const bool edge =
        k0 + BK > Lk ||
        (causal && (k0 + BK - 1 > q0 ||
                    (window > 0 && q0 + BQ - 1 - k0 >= window)));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lc = n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale + Bt[lc];
        if (edge) {
          const int row = q0 + r_lo + (e >> 1) * 8, col = k0 + lc;
          if (col >= Lk)
            x = -INFINITY;
          else if (causal && (col > row || (window > 0 && row - col >= window)))
            x += NEG_INF;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }

    // online softmax; a row's 64 scores sit in the 4 lanes of a quad
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      const float m_new = fmaxf(m[half], mx[half]);
      corr[half] = expf(m[half] - m_new);
      m[half] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        sum[e >> 1] += p;  // l sums the f32 p (p.sum(-1), :624)
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
      l[half] = l[half] * corr[half] + sum[half];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // acc += p·v, p rounded to bf16 (p.astype(v.dtype), :626)
    uint32_t pf[BK / 16][4];
    to_a<BK>(pf, s);
    accumulate<D, BK>(acc, pf, Vt, lane);
    if (kt + 1 < kt_end && tid < BK) Bs[(st ^ 1) * BK + tid] = bias_next;
  }

  bf16* ob = o + (long long)b * Lq * sl + (long long)h * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r_lo + half * 8;
    if (row >= Lq) continue;
    bf16* out = ob + row * sl;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) =
          pack(acc[n][2 * half] / l[half], acc[n][2 * half + 1] / l[half]);
    if (t == 0)
      lse[(long long)bh * Lq + row] = m[half] + logf(fmaxf(l[half], 1e-30f));
  }
}

}  // namespace tc

// ------------------------------------------------------------------ launch

struct Fwd {
  const void *q, *k, *v, *bias;
  void* o;
  float* lse;
  int B, H, Lq, Lk;
  float scale;
  int causal, window;
};

template <typename T>
cudaError_t launch(void (*kern)(const T*, const T*, const T*, const T*, T*,
                                float*, int, int, int, float, int, int),
                   dim3 grid, size_t smem, const Fwd& a,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.bias),
      static_cast<T*>(a.o), a.lse, a.H, a.Lq, a.Lk, a.scale, a.causal,
      a.window);
  return cudaGetLastError();
}

// f32 runs the FMA kernel
template <int D>
struct Fma {
  static size_t smem() { return smem_bytes<float, D>(); }
  static cudaError_t run(const Fwd& a, cudaStream_t s) {
    const dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H);
    return launch(flash_fwd_kernel<float, D>, grid, smem(), a, s);
  }
};

// bf16 runs the tensor-core kernel
template <int D>
struct Tc {
  static size_t smem() { return tc::FWD_SMEM<D>; }
  static cudaError_t run(const Fwd& a, cudaStream_t s) {
    const dim3 grid(a.B * a.H, (a.Lq + BQ - 1) / BQ);
    return launch(tc::flash_fwd_tc_kernel<D>, grid, smem(), a, s);
  }
};

// f(Op<D>{}) for the head_dim d, or `bad` where there is no kernel
template <template <int> class Op, typename R, typename F>
R dispatch(int d, R bad, F f) {
  switch (d) {
    case 16: return f(Op<16>{});
    case 32: return f(Op<32>{});
    case 64: return f(Op<64>{});
    case 128: return f(Op<128>{});
    default: return bad;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes (kubeflow_tpu_torch/kernels/).
// dtype: 0 = f32, 1 = bf16. kft_flash_fwd launches on `stream` and does not
// synchronise; it returns the launch's cudaError_t (0 = success).
extern "C" int kft_flash_fwd(const void* q, const void* k, const void* v,
                             const void* bias, void* o, float* lse, int B,
                             int H, int Lq, int Lk, int D, int dtype,
                             int causal, int window, float scale,
                             void* stream) {
  const Fwd a{q, k, v, bias, o, lse, B, H, Lq, Lk, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto op) { return op.run(a, s); };
  if (dtype == 0) return dispatch<Fma>(D, cudaErrorInvalidValue, run);
  if (dtype == 1) return dispatch<Tc>(D, cudaErrorInvalidValue, run);
  return cudaErrorInvalidValue;
}

// the dynamic shared memory (bytes) a launch takes for this dtype and
// head_dim; -1 where there is no kernel
extern "C" long long kft_flash_fwd_smem(int dtype, int d) {
  auto bytes = [](auto op) { return (long long)op.smem(); };
  if (dtype == 0) return dispatch<Fma>(d, -1LL, bytes);
  if (dtype == 1) return dispatch<Tc>(d, -1LL, bytes);
  return -1;
}

extern "C" const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

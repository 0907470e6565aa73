// Flash-attention forward for Hopper (sm_90a), written by hand.
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
// wrapper fell back to a plain scan. D ∈ {16, 32, 64, 128}.
//
// What bounds it on the H100: the work is 4·B·H·Lq·Lk·D operations (2 for
// q·kᵀ, 2 for p·v; about half of that under causal) against about
// 4·B·L·H·D·sizeof(T) bytes that must move (q, k, v in, O out). Per byte that
// is ~L/8 operations in f32 causal, so at the serving shapes (L 128..1024)
// this is operation-bound on the CUDA cores, not memory-bound.
//
// The design, simple first: one CTA of 128 threads per (b·h, 64-row Q tile),
// looping over 64-key KV tiles with the running max m, sum l and output acc
// in registers (the TPU kernel kept them in VMEM scratch across grid steps;
// CTAs cannot carry state across a grid, so the loop lives inside the CTA).
// Each K/V tile is read from device memory once per Q tile into shared
// memory as f32 and reused by all 64 query rows; the score tile never leaves
// the SM. Each thread owns an 8x4 micro-tile of scores and an 8x(D/16) tile
// of O, so a shared-memory load feeds several FMAs. Arithmetic is f32 FMA on
// the CUDA cores for both dtypes (f32 inputs need f32 products to hold the
// 1e-4 tolerance). Tensor cores (mma/wgmma for bf16), TMA or cp.async double
// buffering and warp specialisation are left for the PR that makes it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* o, float* lse, int B, int H, int Lq,
                   int Lk, float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bias),
      static_cast<T*>(o), lse, H, Lq, Lk, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* bias, void* o, float* lse, int B, int H,
                       int Lq, int Lk, float scale, int causal, int window,
                       cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, bias, o, lse, B, H, Lq, Lk, scale, causal,
                           window, stream);
    case 32:
      return launch<T, 32>(q, k, v, bias, o, lse, B, H, Lq, Lk, scale, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, bias, o, lse, B, H, Lq, Lk, scale, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, bias, o, lse, B, H, Lq, Lk, scale,
                            causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (kubeflow_tpu_torch/kernels/).
// dtype: 0 = f32, 1 = bf16. Launches on `stream` and does not synchronise;
// returns the launch's cudaError_t (0 = success).
extern "C" int kft_flash_fwd(const void* q, const void* k, const void* v,
                             const void* bias, void* o, float* lse, int B,
                             int H, int Lq, int Lk, int D, int dtype,
                             int causal, int window, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, bias, o, lse, B, H, Lq, Lk, scale,
                             causal, window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, bias, o, lse, B, H, Lq, Lk,
                                     scale, causal, window, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

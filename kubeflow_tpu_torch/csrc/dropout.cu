// Dropout whose mask is drawn on the device, for Hopper (sm_90a), written by
// hand: two C entry points (forward, backward), one fused elementwise pass
// each.
//
// Replaces no Pallas kernel. The JAX package draws its dropout masks with
// jax.random.bernoulli inside XLA (kubeflow_tpu/models/gpt.py:218, and the
// nn.Dropout layers at :404, :435, :475; bert.py and vit.py alike), so on
// the TPU there is no hand-written kernel to port. The port needs one
// because a training step captured into a CUDA graph must draw new masks
// at every replay: a mask drawn from a host generator is baked into the
// graph. Here the seed is a device int64 that the host fills before each
// step or replay, and the kernel reads it by pointer.
//
// The function, for element i of the flattened (contiguous) input:
//
//   key  = (seed & 0xffffffff, seed >> 32)
//   e    = (i / row) * row_stride + offset + i % row
//   ctr  = (g & 0xffffffff, g >> 32, site, 0),  g = e / 4
//   r    = Philox4x32-10(ctr, key)[e % 4]      (Salmon et al. 2011; the
//                                              Random123 round and key
//                                              schedule)
//
// e is the element's index in the whole tensor of which the input holds a
// slice: rows of ``row`` elements that sit ``row_stride`` apart there,
// starting at ``offset`` (a rank of a context axis holds L/ctx positions of
// every sequence, and its masks are the whole sequence's). The plain input
// has row = row_stride = n, offset 0, so e = i. The wrapper takes row,
// row_stride and offset that are multiples of 4 (or row = n), so the 4
// elements a thread takes are 4 consecutive elements of the whole.
//   y[i] = r < threshold ? x[i] * scale : 0    (x[i] * scale in f32, then
//                                              rounded to x's dtype)
//
// with threshold = ceil(keep * 2^32) (so r / 2^32 < keep) and scale the f32
// 1 / keep. ``site`` numbers the dropout sites that share one seed (a
// block's attention and MLP outputs), so their masks differ. The backward
// is the same function of dy: it recomputes the mask from (seed, site, i),
// so no mask is stored. kernels/dropout.py holds the plain PyTorch version
// (the same Philox rounds on int64 tensors), which gives the same bits.
//
// What bounds it on the H100: each element is read once and written once
// (2 x sizeof(T) bytes) against one Philox call per 4 elements (10 rounds
// of two 32x32->64 multiplies), about 20 integer operations an element.
// That is below the card's ratio of operations to bytes, so it is bound by
// bytes: at GPT-2 small's residual (8, 1024, 768) in bf16, 25 MB move, 7.5
// us at 3.35 TB/s. Each thread takes 4 consecutive elements per Philox
// call, with one 16-byte (f32) or 8-byte (16-bit types) load and store when
// the pointers allow; a grid-stride loop covers any size.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Vec = float4;
  __device__ static float load(float v) { return v; }
  __device__ static float store(float v) { return v; }
  __device__ static void split(const Vec& v, float (&out)[4]) {
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static Vec join(const float (&in)[4]) {
    return make_float4(in[0], in[1], in[2], in[3]);
  }
};

// 16-bit types move as 4 values in one 8-byte uint2
template <typename T, typename Cvt>
struct Elem16 {
  using Vec = uint2;
  __device__ static void split(const Vec& v, float (&out)[4]) {
    const T* h = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = Cvt::to(h[j]);
  }
  __device__ static Vec join(const float (&in)[4]) {
    Vec v;
    T* h = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = Cvt::from(in[j]);
    return v;
  }
};

struct Bf16Cvt {
  __device__ static float to(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from(float v) {
    return __float2bfloat16_rn(v);
  }
};

struct HalfCvt {
  __device__ static float to(__half v) { return __half2float(v); }
  __device__ static __half from(float v) { return __float2half_rn(v); }
};

template <>
struct Elem<__nv_bfloat16> : Elem16<__nv_bfloat16, Bf16Cvt> {
  __device__ static float load(__nv_bfloat16 v) { return Bf16Cvt::to(v); }
  __device__ static __nv_bfloat16 store(float v) { return Bf16Cvt::from(v); }
};

template <>
struct Elem<__half> : Elem16<__half, HalfCvt> {
  __device__ static float load(__half v) { return HalfCvt::to(v); }
  __device__ static __half store(float v) { return HalfCvt::from(v); }
};

// Backward is a template argument only so that the two passes carry their
// own names in a profile: the arithmetic is the same function of its input.
// Sliced: rows of a larger tensor (row < n), whose element indices take a
// division; a single row (the whole tensor) compiles without it.
template <typename T, bool Backward, bool Sliced>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const int64_t* __restrict__ seed, int64_t n, int64_t row,
                   int64_t row_stride, int64_t offset, uint32_t site,
                   uint64_t threshold, float scale, bool vec) {
  using E = Elem<T>;
  const uint64_t s = static_cast<uint64_t>(*seed);
  const uint2 key = make_uint2(static_cast<uint32_t>(s),
                               static_cast<uint32_t>(s >> 32));
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       g < groups; g += stride) {
    const int64_t i0 = 4 * g;
    const int64_t e0 = Sliced ? (i0 / row) * row_stride + offset + i0 % row
                              : offset + i0;
    const uint64_t c = static_cast<uint64_t>(e0) >> 2;
    const uint4 r4 = philox4x32_10(
        make_uint4(static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32),
                   site, 0u),
        key);
    const uint32_t r[4] = {r4.x, r4.y, r4.z, r4.w};
    if (vec && i0 + 4 <= n) {
      float v[4];
      E::split(reinterpret_cast<const typename E::Vec*>(x)[g], v);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = r[j] < threshold ? v[j] * scale : 0.f;
      reinterpret_cast<typename E::Vec*>(y)[g] = E::join(v);
    } else {
      for (int j = 0; j < 4 && i0 + j < n; ++j) {
        const float v = E::load(x[i0 + j]);
        y[i0 + j] = E::store(r[j] < threshold ? v * scale : 0.f);
      }
    }
  }
}

template <typename T, bool Backward>
int launch(const void* x, void* y, const void* seed, long long n,
           long long row, long long row_stride, long long offset, int site,
           unsigned long long threshold, float scale, int vec,
           cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks)), block(kThreads);
  if (row == n)
    dropout_kernel<T, Backward, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y),
        static_cast<const int64_t*>(seed), n, row, row_stride, offset,
        static_cast<uint32_t>(site), threshold, scale, vec != 0);
  else
    dropout_kernel<T, Backward, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y),
        static_cast<const int64_t*>(seed), n, row, row_stride, offset,
        static_cast<uint32_t>(site), threshold, scale, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

template <bool Backward>
int dispatch(const void* x, void* y, const void* seed, long long n,
             long long row, long long row_stride, long long offset,
             int dtype, int site, unsigned long long threshold, float scale,
             int vec, void* stream) {
  if (n <= 0 || row <= 0 || n % row || offset % 4 ||
      (row != n && (row % 4 || row_stride % 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, Backward>(x, y, seed, n, row, row_stride, offset,
                                     site, threshold, scale, vec, s);
    case 1:
      return launch<__nv_bfloat16, Backward>(x, y, seed, n, row, row_stride,
                                             offset, site, threshold, scale,
                                             vec, s);
    case 2:
      return launch<__half, Backward>(x, y, seed, n, row, row_stride,
                                      offset, site, threshold, scale, vec,
                                      s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y: n contiguous elements of dtype (0 f32, 1 bf16, 2 f16); row,
// row_stride, offset: where they sit in the whole tensor (n, n, 0 for the
// whole); seed: one int64 on the device; vec: x and y start 16-byte
// aligned (4 elements a load). Returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for a layout the kernel does not take.
extern "C" int kft_dropout_fwd(const void* x, void* y, const void* seed,
                               long long n, long long row,
                               long long row_stride, long long offset,
                               int dtype, int site,
                               unsigned long long threshold, float scale,
                               int vec, void* stream) {
  return dispatch<false>(x, y, seed, n, row, row_stride, offset, dtype, site,
                         threshold, scale, vec, stream);
}

// dx from dy: the forward's function of dy, its mask recomputed
extern "C" int kft_dropout_bwd(const void* dy, void* dx, const void* seed,
                               long long n, long long row,
                               long long row_stride, long long offset,
                               int dtype, int site,
                               unsigned long long threshold, float scale,
                               int vec, void* stream) {
  return dispatch<true>(dy, dx, seed, n, row, row_stride, offset, dtype,
                        site, threshold, scale, vec, stream);
}

extern "C" const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The two reduction-free elementwise chains of a transformer block, the
// SwiGLU gate and RoPE, each as one pass.  Neither replaces a TPU kernel:
// XLA fuses each chain into one loop on the TPU, while PyTorch runs it op
// by op, 7 kernels for the gate and about 16 for a RoPE call, most of them
// strided (kernels/ref.py: swiglu_ref, rope_ref, the chains these replace).
//
// Bitwise contract: each step rounds where the op-by-op chain rounds, so
// the pass gives the chain's bits.  PyTorch's CUDA kernels compute a bf16
// or fp16 op in float32 and round its result to the dtype (nearest even);
// a bf16 tensor times a float32 one is promoted to float32.  Every float
// operation here is an _rn intrinsic, so nvcc's default -fmad=true cannot
// contract a product and a sum into one FMA with a single rounding, and
// expf is libdevice's accurate one (no fast math), as in PyTorch's build.
//
// Bound on the H100: memory.  The gate reads h1 and h3 and writes y (6
// bytes a bf16 element) for ~10 float operations and one expf; RoPE reads
// x and writes its rotation (4 bytes a bf16 element) and reads the
// [n_pos, Dh/2] float32 tables, which stay in L2.  So a thread moves 16 bytes
// a load and a store (8 bf16 or fp16, 4 float32), and a grid-stride loop
// over a grid of 8 blocks an SM keeps every SM's loads in flight.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace glue {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;     // 2048 threads: a full SM

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// v rounded to T (nearest even), as float32: the result of a PyTorch op
// on T tensors
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// VEC elements of T from src to dst: 16-byte accesses where VEC * sizeof(T)
// is a multiple of 16 (both 16-byte aligned), else one access an element.
template <typename T, int VEC>
__device__ __forceinline__ void copy(T* dst, const T* src) {
  if constexpr (VEC * sizeof(T) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(VEC * sizeof(T) / 16); ++i)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = src[i];
  }
}

// h1 * (1 / (1 + exp(-h1))) * h3 with PyTorch's roundings: exp, the add of
// 1, the reciprocal (1 / t is t.reciprocal() * 1, and the * 1 is exact)
// and both products each rounded to T.
template <typename T>
__device__ __forceinline__ T gate(T h1, T h3) {
  const float x = to_f(h1);
  const float e = rnd<T>(expf(-x));
  const float a = rnd<T>(__fadd_rn(e, 1.0f));
  const float r = rnd<T>(__fdiv_rn(1.0f, a));
  const float s = rnd<T>(__fmul_rn(x, r));
  return from_f<T>(__fmul_rn(s, to_f(h3)));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const T* __restrict__ h1, const T* __restrict__ h3,
              T* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t nvec = n / VEC;
  for (int64_t v = tid; v < nvec; v += stride) {
    alignas(16) T a[VEC];
    alignas(16) T b[VEC];
    copy<T, VEC>(a, h1 + v * VEC);
    copy<T, VEC>(b, h3 + v * VEC);
#pragma unroll
    for (int j = 0; j < VEC; ++j) a[j] = gate(a[j], b[j]);
    copy<T, VEC>(out + v * VEC, a);
  }
  for (int64_t i = nvec * VEC + tid; i < n; i += stride)
    out[i] = gate(h1[i], h3[i]);
}

// x: rows of 2 half elements, [..., H, 2 half] contiguous; cs, sn: n_pos
// rows of half float32, the tables of x's last leading dims (a prefill's
// [S], decode's [B, 1]), so row r takes table row p = (r / H) % n_pos.
// With x1 = x[:half], x2 = x[half:] of a row, as PyTorch's promoted
// float32 ops round them:
//   out[j]        = T(x1[j] cs[p, j] - x2[j] sn[p, j])
//   out[j + half] = T(x1[j] sn[p, j] + x2[j] cs[p, j])
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const float* __restrict__ cs,
            const float* __restrict__ sn, T* __restrict__ out, int64_t rows,
            int64_t n_pos, int64_t H, int64_t half) {
  const int64_t per_row = half / VEC;
  const int64_t work = rows * per_row;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (int64_t w = tid; w < work; w += stride) {
    const int64_t r = w / per_row;
    const int64_t j = (w - r * per_row) * VEC;
    const int64_t at = (r / H) % n_pos * half + j;
    const int64_t base = 2 * half * r + j;
    alignas(16) T x1[VEC];
    alignas(16) T x2[VEC];
    alignas(16) float c[VEC];
    alignas(16) float s[VEC];
    copy<T, VEC>(x1, x + base);
    copy<T, VEC>(x2, x + base + half);
    copy<float, VEC>(c, cs + at);
    copy<float, VEC>(s, sn + at);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float a = to_f(x1[k]);
      const float b = to_f(x2[k]);
      x1[k] = from_f<T>(__fsub_rn(__fmul_rn(a, c[k]), __fmul_rn(b, s[k])));
      x2[k] = from_f<T>(__fadd_rn(__fmul_rn(a, s[k]), __fmul_rn(b, c[k])));
    }
    copy<T, VEC>(out + base, x1);
    copy<T, VEC>(out + base + half, x2);
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline unsigned grid(int64_t work, int sms) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  return static_cast<unsigned>(blocks < 1 ? 1 : (blocks < cap ? blocks : cap));
}

template <typename T>
int swiglu_launch(const void* h1, const void* h3, void* out, int64_t n,
                  int sms, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const T* a = static_cast<const T*>(h1);
  const T* b = static_cast<const T*>(h3);
  T* o = static_cast<T*>(out);
  if (aligned16(h1) && aligned16(h3) && aligned16(out))
    swiglu_kernel<T, VEC><<<grid(n / VEC, sms), kThreads, 0, st>>>(a, b, o, n);
  else
    swiglu_kernel<T, 1><<<grid(n, sms), kThreads, 0, st>>>(a, b, o, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rope_launch(const void* x, const float* cs, const float* sn, void* out,
                int64_t rows, int64_t n_pos, int64_t H, int64_t half,
                int sms, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (half % VEC == 0 && aligned16(x) && aligned16(out) && aligned16(cs) &&
      aligned16(sn))
    rope_kernel<T, VEC><<<grid(rows * (half / VEC), sms), kThreads, 0, st>>>(
        xi, cs, sn, o, rows, n_pos, H, half);
  else
    rope_kernel<T, 1><<<grid(rows * half, sms), kThreads, 0, st>>>(
        xi, cs, sn, o, rows, n_pos, H, half);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace glue
}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (ops._GLUE_DTYPES).  sms: the
// card's SM count, which sizes the grid.  Each returns the cudaError_t of
// its launch.

// h1, h3, out: n elements each, contiguous.
extern "C" int afp_swiglu(const void* h1, const void* h3, void* out,
                          int64_t n, int dtype, int sms, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return glue::swiglu_launch<float>(h1, h3, out, n, sms, st);
    case 1: return glue::swiglu_launch<__nv_bfloat16>(h1, h3, out, n, sms, st);
    case 2: return glue::swiglu_launch<__half>(h1, h3, out, n, sms, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, out: rows x (2 half) elements, contiguous, x's rows [..., H] in C
// order; cs, sn: [n_pos, half] float32, contiguous, n_pos the product of
// the dims of x's rows before H that the tables cover (the last ones).
extern "C" int afp_rope(const void* x, const float* cs, const float* sn,
                        void* out, int64_t rows, int64_t n_pos, int64_t H,
                        int64_t half, int dtype, int sms, void* stream) {
  if (rows <= 0 || half <= 0) return static_cast<int>(cudaSuccess);
  if (n_pos <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return glue::rope_launch<float>(x, cs, sn, out, rows, n_pos, H, half,
                                      sms, st);
    case 1:
      return glue::rope_launch<__nv_bfloat16>(x, cs, sn, out, rows, n_pos,
                                              H, half, sms, st);
    case 2:
      return glue::rope_launch<__half>(x, cs, sn, out, rows, n_pos, H, half,
                                       sms, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

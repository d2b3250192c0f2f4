// Replaces the TPU kernel repro/kernels/quant_bitflip.py:50
// quant_bitflip_pallas (body _quant_bitflip_kernel, :27-43): quantize a
// float tensor with a symmetric per-tensor scale, corrupt the LSBs of the
// integers, dequantize back to the input dtype.
//
// Port shape: x is [R, n], one candidate per row, each with its own amax
// and scale (the reference computes the scale per tensor under vmap) and
// its own rate.  Two passes:
//   1. amax_kernel: per-row max|x|, a block reduction then one atomicMax
//      per block on the float's bits, which orders like the float since
//      |x| >= 0; exact in any order.
//   2. quant_bitflip_kernel: scale = max(amax, FLT_MIN) * fl32(1 / qmax)
//      (the reference's jitted amax / qmax, which XLA rewrites into a
//      multiply by the constant's float32 reciprocal), then
//      rintf(x / scale), clip, apply_fault, q * scale in x's dtype.
//
// Exactness: built without --use_fast_math, so x / scale is the IEEE
// division and subnormals are kept (an all-zero row has the subnormal
// scale FLT_MIN / qmax, which flush-to-zero would turn into 0 / 0), and
// rintf rounds half to even like jnp.round / torch.round.
//
// Bound on the H100: two reads and one write per element (12 B for fp32),
// plus the hash's integer work per bit plane, which at 4 planes outweighs
// the bytes.  The rate enters as faultmodel.cuh's integer threshold,
// computed once per row.  Both passes use 16-byte accesses and grid-stride loops; the
// random bits never leave registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>

#include "faultmodel.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void amax_kernel(const T* __restrict__ x, float* __restrict__ amax,
                            int64_t n, bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xr = x + static_cast<int64_t>(blockIdx.y) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nvec = vec_ok ? n / VEC : 0;
  float m = 0.0f;
  for (int64_t v = tid; v < nvec; v += stride) {
    alignas(16) T e[VEC];
    *reinterpret_cast<int4*>(e) = reinterpret_cast<const int4*>(xr)[v];
#pragma unroll
    for (int j = 0; j < VEC; ++j) m = fmaxf(m, fabsf(to_f32(e[j])));
  }
  for (int64_t i = nvec * VEC + tid; i < n; i += stride)
    m = fmaxf(m, fabsf(to_f32(xr[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
  __shared__ float warp_max[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (blockDim.x >> 5) ? warp_max[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
    if (lane == 0)
      atomicMax(reinterpret_cast<int*>(amax) + blockIdx.y, __float_as_int(m));
  }
}

template <typename T, int MODEL>
__device__ __forceinline__ T quant_fault(T v, uint32_t idx, float scale,
                                         float qmin, float qmax,
                                         uint32_t seed, uint32_t thresh,
                                         int faulty_bits, int mbu_width) {
  float r = rintf(__fdiv_rn(to_f32(v), scale));
  r = fminf(fmaxf(r, qmin), qmax);
  const int32_t q = afp::apply_fault<MODEL>(static_cast<int32_t>(r), idx, seed,
                                            thresh, faulty_bits, mbu_width);
  return from_f32<T>(__fmul_rn(static_cast<float>(q), scale));
}

template <typename T, int MODEL>
__global__ void quant_bitflip_kernel(const T* __restrict__ x,
                                     T* __restrict__ out,
                                     const float* __restrict__ amax,
                                     const float* __restrict__ rate,
                                     int64_t n, int qmin, int qmax,
                                     uint32_t seed, int faulty_bits,
                                     int mbu_width, bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t row = blockIdx.y;
  const float scale = __fmul_rn(fmaxf(amax[row], FLT_MIN),
                                __frcp_rn(static_cast<float>(qmax)));
  const uint32_t thresh = afp::rate_threshold(rate[row]);
  const float lo = static_cast<float>(qmin), hi = static_cast<float>(qmax);
  const T* xr = x + row * n;
  T* o = out + row * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nvec = vec_ok ? n / VEC : 0;
  for (int64_t v = tid; v < nvec; v += stride) {
    alignas(16) T e[VEC];
    *reinterpret_cast<int4*>(e) = reinterpret_cast<const int4*>(xr)[v];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      e[j] = quant_fault<T, MODEL>(e[j],
                                       static_cast<uint32_t>(v * VEC + j),
                                       scale, lo, hi, seed, thresh, faulty_bits,
                                       mbu_width);
    reinterpret_cast<int4*>(o)[v] = *reinterpret_cast<const int4*>(e);
  }
  for (int64_t i = nvec * VEC + tid; i < n; i += stride)
    o[i] = quant_fault<T, MODEL>(xr[i], static_cast<uint32_t>(i), scale, lo,
                                 hi, seed, thresh, faulty_bits, mbu_width);
}

template <typename T>
int launch(const void* x, void* out, float* amax, const float* rate,
           int64_t n, int64_t rows, int model, int qmin, int qmax,
           uint32_t seed, int faulty_bits, int mbu_width, cudaStream_t s) {
  const bool vec_ok = (n * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int threads = 256;
  const int64_t work = vec_ok ? n / (16 / sizeof(T)) : n;
  const int64_t blocks = (work + threads - 1) / threads;
  const dim3 grid(static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16),
                  static_cast<unsigned>(rows));
  const T* xt = static_cast<const T*>(x);
  amax_kernel<T><<<grid, threads, 0, s>>>(xt, amax, n, vec_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  AFP_DISPATCH_MODEL(model,
      quant_bitflip_kernel<T, MODEL><<<grid, threads, 0, s>>>(
          xt, static_cast<T*>(out), amax, rate, n, qmin, qmax, seed,
          faulty_bits, mbu_width, vec_ok));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: rows x n of float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// amax: rows float32, zeroed by the caller; rate: rows float32.
extern "C" int afp_quant_bitflip(const void* x, void* out, float* amax,
                                 const float* rate, int64_t n, int64_t rows,
                                 int is_bf16, int model, int qmin, int qmax,
                                 uint32_t seed, int faulty_bits, int mbu_width,
                                 void* stream) {
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaSuccess);
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, out, amax, rate, n, rows, model, qmin,
                                 qmax, seed, faulty_bits, mbu_width, s);
  return launch<float>(x, out, amax, rate, n, rows, model, qmin, qmax, seed,
                       faulty_bits, mbu_width, s);
}

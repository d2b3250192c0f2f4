// Replaces the TPU kernel repro/kernels/bitflip.py:57 bitflip_pallas
// (body _bitflip_kernel, :39-50): corrupt the faulty_bits LSBs of an
// integer tensor, indexed by its C-order flat position.
//
// Port shape: the shared tensor q (n elements, e.g. one resident int8 conv
// weight) is read once per row and written to out[R, n], one row per
// candidate of the population, each at its own rate.  q is never written.
// With a scale (one float32 on the device), out is float32 or bf16 and
// holds __fmul_rn(float(q'), scale), rounded once to bf16 for a bf16 leaf:
// the dequantization the main path would otherwise run as two or three
// more passes (a cast, a multiply, a cast to the leaf's dtype), bitwise
// the same, with no float32 copy of a bf16 leaf.  Without a scale, out has
// q's type, the TPU kernel's contract.
//
// Bound on the H100: the integer pipe.  One read and one write per
// element (2 B for int8, 3-5 B with the fused dequant) are far below the
// hash's ~20 integer operations per bit plane.  So a draw must cost
// integer operations only: the rate enters as faultmodel.cuh's integer
// threshold, computed once per row, and each plane is one integer compare
// (no int-to-float conversion, which runs on a pipe a quarter as wide).
// The random bits stay in registers; four elements per thread per step
// (one 4-16 byte load); a grid-stride loop fills the card at any n.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "faultmodel.cuh"

namespace {

// A vector of four T, loaded and stored as one access.
template <int BYTES> struct Vec4;
template <> struct Vec4<4> { using type = int; };
template <> struct Vec4<8> { using type = int2; };
template <> struct Vec4<16> { using type = int4; };

// OUT is T (integers out), or float or __nv_bfloat16 (dequantized by
// *scale in float32, then rounded to nearest even once for bf16).
template <typename T, typename OUT, int MODEL>
__global__ void bitflip_kernel(const T* __restrict__ q, OUT* __restrict__ out,
                               const float* __restrict__ rate,
                               const float* __restrict__ scale_p, int64_t n,
                               uint32_t seed, int faulty_bits, int mbu_width,
                               bool vec_ok) {
  constexpr int VEC = 4;
  using V = typename Vec4<VEC * sizeof(T)>::type;
  using VO = typename Vec4<VEC * sizeof(OUT)>::type;
  const int64_t row = blockIdx.y;
  const uint32_t thresh = afp::rate_threshold(rate[row]);
  float scale = 0.0f;
  if constexpr (!std::is_integral<OUT>::value) scale = *scale_p;
  auto emit = [&](T v) -> OUT {
    if constexpr (std::is_integral<OUT>::value) {
      return v;
    } else if constexpr (std::is_same<OUT, float>::value) {
      return __fmul_rn(static_cast<float>(v), scale);
    } else {
      return __float2bfloat16_rn(__fmul_rn(static_cast<float>(v), scale));
    }
  };
  OUT* o = out + row * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nvec = vec_ok ? n / VEC : 0;
  for (int64_t v = tid; v < nvec; v += stride) {
    alignas(16) T e[VEC];
    alignas(16) OUT r[VEC];
    *reinterpret_cast<V*>(e) = reinterpret_cast<const V*>(q)[v];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      r[j] = emit(afp::apply_fault<MODEL>(
          e[j], static_cast<uint32_t>(v * VEC + j), seed, thresh,
          faulty_bits, mbu_width));
    reinterpret_cast<VO*>(o)[v] = *reinterpret_cast<const VO*>(r);
  }
  for (int64_t i = nvec * VEC + tid; i < n; i += stride)
    o[i] = emit(afp::apply_fault<MODEL>(q[i], static_cast<uint32_t>(i), seed,
                                        thresh, faulty_bits, mbu_width));
}

}  // namespace

// q: n integers of `qbytes` bytes each; rate: rows float32; scale: null,
// or one float32.  out: rows x n of q's type without a scale; with one, of
// float32 (out_bf16 0) or bf16 (out_bf16 1).  Returns the cudaError_t of
// the launch.
extern "C" int afp_bitflip(const void* q, void* out, const float* rate,
                           const float* scale, int64_t n, int64_t rows,
                           int qbytes, int model, uint32_t seed,
                           int faulty_bits, int mbu_width, int out_bf16,
                           void* stream) {
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaSuccess);
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int obytes = scale ? (out_bf16 ? 2 : 4) : qbytes;
  const bool vec_ok = n % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(q) % (4 * qbytes) == 0 &&
                      reinterpret_cast<uintptr_t>(out) % (4 * obytes) == 0;
  const int threads = 256;
  const int64_t work = vec_ok ? n / 4 : n;
  const int64_t blocks = (work + threads - 1) / threads;
  const dim3 grid(static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16),
                  static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scale && out_bf16) {
    AFP_DISPATCH_INT(qbytes, AFP_DISPATCH_MODEL(model,
        bitflip_kernel<QT, __nv_bfloat16, MODEL><<<grid, threads, 0, s>>>(
            static_cast<const QT*>(q), static_cast<__nv_bfloat16*>(out), rate,
            scale, n, seed, faulty_bits, mbu_width, vec_ok)));
  } else if (scale) {
    AFP_DISPATCH_INT(qbytes, AFP_DISPATCH_MODEL(model,
        bitflip_kernel<QT, float, MODEL><<<grid, threads, 0, s>>>(
            static_cast<const QT*>(q), static_cast<float*>(out), rate, scale,
            n, seed, faulty_bits, mbu_width, vec_ok)));
  } else {
    AFP_DISPATCH_INT(qbytes, AFP_DISPATCH_MODEL(model,
        bitflip_kernel<QT, QT, MODEL><<<grid, threads, 0, s>>>(
            static_cast<const QT*>(q), static_cast<QT*>(out), rate, scale, n,
            seed, faulty_bits, mbu_width, vec_ok)));
  }
  return static_cast<int>(cudaGetLastError());
}

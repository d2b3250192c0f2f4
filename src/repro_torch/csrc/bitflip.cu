// Replaces the TPU kernel repro/kernels/bitflip.py:57 bitflip_pallas
// (body _bitflip_kernel, :39-50): corrupt the faulty_bits LSBs of an
// integer tensor, indexed by its C-order flat position.
//
// Port shape: the shared tensor q (n elements, e.g. one resident int8 conv
// weight) is read once per row and written to out[R, n], one row per
// candidate of the population, each at its own rate.  q is never written.
//
// Bound on the H100: one read and one write per element (2 B/element for
// int8), but the hash costs ~20 integer operations per bit plane, so at
// 4 planes the integer pipe, not memory, is the floor.  The design keeps
// the random bits in registers (nothing but q and out touches memory),
// moves 16 bytes per thread per access, and walks the row with a
// grid-stride loop so any n fills the card.  Four elements per thread per
// step (4-16 bytes): sixteen int8 per thread left half the card's thread
// slots empty at ResNet18's 2.4 M-element leaves.
#include <cuda_runtime.h>

#include "faultmodel.cuh"

namespace {

// A vector of four T, loaded and stored as one access.
template <int BYTES> struct Vec4;
template <> struct Vec4<4> { using type = int; };
template <> struct Vec4<8> { using type = int2; };
template <> struct Vec4<16> { using type = int4; };

template <typename T, int MODEL>
__global__ void bitflip_kernel(const T* __restrict__ q, T* __restrict__ out,
                               const float* __restrict__ rate, int64_t n,
                               uint32_t seed, int faulty_bits, int mbu_width,
                               bool vec_ok) {
  constexpr int VEC = 4;
  using V = typename Vec4<VEC * sizeof(T)>::type;
  const int64_t row = blockIdx.y;
  const float r = rate[row];
  T* o = out + row * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nvec = vec_ok ? n / VEC : 0;
  for (int64_t v = tid; v < nvec; v += stride) {
    alignas(16) T e[VEC];
    *reinterpret_cast<V*>(e) = reinterpret_cast<const V*>(q)[v];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      e[j] = afp::apply_fault<MODEL>(
          e[j], static_cast<uint32_t>(v * VEC + j), seed, r, faulty_bits,
          mbu_width);
    reinterpret_cast<V*>(o)[v] = *reinterpret_cast<const V*>(e);
  }
  for (int64_t i = nvec * VEC + tid; i < n; i += stride)
    o[i] = afp::apply_fault<MODEL>(q[i], static_cast<uint32_t>(i), seed, r,
                                   faulty_bits, mbu_width);
}

}  // namespace

// q: n integers of `qbytes` bytes each; out: rows x n of the same type;
// rate: rows float32.  Returns the cudaError_t of the launch.
extern "C" int afp_bitflip(const void* q, void* out, const float* rate,
                           int64_t n, int64_t rows, int qbytes, int model,
                           uint32_t seed, int faulty_bits, int mbu_width,
                           void* stream) {
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaSuccess);
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int vbytes = 4 * qbytes;
  const bool vec_ok = n % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(q) % vbytes == 0 &&
                      reinterpret_cast<uintptr_t>(out) % vbytes == 0;
  const int threads = 256;
  const int64_t work = vec_ok ? n / 4 : n;
  const int64_t blocks = (work + threads - 1) / threads;
  const dim3 grid(static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16),
                  static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AFP_DISPATCH_INT(qbytes, AFP_DISPATCH_MODEL(model,
      bitflip_kernel<QT, MODEL><<<grid, threads, 0, s>>>(
          static_cast<const QT*>(q), static_cast<QT*>(out), rate, n, seed,
          faulty_bits, mbu_width, vec_ok)));
  return static_cast<int>(cudaGetLastError());
}

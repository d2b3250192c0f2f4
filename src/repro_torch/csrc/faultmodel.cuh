// Fault-model hash shared by the three fault kernels: the device-side
// counterpart of repro/kernels/faultmodel.py (apply_fault, fault_mask,
// uniform01, lowbias32) and of repro_torch/kernels/faultmodel.py, which
// is its plain PyTorch oracle.  It is not a kernel of its own: each
// kernel inlines it, so the random bits never travel through memory.
//
// Exactness rules that keep every kernel bitwise equal to the oracle:
//   * all hash arithmetic is uint32 with wraparound;
//   * (u >> 8) < 2^24 converts to float exactly, and * 2^-24 is exact;
//   * the rate compare is float32 against float32;
//   * the MBU start is min(int(float32(u_pos * span)), span - 1).
#pragma once
#include <cstdint>

namespace afp {

constexpr uint32_t kM1 = 0x7FEB352Du;
constexpr uint32_t kM2 = 0x846CA68Bu;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kMbuEventPlane = 101u;
constexpr uint32_t kMbuPosPlane = 102u;

// The order of repro_torch.kernels.ops.MODEL_IDS.
enum FaultModel : int { kFlip = 0, kStuck0 = 1, kStuck1 = 2, kMbu = 3 };

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform01(uint32_t idx, uint32_t seed,
                                           uint32_t plane) {
  const uint32_t h = lowbias32(idx + plane * kGolden);
  const uint32_t u = lowbias32(h ^ seed);
  return static_cast<float>(u >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// int32 mask of the bits a fault touches at flat index idx.
template <int MODEL>
__device__ __forceinline__ int32_t fault_mask(uint32_t idx, uint32_t seed,
                                              float rate, int faulty_bits,
                                              int mbu_width) {
  if (MODEL == kMbu) {
    const int width = max(1, min(mbu_width, faulty_bits));
    const int span = faulty_bits - width + 1;
    const float u_ev = uniform01(idx, seed, kMbuEventPlane);
    const float u_pos = uniform01(idx, seed, kMbuPosPlane);
    const float pos = __fmul_rn(u_pos, static_cast<float>(span));
    const int start = min(static_cast<int>(pos), span - 1);
    const uint32_t window = faulty_bits >= 32 ? 0xFFFFFFFFu
                                              : ((1u << faulty_bits) - 1u);
    const uint32_t burst = (((1u << width) - 1u) << start) & window;
    return u_ev < rate ? static_cast<int32_t>(burst) : 0;
  }
  uint32_t mask = 0;
  for (int i = 0; i < faulty_bits; ++i)
    if (uniform01(idx, seed, static_cast<uint32_t>(i)) < rate) mask |= 1u << i;
  return static_cast<int32_t>(mask);
}

// Corrupt one stored integer; T is the storage type (int8/int16/int32),
// and the mask is narrowed to it first, as q ^ mask.astype(q.dtype).
template <int MODEL, typename T>
__device__ __forceinline__ T apply_fault(T q, uint32_t idx, uint32_t seed,
                                         float rate, int faulty_bits,
                                         int mbu_width) {
  if (faulty_bits <= 0) return q;
  const T m = static_cast<T>(
      fault_mask<MODEL>(idx, seed, rate, faulty_bits, mbu_width));
  if (MODEL == kStuck0) return static_cast<T>(q & ~m);
  if (MODEL == kStuck1) return static_cast<T>(q | m);
  return static_cast<T>(q ^ m);
}

}  // namespace afp

// Expand BODY once per fault model with the compile-time constant MODEL.
#define AFP_DISPATCH_MODEL(model, ...)                                   \
  switch (model) {                                                       \
    case afp::kFlip: { constexpr int MODEL = afp::kFlip; __VA_ARGS__; break; }       \
    case afp::kStuck0: { constexpr int MODEL = afp::kStuck0; __VA_ARGS__; break; }   \
    case afp::kStuck1: { constexpr int MODEL = afp::kStuck1; __VA_ARGS__; break; }   \
    case afp::kMbu: { constexpr int MODEL = afp::kMbu; __VA_ARGS__; break; }         \
    default: return static_cast<int>(cudaErrorInvalidValue);            \
  }

// Expand BODY once per integer storage width with the type QT.
#define AFP_DISPATCH_INT(bytes, ...)                                     \
  switch (bytes) {                                                       \
    case 1: { using QT = int8_t; __VA_ARGS__; break; }                   \
    case 2: { using QT = int16_t; __VA_ARGS__; break; }                  \
    case 4: { using QT = int32_t; __VA_ARGS__; break; }                  \
    default: return static_cast<int>(cudaErrorInvalidValue);            \
  }

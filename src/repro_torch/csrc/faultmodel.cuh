// Fault-model hash shared by the three fault kernels: the device-side
// counterpart of repro/kernels/faultmodel.py (apply_fault, fault_mask,
// uniform01, lowbias32) and of repro_torch/kernels/faultmodel.py, which
// is its plain PyTorch oracle.  It is not a kernel of its own: each
// kernel inlines it, so the random bits never travel through memory.
//
// Exactness rules that keep every kernel bitwise equal to the oracle:
//   * all hash arithmetic is uint32 with wraparound;
//   * the oracle's draw is float(u >> 8) * 2^-24 < rate.  Both sides of
//     that compare scale exactly by 2^24, so it is the integer compare
//     (u >> 8) < T with T = rate > 0 ? min(ceil(rate * 2^24), 2^24) : 0
//     (rate_threshold; NaN and rates <= 0 give 0, so no plane fires).
//     A kernel computes T once per row, and a draw costs no int-to-float
//     conversion: the hash runs on the integer pipe alone;
//   * the MBU start keeps the float arithmetic of the oracle:
//     min(int(float32(float(u_pos >> 8) * 2^-24 * span)), span - 1).
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

// The draw's 24 random bits for (idx, seed, plane).
__device__ __forceinline__ uint32_t draw24(uint32_t idx, uint32_t seed,
                                          uint32_t plane) {
  const uint32_t h = lowbias32(idx + plane * kGolden);
  return lowbias32(h ^ seed) >> 8;
}

// The row's integer threshold: draw24(...) < T exactly when the oracle's
// float(draw24) * 2^-24 < rate.  rate * 2^24 and ceilf are exact.
__device__ __forceinline__ uint32_t rate_threshold(float rate) {
  if (!(rate > 0.0f)) return 0u;
  const float t = ceilf(__fmul_rn(rate, 16777216.0f));
  return t >= 16777216.0f ? 16777216u : static_cast<uint32_t>(t);
}

// A draw in fewer integer operations, the same bits (quant_bitflip):
//   * hash32(idx, plane, fold_seed(seed)) is the hash draw24 shifts,
//     lowbias32(lowbias32(idx + plane * kGolden) ^ seed).  The inner
//     hash's last xorshift and the outer one's first cancel but for the
//     seed's: with h = v ^ (v >> 16), (h ^ seed) ^ ((h ^ seed) >> 16) =
//     v ^ seed ^ (seed >> 16), as (h >> 16) = (v >> 16).  Three
//     operations fewer a draw;
//   * the compare is on the whole hash: for 1 <= T <= 2^24, (h >> 8) < T
//     exactly when h <= (T << 8) - 1 (draw_limit), and at T = 2^24 the
//     shift wraps so the limit is 2^32 - 1 (every draw fires).  T = 0 has
//     no limit: a kernel skips the draws of such a row.
__device__ __forceinline__ uint32_t fold_seed(uint32_t seed) {
  return seed ^ (seed >> 16);
}
__device__ __forceinline__ uint32_t hash32(uint32_t idx, uint32_t plane,
                                           uint32_t folded_seed) {
  uint32_t x = idx + plane * kGolden;
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  x ^= folded_seed;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  return x ^ (x >> 16);
}
__device__ __forceinline__ uint32_t draw_limit(uint32_t thresh) {
  return (thresh << 8) - 1u;
}
__device__ __forceinline__ bool fires(uint32_t idx, uint32_t folded_seed,
                                      uint32_t plane, uint32_t limit) {
  return hash32(idx, plane, folded_seed) <= limit;
}

// int32 mask of the bits a fault touches at flat index idx, for a row
// whose threshold is thresh = rate_threshold(rate).
template <int MODEL>
__device__ __forceinline__ int32_t fault_mask(uint32_t idx, uint32_t seed,
                                              uint32_t thresh, int faulty_bits,
                                              int mbu_width) {
  if (MODEL == kMbu) {
    const int width = max(1, min(mbu_width, faulty_bits));
    const int span = faulty_bits - width + 1;
    const float u_pos = __fmul_rn(
        static_cast<float>(draw24(idx, seed, kMbuPosPlane)),
        5.9604644775390625e-08f);  // 2^-24
    const float pos = __fmul_rn(u_pos, static_cast<float>(span));
    const int start = min(static_cast<int>(pos), span - 1);
    const uint32_t window = faulty_bits >= 32 ? 0xFFFFFFFFu
                                              : ((1u << faulty_bits) - 1u);
    const uint32_t burst = (((1u << width) - 1u) << start) & window;
    return draw24(idx, seed, kMbuEventPlane) < thresh
               ? static_cast<int32_t>(burst) : 0;
  }
  uint32_t mask = 0;
  for (int i = 0; i < faulty_bits; ++i)
    if (draw24(idx, seed, static_cast<uint32_t>(i)) < thresh) mask |= 1u << i;
  return static_cast<int32_t>(mask);
}

// Apply an int32 mask to one stored integer; T is the storage type
// (int8/int16/int32), and the mask is narrowed to it first, as
// q ^ mask.astype(q.dtype).
template <int MODEL, typename T>
__device__ __forceinline__ T apply_mask(T q, int32_t mask) {
  const T m = static_cast<T>(mask);
  if (MODEL == kStuck0) return static_cast<T>(q & ~m);
  if (MODEL == kStuck1) return static_cast<T>(q | m);
  return static_cast<T>(q ^ m);
}

// Corrupt one stored integer of a row whose threshold is thresh.
template <int MODEL, typename T>
__device__ __forceinline__ T apply_fault(T q, uint32_t idx, uint32_t seed,
                                         uint32_t thresh, int faulty_bits,
                                         int mbu_width) {
  if (faulty_bits <= 0) return q;
  return apply_mask<MODEL>(
      q, fault_mask<MODEL>(idx, seed, thresh, faulty_bits, mbu_width));
}

// The hash split from the rows.  The draws of one flat index depend on
// (idx, seed, plane) and the window only, never on a row's rate, so a
// kernel that corrupts one weight for many rows computes them once with
// weight_draws and builds each row's mask from them with row_mask:
// row_mask<M>(d, T, b) == fault_mask<M>(idx, seed, T, b, w) bitwise for
// every threshold T.  d holds plane i's draw24 at d[i] for i < faulty_bits
// (flip, stuck-0, stuck-1), or the MBU event plane's draw at d[0] and the
// burst it would set at d[1].  The loops run over compile-time indices
// and stop at faulty_bits, so d stays in registers.
constexpr int kMaxPlanes = 32;

template <int MODEL>
__device__ __forceinline__ void weight_draws(uint32_t idx, uint32_t seed,
                                             int faulty_bits, int mbu_width,
                                             uint32_t (&d)[kMaxPlanes]) {
  if (MODEL == kMbu) {
    if (faulty_bits <= 0) return;
    const int width = max(1, min(mbu_width, faulty_bits));
    const int span = faulty_bits - width + 1;
    const float u_pos = __fmul_rn(
        static_cast<float>(draw24(idx, seed, kMbuPosPlane)),
        5.9604644775390625e-08f);  // 2^-24
    const float pos = __fmul_rn(u_pos, static_cast<float>(span));
    const int start = min(static_cast<int>(pos), span - 1);
    const uint32_t window = faulty_bits >= 32 ? 0xFFFFFFFFu
                                              : ((1u << faulty_bits) - 1u);
    d[0] = draw24(idx, seed, kMbuEventPlane);
    d[1] = (((1u << width) - 1u) << start) & window;
    return;
  }
#pragma unroll
  for (int i = 0; i < kMaxPlanes; ++i) {
    if (i >= faulty_bits) break;
    d[i] = draw24(idx, seed, static_cast<uint32_t>(i));
  }
}

template <int MODEL>
__device__ __forceinline__ int32_t row_mask(const uint32_t (&d)[kMaxPlanes],
                                            uint32_t thresh,
                                            int faulty_bits) {
  if (faulty_bits <= 0) return 0;
  if (MODEL == kMbu) return d[0] < thresh ? static_cast<int32_t>(d[1]) : 0;
  uint32_t mask = 0;
#pragma unroll
  for (int i = 0; i < kMaxPlanes; ++i) {
    if (i >= faulty_bits) break;
    if (d[i] < thresh) mask |= 1u << i;
  }
  return static_cast<int32_t>(mask);
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

// Replaces the TPU kernel repro/kernels/quant_bitflip.py:50
// quant_bitflip_pallas (body _quant_bitflip_kernel, :27-43): quantize a
// float tensor with a symmetric per-tensor scale, corrupt the LSBs of the
// integers, dequantize back to the input dtype.
//
// Port shape: one launch pair corrupts a GROUP of up to kMaxEntries
// tensors (a decode layer's weight leaves and its input, or one tensor).
// Entry e is x_e viewed as rows_e x n_e, one candidate a row, each row
// with its own amax, scale and rate (the reference computes the scale per
// tensor under vmap); x's rows may be strided, stride 0 for a leaf
// broadcast over the rows, while out is always contiguous.  The group
// shares qmin / qmax, faulty_bits, the fault model and mbu_width.  The
// table travels by value as a __grid_constant__ kernel parameter: no
// device copy of it, no host wait.
//
// Both passes run one flat grid of blocks over every (entry, row, chunk);
// entry e's blocks start at first_block_e, the prefix sum the host puts in
// the table, and a block finds its entry by walking the table.
//   1. amax_kernel: each block writes its chunk's max|x| to its own slot
//      of `partials` with a plain store.  Every slot is written exactly
//      once, so the workspace needs no fill and no atomics.
//   2. quant_bitflip_kernel: each block first takes the max of its row's
//      partials (at most kMaxChunks, 2048, of them: the host's chunking
//      keeps a row's blocks below that), then scale = max(amax, FLT_MIN)
//      * fl32(1 / qmax) (the reference's jitted amax / qmax, which XLA
//      rewrites into a multiply by the constant's float32 reciprocal),
//      the integer rint(x / scale) clipped to [qmin, qmax], the fault
//      mask, q * scale in x's dtype.  A max is exact in any order, so both
//      passes are bitwise the plain version's, whatever the chunking.
//
// Exactness: built without --use_fast_math, so the IEEE quotient x /
// scale decides every element (quant_fault says how, most of them
// without dividing), subnormals are kept (an all-zero row has the
// subnormal scale FLT_MIN / qmax, which flush-to-zero would turn into
// 0 / 0), and rounding is half to even like jnp.round / torch.round.
//
// Bound on the H100: the hash on the integer pipe.  A bf16 element moves
// 6 bytes (read twice, written once) against 15 integer operations for
// each of its faulty_bits draws, so the bytes are a sixth of the time at
// 4 draws.  What the design does about it:
//   * the draw is faultmodel.cuh's hash32 (the xorshift pair between the
//     two lowbias32 rounds folded into one xor with the row's folded seed)
//     compared whole with the row's draw_limit: 15 operations, not 20;
//   * the pass-2 kernel is instantiated for 4, 6 and 8 faulty bits (the
//     paths' counts; others take a generic loop), so each plane's
//     constant folds and the loop unrolls, and a thread computes the
//     masks of 8 elements (one 16-byte load of bf16, two of float32)
//     before any branch: 32 independent hash chains at 4 planes;
//   * rint, the float-to-int and int-to-float conversions go through
//     kMagic (below), and x / scale is x times the row's reciprocal with
//     the IEEE quotient only near a rounding boundary: no conversion or
//     division on the card's quarter-width pipe for almost all elements;
//   * a row whose threshold is 0 skips the draws: its mask is 0, which
//     leaves q as it is under all four models.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>

#include "faultmodel.cuh"

namespace qbf {

constexpr int kMaxEntries = 32;    // ops._QB_MAX_ENTRIES
constexpr int kMaxChunks = 2048;   // blocks a row, at most (ops._qb_chunk)
constexpr int kThreads = 256;
constexpr int kElems = 8;          // elements a thread works on at once

// One tensor of the group; the layout of ops._QB_ENTRY.
struct Entry {
  const void* x;
  void* out;
  const float* rate;     // [rows] float32 on the device
  int64_t n;             // elements a row
  int64_t row_stride;    // x's row stride in elements (0: broadcast)
  int64_t first_block;   // the entry's first block of the flat grid
  int32_t rows;
  int32_t chunk;         // elements a block, a multiple of kElems
  int32_t chunks;        // blocks a row: ceil(n / chunk)
  uint32_t seed;
  int32_t is_bf16;
  int32_t vec_ok;        // 16-byte accesses (set by the entry point)
};
static_assert(sizeof(Entry) == 72, "Entry must match ops._QB_ENTRY");

struct Params {
  Entry e[kMaxEntries];
  float* partials;       // one float a block
  int count, qmin, qmax, faulty_bits, mbu_width;
};

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

// The entry whose blocks hold block b (uniform across the block).
__device__ __forceinline__ int find_entry(const Params& p, int64_t b) {
  int e = 0;
  while (e + 1 < p.count && b >= p.e[e + 1].first_block) ++e;
  return e;
}

// The block's max of m; every thread gets it.
__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_max[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
  return m;
}

// max|x| over elements [lo, hi) of one row.
template <typename T>
__device__ __forceinline__ float chunk_amax(const T* __restrict__ xr,
                                            int64_t lo, int64_t hi,
                                            bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = 4;                 // 16-byte loads in flight a thread
  float m = 0.0f;
  int64_t tail = lo;
  if (vec) {
    const int4* v = reinterpret_cast<const int4*>(xr);
    const int64_t v_lo = lo / VEC, v_hi = hi / VEC;
    for (int64_t i = v_lo + threadIdx.x; i < v_hi; i += kThreads * U) {
      int4 buf[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t j = i + u * kThreads;
        buf[u] = j < v_hi ? __ldg(v + j) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const T* e = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) m = fmaxf(m, fabsf(to_f32(e[k])));
      }
    }
    tail = v_hi * VEC;
  }
  for (int64_t i = tail + threadIdx.x; i < hi; i += kThreads)
    m = fmaxf(m, fabsf(to_f32(xr[i])));
  return m;
}

__global__ void __launch_bounds__(kThreads)
    amax_kernel(const __grid_constant__ Params p) {
  const int64_t b = blockIdx.x;
  const Entry& en = p.e[find_entry(p, b)];
  const int64_t local = b - en.first_block;
  const int64_t row = local / en.chunks;
  const int64_t lo = (local - row * en.chunks) * en.chunk;
  const int64_t hi = min(lo + en.chunk, en.n);
  float m;
  if (en.is_bf16)
    m = chunk_amax(static_cast<const __nv_bfloat16*>(en.x) +
                       row * en.row_stride, lo, hi, en.vec_ok);
  else
    m = chunk_amax(static_cast<const float*>(en.x) + row * en.row_stride,
                   lo, hi, en.vec_ok);
  m = block_max(m);
  if (threadIdx.x == 0) p.partials[b] = m;
}

// The fault mask at flat index idx of a row whose draw limit is limit
// (faultmodel.cuh's fault_mask by hash32 and its compare on the whole
// hash; s is the row's fold_seed); FB is faulty_bits where it is a
// compile-time constant, else 0 and fb holds it.
template <int MODEL, int FB>
__device__ __forceinline__ uint32_t fault_mask(uint32_t idx, uint32_t s,
                                               uint32_t limit, int fb,
                                               int mbu_width) {
  if (MODEL == afp::kMbu) {
    const int width = max(1, min(mbu_width, fb));
    const int span = fb - width + 1;
    const float u_pos = __fmul_rn(
        static_cast<float>(afp::hash32(idx, afp::kMbuPosPlane, s) >> 8),
        5.9604644775390625e-08f);  // 2^-24
    const float pos = __fmul_rn(u_pos, static_cast<float>(span));
    const int start = min(static_cast<int>(pos), span - 1);
    const uint32_t window = (1u << fb) - 1u;   // fb <= 31
    const uint32_t burst = (((1u << width) - 1u) << start) & window;
    return afp::fires(idx, s, afp::kMbuEventPlane, limit) ? burst : 0u;
  }
  uint32_t mask = 0;
  const int planes = FB > 0 ? FB : fb;
#pragma unroll
  for (int i = 0; i < planes; ++i)
    if (afp::fires(idx, s, i, limit)) mask |= 1u << i;
  return mask;
}

// 1.5 * 2^23.  For |t| < 2^22, RN(t + kMagic) is kMagic + rint(t): the
// floats of [2^23, 2^24) are the integers, and kMagic is even, so ties go
// to even as rintf's do.  Its bits are 0x4B400000 + rint(t), the integer
// in two's complement in the low 22 bits, so a mask below 2^21 sets,
// clears or flips the integer's bits on the float's own bits, and the
// float minus kMagic is float(q') exactly: no float-to-int or int-to-float
// conversion (the card's conversion pipe is a quarter as wide).
constexpr float kMagic = 12582912.0f;

struct Row {
  float scale, rcp;      // rcp = RN(1 / scale)
  float lo, hi;          // qmin, qmax; plus kMagic where MAGIC
  uint32_t seed, limit;   // seed: afp::fold_seed of the entry's
  int fb, mbu_width;
  bool fast;             // rcp normal: x * rcp first (see quant_fault)
};

// N elements of a row in place (their flat indices idx): rint(x / scale)
// clipped to [qmin, qmax], the fault mask applied, times scale in T.  The
// masks of all N come first, with no branch among them, so their N *
// faulty_bits hash chains interleave.  MAGIC (|qmin|, qmax and the mask
// below 2^20) works on kMagic + q.  Its quotient: t0 = RN(x * rcp) is
// within |t0| 2^-22 of the IEEE quotient fl(x / scale) (one rounding in
// rcp, one in the product, one in the quotient, each at most 2^-24
// relative), so where t0 lies farther than |t0| 2^-21 from the nearest
// half-integer, the quotient rounds to t0's integer (strictly inside its
// interval: no tie).  Nearer (under 1% of the elements at 16 bits), on a
// NaN, or on a row whose rcp is not normal (a subnormal scale), the
// element takes the IEEE quotient itself, clipped.  The fast path needs
// no clip: |x| <= amax keeps |fl(x / scale)| below qmax (1 + 2^-22), whose
// integer lies in [-qmax, qmax].
template <typename T, int MODEL, int FB, bool HASH, bool MAGIC, int N>
__device__ __forceinline__ void quant_fault(T (&e)[N],
                                            const uint32_t (&idx)[N],
                                            const Row& r) {
  uint32_t mask[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    mask[k] = HASH ? fault_mask<MODEL, FB>(idx[k], r.seed, r.limit, r.fb,
                                           r.mbu_width)
                   : 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float x = to_f32(e[k]);
    if (!MAGIC) {
      float f = rintf(__fdiv_rn(x, r.scale));
      f = fminf(fmaxf(f, r.lo), r.hi);
      int32_t q = static_cast<int32_t>(f);
      if (HASH) q = afp::apply_mask<MODEL>(q, static_cast<int32_t>(mask[k]));
      e[k] = from_f32<T>(__fmul_rn(static_cast<float>(q), r.scale));
      continue;
    }
    const float t0 = __fmul_rn(x, r.rcp);
    float u = __fadd_rn(t0, kMagic);
    const float d = __fsub_rn(t0, __fsub_rn(u, kMagic));
    if (!r.fast || !(fabsf(d) < __fmaf_rn(-fabsf(t0), 0x1p-21f, 0.5f))) {
      u = __fadd_rn(__fdiv_rn(x, r.scale), kMagic);
      u = fminf(fmaxf(u, r.lo), r.hi);   // beyond 2^22 clips all the same
    }
    uint32_t bits = __float_as_uint(u);
    if (HASH)
      bits = afp::apply_mask<MODEL>(bits, static_cast<int32_t>(mask[k]));
    e[k] = from_f32<T>(
        __fmul_rn(__fsub_rn(__uint_as_float(bits), kMagic), r.scale));
  }
}

// Elements [lo, hi) of one row, kElems at a time a thread.
template <typename T, int MODEL, int FB, bool HASH, bool MAGIC>
__device__ __forceinline__ void flip_chunk(const T* __restrict__ xr,
                                           T* __restrict__ o, int64_t lo,
                                           int64_t hi, bool vec,
                                           const Row& r) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = kElems / VEC;      // 16-byte vectors a step
  int64_t tail = lo;
  if (vec) {
    const int4* xv = reinterpret_cast<const int4*>(xr);
    int4* ov = reinterpret_cast<int4*>(o);
    const int64_t v_lo = lo / VEC, v_hi = hi / VEC;
    for (int64_t i = v_lo + threadIdx.x; i < v_hi; i += kThreads * U) {
      alignas(16) T e[kElems];
      uint32_t idx[kElems];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + u * kThreads < v_hi)
          reinterpret_cast<int4*>(e)[u] = __ldg(xv + i + u * kThreads);
#pragma unroll
      for (int k = 0; k < kElems; ++k)
        idx[k] = static_cast<uint32_t>((i + k / VEC * kThreads) * VEC +
                                       k % VEC);
      quant_fault<T, MODEL, FB, HASH, MAGIC>(e, idx, r);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + u * kThreads < v_hi)
          ov[i + u * kThreads] = reinterpret_cast<const int4*>(e)[u];
    }
    tail = v_hi * VEC;
  }
  for (int64_t i = tail + threadIdx.x; i < hi; i += kThreads) {
    T e[1] = {xr[i]};
    const uint32_t idx[1] = {static_cast<uint32_t>(i)};
    quant_fault<T, MODEL, FB, HASH, MAGIC>(e, idx, r);
    o[i] = e[0];
  }
}

template <typename T, int MODEL, int FB, bool MAGIC>
__device__ __forceinline__ void flip_block(const Entry& en, int64_t row,
                                           int64_t lo, int64_t hi,
                                           const Row& r) {
  const T* xr = static_cast<const T*>(en.x) + row * en.row_stride;
  T* o = static_cast<T*>(en.out) + row * en.n;
  if (r.fb > 0 && r.limit != 0u)      // limit 0: a row at rate 0
    flip_chunk<T, MODEL, FB, true, MAGIC>(xr, o, lo, hi, en.vec_ok, r);
  else
    flip_chunk<T, MODEL, FB, false, MAGIC>(xr, o, lo, hi, en.vec_ok, r);
}

template <int MODEL, int FB, bool MAGIC>
__global__ void __launch_bounds__(kThreads, 4)
    quant_bitflip_kernel(const __grid_constant__ Params p) {
  const int64_t b = blockIdx.x;
  const Entry& en = p.e[find_entry(p, b)];
  const int64_t local = b - en.first_block;
  const int64_t row = local / en.chunks;
  const int64_t lo = (local - row * en.chunks) * en.chunk;
  const int64_t hi = min(lo + en.chunk, en.n);
  const float* part = p.partials + en.first_block + row * en.chunks;
  float m = 0.0f;
  for (int i = threadIdx.x; i < en.chunks; i += kThreads)
    m = fmaxf(m, __ldg(part + i));
  m = block_max(m);
  const uint32_t thresh = afp::rate_threshold(__ldg(en.rate + row));
  Row r;
  r.scale = __fmul_rn(fmaxf(m, FLT_MIN),
                      __frcp_rn(static_cast<float>(p.qmax)));
  r.rcp = __frcp_rn(r.scale);
  r.fast = r.rcp >= 0x1p-125f && r.rcp <= 0x1p125f;
  r.lo = static_cast<float>(p.qmin) + (MAGIC ? kMagic : 0.0f);
  r.hi = static_cast<float>(p.qmax) + (MAGIC ? kMagic : 0.0f);
  r.seed = afp::fold_seed(en.seed);
  r.limit = thresh == 0u ? 0u : afp::draw_limit(thresh);
  r.fb = FB > 0 ? FB : p.faulty_bits;
  r.mbu_width = p.mbu_width;
  if (en.is_bf16)
    flip_block<__nv_bfloat16, MODEL, FB, MAGIC>(en, row, lo, hi, r);
  else
    flip_block<float, MODEL, FB, MAGIC>(en, row, lo, hi, r);
}

}  // namespace qbf

// Expand BODY once per faulty-bit count the paths use, with the
// compile-time constant FB (0: any other count, read at run time).
#define QBF_DISPATCH_FB(fb, ...)                                       \
  switch (fb) {                                                        \
    case 4: { constexpr int FB = 4; __VA_ARGS__; break; }              \
    case 6: { constexpr int FB = 6; __VA_ARGS__; break; }              \
    case 8: { constexpr int FB = 8; __VA_ARGS__; break; }              \
    default: { constexpr int FB = 0; __VA_ARGS__; break; }             \
  }

// entries: `count` qbf::Entry records in host memory (vec_ok ignored),
// their first_block the running sum of rows * chunks from 0, which ends at
// total_blocks; partials: total_blocks float32 on the device, written
// before they are read (no initialisation needed).  Launches the two
// passes on `stream`; returns the cudaError_t of the launches.
extern "C" int afp_quant_bitflip_group(const qbf::Entry* entries, int count,
                                       float* partials, int64_t total_blocks,
                                       int model, int qmin, int qmax,
                                       int faulty_bits, int mbu_width,
                                       void* stream) {
  if (count < 1 || count > qbf::kMaxEntries || total_blocks < 1 ||
      total_blocks > 0x7FFFFFFF || faulty_bits < 0 || faulty_bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  qbf::Params p;
  p.partials = partials;
  p.count = count;
  p.qmin = qmin;
  p.qmax = qmax;
  p.faulty_bits = faulty_bits;
  p.mbu_width = mbu_width;
  int64_t next = 0;
  for (int i = 0; i < count; ++i) {
    qbf::Entry e = entries[i];
    const int64_t es = e.is_bf16 ? 2 : 4;
    if (e.n < 1 || e.rows < 1 || e.chunk < qbf::kElems ||
        e.chunk % qbf::kElems != 0 ||
        e.chunks != (e.n + e.chunk - 1) / e.chunk ||
        e.chunks > qbf::kMaxChunks || e.first_block != next)
      return static_cast<int>(cudaErrorInvalidValue);
    next += static_cast<int64_t>(e.rows) * e.chunks;
    e.vec_ok = reinterpret_cast<uintptr_t>(e.x) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(e.out) % 16 == 0 &&
               (e.rows == 1 || ((e.n * es) % 16 == 0 &&
                                (e.row_stride * es) % 16 == 0));
    p.e[i] = e;
  }
  if (next != total_blocks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(total_blocks);
  qbf::amax_kernel<<<grid, qbf::kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (qmax < (1 << 20) && qmin > -(1 << 20) && faulty_bits <= 20) {
    AFP_DISPATCH_MODEL(model, QBF_DISPATCH_FB(faulty_bits,
        qbf::quant_bitflip_kernel<MODEL, FB, true>
            <<<grid, qbf::kThreads, 0, s>>>(p)));
  } else {
    AFP_DISPATCH_MODEL(model,
        qbf::quant_bitflip_kernel<MODEL, 0, false>
            <<<grid, qbf::kThreads, 0, s>>>(p));
  }
  return static_cast<int>(cudaGetLastError());
}

// Replaces the TPU kernel repro/kernels/fault_matmul.py:61
// fault_matmul_pallas (body _fault_matmul_kernel, :25-54):
// out = x @ (apply_fault(qw) * scale) with fp32 accumulation, the bit
// flips applied to the weights on chip.
//
// Port shape: x is [R, M, K] float32 or bfloat16 (one candidate per row),
// qw is the shared (K, N) integer matrix, each row corrupts it at its own
// rate with idx = k * N + n in the unpadded matrix; out is [R, M, N] in
// x's type.  The K-slice count is chosen per row (ops._k_splits), so a row
// sums in the same order whatever R is.
//
// float32 x with int8 qw (every weight the CNN path stores) runs on the
// tensor cores, still fp32-accurate, because the operands split exactly:
//   * an int8 weight, corrupted or not, is exact in bf16;
//   * a float32 x is exactly b0 + b1 + b2, three bf16 values
//     (b0 = bf16(x), b1 = bf16(x - b0), b2 = bf16(x - b0 - b1));
//   * each product b_i * q' (8 x 8 significant bits) is exact in fp32;
//   * the scale is one per tensor, so it moves to the epilogue.
// So three bf16 wgmma products into one fp32 accumulator give x @ q', and
// __fmul_rn(acc, scale) the output.  With x = I_K every output is one
// exact product: the kernel returns the corrupted, dequantized weights
// bitwise.  Bound on the H100: the hash, about 80 integer operations per
// weight at 4 planes, once per weight, on the integer pipe; the three
// bf16 products need less (3 * 2MKN at 989 TFLOP/s), the bytes far less.
// The design (tc::kernel):
//   * one block covers all M rows (up to 512: four warpgroups of two m64
//     tiles) of its (K-slice, N-tile), so each weight is corrupted once per
//     call (once per 512-row chunk beyond that).  The block corrupts its
//     int8 tile into shared memory as bf16, in the K-major layout wgmma
//     reads B from, with faultmodel.cuh's integer threshold;
//   * x arrives through a three-stage cp.async ring in shared memory; each
//     thread splits its A fragment in registers and issues the three
//     products (wgmma m64nNk16, A from registers, B from shared memory);
//   * the next B tile is corrupted while the products run;
//   * the N tile follows N: 16 for a narrow head (ResNet18's fc), else 64;
//   * split-K: each K-slice is one block writing a partial tile; a second
//     kernel sums the slices in slice order (deterministic, no atomics).
// What holds it back (PERF.md §6): per k-step the split, the issue of
// loads and products, and the hash run one after the other.  Rows of a
// [R] call each hash again (each row is its own block).
//
// bf16 x (the transformer path: every LM config runs in bf16) computes the
// reference's CPU function (repro/kernels/ops.py:74-79) for a bf16 weight
// dtype: w = bf16(fp32(q') * scale), out = bf16(x @ w) with the sum in
// fp32.  (The TPU tile keeps w in fp32 and never rounds it; the reference's
// tests check the CPU path, and so does the port.)  Both operands are
// exact bf16, so it is ONE wgmma per k-step and m64 tile.  At olmo-1b's
// shapes (M = B S = 2048, K and N 2048 or 8192) the hash of K N weights at
// ~20 integer operations a draw and plane is the bound, not the 2 M K N
// product: 0.030 ms against 0.017 ms at 2048^3 (16.7 Tops/s integer, 989
// TFLOP/s bf16).  So the route runs two kernels, each at its own limit:
//   1. the hash pass (bfp::hash_kernel, integer pipe, full occupancy):
//      each weight's draws are computed ONCE per call, one draw24 per
//      (weight, plane) (faultmodel.cuh weight_draws), and every row of
//      the call builds its mask from them with its own threshold
//      (row_mask), dequantizes, rounds to bf16 and writes W'[row].  Its
//      bound is K N planes draws plus G K N 2 bytes written.  W' is laid
//      out as 16 x 128 tiles, each tile 4 KB contiguous and already in the
//      no-swizzle K-major core-matrix image wgmma reads B from (b_offset,
//      b_desc), the tiles of one 128-column panel in k order, so a TMA box
//      copies a stage's tiles whole, and a warp of the hash pass writes
//      128 contiguous bytes;
//   2. the product (bfp::product_kernel, tensor cores), bound by its 2 M
//      K N operations (0.0174 ms at 2048^3) but at 128 x 256 blocks reading
//      x and W' from L2 at 85 flops a byte, which asks ~11.6 TB/s of L2 at
//      the tensor cores' peak.  It is warp-specialised: a producer warp
//      keeps a four-stage ring of 48 KB stages full by TMA (x through a
//      128B-swizzled tensor map, W' through a 5-D one that lays two
//      panels side by side), full/empty mbarriers hand the stages over,
//      and two consumer warpgroups issue wgmma m64n256k16 with A and B
//      from shared memory, one group in flight while the next is issued,
//      into fp32 accumulators in k order, rounded once to bf16 (after the
//      split-K slices are summed in order).  The tile leaves through
//      shared memory in whole rows.
// The workspace: W' is 2 K N bytes a row (K, N rounded up to 16, 128):
// 8 MiB at 2048 x 2048, 32 MiB at 2048 x 8192.  ops.fault_matmul walks R
// in groups whose W' fits 256 MiB (32 and 8 rows there), one hash launch
// and one product launch a group, so the draws are shared by up to G rows
// and a call hashes each weight ceil(R / G) times, once for R <= G.
// What still holds the route back: the two passes run one after the other
// (no overlap of the integer and tensor pipes), W' makes a round trip
// through L2 or HBM (2 bytes a weight and row each way), and in the
// product each operand tile is read from L2 by every block that uses it
// (no cluster multicast), the output tile's write (~3 us at 2048^3)
// overlaps no other tile's work (one tile a block, not persistent), and a
// split-K call writes and re-reads fp32 partial sums (PERF.md §7).
//
// int16 and int32 qw with float32 x keep the SIMT body below: their values
// are not exact in bf16, and x is not split for them.  The CNN path never
// stores them; this is dispatch by operand types, and nothing catches a
// failure of the tensor-core path.  That body is a 128x128x8
// shared-memory SGEMM that corrupts and dequantizes each weight tile in
// shared memory (once per 128-row block of x), with fp32 FMAs and the
// same split-K.
//
// float32 x with a bf16 weight dtype (the encoder-decoder: its float32
// encoder input meets the bf16 weights in every encoder projection and in
// the decoder's cross-attention K/V) computes the reference's CPU function
// for that pair: w = bf16(fp32(q') * scale), out = x @ float(w) in fp32,
// float32 out.  w is exactly the bf16 route's W', and x splits exactly
// into three bf16 parts (as above; each part times a bf16 w is exact in
// fp32), so three bf16 wgmma products into one fp32 accumulator give x @
// float(w) with only the order of the sums changed.  The route runs two
// kernels a row group, as the bf16 route does: the hash pass
// (bfp::hash_kernel, unchanged) writes every row's W', then the product
// fwp::product_kernel.  At the encoder's M = B Se = 256 the hash pass is
// the bound (K N planes draws, 0.0075 ms at 1024^2), not the product's 3
// x 2 M K N tensor-core operations (0.0016 ms) or its bytes.  The
// product splits x in registers (no pre-pass writing x as three bf16
// planes: one launch fewer a call on a host-bound path, x read once, each
// W' stage read once for all three products):
//   * a producer warp fills a four-stage mbarrier ring, each stage 64 of
//     K: x's [128, 64] float32 box as two TMA copies of [128, 32] (a
//     3-D tensor map over [R, M, K], 128B swizzle, zeros past M and K),
//     and the stage's W' tiles of one 128-column panel, contiguous in the
//     workspace, as one bulk copy (only the tiles before the slice's end,
//     so no copy reads past the workspace).  x that TMA cannot take (K %
//     4 != 0, or not 16-byte aligned) is written into the same image by
//     plain loads of the producer warp;
//   * two consumer warpgroups of 64 rows load their A fragments from the
//     swizzled stage (two wavefronts a warp, the fewest for 256 bytes),
//     split them with split3 and issue three wgmma m64n128k16 per k-step
//     (A from registers, B the W' tile), k in order, skipping k-steps
//     past the slice; they wait for the stage's products before they
//     release it and load the next stage's fragments into the same
//     registers (a second register set, to keep a stage in flight, makes
//     ptxas serialize the wgmmas: PERF.md §6);
//   * the epilogue adds + 0.0f (a sum of zeros may be -0) and writes
//     float32, or the slice's partial sums, which sum_splits adds in
//     slice order.
// Its time at the encoder's shapes is mostly fixed cost a call and, at
// 1024^2, the split-K sum (PERF.md §6, §7).
// The split is exact for finite x below bf16's overflow threshold (2 -
// 2^-8) 2^127 that is a multiple of 2^-133, bf16's smallest subnormal
// (every x of magnitude >= 2^-110); a part times w is exact unless it
// falls below fp32's normal range (PERF.md §6 says what the card does
// with subnormal parts).  Inf and NaN x are not split.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "faultmodel.cuh"

namespace {

// cudaFuncSetAttribute sets a kernel's attribute on the CURRENT card only,
// so each kernel that asks for more than 48 KB of dynamic shared memory
// keeps one flag a card (the wrappers launch with the tensors' card
// current).  `card` returns the current card.
constexpr int MAX_CARDS = 64;

template <typename Kernel>
cudaError_t smem_attr(Kernel* kernel, int bytes, bool (&set)[MAX_CARDS],
                      int* card) {
  cudaError_t err = cudaGetDevice(card);
  if (err != cudaSuccess) return err;
  if (*card < 0 || *card >= MAX_CARDS) return cudaErrorInvalidDevice;
  if (!set[*card]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    set[*card] = true;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------
// SIMT body (int16, int32)
namespace simt {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8, THREADS = 256;
constexpr int APAD = BM + 4;  // row stride of the transposed x tile

template <typename T, int MODEL>
__global__ void __launch_bounds__(THREADS)
kernel(const float* __restrict__ x, const T* __restrict__ qw,
       float* __restrict__ out, const float* __restrict__ scale_p,
       const float* __restrict__ rate_p, int rows, int M, int K, int N,
       int k_chunk, uint32_t seed, int faulty_bits, int mbu_width) {
  __shared__ __align__(16) float As[BK][APAD];
  __shared__ __align__(16) float Bs[BK][BN];
  const int row = blockIdx.z % rows, split = blockIdx.z / rows;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = split * k_chunk, k_end = min(K, k_begin + k_chunk);
  const float scale = *scale_p;
  const uint32_t thresh = afp::rate_threshold(rate_p[row]);
  const float* xr = x + static_cast<int64_t>(row) * M * K;
  // slice `split` of the partial sums (the output itself when unsplit)
  float* outr = out + (static_cast<int64_t>(split) * rows + row) * M * N;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int e = t + l * THREADS, mm = e / BK, kk = e % BK;
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < k_end) ? xr[static_cast<int64_t>(m) * K + k]
                                        : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int e = t + l * THREADS, kk = e / BN, nn = e % BN;
      const int k = k0 + kk, n = n0 + nn;
      float w = 0.0f;
      if (k < k_end && n < N) {
        const int64_t flat = static_cast<int64_t>(k) * N + n;
        const T q = afp::apply_fault<MODEL>(qw[flat], static_cast<uint32_t>(flat),
                                            seed, thresh, faulty_bits, mbu_width);
        w = __fmul_rn(static_cast<float>(q), scale);
      }
      Bs[kk][nn] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) outr[static_cast<int64_t>(m) * N + n] = acc[i][j];
    }
  }
}

}  // namespace simt

// ---------------------------------------------------------------------
// Tensor-core body of float32 x with int8 qw; its wgmma, cp.async and
// B-layout helpers serve the bf16 route too
namespace tc {

constexpr int WGS = 4;                 // warpgroups, all of them consumers
constexpr int THREADS = 128 * WGS;
constexpr int MT = 2;                  // m64 tiles per warpgroup
constexpr int BM = 64 * MT * WGS;      // rows per block: 512
constexpr int BK = 16;                 // one wgmma k-step per stage
constexpr int XS = 3;                  // stages of the x ring
constexpr int XLD = BK + 8;            // x row stride in floats: 96 B,
                                       // so the fragment reads miss no bank
constexpr int X_STAGE = BM * XLD;      // elements per x stage

// Bytes of one B tile: BN x 16 bf16 in the no-swizzle K-major layout,
// core matrices of 8 n-rows x 16 bytes (8 k), the two k-halves 128 B
// apart (LBO), successive 8-row groups 256 B apart (SBO).
template <int BN> constexpr int B_BYTES = BN * BK * 2;
template <int BN>
constexpr int SMEM_BYTES = 2 * B_BYTES<BN> + XS * X_STAGE * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t b_offset(int n, int k) {
  return (n & 7) * 16 + (n >> 3) * 256 + (k >> 3) * 128 + (k & 7) * 2;
}

__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Make this thread's writes to shared memory (stores, completed cp.async
// copies) visible to the tensor cores' async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin accumulator registers at this point of the program, so the compiler
// moves no read of them across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += A (64x16 bf16, registers) @ B (16xBN bf16, shared memory).
template <int BN> struct Mma;

template <> struct Mma<16> {
  static constexpr int R = 8;
  static __device__ __forceinline__ void run(float (&d)[R],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
        "p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Mma<64> {
  static constexpr int R = 32;
  static __device__ __forceinline__ void run(float (&d)[R],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Mma<128> {
  static constexpr int R = 64;
  static __device__ __forceinline__ void run(float (&d)[R],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// d += A (64x16 bf16) @ B (16xBN bf16), both from shared memory by
// descriptor.
template <int BN> struct MmaSS;

template <> struct MmaSS<256> {
  static constexpr int R = 128;
  static __device__ __forceinline__ void run(float (&d)[R], uint64_t a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
        "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
        "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "
        "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
        "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "
        "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
        "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(desc), "r"(1));
  }
};


__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Split two floats exactly into three bf16x2 words: v = h0 + h1 + h2
// elementwise (the low half holds v.x, as the A fragment wants).
__device__ __forceinline__ void split3(float2 v, uint32_t& h0, uint32_t& h1,
                                       uint32_t& h2) {
  const __nv_bfloat162 b0 = __float22bfloat162_rn(v);
  const float2 f0 = __bfloat1622float2(b0);
  const float2 r1 = make_float2(__fsub_rn(v.x, f0.x), __fsub_rn(v.y, f0.y));
  const __nv_bfloat162 b1 = __float22bfloat162_rn(r1);
  const float2 f1 = __bfloat1622float2(b1);
  const float2 r2 = make_float2(__fsub_rn(r1.x, f1.x), __fsub_rn(r1.y, f1.y));
  h0 = bf16x2_bits(b0);
  h1 = bf16x2_bits(b1);
  h2 = bf16x2_bits(__float22bfloat162_rn(r2));
}

// grid: (N tiles, M chunks of BM, rows * splits); THREADS threads;
// SMEM_BYTES<BN> of dynamic shared memory.  q' is exact in bf16, so the
// scale waits for the epilogue.  dst is [rows, M, N] float32 where splits
// is 1, else the partial sums [splits, rows, M, N].
template <int BN, int MODEL>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const float* __restrict__ x, const int8_t* __restrict__ qw,
       float* __restrict__ dst, const float* __restrict__ scale_p,
       const float* __restrict__ rate_p, int rows, int M, int K, int N,
       int k_chunk, bool x_vec, uint32_t seed, int faulty_bits,
       int mbu_width) {
  constexpr int CHUNKS = BK * 4 / 16;   // 16-byte chunks of a row: 4
  constexpr int CHUNK_K = 4;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* bt = smem;                                   // 2 B tiles
  float* xs = reinterpret_cast<float*>(smem + 2 * B_BYTES<BN>);

  const int row = blockIdx.z % rows, split = blockIdx.z / rows;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = split * k_chunk, k_end = min(K, k_begin + k_chunk);
  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const uint32_t thresh = afp::rate_threshold(rate_p[row]);
  const float scale = *scale_p;
  const float* xr = x + static_cast<int64_t>(row) * M * K;
  const int t = threadIdx.x;
  const int wg = t / 128, warp = (t / 32) % 4, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;

  // x stage s -> ring slot s % XS.  Thread t copies the 16-byte chunk t %
  // CHUNKS of rows t / CHUNKS + i THREADS / CHUNKS of the stage.  Rows past
  // M and k past the slice arrive as zeros.  Without 16-byte alignment, x
  // goes by 4-byte cp.async.
  constexpr int ROW_STEP = THREADS / CHUNKS;
  const int xk = CHUNK_K * (t % CHUNKS);
  const float* x_src = xr + static_cast<int64_t>(m0 + t / CHUNKS) * K + k_begin + xk;
  auto load_x = [&](int s) {
    const float* src = x_src + s * BK;
    float* dst = xs + (s % XS) * X_STAGE + (t / CHUNKS) * XLD + xk;
    const int k = k_begin + s * BK + xk;
#pragma unroll
    for (int i = 0; i < BM / ROW_STEP; ++i) {
      const bool row_ok = m0 + t / CHUNKS + i * ROW_STEP < M;
      if (x_vec) {
        const bool ok = row_ok && k < k_end;
        cp_async16(dst, ok ? src : xr, ok);
      } else {
#pragma unroll
        for (int e = 0; e < CHUNK_K; ++e) {
          const bool ok = row_ok && k + e < k_end;
          cp_async4(dst + e, ok ? src + e : xr, ok);
        }
      }
      src += static_cast<int64_t>(ROW_STEP) * K;
      dst += ROW_STEP * XLD;
    }
  };

  // The weights: thread t < 8 * BN owns the pair (k, k + 1) = 2 * (t / BN)
  // + {0, 1} at column n = t % BN of every stage.
  const bool owner = t < 8 * BN;
  const int wn = t % BN, wk = 2 * (t / BN);
  auto load_q = [&](int s, int8_t (&q)[2]) {
    const int k = k_begin + s * BK + wk, n = n0 + wn;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      q[j] = (k + j < k_end && n < N)
                 ? qw[static_cast<int64_t>(k + j) * N + n] : int8_t(0);
  };
  auto corrupt_q = [&](int s, const int8_t (&q)[2]) {
    const int k = k_begin + s * BK + wk, n = n0 + wn;
    float f[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t idx = static_cast<uint32_t>(k + j) * static_cast<uint32_t>(N)
                           + static_cast<uint32_t>(n);
      f[j] = static_cast<float>(afp::apply_fault<MODEL>(
          q[j], idx, seed, thresh, faulty_bits, mbu_width));
    }
    *reinterpret_cast<uint32_t*>(bt + (s % 2) * B_BYTES<BN> +
                                 b_offset(wn, wk)) =
        bf16x2_bits(__floats2bfloat162_rn(f[0], f[1]));
  };

  constexpr int R = Mma<BN>::R;
  float acc[MT][R];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[j][i] = 0.0f;

  // prologue: x stages 0 and 1 in flight, B tile 0 corrupted, the raw
  // weights of stage 1 in registers
  int8_t qn[2] = {0, 0};
#pragma unroll
  for (int s = 0; s < XS - 1; ++s) {
    if (s < nk) load_x(s);
    cp_async_commit();
  }
  if (owner && nk > 0) {
    load_q(0, qn);
    corrupt_q(0, qn);
    if (nk > 1) load_q(1, qn);
  }
  fence_proxy_async();

  for (int s = 0; s < nk; ++s) {
    cp_async_wait<XS - 2>();
    __syncthreads();  // x stage s and B tile s are in; slot (s + 2) % XS
                      // and B tile (s + 1) % 2 are free
    if (s + XS - 1 < nk) load_x(s + XS - 1);
    cp_async_commit();

    const float* xt = xs + (s % XS) * X_STAGE;
    const uint64_t desc = b_desc(bt + (s % 2) * B_BYTES<BN>);
    // A fragment word h of m64 tile j: the two neighbouring k of (row,
    // col) = (r, 2tq) (r+8, 2tq) (r, 2tq+8) (r+8, 2tq+8) for h = 0..3,
    // split exactly into three bf16 words
    uint32_t a[MT][3][4];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (m0 + wg * 128 + j * 64 >= M) continue;  // uniform per warpgroup
      const int r = wg * 128 + j * 64 + warp * 16 + g;
#pragma unroll
      for (int h = 0; h < 4; ++h)
        split3(*reinterpret_cast<const float2*>(
                   xt + (r + (h & 1) * 8) * XLD + 2 * tq + (h >> 1) * 8),
               a[j][0][h], a[j][1][h], a[j][2][h]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 3; ++p) Mma<BN>::run(acc[j], a[j][p], desc);
    }
    wgmma_commit();

    // overlap the tensor cores: corrupt the next B tile, fetch the raw
    // weights of the one after
    if (owner && s + 1 < nk) {
      corrupt_q(s + 1, qn);
      if (s + 2 < nk) load_q(s + 2, qn);
    }
    fence_proxy_async();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < MT; ++j) fence_acc(acc[j]);
  }

  // epilogue: d[4c + e] of an m64nN tile is (row 16 warp + g + 8 (e / 2),
  // col 8c + 2tq + e % 2), so d[2i], d[2i + 1] are neighbours in a row and
  // go out as one store where N is even; + 0.0f turns a -0 sum of zeros
  // into +0, then the scale
  const int64_t base = (static_cast<int64_t>(split) * rows + row) * M * N;
  auto fin = [&](float v) { return __fmul_rn(__fadd_rn(v, 0.0f), scale); };
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int i = 0; i < R; i += 2) {
      const int m = m0 + wg * 128 + j * 64 + warp * 16 + g + 8 * ((i / 2) % 2);
      const int n = n0 + 8 * (i / 4) + 2 * tq;
      if (m >= M) continue;
      float* d = dst + base + static_cast<int64_t>(m) * N + n;
      const float v0 = fin(acc[j][i]), v1 = fin(acc[j][i + 1]);
      if (N % 2 == 0 && n + 1 < N) {
        *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
      } else {
        if (n < N) d[0] = v0;
        if (n + 1 < N) d[1] = v1;
      }
    }
  }
}

template <int BN, int MODEL>
cudaError_t launch(const float* x, const int8_t* qw, float* dst,
                   const float* scale, const float* rate, int rows, int M,
                   int K, int N, int splits, int k_chunk, uint32_t seed,
                   int faulty_bits, int mbu_width, cudaStream_t s) {
  constexpr int smem = SMEM_BYTES<BN>;
  static bool attr_set[MAX_CARDS] = {};
  int card;
  const cudaError_t err =
      smem_attr(kernel<BN, MODEL>, smem, attr_set, &card);
  if (err != cudaSuccess) return err;
  const bool x_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, rows * splits);
  kernel<BN, MODEL><<<grid, THREADS, smem, s>>>(
      x, qw, dst, scale, rate, rows, M, K, N, k_chunk, x_vec, seed,
      faulty_bits, mbu_width);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------
// bf16 x: the hash pass and the product
namespace bfp {

using tc::BK;
using tc::fence_acc;
using tc::fence_proxy_async;
using tc::MmaSS;
using tc::smem_addr;
using tc::wgmma_commit;
using tc::wgmma_fence;
constexpr int TILE_N = 128;                 // columns of a W' tile
constexpr int TILE = BK * TILE_N;           // elements of a W' tile (4 KB)

// The hash pass.  grid: one block per W' tile (k-tile ks, column tile nt)
// = blockIdx.x, nt * nK + ks; 256 threads, each four bf16 pairs of the
// tile.  Pair p of a tile is the 4-byte word p of its image, the weights
// (k, n) and (k + 1, n) with k = 2 (p & 3) + 8 ((p >> 5) & 1) and n =
// ((p >> 2) & 7) + 8 (p >> 6): b_offset(n, k) = 4p, so a warp writes 128
// contiguous bytes.  Each pair's draws are computed once (weight_draws)
// and every row of the group builds its mask from them; weights past K
// or N are written as zeros, so the product reads whole tiles.
constexpr int HASH_THREADS = 256;

template <int MODEL, typename QT>
__global__ void __launch_bounds__(HASH_THREADS)
hash_kernel(const QT* __restrict__ qw, __nv_bfloat16* __restrict__ tiles,
            const float* __restrict__ scale_p, const float* __restrict__ rate,
            int rows, int K, int N, int nK, int64_t row_elems, uint32_t seed,
            int faulty_bits, int mbu_width) {
  const int nt = blockIdx.x / nK, ks = blockIdx.x % nK;
  const float scale = *scale_p;
  __nv_bfloat16* tile = tiles + static_cast<int64_t>(blockIdx.x) * TILE;
#pragma unroll 1
  for (int p = threadIdx.x; p < TILE / 2; p += HASH_THREADS) {
    const int k = ks * BK + 2 * (p & 3) + 8 * ((p >> 5) & 1);
    const int n = nt * TILE_N + ((p >> 2) & 7) + 8 * (p >> 6);
    bool ok[2];
    QT q[2];
    uint32_t d[2][afp::kMaxPlanes];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ok[j] = k + j < K && n < N;
      const uint32_t idx = static_cast<uint32_t>(k + j) * static_cast<uint32_t>(N)
                           + static_cast<uint32_t>(n);
      q[j] = ok[j] ? qw[idx] : QT(0);
      afp::weight_draws<MODEL>(idx, seed, faulty_bits, mbu_width, d[j]);
    }
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      const uint32_t thresh = afp::rate_threshold(rate[r]);
      float f[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const QT v = afp::apply_mask<MODEL>(
            q[j], afp::row_mask<MODEL>(d[j], thresh, faulty_bits));
        f[j] = ok[j] ? __fmul_rn(static_cast<float>(v), scale) : 0.0f;
      }
      reinterpret_cast<__nv_bfloat162*>(tile + r * row_elems)[p] =
          __floats2bfloat162_rn(f[0], f[1]);
    }
  }
}

// The product: a warp-specialised kernel.  grid: (M / BM, N / BN, rows *
// splits), m fastest, so the blocks of a wave share W' panels; THREADS
// threads; SMEM bytes of dynamic shared memory.
//   * warpgroup 0 is the producer: it gives up registers (setmaxnreg) and
//     one of its threads fills a ring of STAGES stages, each KS k-steps (64
//     of K), with two TMA copies a stage: x's [BM, 64] box through a 3-D
//     tensor map over [R, M, K] that swizzles its 128-byte rows (128B) and
//     zero-fills past M and K, and the stage's [64, BN] of W' through a 5-D
//     map over the W' tiles whose dimension order lands the two panels'
//     tiles of a k-step side by side, one n256 K-major operand (LBO 128,
//     SBO 256), and zero-fills past the last tile.  x that TMA cannot take (K % 8 != 0,
//     or not 16-byte aligned) is written into the same image by plain loads
//     of the producer warp.  Each stage has a full mbarrier (the copies'
//     bytes and the producer's arrive) and an empty one (one arrive per
//     consumer warpgroup);
//   * warpgroups 1 and 2 are the consumers, 64 rows each: they take more
//     registers, wait on a stage's full barrier, issue its four wgmma
//     m64n256k16 (A by descriptor from the swizzled x stage, B the W'
//     stage) into fp32 accumulators, k in order, commit them as one group,
//     wait until at most that group is in flight (wait_group 1), and only
//     then release the previous stage;
//   * a K-slice is a whole number of stages, so every stage runs its four
//     wgmmas; past K the copies read zeros.
// A wait on an mbarrier that never completes (a phase-parity fault) traps
// after ~2^26 tries, so the launch fails instead of hanging the card.
constexpr int BM = 128;                     // two consumer warpgroups of 64
constexpr int BN = 2 * TILE_N;              // two W' panels
constexpr int KS = 4;                       // k-steps a stage: 64 of K, so
                                            // an x row is 128 bytes
constexpr int THREADS = 384;
constexpr int X_BYTES = BM * KS * BK * 2;   // 16 KB
constexpr int TILE_BYTES = TILE * 2;        // 4 KB
constexpr int W_BYTES = KS * 2 * TILE_BYTES;
constexpr int STAGE = X_BYTES + W_BYTES;    // 48 KB
constexpr int STAGES = 4;
// 1024 bytes of slack to align the ring for the 128B swizzle, the stages,
// a full and an empty barrier each
constexpr int SMEM = 1024 + STAGES * STAGE + 16 * STAGES;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier"
               "::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
                  "r"(c1), "r"(c2), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            int c4, uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier"
               "::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
                  "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(bar) : "memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// B of one k-step: the W' stage's two tiles of that k-step, side by side
// in the no-swizzle K-major image (LBO 128 B, SBO 256 B)
__device__ __forceinline__ uint64_t b_desc_at(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// A of one k-step: 64 x 16 of the 128B-swizzled x stage, 128-byte rows,
// 8-row groups 1024 B apart; the k-step's 32 bytes start the address
__device__ __forceinline__ uint64_t a_desc_at(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// dst is [rows, M, N] bf16 where splits is 1, else float32 partial sums
// [splits, rows, M, N].  A K-slice is k_tiles W' tiles (16 of K each), a
// multiple of KS.
__global__ void __launch_bounds__(THREADS, 1)
product_kernel(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap w_map,
               const __nv_bfloat16* __restrict__ x, void* __restrict__ dst_p,
               int rows, int M, int K, int N, int nK, int k_tiles,
               int splits, bool x_tma) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + STAGES * STAGE;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (STAGES + i); };

  const int row = blockIdx.z % rows, split = blockIdx.z / rows;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ks0 = split * k_tiles, ks_end = min(nK, ks0 + k_tiles);
  const int nst = ks_end > ks0 ? (ks_end - ks0 + KS - 1) / KS : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer, one warp: stage s fills slot s % STAGES once its
    // previous use is released (the first round passes at once)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      if (x_tma) tma_prefetch(&x_map);
      tma_prefetch(&w_map);
    }
    const __nv_bfloat16* xr = x + static_cast<int64_t>(row) * M * K;
    const int k_end = min(K, ks_end * BK);
    for (int s = 0; s < nst; ++s) {
      const int slot = s % STAGES, ks = ks0 + s * KS;
      mbar_wait(empty(slot), ((s / STAGES) & 1) ^ 1);
      const uint32_t xs = base + slot * STAGE;
      if (lane == 0) {
        mbar_expect_tx(full(slot), (x_tma ? X_BYTES : 0) + W_BYTES);
        tma_load_5d(xs + X_BYTES, &w_map, 0, 0, n0 / TILE_N, ks, row,
                    full(slot));
        if (x_tma) tma_load_3d(xs, &x_map, ks * BK, m0, row, full(slot));
      }
      if (!x_tma) {
        // element (m, k) of the stage at byte m 128 + ((k / 8) ^ (m % 8))
        // 16 + (k % 8) 2, TMA's 128B swizzle; zeros past M and the slice
        unsigned char* xd = smem + slot * STAGE;
        for (int c = lane; c < BM * 8; c += 32) {
          const int mm = c / 8, ch = c % 8, m = m0 + mm, k = ks * BK + ch * 8;
          __align__(16) __nv_bfloat16 v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = m < M && k + e < k_end ? xr[static_cast<int64_t>(m) * K + k + e]
                                          : __float2bfloat16_rn(0.0f);
          *reinterpret_cast<uint4*>(xd + mm * 128 + ((ch ^ (mm & 7)) << 4)) =
              *reinterpret_cast<const uint4*>(v);
        }
        fence_proxy_async();
        __syncwarp();
      }
      if (lane == 0) mbar_arrive(full(slot));
    }
    return;
  }

  // the consumers: warpgroup c = wg - 1 owns rows 64 c .. 64 c + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  constexpr int R = MmaSS<BN>::R;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  for (int s = 0; s < nst; ++s) {
    const int slot = s % STAGES;
    mbar_wait(full(slot), (s / STAGES) & 1);
    const uint32_t xs = base + slot * STAGE, ws = xs + X_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      MmaSS<BN>::run(acc, a_desc_at(xs + c * 64 * 128 + kk * 32),
                     b_desc_at(ws + kk * 2 * TILE_BYTES));
    wgmma_commit();
    wgmma_wait<1>();                // the previous stage's group is done
    if (s > 0 && t == 0) mbar_arrive(empty((s - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: the tile goes out through shared memory (the ring, free once
  // both consumers are done), so that a warp writes whole rows in 16-byte
  // stores.  d[4j + e] of an m64n256 tile is (row 16 warp + g + 8 (e / 2),
  // col 8j + 2tq + e % 2); a staged row's 16-byte chunk q lies at q ^ (row
  // % 8), so neither the writes nor the reads conflict on banks.  + 0.0f
  // turns a -0 sum of zeros into +0; rounded once to bf16 (or the fp32
  // partial sums of a K-slice).
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const bool out_bf16 = splits == 1;
  const int esz = out_bf16 ? 2 : 4, rb = BN * esz;
  unsigned char* st = smem + c * 64 * rb;
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int r = warp * 16 + g + 8 * ((i / 2) % 2);
    const int byte = (8 * (i / 4) + 2 * tq) * esz;
    unsigned char* p = st + r * rb + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
    const float v0 = __fadd_rn(acc[i], 0.0f), v1 = __fadd_rn(acc[i + 1], 0.0f);
    if (out_bf16)
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  }
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + c) : "memory");
  const int cpr = rb / 16, per = 16 / esz;    // chunks a row, elements a chunk
  const int64_t obase = (static_cast<int64_t>(split) * rows + row) * M * N;
  const bool vec = N % per == 0 && reinterpret_cast<uintptr_t>(dst_p) % 16 == 0;
  for (int q = t; q < 64 * cpr; q += 128) {
    const int r = q / cpr, cc = q % cpr;
    const int m = m0 + c * 64 + r, n = n0 + cc * per;
    if (m >= M || n >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(st + r * rb + ((cc ^ (r & 7)) << 4));
    const int64_t o = obase + static_cast<int64_t>(m) * N + n;
    if (vec) {
      *reinterpret_cast<uint4*>(static_cast<unsigned char*>(dst_p) + o * esz) = v;
    } else if (out_bf16) {
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
      for (int k = 0; k < per && n + k < N; ++k)
        static_cast<uint16_t*>(dst_p)[o + k] = e[k];
    } else {
      const uint32_t* e = reinterpret_cast<const uint32_t*>(&v);
      for (int k = 0; k < per && n + k < N; ++k)
        static_cast<uint32_t*>(dst_p)[o + k] = e[k];
    }
  }
}

// cuTensorMapEncodeTiled lives in libcuda, which this library does not
// link: its address is looked up at run time
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return encode;
}

cudaError_t encode_map(CUtensorMap* map, const void* p, cuuint32_t rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box, CUtensorMapSwizzle swizzle,
                       CUtensorMapDataType type) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, type, rank, const_cast<void*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The last map encoded for an operand, reused while its card, pointer and
// shape repeat (the W' workspace call after call): encoding is host work
// on every call otherwise.  The shape fixes the strides and the box (each
// cache serves one operand of one kernel, so one type and swizzle); the
// card keeps a map made for one card's allocation from another card's
// launch, should an address be reused across cards.
struct MapCache {
  int card = -1;
  const void* p = nullptr;
  cuuint64_t dims[5] = {};
  CUtensorMap map;
};

cudaError_t cached_map(MapCache& c, int card, const void* p,
                       cuuint32_t rank, const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box, CUtensorMapSwizzle swizzle,
                       CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  bool same = c.card == card && c.p == p;
  for (cuuint32_t i = 0; i < rank; ++i) same = same && c.dims[i] == dims[i];
  if (same) return cudaSuccess;
  c.p = nullptr;
  const cudaError_t err = encode_map(&c.map, p, rank, dims, strides, box,
                                     swizzle, type);
  if (err != cudaSuccess) return err;
  c.card = card;
  c.p = p;
  for (cuuint32_t i = 0; i < rank; ++i) c.dims[i] = dims[i];
  return cudaSuccess;
}

cudaError_t launch_product(const __nv_bfloat16* x, const __nv_bfloat16* tiles,
                           void* dst, int rows, int M, int K, int N, int nK,
                           int64_t row_elems, int k_tiles, int splits,
                           cudaStream_t s) {
  static bool attr_set[MAX_CARDS] = {};
  int card;
  cudaError_t err = smem_attr(product_kernel, SMEM, attr_set, &card);
  if (err != cudaSuccess) return err;
  const int nN = (N + TILE_N - 1) / TILE_N;
  // W' as dims (256-byte line, line of a tile, panel, k-tile, row): the box
  // {128, 16, 2, KS, 1} lands k-step major, the two panels side by side
  thread_local MapCache w_cache, x_cache;
  const cuuint64_t w_dims[5] = {128, 16, static_cast<cuuint64_t>(nN),
                                static_cast<cuuint64_t>(nK),
                                static_cast<cuuint64_t>(rows)};
  const cuuint64_t w_strides[4] = {
      256, static_cast<cuuint64_t>(nK) * TILE_BYTES, TILE_BYTES,
      static_cast<cuuint64_t>(row_elems) * 2};
  const cuuint32_t w_box[5] = {128, 16, 2, KS, 1};
  err = cached_map(w_cache, card, tiles, 5, w_dims, w_strides, w_box,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  // x as [rows, M, K] in [BM, 64] boxes, 128B swizzle, where its rows are
  // 16-byte multiples and it is 16-byte aligned; else the producer loads it
  const bool x_tma = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (x_tma) {
    const cuuint64_t x_dims[3] = {static_cast<cuuint64_t>(K),
                                  static_cast<cuuint64_t>(M),
                                  static_cast<cuuint64_t>(rows)};
    const cuuint64_t x_strides[2] = {static_cast<cuuint64_t>(K) * 2,
                                     static_cast<cuuint64_t>(M) * K * 2};
    const cuuint32_t x_box[3] = {KS * BK, BM, 1};
    err = cached_map(x_cache, card, x, 3, x_dims, x_strides, x_box,
                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, rows * splits);
  // without TMA the kernel never reads the x map
  product_kernel<<<grid, THREADS, SMEM, s>>>(x_cache.map, w_cache.map, x, dst,
                                             rows, M, K, N, nK, k_tiles,
                                             splits, x_tma);
  return cudaGetLastError();
}

}  // namespace bfp

// ---------------------------------------------------------------------
// float32 x on W': the product of the float32-x, bf16-weight route (the
// design is in the note at the top)
namespace fwp {

using bfp::mbar_arrive;
using bfp::mbar_expect_tx;
using bfp::mbar_init;
using bfp::mbar_wait;
using bfp::TILE;
using bfp::TILE_BYTES;
using tc::BK;
using tc::fence_acc;
using tc::Mma;
using tc::smem_addr;
using tc::split3;
using tc::wgmma_commit;
using tc::wgmma_fence;

constexpr int BM = 128;                     // two consumer warpgroups of 64
constexpr int BN = bfp::TILE_N;             // one W' panel
constexpr int KS = bfp::KS;                 // k-steps a stage: 64 of K
constexpr int THREADS = 384;
constexpr int X_HALF = BM * 32 * 4;         // one [128, 32] float32 box, 16 KB
constexpr int X_BYTES = 2 * X_HALF;
constexpr int W_BYTES = KS * TILE_BYTES;    // 16 KB
constexpr int STAGE = X_BYTES + W_BYTES;    // 48 KB
constexpr int STAGES = 4;
// 1024 bytes of slack to align the ring for the 128B swizzle, the stages,
// a full and an empty barrier each
constexpr int SMEM = 1024 + STAGES * STAGE + 16 * STAGES;

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
                  "r"(bar) : "memory");
}

// Byte offset of x element (m, k) in a stage: k / 32 picks the [128, 32]
// box, whose 128-byte rows hold their 16-byte chunks at (k / 4 % 8) ^ (m
// % 8), TMA's 128B swizzle
__device__ __forceinline__ int x_offset(int m, int k) {
  return (k >> 5) * X_HALF + m * 128 + ((((k >> 2) & 7) ^ (m & 7)) << 4) +
         (k & 3) * 4;
}

// grid: (M / BM, N / BN, rows * splits), m fastest, so the blocks of a
// wave share W' panels; THREADS threads; SMEM bytes of dynamic shared
// memory.  dst is [rows, M, N] float32 where splits is 1, else the partial
// sums [splits, rows, M, N].  A K-slice is k_tiles W' tiles, a multiple of
// KS.
__global__ void __launch_bounds__(THREADS, 1)
product_kernel(const __grid_constant__ CUtensorMap x_map,
               const float* __restrict__ x,
               const __nv_bfloat16* __restrict__ tiles,
               float* __restrict__ dst, int rows, int M, int K, int N, int nK,
               int64_t row_elems, int k_tiles, bool x_tma) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + STAGES * STAGE;
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (STAGES + i); };

  const int row = blockIdx.z % rows, split = blockIdx.z / rows;
  const int m0 = blockIdx.x * BM, nt = blockIdx.y;
  const int ks0 = split * k_tiles, ks_end = min(nK, ks0 + k_tiles);
  const int nst = ks_end > ks0 ? (ks_end - ks0 + KS - 1) / KS : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer, one warp: stage s fills slot s % STAGES once its
    // previous use is released (the first round passes at once)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0 && x_tma) bfp::tma_prefetch(&x_map);
    const float* xr = x + static_cast<int64_t>(row) * M * K;
    const __nv_bfloat16* wp =
        tiles + row * row_elems + static_cast<int64_t>(nt) * nK * TILE;
    for (int s = 0; s < nst; ++s) {
      const int slot = s % STAGES, ks = ks0 + s * KS;
      const int n_tiles = min(KS, ks_end - ks);
      mbar_wait(empty(slot), ((s / STAGES) & 1) ^ 1);
      const uint32_t xs = base + slot * STAGE;
      if (lane == 0) {
        mbar_expect_tx(full(slot),
                       (x_tma ? X_BYTES : 0) + n_tiles * TILE_BYTES);
        bulk_load(xs + X_BYTES, wp + static_cast<int64_t>(ks) * TILE,
                  n_tiles * TILE_BYTES, full(slot));
        if (x_tma) {
          bfp::tma_load_3d(xs, &x_map, ks * BK, m0, row, full(slot));
          bfp::tma_load_3d(xs + X_HALF, &x_map, ks * BK + 32, m0, row,
                           full(slot));
        }
      }
      if (!x_tma) {
        // the same image by plain loads, four floats a chunk; zeros past
        // M and K
        unsigned char* xd = smem + slot * STAGE;
        for (int c = lane; c < BM * 16; c += 32) {
          const int mm = c / 16, kk = (c % 16) * 4;
          const int m = m0 + mm, k = ks * BK + kk;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = m < M && k + e < K ? xr[static_cast<int64_t>(m) * K + k + e]
                                      : 0.0f;
          *reinterpret_cast<float4*>(xd + x_offset(mm, kk)) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
        __syncwarp();
      }
      if (lane == 0) mbar_arrive(full(slot));
    }
    return;
  }

  // the consumers: warpgroup c = wg - 1 owns rows 64 c .. 64 c + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  constexpr int R = Mma<BN>::R;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  // A fragment word h of a k-step: the two neighbouring k of (row, col) =
  // (r, 2tq) (r+8, 2tq) (r, 2tq+8) (r+8, 2tq+8) for h = 0..3
  const int r0 = c * 64 + warp * 16 + g;
  for (int s = 0; s < nst; ++s) {
    const int slot = s % STAGES, nkk = min(KS, ks_end - (ks0 + s * KS));
    mbar_wait(full(slot), (s / STAGES) & 1);
    const unsigned char* xs = smem + slot * STAGE;
    const uint32_t ws = base + slot * STAGE + X_BYTES;
    uint32_t a[KS][3][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk >= nkk) break;                   // uniform: past the slice
#pragma unroll
      for (int h = 0; h < 4; ++h)
        split3(*reinterpret_cast<const float2*>(
                   xs + x_offset(r0 + (h & 1) * 8, kk * BK + 2 * tq +
                                                       (h >> 1) * 8)),
               a[kk][0][h], a[kk][1][h], a[kk][2][h]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 3; ++p)
        Mma<BN>::run(acc, a[kk][p], bfp::b_desc_at(ws + kk * TILE_BYTES));
    }
    wgmma_commit();
    bfp::wgmma_wait<0>();   // the stage's products are done: its A
    fence_acc(acc);         // registers and its slot are free
    if (t == 0) mbar_arrive(empty(slot));
  }

  // epilogue: d[4j + e] of an m64n128 tile is (row 16 warp + g + 8 (e /
  // 2), col 8j + 2tq + e % 2), so d[2i], d[2i + 1] are neighbours in a row
  // and go out as one store where N is even; + 0.0f turns a -0 sum of
  // zeros into +0
  const int64_t obase = (static_cast<int64_t>(split) * rows + row) * M * N;
  const int n0 = nt * BN;
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int m = m0 + r0 + 8 * ((i / 2) % 2);
    const int n = n0 + 8 * (i / 4) + 2 * tq;
    if (m >= M) continue;
    float* d = dst + obase + static_cast<int64_t>(m) * N + n;
    const float v0 = __fadd_rn(acc[i], 0.0f), v1 = __fadd_rn(acc[i + 1], 0.0f);
    if (N % 2 == 0 && n + 1 < N) {
      *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
    } else {
      if (n < N) d[0] = v0;
      if (n + 1 < N) d[1] = v1;
    }
  }
}

cudaError_t launch_product(const float* x, const __nv_bfloat16* tiles,
                           float* dst, int rows, int M, int K, int N, int nK,
                           int64_t row_elems, int k_tiles, int splits,
                           cudaStream_t s) {
  static bool attr_set[MAX_CARDS] = {};
  int card;
  cudaError_t err = smem_attr(product_kernel, SMEM, attr_set, &card);
  if (err != cudaSuccess) return err;
  // x as [rows, M, K] float32 in [BM, 32] boxes, 128B swizzle, where its
  // rows are 16-byte multiples and it is 16-byte aligned; else the
  // producer loads it
  thread_local bfp::MapCache x_cache;
  const bool x_tma = K > 0 && K % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (x_tma) {
    const cuuint64_t x_dims[3] = {static_cast<cuuint64_t>(K),
                                  static_cast<cuuint64_t>(M),
                                  static_cast<cuuint64_t>(rows)};
    const cuuint64_t x_strides[2] = {static_cast<cuuint64_t>(K) * 4,
                                     static_cast<cuuint64_t>(M) * K * 4};
    const cuuint32_t x_box[3] = {32, BM, 1};
    err = bfp::cached_map(
        x_cache, card, x, 3, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, rows * splits);
  // without TMA the kernel never reads the x map
  product_kernel<<<grid, THREADS, SMEM, s>>>(x_cache.map, x, tiles, dst, rows,
                                             M, K, N, nK, row_elems, k_tiles,
                                             x_tma);
  return cudaGetLastError();
}

}  // namespace fwp

// out[i] = sum over s of partial[s][i], in slice order, written as float32
// or rounded once to bf16; four elements a thread per step where vec (n %
// 4 == 0 and out aligned for it: a row group's out starts inside the
// call's; partial is the wrapper's own).
__device__ __forceinline__ void store4(float* out, int64_t i, float4 v) {
  reinterpret_cast<float4*>(out)[i] = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, int64_t i,
                                       float4 v) {
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out) + 2 * i;
  o[0] = __floats2bfloat162_rn(v.x, v.y);
  o[1] = __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ void store1(float* out, int64_t i, float v) {
  out[i] = v;
}
__device__ __forceinline__ void store1(__nv_bfloat16* out, int64_t i,
                                       float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <typename OT>
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  OT* __restrict__ out, int64_t n,
                                  int splits, bool vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {
    const float4* p = reinterpret_cast<const float4*>(partial);
    for (int64_t i = tid; i < n / 4; i += stride) {
      float4 acc = p[i];
      for (int s = 1; s < splits; ++s) {
        const float4 v = p[s * (n / 4) + i];
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      }
      store4(out, i, acc);
    }
    return;
  }
  for (int64_t i = tid; i < n; i += stride) {
    float acc = partial[i];
    for (int s = 1; s < splits; ++s) acc += partial[s * n + i];
    store1(out, i, acc);
  }
}

template <typename OT>
cudaError_t sum_splits(const float* partial, OT* out, int64_t total,
                       int splits, cudaStream_t s) {
  const int64_t blocks = (total + 255) / 256;
  const unsigned grid = static_cast<unsigned>(blocks < 132 * 8 ? blocks : 132 * 8);
  const bool vec = total % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * sizeof(OT)) == 0;
  sum_splits_kernel<OT><<<grid, 256, 0, s>>>(partial, out, total, splits, vec);
  return cudaGetLastError();
}

bool bad_sizes(int64_t rows, int64_t M, int64_t K, int64_t N, int splits) {
  return splits < 1 || rows * splits > 65535 || M > (1LL << 30) ||
         K > (1LL << 30) || N > (1LL << 30) || K * N > 0xFFFFFFFFLL;
}

}  // namespace

// float32 x: x is rows x M x K; qw: K x N integers of `qbytes` bytes; out:
// rows x M x N float32; scale: one float32; rate: rows float32.  With
// splits > 1, partial is a splits x rows x M x N float32 workspace.  int8
// qw runs the tensor-core body (N tile 16 for N <= 16, else 64), int16 or
// int32 qw the SIMT body; K is cut into `splits` slices of whole k-steps
// (16 of K on the tensor cores, 8 on the SIMT body).
extern "C" int afp_fault_matmul(const void* x, const void* qw, void* out,
                                float* partial, const float* scale,
                                const float* rate, int64_t rows, int64_t M,
                                int64_t K, int64_t N, int splits, int qbytes,
                                int model, uint32_t seed, int faulty_bits,
                                int mbu_width, void* stream) {
  if (rows <= 0 || M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(rows, M, K, N, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tensor_cores = qbytes == 1;
  const int bk = tensor_cores ? tc::BK : simt::BK;
  const int bm = tensor_cores ? tc::BM : simt::BM;
  if ((M + bm - 1) / bm > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t k_steps = (K + bk - 1) / bk;
  const int k_chunk = static_cast<int>((k_steps + splits - 1) / splits * bk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* dst = splits > 1 ? partial : static_cast<float*>(out);
  const int r = static_cast<int>(rows), m = static_cast<int>(M),
            k = static_cast<int>(K), n = static_cast<int>(N);
  cudaError_t err = cudaSuccess;
  if (tensor_cores) {
    const int8_t* q8 = static_cast<const int8_t*>(qw);
    if (N <= 16) {
      AFP_DISPATCH_MODEL(model, err = (tc::launch<16, MODEL>(
          xf, q8, dst, scale, rate, r, m, k, n, splits, k_chunk, seed,
          faulty_bits, mbu_width, s)));
    } else {
      AFP_DISPATCH_MODEL(model, err = (tc::launch<64, MODEL>(
          xf, q8, dst, scale, rate, r, m, k, n, splits, k_chunk, seed,
          faulty_bits, mbu_width, s)));
    }
  } else {
    const dim3 grid(static_cast<unsigned>((N + simt::BN - 1) / simt::BN),
                    static_cast<unsigned>((M + simt::BM - 1) / simt::BM),
                    static_cast<unsigned>(rows * splits));
    switch (qbytes) {
      case 2:
        AFP_DISPATCH_MODEL(model,
            simt::kernel<int16_t, MODEL><<<grid, simt::THREADS, 0, s>>>(
                xf, static_cast<const int16_t*>(qw), dst, scale, rate, r, m,
                k, n, k_chunk, seed, faulty_bits, mbu_width));
        break;
      case 4:
        AFP_DISPATCH_MODEL(model,
            simt::kernel<int32_t, MODEL><<<grid, simt::THREADS, 0, s>>>(
                xf, static_cast<const int32_t*>(qw), dst, scale, rate, r, m,
                k, n, k_chunk, seed, faulty_bits, mbu_width));
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(sum_splits<float>(
      partial, static_cast<float*>(out), rows * M * N, splits, s));
}

// bf16 x, the hash pass: qw is K x N integers of `qbytes` bytes; tiles is
// rows x row_elems bf16, row r the W' of rate[r]: ceil(K / 16) x ceil(N /
// 128) tiles of 16 x 128, tile (ks, nt) at (nt ceil(K / 16) + ks) 2048
// elements, each in the product's B image; bf16(fp32(q') scale).
extern "C" int afp_fault_weight_tiles(const void* qw, void* tiles,
                                      const float* scale, const float* rate,
                                      int64_t rows, int64_t K, int64_t N,
                                      int qbytes, int model, uint32_t seed,
                                      int faulty_bits, int mbu_width,
                                      void* stream) {
  if (rows <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(1, 1, K, N, 1) || rows > (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nK = static_cast<int>((K + tc::BK - 1) / tc::BK);
  const int nN = static_cast<int>((N + bfp::TILE_N - 1) / bfp::TILE_N);
  const int64_t row_elems = static_cast<int64_t>(nK) * nN * bfp::TILE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(tiles);
  const int r = static_cast<int>(rows), k = static_cast<int>(K),
            n = static_cast<int>(N);
  AFP_DISPATCH_INT(qbytes, AFP_DISPATCH_MODEL(model,
      bfp::hash_kernel<MODEL, QT><<<nK * nN, bfp::HASH_THREADS, 0, s>>>(
          static_cast<const QT*>(qw), out, scale, rate, r, k, n, nK,
          row_elems, seed, faulty_bits, mbu_width)));
  return static_cast<int>(cudaGetLastError());
}

// bf16 x, the product: x is rows x M x K bf16, tiles rows x row_elems (the
// hash pass's layout), out rows x M x N bf16.  With splits > 1, partial
// is a splits x rows x M x N float32 workspace and K is cut into slices
// of whole stages (KS W' tiles).
extern "C" int afp_matmul_tiles(const void* x, const void* tiles, void* out,
                                float* partial, int64_t rows, int64_t M,
                                int64_t K, int64_t N, int splits,
                                void* stream) {
  if (rows <= 0 || M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(rows, M, K, N, splits) || (N + bfp::BN - 1) / bfp::BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nK = static_cast<int>((K + tc::BK - 1) / tc::BK);
  const int nN = static_cast<int>((N + bfp::TILE_N - 1) / bfp::TILE_N);
  const int64_t row_elems = static_cast<int64_t>(nK) * nN * bfp::TILE;
  const int k_tiles = ((nK + splits - 1) / splits + bfp::KS - 1) / bfp::KS * bfp::KS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* dst = splits > 1 ? static_cast<void*>(partial) : out;
  const cudaError_t err = bfp::launch_product(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(tiles), dst, static_cast<int>(rows),
      static_cast<int>(M), static_cast<int>(K), static_cast<int>(N), nK,
      row_elems, k_tiles, splits, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(sum_splits<__nv_bfloat16>(
      partial, static_cast<__nv_bfloat16*>(out), rows * M * N, splits, s));
}

// float32 x on W', the product of the float32-x, bf16-weight route: x is
// rows x M x K float32, tiles rows x row_elems (the hash pass's layout),
// out rows x M x N float32.  With splits > 1, partial is a splits x rows
// x M x N float32 workspace and K is cut into slices of whole stages (KS
// W' tiles).
extern "C" int afp_matmul_tiles_f32(const void* x, const void* tiles,
                                    void* out, float* partial, int64_t rows,
                                    int64_t M, int64_t K, int64_t N,
                                    int splits, void* stream) {
  if (rows <= 0 || M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(rows, M, K, N, splits) || (N + fwp::BN - 1) / fwp::BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nK = static_cast<int>((K + tc::BK - 1) / tc::BK);
  const int nN = static_cast<int>((N + bfp::TILE_N - 1) / bfp::TILE_N);
  const int64_t row_elems = static_cast<int64_t>(nK) * nN * bfp::TILE;
  const int k_tiles = ((nK + splits - 1) / splits + fwp::KS - 1) / fwp::KS * fwp::KS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? partial : static_cast<float*>(out);
  const cudaError_t err = fwp::launch_product(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(tiles),
      dst, static_cast<int>(rows), static_cast<int>(M), static_cast<int>(K),
      static_cast<int>(N), nK, row_elems, k_tiles, splits, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(sum_splits<float>(
      partial, static_cast<float*>(out), rows * M * N, splits, s));
}

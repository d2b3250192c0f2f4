// Replaces the TPU kernel repro/kernels/fault_matmul.py:61
// fault_matmul_pallas (body _fault_matmul_kernel, :25-54):
// out = x @ (apply_fault(qw) * scale) with fp32 accumulation, the bit
// flips applied to the weight tile on chip so no corrupted weight matrix
// is ever written to memory.
//
// Port shape: x is [R, M, K] float32 (one candidate per row), qw is the
// shared (K, N) integer matrix, each row corrupts it at its own rate with
// idx = k * N + n in the unpadded matrix; out is [R, M, N] float32.
//
// Design: a shared-memory tiled SGEMM.  Per BK-slice, the block loads its
// x tile into shared memory (transposed, padded against bank conflicts),
// loads the int8/16/32 weight tile, corrupts and dequantizes it into
// shared memory as float, then every thread accumulates an 8x8 register
// tile with fp32 FMAs.  Ragged edges are masked to zero on load and on
// store.  No tensor cores: TF32 would break the fp32 tolerance.
//
// Split-K: at the main path's shapes (one row, M = 512) the 128x128 tiles
// are 32 blocks for 132 SMs, so K is cut into `splits` slices, each block
// writes its partial tile to a workspace, and a second kernel sums the
// slices in slice order: deterministic, no atomics, and the hash work per
// weight is unchanged (each slice hashes only its own rows of qw).
//
// Bound on the H100: the fp32 FMA rate (67 TFLOP/s without tensor cores)
// for the product, plus the hash, which this design recomputes once per
// 128-row block of x (M / 128 times per weight); both are far above the
// bytes.  With x = I_K every output is one exact product, so the kernel
// returns the corrupted, dequantized weights bitwise.
#include <cuda_runtime.h>

#include "faultmodel.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8, THREADS = 256;
constexpr int APAD = BM + 4;  // row stride of the transposed x tile

template <typename T, int MODEL>
__global__ void __launch_bounds__(THREADS)
fault_matmul_kernel(const float* __restrict__ x, const T* __restrict__ qw,
                    float* __restrict__ out, const float* __restrict__ scale_p,
                    const float* __restrict__ rate_p, int rows, int M, int K,
                    int N, int k_chunk, uint32_t seed, int faulty_bits,
                    int mbu_width) {
  __shared__ __align__(16) float As[BK][APAD];
  __shared__ __align__(16) float Bs[BK][BN];
  const int row = blockIdx.z % rows, split = blockIdx.z / rows;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = split * k_chunk, k_end = min(K, k_begin + k_chunk);
  const float scale = *scale_p, rate = rate_p[row];
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
                                            seed, rate, faulty_bits, mbu_width);
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

// out[i] = sum over s of partial[s][i], in slice order.
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int64_t n,
                                  int splits) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float acc = partial[i];
    for (int s = 1; s < splits; ++s) acc += partial[s * n + i];
    out[i] = acc;
  }
}

}  // namespace

// x: rows x M x K float32; qw: K x N integers of `qbytes` bytes; out:
// rows x M x N float32; scale: one float32; rate: rows float32.  With
// splits > 1, partial is a splits x rows x M x N float32 workspace.
extern "C" int afp_fault_matmul(const float* x, const void* qw, float* out,
                                float* partial, const float* scale,
                                const float* rate, int64_t rows, int64_t M,
                                int64_t K, int64_t N, int splits, int qbytes,
                                int model, uint32_t seed, int faulty_bits,
                                int mbu_width, void* stream) {
  if (rows <= 0 || M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (splits < 1 || rows * splits > 65535 || M > (1LL << 30) ||
      K > (1LL << 30) || N > (1LL << 30) || K * N > 0xFFFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t k_steps = (K + BK - 1) / BK;
  const int k_chunk = static_cast<int>((k_steps + splits - 1) / splits * BK);
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>(rows * splits));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? partial : out;
  AFP_DISPATCH_INT(qbytes, AFP_DISPATCH_MODEL(model,
      fault_matmul_kernel<QT, MODEL><<<grid, THREADS, 0, s>>>(
          x, static_cast<const QT*>(qw), dst, scale, rate,
          static_cast<int>(rows), static_cast<int>(M), static_cast<int>(K),
          static_cast<int>(N), k_chunk, seed, faulty_bits, mbu_width)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t n = rows * M * N;
  const int64_t blocks = (n + 255) / 256;
  sum_splits_kernel<<<static_cast<unsigned>(blocks < 132 * 8 ? blocks : 132 * 8),
                      256, 0, s>>>(partial, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

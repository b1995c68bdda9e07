// Sparse matrix product in ELL layout for the large-mesh CG step, for Hopper
// (sm_90a).
//
// Replaces meshdqn_tpu/ops/pallas_kernels.py:ell_matvec_pallas (_ell_kernel):
//
//   ell_matmat_{f32,f64}:  Y[r, c] = sum_k vals[r, k] * X[cols[r, k], c]
//
// cols (R, K) int32, vals (R, K), X (n, m), Y (R, m), m in {1, 2}, all
// row-major and contiguous.  Pad entries (col 0, val 0) are summed like the
// others, so the arithmetic is the plain version's.
//
// Bound: bytes.  Each (col, val) pair is read once: R * K * (4 + 4 or 8)
// bytes.  X is at most ~30k rows (240 KB in f64, m = 2: 480 KB) and is
// gathered from L2 after its first touch, so its device-memory traffic is
// n * m * sizeof(T) once.  The design:
//   * one warp per row; lane l takes entries l, l + 32, ... of the row, so a
//     warp's loads of cols and vals are contiguous (K = 50-56 for the
//     velocity systems: two rounds, the second partial; K need not be a
//     multiple of anything);
//   * X is gathered through the read-only data cache (__ldg);
//   * per-lane sums in T, reduced by a fixed xor-shuffle tree; no atomics and
//     no split of a row, so the result repeats bit for bit.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError()
// after its launch (0 on success).  The caller allocates Y and owns the
// stream; nothing here synchronises or allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    ell_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
               const T* __restrict__ X, T* __restrict__ Y, int R, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // whole warps leave together; no barrier follows

  const size_t base = static_cast<size_t>(row) * K;
  T acc[M];
#pragma unroll
  for (int c = 0; c < M; ++c) acc[c] = T(0);
  for (int k = lane; k < K; k += 32) {
    const int col = __ldcs(cols + base + k);
    const T v = __ldcs(vals + base + k);
#pragma unroll
    for (int c = 0; c < M; ++c)
      acc[c] = fma_t(v, __ldg(X + static_cast<size_t>(col) * M + c), acc[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < M; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < M; ++c) Y[static_cast<size_t>(row) * M + c] = acc[c];
  }
}

template <typename T>
cudaError_t launch(const int* cols, const T* vals, const T* X, T* Y, int R,
                   int K, int m, cudaStream_t stream) {
  if (R < 0 || K < 1 || (m != 1 && m != 2)) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (m == 1)
    ell_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(cols, vals, X, Y, R, K);
  else
    ell_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(cols, vals, X, Y, R, K);
  return cudaGetLastError();
}

}  // namespace

// n (the rows of X) is not read by the kernel: the caller guarantees
// 0 <= cols < n.  It is part of the interface so that a launch states its
// operands' shapes in full.
extern "C" int ell_matmat_f32(const int* cols, const float* vals,
                              const float* X, float* Y, int R, int K, int n,
                              int m, void* stream) {
  (void)n;
  return launch<float>(cols, vals, X, Y, R, K, m,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ell_matmat_f64(const int* cols, const double* vals,
                              const double* X, double* Y, int R, int K, int n,
                              int m, void* stream) {
  (void)n;
  return launch<double>(cols, vals, X, Y, R, K, m,
                        static_cast<cudaStream_t>(stream));
}

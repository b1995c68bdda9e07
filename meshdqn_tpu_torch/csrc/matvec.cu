// Dense f32 matrix-vector product for the fused IPCS step, for Hopper (sm_90a).
//
// Replaces meshdqn_tpu/ops/pallas_kernels.py:matvec_pallas (_mv_kernel) with
// matvec_f32, and matvec_dual_pallas (_mv_dual_kernel) with matvec_dual_f32:
//
//   matvec_f32:       y = M @ x                 M (R, N), x (N, k), y (R, k)
//   matvec_dual_f32:  y = M @ x_hi + M @ x_lo   (M read once)
//
// with k in {1, 2}, all row-major f32, true f32 FMA (no TF32, no tensor
// cores: a matvec does 2 flops per 4-byte matrix entry, so there is no reuse
// for them to exploit).
//
// Bound: bytes.  Every entry of M is used once, so the least time is
// R * N * 4 bytes over the device-memory rate; x and y are a few KB.  The
// design streams M once, coalesced, and keeps everything else on chip:
//   * each block first copies x (and x_lo) into shared memory, so the only
//     device-memory traffic in the main loop is M itself;
//   * one warp per output row; lanes read consecutive 16-byte float4s of the
//     row, kUnroll loads in flight per lane, with the streaming cache hint
//     (M is not reused within a step, and a step's operators exceed L2);
//   * rows whose start is not 16-byte aligned (N % 4 != 0) get a scalar head
//     of at most 3 entries, and a scalar tail of at most 3; nothing is read
//     past the row;
//   * each lane keeps its own partial sums, reduced by a fixed xor-shuffle
//     tree; no atomics and no split of a row across blocks, so the result is
//     bit-reproducible from run to run.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError()
// after its launch (0 on success).  The caller allocates y and owns the
// stream; nothing here synchronises or allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kUnroll = 4;
// Shared memory a block may use on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;

template <int K, bool DUAL>
__device__ __forceinline__ void fma_entry(float m, int c, const float* xs,
                                          int nx, float (&hi)[K],
                                          float (&lo)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    hi[j] = fmaf(m, xs[c * K + j], hi[j]);
    if (DUAL) lo[j] = fmaf(m, xs[nx + c * K + j], lo[j]);
  }
}

template <int K, bool DUAL>
__global__ void __launch_bounds__(kThreads)
    matvec_kernel(const float* __restrict__ M, const float* __restrict__ x_hi,
                  const float* __restrict__ x_lo, float* __restrict__ y, int R,
                  int N) {
  extern __shared__ float xs[];  // [x_hi (N*K) | x_lo (N*K) when DUAL]
  const int nx = N * K;
  for (int i = threadIdx.x; i < nx; i += kThreads) {
    xs[i] = __ldg(x_hi + i);
    if (DUAL) xs[nx + i] = __ldg(x_lo + i);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // whole warps leave together; no barrier follows

  const float* mrow = M + static_cast<size_t>(row) * N;
  float hi[K], lo[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    hi[j] = 0.0f;
    lo[j] = 0.0f;
  }

  // Scalar head up to the first 16-byte boundary of the row.
  int head = static_cast<int>(
      ((16u - (static_cast<uint32_t>(reinterpret_cast<uintptr_t>(mrow)) & 15u)) &
       15u) >> 2);
  if (head > N) head = N;
  if (lane < head) fma_entry<K, DUAL>(__ldcs(mrow + lane), lane, xs, nx, hi, lo);

  // Aligned float4 body.
  const int nvec = (N - head) >> 2;
  const float4* mv = reinterpret_cast<const float4*>(mrow + head);
  int v = lane;
  for (; v + (kUnroll - 1) * 32 < nvec; v += kUnroll * 32) {
    float4 m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m[u] = __ldcs(mv + v + u * 32);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = head + 4 * (v + u * 32);
      fma_entry<K, DUAL>(m[u].x, c, xs, nx, hi, lo);
      fma_entry<K, DUAL>(m[u].y, c + 1, xs, nx, hi, lo);
      fma_entry<K, DUAL>(m[u].z, c + 2, xs, nx, hi, lo);
      fma_entry<K, DUAL>(m[u].w, c + 3, xs, nx, hi, lo);
    }
  }
  for (; v < nvec; v += 32) {
    const float4 m = __ldcs(mv + v);
    const int c = head + 4 * v;
    fma_entry<K, DUAL>(m.x, c, xs, nx, hi, lo);
    fma_entry<K, DUAL>(m.y, c + 1, xs, nx, hi, lo);
    fma_entry<K, DUAL>(m.z, c + 2, xs, nx, hi, lo);
    fma_entry<K, DUAL>(m.w, c + 3, xs, nx, hi, lo);
  }

  // Scalar tail (fewer than 4 entries).
  const int t = head + 4 * nvec + lane;
  if (t < N) fma_entry<K, DUAL>(__ldcs(mrow + t), t, xs, nx, hi, lo);

  // Fixed-order butterfly: every lane ends with the same total.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      hi[j] += __shfl_xor_sync(0xffffffffu, hi[j], off);
      if (DUAL) lo[j] += __shfl_xor_sync(0xffffffffu, lo[j], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      y[static_cast<size_t>(row) * K + j] = DUAL ? hi[j] + lo[j] : hi[j];
  }
}

template <int K, bool DUAL>
cudaError_t launch(const float* M, const float* x_hi, const float* x_lo,
                   float* y, int R, int N, cudaStream_t stream) {
  const int smem = N * K * (DUAL ? 2 : 1) * static_cast<int>(sizeof(float));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  // Above 48 KB dynamic shared memory must be enabled per kernel; remember
  // the largest size granted so the attribute is set once per size class.
  static int granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        matvec_kernel<K, DUAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  if (R == 0) return cudaSuccess;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  matvec_kernel<K, DUAL><<<blocks, kThreads, smem, stream>>>(M, x_hi, x_lo, y,
                                                              R, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int matvec_f32(const float* M, const float* x, float* y, int R,
                          int N, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) return launch<1, false>(M, x, nullptr, y, R, N, s);
  if (k == 2) return launch<2, false>(M, x, nullptr, y, R, N, s);
  return cudaErrorInvalidValue;
}

extern "C" int matvec_dual_f32(const float* M, const float* x_hi,
                               const float* x_lo, float* y, int R, int N, int k,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) return launch<1, true>(M, x_hi, x_lo, y, R, N, s);
  if (k == 2) return launch<2, true>(M, x_hi, x_lo, y, R, N, s);
  return cudaErrorInvalidValue;
}

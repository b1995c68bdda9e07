// Sparse matrix product in ELL layout for the large-mesh CG step, for Hopper
// (sm_90a).
//
// Replaces meshdqn_tpu/ops/pallas_kernels.py:ell_matvec_pallas (_ell_kernel):
//
//   ell_matmat_{f32,f64}:  Y[r, c] = sum_k vals[r, k] * X[cols[r, k], c]
//
// for X (n, m), Y (R, m), m in {1, 2}, row-major and contiguous.  The matrix
// comes packed by slices (ops/sparse.py EllSlices): rows in slices of 32
// consecutive rows, slice s stored from offsets[s] at its own width
// w = widths[s], the ELL rows' trailing pads dropped; or, when uniform > 0,
// every slice at that width from s * 32 * uniform, and then the kernel loads
// neither offsets nor widths.  A row takes G lanes
// (G = lanes, a power of two); the slice is G groups of 32/G rows, group q
// from offsets[s] + q * (32/G) * w, read in steps t < T = ceil(w / G):
//
//   step t of group q:  group start + t * 32 + p * g_t + j,
//                       g_t = min(G, w - t * G), j < g_t,
//
// lane = p * G + j holding entry k = t * G + j of row s * 32 + q * 32/G + p.
// Entries past a row's width are (col 0, val 0) and are summed like the
// others.
//
// Bound: bytes.  Each stored (col, val) pair is read once: 0.8-0.9 of them
// are real where the slices take their own widths (the solver's 25k- to
// 30k-row operators), against 0.4-0.5 of the ELL arrays.
// X is at most ~30k rows (480 KB in f64 with m = 2) and is gathered from L2
// after its first touch.  The design:
//   * the data loads' addresses come from the slice's offset and width: a
//     dependent round trip before any data, unless the slices are uniform
//     (EllSlices stores them so where slicing would save few bytes, as on
//     the 3796-row operators, whose cold launches that round trip holds);
//   * one warp per group, 32/G rows, eight warps a block (four were a
//     little slower on every operator); at each step its lanes read
//     consecutive entries (128 bytes of columns, 128 or 256 of values, less
//     at a row's last step), so the loads coalesce whatever G is;
//   * each lane issues the loads of up to kSteps steps (64 entries of a row
//     for G >= 4) before it gathers X; all loads take the read-only path
//     (__ldg), with the default cache policy: PCG's next product reads the
//     same slices, which fit in L2 (an evict-first hint was no faster);
//   * the row sum keeps the order of the one-warp-per-row kernel this one
//     replaced, so the bits do not change: entry k goes to leaf k mod 32, a
//     leaf is the FMA chain over its entries k, k + 32, ... from +0, and the
//     32 leaves are summed by the xor tree with offsets 16, 8, 4, 2, 1.  Lane
//     j of a row holds leaves j, j + G, j + 2G, ... (step t feeds leaf slot
//     t mod 32/G), sums them in registers in the tree's pairing for the
//     offsets >= G, and shuffles for the offsets < G.  No atomics and no
//     split of a row, so the result repeats bit for bit.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError()
// after its launch (0 on success).  The caller allocates Y and owns the
// stream; nothing here synchronises or allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSliceRows = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int M, int G>
__global__ void __launch_bounds__(kThreads) ell_kernel(
    const int* __restrict__ cols, const T* __restrict__ vals,
    const int* __restrict__ offsets, const int* __restrict__ widths,
    const T* __restrict__ X, T* __restrict__ Y, int R, int uniform, int n_warps) {
  constexpr int kLeaves = 32 / G;  // leaf slots a lane holds
  // Steps whose loads a lane issues before its gathers: two rounds of 32
  // entries of a row where the registers allow, one for G = 1 and 2.
  constexpr int kSteps = kLeaves * (G >= 4 ? 2 : 1);

  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= n_warps) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int slice = warp / G;
  const int group = warp % G;
  const int p = lane / G, j = lane % G;
  const int row = slice * kSliceRows + group * kLeaves + p;
  const int w = uniform > 0 ? uniform : __ldg(widths + slice);
  const int steps = (w + G - 1) / G;
  const int full = steps - 1;           // the steps where a row has G entries
  const int tail = w - full * G;        // g_t of the last step
  const bool in_tail = j < tail;        // does this lane load at the last step
  // Entry indices fit in int (EllSlices holds fewer than 2^31 entries, the
  // wrapper fewer than 2^31 elements of X): 32-bit arithmetic keeps the
  // chain before the first load short.
  const int start = uniform > 0 ? slice * kSliceRows * uniform
                                : __ldg(offsets + slice);
  const int base = start + group * kLeaves * w;
  const int tail_at = base + full * 32 + p * tail + j;

  T acc[kLeaves][M];
#pragma unroll
  for (int i = 0; i < kLeaves; ++i)
#pragma unroll
    for (int c = 0; c < M; ++c) acc[i][c] = T(0);

  for (int t0 = 0; t0 < steps; t0 += kSteps) {
    const int at0 = base + t0 * 32 + lane;
    int col[kSteps];
    T v[kSteps];
    bool live[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = t0 + i;
      live[i] = t < full || (t == full && in_tail);
      const int at = t < full ? at0 + i * 32 : tail_at;
      col[i] = live[i] ? __ldg(cols + at) : 0;
      v[i] = live[i] ? __ldg(vals + at) : T(0);
    }
    // t0 is a multiple of kLeaves, so step t0 + i feeds slot i % kLeaves, and
    // a slot's steps arrive in rising order.
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (live[i]) {
#pragma unroll
        for (int c = 0; c < M; ++c)
          acc[i % kLeaves][c] = fma_t(
              v[i], __ldg(X + col[i] * M + c), acc[i % kLeaves][c]);
      }
    }
  }

  // The xor tree: offsets 16 ... G pair slots h apart in registers, the
  // offsets below G pair lanes by shuffles within the row's G lanes.
#pragma unroll
  for (int h = kLeaves / 2; h >= 1; h /= 2)
#pragma unroll
    for (int i = 0; i < h; ++i)
#pragma unroll
      for (int c = 0; c < M; ++c) acc[i][c] = acc[i][c] + acc[i + h][c];
#pragma unroll
  for (int off = G / 2; off >= 1; off /= 2)
#pragma unroll
    for (int c = 0; c < M; ++c)
      acc[0][c] += __shfl_xor_sync(0xffffffffu, acc[0][c], off);

  if (j == 0 && row < R) {
#pragma unroll
    for (int c = 0; c < M; ++c) Y[static_cast<size_t>(row) * M + c] = acc[0][c];
  }
}

template <typename T, int M, int G>
void launch_g(const int* cols, const T* vals, const int* offsets,
              const int* widths, const T* X, T* Y, int R, int uniform,
              int n_warps, cudaStream_t stream) {
  const int blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ell_kernel<T, M, G><<<blocks, kThreads, 0, stream>>>(
      cols, vals, offsets, widths, X, Y, R, uniform, n_warps);
}

template <typename T, int M>
cudaError_t launch_m(const int* cols, const T* vals, const int* offsets,
                     const int* widths, const T* X, T* Y, int R, int lanes,
                     int uniform, cudaStream_t stream) {
  const int n_warps = (R + kSliceRows - 1) / kSliceRows * lanes;
  switch (lanes) {
    case 1: launch_g<T, M, 1>(cols, vals, offsets, widths, X, Y, R, uniform, n_warps, stream); break;
    case 2: launch_g<T, M, 2>(cols, vals, offsets, widths, X, Y, R, uniform, n_warps, stream); break;
    case 4: launch_g<T, M, 4>(cols, vals, offsets, widths, X, Y, R, uniform, n_warps, stream); break;
    case 8: launch_g<T, M, 8>(cols, vals, offsets, widths, X, Y, R, uniform, n_warps, stream); break;
    case 16: launch_g<T, M, 16>(cols, vals, offsets, widths, X, Y, R, uniform, n_warps, stream); break;
    case 32: launch_g<T, M, 32>(cols, vals, offsets, widths, X, Y, R, uniform, n_warps, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const int* cols, const T* vals, const int* offsets,
                   const int* widths, const T* X, T* Y, int R, int m, int lanes,
                   int uniform, cudaStream_t stream) {
  if (R < 0 || uniform < 0 || (m != 1 && m != 2)) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  if (m == 1)
    return launch_m<T, 1>(cols, vals, offsets, widths, X, Y, R, lanes, uniform, stream);
  return launch_m<T, 2>(cols, vals, offsets, widths, X, Y, R, lanes, uniform, stream);
}

}  // namespace

// n (the rows of X) is not read by the kernel: the caller guarantees
// 0 <= cols < n (EllSlices checks it when made).  It is part of the
// interface so that a launch states its operands' shapes in full.
extern "C" int ell_matmat_f32(const int* cols, const float* vals,
                              const int* offsets, const int* widths,
                              const float* X, float* Y, int R, int n, int m,
                              int lanes, int uniform, void* stream) {
  (void)n;
  return launch<float>(cols, vals, offsets, widths, X, Y, R, m, lanes, uniform,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ell_matmat_f64(const int* cols, const double* vals,
                              const int* offsets, const int* widths,
                              const double* X, double* Y, int R, int n, int m,
                              int lanes, int uniform, void* stream) {
  (void)n;
  return launch<double>(cols, vals, offsets, widths, X, Y, R, m, lanes, uniform,
                        static_cast<cudaStream_t>(stream));
}

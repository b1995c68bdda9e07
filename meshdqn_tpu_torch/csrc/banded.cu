// Banded-block sparse matrix product for the large-mesh CG step, for Hopper
// (sm_90a).
//
// Replaces, in meshdqn_tpu/ops/pallas_kernels.py, banded_matmat_pallas
// (_banded_kernel: plain window layout) and banded_matmat_pallas_aligned
// (_banded_aligned_kernel: 128-aligned windows), and the R = 128 banded SpMV
// of scripts/banded_formulation_bench.py:make_pl_kernel (f32 or bf16
// blocks), which is the aligned product at g = 128, m = 1:
//
//   banded_matmat_{f32,bf16,f64}:
//     Y[b*R + i, c] = sum_j blocks[b, i, j] * x(s_b + j - pad, c)
//
// blocks (B, R, W) row-major, X (n_cols, m), Y (n_rows, m), m in {1, 2};
// s_b = aligned ? floor(b*g / 128) * 128 : b*g is block b's window start in
// padded coordinates, and x(k, c) = X[k, c] for 0 <= k < n_cols, else 0.
// Rows at or past n_rows (the last block's ragged tail) are not written.
// f32 and bf16 blocks take and give f32 X and Y and accumulate in f32 (a
// bf16 entry widens to f32 exactly); f64 blocks work in f64.
//
// Bound: bytes.  Every stored entry of blocks is used once (B*R*W entries,
// most of them zeros of the band's fill), while X and Y are a few hundred KB.
// The design streams blocks once and keeps x on chip:
//   * one block of threads per row-block b; it first copies b's window of x
//     (W*m values, zero outside [0, n_cols)) into shared memory, component
//     by component, so X is read in place with a bounds test and no padded
//     copy of it is ever made;
//   * 8 warps over the R rows; lanes read consecutive 16-byte vectors of a
//     row (4 f32, 8 bf16 or 2 f64 entries; W is a multiple of 8 and every
//     row starts 16-byte aligned), kUnroll loads in flight per lane, with the
//     streaming cache hint; the matching x entries come from shared memory as
//     16-byte vectors;
//   * per-lane sums are reduced by a fixed xor-shuffle tree; no atomics and
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
constexpr int kUnroll = 4;
// Shared memory a block may use on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;

struct bf16_bits {};  // tag: blocks hold bf16 bit patterns (uint16_t)

// Per block type: the stored element, the accumulation type, and how a
// 16-byte load of blocks unpacks into N accumulation-type values.
template <typename Tag> struct Blocks;

template <> struct Blocks<float> {
  using elem = float;
  using acc = float;
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float (&o)[N]) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
};

template <> struct Blocks<bf16_bits> {
  using elem = uint16_t;
  using acc = float;
  static constexpr int N = 8;
  // A bf16 value is the top half of the f32 with the same bits; each 32-bit
  // word holds two, the lower-addressed one in its low half.
  __device__ static void unpack(const uint4& r, float (&o)[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      o[2 * q] = __uint_as_float(w[q] << 16);
      o[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
};

template <> struct Blocks<double> {
  using elem = double;
  using acc = double;
  static constexpr int N = 2;
  __device__ static void unpack(const uint4& r, double (&o)[N]) {
    o[0] = __hiloint2double(static_cast<int>(r.y), static_cast<int>(r.x));
    o[1] = __hiloint2double(static_cast<int>(r.w), static_cast<int>(r.z));
  }
};

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// N consecutive window entries from shared memory (16-byte aligned).
template <int N>
__device__ __forceinline__ void load_window(const float* p, float (&o)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(p)[q];
    o[4 * q] = t.x;
    o[4 * q + 1] = t.y;
    o[4 * q + 2] = t.z;
    o[4 * q + 3] = t.w;
  }
}
template <int N>
__device__ __forceinline__ void load_window(const double* p, double (&o)[N]) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const double2 t = reinterpret_cast<const double2*>(p)[q];
    o[2 * q] = t.x;
    o[2 * q + 1] = t.y;
  }
}

template <typename Tag, int M>
__device__ __forceinline__ void fma_vector(const uint4& raw, const typename Blocks<Tag>::acc* xs,
                                           int W, int e0,
                                           typename Blocks<Tag>::acc (&acc)[M]) {
  using TA = typename Blocks<Tag>::acc;
  constexpr int N = Blocks<Tag>::N;
  TA a[N];
  Blocks<Tag>::unpack(raw, a);
#pragma unroll
  for (int c = 0; c < M; ++c) {
    TA x[N];
    load_window<N>(xs + c * W + e0, x);
#pragma unroll
    for (int q = 0; q < N; ++q) acc[c] = fma_t(a[q], x[q], acc[c]);
  }
}

template <typename Tag, int M>
__global__ void __launch_bounds__(kThreads)
    banded_kernel(const typename Blocks<Tag>::elem* __restrict__ blocks,
                  const typename Blocks<Tag>::acc* __restrict__ X,
                  typename Blocks<Tag>::acc* __restrict__ Y, int R, int W,
                  int g, int pad, int aligned, int n_rows, int n_cols) {
  using TA = typename Blocks<Tag>::acc;
  constexpr int N = Blocks<Tag>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  TA* xs = reinterpret_cast<TA*>(smem);  // [M][W]: component c at xs + c*W

  const long long b = blockIdx.x;
  const long long bg = b * g;
  // x index of window entry 0 (may be negative: the zero padding).
  const long long start = (aligned ? (bg / 128) * 128 : bg) - pad;
  for (int j = threadIdx.x; j < W; j += kThreads) {
    const long long k = start + j;
    const bool in = k >= 0 && k < n_cols;
#pragma unroll
    for (int c = 0; c < M; ++c) xs[c * W + j] = in ? __ldg(X + k * M + c) : TA(0);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nvec = W / N;
  for (int i = threadIdx.x >> 5; i < R; i += kWarpsPerBlock) {
    const long long row = b * R + i;
    if (row >= n_rows) break;  // rows ascend with i; the test is warp-uniform
    const uint4* brow = reinterpret_cast<const uint4*>(blocks + row * W);
    TA acc[M];
#pragma unroll
    for (int c = 0; c < M; ++c) acc[c] = TA(0);
    int v = lane;
    for (; v + (kUnroll - 1) * 32 < nvec; v += kUnroll * 32) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) raw[u] = __ldcs(brow + v + u * 32);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        fma_vector<Tag, M>(raw[u], xs, W, (v + u * 32) * N, acc);
    }
    for (; v < nvec; v += 32) fma_vector<Tag, M>(__ldcs(brow + v), xs, W, v * N, acc);

    // Fixed-order butterfly: every lane ends with the same total.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < M; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < M; ++c) Y[row * M + c] = acc[c];
    }
  }
}

template <typename Tag, int M>
cudaError_t launch_m(const typename Blocks<Tag>::elem* blocks,
                     const typename Blocks<Tag>::acc* X,
                     typename Blocks<Tag>::acc* Y, int B, int R, int W, int g,
                     int pad, int aligned, int n_rows, int n_cols,
                     cudaStream_t stream) {
  const int smem = M * W * static_cast<int>(sizeof(typename Blocks<Tag>::acc));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  // Above 48 KB dynamic shared memory must be enabled per kernel; remember
  // the largest size granted so the attribute is set once per size class.
  static int granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        banded_kernel<Tag, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  if (B == 0 || n_rows == 0) return cudaSuccess;
  banded_kernel<Tag, M><<<B, kThreads, smem, stream>>>(blocks, X, Y, R, W, g, pad,
                                                       aligned, n_rows, n_cols);
  return cudaGetLastError();
}

template <typename Tag>
cudaError_t launch(const void* blocks, const void* X, void* Y, int B, int R,
                   int W, int g, int pad, int aligned, int n_rows, int n_cols,
                   int m, void* stream) {
  using TE = typename Blocks<Tag>::elem;
  using TA = typename Blocks<Tag>::acc;
  if (B < 0 || R < 1 || W < 8 || W % 8 != 0 || g < 1 || pad < 0 ||
      n_rows < 0 || n_rows > static_cast<long long>(B) * R || n_cols < 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(blocks) % 16 != 0) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TE* bl = static_cast<const TE*>(blocks);
  const TA* x = static_cast<const TA*>(X);
  TA* y = static_cast<TA*>(Y);
  if (m == 1) return launch_m<Tag, 1>(bl, x, y, B, R, W, g, pad, aligned, n_rows, n_cols, s);
  if (m == 2) return launch_m<Tag, 2>(bl, x, y, B, R, W, g, pad, aligned, n_rows, n_cols, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int banded_matmat_f32(const float* blocks, const float* X, float* Y,
                                 int B, int R, int W, int g, int pad,
                                 int aligned, int n_rows, int n_cols, int m,
                                 void* stream) {
  return launch<float>(blocks, X, Y, B, R, W, g, pad, aligned, n_rows, n_cols,
                       m, stream);
}

// blocks: bf16 bit patterns; X and Y are f32.
extern "C" int banded_matmat_bf16(const uint16_t* blocks, const float* X,
                                  float* Y, int B, int R, int W, int g, int pad,
                                  int aligned, int n_rows, int n_cols, int m,
                                  void* stream) {
  return launch<bf16_bits>(blocks, X, Y, B, R, W, g, pad, aligned, n_rows,
                           n_cols, m, stream);
}

extern "C" int banded_matmat_f64(const double* blocks, const double* X,
                                 double* Y, int B, int R, int W, int g,
                                 int pad, int aligned, int n_rows, int n_cols,
                                 int m, void* stream) {
  return launch<double>(blocks, X, Y, B, R, W, g, pad, aligned, n_rows, n_cols,
                        m, stream);
}

// Banded sparse matrix product over the band's nonempty tiles, for the
// large-mesh CG step, for Hopper (sm_90a).
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
// blocks (B, R, W), X (n_cols, m), Y (n_rows, m), m in {1, 2}, row-major;
// s_b = aligned ? floor(b*g / 128) * 128 : b*g is block b's window start in
// padded coordinates, and x(k, c) = X[k, c] for 0 <= k < n_cols, else 0.
// Rows at or past n_rows (the last block's ragged tail) are not written.
// f32 and bf16 blocks take and give f32 X and Y and accumulate in f32 (a
// bf16 entry widens to f32 exactly); f64 blocks work in f64.  bf16 blocks
// in the plain window layout compute what the JAX package's banded_matmat
// (meshdqn_tpu/ops/banded.py:241) computes there: x rounded to bf16 and
// each product rounded to bf16 (to nearest even) before the f32 sum; in the
// aligned layout x stays f32 and the products exact, as in
// banded_matmat_pallas_aligned and make_pl_kernel.
//
// The kernel never reads the dense blocks.  It reads their nonempty tiles
// (ops/banded.py BandTiles): each row's window is cut into 128-byte column
// tiles (T = 32 f32, 64 bf16 or 16 f64 entries); the nonempty ones are
// stored contiguously, row after row, with one int32 offset per row and one
// int32 column-tile index per tile.
//
// Bound: bytes.  The blocks hold 80-220x the operators' nonzeros; on the
// finest meshes 2-12% of a window's 128-byte row segments hold a nonzero,
// so the tiles and their index are 8-45x fewer bytes than the blocks.  No
// tensor cores: with m <= 2 columns the product does 2m flops for each
// stored entry (0.5-1 flop a byte in f32), far below the card's ridge point
// (~20 flop/byte on the f32 cores, ~295 on the bf16 tensor cores), and an
// MMA would pad the m columns to 8.  At these sizes (2-15 MB a product) a
// launch is as much latency as bytes: each warp waits for its offsets, then
// its tiles.  The design:
//   * one warp per 8 rows, up to 4 warps per block: the largest of 4, 2, 1
//     that divides R/8, so a block's rows lie in one row block and share
//     its x window.  At R = 128, ceil(n_rows / 32) blocks, 931 for a
//     29,768-row operator, several waves on 132 SMs (one block per 128-row
//     block, the earlier design, left the 14,884-row operators under one);
//   * lanes 8k..8k+7 take rows k and k + 4 of the warp; lane l reads the
//     16-byte chunk l%8 of each 128-byte tile, so 8 lanes read one
//     segment whole; kUnroll tiles of each row are loaded before their
//     arithmetic.  The loads skip L1 and keep the default L2 policy, so an
//     operator whose tiles fit in L2 beside the PCG's other operands can be
//     found there by the next apply of the same solve;
//   * x: the block stages its row block's window, W*m values of X (zero
//     outside [0, n_cols), so windows off either end cost nothing and no
//     padded copy of X is made), into shared memory with asynchronous copies
//     (cp.async) issued after the offsets' loads and waited for after the
//     first tiles' loads, so the copy overlaps both round trips; a lane then
//     reads its x values as 16-byte vectors without bank conflicts.  This
//     beat reading x through L1 by column tile on every operator of the step;
//   * each lane sums its rows' tiles in order; the 8 lanes of a row are
//     reduced by a fixed xor-shuffle tree (4, 2, 1); no atomics and no split
//     of a row across warps, so results repeat bit for bit.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError()
// after its launch (0 on success).  The caller allocates Y and owns the
// stream; nothing here synchronises or allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpRows = 8;   // rows of a row block one warp computes
constexpr int kVecPerRow = 8;  // 16-byte vectors in a 128-byte tile row
constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kUnroll = 3;  // tiles of each of a lane's two lists in flight
// Shared memory a block may use on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;

struct bf16_bits {};  // tag: blocks hold bf16 bit patterns (uint16_t)

// Per block type: the accumulation type, and how a 16-byte load of tiles
// unpacks into N accumulation-type values.
template <typename Tag> struct Blocks;

template <> struct Blocks<float> {
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

// x rounded to bf16 (to nearest even), back in f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// c + a * b, or with kRound (bf16 a and b) c + bf16(a * b): the product of
// two bf16 values is exact in f32, then rounded to bf16 as the JAX
// package's bf16 multiply rounds it; explicitly rounded, so it is never
// contracted into an FMA.
template <bool kRound, typename T>
__device__ __forceinline__ T mac(T a, T b, T c) {
  if constexpr (kRound) {
    return __fadd_rn(c, round_bf16(__fmul_rn(a, b)));
  } else {
    return fma_t(a, b, c);
  }
}

// 16 bytes of packed tiles: not allocated in L1, default L2 policy.
__device__ __forceinline__ uint4 load_tile_vec(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// 16 bytes of x values from shared memory, p 16-byte aligned.
__device__ __forceinline__ void lds16(const float* p, float* o) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}
__device__ __forceinline__ void lds16(const double* p, double* o) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  o[0] = t.x;
  o[1] = t.y;
}

// acc[c] += sum over the vector's N entries a[n] * x[n*M + c], in order.
template <typename Tag, int M, bool kRound>
__device__ __forceinline__ void fma_vector(const uint4& raw,
                                           typename Blocks<Tag>::acc (&x)[Blocks<Tag>::N * M],
                                           typename Blocks<Tag>::acc (&acc)[M]) {
  using TA = typename Blocks<Tag>::acc;
  constexpr int N = Blocks<Tag>::N;
  TA a[N];
  Blocks<Tag>::unpack(raw, a);
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int c = 0; c < M; ++c) acc[c] = mac<kRound>(a[n], x[n * M + c], acc[c]);
  }
}

// x index of window column 0 of row block b (may be negative: the padding).
__device__ __forceinline__ long long window_start(long long b, int g, int pad,
                                                  int aligned) {
  const long long bg = b * g;
  return (aligned ? (bg / 128) * 128 : bg) - pad;
}

// acc += one tile's 16-byte vector (the lane's chunk of column tile
// ct) times its x values from the staged window xs.
template <typename Tag, int M, bool kRound>
__device__ __forceinline__ void tile_fma(const uint4& raw, int ct, int n_ct, int chunk,
                                         const typename Blocks<Tag>::acc* xs,
                                         typename Blocks<Tag>::acc (&acc)[M]) {
  using TA = typename Blocks<Tag>::acc;
  constexpr int N = Blocks<Tag>::N;
  constexpr int L = N * M;
  const int j = min(max(ct, 0), n_ct - 1) * (N * kVecPerRow) + chunk * N;  // window column
  TA x[L];
#pragma unroll
  for (int p = 0; p < L; p += 16 / static_cast<int>(sizeof(TA))) lds16(xs + j * M + p, x + p);
  fma_vector<Tag, M, kRound>(raw, x, acc);
}

// One value of X into shared memory by an asynchronous copy (cp.async:
// no registers held while it flies), zero-filled when !in.
template <typename TA>
__device__ __forceinline__ void copy_async(TA* dst, const TA* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
               "n"(sizeof(TA)), "r"(in ? static_cast<int>(sizeof(TA)) : 0));
}

// Launched with blockDim.x = 32 * (warps per block), a divisor of
// R / kWarpRows: the rows of a block's warps lie in one row block and share
// its x window.  kRound: bf16 blocks in the plain layout (the header).
template <typename Tag, int M, bool kRound>
__global__ void __launch_bounds__(kThreads) banded_tiles_kernel(
    const uint4* __restrict__ tiles, const int* __restrict__ offsets,
    const int* __restrict__ cols, const typename Blocks<Tag>::acc* __restrict__ X,
    typename Blocks<Tag>::acc* __restrict__ Y, int R, int W, int g, int pad, int aligned,
    int n_rows, int n_cols, int n_tiles) {
  using TA = typename Blocks<Tag>::acc;
  const long long n_elem = static_cast<long long>(n_cols) * M;
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);  // warp's rows
  const long long row0 = static_cast<long long>(q) * kWarpRows;
  const long long start = window_start(row0 / R, g, pad, aligned);
  const int lane = threadIdx.x & 31;
  const int chunk = lane & 7;  // the lane's 16-byte column chunk of a tile
  const int n_ct = W / (Blocks<Tag>::N * kVecPerRow);  // column tiles of a window

  // The lane's rows a = row0 + lane/8 and b = a + 4 and their tile lists.
  // The offsets are read first: everything else waits on them.  A warp
  // past the last row (in the last block only) keeps empty lists.
  const long long ra = row0 + (lane >> 3), rb = ra + kWarpRows / 2;
  int lo_a = 0, hi_a = 0, lo_b = 0, hi_b = 0;
  if (row0 < n_rows) {  // clamped, so even a malformed index reads inside
    lo_a = min(max(offsets[ra], 0), n_tiles);
    hi_a = min(max(offsets[ra + 1], lo_a), n_tiles);
    lo_b = min(max(offsets[rb], 0), n_tiles);
    hi_b = min(max(offsets[rb + 1], lo_b), n_tiles);
  }

  // The block's window of x, W*M values zero outside X, flies into shared
  // memory while the offsets and the first tiles are on their way.
  extern __shared__ __align__(16) unsigned char smem[];
  TA* xs = reinterpret_cast<TA*>(smem);  // [W][M]: the window, interleaved as X
  for (int e = threadIdx.x; e < W * M; e += blockDim.x) {
    const long long k = start * M + e;
    const bool in = k >= 0 && k < n_elem;
    copy_async(xs + e, in ? X + k : X, in);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  const int steps = __reduce_max_sync(0xffffffffu, max(hi_a - lo_a, hi_b - lo_b));
  uint4 v_a[kUnroll], v_b[kUnroll];
  int c_a[kUnroll], c_b[kUnroll];
  auto load_chunk = [&](int t0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ta = lo_a + t0 + u, tb = lo_b + t0 + u;
      if (ta < hi_a) {
        v_a[u] = load_tile_vec(tiles + static_cast<long long>(ta) * kVecPerRow + chunk);
        c_a[u] = __ldg(cols + ta);
      }
      if (tb < hi_b) {
        v_b[u] = load_tile_vec(tiles + static_cast<long long>(tb) * kVecPerRow + chunk);
        c_b[u] = __ldg(cols + tb);
      }
    }
  };
  load_chunk(0);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if constexpr (kRound) {  // each thread rounds the values it copied
    for (int e = threadIdx.x; e < W * M; e += blockDim.x) xs[e] = round_bf16(xs[e]);
  }
  __syncthreads();

  TA acc_a[M], acc_b[M];
#pragma unroll
  for (int c = 0; c < M; ++c) acc_a[c] = acc_b[c] = TA(0);
  for (int t0 = 0; t0 < steps;) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (lo_a + t0 + u < hi_a)
        tile_fma<Tag, M, kRound>(v_a[u], c_a[u], n_ct, chunk, xs, acc_a);
      if (lo_b + t0 + u < hi_b)
        tile_fma<Tag, M, kRound>(v_b[u], c_b[u], n_ct, chunk, xs, acc_b);
    }
    t0 += kUnroll;
    if (t0 < steps) load_chunk(t0);
  }

  // Fixed-order butterfly over the 8 lanes of a row: each ends with the
  // same total.
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < M; ++c) {
      acc_a[c] += __shfl_xor_sync(0xffffffffu, acc_a[c], off);
      acc_b[c] += __shfl_xor_sync(0xffffffffu, acc_b[c], off);
    }
  }
  if (chunk == 0) {
#pragma unroll
    for (int c = 0; c < M; ++c) {
      if (ra < n_rows) Y[ra * M + c] = acc_a[c];
      if (rb < n_rows) Y[rb * M + c] = acc_b[c];
    }
  }
}

template <typename Tag, int M, bool kRound>
cudaError_t launch_m(const uint4* tiles, const int* offsets, const int* cols,
                     const typename Blocks<Tag>::acc* X,
                     typename Blocks<Tag>::acc* Y, int R, int W, int g, int pad,
                     int aligned, int n_rows, int n_cols, int n_tiles,
                     cudaStream_t stream) {
  const int smem = M * W * static_cast<int>(sizeof(typename Blocks<Tag>::acc));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  // Above 48 KB dynamic shared memory must be enabled per kernel; remember
  // the largest size granted so the attribute is set once per size class.
  static int granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(banded_tiles_kernel<Tag, M, kRound>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  if (n_rows == 0) return cudaSuccess;
  // The largest of 4, 2, 1 warps that divides the warps of a row block.
  int per_block = kWarpsPerBlock;
  while ((R / kWarpRows) % per_block != 0) per_block /= 2;
  const int warps = (n_rows + kWarpRows - 1) / kWarpRows;
  const int blocks = (warps + per_block - 1) / per_block;
  banded_tiles_kernel<Tag, M, kRound><<<blocks, 32 * per_block, smem, stream>>>(
      tiles, offsets, cols, X, Y, R, W, g, pad, aligned, n_rows, n_cols, n_tiles);
  return cudaGetLastError();
}

template <typename Tag>
cudaError_t launch(const void* tiles, const int* offsets, const int* cols,
                   const void* X, void* Y, int B, int R, int W, int g, int pad,
                   int aligned, int n_rows, int n_cols, int n_tiles, int m,
                   void* stream) {
  using TA = typename Blocks<Tag>::acc;
  constexpr int T = Blocks<Tag>::N * kVecPerRow;
  // kWarpRows divides R: a warp's rows lie in one row block.
  if (B < 0 || R < kWarpRows || R % kWarpRows != 0 || W < T || W % T != 0 ||
      g < 1 || pad < 0 || n_rows < 0 ||
      n_rows > static_cast<long long>(B) * R || n_cols < 0 || n_tiles < 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(tiles) % 16 != 0) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* t = static_cast<const uint4*>(tiles);
  const TA* x = static_cast<const TA*>(X);
  TA* y = static_cast<TA*>(Y);
  constexpr bool kBf16 = std::is_same<Tag, bf16_bits>::value;
  if (kBf16 && !aligned) {
    if (m == 1)
      return launch_m<Tag, 1, kBf16>(t, offsets, cols, x, y, R, W, g, pad, aligned,
                                     n_rows, n_cols, n_tiles, s);
    if (m == 2)
      return launch_m<Tag, 2, kBf16>(t, offsets, cols, x, y, R, W, g, pad, aligned,
                                     n_rows, n_cols, n_tiles, s);
    return cudaErrorInvalidValue;
  }
  if (m == 1)
    return launch_m<Tag, 1, false>(t, offsets, cols, x, y, R, W, g, pad, aligned, n_rows,
                                   n_cols, n_tiles, s);
  if (m == 2)
    return launch_m<Tag, 2, false>(t, offsets, cols, x, y, R, W, g, pad, aligned, n_rows,
                                   n_cols, n_tiles, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// tiles: (n_tiles, 32) packed f32 tiles; offsets (B*R + 1,) and cols
// (n_tiles,) int32 (ops/banded.py BandTiles); X and Y f32.
extern "C" int banded_matmat_f32(const float* tiles, const int* offsets,
                                 const int* cols, const float* X, float* Y,
                                 int B, int R, int W, int g, int pad,
                                 int aligned, int n_rows, int n_cols,
                                 int n_tiles, int m, void* stream) {
  return launch<float>(tiles, offsets, cols, X, Y, B, R, W, g, pad, aligned,
                       n_rows, n_cols, n_tiles, m, stream);
}

// tiles: (n_tiles, 64) bf16 bit patterns; X and Y are f32.
extern "C" int banded_matmat_bf16(const uint16_t* tiles, const int* offsets,
                                  const int* cols, const float* X, float* Y,
                                  int B, int R, int W, int g, int pad,
                                  int aligned, int n_rows, int n_cols,
                                  int n_tiles, int m, void* stream) {
  return launch<bf16_bits>(tiles, offsets, cols, X, Y, B, R, W, g, pad, aligned,
                           n_rows, n_cols, n_tiles, m, stream);
}

// tiles: (n_tiles, 16) f64; X and Y f64.
extern "C" int banded_matmat_f64(const double* tiles, const int* offsets,
                                 const int* cols, const double* X, double* Y,
                                 int B, int R, int W, int g, int pad,
                                 int aligned, int n_rows, int n_cols,
                                 int n_tiles, int m, void* stream) {
  return launch<double>(tiles, offsets, cols, X, Y, B, R, W, g, pad, aligned,
                        n_rows, n_cols, n_tiles, m, stream);
}

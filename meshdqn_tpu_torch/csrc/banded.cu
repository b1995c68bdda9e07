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
// The PCG iteration's products (banded_pcg_f32, f32 blocks, square
// operators; ops/cg.py pcg_fused) are two more instances of the same kernel,
// so every product of the step stays in banded_tiles_kernel:
//   * residual:  Y = B - A X0, the first product of a solve (X is X0);
//   * direction: X is Z, the preconditioned residual.  While its copies and
//     first tiles fly, the block sums the last update's r.z partials
//     (csrc/pcg.cu) and the ones before them in one fixed order, one warp a
//     sum, for beta = rz / rz_old per column (0 where rz_old <= 0, as pcg's
//     guard).  It stages the windows of Z and of the old direction side by
//     side and combines them there into P = Z + beta P_old, the product's
//     x.  It writes P for its own rows (from Z and P_old loaded at the
//     start, the same operands and rounding) into the other buffer of a
//     pair, so no block reads rows another block writes; then Y = A P, and
//     one p.Ap partial a block and column, summed in a fixed order.  With
//     no old direction (a solve's first), P = Z.
//   The products' sums are the plain instance's: A P has the bits of
//   banded_matmat_f32 on the same P.  P = Z + beta P_old and B - A X0 round
//   as torch's elementwise ops do (a multiply, then an add).
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

// What a launch adds to the product (the header): kProduct, the plain
// Y = A X; kResidual and kDirection, the PCG iteration's (f32 only).
enum PcgMode { kProduct = 0, kResidual = 1, kDirection = 2 };

// The PCG instances' operands; partials are [M][count], column-major.
struct PcgArgs {
  const float* B;       // kResidual: Y = B - A X0
  const float* P_old;   // kDirection: the old direction, or null (P = Z)
  float* P_new;         // kDirection: P, the block's own rows
  const float* rz;      // kDirection: the last update's r.z partials
  const float* rz_old;  // kDirection: the update's before it
  float* pap;           // kDirection: one p.Ap partial a block and column
  int n_rz;             // r.z partials a column
};

// p[0] + p[1] + ... + p[n-1] in one fixed order, by one warp: lane l adds
// p[l], p[l + 32], ... in turn (up to 32 loads in flight, so a sum of up to
// 1024 partials waits for one round trip), then a fixed xor tree; every lane
// ends with the same bits.  csrc/pcg.cu sums the same r.z partials with a
// copy of this function, so alpha and beta read one r.z.
__device__ __forceinline__ float warp_sum_fixed(const float* p, int n) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int i0 = 0; i0 < n; i0 += 32 * 32) {
    float v[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const int i = i0 + lane + 32 * u;
      v[u] = i < n ? p[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 32; ++u) s += v[u];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// num / den where den > 0, else 0: pcg's _guarded_div.
__device__ __forceinline__ float guarded_div(float num, float den) {
  return den > 0.f ? __fdiv_rn(num, den) : 0.f;
}

// P = Z + beta P_old, rounded as torch rounds it (a multiply, then an add).
__device__ __forceinline__ float direction(float z, float beta, float p_old) {
  return __fadd_rn(z, __fmul_rn(beta, p_old));
}

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
// kPcg: a PcgMode; the PCG modes take f32 blocks and square operators.
template <typename Tag, int M, bool kRound, int kPcg>
__global__ void __launch_bounds__(kThreads) banded_tiles_kernel(
    const uint4* __restrict__ tiles, const int* __restrict__ offsets,
    const int* __restrict__ cols, const typename Blocks<Tag>::acc* __restrict__ X,
    typename Blocks<Tag>::acc* __restrict__ Y, int R, int W, int g, int pad, int aligned,
    int n_rows, int n_cols, int n_tiles, PcgArgs pcg) {
  using TA = typename Blocks<Tag>::acc;
  static_assert(kPcg == kProduct || std::is_same<Tag, float>::value,
                "the PCG instances take f32 blocks");
  // kDirection: the r.z sums (rz, then rz_old, per column), then each
  // warp's p.Ap per column (in the PCG instances alone, so the plain ones
  // keep all their shared memory).
  float* pcg_s = nullptr;
  if constexpr (kPcg == kDirection) {
    __shared__ float direction_s[2 * M + kWarpsPerBlock * M];
    pcg_s = direction_s;
  }
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
  // kDirection: Z and the old direction at the lane's rows, for its rows
  // of P, on their way from the start.
  const bool has_prev = kPcg == kDirection && pcg.P_old != nullptr;
  float za[M], zb[M], qa[M], qb[M];
  if constexpr (kPcg == kDirection) {
#pragma unroll
    for (int c = 0; c < M; ++c) {
      za[c] = ra < n_rows ? X[ra * M + c] : 0.f;
      zb[c] = rb < n_rows ? X[rb * M + c] : 0.f;
      qa[c] = has_prev && ra < n_rows ? pcg.P_old[ra * M + c] : 0.f;
      qb[c] = has_prev && rb < n_rows ? pcg.P_old[rb * M + c] : 0.f;
    }
  }
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
  // kDirection: the old direction's window beside it, [W][M].
  for (int e = threadIdx.x; e < W * M; e += blockDim.x) {
    const long long k = start * M + e;
    const bool in = k >= 0 && k < n_elem;
    copy_async(xs + e, in ? X + k : X, in);
    if constexpr (kPcg == kDirection) {
      if (has_prev) copy_async(xs + W * M + e, in ? pcg.P_old + k : pcg.P_old, in);
    }
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
  // kDirection: the r.z sums while the copies and the tiles fly, one warp
  // a sum.
  if constexpr (kPcg == kDirection) {
    if (has_prev) {
      const int warps = blockDim.x >> 5;
      for (int q = threadIdx.x >> 5; q < 2 * M; q += warps) {
        const float sum = warp_sum_fixed((q < M ? pcg.rz : pcg.rz_old) + (q % M) * pcg.n_rz,
                                         pcg.n_rz);
        if (lane == 0) pcg_s[q] = sum;
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if constexpr (kRound) {  // each thread rounds the values it copied
    for (int e = threadIdx.x; e < W * M; e += blockDim.x) xs[e] = round_bf16(xs[e]);
  }
  __syncthreads();
  // kDirection: beta per column, the same bits in every thread, and the
  // window of P (e and k = start*M + e share the column).
  float beta[M];
  if constexpr (kPcg == kDirection) {
#pragma unroll
    for (int c = 0; c < M; ++c) beta[c] = has_prev ? guarded_div(pcg_s[c], pcg_s[M + c]) : 0.f;
    if (has_prev) {
      for (int e = threadIdx.x; e < W * M; e += blockDim.x)
        xs[e] = direction(xs[e], beta[e % M], xs[W * M + e]);
      __syncthreads();
    }
  }

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
  if constexpr (kPcg == kProduct) {
    if (chunk == 0) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        if (ra < n_rows) Y[ra * M + c] = acc_a[c];
        if (rb < n_rows) Y[rb * M + c] = acc_b[c];
      }
    }
  } else if constexpr (kPcg == kResidual) {
    if (chunk == 0) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        if (ra < n_rows) Y[ra * M + c] = __fsub_rn(pcg.B[ra * M + c], acc_a[c]);
        if (rb < n_rows) Y[rb * M + c] = __fsub_rn(pcg.B[rb * M + c], acc_b[c]);
      }
    }
  } else {
    // P at the lane's rows, as the window holds it (the same operands and
    // rounding, from the values loaded at the start), then the warp's p.Ap:
    // every lane of a row holds its total, so the tree over the four rows'
    // groups (8, 16) leaves every lane with the warp's sum.
    float v[M];
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const float pa = has_prev ? direction(za[c], beta[c], qa[c]) : za[c];
      const float pb = has_prev ? direction(zb[c], beta[c], qb[c]) : zb[c];
      if (chunk == 0) {
        if (ra < n_rows) {
          Y[ra * M + c] = acc_a[c];
          pcg.P_new[ra * M + c] = pa;
        }
        if (rb < n_rows) {
          Y[rb * M + c] = acc_b[c];
          pcg.P_new[rb * M + c] = pb;
        }
      }
      v[c] = __fmaf_rn(pb, acc_b[c], __fmul_rn(pa, acc_a[c]));
      v[c] += __shfl_xor_sync(0xffffffffu, v[c], 8);
      v[c] += __shfl_xor_sync(0xffffffffu, v[c], 16);
    }
    float* part_s = pcg_s + 2 * M;  // [warp][M]
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < M; ++c) part_s[warp * M + c] = v[c];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int warps = blockDim.x >> 5;
#pragma unroll
      for (int c = 0; c < M; ++c) {
        float s = part_s[c];
        for (int w = 1; w < warps; ++w) s += part_s[w * M + c];
        pcg.pap[c * gridDim.x + blockIdx.x] = s;
      }
    }
  }
}

// The blocks of one launch over n_rows rows of R-row blocks, and the
// threads of each: the largest of 4, 2, 1 warps that divides the warps of a
// row block (ops/banded.py product_blocks counts them the same way).
struct Grid {
  int blocks, threads;
};
Grid grid_of(int R, int n_rows) {
  int per_block = kWarpsPerBlock;
  while ((R / kWarpRows) % per_block != 0) per_block /= 2;
  const int warps = (n_rows + kWarpRows - 1) / kWarpRows;
  return {(warps + per_block - 1) / per_block, 32 * per_block};
}

template <typename Tag, int M, bool kRound, int kPcg = kProduct>
cudaError_t launch_m(const uint4* tiles, const int* offsets, const int* cols,
                     const typename Blocks<Tag>::acc* X,
                     typename Blocks<Tag>::acc* Y, int R, int W, int g, int pad,
                     int aligned, int n_rows, int n_cols, int n_tiles,
                     cudaStream_t stream, PcgArgs pcg = {}) {
  // kDirection stages two windows (Z and the old direction).
  const int smem = (kPcg == kDirection ? 2 : 1) * M * W *
                   static_cast<int>(sizeof(typename Blocks<Tag>::acc));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  // Above 48 KB dynamic shared memory must be enabled per kernel; remember
  // the largest size granted so the attribute is set once per size class.
  static int granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(banded_tiles_kernel<Tag, M, kRound, kPcg>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  if (n_rows == 0) return cudaSuccess;
  const Grid grid = grid_of(R, n_rows);
  banded_tiles_kernel<Tag, M, kRound, kPcg><<<grid.blocks, grid.threads, smem, stream>>>(
      tiles, offsets, cols, X, Y, R, W, g, pad, aligned, n_rows, n_cols, n_tiles, pcg);
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

template <int kPcg>
cudaError_t launch_pcg(const float* tiles, const int* offsets, const int* cols,
                       const float* X, float* Y, int R, int W, int g, int pad, int aligned,
                       int n, int n_tiles, int m, const PcgArgs& pcg, cudaStream_t s) {
  const uint4* t = reinterpret_cast<const uint4*>(tiles);
  if (m == 1)
    return launch_m<float, 1, false, kPcg>(t, offsets, cols, X, Y, R, W, g, pad, aligned,
                                           n, n, n_tiles, s, pcg);
  if (m == 2)
    return launch_m<float, 2, false, kPcg>(t, offsets, cols, X, Y, R, W, g, pad, aligned,
                                           n, n, n_tiles, s, pcg);
  return cudaErrorInvalidValue;
}

}  // namespace

// The PCG iteration's products (the header) on a square (n, n) operator of
// f32 tiles, X and Y (n, m), m in {1, 2}.  mode 1 (residual): Y = B - A X.
// mode 2 (direction): X is Z; P_new = Z + beta P_old (P_old null: P_new =
// Z), Y = A P_new, pap[c * n_pap + block] the blocks' p.Ap partials, n_pap
// the launch's blocks; beta from the n_rz r.z partials a column of rz and
// rz_old.  Partials are [m][count].
extern "C" int banded_pcg_f32(const float* tiles, const int* offsets, const int* cols,
                              const float* X, float* Y, int B, int R, int W, int g,
                              int pad, int aligned, int n, int n_tiles, int m, int mode,
                              const float* Bvec, const float* P_old, float* P_new,
                              const float* rz, const float* rz_old, int n_rz, float* pap,
                              int n_pap, void* stream) {
  constexpr int T = Blocks<float>::N * kVecPerRow;
  if (B < 0 || R < kWarpRows || R % kWarpRows != 0 || W < T || W % T != 0 || g < 1 ||
      pad < 0 || n < 1 || n > static_cast<long long>(B) * R || n_tiles < 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(tiles) % 16 != 0) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PcgArgs pcg{Bvec, P_old, P_new, rz, rz_old, pap, n_rz};
  if (mode == kResidual) {
    if (Bvec == nullptr) return cudaErrorInvalidValue;
    return launch_pcg<kResidual>(tiles, offsets, cols, X, Y, R, W, g, pad, aligned, n,
                                 n_tiles, m, pcg, s);
  }
  if (mode == kDirection) {
    if (P_new == nullptr || pap == nullptr || n_pap != grid_of(R, n).blocks ||
        (P_old != nullptr && (rz == nullptr || rz_old == nullptr || n_rz < 1)))
      return cudaErrorInvalidValue;
    return launch_pcg<kDirection>(tiles, offsets, cols, X, Y, R, W, g, pad, aligned, n,
                                  n_tiles, m, pcg, s);
  }
  return cudaErrorInvalidValue;
}

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

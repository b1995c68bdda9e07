// Dense f32 matrix-vector products for the fused IPCS step, for Hopper (sm_90a).
//
// Replaces meshdqn_tpu/ops/pallas_kernels.py:matvec_pallas (_mv_kernel) with
// matvec_f32 and the grouped forms below, and matvec_dual_pallas
// (_mv_dual_kernel) with matvec_dual_f32:
//
//   matvec_f32:       y = M @ x                 M (R, N), x (N, k), y (R, k)
//   matvec_dual_f32:  y = M @ x_hi + M @ x_lo   (M read once)
//   step_ustar_f32:     u* = ((F1u u + F1p p) - rho (A1Z c)) + k1
//   step_pressure_f32:  p' = (F2p p + F2u u*) + k2,  dp = p' - p
//   step_velocity_f32:  u'[r]    = ((F3s [u*x u*y])[r, 0] + (F3p_x dp)[r]) + k3[r]
//                       u'[ns+r] = ((F3s [u*x u*y])[r, 1] + (F3p_y dp)[r]) + k3[ns+r]
//   step_{ustar,pressure,velocity}_df32: the split form, the same three
//     launches of the 'df32' step (meshdqn_tpu/solver/fused.py
//     fused_step_df32), each operator an f32 high limb M and a bf16 low limb
//     L (|L| <= 2^-24 |M|):
//       u* = (((F1u u + F1p p) - rho (A1Z c)) + k1)
//            + (((L1u b(u) + L1p b(p)) - rho (LA1Z b(c))) + l1)
//       p' = ((F2p p + F2u u*) + k2) + ((L2p b(p) + L2u b(u*)) + l2),  dp = p' - p
//       u'[r] = ((((F3s u*)[r, 0] + (F3p_x dp)[r])
//                 + ((L3s b(u*))[r, 0] + (L3p_x b(dp))[r])) + k3[r]) + l3[r]
//     and alike for u'[ns+r]; b(x) is x rounded to bf16 (nearest even) and
//     l1, l2, l3 the f32 low limbs of k1, k2, k3.
//
// with k in {1, 2}, all row-major f32, true f32 FMA (no TF32, no tensor
// cores: a matvec does 2 flops per 4-byte matrix entry, so there is no reuse
// for them to exploit).  The three step_* forms are the fused IPCS step's
// seven products and the elementwise work around them in three launches.
//
// Bound: bytes.  Every entry of a matrix is used once, so the least time is
// its bytes over the device-memory rate; the vectors are a few tens of KB.
//
// Order.  A row's sum is fixed, so every launch repeats its bits and every
// form gives the bits of the single product: one warp per output row; for
// each product of the row, lane l takes the scalar head (columns up to the
// row's first 16-byte boundary, lane < head), then float4 columns l, l+32,
// ... of the aligned body in sequence, then the scalar tail (fewer than 4
// columns), all by fmaf into one accumulator per right-hand side; then the
// fixed xor-shuffle tree 16, 8, 4, 2, 1.  No atomics, no split of a row,
// nothing read past a row.  The grouped forms combine their products with
// explicitly rounded __fadd_rn / __fsub_rn / __fmul_rn in the order torch
// evaluates solver/fused.py's expression, so nvcc cannot contract them into
// an FMA: a grouped launch equals the single launches and torch's elementwise
// ops bit for bit.
//
// The split form sums each high-limb row exactly as the f32 form does (so
// with zero low limbs it gives the f32 form's values), then streams the
// row's bf16 low limb once: 16-byte loads of 8 entries, each widened to f32
// exactly and multiplied by b(x) by fmaf (the product of two bf16 values is
// exact in f32), lane l taking vectors l, l + 32, ... after a scalar head
// up to the row's 16-byte boundary, then a scalar tail, into accumulators of
// their own; the same xor tree.  b(x) is rounded once per block into shared
// memory beside x.  Low limbs stream half the bytes of the high ones, so a
// step moves 1.5x the f32 step's operator bytes; still bound by bytes.
//
// Design for the card:
//   * Each warp requests its row's first batch of the matrix (D float4 per
//     lane, plus the head and tail scalars) before x has arrived; x goes into
//     shared memory by cp.async meanwhile, so the HBM stream starts at once.
//   * 8 warps a block; each lane keeps D = 8 float4 loads of its row in
//     flight, 4 in launches whose row product has two x vectors (their
//     reads take the registers).  A lane's loads live in registers, so D
//     trades bytes in flight per warp against resident warps; a sweep of
//     1-8 warps and D = 4-16 on the H100 put this choice within a few
//     percent of the best on every shape of the step.
//   * x is staged contiguously per right-hand side (an interleaved (N, 2) x
//     is split on the way), each vector 16-byte aligned in shared memory.
//     Rows with no scalar head read it as one conflict-free float4 per float4
//     of the matrix; rows with a head of h entries (N % 4 != 0, or a matrix
//     that starts off a 16-byte boundary) read two float4s and take the 4
//     values at offset h (a compile-time shift): the same values, in the
//     same order, as scalar reads.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError()
// after its launch (0 on success).  The caller allocates the outputs and owns
// the stream; nothing here synchronises or allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The staged x vectors of a block (dynamic shared memory).
extern __shared__ __align__(16) float smem_x[];

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Shared memory a block may use on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;
constexpr int kMaxProducts = 3;
constexpr int kMaxSlots = 8;
// Operands an epilogue loads per row before the products.
constexpr int kEpi = 4;

// One row product of a launch: output row r reads row row0 + r of M, whose
// k right-hand sides are the staged slots slot .. slot + k - 1.  In the
// split form also row row0 + r of the bf16 low limb L (bit patterns), whose
// right-hand sides are the slots lslot .. lslot + k - 1.
struct Product {
  const float* M;
  int N;
  int row0;
  int slot;
  const uint16_t* L;
  int lslot;
};

// A launch: its products, the x vectors it stages (slot s holds
// src[s][i * stride[s]] for i < len[s] at float offset off[s] of shared
// memory, a multiple of 4; or, where rounds[s] = t + 1, slot t rounded to
// bf16), and the epilogue's operands.
struct Group {
  Product prod[kMaxProducts];
  const float* src[kMaxSlots];
  int stride[kMaxSlots];
  int len[kMaxSlots];
  int off[kMaxSlots];
  int rounds[kMaxSlots];
  int slots;
  int smem_bytes;
  float* out0;
  float* out1;
  const float* in0;
  const float* in1;
  const float* in2;
  const float* rho;
  int R;
  int ns;
};

// 16 bytes of a matrix row: read once, evict first.  volatile keeps the
// first batch's loads ahead of the staging of x and the barrier.
__device__ __forceinline__ float4 load_m4(const float4* p) {
  float4 r;
  asm volatile("ld.global.cs.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "l"(p));
  return r;
}
__device__ __forceinline__ float load_m1(const float* p) {
  float r;
  asm volatile("ld.global.cs.f32 %0, [%1];" : "=f"(r) : "l"(p));
  return r;
}

// One value of x into shared memory by an asynchronous copy.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// A warp's row of one product: its start, width, scalar head and float4
// count.
struct Row {
  const float* m;
  int n;
  int head;
  int nvec;
};

__device__ __forceinline__ Row row_of(const Product& p, int r) {
  Row w;
  w.m = p.M + static_cast<size_t>(p.row0 + r) * p.N;
  const int h = static_cast<int>(
      ((16u - (static_cast<uint32_t>(reinterpret_cast<uintptr_t>(w.m)) & 15u)) &
       15u) >> 2);
  w.n = p.N;
  w.head = h > p.N ? p.N : h;
  w.nvec = (p.N - w.head) >> 2;
  return w;
}

// Loads for float4 rounds b .. b + D - 1 of the row's body: lane l takes
// float4 l + 32 * round.
template <int D>
__device__ __forceinline__ void load_batch(const Row& w, int lane, int b,
                                           float4 (&m)[D]) {
  const float4* mv = reinterpret_cast<const float4*>(w.m + w.head);
#pragma unroll
  for (int u = 0; u < D; ++u) {
    const int v = lane + 32 * (b + u);
    if (v < w.nvec) m[u] = load_m4(mv + v);
  }
}

// The loads a row starts with: head and tail scalars and the first batch.
template <int D>
__device__ __forceinline__ void start_row(const Row& w, int lane, float& mh,
                                          float& mt, float4 (&m)[D]) {
  if (lane < w.head) mh = load_m1(w.m + lane);
  const int t = w.head + 4 * w.nvec + lane;
  if (t < w.n) mt = load_m1(w.m + t);
  load_batch<D>(w, lane, 0, m);
}

// acc[j] += the float4 m of columns head + 4v .. + 3 times x_j there.  x_j
// is 16-byte aligned in shared memory, so those columns lie in its float4s
// v and v + 1 at offset H = head.
template <int K, int H>
__device__ __forceinline__ void fma4(const float4& m, int v, const int* xo,
                                     float* acc) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float4* x4 = reinterpret_cast<const float4*>(smem_x + xo[j]);
    const float4 a = x4[v];
    float x0, x1, x2, x3;
    if constexpr (H == 0) {
      x0 = a.x; x1 = a.y; x2 = a.z; x3 = a.w;
    } else {
      const float4 b = x4[v + 1];
      if constexpr (H == 1) {
        x0 = a.y; x1 = a.z; x2 = a.w; x3 = b.x;
      } else if constexpr (H == 2) {
        x0 = a.z; x1 = a.w; x2 = b.x; x3 = b.y;
      } else {
        x0 = a.w; x1 = b.x; x2 = b.y; x3 = b.z;
      }
    }
    acc[j] = fmaf(m.x, x0, acc[j]);
    acc[j] = fmaf(m.y, x1, acc[j]);
    acc[j] = fmaf(m.z, x2, acc[j]);
    acc[j] = fmaf(m.w, x3, acc[j]);
  }
}

// The row's body, its first batch already in m.
template <int K, int D, int H>
__device__ __forceinline__ void body(const Row& w, int lane, const int* xo,
                                     float* acc, float4 (&m)[D]) {
  for (int b = 0;;) {
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int v = lane + 32 * (b + u);
      if (v < w.nvec) fma4<K, H>(m[u], v, xo, acc);
    }
    b += D;
    if (32 * b >= w.nvec) break;
    load_batch<D>(w, lane, b, m);
  }
}

// Head, body, tail of one row product, its loads started by start_row.
template <int K, int D>
__device__ __forceinline__ void finish_row(const Row& w, int lane, const int* xo,
                                           float mh, float mt, float4 (&m)[D],
                                           float* acc) {
  if (lane < w.head) {
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = fmaf(mh, smem_x[xo[j] + lane], acc[j]);
  }
  switch (w.head) {
    case 0: body<K, D, 0>(w, lane, xo, acc, m); break;
    case 1: body<K, D, 1>(w, lane, xo, acc, m); break;
    case 2: body<K, D, 2>(w, lane, xo, acc, m); break;
    default: body<K, D, 3>(w, lane, xo, acc, m); break;
  }
  const int t = w.head + 4 * w.nvec + lane;
  if (t < w.n) {
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = fmaf(mt, smem_x[xo[j] + t], acc[j]);
  }
}

template <int K>
__device__ __forceinline__ void slot_offsets(const Group& g, int p, int (&xo)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) xo[j] = g.off[g.prod[p].slot + j];
}

// Products P.. of the row, each started after the one before it ends.
template <class E, int D, int P>
__device__ __forceinline__ void run_rest(const Group& g, int r, int lane,
                                         float4 (&m)[D], float* acc) {
  if constexpr (P < E::kProducts) {
    constexpr int K = E::kK[P];
    constexpr int off = E::kOff[P];
    const Row w = row_of(g.prod[P], r);
    float mh = 0.0f, mt = 0.0f;
    start_row<D>(w, lane, mh, mt, m);
    int xo[K];
    slot_offsets<K>(g, P, xo);
    finish_row<K, D>(w, lane, xo, mh, mt, m, acc + off);
    run_rest<E, D, P + 1>(g, r, lane, m, acc);
  }
}

// ---------------------------------------------------------------------------
// The split form's low limbs: bf16 rows, 8 entries a 16-byte vector.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 load_l4(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}
// One bf16 entry, widened to f32 exactly (a bf16 value is the top half of
// the f32 with the same bits).
__device__ __forceinline__ float load_l1(const uint16_t* p) {
  unsigned short r;
  asm volatile("ld.global.cs.u16 %0, [%1];" : "=h"(r) : "l"(p));
  return __uint_as_float(static_cast<uint32_t>(r) << 16);
}

// x rounded to bf16, to nearest even, back in f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A warp's low-limb row: its start, width, scalar head (entries up to the
// first 16-byte boundary) and 8-entry vector count.
struct LoRow {
  const uint16_t* m;
  int n;
  int head;
  int nvec;
};

__device__ __forceinline__ LoRow lo_row_of(const Product& p, int r) {
  LoRow w;
  w.m = p.L + static_cast<size_t>(p.row0 + r) * p.N;
  const int h = static_cast<int>(
      ((16u - (static_cast<uint32_t>(reinterpret_cast<uintptr_t>(w.m)) & 15u)) &
       15u) >> 1);
  w.n = p.N;
  w.head = h > p.N ? p.N : h;
  w.nvec = (p.N - w.head) >> 3;
  return w;
}

// acc[j] += the 8 entries of l (columns head + 8v ..) times b(x_j) there.
// Those columns start in float4 q = head / 4 + 2v of the 16-byte aligned
// slot, at offset H = head % 4.
template <int K, int H>
__device__ __forceinline__ void fma8(const uint4& l, int q, const int* xo,
                                     float* acc) {
  const uint32_t wd[4] = {l.x, l.y, l.z, l.w};
  float a[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[2 * i] = __uint_as_float(wd[i] << 16);
    a[2 * i + 1] = __uint_as_float(wd[i] & 0xffff0000u);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float4* x4 = reinterpret_cast<const float4*>(smem_x + xo[j]) + q;
    const float4 p0 = x4[0], p1 = x4[1];
    float x[12] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w,
                   0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (H != 0) {
      const float4 p2 = x4[2];
      x[8] = p2.x; x[9] = p2.y; x[10] = p2.z; x[11] = p2.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j] = fmaf(a[i], x[H + i], acc[j]);
  }
}

template <int K, int D, int H>
__device__ __forceinline__ void lo_body(const LoRow& w, int lane, const int* xo,
                                        float* acc) {
  const uint4* mv = reinterpret_cast<const uint4*>(w.m + w.head);
  const int q0 = w.head >> 2;
  for (int b = 0; 32 * b < w.nvec; b += D) {
    uint4 m[D];
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int v = lane + 32 * (b + u);
      if (v < w.nvec) m[u] = load_l4(mv + v);
    }
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int v = lane + 32 * (b + u);
      if (v < w.nvec) fma8<K, H>(m[u], q0 + 2 * v, xo, acc);
    }
  }
}

// Head, body, tail of one low-limb row product.
template <int K, int D>
__device__ __forceinline__ void lo_row(const LoRow& w, int lane, const int* xo,
                                       float* acc) {
  if (lane < w.head) {
    const float mh = load_l1(w.m + lane);
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = fmaf(mh, smem_x[xo[j] + lane], acc[j]);
  }
  switch (w.head & 3) {
    case 0: lo_body<K, D, 0>(w, lane, xo, acc); break;
    case 1: lo_body<K, D, 1>(w, lane, xo, acc); break;
    case 2: lo_body<K, D, 2>(w, lane, xo, acc); break;
    default: lo_body<K, D, 3>(w, lane, xo, acc); break;
  }
  const int t = w.head + 8 * w.nvec + lane;
  if (t < w.n) {
    const float mt = load_l1(w.m + t);
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = fmaf(mt, smem_x[xo[j] + t], acc[j]);
  }
}

// Low-limb products P.. of the row, into their own accumulators.
template <class E, int D, int P>
__device__ __forceinline__ void run_lo(const Group& g, int r, int lane, float* acc) {
  if constexpr (P < E::kProducts) {
    constexpr int K = E::kK[P];
    constexpr int off = E::kLoOff[P];
    int xo[K];
#pragma unroll
    for (int j = 0; j < K; ++j) xo[j] = g.off[g.prod[P].lslot + j];
    lo_row<K, D>(lo_row_of(g.prod[P], r), lane, xo, acc + off);
    run_lo<E, D, P + 1>(g, r, lane, acc);
  }
}

// ---------------------------------------------------------------------------
// Epilogues: pre() loads what store() needs, before the row's products;
// store() runs on lane 0 with the reduced sums.
// ---------------------------------------------------------------------------

template <int K>
struct Plain {
  static constexpr bool kSplit = false;
  static constexpr int kProducts = 1;
  static constexpr int kK[1] = {K};
  static constexpr int kOff[1] = {0};
  static constexpr int kAcc = K;
  static constexpr int kDepth = K == 1 ? 8 : 4;
  static __device__ __forceinline__ void pre(const Group&, int, float (&)[kEpi]) {}
  static __device__ __forceinline__ void store(const float* a, const Group& g, int r,
                                               const float (&)[kEpi]) {
#pragma unroll
    for (int j = 0; j < K; ++j) g.out0[static_cast<size_t>(r) * K + j] = a[j];
  }
};

// x_hi's K slots, then x_lo's; y = hi + lo.
template <int K>
struct Dual {
  static constexpr bool kSplit = false;
  static constexpr int kProducts = 1;
  static constexpr int kK[1] = {2 * K};
  static constexpr int kOff[1] = {0};
  static constexpr int kAcc = 2 * K;
  static constexpr int kDepth = 4;
  static __device__ __forceinline__ void pre(const Group&, int, float (&)[kEpi]) {}
  static __device__ __forceinline__ void store(const float* a, const Group& g, int r,
                                               const float (&)[kEpi]) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      g.out0[static_cast<size_t>(r) * K + j] = __fadd_rn(a[j], a[K + j]);
  }
};

// u* = ((F1u u + F1p p) - rho (A1Z c)) + k1: in0 = k1.
struct UStar {
  static constexpr bool kSplit = false;
  static constexpr int kProducts = 3;
  static constexpr int kK[3] = {1, 1, 1};
  static constexpr int kOff[3] = {0, 1, 2};
  static constexpr int kAcc = 3;
  static constexpr int kDepth = 8;
  static __device__ __forceinline__ void pre(const Group& g, int r, float (&e)[kEpi]) {
    e[0] = g.in0[r];
    e[1] = *g.rho;
  }
  static __device__ __forceinline__ void store(const float* a, const Group& g, int r,
                                               const float (&e)[kEpi]) {
    g.out0[r] = __fadd_rn(__fsub_rn(__fadd_rn(a[0], a[1]), __fmul_rn(e[1], a[2])), e[0]);
  }
};

// p' = (F2p p + F2u u*) + k2, dp = p' - p: in0 = k2, in1 = p.
struct Pressure {
  static constexpr bool kSplit = false;
  static constexpr int kProducts = 2;
  static constexpr int kK[2] = {1, 1};
  static constexpr int kOff[2] = {0, 1};
  static constexpr int kAcc = 2;
  static constexpr int kDepth = 8;
  static __device__ __forceinline__ void pre(const Group& g, int r, float (&e)[kEpi]) {
    e[0] = g.in0[r];
    e[1] = g.in1[r];
  }
  static __device__ __forceinline__ void store(const float* a, const Group& g, int r,
                                               const float (&e)[kEpi]) {
    const float pn = __fadd_rn(__fadd_rn(a[0], a[1]), e[0]);
    g.out0[r] = pn;
    g.out1[r] = __fsub_rn(pn, e[1]);
  }
};

// u'[r] = (y[r, 0] + corr[r]) + k3[r], u'[ns + r] = (y[r, 1] + corr[ns + r])
// + k3[ns + r], with y = F3s [u*x u*y] and corr = F3p dp: in0 = k3.
struct Velocity {
  static constexpr bool kSplit = false;
  static constexpr int kProducts = 3;
  static constexpr int kK[3] = {2, 1, 1};
  static constexpr int kOff[3] = {0, 2, 3};
  static constexpr int kAcc = 4;
  static constexpr int kDepth = 4;
  static __device__ __forceinline__ void pre(const Group& g, int r, float (&e)[kEpi]) {
    e[0] = g.in0[r];
    e[1] = g.in0[g.ns + r];
  }
  static __device__ __forceinline__ void store(const float* a, const Group& g, int r,
                                               const float (&e)[kEpi]) {
    g.out0[r] = __fadd_rn(__fadd_rn(a[0], a[2]), e[0]);
    g.out0[g.ns + r] = __fadd_rn(__fadd_rn(a[1], a[3]), e[1]);
  }
};

// The split form's epilogues: the f32 form's expression for the high limbs
// (accumulators 0 ..), the same for the low limbs (accumulators kLoOff ..),
// combined in the order of fused_step_df32.

// u* = u_hi + (((l0 + l1) - rho l2) + lk1): in0 = k1, in2 = lk1.
struct UStarSplit {
  static constexpr bool kSplit = true;
  static constexpr int kProducts = 3;
  static constexpr int kK[3] = {1, 1, 1};
  static constexpr int kOff[3] = {0, 1, 2};
  static constexpr int kLoOff[3] = {3, 4, 5};
  static constexpr int kAcc = 6;
  static constexpr int kDepth = 8;
  static __device__ __forceinline__ void pre(const Group& g, int r, float (&e)[kEpi]) {
    e[0] = g.in0[r];
    e[1] = *g.rho;
    e[2] = g.in2[r];
  }
  static __device__ __forceinline__ void store(const float* a, const Group& g, int r,
                                               const float (&e)[kEpi]) {
    const float hi =
        __fadd_rn(__fsub_rn(__fadd_rn(a[0], a[1]), __fmul_rn(e[1], a[2])), e[0]);
    const float lo =
        __fadd_rn(__fsub_rn(__fadd_rn(a[3], a[4]), __fmul_rn(e[1], a[5])), e[2]);
    g.out0[r] = __fadd_rn(hi, lo);
  }
};

// p' = ((a0 + a1) + k2) + ((l0 + l1) + lk2), dp = p' - p: in0 = k2, in1 = p,
// in2 = lk2.
struct PressureSplit {
  static constexpr bool kSplit = true;
  static constexpr int kProducts = 2;
  static constexpr int kK[2] = {1, 1};
  static constexpr int kOff[2] = {0, 1};
  static constexpr int kLoOff[2] = {2, 3};
  static constexpr int kAcc = 4;
  static constexpr int kDepth = 8;
  static __device__ __forceinline__ void pre(const Group& g, int r, float (&e)[kEpi]) {
    e[0] = g.in0[r];
    e[1] = g.in1[r];
    e[2] = g.in2[r];
  }
  static __device__ __forceinline__ void store(const float* a, const Group& g, int r,
                                               const float (&e)[kEpi]) {
    const float hi = __fadd_rn(__fadd_rn(a[0], a[1]), e[0]);
    const float pn = __fadd_rn(hi, __fadd_rn(__fadd_rn(a[2], a[3]), e[2]));
    g.out0[r] = pn;
    g.out1[r] = __fsub_rn(pn, e[1]);
  }
};

// u'[r] = (((y[r, 0] + corr[r]) + (yl[r, 0] + corrl[r])) + k3[r]) + lk3[r],
// and alike for u'[ns + r]: in0 = k3, in2 = lk3.
struct VelocitySplit {
  static constexpr bool kSplit = true;
  static constexpr int kProducts = 3;
  static constexpr int kK[3] = {2, 1, 1};
  static constexpr int kOff[3] = {0, 2, 3};
  static constexpr int kLoOff[3] = {4, 6, 7};
  static constexpr int kAcc = 8;
  static constexpr int kDepth = 4;
  static __device__ __forceinline__ void pre(const Group& g, int r, float (&e)[kEpi]) {
    e[0] = g.in0[r];
    e[1] = g.in0[g.ns + r];
    e[2] = g.in2[r];
    e[3] = g.in2[g.ns + r];
  }
  static __device__ __forceinline__ void store(const float* a, const Group& g, int r,
                                               const float (&e)[kEpi]) {
    const float x = __fadd_rn(__fadd_rn(a[0], a[2]), __fadd_rn(a[4], a[6]));
    const float y = __fadd_rn(__fadd_rn(a[1], a[3]), __fadd_rn(a[5], a[7]));
    g.out0[r] = __fadd_rn(__fadd_rn(x, e[0]), e[2]);
    g.out0[g.ns + r] = __fadd_rn(__fadd_rn(y, e[1]), e[3]);
  }
};

// Launched with kThreads threads a block and g.smem_bytes of dynamic shared
// memory; warp w of block b takes row b * kWarps + w.
template <class E>
__global__ void __launch_bounds__(kThreads) group_kernel(const Group g) {
  constexpr int D = E::kDepth;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = r < g.R;

  // 1. The first product's first loads, and the epilogue's operands.
  float4 m[D];
  float mh = 0.0f, mt = 0.0f;
  float e[kEpi] = {0.0f, 0.0f, 0.0f, 0.0f};
  Row w0;
  if (live) {
    w0 = row_of(g.prod[0], r);
    start_row<D>(w0, lane, mh, mt, m);
    if (lane == 0) E::pre(g, r, e);
  }

  // 2. x into shared memory while they fly; then the split form's b(x).
  for (int s = 0; s < g.slots; ++s) {
    if (g.rounds[s]) continue;
    const float* src = g.src[s];
    const int stride = g.stride[s];
    float* dst = smem_x + g.off[s];
    for (int i = threadIdx.x; i < g.len[s]; i += kThreads)
      copy_async(dst + i, src + static_cast<size_t>(i) * stride);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if constexpr (E::kSplit) {
    for (int s = 0; s < g.slots; ++s) {
      if (!g.rounds[s]) continue;
      const float* from = smem_x + g.off[g.rounds[s] - 1];
      float* dst = smem_x + g.off[s];
      for (int i = threadIdx.x; i < g.len[s]; i += kThreads) dst[i] = round_bf16(from[i]);
    }
    __syncthreads();
  }
  if (!live) return;  // whole warps leave together; no barrier follows

  // 3. The row's products in order.
  float acc[E::kAcc];
#pragma unroll
  for (int j = 0; j < E::kAcc; ++j) acc[j] = 0.0f;
  {
    constexpr int K = E::kK[0];
    int xo[K];
    slot_offsets<K>(g, 0, xo);
    finish_row<K, D>(w0, lane, xo, mh, mt, m, acc);
  }
  run_rest<E, D, 1>(g, r, lane, m, acc);
  if constexpr (E::kSplit) run_lo<E, D, 0>(g, r, lane, acc);

  // 4. Fixed-order butterfly: every lane ends with the same totals.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < E::kAcc; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
  if (lane == 0) E::store(acc, g, r, e);
}

// Slot s holds n values of src at the given stride; returns false when the
// slots exceed the shared memory a block may use.
__host__ bool add_slot(Group& g, const float* src, int n, int stride) {
  const int off = g.slots == 0 ? 0 : g.off[g.slots - 1] + ((g.len[g.slots - 1] + 3) & ~3);
  g.src[g.slots] = src;
  g.stride[g.slots] = stride;
  g.len[g.slots] = n;
  g.off[g.slots] = off;
  ++g.slots;
  g.smem_bytes = 4 * (off + ((n + 3) & ~3));
  return g.smem_bytes <= kMaxSmemBytes;
}

// A slot holding slot `from` rounded to bf16 (staged by the block itself).
__host__ bool add_round(Group& g, int from) {
  const bool ok = add_slot(g, nullptr, g.len[from], 0);
  g.rounds[g.slots - 1] = from + 1;
  return ok;
}

__host__ void set_lo(Group& g, int p, const uint16_t* L, int lslot) {
  g.prod[p].L = L;
  g.prod[p].lslot = lslot;
}

__host__ Group new_group(int R) {
  Group g = {};
  g.R = R;
  return g;
}

__host__ void set_product(Group& g, int p, const float* M, int N, int row0, int slot) {
  g.prod[p].M = M;
  g.prod[p].N = N;
  g.prod[p].row0 = row0;
  g.prod[p].slot = slot;
}

template <class E>
cudaError_t launch(const Group& g, cudaStream_t stream) {
  if (g.smem_bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  // Above 48 KB dynamic shared memory must be enabled per kernel; remember
  // the largest size granted so the attribute is set once per size class.
  static int granted = 48 * 1024;
  if (g.smem_bytes > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        group_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_bytes);
    if (err != cudaSuccess) return err;
    granted = g.smem_bytes;
  }
  if (g.R == 0) return cudaSuccess;
  const int blocks = (g.R + kWarps - 1) / kWarps;
  group_kernel<E><<<blocks, kThreads, g.smem_bytes, stream>>>(g);
  return cudaGetLastError();
}

// The groups of the entry points.
__host__ bool matvec_group(Group& g, const float* M, const float* x, float* y, int R,
                           int N, int k) {
  g = new_group(R);
  set_product(g, 0, M, N, 0, 0);
  g.out0 = y;
  bool ok = true;
  for (int j = 0; j < k; ++j) ok &= add_slot(g, x + j, N, k);
  return ok;
}

__host__ bool matvec_dual_group(Group& g, const float* M, const float* x_hi,
                                const float* x_lo, float* y, int R, int N, int k) {
  g = new_group(R);
  set_product(g, 0, M, N, 0, 0);
  g.out0 = y;
  bool ok = true;
  for (int j = 0; j < k; ++j) ok &= add_slot(g, x_hi + j, N, k);
  for (int j = 0; j < k; ++j) ok &= add_slot(g, x_lo + j, N, k);
  return ok;
}

__host__ bool ustar_group(Group& g, const float* F1u, const float* F1p,
                          const float* A1Z, const float* u, const float* p,
                          const float* c, const float* rho, const float* k1,
                          float* ustar, int nu, int np) {
  g = new_group(nu);
  bool ok = add_slot(g, u, nu, 1) && add_slot(g, p, np, 1) && add_slot(g, c, nu, 1);
  set_product(g, 0, F1u, nu, 0, 0);
  set_product(g, 1, F1p, np, 0, 1);
  set_product(g, 2, A1Z, nu, 0, 2);
  g.out0 = ustar;
  g.in0 = k1;
  g.rho = rho;
  return ok;
}

__host__ bool pressure_group(Group& g, const float* F2p, const float* F2u,
                             const float* p, const float* ustar, const float* k2,
                             float* pnew, float* dp, int np, int nu) {
  g = new_group(np);
  bool ok = add_slot(g, p, np, 1) && add_slot(g, ustar, nu, 1);
  set_product(g, 0, F2p, np, 0, 0);
  set_product(g, 1, F2u, nu, 0, 1);
  g.out0 = pnew;
  g.out1 = dp;
  g.in0 = k2;
  g.in1 = p;
  return ok;
}

__host__ bool velocity_group(Group& g, const float* F3s, const float* F3p,
                             const float* ustar, const float* dp, const float* k3,
                             float* unew, int ns, int np) {
  g = new_group(ns);
  bool ok = add_slot(g, ustar, ns, 1) && add_slot(g, ustar + ns, ns, 1) &&
            add_slot(g, dp, np, 1);
  set_product(g, 0, F3s, ns, 0, 0);
  set_product(g, 1, F3p, np, 0, 2);
  set_product(g, 2, F3p, np, ns, 2);
  g.out0 = unew;
  g.in0 = k3;
  g.ns = ns;
  return ok;
}

// The split form: the f32 form's group, its x slots rounded into slots of
// their own, each product's low limb reading them.
__host__ bool ustar_split_group(Group& g, const float* F1u, const float* F1p,
                                const float* A1Z, const uint16_t* L1u,
                                const uint16_t* L1p, const uint16_t* LA1Z,
                                const float* u, const float* p, const float* c,
                                const float* rho, const float* k1, const float* lk1,
                                float* ustar, int nu, int np) {
  bool ok = ustar_group(g, F1u, F1p, A1Z, u, p, c, rho, k1, ustar, nu, np);
  ok = ok && add_round(g, 0) && add_round(g, 1) && add_round(g, 2);
  set_lo(g, 0, L1u, 3);
  set_lo(g, 1, L1p, 4);
  set_lo(g, 2, LA1Z, 5);
  g.in2 = lk1;
  return ok;
}

__host__ bool pressure_split_group(Group& g, const float* F2p, const float* F2u,
                                   const uint16_t* L2p, const uint16_t* L2u,
                                   const float* p, const float* ustar, const float* k2,
                                   const float* lk2, float* pnew, float* dp, int np,
                                   int nu) {
  bool ok = pressure_group(g, F2p, F2u, p, ustar, k2, pnew, dp, np, nu);
  ok = ok && add_round(g, 0) && add_round(g, 1);
  set_lo(g, 0, L2p, 2);
  set_lo(g, 1, L2u, 3);
  g.in2 = lk2;
  return ok;
}

__host__ bool velocity_split_group(Group& g, const float* F3s, const float* F3p,
                                   const uint16_t* L3s, const uint16_t* L3p,
                                   const float* ustar, const float* dp, const float* k3,
                                   const float* lk3, float* unew, int ns, int np) {
  bool ok = velocity_group(g, F3s, F3p, ustar, dp, k3, unew, ns, np);
  ok = ok && add_round(g, 0) && add_round(g, 1) && add_round(g, 2);
  set_lo(g, 0, L3s, 3);
  set_lo(g, 1, L3p, 5);
  set_lo(g, 2, L3p, 5);  // its rows ns.., as product 2 reads F3p's
  g.in2 = lk3;
  return ok;
}

}  // namespace

extern "C" int matvec_f32(const float* M, const float* x, float* y, int R, int N,
                          int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Group g;
  if (k < 1 || k > 2 || !matvec_group(g, M, x, y, R, N, k)) return cudaErrorInvalidValue;
  if (k == 1) return launch<Plain<1>>(g, s);
  if (k == 2) return launch<Plain<2>>(g, s);
  return cudaErrorInvalidValue;
}

extern "C" int matvec_dual_f32(const float* M, const float* x_hi, const float* x_lo,
                               float* y, int R, int N, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Group g;
  if (k < 1 || k > 2 || !matvec_dual_group(g, M, x_hi, x_lo, y, R, N, k))
    return cudaErrorInvalidValue;
  if (k == 1) return launch<Dual<1>>(g, s);
  if (k == 2) return launch<Dual<2>>(g, s);
  return cudaErrorInvalidValue;
}

// u* (nu = 2Ns rows) from u (nu), p (np), c (nu); rho a device scalar.
extern "C" int step_ustar_f32(const float* F1u, const float* F1p, const float* A1Z,
                              const float* u, const float* p, const float* c,
                              const float* rho, const float* k1, float* ustar, int nu,
                              int np, void* stream) {
  Group g;
  if (!ustar_group(g, F1u, F1p, A1Z, u, p, c, rho, k1, ustar, nu, np))
    return cudaErrorInvalidValue;
  return launch<UStar>(g, static_cast<cudaStream_t>(stream));
}

// p' and dp (np rows) from p (np) and u* (nu).
extern "C" int step_pressure_f32(const float* F2p, const float* F2u, const float* p,
                                 const float* ustar, const float* k2, float* pnew,
                                 float* dp, int np, int nu, void* stream) {
  Group g;
  if (!pressure_group(g, F2p, F2u, p, ustar, k2, pnew, dp, np, nu))
    return cudaErrorInvalidValue;
  return launch<Pressure>(g, static_cast<cudaStream_t>(stream));
}

// u' (2 ns entries, ns rows) from u* (2 ns) and dp (np); F3p is (2 ns, np).
extern "C" int step_velocity_f32(const float* F3s, const float* F3p, const float* ustar,
                                 const float* dp, const float* k3, float* unew, int ns,
                                 int np, void* stream) {
  Group g;
  if (!velocity_group(g, F3s, F3p, ustar, dp, k3, unew, ns, np))
    return cudaErrorInvalidValue;
  return launch<Velocity>(g, static_cast<cudaStream_t>(stream));
}

// The split form (the 'df32' step): low limbs are (rows, N) bf16 bit
// patterns laid out as their high limbs; lk1, lk2, lk3 f32.
extern "C" int step_ustar_df32(const float* F1u, const float* F1p, const float* A1Z,
                               const uint16_t* L1u, const uint16_t* L1p,
                               const uint16_t* LA1Z, const float* u, const float* p,
                               const float* c, const float* rho, const float* k1,
                               const float* lk1, float* ustar, int nu, int np,
                               void* stream) {
  Group g;
  if (!ustar_split_group(g, F1u, F1p, A1Z, L1u, L1p, LA1Z, u, p, c, rho, k1, lk1, ustar,
                         nu, np))
    return cudaErrorInvalidValue;
  return launch<UStarSplit>(g, static_cast<cudaStream_t>(stream));
}

extern "C" int step_pressure_df32(const float* F2p, const float* F2u,
                                  const uint16_t* L2p, const uint16_t* L2u,
                                  const float* p, const float* ustar, const float* k2,
                                  const float* lk2, float* pnew, float* dp, int np,
                                  int nu, void* stream) {
  Group g;
  if (!pressure_split_group(g, F2p, F2u, L2p, L2u, p, ustar, k2, lk2, pnew, dp, np, nu))
    return cudaErrorInvalidValue;
  return launch<PressureSplit>(g, static_cast<cudaStream_t>(stream));
}

extern "C" int step_velocity_df32(const float* F3s, const float* F3p,
                                  const uint16_t* L3s, const uint16_t* L3p,
                                  const float* ustar, const float* dp, const float* k3,
                                  const float* lk3, float* unew, int ns, int np,
                                  void* stream) {
  Group g;
  if (!velocity_split_group(g, F3s, F3p, L3s, L3p, ustar, dp, k3, lk3, unew, ns, np))
    return cudaErrorInvalidValue;
  return launch<VelocitySplit>(g, static_cast<cudaStream_t>(stream));
}

// The update half of a PCG iteration on the large-mesh CG step, for Hopper
// (sm_90a): everything between two banded products (ops/cg.py pcg_fused).
//
// Replaces no Pallas kernel.  The JAX package computes the block-Jacobi
// product as an einsum (meshdqn_tpu/ops/cg.py BlockJacobi.apply) and PCG's
// axpys and dots in plain jnp (pcg); the port ran them as ~21 torch ops an
// iteration (ops/cg.py pcg_reference), each a launch of 2-5 us on vectors of
// ~120 KB.  Added where a measurement called for it: on the benchmark's CG
// cell those ops were 82% of the device's time a step.
//
//   pcg_update_kernel, kRows = 32 rows of an nb-row block-Jacobi block b a
//   thread block (ceil(nb / 32) of them a block-Jacobi block):
//     alpha = rz / pAp per column (0 where pAp <= 0, as pcg's guard), from
//             the banded product's p.Ap partials and the last update's r.z
//             partials, each summed in one fixed order;
//     X_out = X_in + alpha P,  R_out = R_in - alpha AP  (its rows);
//     Z = inv_b R_b at its rows, inv_b the block's dense (nb, nb) inverse
//             and R_b the block's rows of R_out;
//     one r.z partial a column, rz_out[c * n_rz + blockIdx.x].
//   update = 0 (a solve's start): Z and the r.z partials of R_in only.
//   precondition = 0 (a solve's last iteration): X alone; R, Z and r.z are
//   not needed after it.
//
// Operands are f32, row-major: inv (ceil(n / nb), nb, nb), X_in, X_out, P,
// AP, R_in, R_out, Z (n, m) with m in {1, 2}; n_rz = ceil(n / nb)
// ceil(nb / 32).  The last block's inverse is padded with identity past row
// n; its rows and columns past n are skipped (the identity couples nothing),
// so no padded copy of R is made.  X_in may be X_out; R_in may not be R_out
// (the thread blocks of a block-Jacobi block all read its whole R_in).
//
// Bound: bytes.  A launch reads the blocks once (nb^2 f32 a block: 15.3 MB
// for the 29,768-row velocity system at nb = 128) and the vectors (~0.12 MB
// each); the flops are 2 nb m a row, far below the ridge point.  The sums
// that open and close a launch are round trips that no bandwidth hides, so
// the design keeps each thread block's chain of them short and has many
// thread blocks in flight:
//   * 32 rows a thread block (931 for the 29,768-row system at nb = 128, ~7
//     an SM), so a thread block waits for 16 KB of the inverse, not 64 KB;
//     its 32 rows of the inverse fly into shared memory (cp.async, 16-byte
//     copies) from the start, with its operands of the axpys, while alpha is
//     summed.  Each thread block updates the whole R_b, which its rows of Z
//     read, and writes only its rows of R_out;
//   * the partials are summed in a fixed order, each in one round trip:
//     p.Ap by all the thread block's threads (thread t adds i = t, t + 256,
//     ... in turn, then a fixed tree), r.z by one warp a column with the
//     function csrc/banded.cu's direction product uses on the same partials
//     (warp_sum_fixed, copied below: alpha and beta must read the same r.z);
//   * Z: a warp 4 rows, its lanes adding a row's columns j = lane,
//     lane + 32, ... in turn from shared memory, the 4 rows' fixed xor trees
//     side by side; the r.z partial is summed by the warps over their rows
//     in order, then over the warps in order.  No atomics: the bits repeat
//     run to run.
//   * the axpys round as torch's elementwise ops do (a multiply, then an add).
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError()
// after its launch (0 on success).  The caller allocates every operand and
// owns the stream; nothing here synchronises or allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;  // rows of a block-Jacobi block a thread block computes
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;
// Shared memory a block may use on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;

// p[0] + p[1] + ... + p[n-1] in one fixed order, by one warp: lane l adds
// p[l], p[l + 32], ... in turn (up to 32 loads in flight, so a sum of up to
// 1024 partials waits for one round trip), then a fixed xor tree; every lane
// ends with the same bits.  The same function as csrc/banded.cu's: keep the
// two equal.
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

__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

template <int M>
__global__ void __launch_bounds__(kThreads) pcg_update_kernel(
    const float* __restrict__ inv, int nb, int n, const float* X_in, float* X_out,
    const float* __restrict__ P, const float* __restrict__ AP,
    const float* __restrict__ R_in, float* __restrict__ R_out, float* __restrict__ Z,
    const float* __restrict__ pap, int n_pap,
    const float* __restrict__ rz_in, float* __restrict__ rz_out, int n_rz, int update,
    int precondition) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* inv_s = reinterpret_cast<float*>(smem);  // [kRows][nb]: the rows' inverse
  float* rs = inv_s + kRows * nb;                  // [nb][M]: R_b of R_out
  __shared__ float red_s[kWarps * M];
  __shared__ float sums_s[M];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int parts = (nb + kRows - 1) / kRows;  // thread blocks a block-Jacobi block
  const long long lo = static_cast<long long>(blockIdx.x / parts) * nb;  // R_b's first row
  const int rows_b = static_cast<int>(min(static_cast<long long>(nb), n - lo));
  const int r0 = (blockIdx.x % parts) * kRows;      // the rows, in the block
  const int rows = max(0, min(kRows, rows_b - r0));  // 0 in a ragged block's tail

  if (precondition && rows > 0) {
    const float* src = inv + (lo + r0) * nb;
    const int e = rows * nb;
    if (e % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      for (int i = threadIdx.x; i < e / 4; i += blockDim.x)
        copy16_async(inv_s + 4 * i, src + 4 * i);
    } else {
      for (int i = threadIdx.x; i < e; i += blockDim.x) copy4_async(inv_s + i, src + i);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // The thread's first element of the block's vectors, on its way now: the
  // axpys wait for alpha, not for these loads.
  const int e0 = threadIdx.x;
  const bool has0 = e0 < rows_b * M;
  const bool own0 = e0 >= r0 * M && e0 < (r0 + rows) * M;
  const long long k0 = lo * M + e0;
  float r_0 = 0.f, ap_0 = 0.f, x_0 = 0.f, p_0 = 0.f;
  if (has0 && (precondition || !update)) r_0 = R_in[k0];
  if (has0 && update && precondition) ap_0 = AP[k0];
  if (own0 && update) {
    x_0 = X_in[k0];
    p_0 = P[k0];
  }

  float alpha[M];
  if (update) {
    float s[M];
#pragma unroll
    for (int c = 0; c < M; ++c) s[c] = 0.f;
    for (int i0 = threadIdx.x; i0 < n_pap; i0 += 4 * kThreads) {
      float v[4][M];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
#pragma unroll
        for (int c = 0; c < M; ++c) v[u][c] = i < n_pap ? pap[c * n_pap + i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < M; ++c) s[c] += v[u][c];
      }
    }
#pragma unroll
    for (int c = 0; c < M; ++c) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s[c] += __shfl_xor_sync(0xffffffffu, s[c], off);
      if (lane == 0) red_s[warp * M + c] = s[c];
    }
    if (warp < M) {
      const float rz = warp_sum_fixed(rz_in + warp * n_rz, n_rz);
      if (lane == 0) sums_s[warp] = rz;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < M; ++c) {  // every thread, the same bits
      float t = red_s[c];
      for (int w = 1; w < kWarps; ++w) t += red_s[w * M + c];
      alpha[c] = guarded_div(sums_s[c], t);
    }
  }

  // R_b after the update, and X and R_out at the thread block's rows.
  for (int e = e0; e < nb * M; e += blockDim.x) {
    const bool first = e == e0;
    const bool has = e < rows_b * M, own = e >= r0 * M && e < (r0 + rows) * M;
    const long long k = lo * M + e;
    float r = 0.f;
    if (update) {
      const float a = alpha[e % M];
      if (own) X_out[k] = __fadd_rn(first ? x_0 : X_in[k], __fmul_rn(a, first ? p_0 : P[k]));
      if (precondition && has) {
        r = __fsub_rn(first ? r_0 : R_in[k], __fmul_rn(a, first ? ap_0 : AP[k]));
        if (own) R_out[k] = r;
      }
    } else if (has) {
      r = first ? r_0 : R_in[k];
    }
    if (precondition) rs[e] = r;
  }
  if (!precondition) return;

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  // Z at the warp's rows, their trees side by side, and their r.z in order.
  float acc[kRowsPerWarp][M];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
    for (int c = 0; c < M; ++c) acc[q][c] = 0.f;
  }
  const int i0 = warp * kRowsPerWarp;
  for (int j = lane; j < rows_b; j += 32) {
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      if (i0 + q < rows) {
        const float a = inv_s[(i0 + q) * nb + j];
#pragma unroll
        for (int c = 0; c < M; ++c) acc[q][c] = __fmaf_rn(a, rs[j * M + c], acc[q][c]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
      for (int c = 0; c < M; ++c) acc[q][c] += __shfl_xor_sync(0xffffffffu, acc[q][c], off);
    }
  }
  float rzw[M];
#pragma unroll
  for (int c = 0; c < M; ++c) rzw[c] = 0.f;
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int i = r0 + i0 + q;  // the row in the block
    if (i0 + q < rows) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        if (lane == 0) Z[(lo + i) * M + c] = acc[q][c];
        rzw[c] = __fmaf_rn(rs[i * M + c], acc[q][c], rzw[c]);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < M; ++c) red_s[warp * M + c] = rzw[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < M; ++c) {
      float t = red_s[c];
      for (int w = 1; w < kWarps; ++w) t += red_s[w * M + c];
      rz_out[c * n_rz + blockIdx.x] = t;
    }
  }
}

template <int M>
cudaError_t launch_m(const float* inv, int nb, int n, const float* X_in, float* X_out,
                     const float* P, const float* AP, const float* R_in, float* R_out,
                     float* Z, const float* pap, int n_pap, const float* rz_in,
                     float* rz_out, int n_rz, int update, int precondition,
                     cudaStream_t stream) {
  const int smem =
      precondition ? (kRows * nb + nb * M) * static_cast<int>(sizeof(float)) : 0;
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  // Above 48 KB dynamic shared memory must be enabled per kernel.
  static int granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        pcg_update_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  pcg_update_kernel<M><<<n_rz, kThreads, smem, stream>>>(
      inv, nb, n, X_in, X_out, P, AP, R_in, R_out, Z, pap, n_pap, rz_in, rz_out, n_rz,
      update, precondition);
  return cudaGetLastError();
}

}  // namespace

// The header's update on f32 operands; m in {1, 2}; n_rz = ceil(n / nb)
// ceil(nb / 32) thread blocks; pap [m][n_pap] (update = 1), rz_in and rz_out
// [m][n_rz].
extern "C" int pcg_update_f32(const float* inv, int nb, int n, const float* X_in,
                              float* X_out, const float* P, const float* AP,
                              const float* R_in, float* R_out, float* Z, const float* pap,
                              int n_pap, const float* rz_in, float* rz_out, int n_rz, int m,
                              int update, int precondition, void* stream) {
  if (nb < 1 || n < 1 ||
      n_rz != (n + nb - 1) / nb * ((nb + kRows - 1) / kRows) || (!update && !precondition) ||
      (update && (n_pap < 1 || pap == nullptr || rz_in == nullptr || X_in == nullptr ||
                  X_out == nullptr || P == nullptr || AP == nullptr)) ||
      (precondition && (inv == nullptr || R_in == nullptr || Z == nullptr ||
                        rz_out == nullptr || (update && (R_out == nullptr || R_out == R_in)))))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 1)
    return launch_m<1>(inv, nb, n, X_in, X_out, P, AP, R_in, R_out, Z, pap, n_pap, rz_in,
                       rz_out, n_rz, update, precondition, s);
  if (m == 2)
    return launch_m<2>(inv, nb, n, X_in, X_out, P, AP, R_in, R_out, Z, pap, n_pap, rz_in,
                       rz_out, n_rz, update, precondition, s);
  return cudaErrorInvalidValue;
}

// The convection vector of the IPCS step, c[(i, a)] = ((u.grad)u_i, phi_a),
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's convection
// (meshdqn_tpu/ops/convection.py) is plain jnp, and the port's counterpart,
// ops/convection.py convection_vector_reference, is about thirteen torch ops
// (a gather, three products, three elementwise ops, a concatenation, a
// gather and a sum).  In the fused step that chain cost more of the host's
// time to issue than the three grouped matvec launches together, and
// 0.064 ms of device time a step for about 4 MFLOP; this file does it in two
// launches behind one C call.
//
//   convection_cells_kernel: per cell c, with U[i][a] = u[cell_dofs[c, 6i+a]],
//     uq_i(q)    = sum_a U[i][a] phi[q][a]
//     du_ij(q)   = sum_a U[i][a] gphys[c][a][q][j]
//     conv_i(q)  = uq_0 du_i0 + uq_1 du_i1   (two rounded products, then
//                                             their sum: the JAX kernel's
//                                             order, as the torch twin has it)
//     relem[c*12 + 6i + a] = sum_q (wdet[c][q] conv_i(q)) phi[q][a]
//   and relem[C*12] = 0, the slot that pads the rows of `slots`;
//   convection_slots_kernel: out[d] = sum_s relem[slots[d][s]], in the
//     row's order.
//
// `slots` (ndofs, W) int32 is the incidence table dof_slots packed for the
// kernel (ops/convection.py, once per table): each row's entries in the
// table's ascending order, without the pad slots and the entries of cells
// of zero weight, then padded to the widest row with C*12.  The dropped
// entries are zeros (wdet = 0 scales every term of theirs), which leave a
// sum unchanged but for the sign of a zero result.  At the benchmark's mesh
// this matters: its 248 padded cells (cells_pad) all repeat cell 0's dofs,
// which makes dof_slots 255 wide (25 MB of int64, which the twin gathers
// through every step); packed it is 8 wide (0.39 MB).
//
// Bound: latency.  What it reads is ~2.8 MB at the benchmark's mesh (under
// 1 us at 3.35 TB/s) and the arithmetic ~4 MFLOP, so the time is two
// launches and the dependent round trips to device memory inside them.
// The design keeps those few:
//   * a block takes kCells cells with Q threads a cell: each thread loads its
//     (cell, q) slice of gphys and wdet into registers first, so those loads
//     overlap the gather of u through cell_dofs (the only dependent pair);
//     u's gathered values, phi and the weighted conv_i(q) go through shared
//     memory, and each of the block's (cell, 6i+a) entries is then one
//     thread's sum over q, written in order (coalesced);
//   * one thread per output dof sums its packed row.  The slots kernel is
//     launched as the cells kernel's programmatic dependent (Hopper's
//     griddepcontrol): it starts while the cells kernel runs, loads its
//     row's indices, which do not depend on it, and only then waits for
//     the cells kernel's relem, so its launch and its first round trip
//     overlap the cells kernel.
// No atomics: every sum has one owner and a fixed order, so the result
// repeats bit for bit from call to call.  Pad dofs (whose rows hold only the
// pad slot) come out +0 exactly.
//
// Plain C interface for ctypes; the entry points return cudaGetLastError()
// after the launches (0 on success).  The caller allocates relem (C*12 + 1
// entries) and out, and owns the stream; nothing here synchronises or
// allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBasis = 6;            // P2 basis functions a cell
constexpr int kLocal = 2 * kBasis;   // local velocity dofs a cell
constexpr int kCells = 8;            // cells a block
constexpr int kMaxPoints = 32;       // quadrature points a cell, at most
constexpr int kSlotThreads = 256;
constexpr int kPrefetch = 16;        // slots a row whose indices load early

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Block: kCells * Q threads; dynamic shared memory: phi (Q * 6), the cells'
// gathered u (kCells * 12) and wdet * conv (kCells * 2 * Q), all of T.
template <typename T>
__global__ void __launch_bounds__(kCells * kMaxPoints) convection_cells_kernel(
    const T* __restrict__ u, const int64_t* __restrict__ cell_dofs,
    const T* __restrict__ phi, const T* __restrict__ gphys,
    const T* __restrict__ wdet, T* __restrict__ relem, int C, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_phi = reinterpret_cast<T*>(smem);
  T* s_u = s_phi + Q * kBasis;
  T* s_w = s_u + kCells * kLocal;

  // Let the slots kernel start: it waits for this grid before reading relem.
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int c0 = blockIdx.x * kCells;
  // This thread's (cell, point).
  const int pc = tid / Q, q = tid % Q;
  const int c = c0 + pc;
  const bool live = c < C;

  T g[kBasis][2];
  T w = T(0);
  if (live) {
    const T* gc = gphys + (static_cast<size_t>(c) * kBasis * Q + q) * 2;
#pragma unroll
    for (int a = 0; a < kBasis; ++a) {
      g[a][0] = gc[static_cast<size_t>(a) * Q * 2];
      g[a][1] = gc[static_cast<size_t>(a) * Q * 2 + 1];
    }
    w = wdet[static_cast<size_t>(c) * Q + q];
  }
  for (int e = tid; e < Q * kBasis; e += nt) s_phi[e] = phi[e];
  for (int e = tid; e < kCells * kLocal; e += nt) {
    const size_t at = static_cast<size_t>(c0) * kLocal + e;
    s_u[e] = c0 + e / kLocal < C ? u[cell_dofs[at]] : T(0);
  }
  if (blockIdx.x == 0 && tid == 0) relem[static_cast<size_t>(C) * kLocal] = T(0);
  __syncthreads();

  if (live) {
    const T* U = s_u + pc * kLocal;
    const T* ph = s_phi + q * kBasis;
    T uq[2], du[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uq[i] = du[i][0] = du[i][1] = T(0);
#pragma unroll
      for (int a = 0; a < kBasis; ++a) {
        const T v = U[i * kBasis + a];
        uq[i] = fma_t(v, ph[a], uq[i]);
        du[i][0] = fma_t(v, g[a][0], du[i][0]);
        du[i][1] = fma_t(v, g[a][1], du[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const T conv = add_rn(mul_rn(uq[0], du[i][0]), mul_rn(uq[1], du[i][1]));
      s_w[(pc * 2 + i) * Q + q] = mul_rn(w, conv);
    }
  }
  __syncthreads();

  for (int e = tid; e < kCells * kLocal; e += nt) {
    const int cell = e / kLocal, r = e % kLocal;
    if (c0 + cell >= C) continue;
    const T* W = s_w + (cell * 2 + r / kBasis) * Q;
    const int a = r % kBasis;
    T acc = T(0);
    for (int p = 0; p < Q; ++p) acc = fma_t(W[p], s_phi[p * kBasis + a], acc);
    relem[static_cast<size_t>(c0) * kLocal + e] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSlotThreads) convection_slots_kernel(
    const T* __restrict__ relem, const int* __restrict__ slots,
    T* __restrict__ out, int ndofs, int S) {
  const int d = blockIdx.x * kSlotThreads + threadIdx.x;
  if (d >= ndofs) return;
  const int* row = slots + static_cast<size_t>(d) * S;
  int idx[kPrefetch];
#pragma unroll
  for (int s = 0; s < kPrefetch; ++s) idx[s] = s < S ? row[s] : 0;
  // Wait for the cells kernel to finish and its writes to be visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  T acc = relem[idx[0]];
#pragma unroll
  for (int s = 1; s < kPrefetch; ++s)
    if (s < S) acc = acc + relem[idx[s]];
  for (int s = kPrefetch; s < S; ++s) acc = acc + relem[row[s]];
  out[d] = acc;
}

template <typename T>
cudaError_t launch(const T* u, const int64_t* cell_dofs, const T* phi,
                   const T* gphys, const T* wdet, const int* slots,
                   T* relem, T* out, int C, int Q, int S, int ndofs,
                   cudaStream_t stream) {
  if (C < 0 || Q < 1 || Q > kMaxPoints || S < 1 || ndofs < 0)
    return cudaErrorInvalidValue;
  // At least one block, which writes the pad slot even with no cells.
  const int blocks = C > 0 ? (C + kCells - 1) / kCells : 1;
  const size_t smem = sizeof(T) * (Q * kBasis + kCells * kLocal + kCells * 2 * Q);
  convection_cells_kernel<T><<<blocks, kCells * Q, smem, stream>>>(
      u, cell_dofs, phi, gphys, wdet, relem, C, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ndofs == 0) return err;
  cudaLaunchAttribute dependent[1];
  dependent[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((ndofs + kSlotThreads - 1) / kSlotThreads);
  config.blockDim = dim3(kSlotThreads);
  config.stream = stream;
  config.attrs = dependent;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, convection_slots_kernel<T>,
                           static_cast<const T*>(relem),
                           static_cast<const int*>(slots), out, ndofs, S);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The caller guarantees 0 <= cell_dofs < ndofs and 0 <= slots <= C*12
// (ops/convection.py checks both once per table).
extern "C" int convection_f32(const float* u, const int64_t* cell_dofs,
                              const float* phi, const float* gphys,
                              const float* wdet, const int* slots,
                              float* relem, float* out, int C, int Q, int S,
                              int ndofs, void* stream) {
  return launch<float>(u, cell_dofs, phi, gphys, wdet, slots, relem, out, C,
                       Q, S, ndofs, static_cast<cudaStream_t>(stream));
}

extern "C" int convection_f64(const double* u, const int64_t* cell_dofs,
                              const double* phi, const double* gphys,
                              const double* wdet, const int* slots,
                              double* relem, double* out, int C, int Q, int S,
                              int ndofs, void* stream) {
  return launch<double>(u, cell_dofs, phi, gphys, wdet, slots, relem, out, C,
                        Q, S, ndofs, static_cast<cudaStream_t>(stream));
}

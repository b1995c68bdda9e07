"""Dense f32 matvec: every operator apply of the fused IPCS step.

Kernels (csrc/matvec.cu, CUDA C++ for sm_90a, bound with ctypes):

* `matvec` replaces meshdqn_tpu/ops/pallas_kernels.py:matvec_pallas
  (_mv_kernel): y = m @ x, x of shape (N,) or (N, k) with k <= 2.
* `matvec_dual` replaces meshdqn_tpu/ops/pallas_kernels.py:matvec_dual_pallas
  (_mv_dual_kernel): y = m @ x_hi + m @ x_lo, reading m once.  No caller in
  the port yet (nor in the JAX package's step).

Both are bound by the bytes of m (R * N * 4): a matvec does two flops per
matrix entry and reuses none of it.  The kernel therefore streams m exactly
once with coalesced 16-byte loads, one warp per row, while x sits in shared
memory; per-lane sums are reduced in a fixed shuffle order with no atomics,
so results are bit-reproducible (the ys930 lift error is phase noise seeded
by per-step rounding, so steps must be repeatable).

On CUDA tensors the wrappers launch the kernel or raise.  On CPU tensors
they use the plain versions `matvec_reference` / `matvec_dual_reference`,
which the tests hold against the JAX kernels.  Each wrapper counts its
launches in `<wrapper>.launches`.  On the card a kernel is held to its plain
version by `relative_gap(y, y_plain) <= gap_tolerance(N)`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# Largest dynamic shared memory a block may use on sm_90 (csrc/matvec.cu).
MAX_SMEM_BYTES = 232448

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


_LIB = None


def _lib():
    """csrc/matvec.cu's library, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = build.load("matvec")
        lib.matvec_f32.argtypes = [_c_void_p] * 3 + [_c_int] * 3 + [_c_void_p]
        lib.matvec_f32.restype = _c_int
        lib.matvec_dual_f32.argtypes = [_c_void_p] * 4 + [_c_int] * 3 + [_c_void_p]
        lib.matvec_dual_f32.restype = _c_int
        _LIB = lib
    return _LIB


def matvec_reference(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of `matvec`, in the inputs' dtype."""
    return m @ x


def matvec_dual_reference(
    m: torch.Tensor, x_hi: torch.Tensor, x_lo: torch.Tensor
) -> torch.Tensor:
    """Plain version of `matvec_dual`, in the inputs' dtype."""
    return m @ x_hi + m @ x_lo


def relative_gap(y: torch.Tensor, ref: torch.Tensor) -> float:
    """||y - ref|| / ||ref|| over all entries, in f64."""
    y, ref = y.double(), ref.double()
    return (torch.linalg.vector_norm(y - ref)
            / torch.linalg.vector_norm(ref)).item()


def gap_tolerance(n: int, dtype=torch.float32) -> float:
    """The `relative_gap` allowed between a kernel and its plain version for
    rows of n terms: 2 sqrt(n) u, with u = 2^-24 in f32 (and for bf16
    operands, which a kernel widens to f32 exactly) and 2^-53 in f64.

    Two sums of the same n products in different orders differ by a random
    walk of roundings; on unit-normal data its norm is about 0.1 sqrt(n) u of
    ||y|| (the kernel's order emulated against torch's on the CPU, n = 3 to
    6644), so the factor 2 leaves 6x headroom at small n and 20x at the
    step's widths.  Inputs rounded to TF32 (10-bit mantissa) land at
    >= 50 sqrt(n) 2^-24 and to bf16 at >= 400 sqrt(n) 2^-24, so a kernel
    that drops precision fails."""
    u = 2.0**-53 if dtype == torch.float64 else 2.0**-24
    return 2.0 * n**0.5 * u


def round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """f32 or f64 t rounded to `bits` mantissa bits (TF32 keeps 10, bf16 7):
    the inputs of a kernel that lost precision, which `gap_tolerance`
    rejects."""
    if t.dtype == torch.float64:
        drop, itype = 52 - bits, torch.int64
    else:
        drop, itype = 23 - bits, torch.int32
    i = t.contiguous().view(itype)
    return ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(t.dtype)


def _check(m: torch.Tensor, xs) -> tuple[int, int, int]:
    """Validate CUDA operands for the kernel; returns (R, N, k)."""
    if m.dim() != 2:
        raise ValueError(f"m must be 2-D, got shape {tuple(m.shape)}")
    R, N = m.shape
    shape = xs[0].shape
    if len(shape) not in (1, 2) or shape[0] != N:
        raise ValueError(f"x of shape {tuple(shape)} does not match m {(R, N)}")
    k = 1 if len(shape) == 1 else shape[1]
    if k not in (1, 2):
        raise ValueError(f"the kernel takes k in (1, 2) right-hand sides, got {k}")
    smem = N * k * len(xs) * 4
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"x needs {smem} bytes of shared memory, above the {MAX_SMEM_BYTES} "
            "a block may use"
        )
    if torch.cuda.current_device() != m.device.index:
        raise ValueError(
            f"m is on {m.device}, but the current device is cuda:"
            f"{torch.cuda.current_device()}"
        )
    for t in (m, *xs):
        if t.device != m.device:
            raise ValueError(f"operands on {t.device} and {m.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous operands")
    for t in xs[1:]:
        if t.shape != shape:
            raise ValueError(f"x_hi {tuple(shape)} and x_lo {tuple(t.shape)} differ")
    return R, N, k


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def matvec(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = m @ x for m (R, N) and x (N,) or (N, k<=2), f32 on CUDA."""
    if not m.is_cuda and not x.is_cuda:
        return matvec_reference(m, x)
    R, N, k = _check(m, (x,))
    y = torch.empty((R,) if x.dim() == 1 else (R, k),
                    dtype=torch.float32, device=m.device)
    err = _lib().matvec_f32(
        m.data_ptr(), x.data_ptr(), y.data_ptr(), R, N, k,
        torch.cuda.current_stream(m.device).cuda_stream,
    )
    _raise_on(err, "matvec_f32")
    matvec.launches += 1
    return y


def matvec_dual(
    m: torch.Tensor, x_hi: torch.Tensor, x_lo: torch.Tensor
) -> torch.Tensor:
    """y = m @ x_hi + m @ x_lo, streaming m once; f32 on CUDA."""
    if not (m.is_cuda or x_hi.is_cuda or x_lo.is_cuda):
        return matvec_dual_reference(m, x_hi, x_lo)
    R, N, k = _check(m, (x_hi, x_lo))
    y = torch.empty((R,) if x_hi.dim() == 1 else (R, k),
                    dtype=torch.float32, device=m.device)
    err = _lib().matvec_dual_f32(
        m.data_ptr(), x_hi.data_ptr(), x_lo.data_ptr(), y.data_ptr(), R, N, k,
        torch.cuda.current_stream(m.device).cuda_stream,
    )
    _raise_on(err, "matvec_dual_f32")
    matvec_dual.launches += 1
    return y


matvec.launches = 0
matvec_dual.launches = 0

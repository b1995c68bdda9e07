"""Fixed-iteration preconditioned conjugate gradients for the large-mesh step.

Counterpart of meshdqn_tpu/ops/cg.py.  The two large IPCS systems (A1, the
Crank-Nicolson velocity system, and A3, the mass) are SPD and
mass-dominated, so a handful of preconditioned CG iterations warm-started
from the previous step reach f32 rounding.  `pcg` runs exactly `iters`
iterations: no convergence test, so it never waits for the device, and each
iteration is one operator product (the banded or ELL kernel) plus a few
vector reductions.  Division guards keep a converged column (zero residual)
at alpha = beta = 0 instead of NaN, as in the JAX package.

Two paths, chosen by what the operands are:

* `pcg_fused`, on the card for a banded operator of f32 blocks, an f32
  BlockJacobi and m <= 2 columns (the production CG step): an iteration is
  two launches, each ending where a sum over the whole vector must finish
  (p.Ap for alpha, r.z for beta).  The direction update P = Z + beta P and
  p.Ap ride in the banded product (csrc/banded.cu, `banded_pcg_direction`);
  alpha, the axpys, the block-Jacobi product and r.z are one launch of
  csrc/pcg.cu's `pcg_update_kernel` (`pcg_update`).  2 (1 + iters) launches
  a solve, against ~21 torch ops an iteration.  Every sum of partials runs
  in one fixed order, so the bits repeat; they differ from the plain path's
  by the order of the sums alone.
* `pcg_reference`, everything else (CPU tensors, the ELL layout, f64, bf16
  blocks, Jacobi diagonals): the plain torch iteration.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.profiling import count
from . import build
from .banded import (BandedMatrix, _ptr, banded_pcg_direction, banded_pcg_residual,
                     product_blocks)
from .matvec import MAX_SMEM_BYTES


@dataclass
class BlockJacobi:
    """Block-Jacobi preconditioner: dense inverses of nb-sized diagonal
    blocks along the (RCM-reordered) diagonal.  Its product is one batched
    (B, nb, nb) x (B, nb, m) matrix product, `torch.bmm`: the JAX package
    computes it outside Pallas, as an einsum."""

    inv_blocks: torch.Tensor  # (B, nb, nb)
    n: int  # operator size; B*nb >= n, the tail padded with identity

    def apply(self, R: torch.Tensor) -> torch.Tensor:
        """Z = M^-1 R for (n, m) residuals."""
        B, nb, _ = self.inv_blocks.shape
        m = R.shape[1]
        Rp = torch.cat([R, R.new_zeros(B * nb - R.shape[0], m)])
        Z = torch.bmm(self.inv_blocks, Rp.view(B, nb, m))
        return Z.view(B * nb, m)[: R.shape[0]]


def block_jacobi_arrays(A, nb: int = 64) -> np.ndarray:
    """(B, nb, nb) f64 inverses of A's diagonal blocks, the tail block padded
    with identity: the host arrays of meshdqn_tpu's block_jacobi_inv."""
    A = A.tocsr()
    n = A.shape[0]
    nblocks = -(-n // nb)
    blocks = np.zeros((nblocks, nb, nb), dtype=np.float64)
    for b in range(nblocks):
        lo, hi = b * nb, min((b + 1) * nb, n)
        blk = np.eye(nb)
        blk[: hi - lo, : hi - lo] = A[lo:hi, lo:hi].toarray()
        blocks[b] = np.linalg.inv(blk)
    return blocks


def block_jacobi_inv(A, nb: int = 64, *, device,
                     dtype=torch.float32) -> BlockJacobi:
    """BlockJacobi of a scipy sparse matrix, inverted on the host in f64
    once per mesh and rounded to `dtype` on the host."""
    blocks = block_jacobi_arrays(A, nb)
    if dtype == torch.float32:
        blocks = blocks.astype(np.float32)
    return BlockJacobi(torch.tensor(blocks, device=device).to(dtype), A.shape[0])


def _prec_apply(prec, R: torch.Tensor) -> torch.Tensor:
    """A Jacobi diagonal (n,) or a BlockJacobi."""
    if isinstance(prec, BlockJacobi):
        return prec.apply(R)
    return prec[:, None] * R


def _guarded_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den > 0, else 0."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)


def pcg(A, dinv, B: torch.Tensor, X0: torch.Tensor, iters: int) -> torch.Tensor:
    """Solve A X = B (SPD, B and X0 of shape (n, m)) with `iters`
    preconditioned CG iterations; each column has its own alpha and beta.

    A is any operator with .matmat (ops.banded.BandedMatrix or
    ops.sparse.EllMatrix); dinv a (n,) Jacobi diagonal or a BlockJacobi.
    On CUDA tensors with a banded A of f32 blocks, an f32 BlockJacobi and
    m <= 2 it runs `pcg_fused`, else `pcg_reference` (the module's note).
    Makes 1 + iters products with A, counted as `pcg.products` while
    tracing is on (utils.profiling)."""
    count("pcg.products", 1 + iters)
    if (B.is_cuda and isinstance(A, BandedMatrix) and A.blocks.dtype == torch.float32
            and isinstance(dinv, BlockJacobi) and dinv.inv_blocks.dtype == torch.float32
            and B.dim() == 2 and B.shape[1] in (1, 2)):
        return pcg_fused(A, dinv, B, X0, iters)
    return pcg_reference(A, dinv, B, X0, iters)


def pcg_reference(A, dinv, B: torch.Tensor, X0: torch.Tensor,
                  iters: int) -> torch.Tensor:
    """pcg as plain torch ops around A's products: any operator with
    .matmat, any preconditioner, any dtype and device."""
    R = B - A.matmat(X0)
    Z = _prec_apply(dinv, R)
    P = Z
    rz = (R * Z).sum(dim=0)
    X = X0
    for _ in range(iters):
        AP = A.matmat(P)
        alpha = _guarded_div(rz, (P * AP).sum(dim=0))
        X = X + alpha * P
        R = R - alpha * AP
        Z = _prec_apply(dinv, R)
        rz_new = (R * Z).sum(dim=0)
        P = Z + _guarded_div(rz_new, rz) * P
        rz = rz_new
    return X


_LIB = None
# Rows of a block-Jacobi block that one thread block of pcg_update_kernel
# computes (csrc/pcg.cu kRows): ceil(nb / UPDATE_ROWS) r.z partials a block.
UPDATE_ROWS = 32


def _lib():
    """csrc/pcg.cu's library, built at first use, with its C signature."""
    global _LIB
    if _LIB is None:
        lib = build.load("pcg")
        lib.pcg_update_f32.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 2
                                       + [ctypes.c_void_p] * 8 + [ctypes.c_int]
                                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
        lib.pcg_update_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def update_partials(dinv: BlockJacobi) -> int:
    """The r.z partials a column of one pcg_update launch: one a thread block."""
    n_blocks, nb, _ = dinv.inv_blocks.shape
    return n_blocks * -(-nb // UPDATE_ROWS)


def pcg_update(dinv: BlockJacobi, X_in, X_out, P, AP, R_in: torch.Tensor, R_out,
               Z: torch.Tensor, pap, rz_in, rz_out: torch.Tensor, *, update: bool,
               precondition: bool) -> None:
    """One launch of pcg_update_kernel (csrc/pcg.cu): with `update`,
    alpha = sum(rz_in) / sum(pap) per column (0 where the latter is not
    positive), X_out = X_in + alpha P and, with `precondition`,
    R_out = R_in - alpha AP; with `precondition`, Z = dinv R (R_out, or
    without `update` R_in) and rz_out (m, update_partials(dinv)) its r.z
    partials.  R_out is not R_in.  The operands are checked by pcg_fused."""
    nb = dinv.inv_blocks.shape[1]
    err = _lib().pcg_update_f32(
        dinv.inv_blocks.data_ptr(), nb, dinv.n, _ptr(X_in), _ptr(X_out), _ptr(P), _ptr(AP),
        R_in.data_ptr(), _ptr(R_out), Z.data_ptr(), _ptr(pap),
        0 if pap is None else pap.shape[-1], _ptr(rz_in), rz_out.data_ptr(),
        rz_out.shape[-1], R_in.shape[1], int(update), int(precondition),
        torch.cuda.current_stream(R_in.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pcg_update_f32 launch failed: cudaError_t {err}")
    pcg_update.launches += 1


pcg_update.launches = 0


def _check_fused(A, dinv, B: torch.Tensor, X0: torch.Tensor) -> None:
    """Raise unless pcg_fused's kernels take these operands."""
    if not isinstance(A, BandedMatrix) or A.blocks.dtype != torch.float32:
        raise TypeError("pcg_fused takes a BandedMatrix of f32 blocks, got "
                        f"{type(A).__name__}"
                        + (f" of {A.blocks.dtype}" if isinstance(A, BandedMatrix) else ""))
    if not isinstance(dinv, BlockJacobi) or dinv.inv_blocks.dtype != torch.float32:
        raise TypeError("pcg_fused takes an f32 BlockJacobi, got "
                        + (f"{dinv.inv_blocks.dtype} blocks" if isinstance(dinv, BlockJacobi)
                           else f"a {type(dinv).__name__}"))
    if B.dim() != 2 or B.shape[1] not in (1, 2):
        raise ValueError(f"pcg_fused takes (n, m) right-hand sides, m in (1, 2), got "
                         f"{tuple(B.shape)}")
    n, m = B.shape
    n_rz, nb, nb2 = dinv.inv_blocks.shape
    if A.shape != (n, n) or X0.shape != B.shape or dinv.n != n or nb != nb2 \
            or n_rz != -(-n // nb):
        raise ValueError(f"A {A.shape}, B {tuple(B.shape)}, X0 {tuple(X0.shape)} and "
                         f"{n_rz} blocks of {nb} for n = {dinv.n} do not fit together")
    if B.dtype != torch.float32 or X0.dtype != torch.float32:
        raise TypeError(f"pcg_fused takes f32 B and X0, got {B.dtype} and {X0.dtype}")
    smem = max((UPDATE_ROWS * nb + nb * m) * 4, 2 * A.tiles.width * m * 4)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"blocks of {nb} or windows of {A.tiles.width} need {smem} "
                         f"bytes of shared memory, above the {MAX_SMEM_BYTES} a block "
                         f"may use")
    dev = A.tiles.values.device
    parts = (B, X0, dinv.inv_blocks, A.tiles.offsets, A.tiles.cols)
    if dev.type != "cuda" or any(p.device != dev for p in parts):
        raise ValueError(f"pcg_fused runs on one CUDA device, got tiles on {dev} and "
                         f"operands on {[str(p.device) for p in parts]}")
    if torch.cuda.current_device() != dev.index:
        raise ValueError(f"the operands are on {dev}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if not all(p.is_contiguous() for p in (*parts, A.tiles.values)):
        raise ValueError("pcg_fused takes contiguous operands")
    if A.tiles.values.data_ptr() % 16:
        raise ValueError("the packed tiles must start 16-byte aligned")


def pcg_fused(A: BandedMatrix, dinv: BlockJacobi, B: torch.Tensor, X0: torch.Tensor,
              iters: int) -> torch.Tensor:
    """pcg on the card in 2 (1 + iters) launches (the module's note): the
    iterations, guards, per-column alpha and beta and f32 sums of
    pcg_reference, the sums in another fixed order.  The last iteration
    updates X alone: its R, Z and r.z are never read.  Raises on operands
    the kernels do not take, before any launch.  Counts `pcg.fused` while
    tracing is on."""
    _check_fused(A, dinv, B, X0)
    n, m = B.shape
    n_rz, n_pap = update_partials(dinv), product_blocks(A)
    # One scratch allocation: Z, AP, pairs of residuals and directions (an
    # update reads one and writes the other), the p.Ap partials and a ring
    # of two r.z partials.
    scratch = torch.empty(6 * n * m + m * n_pap + 2 * m * n_rz, dtype=B.dtype,
                          device=B.device)
    Z, AP, R0, R1, P0, P1 = scratch[:6 * n * m].view(6, n, m)
    pap = scratch[6 * n * m:6 * n * m + m * n_pap].view(m, n_pap)
    rz = scratch[6 * n * m + m * n_pap:].view(2, m, n_rz)
    Rs, Ps = (R0, R1), (P0, P1)
    X = torch.empty_like(X0) if iters else X0
    banded_pcg_residual(A, B, X0, R0)
    pcg_update(dinv, None, None, None, None, R0, None, Z, None, None, rz[0], update=False,
               precondition=True)
    X_in = X0
    for k in range(iters):
        banded_pcg_direction(A, Z, Ps[(k - 1) % 2] if k else None, Ps[k % 2], AP,
                             rz[k % 2], rz[(k - 1) % 2], pap)
        pcg_update(dinv, X_in, X, Ps[k % 2], AP, Rs[k % 2], Rs[(k + 1) % 2], Z, pap,
                   rz[k % 2], rz[(k + 1) % 2], update=True, precondition=k < iters - 1)
        X_in = X
    count("pcg.fused")
    return X


def jacobi_inv(A) -> torch.Tensor:
    """1 / diag(A) from an EllMatrix (1 where the diagonal is 0)."""
    rows = torch.arange(A.shape[0], device=A.cols.device)
    diag = torch.where(A.cols == rows[:, None], A.vals, 0.0).sum(dim=1)
    nz = diag != 0
    return torch.where(nz, 1.0 / torch.where(nz, diag, 1.0), 1.0)

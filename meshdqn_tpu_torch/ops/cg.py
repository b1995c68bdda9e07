"""Fixed-iteration preconditioned conjugate gradients for the large-mesh step.

Counterpart of meshdqn_tpu/ops/cg.py.  The two large IPCS systems (A1, the
Crank-Nicolson velocity system, and A3, the mass) are SPD and
mass-dominated, so a handful of preconditioned CG iterations warm-started
from the previous step reach f32 rounding.  `pcg` runs exactly `iters`
iterations: no convergence test, so it never waits for the device, and each
iteration is one operator product (the banded or ELL kernel) plus a few
vector reductions.  Division guards keep a converged column (zero residual)
at alpha = beta = 0 instead of NaN, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.profiling import count


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
    Makes 1 + iters products with A, counted as `pcg.products` while
    tracing is on (utils.profiling)."""
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
    count("pcg.products", 1 + iters)
    return X


def jacobi_inv(A) -> torch.Tensor:
    """1 / diag(A) from an EllMatrix (1 where the diagonal is 0)."""
    rows = torch.arange(A.shape[0], device=A.cols.device)
    diag = torch.where(A.cols == rows[:, None], A.vals, 0.0).sum(dim=1)
    nz = diag != 0
    return torch.where(nz, 1.0 / torch.where(nz, diag, 1.0), 1.0)

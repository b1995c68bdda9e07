"""Sparse matrix products in the ELL (padded per-row) layout.

Counterpart of meshdqn_tpu/ops/sparse.py.  FEM operators have bounded,
near-uniform row occupancy, so each row keeps K (column, value) pairs; pad
entries have column 0 and value 0 and are summed like the others, so the
product needs no mask.

Kernel (csrc/ell.cu, CUDA C++ for sm_90a, bound with ctypes):

* `ell_matmat` replaces meshdqn_tpu/ops/pallas_kernels.py:ell_matvec_pallas
  (_ell_kernel, :39 / :57): Y[r] = sum_k vals[r, k] X[cols[r, k]], for X of
  shape (n,) or (n, m) with m <= 2, in f32 or f64.

It is bound by the bytes of cols and vals (R K (4 + 4 or 8)): each entry is
used once.  x is at most 30k rows (240 KB in f64) and stays in L2 across
the launch, so the gathers cost L2 bandwidth, not device memory.  The design
gives each row one warp, whose lanes read the row's entries coalesced and
gather x through the read-only cache; per-lane sums are reduced by a fixed
xor-shuffle tree, with no atomics, so results repeat bit for bit.

On CUDA tensors `ell_matmat` launches the kernel or raises; on CPU tensors
it uses the plain version `ell_matmat_reference`.  `ell_matmat.launches`
counts kernel launches, `ell_matmat_reference.calls` calls of the plain
version.  On the card the kernel is held to its plain version by
`relative_gap(y, plain) <= gap_tolerance(K, dtype)` (ops/matvec.py).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from . import build

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int

_LIB = None


def _lib():
    """csrc/ell.cu's library, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = build.load("ell")
        for fn in (lib.ell_matmat_f32, lib.ell_matmat_f64):
            fn.argtypes = [_c_void_p] * 4 + [_c_int] * 4 + [_c_void_p]
            fn.restype = _c_int
        _LIB = lib
    return _LIB


def ell_matmat_reference(cols: torch.Tensor, vals: torch.Tensor,
                         X: torch.Tensor) -> torch.Tensor:
    """Plain version of `ell_matmat`, in the inputs' dtype."""
    ell_matmat_reference.calls += 1
    if X.dim() == 1:
        return (vals * X[cols]).sum(dim=1)
    return torch.einsum("rk,rkm->rm", vals, X[cols])


def _check(cols, vals, X) -> tuple[int, int, int, int]:
    """Validate CUDA operands for the kernel; returns (R, K, n, m)."""
    if cols.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and vals {tuple(vals.shape)} "
                         "must be the same (R, K)")
    R, K = cols.shape
    if X.dim() not in (1, 2):
        raise ValueError(f"X must be (n,) or (n, m), got {tuple(X.shape)}")
    n = X.shape[0]
    m = 1 if X.dim() == 1 else X.shape[1]
    if m not in (1, 2):
        raise ValueError(f"the kernel takes m in (1, 2) right-hand sides, got {m}")
    if torch.cuda.current_device() != vals.device.index:
        raise ValueError(f"vals is on {vals.device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    for t in (cols, X):
        if t.device != vals.device:
            raise ValueError(f"operands on {t.device} and {vals.device}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if vals.dtype not in (torch.float32, torch.float64) or X.dtype != vals.dtype:
        raise TypeError(f"vals and X must both be float32 or float64, got "
                        f"{vals.dtype} and {X.dtype}")
    for t in (cols, vals, X):
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous operands")
    return R, K, n, m


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def ell_matmat(cols: torch.Tensor, vals: torch.Tensor,
               X: torch.Tensor) -> torch.Tensor:
    """Y[r] = sum_k vals[r, k] * X[cols[r, k]]; X (n,) or (n, m<=2).

    The caller guarantees 0 <= cols < n (EllMatrix does)."""
    if not (cols.is_cuda or vals.is_cuda or X.is_cuda):
        return ell_matmat_reference(cols, vals, X)
    R, K, n, m = _check(cols, vals, X)
    Y = torch.empty((R,) if X.dim() == 1 else (R, m), dtype=vals.dtype,
                    device=vals.device)
    name = "ell_matmat_f32" if vals.dtype == torch.float32 else "ell_matmat_f64"
    err = getattr(_lib(), name)(
        cols.data_ptr(), vals.data_ptr(), X.data_ptr(), Y.data_ptr(), R, K, n, m,
        torch.cuda.current_stream(vals.device).cuda_stream,
    )
    _raise_on(err, name)
    ell_matmat.launches += 1
    return Y


ell_matmat.launches = 0
ell_matmat_reference.calls = 0


def ell_arrays(A: sp.spmatrix) -> tuple[np.ndarray, np.ndarray]:
    """(cols int32, vals f64) of A in ELL layout, row entries in CSR order:
    the arrays meshdqn_tpu's EllMatrix.from_scipy builds, without its
    per-row loop."""
    A = sp.csr_matrix(A, copy=True)
    A.sum_duplicates()
    A.eliminate_zeros()
    R = A.shape[0]
    counts = np.diff(A.indptr)
    K = max(int(counts.max(initial=0)), 1)
    rows = np.repeat(np.arange(R), counts)
    slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    cols = np.zeros((R, K), dtype=np.int32)
    vals = np.zeros((R, K), dtype=np.float64)
    cols[rows, slot] = A.indices
    vals[rows, slot] = A.data
    return cols, vals


@dataclass
class EllMatrix:
    """Padded sparse matrix on one device: cols (R, K) int32, vals (R, K)."""

    cols: torch.Tensor
    vals: torch.Tensor
    shape: tuple

    @classmethod
    def from_scipy(cls, A: sp.spmatrix, *, device,
                   dtype=torch.float64) -> "EllMatrix":
        cols, vals = ell_arrays(A)
        return cls.from_arrays(cols, vals, A.shape, device=device, dtype=dtype)

    @classmethod
    def from_arrays(cls, cols, vals, shape, *, device, dtype) -> "EllMatrix":
        """From numpy arrays; vals are rounded to `dtype` (float32 or
        float64) on the host, as JAX rounds them."""
        np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
        return cls(
            cols=torch.tensor(np.asarray(cols, dtype=np.int32), device=device),
            vals=torch.tensor(np.asarray(vals).astype(np_dtype), device=device),
            shape=tuple(int(s) for s in shape),
        )

    @property
    def nbytes(self) -> int:
        return (self.cols.numel() * self.cols.element_size()
                + self.vals.numel() * self.vals.element_size())

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat(x)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for X (n_cols,) or (n_cols, m<=2)."""
        if X.shape[0] != self.shape[1]:
            raise ValueError(f"X of shape {tuple(X.shape)} does not match "
                             f"{self.shape}")
        return ell_matmat(self.cols, self.vals, X)

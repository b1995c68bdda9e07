"""Gather-free banded-block sparse products for RCM-reordered FEM operators.

Counterpart of meshdqn_tpu/ops/banded.py.  After a reverse Cuthill-McKee
reordering every column of row r lies in a window around the diagonal, so
the matrix is stored as dense row blocks over that window:

    blocks[b, i, j] = A[b*R + i, s_b - pad + j]                 (B, R, W)

with s_b = b*g (the plain layout) or floor(b*g/128)*128 (`aligned128`), and
g = round(R n_cols / n_rows) the column advance per row block (R for square
operators, R/2 for (2Ns x Ns), 2R for (Ns x 2Ns)).  The JAX package made
this layout because the TPU's gathers were slow; it stays the port's
production layout of the CG step so that the two packages run the same
algebra (the ELL layout of ops/sparse.py is the other option).

Kernel (csrc/banded.cu, CUDA C++ for sm_90a, bound with ctypes):

* `banded_matmat` replaces, in meshdqn_tpu/ops/pallas_kernels.py,
  banded_matmat_pallas (_banded_kernel, :250 / :281) for the plain layout
  and banded_matmat_pallas_aligned (_banded_aligned_kernel, :318 / :352) for
  the aligned one, and scripts/banded_formulation_bench.py:make_pl_kernel
  (:180), the R = 128 aligned product with f32 or bf16 blocks.  Blocks are
  f32, bf16 (f32 X and Y, f32 accumulation) or f64.

It is bound by the stored bytes of blocks (B R W entries, most of them the
band's zero fill), read once; X and Y are a few hundred KB.  The kernel
gives each row block one thread block, which stages the block's x window in
shared memory straight from X (no padded copy of X is made), streams the
block's rows with 16-byte loads, one warp per row, and reduces each row by a
fixed shuffle tree, so results repeat bit for bit.

On CUDA tensors `banded_matmat` launches the kernel or raises; on CPU
tensors it uses the plain version `banded_matmat_reference`.
`banded_matmat.launches` counts kernel launches,
`banded_matmat_reference.calls` calls of the plain version.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from . import build
from .matvec import MAX_SMEM_BYTES

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int

_LIB = None

# Blocks dtype -> (C entry point, dtype of X and Y).
_ENTRY = {
    torch.float32: ("banded_matmat_f32", torch.float32),
    torch.bfloat16: ("banded_matmat_bf16", torch.float32),
    torch.float64: ("banded_matmat_f64", torch.float64),
}


def _lib():
    """csrc/banded.cu's library, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = build.load("banded")
        for name, _ in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [_c_void_p] * 3 + [_c_int] * 9 + [_c_void_p]
            fn.restype = _c_int
        _LIB = lib
    return _LIB


def rcm_permutation(pattern: sp.spmatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a symmetric sparsity pattern;
    perm[new] = old (A[perm][:, perm] has reduced bandwidth)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(
        reverse_cuthill_mckee(pattern.tocsr(), symmetric_mode=True),
        dtype=np.int64,
    )


def permute_interleave_u(Ns: int, rank_s: np.ndarray) -> np.ndarray:
    """new2old map of the velocity space: concatenated [ux; uy] (old) to
    component-interleaved scalar-RCM order (new),
    new2old[2*rank_s[j] + c] = c*Ns + j."""
    new2old = np.empty(2 * Ns, dtype=np.int64)
    j = np.arange(Ns)
    new2old[2 * rank_s] = j
    new2old[2 * rank_s + 1] = Ns + j
    return new2old


def window_starts(B: int, g: int, aligned: bool) -> np.ndarray:
    """s_b for b < B: each row block's window start in padded coordinates."""
    bg = np.arange(B, dtype=np.int64) * g
    return (bg // 128) * 128 if aligned else bg


def banded_matmat_reference(blocks: torch.Tensor, X: torch.Tensor, *, pad: int,
                            g: int, aligned: bool, n_rows: int) -> torch.Tensor:
    """Plain version of `banded_matmat`: gather each block's window of x
    (zero outside [0, n_cols)) and contract, in f32 for f32 and bf16 blocks
    and f64 for f64 blocks."""
    banded_matmat_reference.calls += 1
    B, R, W = blocks.shape
    acc = torch.float64 if blocks.dtype == torch.float64 else torch.float32
    X2 = (X[:, None] if X.dim() == 1 else X).to(acc)
    n_cols, m = X2.shape
    idx = (torch.as_tensor(window_starts(B, g, aligned) - pad, device=X.device)[:, None]
           + torch.arange(W, device=X.device))  # (B, W) x index
    inside = (idx >= 0) & (idx < n_cols)
    win = X2[idx.clamp(0, max(n_cols - 1, 0))] * inside[..., None]  # (B, W, m)
    Y = torch.bmm(blocks.to(acc), win).reshape(B * R, m)[:n_rows]
    return Y[:, 0] if X.dim() == 1 else Y


def _check(blocks, X, pad, g, n_rows):
    """Validate CUDA operands for the kernel; returns (B, R, W, n_cols, m)."""
    if blocks.dim() != 3:
        raise ValueError(f"blocks must be (B, R, W), got {tuple(blocks.shape)}")
    B, R, W = blocks.shape
    if blocks.dtype not in _ENTRY:
        raise TypeError(f"blocks must be float32, bfloat16 or float64, got {blocks.dtype}")
    xdt = _ENTRY[blocks.dtype][1]
    if X.dtype != xdt:
        raise TypeError(f"{blocks.dtype} blocks take {xdt} X, got {X.dtype}")
    if X.dim() not in (1, 2):
        raise ValueError(f"X must be (n,) or (n, m), got {tuple(X.shape)}")
    n_cols = X.shape[0]
    m = 1 if X.dim() == 1 else X.shape[1]
    if m not in (1, 2):
        raise ValueError(f"the kernel takes m in (1, 2) right-hand sides, got {m}")
    if W % 8:
        raise ValueError(f"W = {W} is not a multiple of 8")
    if not 0 <= n_rows <= B * R or g < 1 or pad < 0:
        raise ValueError(f"n_rows={n_rows}, g={g}, pad={pad} do not fit blocks {B, R, W}")
    smem = W * m * X.element_size()
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"the x window needs {smem} bytes of shared memory, above "
                         f"the {MAX_SMEM_BYTES} a block may use")
    if torch.cuda.current_device() != blocks.device.index:
        raise ValueError(f"blocks is on {blocks.device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if X.device != blocks.device:
        raise ValueError(f"operands on {X.device} and {blocks.device}")
    if not (blocks.is_contiguous() and X.is_contiguous()):
        raise ValueError("the kernel takes contiguous operands")
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must start 16-byte aligned")
    return B, R, W, n_cols, m


def banded_matmat(blocks: torch.Tensor, X: torch.Tensor, *, pad: int, g: int,
                  aligned: bool, n_rows: int) -> torch.Tensor:
    """Y = A @ X for a banded layout (see the module note); X (n_cols,) or
    (n_cols, m<=2)."""
    if not (blocks.is_cuda or X.is_cuda):
        return banded_matmat_reference(blocks, X, pad=pad, g=g, aligned=aligned,
                                       n_rows=n_rows)
    B, R, W, n_cols, m = _check(blocks, X, pad, g, n_rows)
    name, ydt = _ENTRY[blocks.dtype]
    Y = torch.empty((n_rows,) if X.dim() == 1 else (n_rows, m), dtype=ydt,
                    device=blocks.device)
    err = getattr(_lib(), name)(
        blocks.data_ptr(), X.data_ptr(), Y.data_ptr(), B, R, W, g, pad,
        int(aligned), n_rows, n_cols, m,
        torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    banded_matmat.launches += 1
    return Y


banded_matmat.launches = 0
banded_matmat_reference.calls = 0


def banded_layout(A: sp.spmatrix, R: int = 128, g: int | None = None,
                  aligned128: bool = False):
    """The layout meshdqn_tpu's BandedMatrix.from_scipy computes, as host
    arrays: (flat index into the (B*R*W,) blocks, f64 values, B, W, pad, g)."""
    A = sp.csr_matrix(A, copy=True)
    A.sum_duplicates()
    A.eliminate_zeros()
    n_rows, n_cols = A.shape
    if g is None:
        g = max(int(round(R * n_cols / n_rows)), 1)
    coo = A.tocoo()
    row = coo.row.astype(np.int64)
    col = coo.col.astype(np.int64)
    B = -(-n_rows // R)
    b = row // R
    pad = int(max(0, (b * g - col).max())) if len(row) else 0
    if aligned128:
        j = col + pad - (b * g // 128) * 128
    else:
        j = col - b * g + pad
    W_req = int(j.max()) + 1 if len(row) else 1
    # W a multiple of lcm(g, 128), as the JAX layout takes it (g | W for its
    # window reshape, 128 | W for lane-aligned blocks), and wide enough that
    # the padded x covers [0, n_cols).
    align = int(np.lcm(g, 128))
    W = -(-W_req // align) * align
    while (B + W // g - 1) * g < n_cols + pad:
        W += align
    return row * W + j, coo.data, B, W, pad, g


@dataclass
class BandedMatrix:
    """Dense banded row blocks on one device: blocks (B, R, W); block b's
    window starts at window_starts(B, g, aligned128)[b] - pad."""

    blocks: torch.Tensor
    pad: int
    g: int
    shape: tuple
    aligned128: bool = False

    @classmethod
    def from_scipy(cls, A: sp.spmatrix, *, device, dtype=torch.float32,
                   R: int = 128, g: int | None = None,
                   aligned128: bool = False) -> "BandedMatrix":
        """Build from a (reordered) scipy matrix.  R defaults to 128, the
        JAX package's TPU production layout, on every device.  The blocks
        are written on `device` from the (index, value) pairs, each index
        once, so the write is deterministic; values are rounded to `dtype`
        as the JAX package rounds them."""
        flat, vals, B, W, pad, g = banded_layout(A, R, g, aligned128)
        if dtype == torch.float32:
            vals = vals.astype(np.float32)
        blocks = torch.zeros(B * R * W, dtype=dtype, device=device)
        blocks[torch.as_tensor(flat, device=device)] = torch.as_tensor(vals).to(
            device=device, dtype=dtype)
        return cls(blocks=blocks.view(B, R, W), pad=pad, g=g,
                   shape=tuple(int(s) for s in A.shape), aligned128=aligned128)

    @property
    def nbytes(self) -> int:
        return self.blocks.numel() * self.blocks.element_size()

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for X (n_cols,) or (n_cols, m<=2)."""
        if X.shape[0] != self.shape[1]:
            raise ValueError(f"X of shape {tuple(X.shape)} does not match "
                             f"{self.shape}")
        return banded_matmat(self.blocks, X, pad=self.pad, g=self.g,
                             aligned=self.aligned128, n_rows=self.shape[0])

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat(x)

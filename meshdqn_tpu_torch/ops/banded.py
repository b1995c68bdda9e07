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
  f32, bf16 (f32 X and Y, f32 accumulation) or f64.  With bf16 blocks in
  the plain layout, x and each product are rounded to bf16, as the JAX
  package's banded_matmat rounds them (`banded_matmat_reference`).

The dense blocks hold 80-220x the operator's nonzeros, and the zeros
cluster: on the finest meshes 2-12% of a window's 128-byte row segments
hold a nonzero.  So the kernel does not read the blocks.  It reads
`BandTiles`, each row's nonempty 128-byte segments ("tiles") packed
contiguously with a CSR-like index (one int32 offset per row, one int32
column-tile index per tile), built once per operator from the same (index,
value) pairs as the blocks.  It is bound by those bytes; X and Y are a few
hundred KB.  Each warp computes 8 rows: its block stages the row block's
window of X in shared memory with asynchronous copies (zero outside
[0, n_cols), so no padded copy of X is made), the warp streams its rows'
tiles with 16-byte loads and reduces each row by a fixed shuffle tree, so
results repeat bit for bit.  The blocks stay on the object: they are the
JAX package's layout, bit for bit, and the input of the plain version.

The PCG iteration's products (ops/cg.py pcg_fused) are two more instances
of the same kernel: `banded_pcg_residual` (R = B - A X0, a solve's first
product) and `banded_pcg_direction` (P = Z + beta P_old formed in the
block's window, A P, and one p.Ap partial a block and column); see
csrc/banded.cu.  They count as banded_matmat's launches.

`banded_matmat(A, X)` takes the whole (frozen) BandedMatrix, so the tiles
it reads and the blocks they came from cannot drift apart.  On CUDA
tensors it launches the kernel or raises; on CPU tensors it uses the plain
version `banded_matmat_reference`, which computes
from the dense blocks, independently of the packing.
`banded_matmat.launches` counts kernel launches (and `banded.launches`
while tracing is on, utils.profiling), `banded_matmat_reference.calls`
calls of the plain version.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..utils.profiling import count
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


# The packed tiles (csrc/banded.cu): one row of a row block by TILE_BYTES of
# its window, i.e. 32 f32, 64 bf16 or 16 f64 entries.  R must be a multiple
# of WARP_ROWS, the rows one warp of the kernel computes.
WARP_ROWS = 8
TILE_BYTES = 128


def _lib():
    """csrc/banded.cu's library, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = build.load("banded")
        for name, _ in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [_c_void_p] * 5 + [_c_int] * 10 + [_c_void_p]
            fn.restype = _c_int
        lib.banded_pcg_f32.argtypes = ([_c_void_p] * 5 + [_c_int] * 10 + [_c_void_p] * 5
                                       + [_c_int, _c_void_p, _c_int, _c_void_p])
        lib.banded_pcg_f32.restype = _c_int
        _LIB = lib
    return _LIB


def tile_width(dtype: torch.dtype) -> int:
    """Entries of one tile row: TILE_BYTES of `dtype`."""
    return TILE_BYTES // (torch.finfo(dtype).bits // 8)


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
    and f64 for f64 blocks.  bf16 blocks in the plain layout take x rounded
    to bf16 and round each product to bf16 before the f32 sum, as the JAX
    package's banded_matmat does on them (meshdqn_tpu/ops/banded.py:241:
    `Z.astype(blocks.dtype)`, a bf16 multiply); in the aligned layout x and
    the products stay f32, as in its aligned Pallas kernel."""
    banded_matmat_reference.calls += 1
    B, R, W = blocks.shape
    acc = torch.float64 if blocks.dtype == torch.float64 else torch.float32
    X2 = (X[:, None] if X.dim() == 1 else X).to(acc)
    n_cols, m = X2.shape
    idx = (torch.as_tensor(window_starts(B, g, aligned) - pad, device=X.device)[:, None]
           + torch.arange(W, device=X.device))  # (B, W) x index
    inside = (idx >= 0) & (idx < n_cols)
    win = X2[idx.clamp(0, max(n_cols - 1, 0))] * inside[..., None]  # (B, W, m)
    if blocks.dtype == torch.bfloat16 and not aligned:
        prods = blocks.float()[..., None] * win.bfloat16().float()[:, None]  # (B, R, W, m)
        Y = prods.bfloat16().float().sum(dim=2).reshape(B * R, m)[:n_rows]
    else:
        Y = torch.bmm(blocks.to(acc), win).reshape(B * R, m)[:n_rows]
    return Y[:, 0] if X.dim() == 1 else Y


@dataclass(frozen=True)
class BandTiles:
    """The nonempty tiles of a stored band (B, R, W), packed for the kernel.

    Each of the B*R rows of the (B*R, W) band is cut into column tiles of
    T = tile_width(dtype) entries.  Row q's nonempty tiles are
    values[offsets[q]:offsets[q+1]], in ascending column order; tile k covers
    window columns cols[k]*T ... cols[k]*T + T-1:

        values[k, t] = blocks[q, cols[k]*T + t]   (as rows of the (B*R, W)
        band), and every entry of blocks outside the tiles is 0.

    The index is checked once, when the object is made; the kernel trusts
    it."""

    values: torch.Tensor  # (n_tiles, T)
    offsets: torch.Tensor  # (B*R + 1,) int32
    cols: torch.Tensor  # (n_tiles,) int32
    width: int  # W

    def __post_init__(self):
        if self.values.dim() != 2:
            raise ValueError(f"values must be (n_tiles, T), got {tuple(self.values.shape)}")
        n_tiles, T = self.values.shape
        if T != tile_width(self.values.dtype):
            raise ValueError(f"{self.values.dtype} tiles are {tile_width(self.values.dtype)}"
                             f" wide, got {T}")
        if self.offsets.dtype != torch.int32 or self.cols.dtype != torch.int32:
            raise TypeError(f"offsets and cols must be int32, got {self.offsets.dtype}"
                            f" and {self.cols.dtype}")
        if self.offsets.dim() != 1 or self.offsets.numel() < 1:
            raise ValueError(f"offsets must be (n_rows + 1,), got "
                             f"{tuple(self.offsets.shape)}")
        if self.cols.shape != (n_tiles,):
            raise ValueError(f"cols must be ({n_tiles},), got {tuple(self.cols.shape)}")
        if self.width < T or self.width % T:
            raise ValueError(f"W = {self.width} is not a multiple of the tile width {T}")
        off = self.offsets.cpu().numpy().astype(np.int64)
        if off[0] != 0 or off[-1] != n_tiles or (np.diff(off) < 0).any():
            raise ValueError(f"tile offsets must rise from 0 to {n_tiles}")
        c = self.cols.cpu().numpy()
        if ((c < 0) | (c >= self.width // T)).any():
            raise ValueError(f"column tiles must lie in [0, {self.width // T})")
        # Strictly ascending inside each row (a row's first tile is free).
        rising = np.diff(c) > 0
        rising[off[(off > 0) & (off < n_tiles)] - 1] = True
        if not rising.all():
            raise ValueError("a row's column tiles must be ascending and distinct")

    @classmethod
    def from_pairs(cls, flat: np.ndarray, vals: torch.Tensor, shape: tuple) -> "BandTiles":
        """From the (flat index into the (B*R*W,) blocks, value) pairs of a
        band of `shape` (B, R, W), each index once: the index is computed on
        the host, the values written on vals' device, each position once, so
        the build is deterministic."""
        B, R, W = shape
        T = tile_width(vals.dtype)
        if W < T or W % T:
            raise ValueError(f"blocks {B, R, W} do not cut into tiles of {T} entries")
        row, j = np.divmod(np.asarray(flat, dtype=np.int64), W)
        n_ct = W // T
        keys, tile = np.unique(row * n_ct + j // T, return_inverse=True)
        offsets = np.searchsorted(keys // n_ct, np.arange(B * R + 1))
        values = torch.zeros(len(keys) * T, dtype=vals.dtype, device=vals.device)
        values[torch.as_tensor(tile.reshape(-1) * T + j % T, device=vals.device)] = vals
        return cls(values=values.view(len(keys), T),
                   offsets=torch.tensor(offsets.astype(np.int32), device=vals.device),
                   cols=torch.tensor((keys % n_ct).astype(np.int32), device=vals.device),
                   width=W)

    @classmethod
    def from_blocks(cls, blocks: torch.Tensor) -> "BandTiles":
        """From dense blocks (B, R, W): their nonzero entries are the pairs."""
        flat = torch.nonzero(blocks.reshape(-1)).squeeze(1)
        return cls.from_pairs(flat.cpu().numpy(), blocks.reshape(-1)[flat],
                              tuple(blocks.shape))

    @property
    def nbytes(self) -> int:
        """What the kernel reads of the operator: packed values and index."""
        return sum(t.numel() * t.element_size()
                   for t in (self.values, self.offsets, self.cols))

    @property
    def occupancy(self) -> float:
        """Share of the band's tiles that hold a nonzero."""
        n_rows = self.offsets.numel() - 1
        return self.values.shape[0] / max(n_rows * (self.width // self.values.shape[1]), 1)


def _check(A, X):
    """Validate CUDA operands of A @ X for the kernel; returns m."""
    t = A.tiles
    if A.blocks.dtype not in _ENTRY:
        raise TypeError(f"blocks must be float32, bfloat16 or float64, got "
                        f"{A.blocks.dtype}")
    xdt = _ENTRY[A.blocks.dtype][1]
    if X.dtype != xdt:
        raise TypeError(f"{A.blocks.dtype} blocks take {xdt} X, got {X.dtype}")
    m = 1 if X.dim() == 1 else X.shape[1]
    if m not in (1, 2):
        raise ValueError(f"the kernel takes m in (1, 2) right-hand sides, got {m}")
    smem = t.width * m * X.element_size()
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"the x window needs {smem} bytes of shared memory, above "
                         f"the {MAX_SMEM_BYTES} a block may use")
    dev = t.values.device
    if torch.cuda.current_device() != dev.index:
        raise ValueError(f"the tiles are on {dev}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    parts = (X, t.offsets, t.cols)
    if any(p.device != dev for p in parts):
        raise ValueError(f"operands on {[str(p.device) for p in parts]}, tiles on {dev}")
    if not all(p.is_contiguous() for p in (t.values, *parts)):
        raise ValueError("the kernel takes contiguous operands")
    if t.values.data_ptr() % 16:
        raise ValueError("the packed tiles must start 16-byte aligned")
    return m


def banded_matmat(A: "BandedMatrix", X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a banded operator (see the module note); X (n_cols,)
    or (n_cols, m<=2).  On the card the kernel reads A's packed tiles; on
    the CPU the plain version reads its dense blocks."""
    if X.dim() not in (1, 2) or X.shape[0] != A.shape[1]:
        raise ValueError(f"X must be ({A.shape[1]},) or ({A.shape[1]}, m), got "
                         f"{tuple(X.shape)}")
    kw = dict(pad=A.pad, g=A.g, aligned=A.aligned128, n_rows=A.shape[0])
    if not (A.blocks.is_cuda or X.is_cuda):
        return banded_matmat_reference(A.blocks, X, **kw)
    m = _check(A, X)
    t = A.tiles
    B, R, W = A.blocks.shape
    name, ydt = _ENTRY[A.blocks.dtype]
    Y = torch.empty((A.shape[0],) if X.dim() == 1 else (A.shape[0], m), dtype=ydt,
                    device=X.device)
    err = getattr(_lib(), name)(
        t.values.data_ptr(), t.offsets.data_ptr(), t.cols.data_ptr(), X.data_ptr(),
        Y.data_ptr(), B, R, W, A.g, A.pad, int(A.aligned128), A.shape[0], A.shape[1],
        t.values.shape[0], m, torch.cuda.current_stream(X.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    banded_matmat.launches += 1
    count("banded.launches")
    if A.blocks.dtype == torch.bfloat16:
        banded_matmat.bf16_launches += 1  # banded_matmat_bf16 (TPU kernel #6)
    return Y


def product_blocks(A: "BandedMatrix") -> int:
    """The blocks of one kernel launch on A (csrc/banded.cu grid_of): up to
    4 warps of 8 rows, as many as divide a row block's warps."""
    R = A.blocks.shape[1]
    per_block = 4
    while (R // WARP_ROWS) % per_block:
        per_block //= 2
    warps = -(-A.shape[0] // WARP_ROWS)
    return -(-warps // per_block)


_RESIDUAL, _DIRECTION = 1, 2  # csrc/banded.cu PcgMode


def _ptr(t):
    """t's data pointer, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def _pcg_launch(A, mode, X, Y, B=None, P_old=None, P_new=None, rz=None, rz_old=None,
                pap=None):
    """One launch of a PCG instance; the operands are checked by the
    caller (ops/cg.py pcg_fused), the launch's shape by the C entry."""
    t = A.tiles
    n_b, R, W = A.blocks.shape
    err = _lib().banded_pcg_f32(
        t.values.data_ptr(), t.offsets.data_ptr(), t.cols.data_ptr(), X.data_ptr(),
        Y.data_ptr(), n_b, R, W, A.g, A.pad, int(A.aligned128), A.shape[0],
        t.values.shape[0], X.shape[1], mode, _ptr(B), _ptr(P_old), _ptr(P_new), _ptr(rz),
        _ptr(rz_old), 0 if rz is None else rz.shape[-1], _ptr(pap),
        0 if pap is None else pap.shape[-1], torch.cuda.current_stream(X.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"banded_pcg_f32 launch failed: cudaError_t {err}")
    banded_matmat.launches += 1
    count("banded.launches")


def banded_pcg_residual(A: "BandedMatrix", B: torch.Tensor, X0: torch.Tensor,
                        R: torch.Tensor) -> None:
    """R = B - A @ X0 in one launch (a PCG solve's first product)."""
    _pcg_launch(A, _RESIDUAL, X0, R, B=B)


def banded_pcg_direction(A: "BandedMatrix", Z: torch.Tensor, P_old, P: torch.Tensor,
                         AP: torch.Tensor, rz, rz_old, pap: torch.Tensor) -> None:
    """In one launch: P = Z + beta P_old, beta = sum(rz) / sum(rz_old) per
    column (0 where the latter is not positive; P = Z where P_old is None),
    AP = A @ P, and pap (m, product_blocks(A)) the blocks' p.Ap partials.
    rz and rz_old are (m, n_rz) r.z partials of the last two updates."""
    _pcg_launch(A, _DIRECTION, Z, AP, P_old=P_old, P_new=P, rz=rz, rz_old=rz_old, pap=pap)


banded_matmat.launches = 0  # every instance's launches
banded_matmat.bf16_launches = 0  # banded_matmat_bf16's alone
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


@dataclass(frozen=True, eq=False)
class BandedMatrix:
    """Dense banded row blocks on one device: blocks (B, R, W); block b's
    window starts at window_starts(B, g, aligned128)[b] - pad.  `tiles`,
    the blocks' nonempty tiles that the kernel reads, is made from the
    blocks when not given.  Frozen, so blocks and tiles stay one operator."""

    blocks: torch.Tensor
    pad: int
    g: int
    shape: tuple
    aligned128: bool = False
    tiles: BandTiles | None = None

    def __post_init__(self):
        if self.blocks.dim() != 3:
            raise ValueError(f"blocks must be (B, R, W), got {tuple(self.blocks.shape)}")
        B, R, W = self.blocks.shape
        if R % WARP_ROWS:
            raise ValueError(f"R = {R} is not a multiple of the kernel's {WARP_ROWS}-row "
                             f"warp")
        if not (0 <= self.shape[0] <= B * R and self.g >= 1 and self.pad >= 0):
            raise ValueError(f"shape={self.shape}, g={self.g}, pad={self.pad} do not fit "
                             f"blocks {B, R, W}")
        if self.tiles is None:
            object.__setattr__(self, "tiles", BandTiles.from_blocks(self.blocks))
        t = self.tiles
        if (t.values.dtype != self.blocks.dtype or t.width != W
                or t.offsets.numel() != B * R + 1 or t.values.device != self.blocks.device):
            raise ValueError(f"tiles of {t.values.dtype}, W = {t.width}, "
                             f"{t.offsets.numel() - 1} rows on {t.values.device} do not "
                             f"belong to {self.blocks.dtype} blocks {B, R, W} on "
                             f"{self.blocks.device}")

    @classmethod
    def from_scipy(cls, A: sp.spmatrix, *, device, dtype=torch.float32,
                   R: int = 128, g: int | None = None,
                   aligned128: bool = False) -> "BandedMatrix":
        """Build from a (reordered) scipy matrix.  R defaults to 128, the
        JAX package's TPU production layout, on every device.  The blocks
        and the tiles are written on `device` from the same (index, value)
        pairs, each index once, so the writes are deterministic; values are
        rounded to `dtype` as the JAX package rounds them."""
        flat, vals, B, W, pad, g = banded_layout(A, R, g, aligned128)
        if dtype == torch.float32:
            vals = vals.astype(np.float32)
        vals = torch.as_tensor(vals).to(device=device, dtype=dtype)
        blocks = torch.zeros(B * R * W, dtype=dtype, device=device)
        blocks[torch.as_tensor(flat, device=device)] = vals
        return cls(blocks=blocks.view(B, R, W), pad=pad, g=g,
                   shape=tuple(int(s) for s in A.shape), aligned128=aligned128,
                   tiles=BandTiles.from_pairs(flat, vals, (B, R, W)))

    @property
    def nbytes(self) -> int:
        """Bytes of the dense blocks (the stored band)."""
        return self.blocks.numel() * self.blocks.element_size()

    def read_bytes(self, m: int = 1) -> int:
        """Bytes one kernel product with m columns moves: the packed tiles
        and their index, X read once and Y written once."""
        xsize = 8 if self.blocks.dtype == torch.float64 else 4
        return self.tiles.nbytes + (self.shape[0] + self.shape[1]) * m * xsize

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for X (n_cols,) or (n_cols, m<=2)."""
        return banded_matmat(self, X)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat(x)

"""Sparse matrix products in the ELL (padded per-row) layout.

Counterpart of meshdqn_tpu/ops/sparse.py.  FEM operators have bounded,
near-uniform row occupancy, so each row keeps K (column, value) pairs; pad
entries have column 0 and value 0 and are summed like the others, so the
product needs no mask.

Kernel (csrc/ell.cu, CUDA C++ for sm_90a, bound with ctypes):

* `ell_matmat` replaces meshdqn_tpu/ops/pallas_kernels.py:ell_matvec_pallas
  (_ell_kernel, :39 / :57): Y[r] = sum_k vals[r, k] X[cols[r, k]], for X of
  shape (n,) or (n, m) with m <= 2, in f32 or f64.

It is bound by the bytes of the operator.  On the solver's meshes more than
half of an (R, K) ELL array is pads: K is the widest row, the mean row holds
~0.45 K, and the Dirichlet rows one entry.  So the kernel does not read the
ELL arrays.  It reads `EllSlices`: rows in slices of 32 consecutive rows,
each slice stored at its own width with its rows' trailing pads dropped
(0.82-0.93 of a slice's entries are real on the finest meshes), one int32
offset and one width per slice.  Where the slices would save little (the
3796-row operators hold 0.76 of their ELL entries real, 0.82 by slice),
every slice is stored at the widest width instead, and the kernel reads no
index: a slice's place follows from its number, and the data loads need
not wait for an offset.  A row takes G lanes of a warp (a power of two,
chosen per matrix from its widest slice and its row count); each lane
issues its column and value loads before it gathers x, which stays in L2
(at most 30k rows, 480 KB in f64 with m = 2).
The row sum keeps the order of the one-warp-per-row kernel that came first,
exactly: entry k goes to leaf k mod 32, a leaf is the FMA chain over its
entries from +0, and the 32 leaves are summed by the xor tree with offsets
16, 8, 4, 2, 1, the offsets >= G in a lane's registers and the rest by
shuffles.  So every product keeps its bits, and repeats them: no atomics,
no row split across blocks.  The ELL arrays stay on the object: they are
the JAX package's layout, bit for bit, and the input of the plain version.

`ell_matmat(A, X)` takes the whole operator: on CUDA tensors it launches
the kernel on A's slices or raises; on CPU tensors it uses the plain
version `ell_matmat_reference` on A's arrays.  `ell_matmat.launches`
counts kernel launches, `ell_matmat_reference.calls` calls of the plain
version.  On the card the kernel is held to its plain version by
`relative_gap(y, plain) <= gap_tolerance(K, dtype)` (ops/matvec.py).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from . import build

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int

_LIB = None

# The kernel's slices (csrc/ell.cu): SLICE_ROWS consecutive rows, one warp
# wide.  A row takes one of LANES lanes of a warp (choose_lanes).
SLICE_ROWS = 32
LANES = (1, 2, 4, 8, 16, 32)
MAX_STEPS = 8  # entries of a row a lane takes, at most (but past 256 wide)
MIN_WARPS = 1024  # below this the launch leaves most of the card's SMs idle
UNIFORM_SHARE = 0.75  # choose_uniform

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _lib():
    """csrc/ell.cu's library, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = build.load("ell")
        for fn in (lib.ell_matmat_f32, lib.ell_matmat_f64):
            fn.argtypes = [_c_void_p] * 6 + [_c_int] * 5 + [_c_void_p]
            fn.restype = _c_int
        _LIB = lib
    return _LIB


def ell_matmat_reference(cols: torch.Tensor, vals: torch.Tensor,
                         X: torch.Tensor) -> torch.Tensor:
    """Plain version of `ell_matmat`, in the inputs' dtype.  In f32 each row
    is the JAX package's matvec on the CPU (XLA fuses its multiply-reduce
    into one fused multiply-add chain over the row's entries in order, from
    +0):
    each step adds the exact product in f64 and rounds to f32, which is the
    FMA but for a rare double rounding.  The order matters where a row's
    terms cancel: Kp on a pressure with a large mean, whose rounded products
    made the unfused f32 step's pressure 5x as noisy as the JAX step's in
    the lift's direction (tests/test_torch_dense_modes.py).  In f64, the
    plain product and sum."""
    ell_matmat_reference.calls += 1
    Xc = X[cols] if X.dim() == 1 else X[cols].permute(0, 2, 1)  # (R, K) or (R, m, K)
    if vals.dtype != torch.float32:
        return (vals if X.dim() == 1 else vals[:, None]).mul(Xc).sum(dim=-1)
    prods = (vals.double() if X.dim() == 1 else vals.double()[:, None]) * Xc.double()
    acc = torch.zeros(prods.shape[:-1], dtype=torch.float32, device=X.device)
    for k in range(prods.shape[-1]):
        acc = (acc.double() + prods[..., k]).float()
    return acc


def row_widths(cols: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Each row's width: the index of its last entry that is not a pad
    (column 0, value +0.0), plus one.  `ell_arrays` puts a row's entries
    first and has eliminated zeros, so there the width is the row's count."""
    real = (cols != 0) | (vals != 0) | np.signbit(vals)
    k = np.arange(1, cols.shape[1] + 1)
    return (real * k).max(axis=1, initial=0)


def choose_lanes(width: int, n_rows: int) -> int:
    """Lanes a row of a matrix takes, from its widest slice and its rows:
    the fewest of LANES that are at least min(width, 8) and leave each lane
    at most MAX_STEPS entries, doubled while the launch has fewer than
    MIN_WARPS warps and a lane more than one entry.  From a sweep of every
    lane count on the finest meshes' operators (PERF.md)."""
    G = next((g for g in LANES if g >= min(width, 8) and -(-width // g) <= MAX_STEPS),
             LANES[-1])
    n_slices = -(-n_rows // SLICE_ROWS)
    while G < LANES[-1] and n_slices * G < MIN_WARPS and -(-width // G) > 1:
        G *= 2
    return G


def choose_uniform(slice_widths: np.ndarray) -> bool:
    """Whether to store every slice at the widest slice's width: when
    slices of their own widths would hold more than UNIFORM_SHARE of the
    entries the widest width stores.  Then the kernel reads no index (a
    slice's place follows from its number), which costs a dependent round
    trip before the data; from the same sweep (PERF.md)."""
    top = int(slice_widths.max(initial=0))
    return int(slice_widths.sum()) > UNIFORM_SHARE * top * len(slice_widths)


@dataclass(frozen=True)
class EllSlices:
    """An ELL matrix's rows packed by slices of SLICE_ROWS for the kernel.

    Slice s holds rows s*32 ... s*32 + 31 (in the last slice, rows past R
    are empty) at width w = widths[s], the widest of its rows or, when the
    slices are uniform, of all rows: 32 w entries from offsets[s], as G
    groups of 32/G rows (G = lanes), group q's from offsets[s] + q * (32/G)
    * w.  A group is read in steps: step t holds the entries k = t*G + j
    (j < g_t = min(G, w - t*G)) of each of its rows p, at

        group start + t * 32 + p * g_t + j,

    so at each step a warp reads consecutive entries, 32 of them but at the
    last step.  Entries past a row's width are pads (column 0, value 0);
    pads inside a row keep their position.  The index is checked once, when
    the object is made; the kernel trusts it.  `uniform` is the one width
    of every slice when they all have it (then offsets[s] = 32 w s, and the
    kernel reads neither offsets nor widths), else 0."""

    cols: torch.Tensor  # (n_entries,) int32
    vals: torch.Tensor  # (n_entries,)
    offsets: torch.Tensor  # (n_slices + 1,) int32
    widths: torch.Tensor  # (n_slices,) int32
    lanes: int
    n_rows: int
    n_cols: int
    uniform: int = field(init=False)

    def __post_init__(self):
        if self.lanes not in LANES:
            raise ValueError(f"lanes must be one of {LANES}, got {self.lanes}")
        if (self.cols.dtype, self.offsets.dtype, self.widths.dtype) != (torch.int32,) * 3:
            raise TypeError(f"cols, offsets and widths must be int32, got "
                            f"{self.cols.dtype}, {self.offsets.dtype}, {self.widths.dtype}")
        if self.vals.dtype not in _NP_DTYPE:
            raise TypeError(f"vals must be float32 or float64, got {self.vals.dtype}")
        n = self.vals.numel()
        if self.vals.dim() != 1 or self.cols.shape != (n,):
            raise ValueError(f"cols {tuple(self.cols.shape)} and vals "
                             f"{tuple(self.vals.shape)} must be the same (n_entries,)")
        n_slices = -(-self.n_rows // SLICE_ROWS)
        if self.widths.shape != (n_slices,) or self.offsets.shape != (n_slices + 1,):
            raise ValueError(f"{self.n_rows} rows take {n_slices} widths and "
                             f"{n_slices + 1} offsets, got {tuple(self.widths.shape)} "
                             f"and {tuple(self.offsets.shape)}")
        if n >= 2**31:
            raise ValueError(f"{n} entries overflow the kernel's int32 offsets")
        parts = (self.cols, self.offsets, self.widths)
        if any(p.device != self.vals.device for p in parts):
            raise ValueError(f"slice arrays on {[str(p.device) for p in parts]}, "
                             f"values on {self.vals.device}")
        w = self.widths.cpu().numpy().astype(np.int64)
        off = self.offsets.cpu().numpy().astype(np.int64)
        if (w < 0).any():
            raise ValueError("slice widths must not be negative")
        if off[0] != 0 or not np.array_equal(np.diff(off), SLICE_ROWS * w):
            raise ValueError("slice offsets must rise from 0 by 32 entries a row of "
                             "each slice's width")
        if off[-1] != n:
            raise ValueError(f"the offsets end at {off[-1]}, the slices hold {n} entries")
        c = self.cols.cpu().numpy()
        if ((c < 0) | (c >= self.n_cols)).any():
            raise ValueError(f"columns must lie in [0, {self.n_cols})")
        same = len(w) > 0 and (w == w[0]).all()
        object.__setattr__(self, "uniform", int(w[0]) if same else 0)

    @classmethod
    def from_arrays(cls, cols: np.ndarray, vals: np.ndarray, n_cols: int, *,
                    device) -> "EllSlices":
        """From (R, K) ELL arrays on the host, vals already in the stored
        dtype (float32 or float64); lanes by choose_lanes, uniform slices
        by choose_uniform."""
        cols = np.asarray(cols, dtype=np.int32)
        w_s = _slice_widths(row_widths(cols, vals), cols.shape[0])
        return _pack(cols, vals, n_cols, device=device,
                     lanes=choose_lanes(int(w_s.max(initial=0)), cols.shape[0]),
                     uniform=choose_uniform(w_s))

    @property
    def nbytes(self) -> int:
        """What the kernel reads of the operator: the slices and their index
        (none when the slices are uniform)."""
        parts = (self.cols, self.vals) + (() if self.uniform else
                                          (self.offsets, self.widths))
        return sum(t.numel() * t.element_size() for t in parts)

    @property
    def fill(self) -> float:
        """Share of the stored entries that hold a nonzero value."""
        return int(torch.count_nonzero(self.vals)) / max(self.vals.numel(), 1)


def _slice_widths(width: np.ndarray, R: int) -> np.ndarray:
    """Each slice's width, the widest of its rows'."""
    n_slices = -(-R // SLICE_ROWS)
    w = np.zeros(n_slices * SLICE_ROWS, np.int64)
    w[:R] = width
    return w.reshape(n_slices, SLICE_ROWS).max(axis=1)


def _pack(cols: np.ndarray, vals: np.ndarray, n_cols: int, *, device, lanes: int,
          uniform: bool) -> EllSlices:
    """EllSlices of (R, K) host arrays for `lanes` lanes a row, each slice
    at its own width or (`uniform`) all at the widest."""
    cols = np.asarray(cols, dtype=np.int32)
    vals = np.asarray(vals)
    R, K = cols.shape
    G = lanes
    w_s = _slice_widths(row_widths(cols, vals), R)
    if uniform:
        w_s[:] = w_s.max(initial=0)
    n_slices = len(w_s)
    rows = n_slices * SLICE_ROWS
    offsets = np.zeros(n_slices + 1, np.int64)
    np.cumsum(SLICE_ROWS * w_s, out=offsets[1:])
    # Rows padded to whole slices and entries to a whole last step.  Past
    # a row's width every entry is a pad (0, +0.0).
    kmax = G * -(-max(K, 1) // G)
    cp = np.zeros((rows, kmax), np.int32)
    vp = np.zeros((rows, kmax), vals.dtype)
    cp[:R, :K] = cols
    vp[:R, :K] = vals
    out_c = np.empty(offsets[-1], np.int32)
    out_v = np.empty(offsets[-1], vals.dtype)
    L = SLICE_ROWS // G
    for W in np.unique(w_s[w_s > 0]):
        sl = np.flatnonzero(w_s == W)
        T = -(-W // G)
        # (slice, q, p, t, j) -> stored order (slice, q, t, p, j), less the
        # last step's entries past W.
        k = np.arange(T)[:, None, None] * G + np.arange(G)  # (t, p, j)
        live = np.broadcast_to(k < W, (G, T, L, G)).reshape(-1)
        idx = (sl[:, None] * SLICE_ROWS + np.arange(SLICE_ROWS)).reshape(-1)
        dest = (offsets[sl][:, None] + np.arange(SLICE_ROWS * W)).reshape(-1)
        for src, dst in ((cp, out_c), (vp, out_v)):
            block = src[idx, : G * T].reshape(len(sl), G, L, T, G)
            block = block.transpose(0, 1, 3, 2, 4).reshape(len(sl), -1)
            dst[dest] = block[:, live].reshape(-1)
    i32 = lambda a: torch.tensor(a.astype(np.int32), device=device)
    return EllSlices(cols=i32(out_c), vals=torch.tensor(out_v, device=device),
                     offsets=i32(offsets), widths=i32(w_s), lanes=G, n_rows=R,
                     n_cols=int(n_cols))


def _check(A: "EllMatrix", X) -> int:
    """Validate CUDA operands of A @ X for the kernel; returns m.  A's
    arrays and slices were checked when A was made."""
    s = A.slices
    m = 1 if X.dim() == 1 else X.shape[1]
    if m not in (1, 2):
        raise ValueError(f"the kernel takes m in (1, 2) right-hand sides, got {m}")
    if X.dtype != s.vals.dtype:
        raise TypeError(f"{s.vals.dtype} slices take {s.vals.dtype} X, got {X.dtype}")
    dev = s.vals.device
    if dev.type != "cuda" or torch.cuda.current_device() != dev.index:
        raise ValueError(f"the slices are on {dev}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if X.device != dev:
        raise ValueError(f"X on {X.device}, slices on {dev}")
    if not X.is_contiguous():
        raise ValueError("the kernel takes a contiguous X")
    if X.numel() >= 2**31:
        raise ValueError(f"X's {X.numel()} elements overflow the kernel's int32 index")
    return m


def ell_matmat(A: "EllMatrix", X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for an ELL operator; X (n_cols,) or (n_cols, m<=2).  On
    the card the kernel reads A's slices; on the CPU the plain version
    reads its (R, K) arrays."""
    if X.dim() not in (1, 2) or X.shape[0] != A.shape[1]:
        raise ValueError(f"X must be ({A.shape[1]},) or ({A.shape[1]}, m), got "
                         f"{tuple(X.shape)}")
    if not (A.vals.is_cuda or X.is_cuda):
        return ell_matmat_reference(A.cols, A.vals, X)
    m = _check(A, X)
    s = A.slices
    R = A.shape[0]
    Y = torch.empty((R,) if X.dim() == 1 else (R, m), dtype=X.dtype, device=X.device)
    name = "ell_matmat_f32" if X.dtype == torch.float32 else "ell_matmat_f64"
    err = getattr(_lib(), name)(
        s.cols.data_ptr(), s.vals.data_ptr(), s.offsets.data_ptr(),
        s.widths.data_ptr(), X.data_ptr(), Y.data_ptr(), R, A.shape[1], m, s.lanes,
        s.uniform, torch.cuda.current_stream(X.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
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


@dataclass(frozen=True, eq=False)
class EllMatrix:
    """Padded sparse matrix on one device: cols (R, K) int32, vals (R, K),
    and `slices`, the same matrix packed for the kernel (made from cols and
    vals when not given).  Frozen, so the arrays and the slices stay one
    operator."""

    cols: torch.Tensor
    vals: torch.Tensor
    shape: tuple
    slices: EllSlices | None = None

    def __post_init__(self):
        if self.cols.dim() != 2 or self.cols.shape != self.vals.shape:
            raise ValueError(f"cols {tuple(self.cols.shape)} and vals "
                             f"{tuple(self.vals.shape)} must be the same (R, K)")
        if self.cols.shape[0] != self.shape[0]:
            raise ValueError(f"{self.cols.shape[0]} rows of cols for shape {self.shape}")
        if self.cols.dtype != torch.int32 or self.vals.dtype not in _NP_DTYPE:
            raise TypeError(f"cols must be int32 and vals float32 or float64, got "
                            f"{self.cols.dtype} and {self.vals.dtype}")
        if self.cols.device != self.vals.device:
            raise ValueError(f"cols on {self.cols.device}, vals on {self.vals.device}")
        if self.slices is None:
            object.__setattr__(self, "slices", EllSlices.from_arrays(
                self.cols.cpu().numpy(), self.vals.cpu().numpy(), self.shape[1],
                device=self.vals.device))
        s = self.slices
        if ((s.n_rows, s.n_cols) != tuple(self.shape) or s.vals.dtype != self.vals.dtype
                or s.vals.device != self.vals.device):
            raise ValueError(f"{s.vals.dtype} slices of {s.n_rows} x {s.n_cols} on "
                             f"{s.vals.device} do not belong to a {self.vals.dtype} "
                             f"{self.shape} matrix on {self.vals.device}")

    @classmethod
    def from_scipy(cls, A: sp.spmatrix, *, device,
                   dtype=torch.float64) -> "EllMatrix":
        cols, vals = ell_arrays(A)
        return cls.from_arrays(cols, vals, A.shape, device=device, dtype=dtype)

    @classmethod
    def from_arrays(cls, cols, vals, shape, *, device, dtype) -> "EllMatrix":
        """From numpy arrays; vals are rounded to `dtype` (float32 or
        float64) on the host, as JAX rounds them.  The slices are built from
        the same host arrays."""
        cols = np.asarray(cols, dtype=np.int32)
        vals = np.asarray(vals).astype(_NP_DTYPE[dtype])
        shape = tuple(int(s) for s in shape)
        return cls(cols=torch.tensor(cols, device=device),
                   vals=torch.tensor(vals, device=device), shape=shape,
                   slices=EllSlices.from_arrays(cols, vals, shape[1], device=device))

    @property
    def nbytes(self) -> int:
        """Bytes of the (R, K) ELL arrays (the stored layout)."""
        return (self.cols.numel() * self.cols.element_size()
                + self.vals.numel() * self.vals.element_size())

    def read_bytes(self, m: int = 1) -> int:
        """Bytes one kernel product with m columns moves: the slices and
        their index, X read once and Y written once."""
        return self.slices.nbytes + sum(self.shape) * m * self.vals.element_size()

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmat(x)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Y = A @ X for X (n_cols,) or (n_cols, m<=2)."""
        return ell_matmat(self, X)

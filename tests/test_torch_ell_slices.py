"""The ELL kernel's packed layout (ops/sparse.py EllSlices) and its summation
order, on the CPU.

Layout: the slices unpack to the EllMatrix arrays, and so to the JAX
package's EllMatrix.from_scipy arrays, bit for bit, for every lane count.

Order: csrc/ell.cu sums each row in the order of the one-warp-per-row kernel
it replaced (entry k into leaf k mod 32, each leaf an FMA chain from +0, the
32 leaves by the xor tree 16, 8, 4, 2, 1), reading the slices with G lanes a
row.  `slice_order` emulates the new kernel over the slices, `warp_order`
the earlier one over the ELL arrays; with the same FMA helper the two are
bit-equal, and both are within ops.matvec.gap_tolerance(K, dtype) of the
plain version, which the TF32- and bf16-rounded controls are not.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from meshdqn_tpu.ops.sparse import EllMatrix as JEll
from meshdqn_tpu_torch.ops import matvec as mv
from meshdqn_tpu_torch.ops import sparse as ts
from tests.torch_helpers import cap_threads

cap_threads()

F32, F64 = torch.float32, torch.float64
NP = {F32: np.float32, F64: np.float64}
JDT = {F32: jnp.float32, F64: jnp.float64}


def fma(a, b, c):
    """One multiply-add rounded to c's dtype; both emulations use it."""
    if c.dtype == np.float32:
        return (a.astype(np.float64) * b + c).astype(np.float32)
    return a * b + c


def warp_order(cols, vals, X):
    """The one-warp-per-row kernel over (R, K) arrays: lane l chains the
    entries l, l + 32, ... from +0, then the xor tree 16 ... 1; lane 0's sum."""
    R, K = cols.shape
    acc = np.zeros((R, 32, X.shape[1]), X.dtype)
    for k in range(K):
        acc[:, k % 32] = fma(vals[:, k, None], X[cols[:, k]], acc[:, k % 32])
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    return acc[:, 0]


def _steps(s: ts.EllSlices):
    """Per stored entry of the slices: (row, k, step t) under the layout
    EllSlices documents, walked slice by slice, group by group."""
    G, L = s.lanes, 32 // s.lanes
    rows, ks, ts_ = [], [], []
    for sl, w in enumerate(s.widths.tolist()):
        for q in range(G):
            for t in range(-(-w // G)):
                g = min(G, w - t * G)
                p, j = np.divmod(np.arange(L * g), g)
                rows.append(sl * 32 + q * L + p)
                ks.append(t * G + j)
                ts_.append(np.full(L * g, t))
    cat = lambda a: np.concatenate(a) if a else np.zeros(0, np.int64)
    return cat(rows), cat(ks), cat(ts_)


def slice_order(s: ts.EllSlices, X):
    """csrc/ell.cu over the slices: the lane (p, j) of row p takes the
    entries k = t*G + j, step t into leaf slot t mod 32/G by FMAs from +0;
    the slots are summed in the xor tree's pairing (slot offsets 16/G ...
    1), then the lanes by the offsets below G; each row's sum from j = 0."""
    G, L = s.lanes, 32 // s.lanes
    row, k, t = _steps(s)
    cols, vals = s.cols.numpy(), s.vals.numpy()
    acc = np.zeros((len(s.widths) * 32, G, L, X.shape[1]), X.dtype)
    # Steps in rising order: each slot's chain in the kernel's order.
    for step in range(int(t.max(initial=-1)) + 1):
        e = np.flatnonzero(t == step)
        r, j = row[e], k[e] % G
        acc[r, j, step % L] = fma(vals[e, None], X[cols[e]], acc[r, j, step % L])
    h = L // 2
    while h >= 1:
        acc[:, :, :h] = acc[:, :, :h] + acc[:, :, h : 2 * h]
        h //= 2
    a0 = acc[:, :, 0]
    lane = np.arange(G)
    o = G // 2
    while o >= 1:
        a0 = a0 + a0[:, lane ^ o]
        o //= 2
    return a0[: s.n_rows, 0]


def unpack(s: ts.EllSlices, K: int):
    """The (R, K) ELL arrays the slices hold (entries past K must be pads)."""
    row, k, _ = _steps(s)
    assert len(row) == s.vals.numel()
    width = max(K, int(k.max(initial=0)) + 1)
    cols = np.zeros((len(s.widths) * 32, width), np.int32)
    vals = np.zeros(cols.shape, s.vals.numpy().dtype)
    cols[row, k] = s.cols.numpy()
    vals[row, k] = s.vals.numpy()
    R = s.n_rows
    assert not cols[R:].any() and not vals[R:].any()
    assert not cols[:, K:].any() and not vals[:, K:].any()
    return cols[:R, :K], vals[:R, :K]


def with_lanes(e: ts.EllMatrix, lanes: int, uniform: bool = False) -> ts.EllMatrix:
    """e with its slices packed for `lanes` lanes a row, each slice at its
    own width or all at the widest."""
    return dataclasses.replace(e, slices=ts._pack(
        e.cols.numpy(), e.vals.numpy(), e.shape[1], device="cpu", lanes=lanes,
        uniform=uniform))


def matrix(case: str):
    """Operators with the features the layout must keep: R not a multiple of
    32, empty and one-entry rows, K = 1, a wide (K > 64) row."""
    rng = np.random.default_rng(7)
    if case == "ragged":  # R = 777, some rows emptied, some left with one entry
        A = sp.random(777, 333, density=0.04, random_state=1, format="lil")
        for r in rng.choice(777, 40, replace=False):
            A[r, :] = 0
        for r in rng.choice(777, 40, replace=False):
            A[r, :] = 0
            A[r, int(rng.integers(333))] = 1.5
        return A.tocsr()
    if case == "k1":  # at most one entry a row, and empty rows
        return sp.csr_matrix((rng.standard_normal(50), (np.arange(0, 100, 2),
                                                         rng.integers(0, 60, 50))),
                             shape=(101, 60))
    if case == "wide":  # one slice of 70-entry rows beside narrow ones
        A = sp.random(200, 400, density=0.01, random_state=3, format="lil")
        A[40:70, :70] = rng.standard_normal((30, 70))
        return A.tocsr()
    raise ValueError(case)


CASES = ["ragged", "k1", "wide"]


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("lanes", ts.LANES)
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("case", CASES)
def test_slices_unpack_to_ell_and_jax_arrays(case, dtype, lanes, uniform):
    A = matrix(case)
    e = with_lanes(ts.EllMatrix.from_scipy(A, device="cpu", dtype=dtype), lanes,
                   uniform)
    j = JEll.from_scipy(A, dtype=JDT[dtype])
    s = e.slices
    assert s.lanes == lanes and (s.n_rows, s.n_cols) == A.shape
    uc, uv = unpack(s, e.cols.shape[1])
    np.testing.assert_array_equal(uc, e.cols.numpy())
    np.testing.assert_array_equal(uv.view(np.uint8), e.vals.numpy().view(np.uint8))
    np.testing.assert_array_equal(uc, np.asarray(j.cols))
    np.testing.assert_array_equal(uv, np.asarray(j.vals))
    # Each slice's width is its widest row, or the widest of all rows when
    # uniform; the rows' trailing pads past it are gone.
    counts = np.zeros(len(s.widths) * 32, np.int64)
    counts[: A.shape[0]] = np.diff(A.tocsr().indptr)
    w_s = counts.reshape(-1, 32).max(axis=1)
    if uniform:
        w_s[:] = w_s.max()
    np.testing.assert_array_equal(s.widths.numpy(), w_s)
    assert s.uniform == (int(w_s[0]) if (w_s == w_s[0]).all() else 0)
    assert s.nbytes == (8 if dtype == F32 else 12) * s.vals.numel() + (
        0 if s.uniform else 4 * (2 * len(w_s) + 1))
    if case == "k1":
        assert e.cols.shape[1] == 1


@pytest.mark.parametrize("lanes", [1, 4, 32])
def test_pads_inside_a_row_keep_their_position(lanes):
    """Arrays carried across may hold a pad before a row's last entry; it
    stays where it is, the trailing pads go."""
    cols = np.array([[3, 0, 5, 0], [0, 0, 0, 0], [0, 2, 0, 0], [1, 0, 0, 0]], np.int32)
    vals = np.array([[1.0, 0.0, 2.0, 0.0], [0.0] * 4, [0.0, -3.0, 0.0, 0.0],
                     [4.0, 0.0, 0.0, 0.0]])
    np.testing.assert_array_equal(ts.row_widths(cols, vals), [3, 0, 2, 1])
    e = with_lanes(ts.EllMatrix.from_arrays(cols, vals, (4, 6), device="cpu",
                                            dtype=F64), lanes)
    assert e.slices.widths.tolist() == [3]
    uc, uv = unpack(e.slices, 4)
    np.testing.assert_array_equal(uc, cols)
    np.testing.assert_array_equal(uv, vals)
    # A -0.0 value or a nonzero column marks a real entry too.
    np.testing.assert_array_equal(
        ts.row_widths(np.array([[0, 0], [0, 4]], np.int32), np.array([[0.0, -0.0],
                                                                      [1.0, 0.0]])),
        [2, 2])


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("lanes", [1, 4, 8, 32])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("case", CASES)
def test_slice_order_is_warp_order_bit_for_bit(case, dtype, lanes, m, uniform):
    A = matrix(case)
    e = with_lanes(ts.EllMatrix.from_scipy(A, device="cpu", dtype=dtype), lanes,
                   uniform)
    X = np.random.default_rng(m).standard_normal((A.shape[1], m)).astype(NP[dtype])
    y = slice_order(e.slices, X)
    yw = warp_order(e.cols.numpy(), e.vals.numpy(), X)
    np.testing.assert_array_equal(y.view(np.uint8), yw.view(np.uint8))
    # Both are a summation order of the plain version's products.
    Xt = torch.tensor(X)
    yp = ts.ell_matmat_reference(e.cols, e.vals, Xt)
    tol = mv.gap_tolerance(e.cols.shape[1], dtype)
    assert mv.relative_gap(torch.tensor(y), yp) <= tol
    for bits in (10, 7):  # TF32 and bf16 inputs fail the same check
        rounded = ts.ell_matmat_reference(e.cols, mv.round_mantissa(e.vals, bits),
                                          mv.round_mantissa(Xt, bits))
        assert mv.relative_gap(rounded, yp) > tol


def test_lanes_rule_and_byte_counts():
    # The finest meshes' operators: (widest row, rows) -> lanes.
    finest = {(50, 29768): 8, (25, 14884): 8, (25, 29768): 8, (9, 29768): 8,
              (9, 3796): 16, (50, 3796): 16, (56, 25854): 8, (10, 3301): 16}
    assert {k: ts.choose_lanes(*k) for k in finest} == finest
    assert [ts.choose_lanes(w, 10**6) for w in (0, 1, 2, 3, 5, 8, 64, 65, 128, 129)] == \
        [1, 1, 2, 4, 8, 8, 8, 16, 16, 32]
    assert ts.choose_lanes(40, 32) == 32 and ts.choose_lanes(1, 32) == 1
    assert ts.choose_lanes(9, 3796) == 16 and ts.choose_lanes(9, 33000) == 8
    # A matrix whose rows' widths vary inside each slice: the slices read
    # fewer bytes than the ELL arrays hold.
    A = matrix("wide")
    e = ts.EllMatrix.from_scipy(A, device="cpu", dtype=F32)
    s = e.slices
    assert s.lanes == ts.choose_lanes(int(s.widths.max()), A.shape[0])
    assert s.vals.numel() == 32 * int(s.widths.sum())
    assert s.nbytes == 8 * s.vals.numel() + 4 * (2 * len(s.widths) + 1)
    assert e.read_bytes(2) == s.nbytes + 2 * 4 * sum(A.shape)
    assert s.nbytes < e.nbytes / 2
    assert s.fill == A.nnz / s.vals.numel() > A.nnz / e.vals.numel()
    assert s.uniform == 0
    # Slices that would save few entries are stored at one width, with no
    # index for the kernel to read: as the 3796-row operators (slice widths
    # of 8 or 9, K = 9), not the 29,768-row ones (18 wide on median, K = 50).
    assert ts.choose_uniform(np.array([9, 9, 8, 9, 9, 9]))
    assert not ts.choose_uniform(np.array([50, 18, 18, 20, 9, 25]))
    assert not ts.choose_uniform(np.zeros(0, np.int64))
    rng = np.random.default_rng(11)
    B = sp.csr_matrix((rng.standard_normal(900), (np.repeat(np.arange(100), 9),
                                                  rng.integers(0, 50, 900))),
                      shape=(100, 50))
    B.sum_duplicates()
    u = ts.EllMatrix.from_scipy(B, device="cpu", dtype=F64)
    assert u.slices.uniform == u.cols.shape[1] == int(u.slices.widths.max())
    assert u.slices.nbytes == 12 * u.slices.vals.numel() == 12 * 128 * u.cols.shape[1]


def _slices(**over):
    e = ts.EllMatrix.from_scipy(matrix("ragged"), device="cpu", dtype=F32)
    return e, {f.name: getattr(e.slices, f.name) for f in dataclasses.fields(ts.EllSlices)
               if f.init} | over


def test_malformed_slices_raise_when_made():
    e, good = _slices()
    ts.EllSlices(**good)
    off, w, c = good["offsets"], good["widths"], good["cols"]
    bad = [
        ("lanes", 3), ("offsets", off + 32), ("offsets", off.flip(0)),
        ("offsets", off[:-1]), ("widths", w + 1), ("widths", -w),
        ("cols", torch.where(c == c.max(), e.shape[1], c).to(torch.int32)),
        ("cols", c - 1), ("cols", c.long()), ("vals", good["vals"].bfloat16()),
        ("n_rows", e.shape[0] + 40),
    ]
    for field, value in bad:
        with pytest.raises((ValueError, TypeError)):
            ts.EllSlices(**(good | {field: value}))
    with pytest.raises(TypeError):  # the ELL columns are int32, as JAX's
        ts.EllMatrix(cols=e.cols.long(), vals=e.vals, shape=e.shape)
    # Slices of another matrix do not make an EllMatrix.
    other = ts.EllMatrix.from_scipy(matrix("k1"), device="cpu", dtype=F32)
    with pytest.raises(ValueError):
        ts.EllMatrix(cols=e.cols, vals=e.vals, shape=e.shape, slices=other.slices)
    f64 = ts.EllMatrix.from_scipy(matrix("ragged"), device="cpu", dtype=F64)
    with pytest.raises(ValueError):
        ts.EllMatrix(cols=e.cols, vals=e.vals, shape=e.shape, slices=f64.slices)
    with pytest.raises(dataclasses.FrozenInstanceError):
        e.vals = e.vals * 2


def test_made_slices_equal_built_slices():
    """EllMatrix(cols, vals, shape) packs its own slices: the same as
    from_scipy's, which packs from the host arrays."""
    A = matrix("ragged")
    e = ts.EllMatrix.from_scipy(A, device="cpu", dtype=F32)
    made = ts.EllMatrix(cols=e.cols, vals=e.vals, shape=e.shape).slices
    for f in ("cols", "vals", "offsets", "widths"):
        assert torch.equal(getattr(made, f), getattr(e.slices, f))
    assert made.lanes == e.slices.lanes
    # The CPU product takes the plain version and counts no launch.
    x = torch.ones(A.shape[1])
    before = ts.ell_matmat.launches, ts.ell_matmat_reference.calls
    y = ts.ell_matmat(e, x)
    assert (ts.ell_matmat.launches, ts.ell_matmat_reference.calls) == (before[0],
                                                                       before[1] + 1)
    assert torch.equal(y, e @ x)
    for bad in (torch.ones(A.shape[1] + 1), torch.ones(A.shape[1], 2, 1)):
        with pytest.raises(ValueError):
            ts.ell_matmat(e, bad)

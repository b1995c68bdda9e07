"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one.  The file imports neither JAX nor the JAX package, so it runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import functools

import pytest
import torch

from meshdqn_tpu_torch.ops import matvec as mv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# The fused step's shapes on ys930 (2Ns = 6644, Np = 876, Ns = 3322) and on
# ah93w145 (6050, 797, 3025), whose rows are not 16-byte aligned; k = 2 is
# the (Ns, 2) velocity stack.
SHAPES = [(6644, 6644, 1), (6644, 876, 1), (876, 6644, 1), (876, 876, 1),
          (3322, 3322, 2), (6050, 6050, 1), (6050, 797, 1), (797, 6050, 1),
          (797, 797, 1), (3025, 3025, 2), (5, 3, 1), (33, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,k", SHAPES)
def test_kernels_match_plain_and_repeat_bits(cuda, R, N, k):
    g = torch.Generator(device="cpu").manual_seed(R * 7 + N + k)
    M = torch.randn(R, N, generator=g).to(cuda)
    X = torch.randn((N,) if k == 1 else (N, k), generator=g).to(cuda)
    # A draw of its own at ~2^-8 of x: dropping it moves y past the tolerance.
    lo = (2.0**-8 * X.abs().cpu() * torch.randn(X.shape, generator=g)).to(cuda)
    tol = mv.gap_tolerance(N)
    y = mv.matvec(M, X)
    assert y.shape == (R,) + tuple(X.shape[1:])
    assert torch.equal(y, mv.matvec(M, X))
    yp = mv.matvec_reference(M, X)
    assert mv.relative_gap(y, yp) <= tol
    yd = mv.matvec_dual(M, X, lo)
    assert torch.equal(yd, mv.matvec_dual(M, X, lo))
    ydp = mv.matvec_dual_reference(M, X, lo)
    assert mv.relative_gap(yd, ydp) <= tol
    # The check rejects a kernel that lost precision or dropped x_lo.
    for bits in (10, 7):
        rounded = mv.matvec_reference(mv.round_mantissa(M, bits),
                                       mv.round_mantissa(X, bits))
        assert mv.relative_gap(rounded, yp) > tol
    assert mv.relative_gap(y, ydp) > tol


@pytest.mark.cuda
def test_launches_are_counted(cuda):
    M, x = torch.ones(4, 4, device=cuda), torch.ones(4, device=cuda)
    before = mv.matvec.launches, mv.matvec_dual.launches
    mv.matvec(M, x)
    mv.matvec_dual(M, x, x)
    assert (mv.matvec.launches, mv.matvec_dual.launches) == (before[0] + 1,
                                                             before[1] + 1)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    M = torch.zeros(8, 8, device=cuda)
    with pytest.raises(TypeError):
        mv.matvec(M.double(), torch.zeros(8, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        mv.matvec(M, torch.zeros(8, 3, device=cuda))
    with pytest.raises(ValueError):
        mv.matvec(M.T, torch.zeros(8, device=cuda))
    with pytest.raises(ValueError):
        mv.matvec(M, torch.zeros(8))
    with pytest.raises(ValueError):  # x does not fit in shared memory
        mv.matvec(torch.zeros(1, 60000, device=cuda), torch.zeros(60000, device=cuda))


# --------------------------------------------------------------------------
# The matvec kernel's grouped form: the fused step's three launches
# (ops/matvec.py step_ustar, step_pressure, step_velocity) against the
# composition of single launches with torch's elementwise ops, which they
# must equal bit for bit.  (Ns, Np) are both packs' and ragged small sizes:
# rows 1, 5, 33, 876 and widths with N % 4 in {1, 2, 3}.
# --------------------------------------------------------------------------

GROUP_SIZES = [(3322, 876), (3025, 797), (1, 5), (5, 33), (33, 7), (3, 876),
               (438, 1), (877, 3)]


def _step_operands(cuda, ns, npr, seed, shifted=False):
    """Seeded operands of the fused step; with `shifted`, every tensor
    starts one element past a 16-byte boundary, so every row has a head."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    nu = 2 * ns

    def r(*shape):
        t = torch.randn(*shape, generator=g)
        if not shifted:
            return t.to(cuda)
        buf = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
        return buf.copy_(t)

    return {"F1u": r(nu, nu), "F1p": r(nu, npr), "A1Z": r(nu, nu), "k1": r(nu),
            "rho": r(()), "F2p": r(npr, npr), "F2u": r(npr, nu), "k2": r(npr),
            "F3s": r(ns, ns), "F3p": r(2, ns, npr), "k3": r(nu), "u": r(nu),
            "p": r(npr), "c": r(nu), "u_star": r(nu), "dp": r(npr)}


def _forms(ns, npr):
    """(grouped wrapper, plain version, operand names, terms of one output)."""
    return [
        (mv.step_ustar, mv.step_ustar_reference,
         ("F1u", "F1p", "A1Z", "rho", "k1", "u", "p", "c"), 4 * ns + npr),
        (mv.step_pressure, mv.step_pressure_reference,
         ("F2p", "F2u", "k2", "p", "u_star"), npr + 2 * ns),
        (mv.step_velocity, mv.step_velocity_reference,
         ("F3s", "F3p", "k3", "u_star", "dp"), ns + npr),
    ]


def _tuple(y):
    return y if isinstance(y, tuple) else (y,)


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("ns,npr", GROUP_SIZES)
def test_grouped_launches_equal_single_launches_bit_for_bit(cuda, ns, npr, shifted):
    t = _step_operands(cuda, ns, npr, seed=ns * 7 + npr, shifted=shifted)
    for grouped, plain, names, terms in _forms(ns, npr):
        args = [t[n] for n in names]
        before = grouped.launches, mv.matvec.launches
        y = _tuple(grouped(*args))
        assert (grouped.launches, mv.matvec.launches) == (before[0] + 1, before[1])
        assert all(map(torch.equal, y, _tuple(grouped(*args))))
        assert all(map(torch.equal, y, _tuple(plain(*args, apply=mv.matvec))))
        yp = torch.cat(_tuple(plain(*args)))
        tol = mv.gap_tolerance(terms)
        assert mv.relative_gap(torch.cat(y), yp) <= tol
        for bits in (10, 7):
            rounded = [mv.round_mantissa(a, bits) for a in args]
            assert mv.relative_gap(torch.cat(_tuple(plain(*rounded))), yp) > tol


@pytest.mark.cuda
def test_grouped_launches_reject_what_they_do_not_take(cuda):
    t = _step_operands(cuda, 6, 3, seed=1)
    ustar = lambda **kw: mv.step_ustar(*({**t, **kw}[n] for n in (
        "F1u", "F1p", "A1Z", "rho", "k1", "u", "p", "c")))
    ustar()  # the operators pass and are remembered
    with pytest.raises(ValueError):  # the vectors are checked on every call
        ustar(u=torch.zeros(24, device=cuda)[::2])
    with pytest.raises(ValueError):
        ustar(p=torch.zeros(4, device=cuda))
    with pytest.raises(ValueError):
        ustar(c=t["c"].cpu())
    with pytest.raises(TypeError):  # a new operator object is checked again
        ustar(F1u=t["F1u"].double())
    with pytest.raises(ValueError):
        ustar(A1Z=t["A1Z"].T)
    with pytest.raises(ValueError):  # rho is a device scalar
        ustar(rho=torch.ones(1, device=cuda))
    with pytest.raises(ValueError):  # F3p is the (2, Ns, Np) stack
        mv.step_velocity(t["F3s"], t["F3p"].view(12, 3), t["k3"], t["u_star"], t["dp"])
    with pytest.raises(ValueError, match="shared memory"):  # x: 60,001 floats
        z = lambda *shape: torch.zeros(*shape, device=cuda)
        mv.step_pressure(z(1, 1), z(1, 60000), z(1), z(1), z(60000))


# --------------------------------------------------------------------------
# The CG path's kernels: banded_matmat (csrc/banded.cu), ell_matmat
# (csrc/ell.cu).  Operators are RCM-banded random patterns at the shapes'
# ratios of the solver's: square (g = R), wide (g = 2R), tall (g = R/2), with
# a ragged last row block.
# --------------------------------------------------------------------------


def _spd_rcm(n, seed):
    import scipy.sparse as sp

    from meshdqn_tpu_torch.ops.banded import rcm_permutation

    A = sp.random(n, n, density=0.01, random_state=seed, format="csr")
    A = (A + A.T + sp.eye(n)).tocsr()
    perm = rcm_permutation(A)
    return A[perm][:, perm].tocsr()


def _rect(A, kind):
    n = A.shape[0]
    return {"square": A, "wide": A[: n // 2, :], "tall": A[:, : n // 2]}[kind].tocsr()


def _controls_fail(plain, yp, tol, inputs):
    """The plain version on TF32- and bf16-rounded inputs must fail the gap
    check, or the check proves nothing."""
    for bits in (10, 7):
        rounded = [mv.round_mantissa(t, bits) if t.is_floating_point() else t
                   for t in inputs]
        assert mv.relative_gap(plain(*rounded), yp) > tol


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("kind", ["square", "wide", "tall"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_banded_matches_plain_and_repeats_bits(cuda, dtype, kind, aligned, m):
    """The tiled kernel against the plain version of the dense blocks, with
    X 16-byte aligned and off by one element."""
    from meshdqn_tpu_torch.ops import banded as bd

    A = _rect(_spd_rcm(1500, seed=3), kind)
    bm = bd.BandedMatrix.from_scipy(A, device=cuda, dtype=dtype, aligned128=aligned)
    assert bm.tiles.values.shape[0] < bm.blocks.numel() // bm.tiles.values[0].numel()
    xdt = torch.float64 if dtype == torch.float64 else torch.float32
    g = torch.Generator(device="cpu").manual_seed(m)
    X = torch.randn((A.shape[1],) if m == 1 else (A.shape[1], m), generator=g,
                    dtype=xdt).to(cuda)
    before = bd.banded_matmat.launches
    y = bm @ X
    assert bd.banded_matmat.launches == before + 1
    assert y.shape == (A.shape[0],) + tuple(X.shape[1:]) and y.dtype == xdt
    assert torch.equal(y, bm @ X)
    shifted = torch.empty(X.numel() + 1, dtype=xdt, device=cuda)[1:].view(X.shape)
    shifted.copy_(X)
    assert torch.equal(y, bm @ shifted)
    kw = dict(pad=bm.pad, g=bm.g, aligned=aligned, n_rows=A.shape[0])
    yp = bd.banded_matmat_reference(bm.blocks, X, **kw)
    W = bm.blocks.shape[2]
    tol = mv.gap_tolerance(W, xdt)
    assert mv.relative_gap(y, yp) <= tol
    blocks = bm.blocks if dtype != torch.bfloat16 else bm.blocks.float()
    plain = lambda b, x: bd.banded_matmat_reference(b, x, **kw)
    if dtype == torch.bfloat16 and not aligned:
        # The plain layout rounds x and each product to bf16, as the JAX
        # package's banded_matmat does: so rounding the inputs changes
        # nothing, and the controls are the product with x in f32 and exact
        # products, and with x rounded but exact products.
        assert mv.relative_gap(plain(blocks, X), yp) > tol
        assert mv.relative_gap(plain(blocks, X.bfloat16().float()), yp) > tol
    else:
        _controls_fail(plain, yp, tol, [blocks, X])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("R", [8, 16, 24, 40, 48, 72])
def test_banded_row_blocks_of_any_multiple_of_8_rows(cuda, R, m):
    """A thread block's warps share one row block's x window, so it takes
    4, 2 or 1 warps as R/8 allows: at R = 40, 48 or 72 a block of 4 warps
    would straddle two row blocks."""
    from meshdqn_tpu_torch.ops import banded as bd

    A = _spd_rcm(1500, seed=5)
    bm = bd.BandedMatrix.from_scipy(A, device=cuda, R=R)
    g = torch.Generator(device="cpu").manual_seed(R + m)
    X = torch.randn((1500,) if m == 1 else (1500, m), generator=g).to(cuda)
    y = bm @ X
    assert torch.equal(y, bm @ X)
    yp = bd.banded_matmat_reference(bm.blocks, X, pad=bm.pad, g=bm.g, aligned=False,
                                    n_rows=1500)
    assert mv.relative_gap(y, yp) <= mv.gap_tolerance(bm.blocks.shape[2])


ELL_CASES = [(2000, 2000, None), (777, 1500, None), (1500, 333, None),
             (29768, 29768, 50), (25854, 25854, 56), (3796, 3796, 9)]


@functools.lru_cache(maxsize=None)
def _ell_matrix(R, C, K):
    """sp.random at density 0.03 for K None; else banded rows of 1 ... K
    entries (a quarter of them one entry, as Dirichlet rows), at least one
    of K: at the finest meshes' sizes and widths of A1bc and Kp."""
    import numpy as np
    import scipy.sparse as sp

    if K is None:
        return sp.random(R, C, density=0.03, random_state=R, format="csr")
    rng = np.random.default_rng(R + K)
    counts = rng.integers(K // 3, K + 1, R)
    counts[rng.random(R) < 0.25] = 1
    counts[R // 2] = K
    rows = np.repeat(np.arange(R), counts)
    cols = np.concatenate([np.sort((r + rng.choice(4 * K, c, replace=False)) % C)
                           for r, c in enumerate(counts)])
    return sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)), shape=(R, C))


def _warp_order(cols, vals, X):
    """The one-warp-per-row ELL kernel's order, in torch on the card: lane l
    chains entries l, l + 32, ... by fused multiply-adds from +0, then the
    xor tree 16, 8, 4, 2, 1.  The FMA is CUDA's fma() through torch's
    runtime-compiled elementwise ops (jiterator)."""
    fma = torch.cuda.jiterator._create_jit_fn(
        "template <typename T> T fma_op(T a, T b, T c) { return fma(a, b, c); }")
    X2 = X.view(X.shape[0], -1)
    R, K = cols.shape
    acc = torch.zeros(R, 32, X2.shape[1], dtype=X.dtype, device=X.device)
    for k in range(K):
        a = acc[:, k % 32]
        acc[:, k % 32] = fma(vals[:, k, None].expand_as(a), X2[cols[:, k].long()], a)
    lane = torch.arange(32, device=X.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    return acc[:, 0].view((R,) + tuple(X.shape[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R,C,K", ELL_CASES)
def test_ell_matches_plain_and_repeats_bits(cuda, R, C, K, dtype, m):
    """The sliced kernel against the plain version of the ELL arrays, and
    bit-equal to the one-warp-per-row kernel's order, at the matrix's own
    lane count and at 1 and 32 lanes a row, each with slices of their own
    widths and uniform ones."""
    import dataclasses

    from meshdqn_tpu_torch.ops import sparse as ell

    A = _ell_matrix(R, C, K)
    e = ell.EllMatrix.from_scipy(A, device=cuda, dtype=dtype)
    g = torch.Generator(device="cpu").manual_seed(R + m)
    X = torch.randn((C,) if m == 1 else (C, m), generator=g, dtype=dtype).to(cuda)
    before = ell.ell_matmat.launches
    y = e @ X
    assert ell.ell_matmat.launches == before + 1
    assert y.shape == (R,) + tuple(X.shape[1:]) and y.dtype == dtype
    assert torch.equal(y, e @ X)
    assert torch.equal(y, _warp_order(e.cols, e.vals, X))
    for lanes in (e.slices.lanes, 1, 32):
        for uniform in (False, True):
            other = dataclasses.replace(e, slices=ell._pack(
                e.cols.cpu().numpy(), e.vals.cpu().numpy(), C, device=cuda,
                lanes=lanes, uniform=uniform))
            assert other.slices.uniform or not uniform
            assert torch.equal(y, other @ X)
    yp = ell.ell_matmat_reference(e.cols, e.vals, X)
    tol = mv.gap_tolerance(e.cols.shape[1], dtype)
    assert mv.relative_gap(y, yp) <= tol
    _controls_fail(lambda v, x: ell.ell_matmat_reference(e.cols, v, x), yp, tol,
                   [e.vals, X])


@pytest.mark.cuda
def test_sparse_kernels_count_and_reject(cuda):
    import dataclasses

    from meshdqn_tpu_torch.ops import banded as bd
    from meshdqn_tpu_torch.ops import sparse as ell

    cols = torch.zeros(4, 3, dtype=torch.int32, device=cuda)
    vals = torch.ones(4, 3, device=cuda)
    e = ell.EllMatrix(cols=cols, vals=vals, shape=(4, 5))
    sl = e.slices
    band = dict(pad=0, g=8, shape=(8, 8))
    bm = bd.BandedMatrix(blocks=torch.ones(1, 8, 128, device=cuda), **band)
    x = torch.ones(8, device=cuda)
    before = ell.ell_matmat.launches, bd.banded_matmat.launches
    ell.ell_matmat(e, torch.ones(5, device=cuda))
    bd.banded_matmat(bm, x)
    assert (ell.ell_matmat.launches, bd.banded_matmat.launches) == (before[0] + 1,
                                                                    before[1] + 1)
    with pytest.raises(TypeError):  # cols must be int32
        ell.EllMatrix(cols=cols.long(), vals=vals, shape=(4, 5))
    with pytest.raises(TypeError):  # X's dtype must match vals'
        ell.ell_matmat(e, torch.ones(5, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):  # m = 3
        ell.ell_matmat(e, torch.ones(5, 3, device=cuda))
    with pytest.raises(ValueError):  # X on another device than the slices
        ell.ell_matmat(e, torch.ones(5))
    with pytest.raises(ValueError):  # X of another shape
        ell.ell_matmat(e, torch.ones(6, device=cuda))
    with pytest.raises(ValueError):  # slices on the host, arrays on the card
        ell.EllMatrix(cols=cols, vals=vals, shape=(4, 5), slices=ell.EllSlices.from_arrays(
            cols.cpu().numpy(), vals.cpu().numpy(), 5, device="cpu"))
    with pytest.raises(ValueError):  # slice arrays on two devices
        ell.EllSlices(cols=sl.cols.cpu(), vals=sl.vals, offsets=sl.offsets,
                      widths=sl.widths, lanes=sl.lanes, n_rows=4, n_cols=5)
    with pytest.raises(ValueError):  # malformed slices: offsets off by a slice
        ell.EllSlices(cols=sl.cols, vals=sl.vals, offsets=sl.offsets + 32,
                      widths=sl.widths, lanes=sl.lanes, n_rows=4, n_cols=5)
    with pytest.raises(ValueError):  # malformed slices: a column past X
        ell.EllMatrix(cols=cols + 5, vals=vals, shape=(4, 5))
    assert ell.ell_matmat.launches == before[0] + 1
    with pytest.raises(TypeError):  # bf16 blocks take f32 X
        b16 = bd.BandedMatrix(blocks=torch.ones(1, 8, 128, device=cuda,
                                                dtype=torch.bfloat16), **band)
        b16 @ x.bfloat16()
    with pytest.raises(ValueError):  # W not a multiple of the 32-entry f32 tile
        bd.BandedMatrix(blocks=torch.ones(1, 8, 12, device=cuda), **band)
    with pytest.raises(ValueError):  # m = 3
        bm @ torch.ones(8, 3, device=cuda)
    with pytest.raises(dataclasses.FrozenInstanceError):  # blocks and tiles stay one
        bm.blocks = torch.zeros(1, 8, 128, device=cuda)
    t = bm.tiles
    with pytest.raises(ValueError):  # malformed offsets: falling
        bd.BandTiles(values=t.values, offsets=t.offsets.flip(0), cols=t.cols,
                     width=t.width)
    with pytest.raises(ValueError):  # malformed offsets: not one per row
        bd.BandedMatrix(blocks=bm.blocks, **band, tiles=bd.BandTiles(
            values=t.values, offsets=torch.cat([t.offsets, t.offsets[-1:]]),
            cols=t.cols, width=t.width))
    with pytest.raises(ValueError):  # the packed buffer starts off 16 bytes
        buf = torch.empty(t.values.numel() + 1, device=cuda)[1:].view(t.values.shape)
        buf.copy_(t.values)
        bd.BandedMatrix(blocks=bm.blocks, **band, tiles=bd.BandTiles(
            values=buf, offsets=t.offsets, cols=t.cols, width=t.width)) @ x
    with pytest.raises(ValueError):  # the window does not fit in shared memory
        wide = bd.BandedMatrix(blocks=torch.ones(1, 8, 40000, device=cuda), pad=0,
                               g=8, shape=(8, 40000))
        wide @ torch.ones(40000, 2, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["banded", "ell_f32", "ell_f64"])
def test_sparse_gap_over_the_rows_off_the_boundary(cuda, layout):
    """An operator like A3bc_s: small mass-matrix entries with a third of
    its rows eliminated to identity rows, which dominate ||y||.  The kernel
    is held to its plain version over all rows and over the rows off the
    boundary; the plain version with x rounded to bf16 off the boundary
    fails the second, so an error there cannot hide behind the identity
    rows."""
    import numpy as np
    import scipy.sparse as sp

    from meshdqn_tpu_torch.ops import banded as bd
    from meshdqn_tpu_torch.ops import sparse as ell

    A = (_spd_rcm(3000, seed=7) * 1e-4).tolil()
    bc = np.random.default_rng(7).random(3000) < 1 / 3
    keep = sp.diags((~bc).astype(float))
    A = (keep @ A.tocsr() @ keep + sp.diags(bc.astype(float))).tocsr()
    interior = torch.tensor(~bc, device=cuda)
    dtype = torch.float64 if layout == "ell_f64" else torch.float32
    g = torch.Generator(device="cpu").manual_seed(7)
    X = torch.randn(3000, 2, generator=g, dtype=dtype).to(cuda)
    if layout == "banded":
        op = bd.BandedMatrix.from_scipy(A, device=cuda, dtype=dtype)
        kw = dict(pad=op.pad, g=op.g, aligned=False, n_rows=3000)
        plain = lambda x: bd.banded_matmat_reference(op.blocks, x, **kw)
        terms = op.blocks.shape[2]
    else:
        op = ell.EllMatrix.from_scipy(A, device=cuda, dtype=dtype)
        plain = lambda x: ell.ell_matmat_reference(op.cols, op.vals, x)
        terms = op.cols.shape[1]
    y, yp = op @ X, plain(X)
    tol = mv.gap_tolerance(terms, dtype)
    assert mv.relative_gap(y, yp) <= tol
    assert mv.relative_gap(y, yp, interior) <= tol
    Xr = torch.where(interior[:, None], X.bfloat16().to(dtype), X)
    assert mv.relative_gap(plain(Xr), yp, interior) > tol


# --------------------------------------------------------------------------
# The matvec kernel's split form: the 'df32' step's three launches
# (ops/matvec.py step_*_df32) against their plain versions.
# --------------------------------------------------------------------------

SPLIT_LOW = {"ustar": ("L1u", "L1p", "LA1Z", "l1"), "pressure": ("L2p", "L2u", "l2"),
             "velocity": ("L3s", "L3p", "l3")}


def _split_operands(cuda, ns, npr, seed, shifted=False, scale=1.0):
    """_step_operands plus low limbs: bf16 matrices and f32 vectors at
    `scale` of the high limbs' magnitude (0 gives zero limbs)."""
    t = _step_operands(cuda, ns, npr, seed, shifted)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    nu = 2 * ns

    def r(dtype, *shape):
        v = (scale * torch.randn(*shape, generator=g)).to(dtype)
        if not shifted:
            return v.to(cuda)
        buf = torch.empty(v.numel() + 1, dtype=dtype, device=cuda)[1:].view(v.shape)
        return buf.copy_(v)

    b, f = torch.bfloat16, torch.float32
    t.update(L1u=r(b, nu, nu), L1p=r(b, nu, npr), LA1Z=r(b, nu, nu), l1=r(f, nu),
             L2p=r(b, npr, npr), L2u=r(b, npr, nu), l2=r(f, npr), L3s=r(b, ns, ns),
             L3p=r(b, 2, ns, npr), l3=r(f, nu))
    return t


def _split_forms(ns, npr):
    """(split wrapper, plain version, f32 grouped wrapper, operand names, the
    f32 form's operand names, terms summed into one output)."""
    return [
        (mv.step_ustar_df32, mv.step_ustar_df32_reference, mv.step_ustar,
         ("F1u", "F1p", "A1Z", "rho", "k1", *SPLIT_LOW["ustar"], "u", "p", "c"),
         ("F1u", "F1p", "A1Z", "rho", "k1", "u", "p", "c"), 2 * (4 * ns + npr)),
        (mv.step_pressure_df32, mv.step_pressure_df32_reference, mv.step_pressure,
         ("F2p", "F2u", "k2", *SPLIT_LOW["pressure"], "p", "u_star"),
         ("F2p", "F2u", "k2", "p", "u_star"), 2 * (npr + 2 * ns)),
        (mv.step_velocity_df32, mv.step_velocity_df32_reference, mv.step_velocity,
         ("F3s", "F3p", "k3", *SPLIT_LOW["velocity"], "u_star", "dp"),
         ("F3s", "F3p", "k3", "u_star", "dp"), 2 * (ns + npr)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("ns,npr", GROUP_SIZES)
def test_split_launches_match_plain(cuda, ns, npr, shifted):
    """Low limbs as large as the high ones, so a dropped or misrouted low
    term cannot hide below f32 rounding: each split launch within
    gap_tolerance of its plain version (twice the terms: both limbs), the
    bits repeating, the plain version without its low limbs outside the
    tolerance; one launch each, counted."""
    t = _split_operands(cuda, ns, npr, seed=ns * 11 + npr, shifted=shifted)
    for split, plain, _, names, _, terms in _split_forms(ns, npr):
        args = [t[n] for n in names]
        before = split.launches, mv.matvec.launches
        y = _tuple(split(*args))
        assert (split.launches, mv.matvec.launches) == (before[0] + 1, before[1])
        assert all(map(torch.equal, y, _tuple(split(*args))))
        yp = torch.cat(_tuple(plain(*args)))
        tol = mv.gap_tolerance(terms)
        assert mv.relative_gap(torch.cat(y), yp) <= tol
        dropped = [torch.zeros_like(a) if n[0] in "Ll" else a for n, a in zip(names, args)]
        assert mv.relative_gap(torch.cat(_tuple(plain(*dropped))), yp) > tol
        # The hi products through single launches: the plain version's other
        # order, within the same tolerance.
        ys = torch.cat(_tuple(plain(*args, apply=mv.matvec)))
        assert mv.relative_gap(torch.cat(y), ys) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("ns,npr", GROUP_SIZES[:4])
def test_split_launches_with_zero_low_limbs_equal_the_f32_form(cuda, ns, npr):
    """With every low limb zero the low sums are +0, so each split launch
    gives the f32 grouped launch's values exactly."""
    t = _split_operands(cuda, ns, npr, seed=ns + npr, scale=0.0)
    for split, _, grouped, names, f32_names, _ in _split_forms(ns, npr):
        y = _tuple(split(*(t[n] for n in names)))
        assert all(map(torch.equal, y, _tuple(grouped(*(t[n] for n in f32_names)))))


@pytest.mark.cuda
def test_split_launches_reject_what_they_do_not_take(cuda):
    t = _split_operands(cuda, 6, 3, seed=2)
    args = lambda **kw: [({**t, **kw})[n] for n in (
        "F1u", "F1p", "A1Z", "rho", "k1", "L1u", "L1p", "LA1Z", "l1", "u", "p", "c")]
    mv.step_ustar_df32(*args())
    with pytest.raises(TypeError):  # low limbs are bf16
        mv.step_ustar_df32(*args(L1u=t["L1u"].float()))
    with pytest.raises(TypeError):  # vector limbs f32
        mv.step_ustar_df32(*args(l1=t["l1"].bfloat16()))
    with pytest.raises(ValueError):  # the limbs' shapes follow the high ones'
        mv.step_ustar_df32(*args(L1p=t["L1p"][:, :2].contiguous()))
    with pytest.raises(ValueError, match="shared memory"):  # 2 x 30,001 floats
        z = lambda *shape, dtype=torch.float32: torch.zeros(*shape, device=cuda,
                                                            dtype=dtype)
        mv.step_pressure_df32(z(1, 1), z(1, 30000), z(1), z(1, 1, dtype=torch.bfloat16),
                              z(1, 30000, dtype=torch.bfloat16), z(1), z(1), z(30000))


# --------------------------------------------------------------------------
# The solver's paths on the card, launch by launch, on the ys930 pack mesh.
# --------------------------------------------------------------------------

# Per config: {counter: launches a step}; counters not named stay at 0.
MODES = {
    "f32": ({"precision": "f32"}, {"step_ustar": 1, "step_pressure": 1,
                                   "step_velocity": 1}),
    "df32": ({"precision": "df32"}, {"step_ustar_df32": 1, "step_pressure_df32": 1,
                                     "step_velocity_df32": 1}),
    "f32_unfused": ({"precision": "f32", "fused": False}, {"matvec": 3, "ell": 6}),
    "mixed": ({"precision": "mixed"}, {"matvec": 5, "ell": 8}),
    "f64": ({}, {"ell": 6}),
}
_MATVEC_COUNTERS = ("matvec", "matvec_dual", "step_ustar", "step_pressure",
                    "step_velocity", "step_ustar_df32", "step_pressure_df32",
                    "step_velocity_df32")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_solver_modes_launch_their_kernels(cuda, mode):
    """IPCSSolver on the card for each dense mode: 3 steps from rest make
    exactly the mode's launches a step, no call of a plain sparse version,
    and finite drags of the mode's dtype."""
    import pathlib

    import numpy as np

    from meshdqn_tpu_torch.mesh import TriMesh
    from meshdqn_tpu_torch.ops import sparse as ell
    from meshdqn_tpu_torch.solver import IPCSConfig, IPCSSolver

    repo = pathlib.Path(__file__).resolve().parents[1]
    z = np.load(repo / "checkpoints" / "ys930_results" / "ground_truth.npz")
    cfg, per_step = MODES[mode]
    s = IPCSSolver(TriMesh(z["coords"], z["cells"]), IPCSConfig(**cfg))
    assert s.device.type == "cuda"
    counters = lambda: {**{k: getattr(mv, k).launches for k in _MATVEC_COUNTERS},
                        "ell": ell.ell_matmat.launches,
                        "ell_plain": ell.ell_matmat_reference.calls}
    before = counters()
    st, d, _ = s.evolve(s.initial_state(), 3)
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in counters().items()}
    assert made == {k: 3 * per_step.get(k, 0) for k in made}
    assert d.dtype == s.pressure_dtype and torch.isfinite(d).all()

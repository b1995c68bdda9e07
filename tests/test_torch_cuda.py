"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one.  The file imports neither JAX nor the JAX package, so it runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import functools

import numpy as np
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
    with pytest.raises(ValueError):  # no right-hand side
        mv.matvec(M, torch.zeros(8, 0, device=cuda))
    with pytest.raises(ValueError):  # the k-column form is not dual
        mv.matvec_dual(M, *(torch.zeros(8, 3, device=cuda),) * 2)
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
# The matvec kernel's k-column form (k > 2: the ensemble's products) and the
# grouped form's batched instance (the batched flows' three launches).
# --------------------------------------------------------------------------

# The ensemble's products on both packs at 16 members (F3s on the (Ns, 2B)
# stack at k = 32), F1u past one launch's 32 columns, and small ragged
# shapes with every N % 4.
COLS_SHAPES = [(6644, 6644, 16), (6644, 876, 16), (876, 6644, 16), (876, 876, 16),
               (3322, 3322, 32), (6644, 6644, 40), (6050, 6050, 16), (797, 6050, 3),
               (3025, 3025, 32), (5, 3, 7), (33, 1, 3), (9, 130, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,k", COLS_SHAPES)
def test_k_columns_match_plain_and_equal_k1_launches(cuda, R, N, k):
    g = torch.Generator(device="cpu").manual_seed(R * 7 + N + k)
    M = torch.randn(R, N, generator=g).to(cuda)
    X = torch.randn(N, k, generator=g).to(cuda)
    before = mv.matvec.launches
    y = mv.matvec(M, X)
    assert mv.matvec.launches == before + -(-k // mv.COLS_MAX)
    assert y.shape == (R, k) and torch.equal(y, mv.matvec(M, X))
    ones = torch.stack([mv.matvec(M, X[:, j].contiguous()) for j in range(k)], dim=1)
    assert torch.equal(y, ones)  # every column a k = 1 launch's bits
    tol = mv.gap_tolerance(N)
    yp = mv.matvec_reference(M, X)
    assert mv.relative_gap(y, yp) <= tol
    for bits in (10, 7):
        rounded = mv.matvec_reference(mv.round_mantissa(M, bits),
                                       mv.round_mantissa(X, bits))
        assert mv.relative_gap(rounded, yp) > tol


@pytest.mark.cuda
def test_k_columns_from_shifted_storage(cuda):
    """M one element past a 16-byte boundary: every row has a head."""
    M = torch.empty(877 * 3322 + 1, device=cuda)[1:].view(877, 3322)
    M.copy_(torch.randn(877, 3322))
    X = torch.randn(3322, 16, device=cuda)
    ones = torch.stack([mv.matvec(M, X[:, j].contiguous()) for j in range(16)], dim=1)
    assert torch.equal(mv.matvec(M, X), ones)


def _k_column_checks(M, X):
    """matvec(M, X) equals, column by column, a k = 1 launch on that column,
    repeats its bits, and lies within gap_tolerance of the plain version,
    while the plain version on TF32- and bf16-rounded inputs does not."""
    N, k = X.shape
    before = mv.matvec.launches
    y = mv.matvec(M, X)
    assert mv.matvec.launches == before + -(-k // mv.COLS_MAX)
    assert y.shape == (M.shape[0], k) and torch.equal(y, mv.matvec(M, X))
    ones = torch.stack([mv.matvec(M, X[:, j].contiguous()) for j in range(k)], dim=1)
    assert torch.equal(y, ones)
    tol = mv.gap_tolerance(N)
    yp = mv.matvec_reference(M, X)
    assert mv.relative_gap(y, yp) <= tol
    for bits in (10, 7):
        rounded = mv.matvec_reference(mv.round_mantissa(M, bits), mv.round_mantissa(X, bits))
        assert mv.relative_gap(rounded, yp) > tol


def _offset_matrix(cuda, R, N, offset, g):
    """A seeded (R, N) matrix stored `offset` floats past a 16-byte boundary:
    its rows' heads move with the offset."""
    M = torch.empty(R * N + offset, device=cuda)[offset:].view(R, N)
    return M.copy_(torch.randn(R, N, generator=g))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [3, 16, 17, 32])
@pytest.mark.parametrize("N", [1028, 1029, 1030, 1031])
def test_k_column_schedule_at_every_head_and_offset(cuda, N, k, offset):
    """The launch shape of ops/matvec.py plan_cols at every N % 4 (head
    classes 1, 4, 2, 4), the kernel instances' column counts and either side
    of them, M off a 16-byte boundary, and 301 rows (no multiple of a tile)."""
    g = torch.Generator(device="cpu").manual_seed(N * 7 + k + offset)
    _k_column_checks(_offset_matrix(cuda, 301, N, offset, g),
                     torch.randn(N, k, generator=g).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,k,offset", [(301, 1030, 40, 0), (37, 1031, 35, 3),
                                          (6644, 6644, 40, 1), (5, 7, 67, 2)])
def test_k_column_launch_splits_read_rows_ld_apart(cuda, R, N, k, offset):
    """Past COLS_MAX columns a launch reads x and writes y at a row stride
    ld = k above its own columns, from a column offset that is not a
    multiple of 4 floats where k is not."""
    g = torch.Generator(device="cpu").manual_seed(R + N + k)
    _k_column_checks(_offset_matrix(cuda, R, N, offset, g),
                     torch.randn(N, k, generator=g).to(cuda))


BATCH_SIZES = [(3322, 876, 5), (3025, 797, 3), (5, 33, 4), (33, 7, 2), (438, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("ns,npr,B", BATCH_SIZES)
def test_batched_grouped_launches_equal_member_launches(cuda, ns, npr, B):
    ts = [_step_operands(cuda, ns, npr, seed=ns * 7 + npr + b) for b in range(B)]
    t = {n: torch.stack([tb[n] for tb in ts]) for n in ts[0]}
    for grouped, plain, names, terms in _forms(ns, npr):
        args = [t[n] for n in names]
        before = grouped.batched_launches, grouped.launches
        y = _tuple(grouped(*args))
        assert (grouped.batched_launches, grouped.launches) == (before[0] + 1, before[1])
        assert all(map(torch.equal, y, _tuple(mv.per_member(grouped, *args))))
        yp = torch.cat([a.flatten() for a in _tuple(mv.per_member(plain, *args))])
        assert mv.relative_gap(torch.cat([a.flatten() for a in y]), yp) <= (
            mv.gap_tolerance(terms))


@pytest.mark.cuda
def test_ensemble_member_one_equals_the_fused_solve(cuda):
    """100 ensemble steps on the ys930 pack (amplitudes 0.7, 1.0, 1.3):
    the member of amplitude 1.0 bit-equal to the solo fused f32 solve at
    every step, seven k-column launches a step."""
    import pathlib

    import numpy as np

    from meshdqn_tpu_torch.mesh import TriMesh
    from meshdqn_tpu_torch.solver import IPCSConfig, IPCSSolver, fused_step
    from meshdqn_tpu_torch.solver.ensemble import EnsembleFlows, ensemble_step

    repo = pathlib.Path(__file__).resolve().parents[1]
    z = np.load(repo / "checkpoints" / "ys930_results" / "ground_truth.npz")
    mesh = TriMesh(z["coords"], z["cells"])
    ens = EnsembleFlows(mesh, [0.7, 1.0, 1.3])
    solo = IPCSSolver(mesh, IPCSConfig(precision="f32"))
    e, s = ens.initial_state(), solo.initial_state()
    before = mv.matvec.launches
    for i in range(100):
        e, (d, _) = ensemble_step(ens.solver.dev, ens.K1, ens.K3, e)
        s, (ds, _) = fused_step(solo.dev, s)
        assert torch.equal(e.u[:, 1], s.u) and torch.equal(e.p[:, 1], s.p), i
    assert mv.matvec.launches == before + 7 * 100
    assert abs(d[1].item() / ds.item() - 1) < 1e-6
    assert torch.isfinite(e.u).all() and torch.isfinite(e.p).all()


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
# Every path makes one convection launch a step, f32 or f64.
MODES = {
    "f32": ({"precision": "f32"}, {"step_ustar": 1, "step_pressure": 1,
                                   "step_velocity": 1, "convection": 1}),
    "df32": ({"precision": "df32"}, {"step_ustar_df32": 1, "step_pressure_df32": 1,
                                     "step_velocity_df32": 1, "convection": 1}),
    "f32_unfused": ({"precision": "f32", "fused": False},
                    {"matvec": 3, "ell": 6, "convection": 1}),
    "mixed": ({"precision": "mixed"}, {"matvec": 5, "ell": 8, "convection": 1}),
    "f64": ({}, {"ell": 6, "convection": 1}),
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
    from meshdqn_tpu_torch.ops import convection as cv
    from meshdqn_tpu_torch.ops import sparse as ell
    from meshdqn_tpu_torch.solver import IPCSConfig, IPCSSolver

    repo = pathlib.Path(__file__).resolve().parents[1]
    z = np.load(repo / "checkpoints" / "ys930_results" / "ground_truth.npz")
    cfg, per_step = MODES[mode]
    s = IPCSSolver(TriMesh(z["coords"], z["cells"]), IPCSConfig(**cfg))
    assert s.device.type == "cuda"
    counters = lambda: {**{k: getattr(mv, k).launches for k in _MATVEC_COUNTERS},
                        "ell": ell.ell_matmat.launches,
                        "ell_plain": ell.ell_matmat_reference.calls,
                        "convection": cv.convection_vector.launches}
    before = counters()
    st, d, _ = s.evolve(s.initial_state(), 3)
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in counters().items()}
    assert made == {k: 3 * per_step.get(k, 0) for k in made}
    assert d.dtype == s.pressure_dtype and torch.isfinite(d).all()


# --------------------------------------------------------------------------
# Greedy deployment's device work (transfer, Q-network, env, re-simulation)
# on the card against the same on the CPU, on the ys930 pack.
# --------------------------------------------------------------------------

def _pack_env(device):
    import pathlib

    from meshdqn_tpu_torch.env import AirfoilEnv, GroundTruth
    from meshdqn_tpu_torch.utils import Config

    run = pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "ys930_results"
    return AirfoilEnv(Config.from_yaml(str(run / "config.yaml")),
                      ground_truth=GroundTruth.load(str(run / "ground_truth.npz")),
                      device=device)


def _once_coarsened(gt):
    import numpy as np

    from meshdqn_tpu_torch.coarsen import remove_vertex
    from meshdqn_tpu_torch.mesh import smooth

    v = int(np.flatnonzero(~gt.mesh.boundary_vertex_mask)[300])
    return smooth(remove_vertex(gt.mesh, v, backend="cavity").mesh, 50)


@pytest.mark.cuda
def test_transfer_on_card_equals_cpu(cuda):
    """locate and the per-removal device pass: cells equal except where a
    point sits on both cells (f32 margin), drag and lift within 1e-12, the
    f32 readback within one f32 ulp."""
    import numpy as np

    from meshdqn_tpu_torch.fem.spaces import P2Space
    from meshdqn_tpu_torch.mesh import mark_boundaries
    from meshdqn_tpu_torch.probes import force_probes
    from meshdqn_tpu_torch.transfer.interpolate import SnapshotTransfer, locate

    env = _pack_env("cpu")
    gt, target = env.gt, _once_coarsened(env.gt)
    ct = SnapshotTransfer(gt.mesh, gt.snapshots, device="cpu")
    gt_ = SnapshotTransfer(gt.mesh, gt.snapshots, device=cuda)
    pts = torch.tensor(P2Space(target).dof_coords())
    c_cells, c_xi = locate(ct.src, pts)
    g_cells, g_xi = (a.cpu() for a in locate(gt_.src, pts.to(cuda)))
    same = c_cells == g_cells
    assert same.float().mean() > 0.99
    assert torch.allclose(g_xi[same], c_xi[same], rtol=0, atol=1e-12)
    probes = force_probes(target, mark_boundaries(target), 1e-3)
    window = np.flatnonzero(~target.boundary_vertex_mask)[:180]
    inp = ct.step_inputs(target, window, *probes)
    (cuv, cpv, *_), cfin, cd, cl, cvw, cpw = ct.step_products_from_inputs(inp)
    (guv, gpv, *_), gfin, gd, gl, gvw, gpw = gt_.step_products_from_inputs(inp)
    assert cfin and gfin

    def forces(uv, pv):
        return (np.einsum("spc,fcp->fs", uv.cpu().numpy(), inp["probe_u"])
                + np.einsum("sp,fp->fs", pv.cpu().numpy(), inp["probe_p"]))

    np.testing.assert_allclose(forces(guv, gpv), forces(cuv, cpv), rtol=1e-12, atol=0)
    ulp = 2.0**-23
    for a, b in ((gd, cd), (gl, cl), (gvw, cvw), (gpw, cpw)):
        np.testing.assert_allclose(a, b, rtol=ulp, atol=0)


@pytest.mark.cuda
def test_q_network_and_env_step_on_card_equal_cpu(cuda):
    """The Q-network on real observations within 1e-4 of max |Q| of the
    CPU's (5x the largest f32 deviation of either package from the exact
    evaluation, tests/test_torch_models.py) with the same greedy action;
    one removal and one shift with the same StepInfo and observations to
    one f32 ulp."""
    import pathlib

    import numpy as np

    from meshdqn_tpu_torch.convert import load_deploy_weights
    from meshdqn_tpu_torch.models import forward
    from meshdqn_tpu_torch.rl import select_action

    w = (pathlib.Path(__file__).resolve().parents[1] / "meshdqn_tpu_torch" / "data"
         / "ys930_ckpt_best_deploy.npz")
    pc, _, _ = load_deploy_weights(w, "cpu")
    pg, _, _ = load_deploy_weights(w, cuda)
    ec, eg = _pack_env("cpu"), _pack_env(cuda)
    sc, sg = ec.reset(), eg.reset()
    for action in (None, 0, ec.action_space_n):
        if action is not None:
            sc, rc, dc, ic = ec.step(action)
            sg, rg, dg, ig = eg.step(action)
            assert (dg, ig.removed, ig.num_vertices, ig.terminal_reason) == (
                dc, ic.removed, ic.num_vertices, ic.terminal_reason)
            assert rg == pytest.approx(rc, rel=1e-9)
            np.testing.assert_allclose(ig.drags, ic.drags, rtol=2.0**-23, atol=0)
        for a, b in zip(sg, sc):
            if a.dtype == torch.float32:
                torch.testing.assert_close(a, b, rtol=2.0**-23, atol=0)
            else:
                assert torch.equal(a, b)
        qc = forward(pc, sc, topk=0.1, head="linear")
        qg = forward(pg, sg, topk=0.1, head="linear").cpu()
        assert (qg - qc).abs().max() <= 1e-4 * qc.abs().max()
        assert int(select_action(pg, sg)) == int(select_action(pc, sc))


@pytest.mark.cuda
def test_run_sim_fused_on_card_against_torch_matmul(cuda):
    """run_sim on a once-coarsened pack mesh, 100 fused f32 steps through
    the grouped matvec kernel (3 launches a step), against the same fused
    step with every dense apply a torch.matmul: snapshot drags and lifts
    within the solver's 1e-3 gate (two f32 summation orders)."""
    from meshdqn_tpu_torch.deploy import run_sim
    from meshdqn_tpu_torch.solver import IPCSConfig, IPCSSolver, fused_step

    env = _pack_env("cpu")
    mesh = _once_coarsened(env.gt)
    cfg = env.config
    cfg.agent.solver_steps, cfg.agent.save_steps, cfg.flow.precision = 100, 50, "f32"
    before = {k: getattr(mv, k).launches for k in _MATVEC_COUNTERS}
    d, l = run_sim(mesh, cfg, device=cuda)
    torch.cuda.synchronize()
    made = {k: getattr(mv, k).launches - before[k] for k in _MATVEC_COUNTERS}
    assert made == {k: 100 if k in ("step_ustar", "step_pressure", "step_velocity") else 0
                    for k in made}
    s = IPCSSolver(mesh, IPCSConfig(precision="f32"), device=cuda)
    st = s.initial_state()
    ref_d, ref_l = [], []
    for i in range(100):
        st, (dd, ll) = fused_step(s.dev, st, apply=mv.matvec_reference)
        if (i + 1) % 50 == 0:
            ref_d.append(float(dd))
            ref_l.append(float(ll))
    for got, ref in ((d, ref_d), (l, ref_l)):
        for a, b in zip(got, ref):
            assert abs(a / b - 1) < 1e-3


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_train_steps_on_card_against_jax_fixture(cuda):
    """Four gradient steps from the converted ys930 checkpoint on the
    fixture's pool, on the card: f64 equal to the JAX package's f64 steps to
    f64 rounding, the f32 steps within 2x of the JAX f32 steps' deviation
    (chip_smoke.train_steps_vs_fixture raises otherwise)."""
    cs = _chip_smoke()
    cs.train_steps_vs_fixture(cuda, *cs.train_fixture())


@pytest.mark.cuda
def test_batched_forward_on_card_against_cpu(cuda):
    """The Q-network's batched forward on the card over the fixture's 64
    states: held to the card's f64 evaluation within 2x of the per-graph
    forward's deviation (chip_smoke.batched_forward_vs_single raises
    otherwise), and the same argmax as the CPU's batch."""
    cs = _chip_smoke()
    assert cs.batched_forward_vs_single(cuda, *cs.train_fixture())["argmax_equal_cpu"]


# TPU kernel #6 (banded_matmat_bf16) on its solve path: the finest ys930
# mesh's production CG step with bf16 banded blocks
# (scripts/torch_bf16_banded_gate.py): (operator, columns) of its 7 banded
# operators; a step applies them 18 times (A1bc 7, A3bc_s 6, the others once)
# and the two ELL operators once each.
BF16_STEP = [("A1bc", 1), ("R1", 1), ("P1m_s", 1), ("BT_s", 1), ("G_s", 1), ("Ms", 2),
             ("A3bc_s", 2)]


@functools.lru_cache(maxsize=1)
def _finest_ys930():
    from meshdqn_tpu_torch.mesh import load_npz
    from meshdqn_tpu_torch.mesh.xdmf import DATA_DIR

    return load_npz(DATA_DIR / "ys930_0.05000_gen.npz")[0]


def _bf16_config():
    from meshdqn_tpu_torch.solver import IPCSConfig

    return IPCSConfig(precision="f32", fused=False, method="cg", cg_chunk=25, cg_iters_u=6,
                      cg_iters_m=5, cg_precond="block", cg_block_size=128,
                      cg_banded_dtype="bf16")


@pytest.mark.cuda
def test_bf16_banded_at_the_finest_ys930_step(cuda):
    """Each banded operator of the step with bf16 blocks (plain layout, x and
    every product rounded to bf16 as the JAX package rounds them) at the
    step's column count: the kernel within gap_tolerance of its window of
    the plain version, repeatable bits, one bf16 launch a product, and the
    controls (x in f32 with exact products; x rounded, exact products)
    outside it."""
    from meshdqn_tpu_torch.ops import banded as bd
    from meshdqn_tpu_torch.solver.ipcs import cg_matrices

    mats = cg_matrices(_finest_ys930(), _bf16_config())["matrices"]
    g = torch.Generator(device="cpu").manual_seed(6)
    for op, m in BF16_STEP:
        A = mats[op]
        bm = bd.BandedMatrix.from_scipy(A, device=cuda, dtype=torch.bfloat16)
        X = torch.randn((A.shape[1],) if m == 1 else (A.shape[1], m), generator=g).to(cuda)
        before = bd.banded_matmat.bf16_launches, bd.banded_matmat.launches
        y = bm @ X
        assert (bd.banded_matmat.bf16_launches, bd.banded_matmat.launches) == (
            before[0] + 1, before[1] + 1), op
        assert torch.equal(y, bm @ X), op
        kw = dict(pad=bm.pad, g=bm.g, aligned=False, n_rows=A.shape[0])
        plain = lambda b, x: bd.banded_matmat_reference(b, x, **kw)  # noqa: E731
        yp = plain(bm.blocks, X)
        tol = mv.gap_tolerance(bm.blocks.shape[2], torch.float32)
        assert mv.relative_gap(y, yp) <= tol, op
        # The controls over the rows that are not unit identity rows: on
        # A3bc_s those carry most of ||y||, and with them in the norm the
        # exact products move y by less than the tolerance.
        ident = (np.diff(A.tocsr().indptr) == 1) & (A.diagonal() == 1) \
            if A.shape[0] == A.shape[1] else np.zeros(A.shape[0], bool)
        rows = torch.as_tensor(~ident, device=cuda)
        blocks = bm.blocks.float()
        assert mv.relative_gap(plain(blocks, X), yp, rows) > tol, op
        assert mv.relative_gap(plain(blocks, X.bfloat16().float()), yp, rows) > tol, op


@pytest.mark.cuda
def test_bf16_cg_step_launches(cuda):
    """The bf16 config's solver on the finest ys930 mesh: every banded
    product of a step through banded_matmat_bf16, 18 launches a step, 2 ELL
    launches, no plain-version call; finite drag and lift."""
    from meshdqn_tpu_torch.ops import banded as bd
    from meshdqn_tpu_torch.ops import sparse
    from meshdqn_tpu_torch.solver import IPCSSolver

    s = IPCSSolver(_finest_ys930(), _bf16_config(), device=cuda)
    assert s.dev.A1bc.blocks.dtype == torch.bfloat16
    steps = 3
    before = (bd.banded_matmat.bf16_launches, bd.banded_matmat.launches,
              sparse.ell_matmat.launches, bd.banded_matmat_reference.calls)
    st, d, l = s.evolve(s.initial_state(), steps)
    torch.cuda.synchronize()
    after = (bd.banded_matmat.bf16_launches, bd.banded_matmat.launches,
             sparse.ell_matmat.launches, bd.banded_matmat_reference.calls)
    assert tuple(b - a for a, b in zip(before, after)) == (18 * steps, 18 * steps,
                                                           2 * steps, 0)
    assert torch.isfinite(d).all() and torch.isfinite(l).all()


@pytest.mark.cuda
def test_cg_step_counts_and_kernel_names_at_the_finest_ys930_step(cuda):
    """The benchmark's CG cell on the card (f32 config of _bf16_config with
    f32 blocks): with tracing on, a step counts 18 `banded.launches` and 13
    `pcg.products`, and the banded and ELL kernels' device events carry
    the names that portbench reads from the `__global__` lines, so
    `torch_ops_device_ms_per_step` does not count them as torch ops."""
    import dataclasses
    import pathlib

    from torch.profiler import ProfilerActivity, profile

    from meshdqn_tpu_torch.solver import IPCSSolver
    from meshdqn_tpu_torch.utils import profiling
    from portbench.devtrace import is_kernel, port_kernels

    cfg = dataclasses.replace(_bf16_config(), cg_banded_dtype="f32")
    s = IPCSSolver(_finest_ys930(), cfg, device=cuda)
    state = s.initial_state()
    steps = 3
    profiling.take_trace()
    profiling.trace_on()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, d, l = s.evolve(state, steps)
            torch.cuda.synchronize()
    finally:
        profiling.trace_off()
    _, counts = profiling.take_trace()
    assert counts["steps"] == steps
    assert counts["banded.launches"] == 18 * steps
    assert counts["pcg.products"] == 13 * steps
    assert torch.isfinite(d).all() and torch.isfinite(l).all()
    names = port_kernels(pathlib.Path(__file__).resolve().parents[1])
    assert {"banded_tiles_kernel", "ell_kernel"} <= names
    from torch.autograd import DeviceType

    device_events = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    for kernel in ("banded_tiles_kernel", "ell_kernel"):
        assert any(is_kernel(name, kernel) for name in device_events), kernel


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["banded", "ell"])
def test_cg_step_graph_equals_the_python_step(cuda, layout):
    """With tracing off a CG solver on the card replays its captured step
    (CGStepGraph); with tracing on it runs the Python step.  Over two evolve
    calls from a seeded start both give the same drags, lifts, state and
    warm start bit for bit, the graph moves the launch counters by the
    Python step's launches, and a state that evolve returned stays as it
    was while the graph runs on."""
    import dataclasses

    from meshdqn_tpu_torch.ops import banded as bd
    from meshdqn_tpu_torch.ops import convection as cv
    from meshdqn_tpu_torch.ops import sparse
    from meshdqn_tpu_torch.solver import IPCSSolver
    from meshdqn_tpu_torch.utils import profiling

    cfg = dataclasses.replace(_bf16_config(), cg_banded_dtype="f32", cg_layout=layout)
    s = IPCSSolver(_finest_ys930(), cfg, device=cuda)
    g = torch.Generator().manual_seed(18)
    u0 = (0.01 * torch.randn(s.ndofs_u, generator=g)).to(cuda)
    counters = lambda: (bd.banded_matmat.launches, sparse.ell_matmat.launches,  # noqa: E731
                        cv.convection_vector.launches)

    def run(trace):
        s.reset_warm_start()
        state = s.initial_state()._replace(u=u0.clone())
        if trace:
            profiling.trace_on()
        try:
            before = counters()
            mid, d1, l1 = s.evolve(state, 7)
            kept = (mid.u.clone(), mid.p.clone())
            state, d2, l2 = s.evolve(mid, 5)
            torch.cuda.synchronize()
            made = tuple(b - a for a, b in zip(before, counters()))
        finally:
            profiling.trace_off()
            profiling.take_trace()
        assert torch.equal(mid.u, kept[0]) and torch.equal(mid.p, kept[1])
        return (torch.cat([d1, d2]), torch.cat([l1, l2]), state.u, state.p,
                s._cg_ustar.clone()), made

    eager, eager_made = run(trace=True)
    assert not s._cg_graphs
    graph, graph_made = run(trace=False)
    assert list(s._cg_graphs) == [(6, 5, 1)]
    again, _ = run(trace=False)
    assert graph_made == eager_made
    assert eager_made[2] == 12 and eager_made[0 if layout == "banded" else 1] > 0
    for a, b, c in zip(eager, graph, again):
        assert torch.equal(a, b) and torch.equal(b, c)
    assert torch.isfinite(graph[0]).all()


# --------------------------------------------------------------------------
# The convection kernel (csrc/convection.cu, ops/convection.py
# convection_vector) against its plain version, the torch twin, on the
# benchmark's mesh in the fused layout (the resolution sweep's 0.10 ys930
# row, pad_quantum 768: ns_pad 6144, cells_pad 256), on the ys930 pack
# unpadded and on the pack in the banded CG layout (dof_perm).
# --------------------------------------------------------------------------

CONV_LAYOUTS = ("fine_padded", "pack", "pack_cg")


@functools.lru_cache(maxsize=None)
def _conv_host(layout):
    """(mesh, ConvectionKernel.build keywords, real dofs mask) of a layout."""
    import pathlib

    from meshdqn_tpu_torch.mesh import TriMesh, load_npz
    from meshdqn_tpu_torch.mesh.xdmf import DATA_DIR

    if layout == "fine_padded":
        mesh = load_npz(DATA_DIR / "ys930_0.10000_gen.npz")[0]
        ns = mesh.num_vertices + mesh.num_edges
        nsq = -(-ns // 768) * 768
        real = np.zeros(2 * nsq, bool)
        real[:ns] = real[nsq:nsq + ns] = True
        return mesh, {"ns_pad": nsq, "cells_pad": 256}, real
    repo = pathlib.Path(__file__).resolve().parents[1]
    z = np.load(repo / "checkpoints" / "ys930_results" / "ground_truth.npz")
    mesh = TriMesh(z["coords"], z["cells"])
    real = np.ones(2 * (mesh.num_vertices + mesh.num_edges), bool)
    if layout == "pack":
        return mesh, {}, real
    from meshdqn_tpu_torch.solver import IPCSConfig
    from meshdqn_tpu_torch.solver.ipcs import cg_matrices

    o2n = cg_matrices(mesh, IPCSConfig(precision="f32", method="cg"))["o2n_u"]
    return mesh, {"dof_perm": o2n}, real


def _conv_case(cuda, layout, dtype, seed=0):
    """(table on the card, u on the card, f64 evaluation of the same inputs
    on the host (chip_smoke.convection_exact), real dofs mask): u is
    N(0, 1) at the real dofs and 0 at the pad dofs."""
    from meshdqn_tpu_torch.ops.convection import ConvectionKernel

    mesh, kw, real = _conv_host(layout)
    k = ConvectionKernel.build(mesh, device=cuda, dtype=dtype, **kw)
    u = np.zeros(k.ndofs)
    u[real] = np.random.default_rng(seed).standard_normal(int(real.sum()))
    u = torch.tensor(u, dtype=dtype, device=cuda)
    return k, u, _chip_smoke().convection_exact(k, u), torch.as_tensor(real, device=cuda)


def _moved_slot(k, exact):
    """k with one entry of a slot table row moved into another row's pad:
    the entry of the largest output's first slot, into the first row with a
    pad slot left."""
    import dataclasses

    slots = k.dof_slots.clone()
    pad = 12 * k.cell_dofs.shape[0]
    d = int(exact.abs().argmax())
    d2 = int(torch.nonzero((slots == pad).any(dim=1))[0])
    assert d2 != d and slots[d, 0] != pad
    free = int(torch.nonzero(slots[d2] == pad)[0])
    slots[d2, free], slots[d, 0] = slots[d, 0].clone(), pad
    return dataclasses.replace(k, dof_slots=slots)


def _conv_tol(twin_gap, dtype):
    """The kernel's allowed norm-relative gap to the f64 evaluation: twice
    the twin's own, plus four ulps of the dtype."""
    eps = 2.0**-24 if dtype == torch.float32 else 2.0**-53
    return 2 * twin_gap + 4 * eps


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", CONV_LAYOUTS)
def test_convection_kernel_matches_plain_and_repeats_bits(cuda, layout, dtype):
    """The kernel against the f64 evaluation of the same inputs within
    `_conv_tol` of the twin's own gap, the same bits in 3 calls, 3 launches
    counted, the pad dofs exactly 0; the control, a table with one slot
    entry moved to another row, fails the same check."""
    from meshdqn_tpu_torch.ops import convection as cv

    k, u, exact, real = _conv_case(cuda, layout, dtype)
    before = cv.convection_vector.launches
    ys = [cv.convection_vector(k, u) for _ in range(3)]
    torch.cuda.synchronize()
    assert cv.convection_vector.launches == before + 3
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    assert ys[0].dtype == dtype and ys[0].shape == (k.ndofs,)
    tol = _conv_tol(mv.relative_gap(cv.convection_vector_reference(k, u), exact), dtype)
    assert mv.relative_gap(ys[0], exact) <= tol
    assert bool((ys[0][~real] == 0).all())
    assert mv.relative_gap(cv.convection_vector(_moved_slot(k, exact), u), exact) > tol


@pytest.mark.cuda
def test_convection_kernel_counts_and_rejects(cuda):
    """The launch counter and the tracer's `convection.launches`, equal to
    the `steps` counter in a traced solve; non-contiguous input, the wrong
    dtype, size and device, and a slot index past the pad rejected."""
    import dataclasses

    from meshdqn_tpu_torch.ops import convection as cv
    from meshdqn_tpu_torch.solver import IPCSConfig, IPCSSolver
    from meshdqn_tpu_torch.utils import profiling

    k, u, _, _ = _conv_case(cuda, "pack", torch.float32)
    solver = IPCSSolver(_conv_host("pack")[0], IPCSConfig(precision="f32"), device=cuda)
    profiling.take_trace()
    profiling.trace_on()
    try:
        before = cv.convection_vector.launches
        cv.convection_vector(k, u)
        cv.convection_vector(k, u)
        assert cv.convection_vector.launches == before + 2
        assert profiling.take_trace()[1] == {"convection.launches": 2}
        solver.evolve(solver.initial_state(), 10)
        counts = profiling.take_trace()[1]
    finally:
        profiling.trace_off()
    assert counts["convection.launches"] == counts["steps"] == 10
    with pytest.raises(ValueError, match="contiguous"):
        cv.convection_vector(k, torch.zeros(2 * k.ndofs, device=cuda)[::2])
    with pytest.raises(TypeError):
        cv.convection_vector(k, u.double())
    with pytest.raises(ValueError, match="shape"):
        cv.convection_vector(k, u[:-1])
    with pytest.raises(ValueError, match="is on"):
        cv.convection_vector(k, u.cpu())
    slots = k.dof_slots.clone()
    slots[0, 0] = 12 * k.cell_dofs.shape[0] + 1
    with pytest.raises(ValueError, match="outside"):
        cv.convection_vector(dataclasses.replace(k, dof_slots=slots), u)


FUSED_DEVIATION_JAX = "fused_f32_step_deviation_jax.json"


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_name", ["ys930", "ah93w145", "fine_padded"])
def test_fused_steps_with_the_convection_kernel_are_as_accurate(cuda, mesh_name):
    """The 2x rule of tests/test_torch_fused.py on the ensemble of one-step
    deviations (tests/test_torch_dense_modes.py's note): from each of the
    first 100 states of the exact trajectory (the fused step in f64, its
    convection the twin's), rounded to f32, one step of the fused f32
    solver (grouped launches, the convection kernel) and one exact step.
    The RMS over the states of the deviation in u, p, drag and lift stays
    within 2x JAX's own on the packs
    (scripts/torch_fused_step_deviation.py; JAX cannot be run on the
    benchmark's mesh within the tests' memory) and within 2x that of the
    same step with the twin's convection on every mesh."""
    import json
    import pathlib

    from meshdqn_tpu_torch.mesh import TriMesh
    from meshdqn_tpu_torch.mesh.xdmf import DATA_DIR
    from meshdqn_tpu_torch.ops.convection import convection_vector_reference
    from meshdqn_tpu_torch.solver import (
        FlowState, IPCSConfig, IPCSSolver, build_fused_operators, fused_step,
    )

    def rel(a, b):
        return (torch.linalg.vector_norm(a.double() - b)
                / torch.linalg.vector_norm(b)).item()

    def twin(dev):
        return dev._replace(conv=functools.partial(convection_vector_reference, dev.conv))

    if mesh_name == "fine_padded":
        mesh = _conv_host("fine_padded")[0]
        cfg = IPCSConfig(precision="f32", pad_quantum=768)
    else:
        repo = pathlib.Path(__file__).resolve().parents[1]
        run = repo / "checkpoints" / f"{mesh_name}_results"
        z = np.load(run / "ground_truth.npz")
        mesh = TriMesh(z["coords"], z["cells"])
        meta = json.loads((run / "ground_truth_meta.json").read_text())
        cfg = IPCSConfig(precision="f32", **{k: meta[k] for k in ("mu", "rho", "dt")})
    dev32 = IPCSSolver(mesh, cfg, device=cuda).dev
    dev64 = twin(build_fused_operators(mesh, cfg, device=cuda, dtype=torch.float64)[0])
    exact_step = functools.partial(fused_step, dev64, apply=mv.matvec_reference)
    exact = FlowState(u=torch.zeros(dev64.k1.shape[0], dtype=torch.float64, device=cuda),
                      p=torch.zeros(dev64.k2.shape[0], dtype=torch.float64, device=cuda))
    rows = {"kernel": [], "twin": []}
    for _ in range(100):
        exact, _ = exact_step(exact)
        start = FlowState(exact.u.float(), exact.p.float())
        ref, (rd, rl) = exact_step(FlowState(start.u.double(), start.p.double()))
        for path, dev in (("kernel", dev32), ("twin", twin(dev32))):
            s, (d, l) = fused_step(dev, start)
            rows[path].append((rel(s.u, ref.u), rel(s.p, ref.p),
                               abs(d.item() - rd.item()), abs(l.item() - rl.item())))
    rms = {p: np.sqrt(np.mean(np.square(r), axis=0)) for p, r in rows.items()}
    assert np.all(rms["kernel"] > 0), rms
    assert np.all(rms["kernel"] <= 2 * rms["twin"]), rms
    if mesh_name != "fine_padded":
        jax = json.loads((DATA_DIR / FUSED_DEVIATION_JAX).read_text())
        theirs = np.array([jax["rms"][mesh_name][m] for m in jax["metrics"]])
        assert np.all(rms["kernel"] <= 2 * theirs), (rms, theirs)

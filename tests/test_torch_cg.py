"""The port's PCG, its preconditioners and the convection kernel's dof_perm,
against the JAX package on the CPU, in f64.

Tolerances: the same algorithm in another summation order differs by f64
rounding amplified by the systems' conditioning (O(10) preconditioned);
1e-12 relative leaves three orders of headroom over that and fails on any
change of algorithm (an iteration more or less moves X by ~1e-3 here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from meshdqn_tpu.ops import cg as jcg
from meshdqn_tpu.ops.convection import ConvectionKernel as JConv
from meshdqn_tpu.ops.sparse import EllMatrix as JEll
from meshdqn_tpu_torch.ops import cg as tcg
from meshdqn_tpu_torch.ops.banded import BandedMatrix, permute_interleave_u
from meshdqn_tpu_torch.ops.convection import ConvectionKernel as TConv
from meshdqn_tpu_torch.ops.sparse import EllMatrix as TEll
from tests.torch_helpers import (cap_threads, jax_mesh, pack_mesh_arrays,
                                 port_mesh, rel)

cap_threads()

F64 = torch.float64
TOL = 1e-12


def spd_tridiag(n=80, seed=0):
    """tests/test_cg.py's mass-like SPD matrix: banded, diagonally dominant."""
    rng = np.random.default_rng(seed)
    d = 2.0 + rng.random(n)
    off = 0.3 * rng.random(n - 1)
    return sp.diags([off, d, off], [-1, 0, 1]).tocsr()


def spd_banded(n=96, w=6, seed=0):
    """tests/test_cg.py's banded SPD matrix with real off-diagonal coupling."""
    rng = np.random.default_rng(seed)
    B = sp.lil_matrix((n, n))
    for k in range(1, w + 1):
        off = 0.4 * rng.random(n - k) / k
        B = B + sp.diags([off, off], [-k, k])
    return ((B + B.T) * 0.5 + sp.diags(3.0 + rng.random(n))).tocsr()


def jacobi_pair(A):
    ja = JEll.from_scipy(A, dtype=jnp.float64)
    ta = TEll.from_scipy(A, device="cpu", dtype=F64)
    return ja, jcg.jacobi_inv(ja), ta, tcg.jacobi_inv(ta)


def test_jacobi_inv_equals_jax():
    A = spd_banded(50).tolil()
    A[7, 7] = 0.0  # a zero diagonal takes 1
    _, jd, _, td = jacobi_pair(A.tocsr())
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("n,nb", [(100, 32), (96, 32), (20, 64)])
def test_block_jacobi_equals_jax(n, nb):
    A = spd_banded(n)
    for tdt, jdt in ((F64, jnp.float64), (torch.float32, jnp.float32)):
        jb = jcg.block_jacobi_inv(A, nb=nb, dtype=jdt)
        tb = tcg.block_jacobi_inv(A, nb=nb, device="cpu", dtype=tdt)
        assert tb.n == jb.n and tb.inv_blocks.dtype == tdt
        np.testing.assert_array_equal(tb.inv_blocks.numpy(), np.asarray(jb.inv_blocks))
    R = np.random.default_rng(2).standard_normal((n, 3))
    got = tb.apply(torch.tensor(R, dtype=torch.float32)).double().numpy()
    assert rel(got, np.asarray(jb.apply(jnp.asarray(R, jnp.float32)))) < 1e-6
    tb64 = tcg.block_jacobi_inv(A, nb=nb, device="cpu", dtype=F64)
    jb64 = jcg.block_jacobi_inv(A, nb=nb, dtype=jnp.float64)
    assert rel(tb64.apply(torch.tensor(R)).numpy(), np.asarray(jb64.apply(jnp.asarray(R)))) < TOL


@pytest.mark.parametrize("case", ["solve", "converged", "warm_exact", "block", "block4",
                                  "banded_op"])
def test_pcg_matches_jax(case):
    """tests/test_cg.py:25-110's cases, each run through both packages."""
    if case in ("solve", "converged", "warm_exact"):
        n = {"solve": 80, "converged": 20, "warm_exact": 50}[case]
        A = spd_tridiag(n)
        ja, jd, ta, td = jacobi_pair(A)
        if case == "solve":
            Bm, X0, iters = np.random.default_rng(1).standard_normal((n, 2)), np.zeros((n, 2)), 60
        elif case == "converged":
            Bm, X0, iters = np.ones((n, 1)), np.zeros((n, 1)), 500
        else:
            x = np.linalg.solve(A.toarray(), np.ones(n))
            Bm, X0, iters = np.ones((n, 1)), x[:, None], 3
    else:
        A = spd_banded(96)
        ja, jd, ta, td = jacobi_pair(A)
        if case.startswith("block"):
            jd = jcg.block_jacobi_inv(A, nb=32, dtype=jnp.float64)
            td = tcg.block_jacobi_inv(A, nb=32, device="cpu", dtype=F64)
        if case == "banded_op":  # the production operator layout
            ta = BandedMatrix.from_scipy(A, device="cpu", dtype=F64, R=8)
        Bm = np.random.default_rng(3).standard_normal((96, 1))
        X0, iters = np.zeros((96, 1)), (4 if case == "block4" else 60)
    Xj = np.asarray(jcg.pcg(ja, jd, jnp.asarray(Bm), jnp.asarray(X0), iters=iters))
    Xt = tcg.pcg(ta, td, torch.tensor(Bm), torch.tensor(X0), iters).numpy()
    assert np.all(np.isfinite(Xt))
    assert rel(Xt, Xj) < TOL
    if case in ("solve", "block", "banded_op"):
        np.testing.assert_allclose(Xt, np.linalg.solve(A.toarray(), Bm),
                                   rtol=1e-9, atol=1e-11)


def test_pcg_zero_iterations_returns_x0():
    A = spd_tridiag(10)
    _, _, ta, td = jacobi_pair(A)
    X0 = torch.arange(10.0, dtype=F64)[:, None]
    assert torch.equal(tcg.pcg(ta, td, torch.ones(10, 1, dtype=F64), X0, 0), X0)


def _f32_banded_system(m, n=96):
    """The production solve's operand types at a small size: a banded
    operator of f32 blocks, an f32 BlockJacobi and (n, m) f32 B and X0."""
    A = spd_banded(n)
    rng = np.random.default_rng(4)
    return (BandedMatrix.from_scipy(A, device="cpu", dtype=torch.float32, R=8),
            tcg.block_jacobi_inv(A, nb=32, device="cpu", dtype=torch.float32),
            torch.tensor(rng.standard_normal((n, m)), dtype=torch.float32),
            torch.tensor(rng.standard_normal((n, m)), dtype=torch.float32))


@pytest.mark.parametrize("m", [1, 2])
def test_pcg_on_cpu_tensors_is_the_plain_path(m):
    """The production operand types on CPU tensors take pcg_reference, bit
    for bit, and neither the kernels nor the `pcg.fused` counter."""
    from meshdqn_tpu_torch.ops import banded
    from meshdqn_tpu_torch.utils import profiling

    A, dinv, B, X0 = _f32_banded_system(m)
    launches = (banded.banded_matmat.launches, tcg.pcg_update.launches)
    profiling.take_trace()
    profiling.trace_on()
    try:
        X = tcg.pcg(A, dinv, B, X0, 5)
    finally:
        profiling.trace_off()
    _, counts = profiling.take_trace()
    assert torch.equal(X, tcg.pcg_reference(A, dinv, B, X0, 5))
    assert counts == {"pcg.products": 6}
    assert (banded.banded_matmat.launches, tcg.pcg_update.launches) == launches


@pytest.mark.parametrize("case", ["bf16_blocks", "jacobi_diagonal", "m3", "cpu_tensors"])
def test_pcg_fused_rejects_what_its_kernels_do_not_take(case):
    """pcg_fused raises on each operand its kernels do not take, before any
    launch; the CPU tensors are the last thing it checks, so every other
    case raises for its own reason here."""
    from meshdqn_tpu_torch.ops import banded

    A, dinv, B, X0 = _f32_banded_system(3 if case == "m3" else 1)
    if case == "bf16_blocks":
        A = BandedMatrix.from_scipy(spd_banded(96), device="cpu", dtype=torch.bfloat16, R=8)
        err, match = TypeError, "f32 blocks"
    elif case == "jacobi_diagonal":
        dinv = torch.ones(96)
        err, match = TypeError, "BlockJacobi"
    elif case == "m3":
        err, match = ValueError, "m in"
    else:
        err, match = ValueError, "CUDA device"
    launches = (banded.banded_matmat.launches, tcg.pcg_update.launches)
    with pytest.raises(err, match=match):
        tcg.pcg_fused(A, dinv, B, X0, 3)
    assert (banded.banded_matmat.launches, tcg.pcg_update.launches) == launches


def test_convection_dof_perm_matches_jax():
    """The banded CG layout's interleaved RCM dof order, on the ys930 pack
    mesh: the kernel consumes and produces vectors in the new layout."""
    arrays = pack_mesh_arrays()
    jm, tm = jax_mesh(arrays), port_mesh(arrays)
    ns = tm.num_vertices + tm.num_edges
    rng = np.random.default_rng(0)
    rank = np.empty(ns, dtype=np.int64)
    rank[rng.permutation(ns)] = np.arange(ns)
    n2o = permute_interleave_u(ns, rank)
    o2n = np.empty_like(n2o)
    o2n[n2o] = np.arange(2 * ns)
    jk = JConv.build(jm, dtype=jnp.float64, dof_perm=o2n)
    tk = TConv.build(tm, device="cpu", dtype=F64, dof_perm=o2n)
    plain = TConv.build(tm, device="cpu", dtype=F64)
    u = rng.standard_normal(2 * ns)
    got = tk(torch.tensor(u)).numpy()
    assert rel(got, np.asarray(jk(jnp.asarray(u)))) < TOL
    # Permuting in, convecting in the old layout, permuting out: the same.
    assert rel(got, plain(torch.tensor(u[o2n]))[n2o].numpy()) < TOL
    with pytest.raises(ValueError):
        TConv.build(tm, device="cpu", dtype=F64, dof_perm=o2n, ns_pad=ns + 2)

"""The port's sparse layouts and the plain versions of their kernels, against
the JAX package on the CPU.

Operators: `EllMatrix.from_scipy` and `BandedMatrix.from_scipy` build the
JAX package's layouts bit for bit (no tolerance).  Products: the plain
versions `ell_matmat_reference` and `banded_matmat_reference`, which the
CUDA kernels are held to on the card, match the JAX package's Pallas
kernels run in interpret mode, its XLA formulation and scipy.  Two sums of
the same products in another order differ by rounding only, so they are
held to ops.matvec.gap_tolerance(terms per row, dtype): 2 sqrt(n) u of the
result's norm, u = 2^-24 in f32 and 2^-53 in f64.
"""
import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from meshdqn_tpu.ops import banded as jbanded
from meshdqn_tpu.ops import pallas_kernels as jpk
from meshdqn_tpu.ops.sparse import EllMatrix as JEll
from meshdqn_tpu_torch.ops import banded as tbanded
from meshdqn_tpu_torch.ops import matvec as mv
from meshdqn_tpu_torch.ops import sparse as tsparse
from tests.torch_helpers import REPO, cap_threads

cap_threads()

F32, F64 = torch.float32, torch.float64
JDT = {F32: jnp.float32, F64: jnp.float64, torch.bfloat16: jnp.bfloat16}


def spd_rcm(n, seed, density=0.02):
    """A random symmetric pattern with a unit diagonal, RCM-reordered: a
    banded operator like the solver's."""
    A = sp.random(n, n, density=density, random_state=seed, format="csr")
    A = (A + A.T + sp.eye(n)).tocsr()
    perm = tbanded.rcm_permutation(A)
    return A[perm][:, perm].tocsr()


def rect(A, kind):
    """kind: 'square' (g = R), 'wide' (n/2 x n: g = 2R), 'tall' (n x n/2:
    g = R/2), the shapes of the (Ns x 2Ns) and (2Ns x Ns) operators."""
    n = A.shape[0]
    return {"square": A, "wide": A[: n // 2, :], "tall": A[:, : n // 2]}[kind].tocsr()


def as_np32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t).astype(np.float32)


# --------------------------------------------------------------------------
# Operators: bit-equal layouts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("R,C,density", [(100, 80, 0.05), (777, 333, 0.03)])
def test_ell_from_scipy_bit_equal(R, C, density, dtype):
    A = sp.random(R, C, density=density, random_state=R, format="csr")
    j = JEll.from_scipy(A, dtype=JDT[dtype])
    t = tsparse.EllMatrix.from_scipy(A, device="cpu", dtype=dtype)
    assert t.shape == tuple(j.shape)
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(j.vals))
    assert t.cols.dtype == torch.int32 and t.vals.dtype == dtype


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("R", [8, 128])
@pytest.mark.parametrize("kind", ["square", "wide", "tall"])
def test_banded_from_scipy_bit_equal(kind, R, aligned):
    A = rect(spd_rcm(600, seed=1), kind)
    for dtype in (F32, F64, torch.bfloat16):
        j = jbanded.BandedMatrix.from_scipy(A, dtype=JDT[dtype], R=R,
                                            device_build=False, aligned128=aligned)
        t = tbanded.BandedMatrix.from_scipy(A, device="cpu", dtype=dtype, R=R,
                                            aligned128=aligned)
        assert (t.pad, t.g, t.shape, t.aligned128) == (j.pad, j.g, tuple(j.shape),
                                                       j.aligned128)
        assert t.blocks.shape == j.blocks.shape and t.blocks.dtype == dtype
        if dtype == F64:
            np.testing.assert_array_equal(t.blocks.numpy(), np.asarray(j.blocks))
        else:  # bf16 and f32 widen to f32 exactly, so equal f32 means equal bits
            np.testing.assert_array_equal(as_np32(t.blocks), as_np32(j.blocks))
    assert t.g == {"square": R, "wide": 2 * R, "tall": R // 2}[kind]


def test_rcm_and_interleave_equal_jax():
    A = spd_rcm(300, seed=4)
    np.testing.assert_array_equal(tbanded.rcm_permutation(A), jbanded.rcm_permutation(A))
    rank = np.random.default_rng(0).permutation(50)
    np.testing.assert_array_equal(tbanded.permute_interleave_u(50, rank),
                                  jbanded.permute_interleave_u(50, rank))


# --------------------------------------------------------------------------
# Plain versions against the JAX kernels and scipy
# --------------------------------------------------------------------------


def check_gap(y, ref, n, dtype):
    y = np.asarray(y, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64).reshape(y.shape)
    gap = np.linalg.norm(y - ref) / np.linalg.norm(ref)
    tol = mv.gap_tolerance(n, dtype)
    assert gap <= tol, (gap, tol)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("R,C", [(130, 64), (512, 512)])
def test_ell_plain_matches_pallas_and_scipy(R, C, m, dtype):
    rng = np.random.default_rng(R + m)
    A = sp.random(R, C, density=0.05, random_state=R + 1, format="csr")
    j = JEll.from_scipy(A, dtype=JDT[dtype])
    t = tsparse.EllMatrix.from_scipy(A, device="cpu", dtype=dtype)
    X = rng.standard_normal((C, m))
    Xt = torch.tensor(X, dtype=dtype)
    y = (t @ (Xt[:, 0] if m == 1 else Xt)).numpy()
    K = t.cols.shape[1]
    # ell_matvec_pallas takes one right-hand side: one call per column.
    ypl = np.stack([np.asarray(jpk.ell_matvec_pallas(
        j.cols, j.vals, jnp.asarray(Xt[:, c].numpy()), block_rows=64,
        interpret=True)) for c in range(m)], axis=1)
    check_gap(y, ypl, K, dtype)
    check_gap(y, A @ Xt.double().numpy(), K, dtype)


def padded_x(bm, X, L):
    Xpad = np.zeros((L, X.shape[1]), np.float32)
    Xpad[bm.pad : bm.pad + X.shape[0]] = X
    return jnp.asarray(Xpad)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("kind", ["square", "wide", "tall"])
def test_banded_plain_matches_pallas_plain_layout(kind, m):
    A = rect(spd_rcm(600, seed=2), kind)
    t = tbanded.BandedMatrix.from_scipy(A, device="cpu", dtype=F32, R=128)
    j = jbanded.BandedMatrix.from_scipy(A, dtype=jnp.float32, R=128,
                                        device_build=False)
    X = np.random.default_rng(m).standard_normal((A.shape[1], m)).astype(np.float32)
    y = t.matmat(torch.tensor(X)).numpy()
    B, R, W = t.blocks.shape
    L = (B + W // t.g - 1) * t.g
    ypl = jpk.banded_matmat_pallas(j.blocks, padded_x(t, X, L), t.g, A.shape[0],
                                   sb=2, interpret=True)
    check_gap(y, ypl, W, F32)
    check_gap(y, A @ X.astype(np.float64), W, F32)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("kind", ["square", "wide", "tall"])
def test_banded_plain_matches_pallas_aligned_layout(kind, m):
    A = rect(spd_rcm(600, seed=7), kind)
    t = tbanded.BandedMatrix.from_scipy(A, device="cpu", dtype=F32, R=128,
                                        aligned128=True)
    j = jbanded.BandedMatrix.from_scipy(A, dtype=jnp.float32, R=128,
                                        device_build=False, aligned128=True)
    X = np.random.default_rng(m).standard_normal((A.shape[1], m)).astype(np.float32)
    y = t.matmat(torch.tensor(X)).numpy()
    # x padded and laid out (L/128, 128, m) as BandedMatrix.matmat does it.
    B, R, W = t.blocks.shape
    L = max(((B - 1) * t.g // 128) * 128 + W, A.shape[1] + t.pad)
    L = -(-L // 128) * 128
    Xpad = padded_x(t, X, L).reshape(L // 128, 128, m)
    ypl = jpk.banded_matmat_pallas_aligned(j.blocks, Xpad, t.g, A.shape[0], sb=2,
                                           interpret=True)
    check_gap(y, ypl, W, F32)
    check_gap(y, A @ X.astype(np.float64), W, F32)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("aligned", [False, True])
def test_banded_plain_f64_matches_xla_and_scipy(aligned, m):
    """The Pallas kernels return f32; the f64 product is the XLA
    formulation's (meshdqn_tpu/ops/banded.py:banded_matmat)."""
    A = rect(spd_rcm(600, seed=3), "tall")
    t = tbanded.BandedMatrix.from_scipy(A, device="cpu", dtype=F64, R=128,
                                        aligned128=aligned)
    X = np.random.default_rng(5).standard_normal((A.shape[1], m))
    y = t.matmat(torch.tensor(X)).numpy()
    W = t.blocks.shape[2]
    check_gap(y, A @ X, W, F64)
    if not aligned:
        j = jbanded.BandedMatrix.from_scipy(A, dtype=jnp.float64, R=128,
                                            device_build=False)
        check_gap(y, jbanded.banded_matmat(j.blocks, jnp.asarray(X), j.pad, j.g,
                                           j.shape), W, F64)


def _bench_module():
    spec = importlib.util.spec_from_file_location(
        "banded_formulation_bench", REPO / "scripts" / "banded_formulation_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16])
def test_banded_plain_matches_make_pl_kernel(dtype):
    """scripts/banded_formulation_bench.py's R = 128 kernel (vpu mode) is the
    aligned product at g = 128, m = 1.

    f32 blocks: order of summation only.  bf16 blocks: the JAX kernel rounds
    x to bf16 before its products (`xw.astype(blk.dtype)`); the port widens
    the blocks to f32 and keeps x in f32, as the aligned kernel does.  So the
    port is held to the JAX kernel on x rounded to bf16 at the f32 gap, and
    on the unrounded x to bf16's unit roundoff 2^-8."""
    import jax

    bench = _bench_module()
    A = spd_rcm(600, seed=9)
    n = A.shape[0]
    jblocks, pad, W, L = bench.build_R128(A, JDT[dtype], jnp)
    t = tbanded.BandedMatrix.from_scipy(A, device="cpu", dtype=dtype, R=128,
                                        aligned128=True)
    assert (t.pad, t.g, t.blocks.shape[2]) == (pad, 128, W)
    np.testing.assert_array_equal(as_np32(t.blocks), as_np32(jblocks))
    mvk = bench.make_pl_kernel(jblocks, pad, L, n, jax, jnp, mode="vpu", sb=8,
                               interpret=True)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    if dtype == F32:
        check_gap(t @ torch.tensor(x), mvk(jnp.asarray(x)), W, F32)
        return
    xb = torch.tensor(x).to(torch.bfloat16).float()
    check_gap(t @ xb, mvk(jnp.asarray(xb.numpy())), W, F32)
    y, ypl = (t @ torch.tensor(x)).double().numpy(), np.asarray(mvk(jnp.asarray(x)))
    assert np.linalg.norm(y - ypl) / np.linalg.norm(ypl) <= 2.0**-8


def test_plain_versions_count_their_calls():
    A = spd_rcm(200, seed=5)
    t = tbanded.BandedMatrix.from_scipy(A, device="cpu", dtype=F32, R=8)
    e = tsparse.EllMatrix.from_scipy(A, device="cpu", dtype=F32)
    x = torch.ones(200)
    before = (tbanded.banded_matmat_reference.calls, tsparse.ell_matmat_reference.calls,
              tbanded.banded_matmat.launches, tsparse.ell_matmat.launches)
    t @ x
    e @ x
    after = (tbanded.banded_matmat_reference.calls, tsparse.ell_matmat_reference.calls,
             tbanded.banded_matmat.launches, tsparse.ell_matmat.launches)
    # CPU tensors take the plain versions; no kernel launch is counted.
    assert after == (before[0] + 1, before[1] + 1, before[2], before[3])

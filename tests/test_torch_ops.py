"""The port's ops against the JAX package's: the matvec kernels' plain
versions against the Pallas kernels (interpret mode, as tests/test_pallas.py
runs them), and the convection term.  The CUDA kernels themselves are held
against the plain versions in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdqn_tpu.ops.convection import ConvectionKernel as JaxConvection
from meshdqn_tpu.ops.pallas_kernels import matvec_dual_pallas, matvec_pallas
from meshdqn_tpu_torch.ops import matvec as mv
from meshdqn_tpu_torch.ops.convection import ConvectionKernel, dof_slots
from tests.torch_helpers import cap_threads, jax_mesh, port_mesh, small_mesh_arrays

cap_threads()

# tests/test_pallas.py's tolerance for these kernels: f32 sums of a few
# hundred unit-normal products, taken in a different order.
RTOL, ATOL = 2e-6, 1e-5


def _mx(R, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((R, N)).astype(np.float32),
            rng.standard_normal(N).astype(np.float32))


class TestMatvecPlainVsPallas:
    """The shapes of tests/test_pallas.py::TestMatvecPallas: R not a
    multiple of the block, k=2, and the dual form."""

    def test_single(self):
        M, x = _mx(700, 500)
        y = mv.matvec(torch.from_numpy(M), torch.from_numpy(x))
        ref = matvec_pallas(jnp.asarray(M), jnp.asarray(x), block_rows=128,
                            interpret=True)
        assert y.shape == (700,) and y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)

    def test_multi_rhs(self):
        M, _ = _mx(256, 384)
        X = np.random.default_rng(3).standard_normal((384, 2)).astype(np.float32)
        Y = mv.matvec(torch.from_numpy(M), torch.from_numpy(X))
        ref = matvec_pallas(jnp.asarray(M), jnp.asarray(X), block_rows=64,
                            interpret=True)
        assert Y.shape == (256, 2)
        np.testing.assert_allclose(Y.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)

    def test_dual(self):
        M, x = _mx(512, 512, seed=1)
        lo = x * np.float32(3e-8)
        y = mv.matvec_dual(torch.from_numpy(M), torch.from_numpy(x),
                           torch.from_numpy(lo))
        ref = matvec_dual_pallas(jnp.asarray(M), jnp.asarray(x), jnp.asarray(lo),
                                 block_rows=128, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)

    def test_cpu_tensors_take_the_plain_version_uncounted(self):
        M, x = _mx(33, 17, seed=2)
        m, xt = torch.from_numpy(M), torch.from_numpy(x)
        before = (mv.matvec.launches, mv.matvec_dual.launches)
        assert torch.equal(mv.matvec(m, xt), mv.matvec_reference(m, xt))
        assert torch.equal(mv.matvec_dual(m, xt, xt),
                           mv.matvec_dual_reference(m, xt, xt))
        # f64 stays f64 on the plain path (the tests' f64 steps use it).
        assert mv.matvec(m.double(), xt.double()).dtype == torch.float64
        assert (mv.matvec.launches, mv.matvec_dual.launches) == before


def _kernel_order(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = M @ x summed in csrc/matvec.cu's order (k = 1), for M stored
    contiguously from a 16-byte boundary, as torch allocates it.  Row r
    starts at entry r * N, so its scalar head is h = (-r N) mod 4 entries (at
    most N, and 0 for every row when N % 4 == 0), taken by lanes 0 .. h - 1;
    then lane l takes float4 columns h + 4v .. h + 4v + 3 for v = l, l + 32,
    ..., each entry by fused multiply-add (exact f64 product and sum, one
    rounding to f32); then the tail of fewer than 4 columns on lanes 0, 1,
    2; then the xor-shuffle tree over the 32 lanes."""
    R, N = M.shape
    heads = torch.tensor([min((-r * N) % 4, N) for r in range(R)])
    y = torch.empty(R)
    for h in heads.unique().tolist():
        rows = heads == h
        m64, x64 = M[rows].double(), x.double()
        lanes = torch.zeros(m64.shape[0], 32, dtype=torch.float32)

        def fma(cols, lane_ids):
            lanes[:, lane_ids] = (lanes[:, lane_ids].double()
                                  + m64[:, cols] * x64[cols]).float()

        fma(torch.arange(h), torch.arange(h))
        nvec = (N - h) // 4
        for v0 in range(0, nvec, 32):
            v = torch.arange(v0, min(v0 + 32, nvec))
            for e in range(4):
                fma(h + 4 * v + e, v - v0)
        tail = torch.arange(h + 4 * nvec, N)
        fma(tail, tail - h - 4 * nvec)
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, torch.arange(32) ^ off]
        y[rows] = lanes[:, 0]
    return y


@pytest.mark.parametrize("R,N", [(64, 6644), (64, 3322), (64, 876), (64, 797),
                                 (64, 8), (5, 3), (33, 1),
                                 # rows with a scalar head: ah93w145's widths
                                 # and every N % 4
                                 (64, 6050), (64, 3025), (16, 5), (16, 6), (16, 7)])
def test_gap_tolerance_passes_the_kernels_order_and_rejects_lost_precision(R, N):
    # What the card's check (tests/test_torch_cuda.py, chip_smoke.py) rests
    # on: the kernel's summation order sits well inside gap_tolerance of
    # torch's, while TF32- or bf16-rounded inputs, or a dual product that
    # drops x_lo, fall outside it.
    g = torch.Generator().manual_seed(R * 7 + N)
    M, x = torch.randn(R, N, generator=g), torch.randn(N, generator=g)
    lo = 2.0**-8 * x.abs() * torch.randn(N, generator=g)
    tol = mv.gap_tolerance(N)
    yp = mv.matvec_reference(M, x)
    # Headroom: the emulated order lands within a third of the tolerance.
    assert mv.relative_gap(_kernel_order(M, x), yp) <= tol / 3
    for bits in (10, 7):
        rounded = mv.matvec_reference(mv.round_mantissa(M, bits),
                                       mv.round_mantissa(x, bits))
        assert mv.relative_gap(rounded, yp) > 10 * tol
    assert mv.relative_gap(yp, mv.matvec_dual_reference(M, x, lo)) > 10 * tol


# --- convection ------------------------------------------------------------

@pytest.fixture(scope="module")
def meshes():
    arrays = small_mesh_arrays()
    return jax_mesh(arrays), port_mesh(arrays)


# f64 evaluations of the same quadrature, summed in a different order; the
# element vectors are O(1), so 1e-12 absolute is ~1e4 f64 ulps of headroom.
CONV_ATOL = 1e-12


@pytest.mark.parametrize("cells_pad", [0, 256])
def test_convection_matches_jax_f64(meshes, cells_pad):
    jm, tm = meshes
    jk = JaxConvection.build(jm, dtype=jnp.float64, cells_pad=cells_pad)
    tk = ConvectionKernel.build(tm, device="cpu", dtype=torch.float64,
                                cells_pad=cells_pad)
    if cells_pad:
        assert tk.cell_dofs.shape[0] % cells_pad == 0
        assert torch.all(tk.wdet[tm.num_cells:] == 0)
    u = np.random.default_rng(3).standard_normal(jk.ndofs)
    np.testing.assert_allclose(tk(torch.from_numpy(u)).numpy(),
                               np.asarray(jk(jnp.asarray(u))), rtol=0,
                               atol=CONV_ATOL)


@pytest.mark.parametrize("cells_pad", [0, 256])
def test_convection_ns_pad_matches_jax_f64(meshes, cells_pad):
    # ns_pad with cells_pad is the pad_quantum configuration of the solver.
    jm, tm = meshes
    ns = jm.num_vertices + jm.num_edges
    nsq = -(-ns // 128) * 128
    jk = JaxConvection.build(jm, dtype=jnp.float64, ns_pad=nsq,
                             cells_pad=cells_pad)
    tk = ConvectionKernel.build(tm, device="cpu", dtype=torch.float64,
                                ns_pad=nsq, cells_pad=cells_pad)
    u = np.zeros(2 * nsq)
    rng = np.random.default_rng(4)
    u[:ns] = rng.standard_normal(ns)
    u[nsq : nsq + ns] = rng.standard_normal(ns)
    rt = tk(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(rt, np.asarray(jk(jnp.asarray(u))), rtol=0,
                               atol=CONV_ATOL)
    assert np.all(rt[ns:nsq] == 0) and np.all(rt[nsq + ns :] == 0)


def test_convection_from_jax_arrays_is_the_same_kernel(meshes):
    jm, tm = meshes
    jk = JaxConvection.build(jm, dtype=jnp.float64)
    tk = ConvectionKernel.from_arrays(
        np.asarray(jk.cell_dofs), np.asarray(jk.phi), np.asarray(jk.gphys),
        np.asarray(jk.wdet), jk.ndofs, device="cpu", dtype=torch.float64,
    )
    u = torch.from_numpy(np.random.default_rng(5).standard_normal(jk.ndofs))
    built = ConvectionKernel.build(tm, device="cpu", dtype=torch.float64)
    assert torch.equal(tk(u), built(u))


def test_dof_slots_lists_every_entry_once_in_order():
    cell_dofs = np.array([[0, 2, 1], [2, 3, 0], [2, 2, 4]])
    table = dof_slots(cell_dofs, 6)
    pad = cell_dofs.size
    assert table.shape == (6, 4)
    np.testing.assert_array_equal(table[2], [1, 3, 6, 7])
    np.testing.assert_array_equal(table[5], [pad] * 4)
    real = np.sort(table[table != pad])
    np.testing.assert_array_equal(real, np.arange(pad))
    for d in range(6):
        row = table[d][table[d] != pad]
        assert np.all(np.diff(row) > 0)
        assert np.all(cell_dofs.ravel()[row] == d)

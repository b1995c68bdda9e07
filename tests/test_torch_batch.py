"""The port's batched and ensemble flows against the JAX package's, on the
CPU at small size: the stacked layout, 100 steps of each against the JAX
programs and the port's own solo solves, the k-column matvec kernel's
summation order, write_xdmf and the sweep script.  The kernels themselves
are held to these plain paths on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from meshdqn_tpu.mesh import read_xdmf as jax_read_xdmf
from meshdqn_tpu.mesh import write_xdmf as jax_write_xdmf
from meshdqn_tpu.solver import IPCSConfig as JaxConfig
from meshdqn_tpu.solver.batch import BatchedFlows as JaxBatched
from meshdqn_tpu.solver.batch import _evolve_batched
from meshdqn_tpu.solver.batch import stack_fused as jax_stack_fused
from meshdqn_tpu.solver.ensemble import EnsembleFlows as JaxEnsemble
from meshdqn_tpu.solver.ensemble import _evolve_ensemble
from meshdqn_tpu_torch.convert import fused_operators_from_numpy
from meshdqn_tpu_torch.mesh import read_xdmf, write_xdmf
from meshdqn_tpu_torch.ops import matvec as mv
from meshdqn_tpu_torch.solver import FlowState, IPCSConfig, IPCSSolver
from meshdqn_tpu_torch.solver.batch import BatchedFlows, evolve_batched_n, stack_fused
from meshdqn_tpu_torch.solver.ensemble import (EnsembleFlows, EnsembleState,
                                               evolve_ensemble_n)
from tests.meshes import channel_mesh
from tests.test_torch_fused import jax_operator_arrays
from tests.test_torch_ops import _kernel_order
from tests.torch_helpers import (REPO, cap_threads, jax_mesh, port_mesh, rel,
                                 small_mesh_arrays)

cap_threads()

STEPS = 100
F32 = JaxConfig(precision="f32", fused=True)


def _arrays(m):
    return m.coords, m.cells


@pytest.fixture(scope="module")
def jax_batched():
    # Different sizes force real padding.
    return JaxBatched([channel_mesh(18, 6), channel_mesh(24, 8)], F32)


@pytest.fixture(scope="module")
def port_batched(jax_batched):
    meshes = [port_mesh(_arrays(s.mesh)) for s in jax_batched.solvers]
    return BatchedFlows(meshes, IPCSConfig(precision="f32", fused=True), device="cpu")


@pytest.fixture(scope="module")
def jax_ensemble():
    return JaxEnsemble(channel_mesh(16, 6), [1.0, 0.5], F32)


def _port_devs(jax_devs, dtype):
    return [fused_operators_from_numpy(*jax_operator_arrays(d), "cpu", dtype)
            for d in jax_devs]


# --- the stacked layout -----------------------------------------------------

def test_stack_fused_equals_jax_layout(jax_batched):
    """The port's stack_fused on JAX's per-member operators gives JAX's
    stacked arrays exactly, the convection tables member by member (JAX pads
    its cells with inert copies, wdet = 0; the port keeps each member's
    own)."""
    devs = [s.dev for s in jax_batched.solvers]
    port = stack_fused(_port_devs(devs, torch.float32))
    jax = jax_stack_fused(devs)
    for name in port._fields:
        if name == "conv":
            continue
        a, b = getattr(port, name).numpy(), np.asarray(getattr(jax, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    ns_max = port.F3s.shape[1]
    for i, conv in enumerate(port.conv):
        C = conv.cell_dofs.shape[0]
        assert conv.ndofs == jax.conv.ndofs == 2 * ns_max
        np.testing.assert_array_equal(conv.cell_dofs.numpy(),
                                      np.asarray(jax.conv.cell_dofs[i, :C]))
        np.testing.assert_array_equal(
            conv.gphys.numpy(),
            np.asarray(jax.conv.gphys[i, :C]).transpose(0, 2, 1, 3).astype(np.float32))
        np.testing.assert_array_equal(conv.wdet.numpy(),
                                      np.asarray(jax.conv.wdet[i, :C], np.float32))
        assert np.all(np.asarray(jax.conv.wdet[i, C:]) == 0)


# --- BatchedFlows -----------------------------------------------------------

def test_batched_f32_is_as_accurate_as_jax(jax_batched):
    """JAX's per-member operators carried across, stacked and stepped 100
    times by each package; the port's f32 deviation from the port's f64
    evaluation of the same batched step within 2x of JAX's own (as
    tests/test_torch_fused.py holds the solo step)."""
    devs = [s.dev for s in jax_batched.solvers]
    runs = {}
    for dtype in (torch.float32, torch.float64):
        dev = stack_fused(_port_devs(devs, dtype))
        B, nu, npr = dev.k1.shape[0], dev.k1.shape[1], dev.k2.shape[1]
        state = FlowState(torch.zeros(B, nu, dtype=dtype), torch.zeros(B, npr, dtype=dtype))
        runs[dtype] = evolve_batched_n(dev, state, STEPS)
    (s32, (d32, l32)), (s64, (d64, l64)) = runs[torch.float32], runs[torch.float64]
    js, (jd, jl) = _evolve_batched(jax_batched.dev, jax_batched.initial_state(), STEPS)
    assert rel(s32.u.numpy(), s64.u.numpy()) <= 2 * rel(js.u, s64.u.numpy())
    assert rel(s32.p.numpy(), s64.p.numpy()) <= 2 * rel(js.p, s64.p.numpy())
    for port, jax, exact in ((d32, jd, d64), (l32, jl, l64)):
        assert (np.abs(port.numpy() - exact.numpy()).max()
                <= 2 * np.abs(np.asarray(jax, np.float64) - exact.numpy()).max())


def test_batched_members_match_their_solo_solves(port_batched):
    """meshdqn_tpu's own check (tests/test_batch.py): each member against
    its solo fused f32 solve, drag and lift to 1e-6, the live state to
    1e-4, in the padded [x | 0 | y | 0] layout."""
    out = port_batched.solve(STEPS, save_steps=50)
    assert out["drags"].shape == (2, STEPS) and out["snap_drags"].shape == (2, 2)
    ns_max = port_batched.n_u // 2
    for i, solo in enumerate(port_batched.solvers):
        st, d, l = solo.evolve(solo.initial_state(), STEPS)
        np.testing.assert_allclose(out["drags"][i].numpy(), d.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["lifts"][i].numpy(), l.numpy(), rtol=0, atol=1e-6)
        ns = solo.ndofs_u // 2
        ub, us = out["state"].u[i].numpy(), st.u.numpy()
        np.testing.assert_allclose(ub[:ns], us[:ns], atol=1e-4)
        np.testing.assert_allclose(ub[ns_max:ns_max + ns], us[ns:], atol=1e-4)
        np.testing.assert_allclose(out["state"].p[i, :solo.ndofs_p].numpy(),
                                   st.p.numpy(), atol=1e-3)


def test_batched_padding_stays_zero(port_batched):
    state, d, l = port_batched.evolve(port_batched.initial_state(), 20)
    ns0 = port_batched.solvers[0].ndofs_u // 2
    ns_max = port_batched.n_u // 2
    assert ns0 < ns_max
    u0 = state.u[0].numpy()
    assert np.all(u0[ns0:ns_max] == 0.0) and np.all(u0[ns_max + ns0:] == 0.0)
    assert np.all(state.p[0, port_batched.solvers[0].ndofs_p:].numpy() == 0.0)
    assert np.isfinite(u0).all()
    assert np.abs(u0[:ns0]).max() > 0.1  # real flow in the live block
    assert d.shape == (2, 20)


def test_batched_shard_raises(port_batched):
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        port_batched.shard(None)


def test_batched_takes_only_f32():
    with pytest.raises(ValueError, match="fused f32"):
        BatchedFlows([port_mesh(_arrays(channel_mesh(4, 2)))], IPCSConfig(), device="cpu")


# --- EnsembleFlows ----------------------------------------------------------

def test_ensemble_f32_is_as_accurate_as_jax(jax_ensemble):
    """JAX's operators and amplitude-scaled K1, K3 carried across, 100
    ensemble steps of each package; the port's f32 deviation from its f64
    evaluation within 2x of JAX's."""
    arrays, conv = jax_operator_arrays(jax_ensemble.solver.dev)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        dev = fused_operators_from_numpy(arrays, conv, "cpu", dtype)
        K1 = torch.tensor(np.asarray(jax_ensemble.K1), dtype=dtype)
        K3 = torch.tensor(np.asarray(jax_ensemble.K3), dtype=dtype)
        B = K1.shape[1]
        state = EnsembleState(torch.zeros(dev.k1.shape[0], B, dtype=dtype),
                              torch.zeros(dev.k2.shape[0], B, dtype=dtype))
        runs[dtype] = evolve_ensemble_n(dev, K1, K3, state, STEPS)
    (s32, _), (s64, _) = runs[torch.float32], runs[torch.float64]
    js, _ = _evolve_ensemble(jax_ensemble.solver.dev, jax_ensemble.K1, jax_ensemble.K3,
                             jax_ensemble.initial_state(), STEPS)
    assert rel(s32.u.numpy(), s64.u.numpy()) <= 2 * rel(js.u, s64.u.numpy())
    assert rel(s32.p.numpy(), s64.p.numpy()) <= 2 * rel(js.p, s64.p.numpy())


@pytest.fixture(scope="module")
def port_ensemble():
    mesh = port_mesh(_arrays(channel_mesh(16, 6)))
    ens = EnsembleFlows(mesh, [1.0, 0.5], device="cpu")
    return ens, ens.evolve(ens.initial_state(), STEPS)


def test_ensemble_amplitude_one_matches_solo(port_ensemble):
    """meshdqn_tpu's member check (tests/test_batch.py:72-92): the member of
    amplitude 1.0 against the solo fused f32 solve, and the half-amplitude
    member a weaker flow."""
    ens, (st, d, l) = port_ensemble
    solo = IPCSSolver(ens.solver.mesh, IPCSConfig(precision="f32"), device="cpu")
    sts, ds, ls = solo.evolve(solo.initial_state(), STEPS)
    np.testing.assert_allclose(st.u[:, 0].numpy(), sts.u.numpy(), atol=1e-4)
    np.testing.assert_allclose(st.p[:, 0].numpy(), sts.p.numpy(), atol=1e-3)
    u0 = np.linalg.norm(st.u[:, 0].numpy())
    u1 = np.linalg.norm(st.u[:, 1].numpy())
    assert np.isfinite(u1) and 0.1 * u0 < u1 < 0.9 * u0
    assert d.shape == (2, STEPS) and l.shape == (2, STEPS)


def test_ensemble_inlet_velocity_scales():
    """meshdqn_tpu's tests/test_batch.py:94-110: the Dirichlet dofs hold the
    amplitude-scaled profile."""
    ens = EnsembleFlows(port_mesh(_arrays(channel_mesh(16, 6))), [1.0, 2.0],
                        device="cpu")
    st, _, _ = ens.evolve(ens.initial_state(), 5)
    u = st.u.numpy()
    ops = ens.solver.operators
    bc = ops.u_bc_mask
    np.testing.assert_allclose(u[bc, 0], ops.u_bc_values[bc], atol=1e-6)
    np.testing.assert_allclose(u[bc, 1], 2 * ops.u_bc_values[bc], atol=1e-5)


def test_ensemble_takes_only_f32():
    with pytest.raises(ValueError, match="fused f32"):
        EnsembleFlows(port_mesh(_arrays(channel_mesh(4, 2))), [1.0],
                      IPCSConfig(precision="df32"), device="cpu")


# --- the k-column kernel's summation order ----------------------------------

def _column_order(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y = M @ X summed in csrc/matvec.cu's k-column order, for M stored
    contiguously from a 16-byte boundary: launches of up to COLS_MAX columns,
    each walking windows of column_window(N, kc) columns of M.  In window c0
    lane l takes, for each column, the scalar head (window 0 only, lane <
    h), the row's float4s v in [c0 / 4, (c0 + W) / 4) with v = l mod 32 in
    order, then its tail column if that lies in [c0, c0 + W); each read
    checked against the window's staged rows.  Then the xor tree."""
    R, N = M.shape
    k = X.shape[1]
    heads = torch.tensor([min((-r * N) % 4, N) for r in range(R)])
    Y = torch.empty(R, k)
    for c_lo in range(0, k, mv.COLS_MAX):
        kc = min(mv.COLS_MAX, k - c_lo)
        W = mv.column_window(N, kc)
        assert W % 128 == 0 and 4 * kc * (W + 4) <= mv.COLS_SMEM_BYTES
        x64 = X[:, c_lo:c_lo + kc].double()
        for h in heads.unique().tolist():
            rows = heads == h
            m64 = M[rows].double()
            lanes = torch.zeros(m64.shape[0], 32, kc, dtype=torch.float32)
            nvec = (N - h) // 4
            t = h + 4 * nvec + torch.arange(32)  # each lane's tail column

            def fma(cols, lane_ids, c0):
                # Every column read lies in the window's staged rows.
                assert cols.numel() == 0 or (
                    0 <= cols.min() - c0 and cols.max() - c0 < min(W + 4, N - c0))
                prod = m64[:, cols, None] * x64[cols][None]
                lanes[:, lane_ids] = (lanes[:, lane_ids].double() + prod).float()

            for c0 in range(0, N, W):
                if c0 == 0:
                    fma(torch.arange(h), torch.arange(h), c0)
                vb, ve = c0 // 4, min(c0 // 4 + W // 4, nvec)
                for v0 in range(vb, ve, 32):
                    v = torch.arange(v0, min(v0 + 32, ve))
                    for e in range(4):
                        fma(h + 4 * v + e, v - v0, c0)
                here = (t < N) & (t >= c0) & (t < c0 + W)
                fma(t[here], torch.arange(32)[here], c0)
            for off in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[:, torch.arange(32) ^ off]
            Y[rows, c_lo:c_lo + kc] = lanes[:, 0]
    return Y


@pytest.mark.parametrize("R,N,k", [(8, 1531, 3), (8, 1531, 16), (8, 1531, 32),
                                   (8, 1531, 40), (6, 9003, 3), (5, 130, 16)])
def test_k_column_order_equals_k1_order_per_column(R, N, k):
    """Each column of the k-column order equals the single form's k = 1
    order (tests/test_torch_ops.py) bit for bit, at widths whose rows carry
    every head offset (N % 4 = 3 or 2) and over several windows (N > W at
    k = 16, 32 and at k = 3 past 8064); and it lies within a third of
    gap_tolerance of the plain product, as the k <= 2 order does."""
    g = torch.Generator().manual_seed(R * 7 + N + k)
    M, X = torch.randn(R, N, generator=g), torch.randn(N, k, generator=g)
    Y = _column_order(M, X)
    for j in range(k):
        assert torch.equal(Y[:, j], _kernel_order(M, X[:, j].contiguous())), j
    assert mv.relative_gap(Y, mv.matvec_reference(M, X)) <= mv.gap_tolerance(N) / 3


def test_column_windows_cover_the_ensemble_shapes():
    # ys930: 2Ns = 6644, Np = 876; ah93w145 6050, 797; k = 16 and the F3s
    # stack's 32.
    for N in (6644, 3322, 876, 6050, 3025, 797):
        for k in (3, 16, 32):
            W = mv.column_window(N, k)
            assert W % 128 == 0 and 128 <= W and 4 * k * (W + 4) <= mv.COLS_SMEM_BYTES
            assert W < N + 128


def test_plain_matvec_takes_any_k_on_the_cpu():
    """On CPU tensors matvec is its plain version, one product per column
    (as the kernel gives each column a k = 1 launch's bits), and launches
    nothing."""
    g = torch.Generator().manual_seed(0)
    M, X = torch.randn(7, 9, generator=g), torch.randn(9, 40, generator=g)
    before = mv.matvec.launches
    y = mv.matvec(M, X)
    assert torch.equal(y, torch.stack([M @ X[:, j] for j in range(40)], dim=1))
    assert mv.relative_gap(y, M @ X) <= mv.gap_tolerance(9)
    assert mv.matvec.launches == before


# --- write_xdmf and the sweep script ----------------------------------------

def test_write_xdmf_round_trips_as_jax_writer(tmp_path):
    arrays = small_mesh_arrays()
    port_path, jax_path = tmp_path / "port_triangle.xdmf", tmp_path / "jax_triangle.xdmf"
    write_xdmf(str(port_path), port_mesh(arrays))
    jax_write_xdmf(str(jax_path), jax_mesh(arrays))
    for reader in (read_xdmf, jax_read_xdmf):
        a, b = reader(str(port_path)), reader(str(jax_path))
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.cells, b.cells)
        np.testing.assert_array_equal(a.coords, arrays[0])
        np.testing.assert_array_equal(a.cells, arrays[1])
    assert (port_path.read_text().replace("port_", "")
            == jax_path.read_text().replace("jax_", ""))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_reynolds_ensemble_runs(tmp_path, capsys):
    src = tmp_path / "channel_triangle.xdmf"
    write_xdmf(str(src), port_mesh(_arrays(channel_mesh(16, 6))))
    amps, d, l = _script("torch_reynolds_ensemble").main(
        ["--mesh", str(src), "--B", "3", "--steps", "5", "--device", "cpu"])
    np.testing.assert_allclose(amps, [0.4, 0.85, 1.3])
    assert d.shape == l.shape == (3,) and np.isfinite(d).all()
    assert capsys.readouterr().out.count("  amp ") == 3


def test_torch_make_sweep_runs(tmp_path):
    import csv

    main = _script("torch_make_sweep").main

    src = tmp_path / "small_triangle.xdmf"
    write_xdmf(str(src), port_mesh(small_mesh_arrays()))
    rows = main(["--mesh", str(src), "--targets", "478", "474", "--steps", "20",
                 "--out-dir", str(tmp_path / "sweep"), "--device", "cpu"])
    assert [r["NUM_COORDS"] for r in rows] == [482, 478, 474]
    with open(tmp_path / "sweep" / "ys930_decimation_benchmark.csv") as f:
        read = list(csv.DictReader(f))
    assert list(read[0]) == ["NUM_COORDS", "RESOLUTION", "TIME", "DRAG", "LIFT"]
    assert [int(r["NUM_COORDS"]) for r in read] == [482, 478, 474]
    assert all(np.isfinite(float(r["DRAG"])) and float(r["DRAG"]) != 0 for r in read)
    assert os.path.exists(tmp_path / "sweep" / "ys930_474_triangle.xdmf")

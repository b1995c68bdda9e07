"""The port's large-mesh CG solve (IPCSConfig(method='cg')) against the JAX
package on the CPU, on the ys930 pack mesh (876 vertices; its RCM span 459
passes the banded layout's bandwidth guard), and the finest meshes it
carries as .npz files.

Tolerances: f64 steps of the same algebra in another summation order agree
to ~1e-12 per step; over 50 steps the pressure system's conditioning and
the flow amplify that to ~1e-11 (1e-12 to 8e-12 after 20 steps on the CPU),
so drag, lift, u and p are held to 1e-10.  A run split over two evolve
calls makes the same launches in the same order as one call: bit-equal.
"""
import csv
import hashlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meshdqn_tpu.solver as js
from meshdqn_tpu_torch.convert import cg_operators_from_numpy
from meshdqn_tpu_torch.mesh import load_npz, read_xdmf
from meshdqn_tpu_torch.mesh.xdmf import DATA_DIR
from meshdqn_tpu_torch.ops.banded import BandedMatrix
from meshdqn_tpu_torch.ops.cg import BlockJacobi
from meshdqn_tpu_torch.solver import (BandedCGOperators, CGOperators, FlowState,
                                      IPCSConfig, IPCSSolver, evolve_cg_n)
from tests.torch_helpers import (REPO, cap_threads, jax_leaves, jax_mesh,
                                 pack_mesh_arrays, port_mesh, rel)

cap_threads()

STEPS = 50
TOL = 1e-10
# cg_iters_u, cg_iters_m, cg_pressure_refine: the production iteration
# counts, a third of the defaults' work, which keeps the file's JAX runs on
# the CPU short.
ITERS = (6, 5, 1)
F64_CG = dict(precision="f64", method="cg", cg_iters_u=6, cg_iters_m=5)
# The production config of bench.py:253-260 (f32, block-Jacobi nb = 128).
PRODUCTION = dict(precision="f32", fused=False, method="cg", cg_chunk=25,
                  cg_iters_u=6, cg_iters_m=5, cg_precond="block",
                  cg_block_size=128)


@pytest.fixture(scope="module")
def meshes():
    arrays = pack_mesh_arrays()
    return jax_mesh(arrays), port_mesh(arrays)


@pytest.fixture(scope="module")
def jax_runs(meshes):
    """50 f64 steps of the JAX solver in its ELL layout with Jacobi, and in
    its banded layout with block-Jacobi.  The banded layout is built at
    R = 128, its TPU production layout and the port's default (JAX takes
    R = 8 on the CPU)."""
    import meshdqn_tpu.ops.banded as jbanded

    build = jbanded.BandedMatrix.from_scipy.__func__
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbanded.BandedMatrix, "from_scipy",
                   classmethod(lambda cls, A, **kw: build(cls, A, R=128, **kw)))
        for layout, prec in (("banded", "block"), ("ell", "jacobi")):
            s = js.IPCSSolver(meshes[0], js.IPCSConfig(
                **F64_CG, cg_layout=layout, cg_precond=prec))
            st, d, l = s.evolve(s.initial_state(), STEPS)
            runs[prec] = (s, np.asarray(st.u), np.asarray(st.p),
                          np.asarray(d), np.asarray(l))
    assert runs["block"][0].dev.A1bc.blocks.shape[1] == 128
    return runs


@pytest.mark.parametrize("layout,prec", [("banded", "block"), ("ell", "jacobi")])
def test_operators_carried_across_step_like_jax(jax_runs, layout, prec):
    """JAX's own operators through cg_operators_from_numpy: the port's steps
    (ipcs_step_cg_banded / ipcs_step_cg) match evolve_cg_banded_n /
    evolve_cg_n on drag, lift, u and p."""
    s, u, p, d, l = jax_runs[prec]
    dev = cg_operators_from_numpy(jax_leaves(s.dev), "cpu", torch.float64)
    banded = layout == "banded"
    assert isinstance(dev, BandedCGOperators if banded else CGOperators)
    if banded:
        assert isinstance(dev.A1bc, BandedMatrix) and isinstance(dev.d1inv, BlockJacobi)
    state = FlowState(u=torch.zeros(len(u), dtype=torch.float64),
                      p=torch.zeros(len(p), dtype=torch.float64))
    st, ustar, (td, tl) = evolve_cg_n(dev, state, torch.zeros_like(state.u), STEPS,
                                      *ITERS)
    assert rel(td.numpy(), d) < TOL and rel(tl.numpy(), l) < TOL
    assert abs(td[-1].item() / d[-1] - 1) < TOL and abs(tl[-1].item() / l[-1] - 1) < TOL
    assert rel(st.u.numpy(), u) < TOL and rel(st.p.numpy(), p) < TOL
    assert rel(ustar.numpy(), np.asarray(s._cg_ustar)) < TOL


@pytest.mark.parametrize("prec", ["jacobi", "block"])
def test_carried_ell_slices_equal_from_scipy(meshes, jax_runs, prec):
    """The ELL kernel's slices of the operators carried across from JAX's
    arrays (every operator of its ELL layout; Kp and A2bc of the banded
    one) equal those EllMatrix.from_scipy packs from the port's own
    matrices, which hold the same entries."""
    from meshdqn_tpu_torch.ops.sparse import EllMatrix
    from meshdqn_tpu_torch.solver.ipcs import cg_matrices

    dev = cg_operators_from_numpy(jax_leaves(jax_runs[prec][0].dev), "cpu",
                                  torch.float64)
    layout = "ell" if prec == "jacobi" else "banded"
    mats = cg_matrices(meshes[1], IPCSConfig(**F64_CG, cg_layout=layout,
                                             cg_precond=prec))["matrices"]
    carried = {k: v for k, v in dev._asdict().items() if isinstance(v, EllMatrix)}
    assert len(carried) == (9 if layout == "ell" else 2)
    for name, e in carried.items():
        ref = EllMatrix.from_scipy(mats[name], device="cpu", dtype=torch.float64)
        assert e.slices.lanes == ref.slices.lanes, name
        for f in ("cols", "vals", "offsets", "widths"):
            assert torch.equal(getattr(e.slices, f), getattr(ref.slices, f)), (name, f)


@pytest.mark.parametrize("prec", ["jacobi", "block"])
def test_public_f64_solver_matches_jax(meshes, jax_runs, prec):
    """IPCSSolver(..., device='cpu') builds its own operators in its default
    banded layout.  Jacobi is held to JAX's ELL run: the pointwise
    preconditioner does not depend on the dof order, so the two layouts
    agree to rounding.  Exported velocities are in JAX's [ux; uy] layout."""
    s, u, p, d, l = jax_runs[prec]
    t = IPCSSolver(meshes[1], IPCSConfig(**F64_CG, cg_precond=prec), device="cpu")
    assert isinstance(t.dev, BandedCGOperators) and t.dev.A1bc.blocks.shape[1] == 128
    st, td, tl = t.evolve(t.initial_state(), STEPS)
    assert td.dtype == torch.float64
    assert abs(td[-1].item() / d[-1] - 1) < TOL and abs(tl[-1].item() / l[-1] - 1) < TOL
    assert rel(td.numpy(), d) < TOL and rel(tl.numpy(), l) < TOL
    assert rel(t.export_u(st.u).numpy(), np.asarray(s.export_u(jnp.asarray(u)))) < TOL
    assert rel(st.p.numpy(), p) < TOL


def test_public_ell_layout_matches_jax(meshes, jax_runs):
    s, u, p, d, l = jax_runs["jacobi"]
    t = IPCSSolver(meshes[1], IPCSConfig(**F64_CG, cg_layout="ell"), device="cpu")
    assert isinstance(t.dev, CGOperators) and t._u_export_idx is None
    st, td, tl = t.evolve(t.initial_state(), STEPS)
    assert rel(td.numpy(), d) < TOL and rel(tl.numpy(), l) < TOL
    assert rel(st.u.numpy(), u) < TOL and rel(st.p.numpy(), p) < TOL


@pytest.fixture(scope="module")
def production(meshes):
    return IPCSSolver(meshes[1], IPCSConfig(**PRODUCTION), device="cpu")


def test_f32_production_solve(production, jax_runs):
    out = production.solve(STEPS, save_steps=25)
    assert out["drags"].shape == out["lifts"].shape == (STEPS,)
    assert out["drags"].dtype == torch.float32
    assert len(out["snapshots"]) == 2 and out["snap_drags"].shape == (2,)
    assert np.all(np.isfinite(out["snap_drags"])) and np.all(np.isfinite(out["snap_lifts"]))
    st = out["state"]
    # Snapshots are exported to [ux; uy]; the state stays interleaved.
    snap = out["snapshots"][-1]
    assert torch.equal(snap.u, production.export_u(st.u)) and torch.equal(snap.p, st.p)
    # The same config in f64 (JAX): f32 rounding only; 1e-3 is the solver's
    # drag/lift gate.
    s, u, p, d, l = jax_runs["block"]
    assert abs(out["snap_drags"][-1] / d[-1] - 1) < 1e-3
    assert rel(snap.u.double().numpy(), s.export_u(jnp.asarray(u))) < 1e-3


def test_chunks_are_bit_identical_and_warm_start_carries(meshes, production):
    """The port's steps are a Python loop, so cg_chunk is accepted and has no
    effect; the chunks that remain are the caller's.  Two evolve calls (13 +
    17 steps) against one of 30: the PCG warm start carries across calls,
    so the same launches run in the same order and the results are
    bit-equal; initial_state() resets the warm start, so the second
    trajectory starts as the first did."""
    sb, db, lb = production.evolve(production.initial_state(), 30)
    st = production.initial_state()
    st, d1, l1 = production.evolve(st, 13)
    st, d2, l2 = production.evolve(st, 17)
    assert torch.equal(torch.cat([d1, d2]), db) and torch.equal(torch.cat([l1, l2]), lb)
    assert torch.equal(st.u, sb.u) and torch.equal(st.p, sb.p)
    production.reset_warm_start()
    assert not production._cg_ustar.any()


def test_bf16_banded_and_guards(meshes):
    t = IPCSSolver(meshes[1], IPCSConfig(**{**PRODUCTION, "cg_banded_dtype": "bf16"}),
                   device="cpu")
    assert t.dev.A1bc.blocks.dtype == torch.bfloat16
    st, d, l = t.evolve(t.initial_state(), 5)
    assert st.u.dtype == torch.float32 and torch.isfinite(d).all()
    with pytest.raises(ValueError, match="bf16"):
        IPCSSolver(meshes[1], IPCSConfig(precision="f64", method="cg",
                                         cg_banded_dtype="bf16"), device="cpu")
    with pytest.raises(ValueError, match="cg"):
        IPCSSolver(meshes[1], IPCSConfig(precision="mixed", method="cg"), device="cpu")


def test_bf16_banded_products_and_step_match_jax(meshes):
    """cg_banded_dtype='bf16' from JAX's operators carried across (R = 128,
    plain layout).  JAX's banded_matmat rounds x and each product to bf16
    before its f32 sum (meshdqn_tpu/ops/banded.py:241); the port's plain
    version does the same, so every banded product agrees to f32 rounding
    of the sum (gap_tolerance of the window; keeping x in f32 misses by
    2.3e-3 on A1bc).  One step from a common state (after 5 JAX steps)
    agrees to 1e-2 in u* and u: rounding x to bf16 is discontinuous, so
    inputs that differ by f32 rounding round to bf16 values 2^-8 apart now
    and then, and six PCG iterations spread that (measured 3e-3; the
    pressure, which bf16 operators leave ~40% noisy in either package, is
    not compared)."""
    import jax

    import meshdqn_tpu.ops.banded as jbanded
    from meshdqn_tpu.solver.ipcs import FlowState as JaxState
    from meshdqn_tpu.solver.ipcs import ipcs_step_cg_banded as jax_step
    from meshdqn_tpu_torch.ops import matvec as mv
    from meshdqn_tpu_torch.solver import ipcs_step_cg_banded

    build = jbanded.BandedMatrix.from_scipy.__func__
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbanded.BandedMatrix, "from_scipy",
                   classmethod(lambda cls, A, **kw: build(cls, A, R=128, **kw)))
        s = js.IPCSSolver(meshes[0], js.IPCSConfig(**PRODUCTION, cg_banded_dtype="bf16"))
    dev = cg_operators_from_numpy(jax_leaves(s.dev), "cpu", torch.float32)
    rng = np.random.default_rng(0)
    banded = {k: v for k, v in dev._asdict().items() if isinstance(v, BandedMatrix)}
    assert len(banded) == 7
    for name, bm in banded.items():
        assert bm.blocks.dtype == torch.bfloat16 and not bm.aligned128, name
        for m in (1, 2):
            X = rng.standard_normal((bm.shape[1], m)).astype(np.float32)
            want = np.asarray(getattr(s.dev, name).matmat(jnp.asarray(X)))
            got = bm.matmat(torch.tensor(X)).numpy()
            assert mv.relative_gap(torch.tensor(got), torch.tensor(want)) <= \
                mv.gap_tolerance(bm.blocks.shape[2]), (name, m)
    st, _, _ = s.evolve(s.initial_state(), 5)
    u0, p0, w0 = np.asarray(st.u), np.asarray(st.p), np.asarray(s._cg_ustar)
    jn, jus, _ = jax.jit(lambda d, x, w: jax_step(d, x, w, *ITERS))(
        s.dev, JaxState(jnp.asarray(u0), jnp.asarray(p0)), jnp.asarray(w0))
    tn, tus, (td, _) = ipcs_step_cg_banded(
        dev, FlowState(torch.tensor(u0), torch.tensor(p0)), torch.tensor(w0), *ITERS)
    assert rel(tus.numpy(), np.asarray(jus)) < 1e-2
    assert rel(tn.u.numpy(), np.asarray(jn.u)) < 1e-2
    assert torch.isfinite(td)


def test_cg_needs_the_card_unless_told(meshes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IPCSSolver(meshes[1], IPCSConfig(**PRODUCTION))


def test_bandwidth_guard_falls_back_to_ell(meshes, monkeypatch):
    """A span past max(512, n/4) / 2 takes the ELL layout, as in JAX."""
    import meshdqn_tpu_torch.solver.ipcs as tipcs

    monkeypatch.setattr(tipcs, "permute_interleave_u",
                        lambda ns, rank: np.random.default_rng(0).permutation(2 * ns))
    t = IPCSSolver(meshes[1], IPCSConfig(precision="f32", method="cg"), device="cpu")
    assert isinstance(t.dev, CGOperators)


# --------------------------------------------------------------------------
# The finest meshes, carried as .npz
# --------------------------------------------------------------------------

ORACLE_CSV = REPO / "docs" / "examples" / "gen_finest_f64cg_oracle.csv"


@pytest.mark.parametrize("airfoil,vertices", [("ys930", 3796), ("ah93w145", 3301)])
def test_npz_meshes_equal_the_tracked_files(airfoil, vertices):
    from meshdqn_tpu.mesh import read_xdmf as jax_read_xdmf

    xdmf = REPO / "docs" / "examples" / "meshes" / f"{airfoil}_0.05000_gen.xdmf"
    mesh, sha8 = load_npz(DATA_DIR / f"{airfoil}_0.05000_gen.npz")
    assert mesh.num_vertices == vertices
    for ref in (read_xdmf(str(xdmf)), jax_read_xdmf(str(xdmf))):
        np.testing.assert_array_equal(mesh.coords, ref.coords)
        np.testing.assert_array_equal(mesh.cells, ref.cells)
    h5 = xdmf.with_suffix(".h5")
    assert sha8 == hashlib.sha256(h5.read_bytes()).hexdigest()[:8]
    with open(ORACLE_CSV) as f:
        rows = [r for r in csv.DictReader(f) if r["MESH_SHA8"] == sha8]
    assert rows and all(r["AIRFOIL"] == airfoil for r in rows)
    assert int(rows[0]["NUM_COORDS"]) == vertices


def test_xdmf_to_npz_entry_point(tmp_path):
    src = REPO / "docs" / "examples" / "meshes" / "ah93w145_0.05000_gen.xdmf"
    dst = tmp_path / "m.npz"
    subprocess.run([sys.executable, "-m", "meshdqn_tpu_torch.mesh.xdmf", str(src),
                    str(dst)], cwd=REPO, check=True, capture_output=True, timeout=120)
    mesh, sha8 = load_npz(dst)
    ref, ref_sha8 = load_npz(DATA_DIR / "ah93w145_0.05000_gen.npz")
    assert sha8 == ref_sha8
    np.testing.assert_array_equal(mesh.coords, ref.coords)


_IMPORT_ALL = """
import importlib, pkgutil, sys
import meshdqn_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
print(sorted(n for n in sys.modules if n.split(".")[0] in ("h5py", "jax", "meshdqn_tpu")))
"""


def test_package_imports_neither_h5py_nor_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"

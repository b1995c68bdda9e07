"""The plain reference against the program on the CPU, at a small size: the
same operators, and the same short trajectory to float32 rounding."""
import numpy as np
import pytest
import torch

from conftest import ROOT

MESH = ROOT / "meshdqn_tpu_torch/data/ys930_0.30000_gen.npz"


@pytest.fixture(scope="module")
def mesh():
    with np.load(MESH) as z:
        return z["coords"], z["cells"]


def test_frozen_assembly_equals_the_programs(mesh):
    from meshdqn_tpu_torch.mesh import TriMesh, mark_boundaries
    from meshdqn_tpu_torch.fem import assemble_operators
    from meshdqn_tpu_torch.probes import drag_probe, lift_probe
    from portbench.reference.fem import Mesh, assemble

    tm = TriMesh(*mesh)
    markers = mark_boundaries(tm)
    theirs = assemble_operators(tm, markers, 1e-3, 1.0, 1e-3)
    ours = assemble(Mesh(*mesh), 1e-3)
    for name in ("M", "Kv", "S", "B", "Bn", "Kp", "G"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert abs(a - b).max() <= 1e-12 * abs(b).max(), name
    assert np.array_equal(ours.u_mask, theirs.u_bc_mask)
    assert np.array_equal(ours.p_mask, theirs.p_bc_mask)
    np.testing.assert_allclose(ours.u_vals, theirs.u_bc_values, rtol=0, atol=1e-15)
    for mine, probe in ((ours.drag, drag_probe(tm, markers, 1e-3)),
                        (ours.lift, lift_probe(tm, markers, 1e-3))):
        np.testing.assert_allclose(mine[0], probe.d_u, rtol=0, atol=1e-15)
        np.testing.assert_allclose(mine[1], probe.d_p, rtol=0, atol=1e-15)


def test_reference_tracks_the_programs_padded_f32_solve(mesh):
    """20 steps from a perturbed rest: the program's fused f32 solve (its
    plain versions on the CPU, padded as the sweep pads) within float32
    rounding of the float64 reference, and the TF32 control far outside."""
    from meshdqn_tpu_torch.mesh import TriMesh
    from meshdqn_tpu_torch.solver import IPCSConfig, IPCSSolver
    from portbench import check
    from portbench.reference.ipcs import ReferenceFlow

    torch.manual_seed(0)
    solver = IPCSSolver(TriMesh(*mesh), IPCSConfig(precision="f32", fused=True,
                                                   pad_quantum=768), device="cpu")
    ref = ReferenceFlow(*mesh, mu=1e-3, rho=1.0, dt=1e-3, device="cpu")
    ctl = ReferenceFlow(*mesh, mu=1e-3, rho=1.0, dt=1e-3, device="cpu",
                        precision="tf32")
    u0 = 0.01 * np.random.default_rng(3).standard_normal(2 * ref.ns)
    state = solver.initial_state()._replace(
        u=torch.as_tensor(check.embed_u(u0, solver.ndofs_u), dtype=torch.float32))
    res = solver.solve(20, 10, state=state)
    program = (res["drags"].numpy(), res["lifts"].numpy(), res["state"].u.numpy(),
               res["state"].p.numpy())
    exact = ref.solve(u0, 20)
    good = check.gaps(program, exact)
    bad = check.gaps(ctl.solve(u0, 20), exact)
    assert good["drag_gap"] < 1e-5 and good["lift_gap"] < 1e-3 and good["state_gap"] < 1e-2
    assert all(bad[k] > 3 * good[k] for k in check.NUMBERS)


def test_tf32_rounds_to_ten_mantissa_bits_to_nearest_even():
    from portbench.reference.ipcs import to_tf32

    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one, one + ulp / 2, one + 1.5 * ulp, one + 0.75 * ulp,
                      -(one + 0.75 * ulp), 3.0e-3], dtype=torch.float32)
    y = to_tf32(x)
    assert y[:5].tolist() == [one, one, one + 2 * ulp, one + ulp, -(one + ulp)]
    assert abs(y[5].item() / 3.0e-3 - 1) <= 2.0 ** -11

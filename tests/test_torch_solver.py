"""The port's solver end to end on the CPU: the f64 fused step on the ys930
pack mesh against the cached 100-step f64 run, the public f32 entry point,
pad_quantum, and the refusal to run on the CPU unasked."""
import numpy as np
import pytest
import torch

from meshdqn_tpu_torch.solver import (
    FlowState, IPCSConfig, IPCSSolver, build_fused_operators, fused_step,
)
from meshdqn_tpu_torch.solver import ipcs as ipcs_mod
from tests.torch_helpers import (
    CACHE_YS930_100, cap_threads, jax_mesh, port_mesh, rel, small_mesh_arrays,
)

cap_threads()


def run_snapshots(dev, n, every, dtype):
    state = FlowState(u=torch.zeros(dev.k1.shape[0], dtype=dtype),
                      p=torch.zeros(dev.k2.shape[0], dtype=dtype))
    snaps = []
    for i in range(n):
        state, (d, l) = fused_step(dev, state)
        if (i + 1) % every == 0:
            snaps.append((state, d.item(), l.item()))
    return snaps


def test_f64_fused_step_reproduces_the_ys930_cache():
    """tests/_cache/ys930_gt_100steps.npz is the JAX f64 (unfused) solver's
    100-step run on the ys930 pack mesh, 5 snapshots.  The port composes the
    same algebra in another order; measured agreement ~4e-12 (the pressure
    system's conditioning times f64 rounding), gate 1e-10."""
    z = np.load(CACHE_YS930_100)
    dev, *_ = build_fused_operators(port_mesh((z["coords"], z["cells"])),
                                    IPCSConfig(), device="cpu",
                                    dtype=torch.float64)
    snaps = run_snapshots(dev, 100, 20, torch.float64)
    assert len(snaps) == len(z["gt_drag"]) == 5
    for i, (s, d, l) in enumerate(snaps):
        assert abs(d / z["gt_drag"][i] - 1) < 1e-10
        assert abs(l / z["gt_lift"][i] - 1) < 1e-10
        assert rel(s.u.numpy(), z["u"][i]) < 1e-10
        assert rel(s.p.numpy(), z["p"][i]) < 1e-10


@pytest.fixture(scope="module")
def small_mesh():
    return port_mesh(small_mesh_arrays())


def test_public_f32_solve_on_cpu(small_mesh):
    s = IPCSSolver(small_mesh, IPCSConfig(precision="f32"), device="cpu")
    out = s.solve(100, save_steps=20)
    assert set(out) == {"state", "drags", "lifts", "snapshots", "snap_drags",
                        "snap_lifts"}
    assert out["drags"].shape == out["lifts"].shape == (100,)
    assert out["drags"].dtype == torch.float32
    assert len(out["snapshots"]) == 5
    assert out["snap_drags"].shape == out["snap_lifts"].shape == (5,)
    np.testing.assert_array_equal(out["snap_drags"], out["drags"][19::20].numpy())
    assert torch.isfinite(out["state"].u).all() and torch.isfinite(out["state"].p).all()
    assert out["state"].u.shape == (s.ndofs_u,)
    # Continuing from a snapshot is the same as never stopping.
    s2, d2, _ = s.evolve(out["snapshots"][3], 20)
    assert torch.equal(s2.u, out["state"].u) and torch.equal(d2, out["drags"][80:])
    # Against the JAX f64 solver on the same mesh: f32 rounding moves the
    # drag after 100 steps by ~1e-4 (7e-5 measured), gate 1e-3.
    from meshdqn_tpu.solver import IPCSConfig as JaxConfig
    from meshdqn_tpu.solver import IPCSSolver as JaxSolver

    js = JaxSolver(jax_mesh(small_mesh_arrays()), JaxConfig(precision="f64"))
    _, jd, _ = js.evolve(js.initial_state(), 100)
    assert abs(out["snap_drags"][-1] / float(jd[-1]) - 1) < 1e-3


def test_pad_quantum_is_exact(small_mesh):
    """Zero-embedding into pad_quantum buckets changes nothing but the
    layout: the pad dofs stay 0 and the f64 trajectories agree to rounding
    (LU pivots and sums in other orders; the pressure system's conditioning
    lifts that to ~4e-12 in p after 20 steps, gate 1e-10)."""
    base, nu, npp, pad = build_fused_operators(
        small_mesh, IPCSConfig(), device="cpu", dtype=torch.float64)
    padded, nuq, nppq, pad = build_fused_operators(
        small_mesh, IPCSConfig(pad_quantum=128), device="cpu",
        dtype=torch.float64)
    ns, nsq, np_, npq = pad
    assert nuq == 2 * nsq and nsq % 128 == 0 and npq % 32 == 0
    assert padded.conv.cell_dofs.shape[0] % 256 == 0
    (a, da, la), = run_snapshots(base, 20, 20, torch.float64)
    (b, db, lb), = run_snapshots(padded, 20, 20, torch.float64)
    u = b.u.numpy()
    assert np.all(u[ns:nsq] == 0) and np.all(u[nsq + ns:] == 0)
    assert np.all(b.p.numpy()[np_:] == 0)
    assert rel(np.concatenate([u[:ns], u[nsq:nsq + ns]]), a.u.numpy()) < 1e-10
    assert rel(b.p.numpy()[:np_], a.p.numpy()) < 1e-10
    assert abs(db / da - 1) < 1e-10 and abs(lb / la - 1) < 1e-10


def test_solver_unpads(small_mesh):
    s = IPCSSolver(small_mesh, IPCSConfig(precision="f32", pad_quantum=128),
                   device="cpu")
    st, d, _ = s.evolve(s.initial_state(), 3)
    ns, nsq, np_, _ = s._pad
    assert s.unpad_u(st.u).shape == (2 * ns,) and s.unpad_p(st.p).shape == (np_,)
    assert torch.isfinite(d).all()


def test_no_silent_cpu(small_mesh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IPCSSolver(small_mesh, IPCSConfig(precision="f32"))
    with pytest.raises(RuntimeError):
        ipcs_mod.resolve_device(None)


@pytest.mark.parametrize("overrides", [
    {"precision": "f64"}, {"precision": "mixed"}, {"precision": "df32"},
    {"precision": "f32", "method": "cg"}, {"precision": "f32", "fused": False},
])
def test_unported_paths_raise(small_mesh, overrides):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        IPCSSolver(small_mesh, IPCSConfig(**overrides), device="cpu")


def test_config_loads_the_repo_yaml_flow_keys():
    """Every flow key the JAX IPCSConfig takes is a field here with the same
    default, so configs/*.yaml values load unchanged."""
    import dataclasses

    from meshdqn_tpu.solver import IPCSConfig as JaxConfig

    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(IPCSConfig)}
    assert port_fields == jax_fields

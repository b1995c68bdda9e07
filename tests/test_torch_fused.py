"""The port's fused solver against the JAX package's, on the small airfoil
mesh: operator composition, the f32 step from identical operators, and the
f64 step against the JAX f64 (unfused) solver."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdqn_tpu.solver import IPCSConfig as JaxConfig
from meshdqn_tpu.solver import IPCSSolver as JaxSolver
from meshdqn_tpu.solver.ipcs import FlowState as JaxState
from meshdqn_tpu.solver.ipcs import evolve_fused_n
from meshdqn_tpu_torch.convert import CONV_FIELDS, fused_operators_from_numpy
from meshdqn_tpu_torch.solver import (
    FlowState, FusedOperators, IPCSConfig, build_fused_operators, fused_step,
)
from tests.torch_helpers import cap_threads, jax_mesh, port_mesh, rel, small_mesh_arrays

cap_threads()

STEPS = 100


@pytest.fixture(scope="module")
def jax_f32():
    """The JAX f32 fused solver; on the CPU it composes its operators with
    build_fused_host_f64 (exact f64, then cast)."""
    return JaxSolver(jax_mesh(small_mesh_arrays()), JaxConfig(precision="f32"))


def jax_operator_arrays(dev):
    arrays = {f: np.asarray(getattr(dev, f)) for f in dev._fields if f != "conv"}
    conv = {f: getattr(dev.conv, f) if f == "ndofs" else np.asarray(getattr(dev.conv, f))
            for f in CONV_FIELDS}
    return arrays, conv


def run(dev, n, dtype):
    state = FlowState(u=torch.zeros(dev.k1.shape[0], dtype=dtype),
                      p=torch.zeros(dev.k2.shape[0], dtype=dtype))
    drags, lifts = [], []
    for _ in range(n):
        state, (d, l) = fused_step(dev, state)
        drags.append(d.item())
        lifts.append(l.item())
    return state, np.array(drags), np.array(lifts)


def test_composition_matches_host_f64_within_an_ulp(jax_f32):
    """compose_fused (LU solves) against build_fused_host_f64 (inverse times
    matrix), both in f64 then cast to f32.  Each f32 entry is the rounding of
    the same f64 value up to f64 composition error, so the two agree within
    one f32 ulp, plus an absolute floor of 1e-12 * max|F| for entries that
    vanish in exact arithmetic (e.g. off the identity in F2p and F3s): those
    come out as f64 solve noise of order cond(A) * 2^-53 * max|F| in either
    method and share no bits."""
    port, *_ = build_fused_operators(port_mesh(small_mesh_arrays()),
                                     IPCSConfig(precision="f32"), device="cpu")
    jdev = jax_f32.dev
    for name in FusedOperators._fields:
        if name == "conv":
            continue
        a = getattr(port, name).numpy()
        b = np.asarray(getattr(jdev, name))
        assert a.dtype == np.float32 and a.shape == b.shape, name
        ulp = np.spacing(np.abs(b)).astype(np.float64)
        floor = 1e-12 * np.abs(b).max()
        err = np.abs(a.astype(np.float64) - b)
        assert np.all(err <= ulp + floor), (name, float((err - ulp).max()))


def test_f32_steps_from_jax_operators_are_as_accurate_as_jax(jax_f32):
    """The JAX solver's composed operators, carried across, drive 100 f32
    steps of each package.  Two f32 evaluations of the same step differ by
    their rounding alone, and that is large here: the pressure is a small
    difference of F2u u* terms ~1e3 larger, so one f32 step from a common
    state already moves p by ~1.5e-3 relative in either package (u by ~5e-5).
    So each f32 trajectory is measured against the exact evaluation of the
    same operators (the port's step in f64 on them, which matches JAX's f64
    solver to ~1e-12 below), and the port's deviation must stay within 2x of
    JAX's own: a port that added error of its own (a dropped term, reduced
    precision somewhere) would exceed it."""
    arrays, conv = jax_operator_arrays(jax_f32.dev)
    dev32 = fused_operators_from_numpy(arrays, conv, "cpu", torch.float32)
    dev64 = fused_operators_from_numpy(arrays, conv, "cpu", torch.float64)
    s32, d32, l32 = run(dev32, STEPS, torch.float32)
    s64, d64, l64 = run(dev64, STEPS, torch.float64)
    js, (jd, jl) = evolve_fused_n(jax_f32.dev, jax_f32.initial_state(), STEPS)
    jd, jl = np.asarray(jd, np.float64), np.asarray(jl, np.float64)

    assert rel(s32.u.numpy(), s64.u.numpy()) <= 2 * rel(js.u, s64.u.numpy())
    assert rel(s32.p.numpy(), s64.p.numpy()) <= 2 * rel(js.p, s64.p.numpy())
    assert np.abs(d32 - d64).max() <= 2 * np.abs(jd - d64).max()
    assert np.abs(l32 - l64).max() <= 2 * np.abs(jl - l64).max()
    # And the two f32 trajectories end close together in absolute terms.
    assert rel(s32.u.numpy(), js.u) < 1e-3
    assert abs(d32[-1] / jd[-1] - 1) < 1e-3


def test_one_f32_step_matches_jax_within_rounding(jax_f32):
    """One step from a common developed state: the port and JAX differ by
    f32 rounding of the same operators only; 5e-4 relative on u is 10x the
    ~5e-5 rounding spread measured between the two packages."""
    arrays, conv = jax_operator_arrays(jax_f32.dev)
    dev32 = fused_operators_from_numpy(arrays, conv, "cpu", torch.float32)
    dev64 = fused_operators_from_numpy(arrays, conv, "cpu", torch.float64)
    s64, _, _ = run(dev64, 50, torch.float64)
    u0, p0 = s64.u.float(), s64.p.float()
    s1, _ = fused_step(dev32, FlowState(u0, p0))
    js1, _ = evolve_fused_n(jax_f32.dev, JaxState(jnp.asarray(u0.numpy()),
                                                  jnp.asarray(p0.numpy())), 1)
    assert rel(s1.u.numpy(), js1.u) < 5e-4


def test_f64_steps_match_jax_f64_solver():
    """The port's fused step in f64 against the JAX f64 solver, which is
    unfused (inverse applies plus sparse operators): the same algebra
    composed in a different order, so the difference is f64 rounding
    amplified by the systems' conditioning, measured ~1e-12; gate 1e-9."""
    arrays = small_mesh_arrays()
    dev64, *_ = build_fused_operators(port_mesh(arrays), IPCSConfig(),
                                      device="cpu", dtype=torch.float64)
    s, d, l = run(dev64, STEPS, torch.float64)
    js = JaxSolver(jax_mesh(arrays), JaxConfig(precision="f64"))
    jst, jd, jl = js.evolve(js.initial_state(), STEPS)
    # Norm-relative over the trajectory: lift crosses zero early on.
    assert rel(d, jd) < 1e-9
    assert rel(l, jl) < 1e-9
    assert rel(s.u.numpy(), jst.u) < 1e-9
    assert rel(s.p.numpy(), jst.p) < 1e-9

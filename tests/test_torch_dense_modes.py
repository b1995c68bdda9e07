"""The port's unfused dense step ('f64', 'mixed', f32 with fused=False)
against the JAX package, on the CPU.

Two f32 evaluations of one step differ by their rounding alone, and one
step's rounding is large here: the pressure is a small difference of terms
~1e3 larger.  A single trajectory's deviation from the exact evaluation is
therefore one draw of a random walk, dominated by whichever step drew the
largest rounding: over 100 steps of the small mesh the port's and JAX's
per-metric deviations differ by factors of 0.1 to 8 either way, metric by
metric (the largest drag deviation falls in step 2, the impulsive start).
So the 2x rule of tests/test_torch_fused.py is applied to the ensemble of
one-step deviations: from each of 100 states of the exact trajectory, one
f32 step of each package against one exact step, their RMS over the 100
states.  A port that added error of its own (a dropped term, a cast in the
wrong place, reduced precision) exceeds it; the trajectories themselves are
held to the solver's 1e-3 gate.  "Exact" is the port's step in f64 on the
same operators, widened.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdqn_tpu.solver import IPCSConfig as JaxConfig
from meshdqn_tpu.solver import IPCSSolver as JaxSolver
from meshdqn_tpu.solver.ipcs import FlowState as JaxState
from meshdqn_tpu.solver.ipcs import evolve_n as jax_evolve_n
from meshdqn_tpu.solver.ipcs import ipcs_step as jax_ipcs_step
from meshdqn_tpu_torch.convert import device_operators_from_numpy
from meshdqn_tpu_torch.ops.sparse import EllMatrix
from meshdqn_tpu_torch.solver import (
    DeviceOperators, FlowState, IPCSConfig, IPCSSolver, build_device_operators,
    evolve_n, ipcs_step,
)
from tests.torch_helpers import (
    CACHE_YS930_100, cap_threads, jax_leaves, jax_mesh, port_mesh, rel,
    small_mesh_arrays,
)

cap_threads()

STEPS = 100
REFINE = 2  # IPCSConfig().refine_iters


@pytest.fixture(scope="module")
def small():
    arrays = small_mesh_arrays()
    return jax_mesh(arrays), port_mesh(arrays)


def test_f64_unfused_solver_reproduces_the_ys930_cache():
    """IPCSConfig() is 'f64' with the unfused step, the JAX package's
    default and its ground-truth solver.  tests/_cache/ys930_gt_100steps.npz
    is that JAX solver's 100-step run on the ys930 pack mesh, 5 snapshots.
    The same algebra, its inverses built by another LAPACK: measured
    agreement ~1e-13; gate 1e-10, as the fused f64 test has it."""
    z = np.load(CACHE_YS930_100)
    s = IPCSSolver(port_mesh((z["coords"], z["cells"])), IPCSConfig(), device="cpu")
    assert not s.fused and isinstance(s.dev, DeviceOperators)
    assert s.dev.A1inv.dtype == s.work_dtype == s.pressure_dtype == torch.float64
    out = s.solve(STEPS, save_steps=20)
    assert len(out["snapshots"]) == len(z["gt_drag"]) == 5
    for i, snap in enumerate(out["snapshots"]):
        assert abs(out["snap_drags"][i] / z["gt_drag"][i] - 1) < 1e-10
        assert abs(out["snap_lifts"][i] / z["gt_lift"][i] - 1) < 1e-10
        assert rel(snap.u.numpy(), z["u"][i]) < 1e-10
        assert rel(snap.p.numpy(), z["p"][i]) < 1e-10


@pytest.fixture(scope="module")
def jax_unfused(small):
    return {prec: JaxSolver(small[0], JaxConfig(precision=prec, fused=False))
            for prec in ("f64", "f32", "mixed")}


@pytest.mark.parametrize("prec", ["f64", "f32", "mixed"])
def test_device_operators_match_jax(small, jax_unfused, prec):
    """build_device_operators against the JAX solver's DeviceOperators:
    the same fields in the same dtypes; sparse operators and vectors equal;
    the inverses, built in f64 by another LAPACK, within one ulp of their
    dtype plus 1e-12 of the largest entry (entries that vanish in exact
    arithmetic come out as f64 solve noise in either)."""
    port = build_device_operators(small[1], IPCSConfig(precision=prec, fused=False),
                                  device="cpu")
    ref = jax_unfused[prec].dev
    for name in DeviceOperators._fields:
        a, b = getattr(port, name), getattr(ref, name)
        if b is None:
            assert a is None, name
        elif name == "conv":
            assert a.phi.dtype == (torch.float64 if prec == "f64" else torch.float32)
        elif isinstance(a, EllMatrix):
            assert a.shape == tuple(b.shape), name
            np.testing.assert_array_equal(a.cols.numpy(), np.asarray(b.cols))
            np.testing.assert_array_equal(a.vals.numpy(), np.asarray(b.vals))
        elif name in ("A1inv", "A2inv", "A3inv_s"):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            err = np.abs(a.astype(np.float64) - b)
            floor = 1e-12 * np.abs(b).max()
            assert np.all(err <= np.spacing(np.abs(b)).astype(np.float64) + floor), name
        else:
            assert a.numpy().dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _widened(leaves):
    """The leaves with every float array in f64: the exact evaluation's
    operators."""
    def widen(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: np.asarray(x, np.float64) if k in ("vals", "phi", "gphys", "wdet")
                    else x for k, x in v.items()}
        return np.asarray(v, np.float64)

    return {name: widen(v) for name, v in leaves.items()}


@pytest.fixture(scope="module")
def carried(jax_unfused):
    """Per precision: JAX's solver, its operators carried across, and the
    same widened to f64."""
    out = {}
    for prec in ("f32", "mixed"):
        leaves = jax_leaves(jax_unfused[prec].dev)
        out[prec] = (jax_unfused[prec], device_operators_from_numpy(leaves, "cpu"),
                     device_operators_from_numpy(_widened(leaves), "cpu"))
    return out


def _zero(dev, u_dtype, p_dtype):
    return FlowState(u=torch.zeros(dev.t1.shape[0], dtype=u_dtype),
                     p=torch.zeros(dev.t2.shape[0], dtype=p_dtype))


@pytest.mark.parametrize("prec", ["f32", "mixed"])
def test_unfused_trajectory_holds_dtypes_and_the_gate(carried, prec):
    """100 steps of the port and of JAX from the same operators: 'mixed'
    keeps u in f32 and p in f64 through every step, its drag and lift in
    f64; both trajectories end within 1e-3 of the exact evaluation."""
    js, dev, dev64 = carried[prec]
    pdt = torch.float64 if prec == "mixed" else torch.float32
    state = _zero(dev, torch.float32, pdt)
    drags = []
    for _ in range(STEPS):
        state, (d, _) = ipcs_step(dev, state, prec, REFINE)
        assert state.u.dtype == torch.float32 and state.p.dtype == pdt
        drags.append(d)
    assert drags[-1].dtype == pdt
    s64, (d64, l64) = evolve_n(dev64, _zero(dev, torch.float64, torch.float64),
                               STEPS, prec, REFINE)
    jst, (jd, _) = jax_evolve_n(js.dev, js.initial_state(), STEPS, prec, REFINE)
    assert np.asarray(jst.p).dtype == (np.float64 if prec == "mixed" else np.float32)
    for u, d in ((state.u.numpy(), drags[-1].item()), (np.asarray(jst.u), float(jd[-1]))):
        assert rel(u, s64.u.numpy()) < 1e-3
        assert abs(d / d64[-1].item() - 1) < 1e-3


@pytest.mark.parametrize("prec", ["f32", "mixed"])
def test_unfused_steps_are_as_accurate_as_jax(carried, prec):
    """The 2x rule over the ensemble of one-step deviations (module note):
    from each of the exact trajectory's first 100 states, rounded to the
    step's dtypes, one step of the port, one of JAX and one exact step; the
    RMS over the states of each package's deviation in u, p, drag and
    lift.  Measured port/JAX ratios: 0.72-1.09."""
    js, dev, dev64 = carried[prec]
    pdt = torch.float64 if prec == "mixed" else torch.float32
    step = jax.jit(lambda d, s: jax_ipcs_step(d, s, prec, REFINE))
    exact = _zero(dev, torch.float64, torch.float64)
    dev_port, dev_jax = [], []
    for _ in range(STEPS):
        exact, _ = ipcs_step(dev64, exact, prec, REFINE)
        start = FlowState(u=exact.u.float(), p=exact.p.to(pdt))
        ref, (rd, rl) = ipcs_step(dev64, FlowState(start.u.double(), start.p.double()),
                                  prec, REFINE)
        ours, (d, l) = ipcs_step(dev, start, prec, REFINE)
        theirs, (jd, jl) = step(js.dev, JaxState(jnp.asarray(start.u.numpy()),
                                                 jnp.asarray(start.p.numpy())))
        for out, (u, p, dd, ll) in ((dev_port, (ours.u.numpy(), ours.p.numpy(), d, l)),
                                    (dev_jax, (theirs.u, theirs.p, jd, jl))):
            out.append((rel(u, ref.u.numpy()), rel(p, ref.p.numpy()),
                        abs(float(dd) - rd.item()), abs(float(ll) - rl.item())))
    rms = lambda rows: np.sqrt(np.mean(np.square(rows), axis=0))
    port, theirs = rms(dev_port), rms(dev_jax)
    assert np.all(port > 0), port  # the f32 step really rounds
    assert np.all(port <= 2 * theirs), (port, theirs)

"""The port's IPCSSolver routes every precision and `fused` setting as the
JAX solver does, and exposes the surface the environment reads; on the
CPU, on the small airfoil mesh."""
import numpy as np
import pytest

from meshdqn_tpu.solver import IPCSConfig as JaxConfig
from meshdqn_tpu.solver import IPCSSolver as JaxSolver
from meshdqn_tpu_torch.solver import IPCSConfig, IPCSSolver
from tests.torch_helpers import cap_threads, jax_mesh, port_mesh, small_mesh_arrays

cap_threads()


@pytest.fixture(scope="module")
def small():
    arrays = small_mesh_arrays()
    return jax_mesh(arrays), port_mesh(arrays)


COMBOS = [(p, f) for p in ("f64", "f32", "mixed", "df32") for f in (None, True, False)]


def _jax_outcome(mesh, prec, fused):
    """(solver, state after 2 steps, drags) or the exception the JAX package
    raises, at construction or at the first evolve."""
    try:
        s = JaxSolver(mesh, JaxConfig(precision=prec, fused=fused))
        st, d, _ = s.evolve(s.initial_state(), 2)
    except (ValueError, TypeError) as e:
        return e
    return s, st, np.asarray(d, np.float64)


@pytest.mark.parametrize("prec,fused", COMBOS)
def test_routing_matches_jax(small, prec, fused):
    """Where JAX runs a combination the port runs it the same way (fused or
    not, split limbs or not, the same dtypes) and its first two drags agree
    (1e-12 in f64, 1e-4 in f32 rounding); where JAX raises, at construction
    or at its first evolve ('df32' unfused: its scan refuses u promoted to
    f64), the port raises ValueError when made and says why."""
    jax_out = _jax_outcome(small[0], prec, fused)
    cfg = IPCSConfig(precision=prec, fused=fused)
    if isinstance(jax_out, Exception):
        with pytest.raises(ValueError, match="fused"):
            IPCSSolver(small[1], cfg, device="cpu")
        return
    js, jst, jd = jax_out
    s = IPCSSolver(small[1], cfg, device="cpu")
    assert s.fused == js.fused
    assert (s.dev_lo is None) == (js.dev_lo is None)
    assert str(s.work_dtype).split(".")[1] == np.dtype(js.work_dtype).name
    assert str(s.pressure_dtype).split(".")[1] == np.dtype(js.pressure_dtype).name
    st, d, _ = s.evolve(s.initial_state(), 2)
    assert st.u.dtype == s.work_dtype and st.p.dtype == s.pressure_dtype
    assert str(st.p.dtype).split(".")[1] == np.asarray(jst.p).dtype.name
    tol = 1e-12 if prec == "f64" else 1e-4
    assert np.all(np.abs(d.double().numpy() / jd - 1) < tol), (d, jd)


def test_solver_exposes_the_surface_the_env_reads(small):
    """markers, operators, the drag and lift probes and removable equal the
    JAX solver's."""
    js = JaxSolver(small[0], JaxConfig(precision="f32"))
    s = IPCSSolver(small[1], IPCSConfig(precision="f32"), device="cpu")
    np.testing.assert_array_equal(s.markers.markers, js.markers.markers)
    np.testing.assert_array_equal(s.removable, js.removable)
    assert s.operators.V.ndofs == js.operators.V.ndofs == s.ndofs_u
    assert (s.operators.A1 != js.operators.A1).nnz == 0
    for probe, ref in ((s.drag, js.drag), (s.lift, js.lift)):
        np.testing.assert_array_equal(probe.d_u, ref.d_u)
        np.testing.assert_array_equal(probe.d_p, ref.d_p)

"""The port's 'df32' step (split f32 high and bf16 low limb operators)
against the JAX package, on the CPU, on the small airfoil mesh: the limbs,
the plain versions of the matvec kernel's split form against the JAX
step's expression, and 100 steps from limbs carried across."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from meshdqn_tpu.solver import IPCSConfig as JaxConfig
from meshdqn_tpu.solver import IPCSSolver as JaxSolver
from meshdqn_tpu.solver.fused import HIGH
from meshdqn_tpu.solver.ipcs import evolve_fused_df32_n as jax_evolve_df32
from meshdqn_tpu_torch.convert import (CONV_FIELDS, fused_operators_from_numpy,
                                       split_low_from_numpy)
from meshdqn_tpu_torch.ops import matvec as mv
from meshdqn_tpu_torch.solver import (
    FlowState, IPCSConfig, IPCSSolver, SplitLow, build_fused_operators,
    evolve_fused_df32_n, evolve_fused_n, fused_step, fused_step_df32,
)
from tests.torch_helpers import (cap_threads, jax_leaves, jax_mesh, port_mesh, rel,
                                 small_mesh_arrays)

cap_threads()

STEPS = 100
MATS = ("F1u", "F1p", "A1Z", "F2p", "F2u", "F3s", "F3p")
VECS = ("k1", "k2", "k3")


@pytest.fixture(scope="module")
def jax_df32():
    """The JAX df32 solver; on the CPU it composes its operators with
    build_fused_host_f64(split=True)."""
    return JaxSolver(jax_mesh(small_mesh_arrays()), JaxConfig(precision="df32"))


@pytest.fixture(scope="module")
def port_split():
    (hi, lo), *_ = build_fused_operators(port_mesh(small_mesh_arrays()),
                                         IPCSConfig(precision="df32"), device="cpu",
                                         split=True)
    return hi, lo


def test_split_limbs_match_build_fused_host_f64(port_split, jax_df32):
    """The port's limbs against the JAX package's: the high limbs are the
    port's f32 build; |lo| <= 1.2 2^-24 |hi| (tests/test_solver.py:172-197);
    matrix limbs bf16, vector limbs f32.  Against JAX's: the two f64
    compositions agree to f64 rounding, 1e-12 of the largest entry as in
    tests/test_torch_fused.py (the entries that vanish in exact arithmetic,
    most of F2p and F3s, are f64 solve noise in either); so the high limbs
    are within one f32 ulp plus that floor, and where they are equal the
    low limbs are within one bf16 ulp plus it."""
    hi, lo = port_split
    f32, *_ = build_fused_operators(port_mesh(small_mesh_arrays()),
                                    IPCSConfig(precision="f32"), device="cpu")
    jhi, jlo = jax_df32.dev, jax_df32.dev_lo
    for name in SplitLow._fields:
        h, l = getattr(hi, name), getattr(lo, name)
        assert torch.equal(h, getattr(f32, name)), name
        assert l.dtype == (torch.float32 if name in VECS else torch.bfloat16), name
        l64, h64 = l.double().numpy(), h.double().numpy()
        assert np.all(np.abs(l64) <= 1.2 * 2.0**-24 * np.abs(h64)), name
        jh = np.asarray(getattr(jhi, name))
        jl = np.asarray(getattr(jlo, name)).astype(np.float64)
        floor = 1e-12 * np.abs(jh).max()
        assert np.all(np.abs(h64 - jh) <= np.spacing(np.abs(jh)) + floor), name
        same = h.numpy() == jh
        ulp = (np.abs(jl) * 2.0**-7 if name in MATS
               else np.spacing(np.abs(jl).astype(np.float32)))
        assert np.all(np.abs(l64 - jl)[same] <= ulp[same] + floor), name


def _jax_mml(m_lo, x):
    return jnp.matmul(m_lo, x.astype(jnp.bfloat16), preferred_element_type=jnp.float32)


def _jax_df32_stages(t):
    """The three stages of meshdqn_tpu/solver/fused.py:fused_step_df32, as
    written there, on the operands `t` (numpy arrays, bf16 low limbs)."""
    j = {k: jnp.asarray(v) for k, v in t.items()}
    u_hi = (jnp.matmul(j["F1u"], j["u"], precision=HIGH)
            + jnp.matmul(j["F1p"], j["p"], precision=HIGH)
            - j["rho"] * jnp.matmul(j["A1Z"], j["c"], precision=HIGH) + j["k1"])
    u_corr = (_jax_mml(j["L1u"], j["u"]) + _jax_mml(j["L1p"], j["p"])
              - j["rho"] * _jax_mml(j["LA1Z"], j["c"]) + j["l1"])
    u_star = u_hi + u_corr
    p_hi = (jnp.matmul(j["F2p"], j["p"], precision=HIGH)
            + jnp.matmul(j["F2u"], j["u_star"], precision=HIGH) + j["k2"])
    p_new = p_hi + (_jax_mml(j["L2p"], j["p"]) + _jax_mml(j["L2u"], j["u_star"]) + j["l2"])
    ns = t["F3s"].shape[0]
    us = j["u_star"]
    ustack = jnp.stack([us[:ns], us[ns:]], axis=1)
    y = jnp.matmul(j["F3s"], ustack, precision=HIGH)
    y = y + jnp.einsum("cnp,p->nc", j["F3p"], j["dp"], precision=HIGH)
    y_corr = jnp.matmul(j["L3s"], ustack.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
    y_corr = y_corr + jnp.einsum("cnp,p->nc", j["L3p"], j["dp"].astype(jnp.bfloat16),
                                 preferred_element_type=jnp.float32)
    y = y + y_corr
    u_new = jnp.concatenate([y[:, 0], y[:, 1]]) + j["k3"] + j["l3"]
    return {"ustar": u_star, "pressure": p_new, "velocity": u_new}


def _operands(ns, npr, seed, lo_scale):
    """Seeded f32 operands of the three stages; low limbs bf16 at lo_scale
    of the high ones' magnitude."""
    rng = np.random.default_rng(seed)
    nu = 2 * ns
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    b = lambda *shape: (lo_scale * rng.standard_normal(shape)).astype(ml_dtypes.bfloat16)
    return {"F1u": r(nu, nu), "F1p": r(nu, npr), "A1Z": r(nu, nu), "k1": r(nu),
            "rho": np.float32(0.7), "L1u": b(nu, nu), "L1p": b(nu, npr),
            "LA1Z": b(nu, nu), "l1": r(nu) * np.float32(lo_scale),
            "F2p": r(npr, npr), "F2u": r(npr, nu), "k2": r(npr), "L2p": b(npr, npr),
            "L2u": b(npr, nu), "l2": r(npr) * np.float32(lo_scale),
            "F3s": r(ns, ns), "F3p": r(2, ns, npr), "k3": r(nu), "L3s": b(ns, ns),
            "L3p": b(2, ns, npr), "l3": r(nu) * np.float32(lo_scale),
            "u": r(nu), "p": r(npr), "c": r(nu), "u_star": r(nu), "dp": r(npr)}


FORMS = {
    "ustar": (mv.step_ustar_df32_reference, ("F1u", "F1p", "A1Z", "rho", "k1", "L1u",
                                             "L1p", "LA1Z", "l1", "u", "p", "c")),
    "pressure": (mv.step_pressure_df32_reference, ("F2p", "F2u", "k2", "L2p", "L2u",
                                                   "l2", "p", "u_star")),
    "velocity": (mv.step_velocity_df32_reference, ("F3s", "F3p", "k3", "L3s", "L3p",
                                                   "l3", "u_star", "dp")),
}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.tensor(a.astype(np.float32)).bfloat16()
    return torch.tensor(a)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("ns,npr", [(40, 17), (97, 33)])
def test_plain_versions_compute_the_jax_expression(form, ns, npr):
    """step_*_df32_reference against fused_step_df32's expression in JAX on
    random operands, with low limbs as large as the high ones (at the
    solver's 2^-24 a dropped low term would hide below f32 rounding): within
    gap_tolerance of the terms summed into an output; the same with the low
    limbs dropped falls far outside it."""
    t = _operands(ns, npr, seed=ns + npr, lo_scale=1.0)
    want = np.asarray(_jax_df32_stages(t)[form], np.float64)
    plain, names = FORMS[form]
    got = plain(*(_torch(t[n]) for n in names))
    got = (got[0] if isinstance(got, tuple) else got).double().numpy()
    terms = {"ustar": 2 * (4 * ns + npr), "pressure": 2 * (npr + 2 * ns),
             "velocity": 2 * (ns + npr)}[form]
    tol = mv.gap_tolerance(terms)
    assert rel(got, want) <= tol
    if form == "pressure":  # dp = p' - p, from the same p'
        p_new, dp = plain(*(_torch(t[n]) for n in names))
        assert torch.equal(dp, p_new - _torch(t["p"]))
    zero = {n: (np.zeros_like(t[n]) if n.startswith(("L", "l")) else t[n]) for n in names}
    dropped = plain(*(_torch(zero[n]) for n in names))
    dropped = (dropped[0] if isinstance(dropped, tuple) else dropped).double().numpy()
    assert rel(dropped, want) > 1000 * tol


def test_zero_low_limbs_give_the_f32_step(port_split):
    """With every low limb zero the split step is the f32 step, value for
    value: the low sums are +0 and adding them changes nothing."""
    hi, lo = port_split
    zero = SplitLow(*(torch.zeros_like(t) for t in lo))
    state = FlowState(u=1e-2 * torch.randn(hi.k1.shape[0], generator=torch.Generator()
                                           .manual_seed(0)),
                      p=torch.zeros(hi.k2.shape[0]))
    for _ in range(3):
        a, (da, la) = fused_step_df32(hi, zero, state)
        b, (db, lb) = fused_step(hi, state)
        assert torch.equal(a.u, b.u) and torch.equal(a.p, b.p)
        assert torch.equal(da, db) and torch.equal(la, lb)
        state = a


def test_df32_steps_from_jax_limbs_are_as_accurate_as_jax(jax_df32):
    """The JAX package's limbs carried across (bf16 kept bf16) drive 100 df32
    steps of each package.  Each trajectory is measured against the exact
    evaluation of the same split operators, the port's step in f64 on
    hi + lo, and the port's deviation must stay within 2x of JAX's own
    (tests/test_torch_fused.py)."""
    jdev = jax_df32.dev
    arrays = {f: np.asarray(getattr(jdev, f)) for f in jdev._fields if f != "conv"}
    conv = {f: getattr(jdev.conv, f) if f == "ndofs" else np.asarray(getattr(jdev.conv, f))
            for f in CONV_FIELDS}
    hi = fused_operators_from_numpy(arrays, conv, "cpu", torch.float32)
    lo = split_low_from_numpy(jax_leaves(jax_df32.dev_lo), "cpu")
    for name in SplitLow._fields:
        jl = np.asarray(getattr(jax_df32.dev_lo, name))
        assert getattr(lo, name).dtype == (torch.bfloat16 if jl.dtype == ml_dtypes.bfloat16
                                           else torch.float32)
        np.testing.assert_array_equal(getattr(lo, name).float().numpy(),
                                      jl.astype(np.float32))
    exact = {k: (v.astype(np.float64) + getattr(lo, k).double().numpy()
                 if k in SplitLow._fields else v) for k, v in arrays.items()}
    dev64 = fused_operators_from_numpy(exact, conv, "cpu", torch.float64)
    zero = lambda dt: FlowState(torch.zeros(hi.k1.shape[0], dtype=dt),
                                torch.zeros(hi.k2.shape[0], dtype=dt))
    s, (d, l) = evolve_fused_df32_n(hi, lo, zero(torch.float32), STEPS)
    s64, (d64, l64) = evolve_fused_n(dev64, zero(torch.float64), STEPS)
    js, (jd, jl) = jax_evolve_df32(jdev, jax_df32.dev_lo, jax_df32.initial_state(), STEPS)
    d, l, d64, l64 = (x.double().numpy() for x in (d, l, d64, l64))
    jd, jl = np.asarray(jd, np.float64), np.asarray(jl, np.float64)
    assert rel(s.u.numpy(), s64.u.numpy()) <= 2 * rel(js.u, s64.u.numpy())
    assert rel(s.p.numpy(), s64.p.numpy()) <= 2 * rel(js.p, s64.p.numpy())
    assert np.abs(d - d64).max() <= 2 * np.abs(jd - d64).max()
    assert np.abs(l - l64).max() <= 2 * np.abs(jl - l64).max()
    assert rel(s.u.numpy(), js.u) < 1e-3 and abs(d[-1] / jd[-1] - 1) < 1e-3


def test_public_df32_solver(port_split):
    """IPCSSolver(precision='df32') takes the fused split step by default:
    its limbs are the port's split build; 20 steps, continued from a
    snapshot as if never stopped."""
    s = IPCSSolver(port_mesh(small_mesh_arrays()), IPCSConfig(precision="df32"),
                   device="cpu")
    assert s.fused and isinstance(s.dev_lo, SplitLow)
    hi, lo = port_split
    for name in SplitLow._fields:
        assert torch.equal(getattr(s.dev, name), getattr(hi, name))
        assert torch.equal(getattr(s.dev_lo, name), getattr(lo, name))
    out = s.solve(20, save_steps=10)
    assert out["drags"].dtype == torch.float32 and torch.isfinite(out["drags"]).all()
    st, d, _ = s.evolve(out["snapshots"][0], 10)
    assert torch.equal(st.u, out["state"].u) and torch.equal(d, out["drags"][10:])

"""The fused step's grouped launches (ops/matvec.py step_ustar,
step_pressure, step_velocity) on the CPU: their plain versions are the
step's torch expressions bit for bit, the default step equals the step
through single products bit for bit on the ys930 pack's operators, and the
wrappers' checks reject what the kernel does not take.  The kernel itself is
held to the composition of single launches on the card, in
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from meshdqn_tpu_torch.ops import matvec as mv
from meshdqn_tpu_torch.solver import (
    FlowState, IPCSConfig, build_fused_operators, fused_step,
)
from tests.torch_helpers import cap_threads, pack_mesh_arrays, port_mesh

cap_threads()


def _operators(ns, np_, dtype, seed=0):
    """Seeded operators and state of the fused step's shapes (Ns, Np)."""
    rng = np.random.default_rng(seed)
    nu = 2 * ns
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=dtype)
    ops = dict(F1u=t(nu, nu), F1p=t(nu, np_), A1Z=t(nu, nu), k1=t(nu), F2p=t(np_, np_),
               F2u=t(np_, nu), k2=t(np_), F3s=t(ns, ns), F3p=t(2, ns, np_), k3=t(nu),
               rho=torch.tensor(1.25, dtype=dtype))
    return ops, t(nu), t(np_), t(nu)


def _step_products_as_written(o, u_n, p_n, c):
    """solver/fused.py's step expression as it stood with seven single
    products (each m @ x on the CPU, a two-column x one column at a time, as
    the plain product takes it), written out here as the rounding spec the
    grouped kernel must follow."""
    u_star = o["F1u"] @ u_n + o["F1p"] @ p_n - o["rho"] * (o["A1Z"] @ c) + o["k1"]
    p_new = o["F2p"] @ p_n + o["F2u"] @ u_star + o["k2"]
    dp = p_new - p_n
    ns = o["F3s"].shape[0]
    ustack = torch.stack([u_star[:ns], u_star[ns:]], dim=1)
    y = torch.stack([o["F3s"] @ ustack[:, j] for j in range(2)], dim=1)
    corr = (o["F3p"].view(2 * ns, -1) @ dp).view(2, ns)
    y = y + corr.T
    u_new = torch.cat([y[:, 0], y[:, 1]]) + o["k3"]
    return u_star, p_new, dp, u_new


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ns,np_", [(37, 13), (64, 32), (5, 1)])
def test_plain_versions_are_the_step_expression(dtype, ns, np_):
    o, u, p, c = _operators(ns, np_, dtype)
    want = _step_products_as_written(o, u, p, c)
    u_star = mv.step_ustar(o["F1u"], o["F1p"], o["A1Z"], o["rho"], o["k1"], u, p, c)
    p_new, dp = mv.step_pressure(o["F2p"], o["F2u"], o["k2"], p, u_star)
    u_new = mv.step_velocity(o["F3s"], o["F3p"], o["k3"], u_star, dp)
    for got, ref in zip((u_star, p_new, dp, u_new), want):
        assert got.dtype == dtype and torch.equal(got, ref)
    # The same with every product through the single form's wrapper.
    assert torch.equal(mv.step_ustar_reference(o["F1u"], o["F1p"], o["A1Z"], o["rho"],
                                               o["k1"], u, p, c, apply=mv.matvec), want[0])


def test_cpu_tensors_take_the_plain_versions_uncounted():
    o, u, p, c = _operators(9, 4, torch.float32)
    counters = (mv.step_ustar, mv.step_pressure, mv.step_velocity, mv.matvec)
    before = [f.launches for f in counters]
    u_star = mv.step_ustar(o["F1u"], o["F1p"], o["A1Z"], o["rho"], o["k1"], u, p, c)
    _, dp = mv.step_pressure(o["F2p"], o["F2u"], o["k2"], p, u_star)
    mv.step_velocity(o["F3s"], o["F3p"], o["k3"], u_star, dp)
    assert [f.launches for f in counters] == before


@pytest.fixture(scope="module")
def ys930_f32():
    dev, nu, npr, _ = build_fused_operators(port_mesh(pack_mesh_arrays()),
                                            IPCSConfig(precision="f32"), device="cpu")
    return dev, nu, npr


def test_grouped_step_equals_single_products_over_20_steps_on_ys930(ys930_f32):
    """fused_step's default path (the grouped launches' plain versions on
    the CPU) against the step through single products, from rest and from a
    perturbed state, bit for bit at every step."""
    dev, nu, npr = ys930_f32
    g = np.random.default_rng(1)
    starts = [FlowState(u=torch.zeros(nu), p=torch.zeros(npr)),
              FlowState(u=torch.tensor(1e-2 * g.standard_normal(nu), dtype=torch.float32),
                        p=torch.tensor(1e-2 * g.standard_normal(npr), dtype=torch.float32))]
    for state in starts:
        a = b = state
        for _ in range(20):
            a, (da, la) = fused_step(dev, a)
            b, (db, lb) = fused_step(dev, b, apply=mv.matvec_reference)
            assert torch.equal(a.u, b.u) and torch.equal(a.p, b.p)
            assert torch.equal(da, db) and torch.equal(la, lb)
        assert torch.isfinite(a.u).all() and float(a.u.abs().max()) > 0


def _ustar_operands(o, u, p, c):
    return (
        (("F1u", o["F1u"], ("nu", "nu")), ("F1p", o["F1p"], ("nu", "np")),
         ("A1Z", o["A1Z"], ("nu", "nu")), ("rho", o["rho"], ()),
         ("k1", o["k1"], ("nu",))),
        (("u", u, ("nu",)), ("p", p, ("np",)), ("c", c, ("nu",))),
        ("nu", "np", "nu"),
    )


@pytest.mark.parametrize("fault,error,match", [
    ("operator_shape", ValueError, "does not match"),
    ("vector_shape", ValueError, "does not match"),
    ("operator_dims", ValueError, "must have 2 dimensions"),
    ("rho_not_scalar", ValueError, "must have 0 dimensions"),
    ("dtype", TypeError, "float32"),
    ("mixed_devices", ValueError, "is on meta"),
    ("not_contiguous", ValueError, "contiguous"),
    ("too_wide", ValueError, "shared memory"),
    ("on_cpu", ValueError, "CUDA device"),
])
def test_grouped_checks_reject_what_the_kernel_does_not_take(fault, error, match):
    """The checks the wrappers run before a launch, on CPU-visible faults
    (the wrappers themselves take their plain versions on the CPU)."""
    o, u, p, c = _operators(6, 3, torch.float32)
    if fault == "operator_shape":
        o["F1p"] = torch.zeros(12, 4)
    elif fault == "vector_shape":
        p = torch.zeros(4)
    elif fault == "operator_dims":
        o["A1Z"] = torch.zeros(144)
    elif fault == "rho_not_scalar":
        o["rho"] = torch.ones(1)
    elif fault == "dtype":
        c = c.double()
    elif fault == "mixed_devices":
        u = u.to("meta")
    elif fault == "not_contiguous":
        u = torch.zeros(24)[::2]
    elif fault == "too_wide":
        # x vectors of 2 x 30000 + 3 floats: more than 227 KB of shared memory.
        o, u, p, c = ({**o, "F1u": torch.zeros(30000, 1).expand(30000, 30000),
                       "A1Z": torch.zeros(30000, 1).expand(30000, 30000),
                       "F1p": torch.zeros(30000, 1).expand(30000, 3),
                       "k1": torch.zeros(30000)}, torch.zeros(30000), p, torch.zeros(30000))
    with pytest.raises(error, match=match):
        mv._check_group("ustar", *_ustar_operands(o, u, p, c))
    assert "ustar" not in mv._checked_operators


def test_velocity_checks_the_stacked_blocks():
    o, u, p, c = _operators(6, 3, torch.float32)
    ops = (("F3s", o["F3s"], ("ns", "ns")), ("F3p", o["F3p"].view(12, 3), (2, "ns", "np")),
           ("k3", o["k3"], ("nu",)))
    with pytest.raises(ValueError, match="dimensions"):
        mv._check_group("velocity", ops, (("dp", torch.zeros(3), ("np",)),), ("np",))
    ops = (("F3s", o["F3s"], ("ns", "ns")), ("F3p", torch.zeros(3, 6, 3), (2, "ns", "np")))
    with pytest.raises(ValueError, match="does not match"):
        mv._check_group("velocity", ops, (), ("np",))

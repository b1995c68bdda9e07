"""The port's CG path against the benchmark's plain reference, on the CPU.

The benchmark's CG cell (`ys930-finest-cg`: portbench/configs/ys930_finest.json,
f32 block-Jacobi PCG (6, 5) in the banded layout) on the 555-vertex sweep
mesh (0.25, the coarsest that the CG path builds in the banded layout; the
482-vertex row falls back to the ELL layout), 30 steps from rest plus a
seeded 0.01 N(0, 1) velocity, run through
the cell's own driver (portbench/drivers/solo_cg.py) and read by the
numbers that decide the cell's `correct` (portbench/check.py) against the
plain float64 reference (portbench/reference/ipcs.py), which shares no
code with the program.  Also: `import_u` inverts `export_u`, and in both
layouts (the ELL one on the 482-vertex row) tracing leaves every bit alone
and the step's spans and counters are there.
"""
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.reference.fem import Mesh
from portbench.reference.ipcs import ReferenceFlow

from meshdqn_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
MESHES = {"banded": "ys930_0.25000_gen.npz", "ell": "ys930_0.30000_gen.npz"}
CONFIG = json.loads((REPO / "portbench/configs/ys930_finest.json").read_text())
LIMITS = json.loads((REPO / "portbench/limits/ys930-finest-cg.json").read_text())
STEPS = 30
SEED = 3180000005
PHASES = ("step.convection", "step.ustar", "step.pressure", "step.velocity",
          "step.probes")


@functools.lru_cache(maxsize=None)
def load_mesh(layout):
    torch.set_num_threads(2)
    with np.load(REPO / "meshdqn_tpu_torch/data" / MESHES[layout]) as z:
        return z["coords"], z["cells"]


@pytest.fixture(scope="module")
def mesh():
    return load_mesh("banded")


@pytest.fixture(scope="module")
def inputs(mesh):
    ns = Mesh(*mesh).ns
    return harness.Inputs(SEED, 0.01, [ns], 2 * ns)


def driver(mesh, **solver):
    """The cell's driver on `mesh`, STEPS steps a solve, with the cell's
    solver keys and `solver` over them."""
    Driver = harness.load_module(REPO / "portbench/drivers/solo_cg.py").Driver
    cfg = {**CONFIG, "flow": {**CONFIG["flow"], "solver_steps": STEPS, "save_steps": 10}}
    mesh_set = {"solver": {**CONFIG["mesh_sets"]["finest"]["solver"], **solver}}
    return Driver(cfg, mesh_set, [mesh], torch.device("cpu"))


def reference(mesh, inputs, precision="f64"):
    flow = CONFIG["flow"]
    ref = ReferenceFlow(*mesh, mu=flow["mu"], rho=flow["rho"], dt=flow["dt"],
                        device="cpu", precision=precision)
    return ref.solve(inputs.plain(0)[0], STEPS)


def program_gaps(d, inputs, ref):
    drags, lifts, u, p = d.solve(inputs.program(0))
    return check.gaps((drags[0], lifts[0], u[0].numpy(), p[0].numpy()), ref)


@pytest.fixture(scope="module")
def exact(mesh, inputs):
    return reference(mesh, inputs)


@functools.lru_cache(maxsize=None)
def production_in(layout):
    """The cell's driver on the layout's mesh, built once."""
    d = driver(load_mesh(layout))
    assert (d.solver._u_export_idx is not None) == (layout == "banded")
    return d


@pytest.fixture(scope="module")
def production():
    return production_in("banded")


def test_converged_f64_cg_agrees_with_the_reference(mesh, inputs, exact):
    """With PCG run to convergence (30 iterations each: 100 read the same)
    in float64, the CG path solves the reference's equations: the gaps are
    float64 rounding carried through 30 steps of two summation orders
    (2.5e-12 at most here), 1e-9 leaves room for other BLAS, while the
    production (6, 5) truncation alone reads 2.0e-5 and above in float64."""
    gaps = program_gaps(driver(mesh, precision="f64", cg_iters_u=30, cg_iters_m=30),
                        inputs, exact)
    assert max(gaps.values()) < 1e-9, gaps


def test_production_solve_is_correct_under_the_cells_limits(production, inputs, exact):
    correct, checks = check.verdict(program_gaps(production, inputs, exact), LIMITS)
    assert correct, checks


@pytest.mark.parametrize("control", ["pcg_1_1", "tf32_reference"])
def test_a_control_is_not_correct(mesh, inputs, exact, control):
    """Truncating PCG to one iteration each, or the reference itself with
    TF32 products (the precision below the configuration's f32), fails at
    least one of the cell's limits."""
    if control == "pcg_1_1":
        gaps = program_gaps(driver(mesh, cg_iters_u=1, cg_iters_m=1), inputs, exact)
    else:
        gaps = check.gaps(reference(mesh, inputs, "tf32"), exact)
    assert not check.verdict(gaps, LIMITS)[0], gaps


def test_import_u_inverts_export_u(production, inputs):
    s = production.solver
    u = torch.as_tensor(inputs.program(0)[0], dtype=torch.float32)
    inside = s.import_u(u)
    assert s._u_export_idx is not None and not torch.equal(inside, u)
    assert torch.equal(s.export_u(inside), u)
    assert torch.equal(s.import_u(s.export_u(inside)), inside)


def run_traced(layout, on):
    """Two evolve calls (4 and 3 steps) of the layout's production driver
    from a seeded 0.01 N(0, 1) velocity; with `on`, traced.  Returns (u, p,
    drags, lifts, spans, counts)."""
    d = production_in(layout)
    ns = Mesh(*load_mesh(layout)).ns
    profiling.take_trace()
    d.start(harness.Inputs(SEED, 0.01, [ns], 2 * ns).program(0))
    if on:
        profiling.trace_on()
    try:
        s, state = d.solver, d._state
        state, d1, l1 = s.evolve(state, 4)
        state, d2, l2 = s.evolve(state, 3)
    finally:
        profiling.trace_off()
    spans, counts = profiling.take_trace()
    return state.u, state.p, torch.cat([d1, d2]), torch.cat([l1, l2]), spans, counts


@pytest.mark.parametrize("layout", MESHES)
def test_tracing_leaves_every_bit_alone(layout):
    plain = run_traced(layout, False)
    traced = run_traced(layout, True)
    assert plain[4:] == ([], {})
    for a, b in zip(plain[:4], traced[:4]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", MESHES)
def test_each_evolve_holds_five_phase_spans_a_step_and_the_counts(layout):
    *_, spans, counts = run_traced(layout, True)
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["evolve", "evolve"]
    for root, n in zip(roots, (4, 3)):
        children = [s for s in spans if s.parent == root]
        assert [s.name for s in children] == list(PHASES) * n
        assert all(spans[root].start_ns <= s.start_ns <= s.end_ns <= spans[root].end_ns
                   for s in children)
    # The plain banded and ELL products on the CPU count no kernel launch.
    assert counts == {"steps": 7, "pcg.products": 13 * 7}


def test_setup_compose_span_holds_the_cg_operators(mesh):
    profiling.take_trace()
    profiling.trace_on()
    try:
        driver(mesh)
    finally:
        profiling.trace_off()
    spans, counts = profiling.take_trace()
    assert [s.name for s in spans] == ["setup.assemble", "setup.compose"]
    assert counts == {}


def test_benchmark_reads_the_banded_and_ell_kernels_as_the_programs():
    """portbench reads the program's kernel names from the `__global__`
    lines of csrc/*.cu; without the two CG kernels there,
    `torch_ops_device_ms_per_step` would count them as torch ops."""
    from portbench.devtrace import port_kernels

    assert {"banded_tiles_kernel", "ell_kernel"} <= port_kernels(REPO)

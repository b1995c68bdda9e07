"""The program's tracer (meshdqn_tpu_torch.utils.profiling) on the CPU, on
the coarsest sweep mesh, fused f32: with tracing off a solve reads no clock
and enters no profiler annotation; with it on, each `evolve` call is one
root span holding its steps' five phase spans, the `steps` counter counts
the steps run, the set-up spans are kept once a solver, the annotations
land in torch.profiler's trace, and the numbers are the untraced ones bit
for bit."""
from pathlib import Path

import numpy as np
import pytest
import torch

from meshdqn_tpu_torch.mesh import TriMesh
from meshdqn_tpu_torch.solver import IPCSConfig, IPCSSolver
from meshdqn_tpu_torch.utils import profiling

MESH = Path(__file__).resolve().parents[1] / "meshdqn_tpu_torch/data/ys930_0.30000_gen.npz"
PHASES = ("step.convection", "step.ustar", "step.pressure", "step.velocity",
          "step.probes")
CALLS = (3, 2)  # steps of each evolve call


@pytest.fixture(scope="module")
def built():
    """A solver built with tracing on, and the spans and counts its set-up
    kept."""
    torch.set_num_threads(2)
    with np.load(MESH) as z:
        mesh = TriMesh(z["coords"], z["cells"])
    profiling.take_trace()
    profiling.trace_on()
    try:
        solver = IPCSSolver(mesh, IPCSConfig(precision="f32", fused=True,
                                             pad_quantum=768), device="cpu")
    finally:
        profiling.trace_off()
    spans, counts = profiling.take_trace()
    return solver, spans, counts


@pytest.fixture
def solver(built):
    yield built[0]
    profiling.trace_off()
    profiling.take_trace()


def start(solver):
    g = torch.Generator().manual_seed(5)
    u = 0.01 * torch.randn(solver.ndofs_u, generator=g, dtype=torch.float32)
    return solver.initial_state()._replace(u=u)


def run_calls(solver):
    state, drags, lifts = start(solver), [], []
    for n in CALLS:
        state, d, l = solver.evolve(state, n)
        drags.append(d)
        lifts.append(l)
    return state, torch.cat(drags), torch.cat(lifts)


def test_setup_spans_are_kept_once_a_solver(built):
    _, spans, counts = built
    assert [s.name for s in spans] == ["setup.assemble", "setup.compose"]
    assert all(s.parent == -1 and s.end_ns > s.start_ns for s in spans)
    assert spans[0].end_ns <= spans[1].start_ns
    assert counts == {}


def test_tracing_off_reads_no_clock_and_enters_no_annotation(solver, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the tracer ran with tracing off")

    monkeypatch.setattr(profiling, "perf_counter_ns", refuse)
    monkeypatch.setattr(profiling, "record_function", refuse)
    res = solver.solve(4, save_steps=2, state=start(solver))
    assert res["drags"].shape == (4,)
    assert profiling.take_trace() == ([], {})


def test_each_call_is_one_root_holding_five_phases_a_step(solver):
    profiling.trace_on()
    run_calls(solver)
    profiling.trace_off()
    spans, counts = profiling.take_trace()
    assert counts == {"steps": sum(CALLS)}
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["evolve"] * len(CALLS)
    for root, n in zip(roots, CALLS):
        children = [s for s in spans if s.parent == root]
        assert [s.name for s in children] == list(PHASES) * n
        for s in [spans[root], *children]:
            assert s.start_ns <= s.end_ns
        for s in children:
            assert spans[root].start_ns <= s.start_ns and s.end_ns <= spans[root].end_ns
        for a, b in zip(children, children[1:]):
            assert a.end_ns <= b.start_ns


def test_traced_solve_equals_untraced_bit_for_bit(solver):
    plain = run_calls(solver)
    profiling.trace_on()
    traced = run_calls(solver)
    profiling.trace_off()
    for a, b in zip([plain[0].u, plain[0].p, *plain[1:]],
                    [traced[0].u, traced[0].p, *traced[1:]]):
        assert torch.equal(a, b)


def test_annotations_land_in_the_profilers_trace(solver):
    from torch.profiler import ProfilerActivity, profile

    profiling.trace_on(annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_calls(solver)
    profiling.trace_off()
    found = {}
    for ev in prof.events():
        if ev.name.startswith("meshdqn:"):
            found[ev.name] = found.get(ev.name, 0) + 1
    assert found == {"meshdqn:evolve": len(CALLS),
                     **{f"meshdqn:{p}": sum(CALLS) for p in PHASES}}


def test_a_span_closes_what_an_exception_left_open():
    tr = profiling.Tracer()
    with pytest.raises(ValueError):
        with tr.span("outer"):
            tr.begin("inner")
            raise ValueError
    spans, _ = tr.take()
    assert [(s.name, s.parent) for s in spans] == [("outer", -1), ("inner", 0)]
    assert all(s.end_ns is not None for s in spans)
    assert tr.take() == ([], {})


def test_counts_are_kept_only_while_tracing():
    profiling.take_trace()
    profiling.count("steps", 3)
    profiling.trace_on()
    try:
        profiling.count("steps", 2)
        profiling.count("steps")
    finally:
        profiling.trace_off()
    assert profiling.take_trace() == ([], {"steps": 3})

"""Device time of a piece of work, from torch.profiler's kernel records, the
bytes a solver's step reads, and the program's own spans and counters.

The tracer: with tracing on (`trace_on`), `span(name)` keeps (name, parent,
start_ns, end_ns) in memory on `time.perf_counter_ns`'s clock, and
`count(name, n)` adds to a counter; `take_trace` hands both over and clears
them.  With `annotate`, each span also enters
`torch.profiler.record_function("meshdqn:" + name)`, so it lands in a
profiler's trace as an annotation on the device events' clock.  With
tracing off nothing is read or kept: the solver's hot loops test
`tracing()` once a step or a call, and `span` returns a shared null
context.  The tracer is one per process, as the profiler is.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext
from time import perf_counter_ns
from typing import NamedTuple

from torch.profiler import record_function


def device_busy(fn):
    """Run fn() under torch.profiler and return (its result, the summed
    device time of the kernels it ran in ms, their count).  Device-side
    events only: a CPU op also carries the device time of the kernels it
    launched, which would count them twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy_us, ops = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t > 0:
            busy_us += t
            ops += ev.count
    return out, busy_us / 1e3, ops


FUSED_OPERATORS = ("F1u", "F1p", "A1Z", "F2p", "F2u", "F3s", "F3p")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def fused_step_bytes(dev) -> tuple[int, int]:
    """Bytes one fused step reads once each, as stored (padding included):
    (the seven dense operators, everything: operators, vectors and the
    convection tables)."""
    import torch

    ops = sum(_nbytes(getattr(dev, n)) for n in FUSED_OPERATORS)
    leaves = [*dev._replace(conv=None), *vars(dev.conv).values()]
    return ops, sum(_nbytes(t) for t in leaves if isinstance(t, torch.Tensor))


def cg_step_bytes(dev, cfg) -> tuple[int, int]:
    """Bytes one banded CG step reads once each: (operator bytes, all
    bytes).  Operators: the banded kernel's packed tiles and their index,
    and the block-Jacobi inverses, times their applies.  All: also the dense
    pressure inverse, the ELL operators, the convection tables and the
    vectors."""
    import torch

    from ..ops.banded import BandedMatrix
    from ..ops.cg import BlockJacobi

    iu, im, pr = 1 + cfg.cg_iters_u, 1 + cfg.cg_iters_m, cfg.cg_pressure_refine
    counts = {"A1bc": iu, "A3bc_s": im, "d1inv": iu, "d3inv": im}
    ops = 0
    for name in ("A1bc", "A3bc_s", "R1", "P1m_s", "BT_s", "Ms", "G_s", "d1inv",
                 "d3inv"):
        v = getattr(dev, name)
        if isinstance(v, BandedMatrix):
            b = v.tiles.nbytes
        else:
            b = _nbytes(v.inv_blocks if isinstance(v, BlockJacobi) else v)
        ops += counts.get(name, 1) * b
    rest = (1 + pr) * _nbytes(dev.A2inv) + dev.Kp.slices.nbytes + pr * dev.A2bc.slices.nbytes
    rest += sum(_nbytes(t) for t in vars(dev.conv).values() if isinstance(t, torch.Tensor))
    rest += sum(_nbytes(getattr(dev, n)) for n in ("z_u", "z_p", "t1", "t2", "t3",
                                                   "drag_u", "drag_p", "lift_u",
                                                   "lift_p", "vert_pos"))
    return ops, ops + rest


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in the same list, -1 for a root
    start_ns: int
    end_ns: int


class Tracer:
    """Spans and counters kept in memory while `on`; see the module's
    docstring.  Spans nest on one thread: `begin` opens a span inside the
    innermost open one, `end` closes the innermost, `next` closes it and
    opens a sibling."""

    def __init__(self):
        self.on = False
        self.annotate = False
        self.spans = []  # [name, parent, start_ns, end_ns]
        self.counts = {}
        # The open spans, innermost last: (index, record_function scope or
        # None).
        self._open = []

    def begin(self, name: str) -> None:
        mark = None
        if self.annotate:
            mark = record_function("meshdqn:" + name)
            mark.__enter__()
        self.spans.append([name, self._open[-1][0] if self._open else -1,
                           perf_counter_ns(), None])
        self._open.append((len(self.spans) - 1, mark))

    def end(self) -> None:
        i, mark = self._open.pop()
        self.spans[i][3] = perf_counter_ns()
        if mark is not None:
            mark.__exit__(None, None, None)

    def next(self, name: str) -> None:
        self.end()
        self.begin(name)

    @contextmanager
    def span(self, name: str):
        depth = len(self._open)
        self.begin(name)
        try:
            yield
        finally:
            # Also closes what an exception left open inside it.
            while len(self._open) > depth:
                self.end()

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def take(self) -> tuple[list[Span], dict]:
        spans = [Span(*s) for s in self.spans]
        counts = self.counts
        self.spans, self.counts, self._open = [], {}, []
        return spans, counts


TRACER = Tracer()
_NULL = nullcontext()


def trace_on(annotate: bool = False) -> None:
    """Start keeping spans and counts; with `annotate`, also as
    torch.profiler annotations named "meshdqn:<span>"."""
    TRACER.on, TRACER.annotate = True, annotate


def trace_off() -> None:
    TRACER.on = TRACER.annotate = False


def tracing() -> Tracer | None:
    """The tracer while tracing is on, else None: the one test a hot loop
    makes before it opens spans."""
    return TRACER if TRACER.on else None


def span(name: str):
    """A span around a `with` block while tracing is on; a shared null
    context (no clock, no allocation) while it is off."""
    return TRACER.span(name) if TRACER.on else _NULL


def count(name: str, n: int = 1) -> None:
    if TRACER.on:
        TRACER.count(name, n)


def take_trace() -> tuple[list[Span], dict]:
    """The spans (closed ones have end_ns; parents index the same list) and
    counts kept since the last take, and clear them.  Take between calls,
    with no span open."""
    return TRACER.take()

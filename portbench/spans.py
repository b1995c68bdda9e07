"""The program's own spans, read in a cell's solve: the host's issue, device
time and device idle by phase of the step, and the set-up by phase.

The program's tracer (meshdqn_tpu_torch.utils.profiling) keeps one span
around each `evolve` call, the root of its steps' phase spans
(step.convection; step.ustar, step.pressure, step.velocity, the three
grouped launches with their wrappers; step.probes, drag and lift), two
around the solver's set-up (setup.assemble, setup.compose), and counts the
steps run (`steps`).  They are read in three stretches:

  set-up          tracing on from just before the driver builds the solver
                  to the end of the warm solve: setup_s.*
  traced issue    the traffic's issue chunks again with tracing on, on the
                  host clock: issue_ms_per_step.*
  traced profile  the traffic's profiled stretch again with tracing on and
                  each span annotated into the profiler's trace:
                  device_ms_per_step.*, idle_ms_per_step.*

`loop` is the `evolve` span's self time (the loop's stores into its
preallocated rows and the Python between steps), `launches` the three
launch spans together.  The annotations slow the host inside the profiled
stretch, so the idle numbers rank the phases under the profiler, as
device_idle_share does; they are not unprofiled idle.

    python3 -m portbench.spans --workload <name> --seed <n>

from the root of a checkout runs the cell's solver through the harness's
own untraced stretches (harness.traced) and then these, and prints one JSON
line: the span metrics, the untraced per-layer metrics of the same run, the
checks that tie the two together, and what tracing costs the host.  Where
the program has no tracer every span metric is None.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    # One host thread a library, as portbench/run.py runs a cell; set
    # before numpy or torch is imported.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"

import torch  # noqa: E402

from . import devtrace, harness  # noqa: E402
from .reference.fem import Mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "meshdqn:"  # the annotations' names: PREFIX + span name
RUNTIME = re.compile(r"cu(da)?[A-Z]")  # CUDA runtime and driver calls' names
OUTSIDE = "(outside)"
# A metric's phase: the spans whose self time or attributed time it sums.
PHASES = {
    "loop": ("evolve",),
    "convection": ("step.convection",),
    "probes": ("step.probes",),
    "launches": ("step.ustar", "step.pressure", "step.velocity"),
}
ISSUE = ("loop", "convection", "probes", "launches")
DEVICE = ("convection", "probes")
IDLE = ("loop", "convection", "probes", "launches")
SETUP = ("assemble", "compose")
KERNEL = "group_kernel"
COST_ROUNDS = 6


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from meshdqn_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "trace_on") else None


def self_seconds(spans) -> dict:
    """Seconds by span name of the program's taken spans (Span records: name,
    parent index, start_ns, end_ns), each span less its children."""
    out = {}
    for s in spans:
        d = (s.end_ns - s.start_ns) * 1e-9
        out[s.name] = out.get(s.name, 0.0) + d
        if s.parent >= 0:
            up = spans[s.parent].name
            out[up] = out.get(up, 0.0) - d
    return out


def innermost(spans, points) -> list:
    """For each of `points` (ascending), the index in `spans` ((name, start,
    end), nested as one thread's calls nest) of the innermost span holding
    it, or None."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    stack, out, k = [], [], 0
    for t in points:
        while k < len(order) and spans[order[k]][1] <= t:
            i = order[k]
            while stack and spans[stack[-1]][2] < spans[i][1]:
                stack.pop()
            stack.append(i)
            k += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def merge(device) -> list:
    """The union of (start, end) intervals, as sorted disjoint [start, end]."""
    merged = []
    for a, b in sorted(device):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def attribute(spans, calls, device, window=None) -> tuple[dict, dict]:
    """Device seconds and idle seconds by program span.

    spans: (name, start, end) of the program's spans; calls: (start, end,
    device seconds) of host calls with the device time of the kernels each
    launched; device: (start, end) of the device intervals; window: (start,
    end) of the stretch, whose idle before the first and after the last
    device interval are gaps too where there are any.  Times in us on the profiler's clock.  A
    call's device seconds go to the innermost span holding the call's
    middle; each gap between merged device intervals goes whole to the
    innermost span holding the gap's middle.  Returns (device_s, idle_s) by
    span name, OUTSIDE where no span holds the point; idle_s sums to the
    total of the gaps."""
    def by_span(weighted):
        weighted = sorted(weighted)
        out = {}
        for (_, w), i in zip(weighted, innermost(spans, [t for t, _ in weighted])):
            name = OUTSIDE if i is None else spans[i][0]
            out[name] = out.get(name, 0.0) + w
        return out

    merged = merge(device)
    if window and merged:
        merged = [[window[0]] * 2, *merged, [window[1]] * 2]
    gaps = [(0.5 * (end + start), (start - end) * 1e-6)
            for (_, end), (start, _) in zip(merged, merged[1:]) if start > end]
    return by_span([(0.5 * (a + b), s) for a, b, s in calls]), by_span(gaps)


def from_profiler(prof) -> tuple[list, list, list, dict]:
    """(spans, calls, device, by_name) of a torch.profiler run in which the
    program's spans were annotated, for `attribute`.

    The link from a host call to the kernels it launched is the profiler's
    own: the CUDA runtime or driver call that launched a device event
    (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...) and the event
    carry the same correlation id (`FunctionEvent.id`).  That holds for the
    kernels launched through ctypes too, which no aten op encloses, where
    the aten op's link (`FunctionEvent.kernels`) finds nothing.  The
    device-side copy of an annotation (named as the annotation) is not a
    device event."""
    from torch.autograd import DeviceType

    spans, launches, dev_events, by_name = [], {}, [], {}
    for ev in prof.events():
        a, b = float(ev.time_range.start), float(ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            if not ev.name.startswith(PREFIX):
                dev_events.append((ev.id, a, b))
                by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a) * 1e-6
        elif ev.device_type == DeviceType.CPU:
            if ev.name.startswith(PREFIX):
                spans.append((ev.name[len(PREFIX):], a, b))
            elif RUNTIME.match(ev.name):
                launches[ev.id] = (a, b)
    calls = [(*launches[i], (b - a) * 1e-6) for i, a, b in dev_events if i in launches]
    return spans, calls, [(a, b) for _, a, b in dev_events], by_name


def profiled(prog, advance, device) -> dict:
    """Profile advance() with the program's spans annotated; returns
    {"window_s" (host clock), "hull_s" (the spans' stretch on the profiler's
    clock), "busy_s", "linked_s", "by_name", "device_s", "idle_s",
    "counts"}."""
    from torch.profiler import ProfilerActivity, profile

    harness.sync(device)
    prog.trace_on(annotate=True)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            advance()
            harness.sync(device)
            window_s = time.perf_counter() - t0
    finally:
        prog.trace_off()
    _, counts = prog.take_trace()
    spans, calls, device_iv, by_name = from_profiler(prof)
    # The stretch on the profiler's clock: from the first span's start to
    # the later of the last span's end and the last device event's.
    hull = (min(a for _, a, _ in spans),
            max(b for _, _, b in spans + [(None, 0.0, b) for _, b in device_iv]))
    device_s, idle_s = attribute(spans, calls, device_iv, hull)
    return {"window_s": window_s, "hull_s": (hull[1] - hull[0]) * 1e-6,
            "busy_s": sum(b - a for a, b in merge(device_iv)) * 1e-6,
            "linked_s": sum(s for _, _, s in calls), "by_name": by_name,
            "device_s": device_s, "idle_s": idle_s, "counts": counts}


def chunk_seconds(advance, chunks: int, chunk: int, device) -> float:
    """Host seconds to issue `chunks` chunks of `chunk` steps, each timed
    from a synchronised device, as the harness times host_issue_ms_per_step."""
    wall = 0.0
    for _ in range(chunks):
        harness.sync(device)
        a = time.perf_counter()
        advance(chunk)
        wall += time.perf_counter() - a
    harness.sync(device)
    return wall


def issued(prog, advance, chunks: int, chunk: int, device) -> dict:
    """The issue chunks with tracing on; returns {"wall_s", "self_s" (self
    seconds by span name), "counts", "evolve_s" (the `evolve` spans' whole
    time)}."""
    prog.trace_on()
    try:
        wall = chunk_seconds(advance, chunks, chunk, device)
    finally:
        prog.trace_off()
    spans, counts = prog.take_trace()
    return {"wall_s": wall, "self_s": self_seconds(spans), "counts": counts,
            "evolve_s": sum((s.end_ns - s.start_ns) * 1e-9 for s in spans
                            if s.name == "evolve")}


def tracer_us_per_step(prog, steps: int = 20000) -> tuple[float, float]:
    """Host us a step of the tracer's own work in the fused step (its one
    `tracing()` test, six flag tests and, with tracing on, five phase
    spans), without the step: (tracing off, tracing on, no annotation)."""
    out = []
    for on in (False, True):
        if on:
            prog.trace_on()
        try:
            t0 = time.perf_counter()
            with prog.span("evolve"):
                for _ in range(steps):
                    tr = prog.tracing()
                    if tr:
                        tr.begin("step.convection")
                    for name in ("step.ustar", "step.pressure", "step.velocity",
                                 "step.probes"):
                        if tr:
                            tr.next(name)
                    if tr:
                        tr.end()
            prog.count("steps", steps)
            out.append((time.perf_counter() - t0) / steps * 1e6)
        finally:
            prog.trace_off()
            prog.take_trace()
    return out[0], out[1]


def per_step(by_span: dict, phase: str, steps: int, counts: dict):
    """ms a step of a phase's spans, or None where its spans are absent or
    the `steps` counter does not equal the stretch's steps."""
    names = [n for n in PHASES[phase] if n in by_span]
    if not names or counts.get("steps") != steps:
        return None
    return sum(by_span[n] for n in names) / steps * 1e3


def span_metrics(setup: dict, issue: dict | None, issue_steps: int,
                 prof: dict | None, prof_steps: int) -> dict:
    """The span metrics by name; None where a stretch found nothing to read
    (no tracer, no device events)."""
    out = {f"setup_s.{p}": setup.get(f"setup.{p}") for p in SETUP}
    for p in ISSUE:
        out[f"issue_ms_per_step.{p}"] = issue and per_step(
            issue["self_s"], p, issue_steps, issue["counts"])
    for p in DEVICE:
        out[f"device_ms_per_step.{p}"] = prof and per_step(
            prof["device_s"], p, prof_steps, prof["counts"])
    for p in IDLE:
        out[f"idle_ms_per_step.{p}"] = prof and per_step(
            prof["idle_s"], p, prof_steps, prof["counts"])
    return out


def _ratio(a, b):
    return a / b if a is not None and b else None


def run(cell, seed: int, device, log=print) -> dict:
    """Set-up with tracing on, the harness's untraced stretches, then the
    traced ones; returns the result line's object."""
    tr = cell.traffic
    prog = tracer()
    mesh_list = harness.meshes(cell)
    ns = [Mesh(c, t).ns for c, t in mesh_list]
    nps = [len(c) for c, _ in mesh_list]
    if prog:
        prog.take_trace()
        prog.trace_on()
    try:
        driver = harness.part(cell, "drivers", tr["driver"]).Driver(
            cell.config, cell.mesh_set, mesh_list, device)
        inputs = harness.Inputs(seed, tr["perturbation"], ns, driver.n_u)
        warm = tr["warm_steps"]
        driver.solve(inputs.program(harness.WARM), steps=2 * warm, save_steps=warm)
        harness.sync(device)
    finally:
        if prog:
            prog.trace_off()
    setup = self_seconds(prog.take_trace()[0]) if prog else {}

    # The harness's own stretches, untraced and in its order; one solve
    # stands for the window, whose wall time no metric here reads.
    info = harness.card(device)
    ctx = harness.traced(cell, driver, inputs, 1, float("nan"), ns, nps, info, device,
                         log)
    untraced = {}
    for name in ("host_issue_ms_per_step", "torch_ops_device_ms_per_step",
                 "kernel_roofline.group_kernel", "device_idle_share"):
        untraced[name] = harness.part(cell, "metrics", name).read(ctx)

    chunk, chunks, n = tr["issue_chunk_steps"], tr["issue_chunks"], tr["profile_steps"]
    issue = prof = None
    if prog:
        issue = issued(prog, driver.advance, chunks, chunk, device)
        prof = profiled(prog, lambda: driver.advance(n), device)
        log(f"traced profile: {n} steps, busy {prof['busy_s']:.6f} of "
            f"{prof['window_s']:.6f} s, {prof['linked_s']:.6f} s of it linked to "
            f"host calls")
    metrics = span_metrics(setup, issue, chunk * chunks, prof, n)
    rounds = []
    if prog:
        # What tracing costs the host, in alternating rounds of the issue
        # chunks untraced and traced (the host's pace drifts between
        # stretches more than tracing moves it).
        for r in range(COST_ROUNDS):
            pair = {}
            for on in ((False, True) if r % 2 == 0 else (True, False)):
                if on:
                    pair[on] = issued(prog, driver.advance, chunks, chunk, device)["wall_s"]
                else:
                    pair[on] = chunk_seconds(driver.advance, chunks, chunk, device)
            rounds.append([pair[False] / (chunk * chunks) * 1e3,
                           pair[True] / (chunk * chunks) * 1e3])

    checks = {}
    if issue:
        evolve_ms = issue["evolve_s"] / (chunk * chunks) * 1e3
        parts = [metrics[f"issue_ms_per_step.{p}"] for p in ISSUE]
        checks["traced_evolve_ms_per_step"] = evolve_ms
        checks["traced_issue_ms_per_step"] = issue["wall_s"] / (chunk * chunks) * 1e3
        if None not in parts:
            checks["issue_sum_over_evolve"] = sum(parts) / evolve_ms
        checks["tracing_cost_ms_per_step"] = evolve_ms - untraced["host_issue_ms_per_step"]
        checks["tracing_cost_share"] = _ratio(checks["tracing_cost_ms_per_step"],
                                              untraced["host_issue_ms_per_step"])
        checks["tracer_us_per_step_off"], checks["tracer_us_per_step_on"] = (
            tracer_us_per_step(prog))
        checks["cost_rounds_ms_per_step"] = rounds
        checks["cost_rounds_median_ms_per_step"] = statistics.median(
            on - off for off, on in rounds)
    if prof and prof["by_name"]:
        dev = [metrics[f"device_ms_per_step.{p}"] for p in DEVICE]
        if None not in dev:
            checks["conv_probes_over_torch_ops"] = _ratio(
                sum(dev), untraced["torch_ops_device_ms_per_step"])
        kernel_s = sum(t for k, t in prof["by_name"].items()
                       if devtrace.is_kernel(k, KERNEL))
        launches_s = sum(prof["device_s"].get(s, 0.0) for s in PHASES["launches"])
        checks["launches_device_over_group_kernel"] = _ratio(launches_s, kernel_s)
        checks["idle_by_span_over_stretch_idle"] = _ratio(
            sum(prof["idle_s"].values()), prof["window_s"] - prof["busy_s"])
        checks["idle_by_span_over_hull_idle"] = _ratio(
            sum(prof["idle_s"].values()), prof["hull_s"] - prof["busy_s"])
        checks["linked_over_busy_device_time"] = _ratio(
            prof["linked_s"], sum(prof["by_name"].values()))
        checks["device_idle_share_traced"] = 100.0 * (1 - prof["busy_s"] / prof["window_s"])
        checks["device_ms_per_step_by_span"] = {
            k: v / n * 1e3 for k, v in sorted(prof["device_s"].items())}
        checks["idle_ms_per_step_by_span"] = {
            k: v / n * 1e3 for k, v in sorted(prof["idle_s"].items())}
    return {"metrics": metrics, "untraced": untraced, "checks": checks,
            "device": info}


def main(argv=None, *, root: Path = ROOT, require_card: bool = True) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(root, args.workload)
    if require_card:
        if not torch.cuda.is_available():
            print(f"{args.workload} needs a CUDA card", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run(cell, args.seed, device,
                 log=lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

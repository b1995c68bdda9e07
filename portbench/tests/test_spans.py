"""The reading of the program's spans (portbench/spans.py): the attribution
of device and idle time to spans on hand-made intervals, the self times and
per-step readings, and a run of the tiny CPU cell that reads every span
metric the host can give."""
import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from conftest import add_tiny_cells
from portbench import spans as sp
from meshdqn_tpu_torch.utils.profiling import Span

# evolve [0, 100] holds convection [10, 20] and ustar [20, 40]; ustar holds
# a host op [25, 35]; a second root [200, 300] holds probes [210, 220].
SPANS = [("evolve", 0.0, 100.0), ("step.convection", 10.0, 20.0),
         ("step.ustar", 20.0, 40.0), ("aten::mm", 25.0, 35.0),
         ("evolve", 200.0, 300.0), ("step.probes", 210.0, 220.0)]


def test_innermost_span_of_each_point():
    points = [-1.0, 5.0, 10.0, 15.0, 30.0, 38.0, 50.0, 150.0, 215.0, 250.0, 400.0]
    got = [None if i is None else SPANS[i][0] for i in sp.innermost(SPANS, points)]
    assert got == [None, "evolve", "step.convection", "step.convection", "aten::mm",
                   "step.ustar", "evolve", None, "step.probes", "evolve", None]


def test_device_time_goes_to_the_innermost_span_of_its_launch():
    calls = [(12.0, 13.0, 3e-6), (26.0, 27.0, 5e-6), (21.0, 22.0, 7e-6),
             (50.0, 51.0, 11e-6), (150.0, 151.0, 13e-6), (212.0, 213.0, 17e-6)]
    device_s, _ = sp.attribute(SPANS, calls, [])
    assert device_s == pytest.approx({"step.convection": 3e-6, "aten::mm": 5e-6,
                                      "step.ustar": 7e-6, "evolve": 11e-6,
                                      sp.OUTSIDE: 13e-6, "step.probes": 17e-6})


def test_idle_by_span_and_outside_sums_to_the_idle():
    # Overlapping device intervals merge; gaps (15, 30), (50, 60), (70, 120),
    # (130, 140), (150, 211) and (212, 218) hold their middles in ustar
    # (before its host op), evolve, evolve, outside, outside and probes.
    device = [(12.0, 15.0), (30.0, 45.0), (40.0, 50.0), (60.0, 70.0),
              (120.0, 130.0), (140.0, 150.0), (211.0, 212.0), (218.0, 230.0)]
    _, idle_s = sp.attribute(SPANS, [], device)
    assert idle_s == pytest.approx({"step.ustar": 15e-6, "evolve": 60e-6,
                                    sp.OUTSIDE: 71e-6, "step.probes": 6e-6})
    merged = sp.merge(device)
    total = sum(b - a for (_, a), (b, _) in zip(merged, merged[1:])) * 1e-6
    assert sum(idle_s.values()) == pytest.approx(total)
    # The stretch's idle before the first interval (0, 12) and after the
    # last (230, 300) falls in the two evolve spans.
    _, idle_s = sp.attribute(SPANS, [], device, window=(0.0, 300.0))
    assert idle_s == pytest.approx({"step.ustar": 15e-6, "evolve": (60 + 12 + 70) * 1e-6,
                                    sp.OUTSIDE: 71e-6, "step.probes": 6e-6})
    assert sum(idle_s.values()) == pytest.approx(
        300e-6 - sum(b - a for a, b in merged) * 1e-6)


def test_kernels_link_to_their_launch_calls_by_correlation_id():
    """A kernel launched through ctypes sits under no aten op: its launch
    call's correlation id places it in the annotation that held the call.
    The annotation's device-side copy is not a device event."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, kind, i, a, b):
        return NS(name=name, device_type=kind, id=i,
                  time_range=NS(start=a, end=b))

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        ev("meshdqn:evolve", cpu, 1, 0, 100), ev("meshdqn:step.convection", cpu, 2, 5, 30),
        ev("aten::index", cpu, 3, 6, 20), ev("cudaLaunchKernel", cpu, 900, 8, 9),
        ev("meshdqn:step.ustar", cpu, 4, 30, 60), ev("cuLaunchKernel", cpu, 901, 40, 41),
        ev("cudaMemcpyAsync", cpu, 902, 70, 72),
        ev("index_elementwise_kernel", cuda, 900, 10, 14),
        ev("group_kernel<UStar>", cuda, 901, 42, 80),
        ev("Memcpy DtoD", cuda, 902, 80, 81), ev("orphan_kernel", cuda, 903, 90, 95),
        ev("meshdqn:step.ustar", cuda, 4, 42, 80)]
    spans, calls, device, by_name = sp.from_profiler(NS(events=lambda: events))
    assert spans == [("evolve", 0, 100), ("step.convection", 5, 30), ("step.ustar", 30, 60)]
    assert [c[:2] for c in calls] == [(8, 9), (40, 41), (70, 72)]
    assert [c[2] for c in calls] == pytest.approx([4e-6, 38e-6, 1e-6])
    assert device == [(10, 14), (42, 80), (80, 81), (90, 95)]
    assert set(by_name) == {"index_elementwise_kernel", "group_kernel<UStar>",
                            "Memcpy DtoD", "orphan_kernel"}
    device_s, _ = sp.attribute(spans, calls, device)
    assert device_s == pytest.approx({"step.convection": 4e-6, "step.ustar": 38e-6,
                                      "evolve": 1e-6})


def test_self_seconds_and_per_step_readings():
    spans = [Span("evolve", -1, 0, 10_000), Span("step.convection", 0, 1_000, 2_000),
             Span("step.ustar", 0, 2_000, 5_000), Span("step.probes", 0, 5_000, 6_000),
             Span("evolve", -1, 20_000, 24_000), Span("step.ustar", 4, 21_000, 22_000)]
    self_s = sp.self_seconds(spans)
    assert self_s == pytest.approx({"evolve": 8e-6, "step.convection": 1e-6,
                                    "step.ustar": 4e-6, "step.probes": 1e-6})
    assert sum(self_s.values()) == pytest.approx(14e-6)
    issue = {"self_s": self_s, "counts": {"steps": 2}}
    got = sp.span_metrics({}, issue, 2, None, 600)
    assert got["issue_ms_per_step.loop"] == pytest.approx(4e-3)
    assert got["issue_ms_per_step.launches"] == pytest.approx(2e-3)
    assert got["device_ms_per_step.convection"] is None
    assert got["setup_s.compose"] is None
    # A counter that disagrees with the stretch's steps reads nothing.
    assert sp.span_metrics({}, issue, 3, None, 600)["issue_ms_per_step.loop"] is None


def test_tiny_cell_reads_every_program_span_metric(checkout):
    """On the CPU the profile holds no device events: the set-up and issue
    metrics are read, the device and idle ones are None, and the issue
    phases sum to the traced `evolve` spans' time."""
    add_tiny_cells(checkout)
    torch.set_num_threads(2)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = sp.main(["--workload", "tiny-solo", "--seed", "2147483697"],
                     root=checkout, require_card=False)
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    m = result["metrics"]
    program_span = [f"setup_s.{p}" for p in sp.SETUP] + [
        f"issue_ms_per_step.{p}" for p in sp.ISSUE]
    assert all(m[k] > 0 for k in program_span)
    assert all(v is None for k, v in m.items() if k not in program_span)
    assert result["checks"]["issue_sum_over_evolve"] == pytest.approx(1.0)
    assert result["untraced"]["host_issue_ms_per_step"] > 0

"""A whole run on the CPU, the look for a card skipped, with the timed path
broken underneath: `correct` comes out false for each fault a cell can
have, and true for the path unbroken.  The tiny cell runs the coarsest
sweep mesh for 10 steps a solve under the limits of the benchmark's cell.
A solo cell can have two of the faults: a step that returns its state
unchanged, and an answer altered where it is produced; it has no batch to
leave half of and no exchange between chips."""
import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from conftest import add_tiny_cells


def run_once(root, workload, trace=0):
    from portbench import run

    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", "2147483697", "--seconds", "0.5",
                       "--trace", str(trace)], root=root, require_card=False)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture
def tiny(checkout):
    add_tiny_cells(checkout)
    return checkout


def state_unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    import meshdqn_tpu_torch.solver.ipcs as ipcs

    step = ipcs.fused_step
    monkeypatch.setattr(ipcs, "fused_step", lambda dev, s: (s, step(dev, s)[1]))


def answer_altered(monkeypatch):
    """An answer altered where it is produced: the drag probe's value 5%
    high and the lift's sign flipped."""
    import meshdqn_tpu_torch.solver.ipcs as ipcs

    step = ipcs.fused_step

    def altered(dev, s):
        new, (d, l) = step(dev, s)
        return new, (1.05 * d, -l)

    monkeypatch.setattr(ipcs, "fused_step", altered)


def test_unbroken_path_is_correct(tiny):
    torch.set_num_threads(2)
    result = run_once(tiny, "tiny-solo")
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"flow_steps_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [state_unchanged, answer_altered])
def test_fault_is_not_correct(tiny, monkeypatch, fault):
    torch.set_num_threads(2)
    fault(monkeypatch)
    result = run_once(tiny, "tiny-solo")
    assert not result["correct"] and result["failed"] > 0


def test_traced_run_reports_per_layer_metrics_it_can_read(tiny):
    """On the CPU the profile holds no device events and the CPU has no
    peaks: only the host's issue time is read, and `correct` still holds."""
    torch.set_num_threads(2)
    result = run_once(tiny, "tiny-solo", trace=1)
    assert result["correct"]
    assert set(result["metrics"]) == {"host_issue_ms_per_step"}
    assert len(result["breakdown"]["device_ops"]) <= 10

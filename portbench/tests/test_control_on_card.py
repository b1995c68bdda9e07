"""On the card, at the cell's own size: the control (the reference in the
program's place with TF32 products) comes out not correct, and the program
correct, under the cell's limits.  Run on the card with

    python -m pytest -p no:cacheprovider portbench/tests/test_control_on_card.py
"""
import json

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_where_the_program_holds(cuda, workload):
    from portbench import check, control, harness

    cell = harness.load_cell(ROOT, workload)
    (row,) = control.readings(cell, [2147483711], 1, cuda, emit=lambda r: None)
    limits = harness.limits(cell)
    assert check.verdict(row["program"], limits)[0]
    assert not check.verdict(row["control"], limits)[0]

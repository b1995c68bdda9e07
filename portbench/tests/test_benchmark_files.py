"""BENCHMARK.json and every file it names load, keep to the contract's
characters and limits, and a new file is found by its name alone."""
import hashlib
import json
import re
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, add_entries

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = BENCH["workloads"][0]["name"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert {m["name"] for m in BENCH["end_to_end"]} == {"flow_steps_per_s", "setup_s"}


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_one_line_texts(kind):
    entries = BENCH[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if kind == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] == 1


def test_configs_load_with_frozen_meshes():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and c["reduced"] == []
        for mesh_set in cfg["mesh_sets"].values():
            for m in mesh_set["meshes"]:
                with np.load(ROOT / m["file"]) as z:
                    coords = np.ascontiguousarray(z["coords"], dtype=np.float64)
                    cells = np.ascontiguousarray(z["cells"], dtype=np.int32)
                digest = hashlib.sha256(coords.tobytes() + cells.tobytes()).hexdigest()
                assert digest == m["sha256"] and len(coords) == m["vertices"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_part_of_a_cell_is_found(workload):
    from portbench import harness

    cell = harness.load_cell(ROOT, workload)
    tr = cell.traffic
    assert callable(harness.part(cell, "drivers", tr["driver"]).Driver)
    assert callable(harness.part(cell, "counts", tr["counts"]).step_counts)
    assert set(harness.limits(cell)) >= {"drag_gap", "lift_gap", "state_gap"}
    for m in cell.per_layer:
        assert m["moves"] == "flow_steps_per_s"
        assert callable(harness.part(cell, "metrics", m["name"]).read)


def test_a_traffic_file_added_in_a_copy_is_found_by_name(checkout):
    """So are a driver and a per-layer metric reader added as files."""
    from portbench import harness

    first = BENCH["workloads"][0]
    tr = json.loads((checkout / f"portbench/traffic/{first['traffic']}.json").read_text())
    driver = checkout / f"portbench/drivers/{tr['driver']}.py"
    tr["perturbation"] = 0.02
    tr["driver"] = "solo_copy"
    (checkout / "portbench/traffic/strong.json").write_text(json.dumps(tr))
    (checkout / "portbench/drivers/solo_copy.py").write_text(driver.read_text())
    (checkout / "portbench/metrics/flows_seen.py").write_text(
        "def read(ctx):\n    return ctx['flows']\n")
    (checkout / "portbench/limits/ys930-strong.json").write_text(
        (checkout / f"portbench/limits/{first['name']}.json").read_text())
    add_entries(checkout, workloads=[{"name": "ys930-strong", "config": first["config"],
                                      "traffic": "strong", "chips": 1, "why": "test"}],
                per_layer=[{"name": "flows_seen", "unit": "flows", "better": "higher",
                            "source": "program_counter", "layer": "entry",
                            "moves": "flow_steps_per_s", "workloads": ["ys930-strong"]}])
    cell = harness.load_cell(checkout, "ys930-strong")
    assert cell.traffic["perturbation"] == 0.02
    assert cell.mesh_set == harness.load_cell(checkout, first["name"]).mesh_set
    assert {m["name"] for m in cell.per_layer} >= {"step_mfu", "device_idle_share"}
    assert not any(m["name"].startswith("kernel_roofline") for m in cell.per_layer)
    assert "flows_seen" in {m["name"] for m in cell.per_layer}
    assert harness.part(cell, "metrics", "flows_seen").read({"flows": 1}) == 1
    assert callable(harness.part(cell, "drivers", cell.traffic["driver"]).Driver)


def test_run_fails_cleanly_without_a_card():
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELL, "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_run_fails_without_the_program(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from pathlib import Path; sys.path.insert(0, '.'); "
            "import portbench.run as r; sys.exit(r.main(['--workload', "
            f"'{CELL}', '--seed', '1', '--seconds', '1', '--trace', '0'], "
            "root=Path('.').resolve(), require_card=False))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "meshdqn_tpu_torch" in p.stderr

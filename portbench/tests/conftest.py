"""Fixtures of the benchmark's tests: the card, and a checkout root built in
a temporary directory (a copy of BENCHMARK.json and portbench/, the
program linked in) to which a test can add files."""
import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "meshdqn_tpu_torch").symlink_to(ROOT / "meshdqn_tpu_torch")
    return tmp_path


def add_entries(root: Path, **entries) -> None:
    """Append entries to lists of root's BENCHMARK.json."""
    path = root / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    for key, items in entries.items():
        bench[key].extend(items)
    path.write_text(json.dumps(bench, indent=1))


def add_tiny_cells(root: Path) -> None:
    """Add a cell a CPU can run in seconds: one flow on the coarsest sweep
    mesh, padded as the sweep pads, 10 steps a solve, with the traffic and
    the limits of the benchmark's first cell."""
    pb = root / "portbench"
    first = json.loads((root / "BENCHMARK.json").read_text())["workloads"][0]
    cfg = json.loads((pb / "configs" / f"{first['config']}.json").read_text())
    cfg.update(name="tiny", mesh_sets={"one": {
        "meshes": [{"file": "meshdqn_tpu_torch/data/ys930_0.30000_gen.npz"}],
        "solver": {"precision": "f32", "fused": True, "pad_quantum": 768}}})
    cfg["flow"].update(solver_steps=10, save_steps=5)
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / f"{first['traffic']}.json").read_text())
    tr.update(mesh_set="one", warm_steps=2, issue_chunks=3, profile_steps=5)
    (pb / "traffic" / "tiny-solo.json").write_text(json.dumps(tr))
    (pb / "limits" / "tiny-solo.json").write_text(
        (pb / "limits" / f"{first['name']}.json").read_text())
    add_entries(root, configs=[{"name": "tiny", "source": "test", "reduced": [],
                                "file": "portbench/configs/tiny.json", "why": "test"}],
                workloads=[{"name": "tiny-solo", "config": "tiny", "traffic": "tiny-solo",
                            "chips": 1, "why": "test"}])

"""The counts of bytes and operations come from the unpadded shapes; the
import guard compares top-level names whole; the reference loads nothing
of JAX, the JAX package or the program."""
import json
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT


PACK = "checkpoints/ys930_results/ground_truth.npz"


def shapes(mesh_file):
    from portbench.reference.fem import Mesh

    with np.load(ROOT / mesh_file) as z:
        m = Mesh(z["coords"], z["cells"])
    return m.ns, m.nv


def mesh_set_files(config, mesh_set):
    cfg = json.loads((ROOT / f"portbench/configs/{config}.json").read_text())
    return [m["file"] for m in cfg["mesh_sets"][mesh_set]["meshes"]]


@pytest.mark.parametrize("files, megabytes", [
    # PERF.md section 3: the fused f32 step's operators on the two pack meshes
    (["checkpoints/ys930_results/ground_truth.npz"], 470.2),
    (["checkpoints/ah93w145_results/ground_truth.npz"], 389.8),
    (mesh_set_files("ys930", "fine"), 1457.9),     # the finest fused ys930 sweep row
])
def test_operator_bytes_of_the_meshes(files, megabytes):
    from portbench.counts.fused import F32, operator_entries

    total = sum(F32 * sum(operator_entries(*shapes(f)).values()) for f in files)
    assert round(total / 1e6, 1) == megabytes


@pytest.mark.parametrize("workload, mesh_set, megabytes", [
    ("ys930-fine-solo", "fine", 1458.4),        # 1457.9 MB of operators and the vectors
])
def test_counts_ignore_pad_quantum(checkout, workload, mesh_set, megabytes):
    """The harness counts from the meshes alone: padding the solver more or
    less leaves the yardstick where it was."""
    from portbench import harness
    from portbench.counts.fused import step_counts

    path = checkout / "portbench/configs/ys930.json"
    seen = set()
    for q in (0, 768, 1536):
        cfg = json.loads(path.read_text())
        cfg["mesh_sets"][mesh_set]["solver"]["pad_quantum"] = q
        path.write_text(json.dumps(cfg))
        cell = harness.load_cell(checkout, workload)
        assert cell.mesh_set["solver"]["pad_quantum"] == q
        seen.add(sum(step_counts(*shapes(m["file"]))[0] for m in cell.mesh_set["meshes"]))
    assert len(seen) == 1
    assert round(seen.pop() / 1e6, 1) == megabytes


def test_least_time_is_bound_by_bytes():
    from portbench.counts.fused import least_seconds, step_counts

    peaks = json.loads((ROOT / "portbench/peaks.json").read_text())["NVIDIA H100 80GB HBM3"]
    nbytes, ops = step_counts(*shapes(PACK))
    assert least_seconds(nbytes, ops, peaks) == nbytes / 3.35e12
    assert abs(nbytes / 3.35e12 - 0.1404e-3) < 1e-6


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run

    for name in ("meshdqn_tpu_torch", "meshdqn_tpu_torch.solver", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "meshdqn_tpu.solver", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["jaxlib", "meshdqn_tpu"]


def test_reference_imports_neither_jax_nor_either_package():
    code = ("import sys; import portbench.reference.ipcs, portbench.reference.fem, "
            "portbench.counts.fused, portbench.check; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120, check=True)
    top = set(p.stdout.split())
    assert "torch" in top and "portbench" in top
    assert not top & {"jax", "jaxlib", "flax", "meshdqn_tpu", "meshdqn_tpu_torch"}


def test_metric_readers_on_a_synthetic_profile():
    """Every reader under portbench/metrics on a made-up profile of 10 steps
    of a ys930 pack step: the kernel shares and the step's share from the
    counts, the rest from the events; a reader with nothing to read gives
    None, never 0."""
    from portbench import harness
    from portbench.counts import fused

    peaks = json.loads((ROOT / "portbench/peaks.json").read_text())["NVIDIA H100 80GB HBM3"]
    ns, npr = shapes(PACK)
    step_s = fused.least_seconds(*fused.kernel_counts(ns, npr), peaks)
    ctx = {
        "issue_s_per_step": 4e-4, "wall_s_per_step": 5e-4,
        "profile": {"steps": 10, "window_s": 5e-3, "busy_s": 2e-3,
                    "by_name": {"void group_kernel<UStar>(Group)": 8 * step_s,
                                "void at::native::index_kernel<4>()": 1e-4}},
        "port_kernels": {"group_kernel"},
        "step_counts": fused.step_counts(ns, npr),
        "kernel_counts": fused.kernel_counts(ns, npr),
        "least_seconds": lambda c: fused.least_seconds(*c, peaks),
    }
    got = {p.stem: harness.load_module(p).read(ctx)
           for p in sorted((ROOT / "portbench/metrics").glob("*.py"))}
    assert got["host_issue_ms_per_step"] == pytest.approx(0.4)
    assert got["torch_ops_device_ms_per_step"] == pytest.approx(0.01)
    assert got["device_idle_share"] == pytest.approx(60.0)
    assert got["kernel_roofline.group_kernel"] == pytest.approx(125.0)
    assert 0 < got["step_mfu"] < 100
    ctx["profile"]["by_name"] = {}
    ctx["profile"]["busy_s"] = 0.0
    assert all(harness.load_module(ROOT / f"portbench/metrics/{m}.py").read(ctx) is None
               for m in ("kernel_roofline.group_kernel", "device_idle_share",
                         "torch_ops_device_ms_per_step"))

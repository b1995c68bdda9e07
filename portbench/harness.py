"""The general harness: one cell of BENCHMARK.json, run once.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric sits in a file of its own, found by the name that
BENCHMARK.json gives:

  configs     the file that a `configs` entry names (JSON: flow settings
              and mesh sets)
  traffic     portbench/traffic/<traffic>.json: the driver, the counts, the
              configuration's mesh set and the mix's parameters
  drivers     portbench/drivers/<driver>.py: builds the program's solver and
              runs one whole solve from given initial velocities
  counts      portbench/counts/<counts>.py: bytes and operations of a step
  metrics     portbench/metrics/<metric>.py: read(ctx) -> value or None
  limits      portbench/limits/<workload>.json: the limit of each number
              that decides `correct`

A run: set-up (imports, the program's solver, a short warm solve), then the
window: whole solves back to back, each from rest plus the seed's
perturbation, each ending with its drags and lifts on the host; the window
closes at the end of the first solve that ends past `seconds`, so the rate
counts every step and every second of it.  With trace, the host's issue
time and a profiled stretch of steps follow.  Then the program is freed and
the plain reference recomputes a sample of the window's solves drawn from
the seed.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import check, devtrace
from .reference.fem import Mesh
from .reference.ipcs import ReferenceFlow

HERE = Path(__file__).resolve().parent
WARM = 2**32  # the warm solve's index among the seed's inputs


@dataclass
class Cell:
    root: Path
    workload: dict
    config: dict
    traffic: dict
    mesh_set: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(root=root, workload=w, config=config, traffic=traffic,
                mesh_set=config["mesh_sets"][traffic["mesh_set"]],
                end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if applies(m, workload)])


def load_module(path: Path):
    """A module from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def part(cell: Cell, kind: str, name: str):
    return load_module(cell.root / "portbench" / kind / f"{name}.py")


def limits(cell: Cell) -> dict:
    return json.loads((cell.root / "portbench" / "limits" / f"{cell.name}.json").read_text())


def meshes(cell: Cell) -> list:
    out = []
    for m in cell.mesh_set["meshes"]:
        with np.load(cell.root / m["file"]) as z:
            out.append((z["coords"], z["cells"]))
    return out


class Inputs:
    """The seed's initial velocities: solve i, flow b starts from rest plus
    amplitude * N(0, 1) at every velocity dof, drawn from (seed, i, b).
    Every seed gives every solve the same sizes, so the same work."""

    def __init__(self, seed: int, amplitude: float, ns: list, n_u: int):
        self.seed = seed % 2**64
        self.amplitude, self.ns, self.n_u = amplitude, ns, n_u

    def plain(self, i: int) -> list:
        """Per flow, the velocity (2 Ns,) in the reference's layout."""
        return [self.amplitude
                * np.random.default_rng([self.seed, i, b]).standard_normal(2 * ns)
                for b, ns in enumerate(self.ns)]

    def program(self, i: int) -> np.ndarray:
        """(flows, n_u): the same velocities in the program's layout."""
        return np.stack([check.embed_u(u, self.n_u) for u in self.plain(i)])


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device) -> dict:
    """The card's name, count and power limit (nvidia-smi), as reported
    with every device number."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        limit = ""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "power_limit_w": float(limit) if limit else None}


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, device, t0: float,
        log=print) -> dict:
    """One run of the cell; returns the result line's object."""
    tr = cell.traffic
    mesh_list = meshes(cell)
    ns = [Mesh(c, t).ns for c, t in mesh_list]
    nps = [len(c) for c, _ in mesh_list]

    # ---- set-up: the program's solver and a short warm solve
    log(f"set-up: {time.perf_counter() - t0:.3f} s to the program's build")
    driver = part(cell, "drivers", tr["driver"]).Driver(cell.config, cell.mesh_set,
                                                         mesh_list, device)
    sync(device)
    log(f"set-up: {time.perf_counter() - t0:.3f} s with the program built")
    inputs = Inputs(seed, tr["perturbation"], ns, driver.n_u)
    warm = tr["warm_steps"]
    driver.solve(inputs.program(WARM), steps=2 * warm, save_steps=warm)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the window
    t_start = time.perf_counter()
    setup_s = t_start - t0
    kept, ends = [], []
    while True:
        i = len(kept)
        d, l, u, p = driver.solve(inputs.program(i))
        kept.append((d, l, u, p))
        window_s = time.perf_counter() - t_start
        ends.append(window_s)
        if window_s >= seconds:
            break
    solves = len(kept)
    flow_steps = solves * driver.steps * driver.flows
    log(f"window: {solves} solves of {driver.flows} flow(s) x {driver.steps} steps "
        f"in {window_s:.3f} s; set-up {setup_s:.3f} s; each solve's s: "
        + " ".join(f"{b - a:.3f}" for a, b in zip([0.0] + ends, ends)))

    metrics, extra = {}, {}
    info = card(device)
    if trace_on:
        ctx = traced(cell, driver, inputs, solves, window_s, ns, nps, info, device, log)
        for m in cell.per_layer:
            value = part(cell, "metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        prof = ctx["profile"]
        info["busy_s"], info["window_s"] = prof["busy_s"], prof["window_s"]
        extra["breakdown"] = {"device_ops": devtrace.top_ops(prof["by_name"]),
                               "idle_gaps": prof["idle_gaps"]}
    else:
        values = {"flow_steps_per_s": flow_steps / window_s, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)

    # ---- the comparison, once the program's state is freed
    rng = np.random.default_rng([seed % 2**64, 1])
    picks = sorted(rng.choice(solves, size=min(tr["compared_solves"], solves),
                              replace=False).tolist())
    program = {(i, b): (kept[i][0][b], kept[i][1][b], kept[i][2][b].cpu().numpy(),
                        kept[i][3][b].cpu().numpy())
               for i in picks for b in range(driver.flows)}
    attempted = solves * driver.flows
    del kept, driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_outputs(cell, picks, inputs, mesh_list, device)
    readings = [check.gaps(program[k], ref[k]) for k in program]
    log(f"reference: solves {picks} in {time.perf_counter() - t_ref:.3f} s")
    lim = limits(cell)
    correct, checks = check.verdict(check.worst(readings), lim)
    failed = sum(not check.verdict(r, lim)[0] for r in readings)
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": info, **extra, "checks": checks}


def reference_outputs(cell, picks, inputs: Inputs, mesh_list, device) -> dict:
    """{(solve, flow): (drags, lifts, u, p)} of the plain float64 reference
    from the solves' initial velocities, one flow's operators on the device
    at a time."""
    flow = cell.config["flow"]
    out = {}
    for b, (coords, cells) in enumerate(mesh_list):
        ref = ReferenceFlow(coords, cells, mu=flow["mu"], rho=flow["rho"],
                            dt=flow["dt"], device=device)
        for i in picks:
            out[i, b] = ref.solve(inputs.plain(i)[b], flow["solver_steps"])
        del ref
    return out


def traced(cell, driver, inputs, solves, window_s, ns, nps, info, device, log) -> dict:
    """The host's issue time and one profiled stretch of steps, with what
    the metric readers need beside them."""
    tr = cell.traffic
    counts = part(cell, "counts", tr["counts"])
    # The chip's published peaks; a device not listed (or the CPU) has none,
    # and the shares of a peak are then not read.
    peaks = json.loads((HERE / "peaks.json").read_text()).get(info["kind"])
    driver.start(inputs.program(solves))
    chunk, issue = tr["issue_chunk_steps"], 0.0
    for _ in range(tr["issue_chunks"]):
        sync(device)
        a = time.perf_counter()
        driver.advance(chunk)
        issue += time.perf_counter() - a
    sync(device)
    n = tr["profile_steps"]
    prof = devtrace.profile(lambda: driver.advance(n), device)
    log(f"profile: {n} steps, {prof['device_events']} device events, busy "
        f"{prof['busy_s']:.6f} of {prof['window_s']:.6f} s on {info['kind']} at "
        f"{info.get('power_limit_w')} W")
    add = lambda pairs: tuple(map(sum, zip(*pairs)))
    return {
        "flows": driver.flows,
        "wall_s_per_step": window_s / (solves * driver.steps),
        "issue_s_per_step": issue / (chunk * tr["issue_chunks"]),
        "issue_chunk_steps": chunk,
        "profile": {**prof, "steps": n},
        "port_kernels": devtrace.port_kernels(cell.root),
        "step_counts": add(counts.step_counts(a, b) for a, b in zip(ns, nps)),
        "kernel_counts": add(counts.kernel_counts(a, b) for a, b in zip(ns, nps)),
        "least_seconds": lambda c: peaks and counts.least_seconds(*c, peaks),
    }

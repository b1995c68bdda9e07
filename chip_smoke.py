#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

The main path is the transient flow solve: the port's IPCSSolver, fused f32
path, 5000 steps on each of the two airfoil packs in checkpoints/.  Every
dense operator apply goes through the hand-written matvec kernel
(meshdqn_tpu_torch/csrc/matvec.cu), which is built from source at first use.

Phases, one JSON line each (any failure raises and the script exits non-zero
without the final line):

  device   nvidia-smi's name and power limit, the device name, and the
           device-memory and f32 peaks used for the bounds (null if unknown)
  build    nvcc of the kernel source
  kernels  each kernel at each main-path shape of both packs: held against
           its plain torch version (||y - plain|| / ||plain|| within
           2 sqrt(N) 2^-24, while the plain version on TF32- and
           bf16-rounded inputs, and the dual form without x_lo, must fall
           outside it), run twice for identical bits, and timed (CUDA
           events, median of 25, L2 flushed before each launch) beside its
           bound, the plain version and one torch.matmul call
  solve    per pack: set-up time, a 100-step warm-up from a random state,
           then solve(5000, save_steps=1000) from rest with the launch
           counters zeroed; drag/lift against the pack's f64 values (final
           values within 1e-3 relative, asserted), ms per step, achieved
           operator bandwidth
  profile  50 steps unprofiled, then under torch.profiler: device busy share
           and time by kernel
  f64      per pack: the same 5000 steps in f64 through the plain products,
           snapshot by snapshot beside the pack's values and the f32 run

then the kernels summary line, nvidia-smi's line, and the result line.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PACKS = ("ys930", "ah93w145")
STEPS, SAVE = 5000, 1000
GATE = 1e-3  # drag/lift relative error against the f64 oracle
# Device-memory rate (bytes/s) and f32 non-tensor-core rate (flop/s) by
# card, from NVIDIA's data sheets.  Unknown cards get no bound.
PEAKS = {
    "H100 PCIe": (2.0e12, 51.2e12),
    "H100 NVL": (3.9e12, 60.0e12),
    "H100 80GB HBM3": (3.35e12, 66.9e12),  # the SXM part
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    return None, None


def time_ms(fn, flush, reps=25):
    """Median device time of fn() over reps launches, each started with the
    L2 cache flushed (the step streams ~0.4 GB through a 50 MB L2, so every
    operator arrives cold).  A spin of ~0.1 ms on the device before each
    start event lets the host enqueue the launch before the device reaches
    it, so host-side wrapper time stays out of the measurement."""
    fn()
    pairs = []
    for _ in range(reps):
        flush.sum()  # reads evict L2 without leaving dirty lines behind
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def pack_shapes(ns: int, npr: int):
    """The fused step's seven dense applies: (operator, R, N, k)."""
    n1 = 2 * ns
    return [("F1u", n1, n1, 1), ("A1Z", n1, n1, 1), ("F1p", n1, npr, 1),
            ("F3p", n1, npr, 1), ("F2u", npr, n1, 1), ("F2p", npr, npr, 1),
            ("F3s", ns, ns, 2)]


def load_pack(name):
    from meshdqn_tpu_torch.mesh import TriMesh

    d = os.path.join(REPO, "checkpoints", f"{name}_results")
    z = np.load(os.path.join(d, "ground_truth.npz"))
    with open(os.path.join(d, "ground_truth_meta.json")) as f:
        meta = json.load(f)
    return TriMesh(z["coords"], z["cells"]), z, meta


def check_kernels(cuda, meshes, mem_peak, flop_peak, flush):
    from meshdqn_tpu_torch.ops import matvec as mv

    summary = {}
    for kname, kernel, plain, library in (
        ("matvec", lambda m, x, lo: mv.matvec(m, x),
         lambda m, x, lo: mv.matvec_reference(m, x),
         lambda m, x, lo, x2: torch.matmul(m, x)),
        # One torch call that streams m once for both words: m @ [x_hi x_lo].
        ("matvec_dual", mv.matvec_dual, mv.matvec_dual_reference,
         lambda m, x, lo, x2: torch.matmul(m, x2)),
    ):
        dual = kname == "matvec_dual"
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        worst, by_bytes = 0.0, True
        seen = {}
        for pack, mesh in meshes.items():
            ns, npr = mesh.num_vertices + mesh.num_edges, mesh.num_vertices
            for op, R, N, k in pack_shapes(ns, npr):
                key = (R, N, k)
                if key not in seen:
                    g = torch.Generator(device=cuda).manual_seed(R * 131 + N * 7 + k)
                    M = torch.randn(R, N, device=cuda, generator=g)
                    X = torch.randn((N,) if k == 1 else (N, k), device=cuda, generator=g)
                    # x_lo is a draw of its own at ~2^-8 of x_hi, so a dual
                    # kernel that drops it moves y far past the tolerance.
                    lo = 2.0**-8 * X.abs() * torch.randn(X.shape, device=cuda, generator=g)
                    X2 = torch.cat([X.view(N, -1), lo.view(N, -1)], dim=1)
                    y = kernel(M, X, lo)
                    torch.cuda.synchronize()
                    if not torch.equal(y, kernel(M, X, lo)):
                        raise AssertionError(f"{kname} {key}: bits differ between runs")
                    yp = plain(M, X, lo)
                    tol = mv.gap_tolerance(N)
                    gap = mv.relative_gap(y, yp)
                    if not gap <= tol:
                        raise AssertionError(f"{kname} {key}: ||y - plain|| / ||plain|| "
                                             f"= {gap:.3g} above {tol:.3g}")
                    # Controls: the plain version on inputs rounded to TF32 and
                    # to bf16 (and, for the dual form, with x_lo dropped) must
                    # fail the same check, or the check proves nothing.
                    controls = {
                        f"control_{name}_gap": mv.relative_gap(plain(
                            mv.round_mantissa(M, bits), mv.round_mantissa(X, bits),
                            mv.round_mantissa(lo, bits)), yp)
                        for name, bits in (("tf32", 10), ("bf16", 7))
                    }
                    if dual:
                        controls["control_drop_lo_gap"] = mv.relative_gap(
                            mv.matvec_reference(M, X), yp)
                    if not min(controls.values()) > tol:
                        raise AssertionError(f"{kname} {key}: a control passes the "
                                             f"check: {controls}")
                    nx = 2 if dual else 1
                    nbytes = 4 * (R * N + nx * N * k + R * k)
                    flops = 2 * R * N * k * nx
                    t_bytes = nbytes / mem_peak * 1e3 if mem_peak else None
                    t_ops = flops / flop_peak * 1e3 if flop_peak else None
                    row = {
                        "phase": "kernels", "kernel": kname, "R": R, "N": N, "k": k,
                        "rel_gap": gap, "tol": tol, **controls,
                        "max_abs_err": (y - yp).abs().max().item(),
                        "kernel_ms": time_ms(lambda: kernel(M, X, lo), flush),
                        "plain_ms": time_ms(lambda: plain(M, X, lo), flush),
                        "library_ms": time_ms(lambda: library(M, X, lo, X2), flush),
                        "bound_ms": None if t_bytes is None else max(t_bytes, t_ops),
                        "bound_by": None if t_bytes is None else
                        ("bytes" if t_bytes >= t_ops else "operations"),
                    }
                    if row["bound_ms"]:
                        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
                    emit(row)
                    seen[key] = row
                    worst = max(worst, row["max_abs_err"])
                    del M, X, lo, X2
                if pack == PACKS[0]:
                    # Summary: the seven applies of one ys930 step.
                    row = seen[key]
                    tot["ms"] += row["kernel_ms"]
                    tot["plain_ms"] += row["plain_ms"]
                    tot["library_ms"] += row["library_ms"]
                    if row["bound_ms"] is not None:
                        tot["bound_ms"] += row["bound_ms"]
                        by_bytes &= row["bound_by"] == "bytes"
                    else:
                        tot["bound_ms"] = None
        summary[kname] = dict(tot, max_abs_err=worst,
                              bound_by=("bytes" if by_bytes else "operations")
                              if tot["bound_ms"] is not None else None)
    emit({"phase": "kernels", "checked": list(summary)})
    return summary


def solve_pack(cuda, name, mesh, z, meta, mem_peak):
    from meshdqn_tpu_torch.ops import matvec as mv
    from meshdqn_tpu_torch.solver import FlowState, IPCSConfig, IPCSSolver

    cfg = IPCSConfig(mu=meta["mu"], rho=meta["rho"], dt=meta["dt"], precision="f32")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = IPCSSolver(mesh, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if solver.device.type != "cuda":
        raise AssertionError(f"solver landed on {solver.device}")

    g = torch.Generator(device=cuda).manual_seed(0)
    warm = FlowState(
        u=1e-3 * torch.randn(solver.ndofs_u, device=cuda, generator=g),
        p=torch.zeros(solver.ndofs_p, device=cuda),
    )
    solver.evolve(warm, 100)
    torch.cuda.synchronize()

    mv.matvec.launches = 0
    mv.matvec_dual.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = solver.solve(STEPS, save_steps=SAVE)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = {"matvec": mv.matvec.launches, "matvec_dual": mv.matvec_dual.launches}
    if launches["matvec"] != 7 * STEPS:
        raise AssertionError(f"matvec launched {launches['matvec']} times, "
                             f"expected {7 * STEPS}")

    st = out["state"]
    if st.u.shape != (solver.ndofs_u,) or st.p.shape != (solver.ndofs_p,):
        raise AssertionError("state has the wrong shape")
    if not (torch.isfinite(st.u).all() and torch.isfinite(st.p).all()
            and torch.isfinite(out["drags"]).all() and torch.isfinite(out["lifts"]).all()):
        raise AssertionError("non-finite values in the solve")
    derr = np.abs(out["snap_drags"] / z["gt_drag"] - 1)
    lerr = np.abs(out["snap_lifts"] / z["gt_lift"] - 1)

    ms = start.elapsed_time(end) / STEPS
    ns, npr = mesh.num_vertices + mesh.num_edges, mesh.num_vertices
    op_bytes = sum(4 * R * N for _, R, N, _ in pack_shapes(ns, npr))
    # Everything the step reads once: operators, vectors, convection tables.
    leaves = [*solver.dev._replace(conv=None), *vars(solver.dev.conv).values()]
    step_bytes = sum(t.numel() * t.element_size() for t in leaves
                     if isinstance(t, torch.Tensor))
    gbs = step_bytes / (ms * 1e-3) / 1e9
    row = {
        "phase": "solve", "pack": name, "vertices": npr, "ndofs_u": 2 * ns,
        "setup_s": setup_s,
        "ms_per_step": ms, "host_ms_per_step": host_s * 1e3 / STEPS,
        "operator_MB_per_step": op_bytes / 1e6,
        "step_MB": step_bytes / 1e6,
        "achieved_GB_s": gbs,
        "share_of_peak": gbs * 1e9 / mem_peak if mem_peak else None,
        "launches": launches,
        "snap_drags": out["snap_drags"].tolist(),
        "snap_lifts": out["snap_lifts"].tolist(),
        "drag_rel_err": derr.tolist(), "lift_rel_err": lerr.tolist(),
        "jax_f32_level": {"ys930": [1.6e-5, 2.6e-4],
                          "ah93w145": [3.4e-5, 1.0e-4]}.get(name),
    }
    emit(row)
    if not (derr[-1] < GATE and lerr[-1] < GATE):
        raise AssertionError(f"{name}: final drag/lift error {derr[-1]:.3g} / "
                             f"{lerr[-1]:.3g} above {GATE}")
    return solver, st, launches, row


def solve_f64(cuda, name, mesh, z, meta, f32_row):
    """The same 5000 steps from rest in f64, every dense product through the
    plain version (the kernel is f32 only): it separates the f32 step's
    rounding from any bias of the port's discretisation."""
    from meshdqn_tpu_torch.ops.matvec import matvec_reference
    from meshdqn_tpu_torch.solver import (FlowState, IPCSConfig,
                                          build_fused_operators, fused_step)

    cfg = IPCSConfig(mu=meta["mu"], rho=meta["rho"], dt=meta["dt"], precision="f32")
    dev, nu, npr, _ = build_fused_operators(mesh, cfg, device=cuda,
                                            dtype=torch.float64)
    state = FlowState(u=torch.zeros(nu, dtype=torch.float64, device=cuda),
                      p=torch.zeros(npr, dtype=torch.float64, device=cuda))
    drags = torch.empty(STEPS, dtype=torch.float64, device=cuda)
    lifts = torch.empty_like(drags)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(STEPS):
        state, (d, l) = fused_step(dev, state, apply=matvec_reference)
        drags[i] = d
        lifts[i] = l
    end.record()
    torch.cuda.synchronize()
    sd = drags.view(-1, SAVE)[:, -1].cpu().numpy()
    sl = lifts.view(-1, SAVE)[:, -1].cpu().numpy()
    if not (np.isfinite(sd).all() and np.isfinite(sl).all()):
        raise AssertionError(f"{name}: non-finite values in the f64 solve")
    derr = np.abs(sd / z["gt_drag"] - 1)
    lerr = np.abs(sl / z["gt_lift"] - 1)
    emit({
        "phase": "f64", "pack": name, "ms_per_step": start.elapsed_time(end) / STEPS,
        "snap_drags": sd.tolist(), "snap_lifts": sl.tolist(),
        "drag_rel_err": derr.tolist(), "lift_rel_err": lerr.tolist(),
        # The f32 kernel run against this f64 run, snapshot by snapshot.
        "f32_drag_rel_to_f64": np.abs(np.asarray(f32_row["snap_drags"]) / sd - 1).tolist(),
        "f32_lift_rel_to_f64": np.abs(np.asarray(f32_row["snap_lifts"]) / sl - 1).tolist(),
    })
    if not (derr[-1] < GATE and lerr[-1] < GATE):
        raise AssertionError(f"{name}: f64 final drag/lift error {derr[-1]:.3g} / "
                             f"{lerr[-1]:.3g} above {GATE}")


def profile_steps(solver, state, n=50):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # The same n steps first without the profiler, for its wall time.
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    solver.evolve(state, n)
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.evolve(state, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        # Device-side events only: a CPU op also carries the device time of
        # the kernels it launched, which would count them twice.
        if ev.device_type != DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + t / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # device_busy_share is measured in the profiled window, where the
    # profiler also slows the host; busy over the unprofiled wall time of
    # the same steps, just before, is an estimate across two windows.
    unprofiled_ms = start.elapsed_time(end)
    emit({"phase": "profile", "steps": n, "wall_ms_per_step": wall_ms / n,
          "unprofiled_wall_ms_per_step": unprofiled_ms / n,
          "device_busy_ms_per_step": busy / n if busy else None,
          "device_busy_share": busy / wall_ms if busy else None,
          "busy_over_unprofiled_wall": busy / unprofiled_ms if busy else None,
          "top_ms_per_step": {k[:80]: v / n for k, v in top}})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import meshdqn_tpu_torch  # noqa: F401  (sets f32 matmul precision)
    from meshdqn_tpu_torch.ops import build

    cuda = torch.device("cuda", torch.cuda.current_device())
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    mem_peak, flop_peak = peaks(kind)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "mem_peak_B_s": mem_peak,
          "f32_peak_flop_s": flop_peak})

    t0 = time.perf_counter()
    build.load("matvec")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": ["meshdqn_tpu_torch/csrc/matvec.cu"]})

    packs = {name: load_pack(name) for name in PACKS}
    flush = torch.empty(64 * 2**20 // 4, device=cuda)  # > the 50 MB L2
    summary = check_kernels(cuda, {n: p[0] for n, p in packs.items()},
                            mem_peak, flop_peak, flush)
    del flush

    launches = {"matvec": 0, "matvec_dual": 0}
    rows, last = {}, None
    for name, (mesh, z, meta) in packs.items():
        solver, state, counted, rows[name] = solve_pack(cuda, name, mesh, z, meta,
                                                        mem_peak)
        for k in launches:
            launches[k] += counted[k]
        if last is None:
            last = (solver, state)
        del solver, state
    profile_steps(*last)
    del last
    for name, (mesh, z, meta) in packs.items():
        solve_f64(cuda, name, mesh, z, meta, rows[name])

    src = "meshdqn_tpu_torch/csrc/matvec.cu"
    replaces = {"matvec": "meshdqn_tpu/ops/pallas_kernels.py:124",
                "matvec_dual": "meshdqn_tpu/ops/pallas_kernels.py:134"}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": launches[k], "on_main_path": k == "matvec",
         "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
         "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
         "library_ms": s["library_ms"],
         "note": "ms, plain_ms, bound_ms and library_ms are sums over the "
                 "seven applies of one ys930 step"}
        for k, s in summary.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

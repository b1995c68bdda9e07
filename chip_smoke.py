#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--diag]

The paths, each driven through IPCSSolver, the entry point a user calls:

* the fused f32 solve, 5000 steps on each of the two airfoil packs in
  checkpoints/, each step three launches of the matvec kernel's grouped
  form (meshdqn_tpu_torch/csrc/matvec.cu: the seven dense applies and the
  elementwise work around them);
* the other dense modes on both packs, 5000 steps each: 'f64' (the
  default IPCSConfig(), the unfused step: f64 inverses through
  torch.matmul, 6 ELL launches a step), 'mixed' (5 single matvec and 8 ELL
  launches a step), f32 with fused=False (3 and 6) and 'df32' (three
  launches of the matvec kernel's split form: f32 high and bf16 low limbs);
* the large-mesh CG solve at the production config (f32, banded layout,
  block-Jacobi PCG, 6 / 5 iterations), 5000 steps on the finest generated
  mesh of each airfoil (meshdqn_tpu_torch/data/*.npz), every sparse product
  through the banded kernel (csrc/banded.cu) or the ELL kernel
  (csrc/ell.cu);
* the ensemble (solver.ensemble.EnsembleFlows): 16 inflow amplitudes on
  the ys930 pack mesh, 5000 steps, each step seven launches of the matvec
  kernel's k-column form (16 columns, F3s 32);
* the batched flows (solver.batch.BatchedFlows, scripts/make_sweep.py's
  sweep): the ys930 pack mesh and four decimations of it, 5000 steps, each
  step three launches of the grouped form's batched instance;
* greedy deployment (deploy.Deployer and cli.deploy's main, the entry a
  user calls): the trained Q-network of each pack coarsening its mesh on
  the card, every removal's interpolated drag and lift computed on the
  device, and on ys930 the first three removals re-simulated (5000 fused
  f32 steps each, the grouped matvec kernel's launches).
* training (cli.train's main, the entry a user calls): eight sweeps of
  the ys930 pack's config at its full width (32 envs, batch 32, a
  50000-transition ring on the card), resumed from the JAX package's
  checkpoint converted (meshdqn_tpu_torch/data/ys930_ckpt_state.npz); no
  kernel lies on this path, and none is launched.

The kernels are built from source at first use.  Phases, one JSON line each
(any failure raises and the script exits non-zero without the final line):

  device     nvidia-smi's name and power limit, the device name, and the
             device-memory, f32 and f64 peaks used for the bounds
  build      nvcc of the three kernel sources, started together
  kernels    each kernel at each shape its paths give it (the CG kernels
             on both finest meshes): held against its plain
             torch version (||y - plain|| / ||plain|| within
             ops.matvec.gap_tolerance of the row's terms), while the plain
             version on TF32- and bf16-rounded inputs (and the dual form
             without x_lo) must fall outside it; run twice for identical
             bits; timed (CUDA events, median of 25, L2 evicted before each
             launch) beside its bound, the plain version and one library
             call (torch.matmul, or a torch.sparse CSR product).  The banded
             kernel's bound counts the bytes it reads (its packed tiles and
             their index, X and Y), not the dense blocks (stored_bound_ms);
             the ELL kernel's counts the nonzeros, their columns, a row
             index, X and Y (nnz_bound_ms), with the row slices it reads
             (read_bound_ms) and the ELL arrays (stored_bound_ms) beside.
             The ELL step sums cover the production step's 2 applies (f32)
             and the f64 oracle step's 54.  The matvec
             kernel's grouped form, per pack and launch, must also equal the
             composition of single matvec launches and torch's elementwise
             ops bit for bit, and is timed beside that composition.  Its
             split form ('df32'), per pack and launch, on the production
             limbs and on a synthetic low limb as large as the high one
             (dropping the low limbs must fail the check there), with zero
             low limbs equal to the f32 grouped launch.  Its k-column form
             (matvec_cols) at the ensemble step's ys930 shapes at 16 members
             (F3s at 32 and 16 columns), F1u at 40 columns (two launches)
             and ah93w145's F1u at 16: every column also bit-equal to a
             k = 1 launch; library call torch.matmul; each row with the
             launch shape ops.matvec.plan_cols chose (rows a warp, rows a
             block, head classes, window) and the bytes of x it staged.
             Sparse rows also hold the gap over the rows that are not
             identity (Dirichlet) rows; the ELL kernel also at the unfused
             step's operators on both packs, f32 and f64
  solve      per pack: the fused f32 solve from rest with the launch
             counters zeroed (3 grouped launches a step and no single one,
             asserted); drag/lift within 1e-3 of the pack's f64 values
  grouped_bits  per pack: 100 steps from the solve's last state through
             the grouped launches and through seven single launches a step
             (fused_step(..., apply=matvec)), bit-equal at every step
  profile    50 steps of a path under torch.profiler: device busy share,
             time by kernel and the port's kernels' sums (fused, then CG)
  f64        per pack: the fused solve in f64 through the plain products
  dense_f64, dense_mixed, dense_f32, df32
             per pack: 5000 steps from rest of each mode with the counters
             zeroed, its launches asserted; final drag and lift within 1e-3
             of the pack (ys930's df32 lift printed only), dense_f64 every
             snapshot within 1e-8; a profile row of each mode (ys930);
             df32_vs_f32 sets both packs' fused f32 and df32 errors side
             by side
  cg_solve   per finest mesh: the production CG solve, 5000 steps from rest
             with the counters zeroed (18 banded and 2 ELL launches a step,
             asserted, and no plain-version call); final drag and lift within
             1e-3 of the f64 oracle row of docs/examples/
             gen_finest_f64cg_oracle.csv picked by the mesh's sha8
  cg_oracle  per finest mesh: the oracle's own config (f64, ELL, Jacobi,
             25 / 20 iterations) on the card: 54 ELL launches a step,
             final drag and lift within 1.5e-7 of the CSV's printed digits;
             then 50 ys930 steps under torch.profiler (profile, cg_oracle)
  cg_diag    only with --diag, printed only: the production config in f64
             (banded f64 blocks), 5000 steps, and in the ELL layout in f32,
             500 steps
  ensemble   EnsembleFlows, ys930, amplitudes linspace(0.4, 1.3, 16), 5000
             steps from rest with the counters zeroed (7 k-column launches
             a step, asserted): member 1.0 (index 10, exactly 1.0 in f32)
             bit-equal to the solo fused f32 solve at every 1000-step
             snapshot, its drag and lift within 1e-6 of the solo's and its
             final ones within 1e-3 of the pack; every member finite; drag
             and lift by amplitude, ms/step, per-member ms/step against the
             solo solve's, then 50 profiled steps (device busy)
  batched    BatchedFlows, the ys930 pack mesh (not smoothed again) and its
             decimations to 850, 820, 790 and 760 vertices (seed = target,
             smoothed 50 passes, as scripts/make_sweep.py), 5000 steps from
             rest with the counters zeroed (3 batched launches a step,
             asserted): the base member's state bit-equal to its solo solve,
             each member's final drag within 1e-3 of its solo solve's (lift
             printed), the padding exactly zero; set-up s, ms/step and
             per-flow ms/step, 50 profiled steps; then the batched form's
             kernel rows (matvec_group_batched: seeded operands at the
             stacked sizes, bit-equal to the members' grouped launches,
             gap and controls against the per-member plain versions, timed
             beside them) and one step of the sweep's own operators
             bit-equal to the members' grouped launches
  deploy     greedy: per pack, the port's Deployer (complete_traj=False)
             until the episode ends, counters zeroed: actions, vertex counts
             and terminal reason equal to the JAX package's rollout
             (meshdqn_tpu_torch/data/*_deploy_greedy.npz), the interpolated
             estimates within 1e-9; the closing 5000-step re-simulation is
             fused f32.  timings (ys930): env step wall ms (removal, shift),
             a removal's device busy ms, synchronizing calls a step, the
             full locate sweep and the Q-network's forward (events).
             resims (ys930): cli.deploy's main with --precision auto up to
             the third removal, each re-simulated, counters zeroed (3
             grouped launches a step, asserted); every re-simulated
             drag/lift finite, each final drag within the config's
             threshold (1e-3) of the pack; set-up s, ms/step and device busy
             ms/step of each; the last mesh again in 'f64' (unfused): final
             drag within 1e-3 of the f32 re-simulation's, lift printed; the
             JAX package's verified TPU run's first three re-simulated drag
             errors printed beside
  train      (a) four gradient steps from the converted checkpoint on the
             JAX fixture's batches (meshdqn_tpu_torch/data/
             ys930_train_fixture.npz), f32 and f64: f64 within 1e-11 /
             1e-9 of JAX's f64 losses / params1 update, f32's deviation
             within 2x of JAX's own; (b) the batched Q-network forward over
             the pool's 64 states against the per-graph forward, by the 2x
             rule against the per-graph forward in f64, the same argmax;
             (c) cli.train's main, 8 sweeps, counters zeroed: finite
             losses, gradient steps = queued batches, ring = pushes with
             every non-final slot's next state the env's next slot's state,
             a second Trainer resuming the same counters and learner, no
             kernel launched; printed: ms per steady sweep (one applying
             the previous sweep's batches) and its MESHDQN_TIMING
             buckets, syncs, peak memory, then 2 profiled sweeps (device
             busy and ops, syncs a sweep) and 32 gradient steps between
             events; (d) one deploy probe episode

then the kernels summary line, nvidia-smi's line, and the result line.
"""
import argparse
import csv
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PACKS = ("ys930", "ah93w145")
STEPS, SAVE = 5000, 1000
GATE = 1e-3  # drag/lift relative error against the f64 oracle
AIRFOILS = ("ys930", "ah93w145")  # the finest generated meshes, CG path
ORACLE_CSV = os.path.join(REPO, "docs", "examples", "gen_finest_f64cg_oracle.csv")
ORACLE_ABS = 1.5e-7  # the oracle CSV prints drag and lift to 7 decimals
# The production CG config (bench.py:253-260 of the JAX package).
PRODUCTION = dict(precision="f32", fused=False, method="cg", cg_chunk=25,
                  cg_iters_u=6, cg_iters_m=5, cg_precond="block",
                  cg_block_size=128)
# The oracle's own config (scripts/make_fine_oracle.py:91).
ORACLE = dict(precision="f64", method="cg", cg_layout="ell")
# The JAX package's f32 production config on the TPU against the same f64
# rows, final drag / lift relative error (docs/FINE_ORACLE_RECONCILIATION.md);
# printed beside the port's for comparison only.
JAX_TPU_F32 = {"ys930": [3.8e-5, 9.8e-4], "ah93w145": [4.8e-5, 2.1e-4]}
# Device-memory rate (bytes/s), f32 and f64 non-tensor-core rates (flop/s)
# by card, from NVIDIA's data sheets.  Unknown cards get no bound.
PEAKS = {
    "H100 PCIe": (2.0e12, 51.2e12, 25.6e12),
    "H100 NVL": (3.9e12, 60.0e12, 30.0e12),
    "H100 80GB HBM3": (3.35e12, 66.9e12, 33.5e12),  # the SXM part
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
    return None, None, None


def time_ms(fn, flush, reps=25):
    """Median device time of fn() over reps launches, each started with the
    L2 cache flushed (the step streams ~0.4 GB through a 50 MB L2, so every
    operator arrives cold).  A spin of ~0.5 ms on the device before each
    start event lets the host enqueue the launch before the device reaches
    it, so host-side wrapper time stays out of the measurement (a spin of
    0.1 ms let a loaded host's wrapper time into some medians)."""
    fn()
    pairs = []
    for _ in range(reps):
        flush.sum()  # reads evict L2 without leaving dirty lines behind
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_of(nbytes, flops, mem_peak, flop_peak):
    """The least time for the bytes and operations given: the larger of
    bytes over the memory rate and operations over the peak rate, in ms,
    and which of the two bounds it (None without the card's peaks)."""
    t_bytes = nbytes / mem_peak * 1e3 if mem_peak else None
    t_ops = flops / flop_peak * 1e3 if flop_peak else None
    if t_bytes is None:
        return {"bound_ms": None, "bound_by": None}
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
                    row = {
                        "phase": "kernels", "kernel": kname, "R": R, "N": N, "k": k,
                        "rel_gap": gap, "tol": tol, **controls,
                        "max_abs_err": (y - yp).abs().max().item(),
                        "kernel_ms": time_ms(lambda: kernel(M, X, lo), flush),
                        "plain_ms": time_ms(lambda: plain(M, X, lo), flush),
                        "library_ms": time_ms(lambda: library(M, X, lo, X2), flush),
                        **bound_of(nbytes, flops, mem_peak, flop_peak),
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
        if kname == "matvec":
            single_rows = seen
    summary["matvec_group"] = check_grouped(cuda, meshes, mem_peak, flop_peak, flush,
                                            single_rows)
    emit({"phase": "kernels", "checked": list(summary)})
    return summary


def grouped_forms(mv, ns, npr):
    """The fused step's three grouped launches at a pack's sizes: (form,
    grouped wrapper, plain version, the operands' names, the row product
    shapes (R, N, k) it groups, the terms summed into one output)."""
    nu = 2 * ns
    return [
        ("ustar", mv.step_ustar, mv.step_ustar_reference,
         ("F1u", "F1p", "A1Z", "rho", "k1", "u", "p", "c"),
         [(nu, nu, 1), (nu, npr, 1), (nu, nu, 1)], 2 * nu + npr),
        ("pressure", mv.step_pressure, mv.step_pressure_reference,
         ("F2p", "F2u", "k2", "p", "u_star"), [(npr, npr, 1), (npr, nu, 1)], npr + nu),
        ("velocity", mv.step_velocity, mv.step_velocity_reference,
         ("F3s", "F3p", "k3", "u_star", "dp"),
         [(ns, ns, 2), (nu, npr, 1)], ns + npr),
    ]


def check_grouped(cuda, meshes, mem_peak, flop_peak, flush, single_rows):
    """The matvec kernel's grouped form: per pack, each of the fused step's
    three launches on seeded operands against the composition of single
    matvec launches with torch's elementwise ops (bit for bit) and against
    its plain version (the same expression through matvec_reference, within
    gap_tolerance of the terms summed into an output, TF32 and bf16 controls
    outside it); repeated bits; times beside the bound, the composition, the
    sum of the single launches' own times and the plain version.  Returns
    the summary over one ys930 step."""
    from meshdqn_tpu_torch.ops import matvec as mv

    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0,
           "composed_ms": 0.0, "singles_ms": 0.0}
    worst = 0.0
    for pack, mesh in meshes.items():
        ns, npr = mesh.num_vertices + mesh.num_edges, mesh.num_vertices
        nu = 2 * ns
        g = torch.Generator(device=cuda).manual_seed(ns * 7 + npr)
        r = lambda *shape: torch.randn(*shape, device=cuda, generator=g)
        t = {"F1u": r(nu, nu), "F1p": r(nu, npr), "A1Z": r(nu, nu), "k1": r(nu),
             "rho": r(()), "F2p": r(npr, npr), "F2u": r(npr, nu), "k2": r(npr),
             "F3s": r(ns, ns), "F3p": r(2, ns, npr), "k3": r(nu),
             "u": r(nu), "p": r(npr), "c": r(nu), "u_star": r(nu), "dp": r(npr)}
        for form, grouped, plain, names, shapes, terms in grouped_forms(mv, ns, npr):
            args = [t[n] for n in names]
            as_tuple = lambda y: y if isinstance(y, tuple) else (y,)
            y = as_tuple(grouped(*args))
            torch.cuda.synchronize()
            if not all(map(torch.equal, y, as_tuple(grouped(*args)))):
                raise AssertionError(f"matvec_group {form} {pack}: bits differ between "
                                     "runs")
            composed = as_tuple(plain(*args, apply=mv.matvec))
            if not all(map(torch.equal, y, composed)):
                raise AssertionError(f"matvec_group {form} {pack}: not bit-equal to the "
                                     "single launches and torch's elementwise ops")
            yp = torch.cat(as_tuple(plain(*args)))
            tol = mv.gap_tolerance(terms)
            gap = mv.relative_gap(torch.cat(y), yp)
            if not gap <= tol:
                raise AssertionError(f"matvec_group {form} {pack}: ||y - plain|| / "
                                     f"||plain|| = {gap:.3g} above {tol:.3g}")
            controls = {
                f"control_{name}_gap": mv.relative_gap(torch.cat(as_tuple(plain(
                    *(mv.round_mantissa(a, bits) for a in args)))), yp)
                for name, bits in (("tf32", 10), ("bf16", 7))
            }
            if not min(controls.values()) > tol:
                raise AssertionError(f"matvec_group {form} {pack}: a control passes the "
                                     f"check: {controls}")
            # Each operand read once, each output written once.
            nbytes = 4 * (sum(a.numel() for a in args) + sum(o.numel() for o in y))
            flops = sum(2 * R * N * k for R, N, k in shapes)
            row = {
                "phase": "kernels", "kernel": "matvec_group", "form": form, "pack": pack,
                "products": shapes, "rel_gap": gap, "tol": tol, **controls,
                "bits_equal_single_launches": True,
                "max_abs_err": (torch.cat(y) - yp).abs().max().item(),
                "kernel_ms": time_ms(lambda: grouped(*args), flush),
                "composed_ms": time_ms(lambda: plain(*args, apply=mv.matvec), flush),
                "singles_ms": sum(single_rows[s]["kernel_ms"] for s in shapes),
                "plain_ms": time_ms(lambda: plain(*args), flush),
                "library_ms": None,
                **bound_of(nbytes, flops, mem_peak, flop_peak),
            }
            if row["bound_ms"]:
                row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            emit(row)
            worst = max(worst, row["max_abs_err"])
            if pack == PACKS[0]:
                for k in ("ms", "plain_ms", "composed_ms", "singles_ms", "bound_ms"):
                    v = row["kernel_ms" if k == "ms" else k]
                    tot[k] = None if tot[k] is None or v is None else tot[k] + v
        del t
    return dict(tot, max_abs_err=worst,
                bound_by="bytes" if tot["bound_ms"] is not None else None)


def solve_pack(cuda, name, mesh, z, meta, mem_peak):
    from meshdqn_tpu_torch.solver import FlowState, IPCSSolver

    cfg = pack_config(meta, precision="f32")
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

    zero_counters()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = solver.solve(STEPS, save_steps=SAVE)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = read_counters()
    expect = {**NO_LAUNCHES, "step_ustar": STEPS, "step_pressure": STEPS,
              "step_velocity": STEPS}
    if launches != expect:
        raise AssertionError(f"{name}: launches {launches}, expected {expect}")

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
    from meshdqn_tpu_torch.solver import FlowState, build_fused_operators, fused_step

    cfg = pack_config(meta, precision="f32")
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


def profile_steps(solver, state, path, n=50):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # The same n steps first without the profiler, for its wall time and
    # the host's time to issue them (no wait on the device in between).
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    solver.evolve(state, n)
    issue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.evolve(state, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    kernels = 0
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
            kernels += ev.count
    busy = sum(by_name.values())
    # Names cut to 80 characters, the times of names that share a cut summed
    # (template instances of one kernel often do).
    short = {}
    for k, v in by_name.items():
        short[k[:80]] = short.get(k[:80], 0.0) + v
    top = sorted(short.items(), key=lambda kv: -kv[1])[:10]
    # The port's own kernels, each summed over its template instances.
    ours = {k: sum(v for name, v in by_name.items() if k in name) / n
            for k in ("group_kernel", "group_batched_kernel", "cols_kernel",
                      "banded_tiles_kernel", "ell_kernel")}
    # device_busy_share is measured in the profiled window, where the
    # profiler also slows the host; busy over the unprofiled wall time of
    # the same steps, just before, is an estimate across two windows.
    unprofiled_ms = start.elapsed_time(end)
    row = {"phase": "profile", "path": path, "steps": n, "wall_ms_per_step": wall_ms / n,
           "unprofiled_wall_ms_per_step": unprofiled_ms / n,
           "host_issue_ms_per_step": issue_ms / n,
           "device_busy_ms_per_step": busy / n if busy else None,
           "device_ops_per_step": kernels / n,
           "device_busy_share": busy / wall_ms if busy else None,
           "busy_over_unprofiled_wall": busy / unprofiled_ms if busy else None,
           "port_kernels_ms_per_step": ours,
           "top_ms_per_step": {k: v / n for k, v in top}}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# The batched and ensemble flows: the matvec kernel's k-column form and the
# grouped form's batched instance
# ---------------------------------------------------------------------------

# The ensemble's amplitudes (scripts/reynolds_ensemble.py's default): member
# ENS_ONE is exactly 1.0 in f32, the solo solve's inflow.
ENS_AMPS = np.linspace(0.4, 1.3, 16)
ENS_ONE = 10
ENS_REL = 1e-6  # member 1.0's drag/lift against the solo solve's
# The sweep's decimation targets (scripts/make_sweep.py's default).
SWEEP_TARGETS = (850, 820, 790, 760)
BATCHED = ("step_ustar_batched", "step_pressure_batched", "step_velocity_batched")


def cols_shapes(ns: int, npr: int, k: int = len(ENS_AMPS)):
    """The ensemble step's seven products at k members: (operator, R, N,
    columns); F3s takes the (Ns, 2k) stack of both velocity components."""
    n1 = 2 * ns
    return [("F1u", n1, n1, k), ("A1Z", n1, n1, k), ("F1p", n1, npr, k),
            ("F3p", n1, npr, k), ("F2u", npr, n1, k), ("F2p", npr, npr, k),
            ("F3s", ns, ns, 2 * k)]


def check_cols(cuda, meshes, mem_peak, flop_peak, flush):
    """The matvec kernel's k-column form at the ensemble step's seven ys930
    shapes at 16 members (F3s at 32 columns, and at 16), F1u at 40 columns
    (two launches) and ah93w145's F1u at 16: against the plain version
    (gap_tolerance of N, TF32 and bf16 controls outside it), every column
    bit-equal to a k = 1 launch, repeated bits; timed beside the bound, the
    plain version and torch.matmul (TF32 off); with the planner's launch
    shape and the bytes of x staged.  Returns the summary over one ys930
    ensemble step."""
    from meshdqn_tpu_torch.ops import matvec as mv

    ys, ah = meshes[PACKS[0]], meshes[PACKS[1]]
    ns, npr = ys.num_vertices + ys.num_edges, ys.num_vertices
    ans = ah.num_vertices + ah.num_edges
    step = cols_shapes(ns, npr)
    shapes = ([(PACKS[0], True, *sh) for sh in step]
              + [(PACKS[0], False, "F3s", ns, ns, len(ENS_AMPS)),
                 (PACKS[0], False, "F1u", 2 * ns, 2 * ns, 40),
                 (PACKS[1], False, "F1u", 2 * ans, 2 * ans, len(ENS_AMPS))])
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    worst, by_bytes, seen = 0.0, True, {}
    for pack, in_step, op, R, N, k in shapes:
        key = (R, N, k)
        if key not in seen:
            g = torch.Generator(device=cuda).manual_seed(R * 131 + N * 7 + k)
            M = torch.randn(R, N, device=cuda, generator=g)
            X = torch.randn(N, k, device=cuda, generator=g)
            before = mv.matvec.launches
            y = mv.matvec(M, X)
            launches = mv.matvec.launches - before
            torch.cuda.synchronize()
            if not torch.equal(y, mv.matvec(M, X)):
                raise AssertionError(f"matvec_cols {key}: bits differ between runs")
            ones = torch.stack([mv.matvec(M, X[:, j].contiguous()) for j in range(k)], 1)
            if not torch.equal(y, ones):
                raise AssertionError(f"matvec_cols {key}: a column differs from its "
                                     "k = 1 launch")
            yp = mv.matvec_reference(M, X)
            tol = mv.gap_tolerance(N)
            gap = mv.relative_gap(y, yp)
            if not gap <= tol:
                raise AssertionError(f"matvec_cols {key}: ||y - plain|| / ||plain|| = "
                                     f"{gap:.3g} above {tol:.3g}")
            controls = {
                f"control_{name}_gap": mv.relative_gap(mv.matvec_reference(
                    mv.round_mantissa(M, bits), mv.round_mantissa(X, bits)), yp)
                for name, bits in (("tf32", 10), ("bf16", 7))
            }
            if not min(controls.values()) > tol:
                raise AssertionError(f"matvec_cols {key}: a control passes the check: "
                                     f"{controls}")
            # The planner's launch shape (the first launch's where k > COLS_MAX)
            # and the bytes of x every launch stages into shared memory.
            kcs = [min(mv.COLS_MAX, k - c0) for c0 in range(0, k, mv.COLS_MAX)]
            plan = mv.plan_cols(R, N, kcs[0])
            row = {
                "phase": "kernels", "kernel": "matvec_cols", "pack": pack, "op": op,
                "R": R, "N": N, "k": k, "launches_per_call": launches,
                "rows_per_warp": plan.rows_per_warp, "rows_per_block": plan.tile,
                "head_classes": plan.classes, "window": plan.window,
                "x_staged_MB": sum(mv.plan_cols(R, N, kc).staged_bytes(R, N, kc)
                                   for kc in kcs) / 1e6,
                "rel_gap": gap, "tol": tol, **controls, "bits_equal_k1_launches": True,
                "max_abs_err": (y - yp).abs().max().item(),
                "kernel_ms": time_ms(lambda: mv.matvec(M, X), flush),
                "plain_ms": time_ms(lambda: mv.matvec_reference(M, X), flush),
                "library_ms": time_ms(lambda: torch.matmul(M, X), flush),
                **bound_of(4 * (R * N + N * k + R * k), 2 * R * N * k, mem_peak,
                           flop_peak),
            }
            if row["bound_ms"]:
                row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            emit(row)
            seen[key] = row
            worst = max(worst, row["max_abs_err"])
            del M, X, y, ones, yp
        if in_step:
            row = seen[key]
            for k_ in ("plain_ms", "library_ms"):
                tot[k_] += row[k_]
            tot["ms"] += row["kernel_ms"]
            if row["bound_ms"] is None:
                tot["bound_ms"] = None
            elif tot["bound_ms"] is not None:
                tot["bound_ms"] += row["bound_ms"]
                by_bytes &= row["bound_by"] == "bytes"
    return dict(tot, max_abs_err=worst,
                bound_by=("bytes" if by_bytes else "operations")
                if tot["bound_ms"] is not None else None)


def check_batched_kernel(cuda, ns, npr, B, mem_peak, flop_peak, flush):
    """The grouped form's batched instance at the sweep's stacked sizes (B
    members of Ns, Np), seeded operands: each form's one launch bit-equal to
    B grouped launches on the members' slices and repeated, within
    gap_tolerance of the per-member plain versions (TF32 and bf16 controls
    outside it); timed beside the bound, the B grouped launches and the
    plain versions.  Returns the summary over one batched step."""
    from meshdqn_tpu_torch.ops import matvec as mv

    nu = 2 * ns
    g = torch.Generator(device=cuda).manual_seed(ns * 7 + npr + B)
    r = lambda *shape: torch.randn(B, *shape, device=cuda, generator=g)
    t = {"F1u": r(nu, nu), "F1p": r(nu, npr), "A1Z": r(nu, nu), "k1": r(nu),
         "rho": r(), "F2p": r(npr, npr), "F2u": r(npr, nu), "k2": r(npr),
         "F3s": r(ns, ns), "F3p": r(2, ns, npr), "k3": r(nu),
         "u": r(nu), "p": r(npr), "c": r(nu), "u_star": r(nu), "dp": r(npr)}
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0,
           "composed_ms": 0.0}
    worst = 0.0
    flat = lambda ys: torch.cat([y.flatten() for y in ys])
    as_tuple = lambda y: y if isinstance(y, tuple) else (y,)
    for form, grouped, plain, names, shapes, terms in grouped_forms(mv, ns, npr):
        args = [t[n] for n in names]
        y = as_tuple(grouped(*args))
        torch.cuda.synchronize()
        if not all(map(torch.equal, y, as_tuple(grouped(*args)))):
            raise AssertionError(f"matvec_group_batched {form}: bits differ between runs")
        if not all(map(torch.equal, y, as_tuple(mv.per_member(grouped, *args)))):
            raise AssertionError(f"matvec_group_batched {form}: not bit-equal to "
                                 "grouped launches on the members' slices")
        yp = flat(as_tuple(mv.per_member(plain, *args)))
        tol = mv.gap_tolerance(terms)
        gap = mv.relative_gap(flat(y), yp)
        if not gap <= tol:
            raise AssertionError(f"matvec_group_batched {form}: ||y - plain|| / ||plain|| "
                                 f"= {gap:.3g} above {tol:.3g}")
        controls = {
            f"control_{name}_gap": mv.relative_gap(flat(as_tuple(mv.per_member(
                plain, *(mv.round_mantissa(a, bits) for a in args)))), yp)
            for name, bits in (("tf32", 10), ("bf16", 7))
        }
        if not min(controls.values()) > tol:
            raise AssertionError(f"matvec_group_batched {form}: a control passes the "
                                 f"check: {controls}")
        nbytes = 4 * (sum(a.numel() for a in args) + sum(o.numel() for o in y))
        flops = B * sum(2 * R * N * k for R, N, k in shapes)
        row = {
            "phase": "kernels", "kernel": "matvec_group_batched", "form": form,
            "members": B, "products": shapes, "rel_gap": gap, "tol": tol, **controls,
            "bits_equal_member_launches": True,
            "max_abs_err": (flat(y) - yp).abs().max().item(),
            "kernel_ms": time_ms(lambda: grouped(*args), flush),
            "composed_ms": time_ms(lambda: mv.per_member(grouped, *args), flush),
            "plain_ms": time_ms(lambda: mv.per_member(plain, *args), flush),
            "library_ms": None, **bound_of(nbytes, flops, mem_peak, flop_peak),
        }
        if row["bound_ms"]:
            row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        emit(row)
        worst = max(worst, row["max_abs_err"])
        for k in ("ms", "plain_ms", "composed_ms", "bound_ms"):
            v = row["kernel_ms" if k == "ms" else k]
            tot[k] = None if tot[k] is None or v is None else tot[k] + v
    del t
    return dict(tot, max_abs_err=worst,
                bound_by="bytes" if tot["bound_ms"] is not None else None)


def ensemble_phase(cuda, mesh, z, meta, solo_ms):
    """EnsembleFlows on the ys930 pack mesh, ENS_AMPS, 5000 steps from rest
    with the counters zeroed (7 k-column launches a step, asserted): member
    1.0's state bit-equal to the solo fused f32 solve at every snapshot, its
    drag and lift within ENS_REL of the solo's and its final ones within
    1e-3 of the pack; every member finite.  Returns the launches."""
    from meshdqn_tpu_torch.solver import IPCSSolver
    from meshdqn_tpu_torch.solver.ensemble import EnsembleFlows

    if np.float32(ENS_AMPS[ENS_ONE]) != 1.0:
        raise AssertionError("the ensemble's reference member is not 1.0 in f32")
    cfg = pack_config(meta, precision="f32")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens = EnsembleFlows(mesh, list(ENS_AMPS), cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if ens.solver.device.type != "cuda":
        raise AssertionError(f"the ensemble landed on {ens.solver.device}")
    state = ens.initial_state()
    snaps = []
    zero_counters()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEPS // SAVE):
        state, d, l = ens.evolve(state, SAVE)
        snaps.append((state, d[:, -1], l[:, -1], d, l))
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = read_counters()
    expect = {**NO_LAUNCHES, "matvec": 7 * STEPS}
    if launches != expect:
        raise AssertionError(f"ensemble: launches {launches}, expected {expect}")
    ms = start.elapsed_time(end) / STEPS
    if not all(torch.isfinite(t).all() for snap in snaps for t in
               (snap[0].u, snap[0].p, snap[3], snap[4])):
        raise AssertionError("ensemble: non-finite values")

    solo = IPCSSolver(mesh, cfg)
    s = solo.initial_state()
    d_rel, l_rel = [], []
    for i, (st, d, l, _, _) in enumerate(snaps):
        s, sd, sl = solo.evolve(s, SAVE)
        if not (torch.equal(st.u[:, ENS_ONE], s.u) and torch.equal(st.p[:, ENS_ONE], s.p)):
            raise AssertionError(f"ensemble: member 1.0 differs from the solo fused "
                                 f"solve at step {(i + 1) * SAVE}")
        d_rel.append(abs(d[ENS_ONE].item() / sd[-1].item() - 1))
        l_rel.append(abs(l[ENS_ONE].item() / sl[-1].item() - 1))
    final_d = snaps[-1][1].cpu().numpy()
    final_l = snaps[-1][2].cpu().numpy()
    pack_err = [float(abs(final_d[ENS_ONE] / z["gt_drag"][-1] - 1)),
                float(abs(final_l[ENS_ONE] / z["gt_lift"][-1] - 1))]
    emit({"phase": "ensemble", "pack": PACKS[0], "members": len(ENS_AMPS),
          "setup_s": setup_s, "ms_per_step": ms,
          "ms_per_member_step": ms / len(ENS_AMPS),
          "solo_fused_ms_per_step": solo_ms,
          "member_share_of_solo": ms / len(ENS_AMPS) / solo_ms,
          "host_ms_per_step": host_s * 1e3 / STEPS, "launches": launches,
          "member_one_bit_equal_solo_at_snapshots": True,
          "member_one_drag_rel_to_solo": d_rel, "member_one_lift_rel_to_solo": l_rel,
          "member_one_rel_err_to_pack": pack_err,
          "final_drag_lift_by_amplitude": {f"{a:.2f}": [float(dd), float(ll)]
                                           for a, dd, ll in zip(ENS_AMPS, final_d,
                                                                final_l)}})
    if not (max(d_rel) <= ENS_REL and max(l_rel) <= ENS_REL):
        raise AssertionError(f"ensemble: member 1.0's drag/lift {max(d_rel):.3g} / "
                             f"{max(l_rel):.3g} from the solo solve's, above {ENS_REL}")
    if not max(pack_err) < GATE:
        raise AssertionError(f"ensemble: member 1.0's final drag/lift {pack_err} from "
                             f"the pack, above {GATE}")
    profile_steps(ens, state, path="ensemble")
    return launches


def batched_phase(cuda, mesh, meta, pk, flush):
    """BatchedFlows on the ys930 pack mesh and its decimations to
    SWEEP_TARGETS (seed = target, smoothed 50 passes, as
    scripts/make_sweep.py), 5000 steps from rest with the counters zeroed
    (3 batched launches a step, asserted): the base member's state bit-equal
    to its solo fused f32 solve, each decimated member's final drag within
    1e-3 of its own solo solve's, the padding exactly zero.  Then the
    batched form's kernel check at the stacked sizes, and one step's three
    launches on the sweep's operators bit-equal to the members' grouped
    launches.  Returns (launches, kernel summary)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from torch_make_sweep import decimate

    from meshdqn_tpu_torch.mesh import smooth
    from meshdqn_tpu_torch.ops import matvec as mv
    from meshdqn_tpu_torch.ops.convection import convection_members
    from meshdqn_tpu_torch.solver.batch import BatchedFlows

    t0 = time.perf_counter()
    meshes = [mesh] + [smooth(decimate(mesh, t, seed=t), 50) for t in SWEEP_TARGETS]
    decimate_s = time.perf_counter() - t0
    cfg = pack_config(meta, precision="f32")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bf = BatchedFlows(meshes, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    out, ms, host_ms, launches = timed_solve(bf, STEPS, SAVE)
    expect = {**NO_LAUNCHES, **{k: STEPS for k in BATCHED}}
    if launches != expect:
        raise AssertionError(f"batched: launches {launches}, expected {expect}")
    st = out["state"]
    if not (torch.isfinite(st.u).all() and torch.isfinite(st.p).all()
            and torch.isfinite(out["drags"]).all() and torch.isfinite(out["lifts"]).all()):
        raise AssertionError("batched: non-finite values")
    ns_max = bf.n_u // 2
    rows = []
    for i, solver in enumerate(bf.solvers):
        ns, npr = solver.ndofs_u // 2, solver.ndofs_p
        pad = torch.cat([st.u[i, ns:ns_max], st.u[i, ns_max + ns:], st.p[i, npr:]])
        if not torch.all(pad == 0):
            raise AssertionError(f"batched: member {i}'s padding is not zero")
        solo = solver.solve(STEPS, save_steps=SAVE)
        if i == 0 and not (torch.equal(st.u[0], solo["state"].u)
                           and torch.equal(st.p[0], solo["state"].p)):
            raise AssertionError("batched: the base member differs from its solo solve")
        rows.append({"vertices": meshes[i].num_vertices,
                     "drag": float(out["snap_drags"][i, -1]),
                     "lift": float(out["snap_lifts"][i, -1]),
                     "solo_drag": float(solo["snap_drags"][-1]),
                     "solo_lift": float(solo["snap_lifts"][-1]),
                     "drag_rel_to_solo": float(abs(out["snap_drags"][i, -1]
                                                   / solo["snap_drags"][-1] - 1)),
                     "lift_rel_to_solo": float(abs(out["snap_lifts"][i, -1]
                                                   / solo["snap_lifts"][-1] - 1))})
        del solo
    emit({"phase": "batched", "members": bf.B, "decimate_s": decimate_s,
          "setup_s": setup_s, "ms_per_step": ms, "ms_per_flow_step": ms / bf.B,
          "host_ms_per_step": host_ms, "launches": launches,
          "base_bit_equal_solo": True, "padding_zero": True, "flows": rows})
    worst = max(r["drag_rel_to_solo"] for r in rows)
    if not worst < GATE:
        raise AssertionError(f"batched: a member's final drag {worst:.3g} from its solo "
                             f"solve, above {GATE}")
    profile_steps(bf, st, path="batched")

    # One step's three launches on the sweep's own operators.
    dev = bf.dev
    c = convection_members(dev.conv, st.u)
    args = {"ustar": (dev.F1u, dev.F1p, dev.A1Z, dev.rho, dev.k1, st.u, st.p, c)}
    u_star = mv.step_ustar(*args["ustar"])
    args["pressure"] = (dev.F2p, dev.F2u, dev.k2, st.p, u_star)
    _, dp = mv.step_pressure(*args["pressure"])
    args["velocity"] = (dev.F3s, dev.F3p, dev.k3, u_star, dp)
    for form, fn in (("ustar", mv.step_ustar), ("pressure", mv.step_pressure),
                     ("velocity", mv.step_velocity)):
        y, ym = fn(*args[form]), mv.per_member(fn, *args[form])
        if not all(map(torch.equal, *(a if isinstance(a, tuple) else (a,)
                                      for a in (y, ym)))):
            raise AssertionError(f"batched: the sweep's {form} launch differs from its "
                                 "members' grouped launches")
    summary = check_batched_kernel(cuda, ns_max, bf.n_p, bf.B, pk[0], pk[1], flush)
    return launches, summary


# ---------------------------------------------------------------------------
# The large-mesh CG path
# ---------------------------------------------------------------------------


def load_finest(name):
    """The finest generated mesh of `name` and its f64 oracle row, picked by
    the mesh's sha8 (the MESH_SHA8 column)."""
    from meshdqn_tpu_torch.mesh import load_npz
    from meshdqn_tpu_torch.mesh.xdmf import DATA_DIR

    mesh, sha8 = load_npz(DATA_DIR / f"{name}_0.05000_gen.npz")
    with open(ORACLE_CSV) as f:
        rows = [r for r in csv.DictReader(f)
                if r["MESH_SHA8"] == sha8 and r["SOLVER"].startswith("f64")]
    if not rows or rows[0]["AIRFOIL"] != name:
        raise AssertionError(f"{name}: no f64 oracle row for mesh sha8 {sha8}")
    if int(rows[0]["NUM_COORDS"]) != mesh.num_vertices:
        raise AssertionError(f"{name}: the oracle row's vertex count differs")
    return mesh, {"sha8": sha8, "drag": float(rows[0]["DRAG"]),
                  "lift": float(rows[0]["LIFT"])}


def grouped_bits(name, solver, state, n=100):
    """n steps from `state` through the grouped launches and through seven
    single launches a step, bit-equal at every step."""
    from meshdqn_tpu_torch.ops.matvec import matvec
    from meshdqn_tpu_torch.solver import fused_step

    a = b = state
    for i in range(n):
        a, (da, la) = fused_step(solver.dev, a)
        b, (db, lb) = fused_step(solver.dev, b, apply=matvec)
        if not (torch.equal(a.u, b.u) and torch.equal(a.p, b.p)
                and torch.equal(da, db) and torch.equal(la, lb)):
            raise AssertionError(f"{name}: step {i + 1} of the grouped launches differs "
                                 "from the single launches")
    emit({"phase": "grouped_bits", "pack": name, "steps": n, "bit_equal": True,
          "final_drag": da.item(), "final_lift": la.item()})


# Every launch counter at 0: a path's expectation names what it launches.
NO_LAUNCHES = {"matvec": 0, "matvec_dual": 0, "step_ustar": 0, "step_pressure": 0,
               "step_velocity": 0, "step_ustar_df32": 0, "step_pressure_df32": 0,
               "step_velocity_df32": 0, "banded_matmat": 0, "ell_matmat": 0,
               "banded_plain_calls": 0, "ell_plain_calls": 0,
               "step_ustar_batched": 0, "step_pressure_batched": 0,
               "step_velocity_batched": 0}
GROUPED = ("step_ustar", "step_pressure", "step_velocity")
SPLIT = ("step_ustar_df32", "step_pressure_df32", "step_velocity_df32")


def zero_counters():
    from meshdqn_tpu_torch.ops import banded, matvec, sparse

    for fn in (matvec.matvec, matvec.matvec_dual, banded.banded_matmat,
               sparse.ell_matmat, *(getattr(matvec, k) for k in GROUPED + SPLIT)):
        fn.launches = 0
    for k in GROUPED:
        getattr(matvec, k).batched_launches = 0
    banded.banded_matmat_reference.calls = 0
    sparse.ell_matmat_reference.calls = 0


def read_counters():
    from meshdqn_tpu_torch.ops import banded, matvec, sparse

    return {"matvec": matvec.matvec.launches,
            "matvec_dual": matvec.matvec_dual.launches,
            **{k: getattr(matvec, k).launches for k in GROUPED + SPLIT},
            "banded_matmat": banded.banded_matmat.launches,
            "ell_matmat": sparse.ell_matmat.launches,
            "banded_plain_calls": banded.banded_matmat_reference.calls,
            "ell_plain_calls": sparse.ell_matmat_reference.calls,
            **{f"{k}_batched": getattr(matvec, k).batched_launches for k in GROUPED}}


def csr_tensor(A, device, dtype):
    A = A.tocsr()
    return torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr.astype(np.int64)),
        torch.as_tensor(A.indices.astype(np.int64)),
        torch.as_tensor(A.data), size=A.shape, dtype=dtype, device=device)


def interior_rows(A, device):
    """A bool mask of the rows of square A that are not unit identity rows
    (the Dirichlet rows of a BC-eliminated system), or None when A has
    none."""
    if A.shape[0] != A.shape[1]:
        return None
    A = A.tocsr()
    ident = (np.diff(A.indptr) == 1) & (A.diagonal() == 1)
    return torch.as_tensor(~ident, device=device) if ident.any() else None


def check_sparse_case(cuda, kernel, op, A, m, kernel_fn, plain_fn, inputs,
                      read_bytes, entries, terms, pk, flush, *, stored_bytes,
                      nnz_bound=False, controls=None, **extra):
    """One sparse kernel at one shape: gap to the plain version, over all
    rows and over the rows off the boundary (those of A that are not
    identity rows: the identity rows dominate ||y|| on A3bc_s), controls,
    repeated bits, times and bounds.  `inputs` are the plain version's
    floating operands (matrix storage and X), which the controls round
    (`controls`, name -> inputs, replaces the rounded inputs where rounding
    is part of the product);
    `read_bytes` what one product moves (the operator bytes the kernel
    reads, X read once, Y written once); `stored_bytes` the layout's stored
    operator bytes; `entries` the matrix entries the kernel multiplies,
    each one multiply-add per column of X; `terms` the terms of one row's
    sum.  The bound (bound_ms) counts `read_bytes` and `entries`, or with
    `nnz_bound` the nonzeros alone (values, columns, a row index, X and
    Y; one multiply-add each), read_bound_ms the read bytes beside it."""
    from meshdqn_tpu_torch.ops import matvec as mv

    mem_peak, f32_peak, f64_peak = pk
    X = inputs[-1]
    xdt = X.dtype
    y = kernel_fn()
    torch.cuda.synchronize()
    if not torch.equal(y, kernel_fn()):
        raise AssertionError(f"{kernel} {op}: bits differ between runs")
    yp = plain_fn(*inputs)
    tol = mv.gap_tolerance(terms, xdt)
    gap = mv.relative_gap(y, yp)
    if not gap <= tol:
        raise AssertionError(f"{kernel} {op}: ||y - plain|| / ||plain|| = {gap:.3g} "
                             f"above {tol:.3g}")
    interior = interior_rows(A, cuda)
    gap_in = gap if interior is None else mv.relative_gap(y, yp, interior)
    if not gap_in <= tol:
        raise AssertionError(f"{kernel} {op}: the gap over the rows off the boundary, "
                             f"{gap_in:.3g}, is above {tol:.3g}")
    if controls is None:
        controls = {name: [mv.round_mantissa(t.float() if t.dtype == torch.bfloat16
                                             else t, bits) for t in inputs]
                    for name, bits in (("tf32", 10), ("bf16", 7))}
    controls = {f"control_{name}_gap": mv.relative_gap(plain_fn(*args), yp)
                for name, args in controls.items()}
    if not min(controls.values()) > tol:
        raise AssertionError(f"{kernel} {op}: a control passes the check: {controls}")
    Acsr = csr_tensor(A, cuda, xdt)
    X2 = X.view(X.shape[0], -1)
    esize = inputs[0].element_size()
    xy_bytes = (A.shape[0] + A.shape[1]) * m * X.element_size()
    nnz_bytes = A.nnz * (esize + 4) + (A.shape[0] + 1) * 4 + xy_bytes
    flops = 2 * (A.nnz if nnz_bound else entries) * m
    peak = f64_peak if xdt == torch.float64 else f32_peak
    ms_of = lambda b: b / mem_peak * 1e3 if mem_peak else None
    t_bytes = ms_of(nnz_bytes if nnz_bound else read_bytes)
    t_ops = flops / peak * 1e3 if peak else None
    row = {
        "phase": "kernels", "kernel": kernel, "op": op, "shape": list(A.shape),
        "m": m, "dtype": str(inputs[0].dtype).replace("torch.", ""), **extra,
        "nnz": int(A.nnz), "stored_MB": stored_bytes / 1e6, "read_MB": read_bytes / 1e6,
        "rel_gap": gap, "rel_gap_interior": gap_in,
        "interior_rows": None if interior is None else int(interior.sum()),
        "tol": tol, **controls,
        "max_abs_err": (y - yp).abs().max().item(),
        "kernel_ms": time_ms(kernel_fn, flush),
        "plain_ms": time_ms(lambda: plain_fn(*inputs), flush),
        "library_ms": time_ms(lambda: Acsr @ X2, flush),
        "bound_ms": None if t_bytes is None else max(t_bytes, t_ops),
        "bound_by": None if t_bytes is None else
        ("bytes" if t_bytes >= t_ops else "operations"),
        "read_bound_ms": ms_of(read_bytes),
        "nnz_bound_ms": ms_of(nnz_bytes),
        "stored_bound_ms": ms_of(stored_bytes + xy_bytes),
    }
    if row["bound_ms"]:
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    emit(row)
    return row


# The 18 banded applies of one production step (6 / 5 PCG iterations, one
# product each plus the initial residual) and the 2 ELL ones: (op, m, count).
STEP_BANDED = [("A1bc", 1, 7), ("R1", 1, 1), ("P1m_s", 1, 1), ("BT_s", 1, 1),
               ("G_s", 1, 1), ("Ms", 2, 1), ("A3bc_s", 2, 6)]
STEP_ELL = [("Kp", 1, 1), ("A2bc", 1, 1)]
# The 54 ELL applies of one step of the f64 oracle config (ipcs_step_cg at
# 25 / 20 PCG iterations and one pressure refinement): (op, m, count).
ORACLE_STEP = [("R1", 1, 1), ("P1m", 1, 1), ("A1bc", 1, 26), ("Kp", 1, 1),
               ("BT", 1, 1), ("A2bc", 1, 1), ("M", 1, 1), ("G", 1, 1),
               ("A3bc_s", 2, 21)]
# The nine operators of the ELL layout and the column count each is applied
# to: every apply of the f64 oracle config, and of the f32 ELL config.
ELL_OPS = [("A1bc", 1), ("A3bc_s", 2), ("A2bc", 1), ("Kp", 1), ("R1", 1),
           ("P1m", 1), ("BT", 1), ("M", 1), ("G", 1)]


def check_cg_kernels(cuda, meshes, pk, flush):
    """banded_matmat and ell_matmat at every shape the CG paths give them on
    each finest mesh: the banded operators in both window layouts with m = 1
    and 2 (A1bc also with bf16 blocks), and the nine ELL operators in f32 and
    f64.  Returns the summary of each kernel over one ys930 production step."""
    from meshdqn_tpu_torch.ops.banded import BandedMatrix, banded_matmat_reference
    from meshdqn_tpu_torch.ops.sparse import EllMatrix, ell_matmat_reference
    from meshdqn_tpu_torch.solver import IPCSConfig
    from meshdqn_tpu_torch.solver.ipcs import cg_matrices

    rows = {"banded_matmat": [], "ell_matmat": []}
    step = {}

    def x_for(A, m, dtype, seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        shape = (A.shape[1],) if m == 1 else (A.shape[1], m)
        return torch.randn(shape, device=cuda, dtype=dtype, generator=g)

    def banded_case(airfoil, op, A, bm, m, aligned):
        dtype = bm.blocks.dtype
        xdt = torch.float64 if dtype == torch.float64 else torch.float32
        X = x_for(A, m, xdt, A.shape[0] + m)
        kw = dict(pad=bm.pad, g=bm.g, aligned=aligned, n_rows=A.shape[0])
        B, R, W = bm.blocks.shape
        controls = None
        if dtype == torch.bfloat16 and not aligned:
            # x and each product are rounded to bf16 here, as the JAX
            # package's banded_matmat rounds them; the controls keep x in f32
            # with exact products, and round x with exact products.
            b32 = bm.blocks.float()
            controls = {"x_f32": [b32, X], "exact_products": [b32, X.bfloat16().float()]}
        # The kernel reads the packed tiles; the bound counts their bytes.
        row = check_sparse_case(
            cuda, "banded_matmat", op, A, m, lambda: bm.matmat(X),
            lambda b, x: banded_matmat_reference(b, x, **kw), [bm.blocks, X],
            bm.read_bytes(m), bm.tiles.values.numel(), W, pk, flush,
            stored_bytes=bm.nbytes, controls=controls, airfoil=airfoil,
            aligned128=aligned,
            blocks=[B, R, W], g=bm.g, pad=bm.pad, n_tiles=bm.tiles.values.shape[0],
            tile_occupancy=bm.tiles.occupancy)
        rows["banded_matmat"].append(row)
        return row

    def ell_case(airfoil, op, A, m, dtype):
        e = EllMatrix.from_scipy(A, device=cuda, dtype=dtype)
        X = x_for(A, m, dtype, A.shape[0] + m)
        # The kernel reads the slices (read_bound_ms); the bound counts the
        # nonzeros alone, not the pads a slice stores.
        row = check_sparse_case(
            cuda, "ell_matmat", op, A, m, lambda: e.matmat(X),
            lambda v, x: ell_matmat_reference(e.cols, v, x), [e.vals, X],
            e.read_bytes(m), e.slices.vals.numel(), e.cols.shape[1], pk, flush,
            stored_bytes=e.nbytes, nnz_bound=True, airfoil=airfoil,
            K=e.cols.shape[1], lanes=e.slices.lanes, uniform=e.slices.uniform,
            fill=e.slices.fill, ell_fill=A.nnz / e.vals.numel())
        rows["ell_matmat"].append(row)
        return row

    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    for airfoil, mesh in meshes.items():
        main = airfoil == AIRFOILS[0]
        mats = cg_matrices(mesh, IPCSConfig(**PRODUCTION))["matrices"]
        for op, step_m, _ in STEP_BANDED:
            for dtype in (f32, bf16) if op == "A1bc" else (f32,):
                for aligned in (False, True):
                    bm = BandedMatrix.from_scipy(mats[op], device=cuda, dtype=dtype,
                                                 aligned128=aligned)
                    for m in (1, 2):
                        row = banded_case(airfoil, op, mats[op], bm, m, aligned)
                        if main and dtype == f32 and not aligned and m == step_m:
                            step["banded_matmat", op] = row
                    del bm
        del mats
        ell_mats = cg_matrices(mesh, IPCSConfig(**ORACLE))["matrices"]
        for dtype in (f32, f64):
            for op, m in ELL_OPS:
                row = ell_case(airfoil, op, ell_mats[op], m, dtype)
                if main and dtype == f32 and op in ("A2bc", "Kp"):
                    step["ell_matmat", op] = row
                if main and dtype == f64:
                    step["ell_oracle", op] = row
        del ell_mats

    def step_sums(kname, plan):
        src = {"ms": "kernel_ms", **{k: k for k in (
            "plain_ms", "library_ms", "bound_ms", "read_bound_ms", "nnz_bound_ms",
            "stored_bound_ms")}}
        tot = dict.fromkeys(src, 0.0)
        by_bytes = True
        for op, _, count in plan:
            r = step[kname, op]
            for k in tot:
                tot[k] = None if tot[k] is None or r[src[k]] is None else \
                    tot[k] + count * r[src[k]]
            by_bytes &= r["bound_by"] == "bytes"
        return dict(tot, applies=sum(c for _, _, c in plan),
                    bound_by=("bytes" if by_bytes else "operations")
                    if tot["bound_ms"] is not None else None)

    summary = {}
    for kname, plan in (("banded_matmat", STEP_BANDED), ("ell_matmat", STEP_ELL)):
        summary[kname] = dict(step_sums(kname, plan),
                              max_abs_err=max(r["max_abs_err"] for r in rows[kname]))
    summary["ell_matmat"]["oracle_step"] = step_sums("ell_oracle", ORACLE_STEP)
    emit({"phase": "kernels", "ell_step_sums": {
        "production_f32": {k: v for k, v in summary["ell_matmat"].items()
                           if k != "oracle_step"},
        "oracle_f64": summary["ell_matmat"]["oracle_step"]}})
    emit({"phase": "kernels", "checked": ["banded_matmat", "ell_matmat"],
          "shapes": {k: len(v) for k, v in rows.items()}})
    return summary


def cg_step_bytes(dev, cfg):
    """Bytes one CG step reads once each: (operator bytes, all bytes).
    Operators: the banded kernel's packed tiles and their index, and the
    block-Jacobi inverses, times their applies.  All: also the dense
    pressure inverse, the ELL operators, the convection tables and the
    vectors."""
    from meshdqn_tpu_torch.ops.banded import BandedMatrix
    from meshdqn_tpu_torch.ops.cg import BlockJacobi

    nbytes = lambda t: t.numel() * t.element_size()
    iu, im, pr = 1 + cfg.cg_iters_u, 1 + cfg.cg_iters_m, cfg.cg_pressure_refine
    counts = {"A1bc": iu, "A3bc_s": im, "d1inv": iu, "d3inv": im}
    ops = 0
    for name in ("A1bc", "A3bc_s", "R1", "P1m_s", "BT_s", "Ms", "G_s", "d1inv",
                 "d3inv"):
        v = getattr(dev, name)
        if isinstance(v, BandedMatrix):
            b = v.tiles.nbytes
        else:
            b = nbytes(v.inv_blocks if isinstance(v, BlockJacobi) else v)
        ops += counts.get(name, 1) * b
    rest = (1 + pr) * nbytes(dev.A2inv) + dev.Kp.slices.nbytes + pr * dev.A2bc.slices.nbytes
    rest += sum(nbytes(t) for t in vars(dev.conv).values() if isinstance(t, torch.Tensor))
    rest += sum(nbytes(getattr(dev, n)) for n in ("z_u", "z_p", "t1", "t2", "t3",
                                                   "drag_u", "drag_p", "lift_u",
                                                   "lift_p", "vert_pos"))
    return ops, ops + rest


def timed_solve(solver, steps, save):
    """solve() from rest with every counter zeroed just before; returns
    (output, device ms/step, host ms/step, counters read just after)."""
    zero_counters()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = solver.solve(steps, save_steps=save)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    return out, start.elapsed_time(end) / steps, host_ms, read_counters()


def check_finite(name, solver, out):
    st = out["state"]
    if st.u.shape != (solver.ndofs_u,) or st.p.shape != (solver.ndofs_p,):
        raise AssertionError(f"{name}: state has the wrong shape")
    if not (torch.isfinite(st.u).all() and torch.isfinite(st.p).all()
            and torch.isfinite(out["drags"]).all() and torch.isfinite(out["lifts"]).all()):
        raise AssertionError(f"{name}: non-finite values in the solve")


def cg_solve(cuda, name, mesh, oracle, pk):
    """The production CG solve on the finest mesh, gated at 1e-3."""
    from meshdqn_tpu_torch.solver import FlowState, IPCSConfig, IPCSSolver

    cfg = IPCSConfig(**PRODUCTION)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = IPCSSolver(mesh, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if solver.device.type != "cuda" or type(solver.dev).__name__ != "BandedCGOperators":
        raise AssertionError(f"{name}: solver is {type(solver.dev).__name__} on "
                             f"{solver.device}")
    # Warm-up from a distinct state; solve() starts from rest and resets the
    # PCG warm start.
    g = torch.Generator(device=cuda).manual_seed(0)
    solver.evolve(FlowState(
        u=1e-3 * torch.randn(solver.ndofs_u, device=cuda, generator=g),
        p=torch.zeros(solver.ndofs_p, device=cuda)), 25)
    out, ms, host_ms, counts = timed_solve(solver, STEPS, SAVE)
    expect = {**NO_LAUNCHES, "banded_matmat": 18 * STEPS, "ell_matmat": 2 * STEPS}
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts}, expected {expect}")
    check_finite(name, solver, out)
    derr = abs(float(out["snap_drags"][-1]) / oracle["drag"] - 1)
    lerr = abs(float(out["snap_lifts"][-1]) / oracle["lift"] - 1)
    op_bytes, step_bytes = cg_step_bytes(solver.dev, cfg)
    mem_peak = pk[0]
    row = {
        "phase": "cg_solve", "airfoil": name, "mesh_sha8": oracle["sha8"],
        "vertices": mesh.num_vertices, "ndofs_u": solver.ndofs_u,
        "setup_s": setup_s, "ms_per_step": ms, "host_ms_per_step": host_ms,
        "operator_MB_per_step": op_bytes / 1e6, "step_MB": step_bytes / 1e6,
        "achieved_GB_s": step_bytes / (ms * 1e-3) / 1e9,
        "share_of_peak": step_bytes / (ms * 1e-3) / mem_peak if mem_peak else None,
        "bound_ms_per_step": step_bytes / mem_peak * 1e3 if mem_peak else None,
        "launches": counts,
        "snap_drags": out["snap_drags"].tolist(),
        "snap_lifts": out["snap_lifts"].tolist(),
        "oracle": oracle, "drag_rel_err": derr, "lift_rel_err": lerr,
        "jax_f32_tpu_rel_err": JAX_TPU_F32[name],
    }
    emit(row)
    if not (derr < GATE and lerr < GATE):
        raise AssertionError(f"{name}: final drag/lift error {derr:.3g} / "
                             f"{lerr:.3g} above {GATE}")
    return solver, out, row


def cg_oracle(name, mesh, oracle, profile=False):
    """The oracle's own f64 ELL config on the card, held to the CSV; with
    `profile`, 50 more steps under the profiler."""
    from meshdqn_tpu_torch.solver import IPCSConfig, IPCSSolver

    cfg = IPCSConfig(**ORACLE)
    solver = IPCSSolver(mesh, cfg)
    out, ms, host_ms, counts = timed_solve(solver, STEPS, SAVE)
    per_step = 2 + (1 + cfg.cg_iters_u) + 2 + cfg.cg_pressure_refine + 2 + (1 + cfg.cg_iters_m)
    expect = {**NO_LAUNCHES, "ell_matmat": per_step * STEPS}
    if per_step != 54 or counts != expect:
        raise AssertionError(f"{name}: launches {counts}, expected {expect}")
    check_finite(name, solver, out)
    dd = float(out["snap_drags"][-1]) - oracle["drag"]
    dl = float(out["snap_lifts"][-1]) - oracle["lift"]
    emit({"phase": "cg_oracle", "airfoil": name, "ms_per_step": ms,
          "host_ms_per_step": host_ms, "launches": counts,
          "snap_drags": out["snap_drags"].tolist(),
          "snap_lifts": out["snap_lifts"].tolist(), "oracle": oracle,
          "drag_abs_diff": dd, "lift_abs_diff": dl, "limit": ORACLE_ABS})
    if not (abs(dd) <= ORACLE_ABS and abs(dl) <= ORACLE_ABS):
        raise AssertionError(f"{name}: f64 drag/lift differ from the oracle CSV by "
                             f"{dd:.3g} / {dl:.3g}, above {ORACLE_ABS}")
    if profile:
        profile_steps(solver, out["state"], path="cg_oracle")


def cg_diag(name, mesh, oracle, f32_out, f32_ms):
    """Printed only: the production config in f64 (banded f64 blocks), which
    tells f32 rounding from truncated PCG, and in the ELL layout in f32."""
    from meshdqn_tpu_torch.solver import IPCSConfig, IPCSSolver

    solver = IPCSSolver(mesh, IPCSConfig(**{**PRODUCTION, "precision": "f64"}))
    out, ms, _, counts = timed_solve(solver, STEPS, SAVE)
    check_finite(name, solver, out)
    sd, sl = out["snap_drags"], out["snap_lifts"]
    del solver, out
    ell = IPCSSolver(mesh, IPCSConfig(**{**PRODUCTION, "cg_layout": "ell"}))
    n = min(500, STEPS)
    eout, ems, ehost, ecounts = timed_solve(ell, n, n)
    check_finite(name, ell, eout)
    emit({
        "phase": "cg_diag", "airfoil": name,
        "f64_production": {
            "ms_per_step": ms, "launches": counts,
            "snap_drags": sd.tolist(), "snap_lifts": sl.tolist(),
            "drag_rel_err": abs(float(sd[-1]) / oracle["drag"] - 1),
            "lift_rel_err": abs(float(sl[-1]) / oracle["lift"] - 1),
            "f32_drag_rel_to_f64": np.abs(f32_out["snap_drags"] / sd - 1).tolist(),
            "f32_lift_rel_to_f64": np.abs(f32_out["snap_lifts"] / sl - 1).tolist(),
        },
        "ell_f32_production": {
            "steps": n, "ms_per_step": ems, "host_ms_per_step": ehost,
            "banded_ms_per_step": f32_ms, "launches": ecounts,
            "final_drag_rel_to_banded": abs(
                eout["drags"][n - 1].item() / f32_out["drags"][n - 1].item() - 1),
            "final_lift_rel_to_banded": abs(
                eout["lifts"][n - 1].item() / f32_out["lifts"][n - 1].item() - 1),
        },
    })


# ---------------------------------------------------------------------------
# The dense modes besides the fused f32 step: 'df32' (the matvec kernel's
# split form), 'f64', 'mixed' and f32 unfused (the matvec kernel's single
# form for f32 inverses, the ELL kernel for every sparse product)
# ---------------------------------------------------------------------------


def pack_config(meta, **kw):
    from meshdqn_tpu_torch.solver import IPCSConfig

    return IPCSConfig(mu=meta["mu"], rho=meta["rho"], dt=meta["dt"], **kw)


def split_forms(mv):
    """The 'df32' step's three split launches: (form, split wrapper, plain
    version, f32 grouped wrapper, the high operands' names, the low limbs'
    names, the vectors' names)."""
    return [
        ("ustar", mv.step_ustar_df32, mv.step_ustar_df32_reference, mv.step_ustar,
         ("F1u", "F1p", "A1Z", "rho", "k1"), ("F1u", "F1p", "A1Z", "k1"),
         ("u", "p", "c")),
        ("pressure", mv.step_pressure_df32, mv.step_pressure_df32_reference,
         mv.step_pressure, ("F2p", "F2u", "k2"), ("F2p", "F2u", "k2"), ("p", "u_star")),
        ("velocity", mv.step_velocity_df32, mv.step_velocity_df32_reference,
         mv.step_velocity, ("F3s", "F3p", "k3"), ("F3s", "F3p", "k3"),
         ("u_star", "dp")),
    ]


def check_split(cuda, packs, mem_peak, flop_peak, flush):
    """The matvec kernel's split form, per pack and launch, on the pack's
    production limbs (built as the solver builds them) and on a synthetic
    low limb as large as the high one (at 2^-24 a dropped or misrouted low
    term would hide below f32 rounding): within gap_tolerance of its plain
    version (both limbs' terms), the plain version without its low limbs
    outside it on the synthetic limbs, zero limbs giving the f32 grouped
    launch's values exactly, repeated bits; on the production limbs timed
    beside the bound, the plain version, the same step through torch with
    the low limbs widened to f32 beforehand (composed_ms) and the f32
    grouped launch.  Returns the summary over one ys930 step."""
    from meshdqn_tpu_torch.ops import matvec as mv
    from meshdqn_tpu_torch.solver import build_fused_operators

    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0,
           "composed_ms": 0.0, "f32_grouped_ms": 0.0}
    worst = 0.0
    for pack, (mesh, _, meta) in packs.items():
        (hi, lo), *_ = build_fused_operators(
            mesh, pack_config(meta, precision="df32"), device=cuda, split=True)
        ns, npr = hi.F3s.shape[0], hi.F2p.shape[0]
        nu = 2 * ns
        g = torch.Generator(device=cuda).manual_seed(ns * 5 + npr)
        r = lambda *shape: torch.randn(*shape, device=cuda, generator=g)
        vecs = {"u": r(nu), "p": r(npr), "c": r(nu), "u_star": r(nu), "dp": r(npr)}
        rms = lambda t: t.double().pow(2).mean().sqrt().item()
        synthetic = {k: (rms(getattr(hi, k)) * r(*getattr(hi, k).shape)).to(
            getattr(lo, k).dtype) for k in lo._fields}
        for form, split, plain, grouped, his, los, xs in split_forms(mv):
            hi_args = [getattr(hi, n) for n in his]
            x_args = [vecs[n] for n in xs]
            rows_of = lambda limbs: hi_args + [limbs[n] for n in los] + x_args
            terms = {"ustar": 2 * nu + npr, "pressure": npr + nu,
                     "velocity": ns + npr}[form]
            tol = mv.gap_tolerance(2 * terms)
            as_cat = lambda y: torch.cat(y) if isinstance(y, tuple) else y
            zero = {n: torch.zeros_like(getattr(lo, n)) for n in los}
            y0 = as_cat(split(*rows_of(zero)))
            if not torch.equal(y0, as_cat(grouped(*hi_args, *x_args))):
                raise AssertionError(f"matvec_group_df32 {form} {pack}: zero low limbs "
                                     "do not give the f32 grouped launch's values")
            for case, limbs in (("production", lo._asdict()), ("synthetic", synthetic)):
                args = rows_of(limbs)
                y = as_cat(split(*args))
                torch.cuda.synchronize()
                if not torch.equal(y, as_cat(split(*args))):
                    raise AssertionError(f"matvec_group_df32 {form} {pack} {case}: bits "
                                         "differ between runs")
                yp = as_cat(plain(*args))
                gap = mv.relative_gap(y, yp)
                if not gap <= tol:
                    raise AssertionError(f"matvec_group_df32 {form} {pack} {case}: "
                                         f"gap {gap:.3g} above {tol:.3g}")
                drop = mv.relative_gap(as_cat(plain(*rows_of(zero))), yp)
                if case == "synthetic" and not drop > tol:
                    raise AssertionError(f"matvec_group_df32 {form} {pack}: dropping the "
                                         f"low limbs passes the check ({drop:.3g})")
                row = {"phase": "kernels", "kernel": "matvec_group_df32", "form": form,
                       "pack": pack, "limbs": case, "rel_gap": gap, "tol": tol,
                       "control_drop_lo_gap": drop,
                       "zero_lo_equals_f32_grouped": True,
                       "max_abs_err": (y - yp).abs().max().item()}
                if case == "production":
                    wide = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
                    # Each operand read once, each output (p' and dp in the
                    # pressure launch) written once; a multiply-add per entry
                    # of each limb and right-hand side (F3s takes two).
                    nbytes = sum(a.numel() * a.element_size() for a in args) + 4 * y.numel()
                    flops = 4 * sum(getattr(hi, n).numel() * (2 if n == "F3s" else 1)
                                    for n in his if getattr(hi, n).dim() >= 2)
                    row.update({
                        "kernel_ms": time_ms(lambda: split(*args), flush),
                        "plain_ms": time_ms(lambda: plain(*args), flush),
                        "composed_ms": time_ms(lambda: plain(*wide), flush),
                        "f32_grouped_ms": time_ms(lambda: grouped(*hi_args, *x_args),
                                                  flush),
                        "library_ms": None,
                        "step_MB": nbytes / 1e6,
                        **bound_of(nbytes, flops, mem_peak, flop_peak),
                    })
                    if row["bound_ms"]:
                        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
                    if pack == PACKS[0]:
                        for k in ("plain_ms", "composed_ms", "f32_grouped_ms",
                                  "bound_ms"):
                            tot[k] = None if tot[k] is None or row[k] is None else \
                                tot[k] + row[k]
                        tot["ms"] += row["kernel_ms"]
                emit(row)
                worst = max(worst, row["max_abs_err"])
        del hi, lo, synthetic
    return dict(tot, max_abs_err=worst,
                bound_by="bytes" if tot["bound_ms"] is not None else None)


# The unfused step's sparse products (ipcs_step): operator, dtype by mode.
UNFUSED_ELL = ("R1", "P1m", "Kp", "BT", "M", "G")
UNFUSED_STEPS = {  # mode: [(op, dtype, count)] of one step
    "dense_f64": [(op, "f64", 1) for op in UNFUSED_ELL],
    "dense_mixed": [("R1", "f32", 1), ("P1m", "f32", 1), ("Kp", "f64", 1),
                    ("BT", "f64", 1), ("M", "f32", 1), ("G", "f32", 1),
                    ("A2bc", "f64", 2)],
    "dense_f32": [(op, "f32", 1) for op in UNFUSED_ELL],
}


def check_unfused_ell(cuda, packs, pk, flush):
    """ell_matmat at the unfused step's shapes on each pack: its six sparse
    operators in f32 and f64 and A2bc (the 'mixed' refinement) in f64.
    Returns the sums over one ys930 step of each unfused mode."""
    from meshdqn_tpu_torch.fem.assembly import apply_bc_symmetric
    from meshdqn_tpu_torch.ops.sparse import EllMatrix, ell_matmat_reference
    from meshdqn_tpu_torch.solver.ipcs import assemble

    rows = {}
    for pack, (mesh, _, meta) in packs.items():
        _, ops = assemble(mesh, pack_config(meta))
        mats = {"R1": ops.R1, "P1m": (ops.B - ops.Bn).tocsr(), "Kp": ops.Kp,
                "BT": ops.B.T.tocsr(), "M": ops.M, "G": ops.G,
                "A2bc": apply_bc_symmetric(ops.A2, ops.p_bc_mask)}
        for name, dtype in [(op, dt) for op in UNFUSED_ELL for dt in ("f32", "f64")] + [
                ("A2bc", "f64")]:
            A = mats[name]
            tdt = torch.float32 if dtype == "f32" else torch.float64
            e = EllMatrix.from_scipy(A, device=cuda, dtype=tdt)
            gen = torch.Generator(device=cuda).manual_seed(A.shape[0] + A.shape[1])
            X = torch.randn(A.shape[1], device=cuda, dtype=tdt, generator=gen)
            rows[pack, name, dtype] = check_sparse_case(
                cuda, "ell_matmat", name, A, 1, lambda: e.matmat(X),
                lambda v, x: ell_matmat_reference(e.cols, v, x), [e.vals, X],
                e.read_bytes(1), e.slices.vals.numel(), e.cols.shape[1], pk, flush,
                stored_bytes=e.nbytes, nnz_bound=True, pack=pack, path="unfused",
                K=e.cols.shape[1], lanes=e.slices.lanes, uniform=e.slices.uniform)
    sums = {}
    for mode, plan in UNFUSED_STEPS.items():
        tot = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        for op, dtype, count in plan:
            r = rows[PACKS[0], op, dtype]
            for k, src in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                           ("library_ms", "library_ms"), ("bound_ms", "bound_ms")):
                tot[k] = None if tot[k] is None or r[src] is None else \
                    tot[k] + count * r[src]
        sums[mode] = dict(tot, applies=sum(c for _, _, c in plan))
    emit({"phase": "kernels", "ell_unfused_step_sums": sums})
    return sums


# Per dense mode: (config overrides, launches a step by counter).
DENSE_MODES = {
    "dense_f64": ({}, {"ell_matmat": 6}),
    "dense_mixed": ({"precision": "mixed"}, {"matvec": 5, "ell_matmat": 8}),
    "dense_f32": ({"precision": "f32", "fused": False},
                  {"matvec": 3, "ell_matmat": 6}),
    "df32": ({"precision": "df32"}, {k: 1 for k in SPLIT}),
}
SNAP_F64_REL = 1e-8  # dense_f64 against the pack's f64 snapshots
# The JAX package's df32 final drag / lift errors on its TPU
# (meshdqn_tpu/solver/ipcs.py:36-41), printed beside the port's only.
JAX_TPU_DF32 = {"ys930": [2.2e-5, 1.6e-3], "ah93w145": [1.2e-5, 1.2e-4]}


def dense_phase(cuda, mode, name, mesh, z, meta, f32_row):
    """One dense mode's 5000-step solve from rest through IPCSSolver with
    the counters zeroed: its launches asserted, drag and lift against the
    pack's f64 values (1e-3 at the end; for 'f64' also 1e-8 at every
    snapshot; for 'df32' ys930's lift printed, not asserted, see PERF.md),
    printed beside the fused f32 solve's errors from this call."""
    from meshdqn_tpu_torch.solver import FlowState, IPCSSolver

    overrides, per_step = DENSE_MODES[mode]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = IPCSSolver(mesh, pack_config(meta, **overrides))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if solver.device.type != "cuda":
        raise AssertionError(f"{mode} {name}: solver landed on {solver.device}")
    g = torch.Generator(device=cuda).manual_seed(1)
    solver.evolve(FlowState(
        u=1e-3 * torch.randn(solver.ndofs_u, device=cuda, generator=g).to(
            solver.work_dtype),
        p=torch.zeros(solver.ndofs_p, device=cuda, dtype=solver.pressure_dtype)), 20)
    out, ms, host_ms, counts = timed_solve(solver, STEPS, SAVE)
    expect = {**NO_LAUNCHES, **{k: n * STEPS for k, n in per_step.items()}}
    if counts != expect:
        raise AssertionError(f"{mode} {name}: launches {counts}, expected {expect}")
    check_finite(f"{mode} {name}", solver, out)
    st = out["state"]
    if st.u.dtype != solver.work_dtype or st.p.dtype != solver.pressure_dtype:
        raise AssertionError(f"{mode} {name}: state dtypes {st.u.dtype}, {st.p.dtype}")
    derr = np.abs(out["snap_drags"] / z["gt_drag"] - 1)
    lerr = np.abs(out["snap_lifts"] / z["gt_lift"] - 1)
    row = {"phase": mode, "pack": name, "setup_s": setup_s, "ms_per_step": ms,
           "host_ms_per_step": host_ms, "launches": counts,
           "work_dtype": str(solver.work_dtype), "pressure_dtype": str(solver.pressure_dtype),
           "snap_drags": out["snap_drags"].tolist(), "snap_lifts": out["snap_lifts"].tolist(),
           "drag_rel_err": derr.tolist(), "lift_rel_err": lerr.tolist(),
           "fused_f32_drag_lift_rel_err": [f32_row["drag_rel_err"][-1],
                                           f32_row["lift_rel_err"][-1]]}
    if mode == "df32":
        row["jax_tpu_df32_drag_lift_rel_err"] = JAX_TPU_DF32[name]
    emit(row)
    gated = [("drag", derr[-1])]
    if mode != "df32" or name != "ys930":
        gated.append(("lift", lerr[-1]))
    for what, err in gated:
        if not err < GATE:
            raise AssertionError(f"{mode} {name}: final {what} error {err:.3g} above {GATE}")
    if mode == "dense_f64" and not (derr.max() < SNAP_F64_REL and lerr.max() < SNAP_F64_REL):
        raise AssertionError(f"{mode} {name}: snapshots {derr.max():.3g} / {lerr.max():.3g} "
                             f"from the pack's f64 values, above {SNAP_F64_REL}")
    return solver, out, row


# ---------------------------------------------------------------------------
# Greedy deployment (env, transfer, coarsening, the Q-network, cli.deploy)
# ---------------------------------------------------------------------------

# The JAX package's greedy rollouts on the CPU (scripts/torch_deploy_fixture.py)
# give the interpolated drag/lift estimates as f32 values (they cross to the
# host packed in f32); the port's on the CPU equal them exactly.
DEPLOY_REL = 1e-9
# ys930's verified deployment by the JAX package on its TPU: per-removal
# re-simulated drag errors in %, entry 0 the ground truth; printed only.
DEPLOY_REPORT = os.path.join(REPO, "docs", "examples", "ys930_r5_deploy_report.json")
RESIMS = 3  # removals re-simulated through cli.deploy on ys930
PROFILED_RESIM_STEPS = 50


def pack_run_dir(tmp, pack):
    """tmp/<pack>_results holding a copy of the pack's ground truth and its
    fingerprint, as a deployment's run directory (save_dir = tmp)."""
    src = os.path.join(REPO, "checkpoints", f"{pack}_results")
    dst = os.path.join(tmp, f"{pack}_results")
    os.makedirs(dst, exist_ok=True)
    for f in ("ground_truth.npz", "ground_truth_meta.json"):
        shutil.copy(os.path.join(src, f), dst)
    return os.path.join(src, "config.yaml")


def count_syncs(fn):
    """(fn(), the synchronizing CUDA calls it made, as flagged by
    torch.cuda.set_sync_debug_mode)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def deploy_greedy(cuda, pack, tmp):
    """The port's Deployer on the card, complete_traj=False, until the
    episode ends, with the counters zeroed: actions, vertex counts and the
    terminal reason equal to the JAX package's fixture, the estimates within
    DEPLOY_REL of it."""
    from meshdqn_tpu_torch.convert import load_deploy_weights
    from meshdqn_tpu_torch.deploy import Deployer, DeployOptions
    from meshdqn_tpu_torch.env import GroundTruth
    from meshdqn_tpu_torch.mesh import smooth
    from meshdqn_tpu_torch.utils import Config

    cfg = Config.from_yaml(pack_run_dir(tmp, pack))
    cfg.save_dir = tmp
    cfg.flow.precision = "f32"  # the closing re-simulation: fused, on the kernel
    gt = GroundTruth.load(os.path.join(tmp, f"{pack}_results", "ground_truth.npz"))
    data = os.path.join(REPO, "meshdqn_tpu_torch", "data")
    params, step, _ = load_deploy_weights(os.path.join(data, f"{pack}_ckpt_best_deploy.npz"),
                                          cuda)
    fix = np.load(os.path.join(data, f"{pack}_deploy_greedy.npz"))
    zero_counters()
    t0 = time.perf_counter()
    res = Deployer(cfg, gt, params, DeployOptions(complete_traj=False), device=cuda).run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    actions = [cfg.agent.N_closest if a is None else a for a in res.actions]
    nan_rows = np.isnan(fix["est_drags"])
    with np.errstate(invalid="ignore"):
        rel = max(np.nanmax(np.abs(res.est_drags / fix["est_drags"] - 1)),
                  np.nanmax(np.abs(res.est_lifts / fix["est_lifts"] - 1)))
    row = {"phase": "deploy", "step": "greedy", "pack": pack, "checkpoint_step": step,
           "steps": len(actions), "removals": len(res.removed_coords),
           "vertices": [int(res.initial_vertices), int(res.final_vertices)],
           "terminal_reason": res.terminal_reason,
           "fixture_terminal_reason": str(fix["terminal_reason"]),
           "actions_equal": actions == fix["actions"].tolist(),
           "vertices_equal": bool(np.array_equal(res.est_vertices, fix["vertices"])),
           "est_max_rel_dev": float(rel), "est_gate": DEPLOY_REL,
           "q_gap_fixture": fix["q_gap"].tolist(), "smooth_backend": smooth.last_backend,
           "wall_s": wall_s, "final_sim": res.resim_stats[-1], "launches": launches}
    emit(row)
    if not (row["actions_equal"] and row["vertices_equal"]
            and res.terminal_reason == row["fixture_terminal_reason"]):
        raise AssertionError(f"deploy {pack}: the greedy rollout differs from the fixture")
    if not (np.array_equal(np.isnan(res.est_drags), nan_rows) and rel <= DEPLOY_REL):
        raise AssertionError(f"deploy {pack}: estimates {rel:.3g} from the fixture, "
                             f"above {DEPLOY_REL}")
    return cfg, gt, params, fix, launches


def deploy_timings(cuda, cfg, gt, params, fix, flush):
    """ys930's env step (host and device), the full locate sweep and the
    Q-network's forward, each beside nvidia-smi's line."""
    from meshdqn_tpu_torch.env import AirfoilEnv
    from meshdqn_tpu_torch.fem.spaces import P2Space
    from meshdqn_tpu_torch.models import forward
    from meshdqn_tpu_torch.rl import select_action
    from meshdqn_tpu_torch.transfer.interpolate import locate
    from meshdqn_tpu_torch.utils import device_busy

    env = AirfoilEnv(cfg, ground_truth=gt, device=cuda)
    state = env.reset()
    remove = int(fix["actions"][0])  # the first greedy removal
    fresh = env.snapshot_state()
    env.step(remove)
    removed = env.snapshot_state()  # interpolants on the device: a shift gathers
    walls, syncs = {}, {}
    for kind, snap, action in (("removal", fresh, remove),
                               ("nothing", removed, env.action_space_n)):
        times = []
        for _ in range(10):
            env.restore_state(snap)
            t0 = time.perf_counter()
            _, syncs[kind] = count_syncs(lambda: env.step(action))
            times.append((time.perf_counter() - t0) * 1e3)
        walls[kind] = statistics.median(times)
    env.restore_state(fresh)
    _, busy_ms, ops = device_busy(lambda: env.step(remove))
    q_host = []
    for _ in range(10):
        t0 = time.perf_counter()
        _, q_syncs = count_syncs(lambda: int(select_action(params, state)))
        q_host.append((time.perf_counter() - t0) * 1e3)
    g_dev = type(state)(*(t.to(cuda) for t in state))
    pts = torch.tensor(P2Space(gt.mesh).dof_coords(), device=cuda)
    row = {"phase": "deploy", "step": "timings", "pack": "ys930",
           "nvidia_smi": nvidia_smi(),
           "env_removal_ms": walls["removal"], "env_nothing_ms": walls["nothing"],
           "env_removal_device_busy_ms": busy_ms, "env_removal_device_ops": ops,
           "env_removal_host_ms": walls["removal"] - busy_ms,
           "syncs_per_removal_step": syncs["removal"],
           "syncs_per_nothing_step": syncs["nothing"],
           "select_action_host_ms": statistics.median(q_host),
           "syncs_per_select_action": q_syncs,
           "locate_points": len(pts), "locate_cells": gt.mesh.num_cells,
           "locate_ms": time_ms(lambda: locate(env.transfer.src, pts), flush),
           "q_forward_ms": time_ms(lambda: forward(params, g_dev, topk=0.1), flush)}
    emit(row)
    return row


def deploy_resims(cuda, tmp, fix):
    """cli.deploy's main on ys930 with --precision auto (fused f32 on CUDA)
    through the first RESIMS removals, each re-simulated (complete_traj),
    with the counters zeroed: grouped launches counted, every re-simulated
    snapshot finite, each final drag within the config's threshold of the
    ground truth; then the last mesh again in 'f64' (unfused): the f32
    re-simulation's final drag within 1e-3 of it, the lift printed."""
    from meshdqn_tpu_torch.cli import deploy as cli_deploy
    from meshdqn_tpu_torch.deploy import run_sim
    from meshdqn_tpu_torch.utils import Config

    cfg_path = pack_run_dir(tmp, "ys930")
    removals = np.flatnonzero(np.diff(fix["vertices"]) < 0)
    max_steps = int(removals[RESIMS - 1]) + 1
    weights = os.path.join(REPO, "meshdqn_tpu_torch", "data", "ys930_ckpt_best_deploy.npz")
    zero_counters()
    res = cli_deploy.main(["--config", cfg_path, "--weights", weights,
                           "--max-steps", str(max_steps), "--precision", "auto",
                           "--profile-resim-steps", str(PROFILED_RESIM_STEPS),
                           f"save_dir={tmp}"])
    torch.cuda.synchronize()
    launches = read_counters()
    cfg = Config.from_yaml(cfg_path)
    solves = len(res.resim_stats)
    per_form = solves * (cfg.agent.solver_steps + PROFILED_RESIM_STEPS)
    expect = {**NO_LAUNCHES, **{k: per_form for k in GROUPED}}
    gt_d = float(res.complete_drags[0][-1])
    gt_l = float(res.complete_lifts[0][-1])
    errs = [abs(float(d[-1]) / gt_d - 1) for d in res.complete_drags[1:]]
    finite = all(np.isfinite(d).all() and np.isfinite(l).all()
                 for d, l in zip(res.complete_drags, res.complete_lifts))
    with open(DEPLOY_REPORT) as f:
        jax_tpu = json.load(f)["verified_greedy"]["per_step_resim_drag_err_pct"][1:RESIMS + 1]
    f32_d, f32_l = float(res.complete_drags[-1][-1]), float(res.complete_lifts[-1][-1])
    cfg64 = Config.from_yaml(cfg_path)
    cfg64.flow.precision = "f64"
    zero_counters()
    stats64 = {}
    d64, l64 = run_sim(res.best_mesh, cfg64, device=cuda, stats=stats64)
    launches64 = read_counters()
    f64_rel = [abs(f32_d / float(d64[-1]) - 1), abs(f32_l / float(l64[-1]) - 1)]
    row = {"phase": "deploy", "step": "resims", "pack": "ys930",
           "nvidia_smi": nvidia_smi(), "max_steps": max_steps,
           "removals": len(res.removed_coords), "precision": "f32 (auto on CUDA)",
           "resim_stats": res.resim_stats, "launches": launches,
           "resim_drag_err_pct": [100 * e for e in errs],
           "jax_tpu_verified_resim_drag_err_pct": jax_tpu,
           "final_drag_error_pct": res.drag_error_pct,
           "f64_last_mesh": {"stats": stats64, "launches": launches64,
                             "drag": float(d64[-1]), "lift": float(l64[-1]),
                             "f32_drag": f32_d, "f32_lift": f32_l,
                             "f32_vs_f64_rel": f64_rel}}
    emit(row)
    if res.terminal_reason != "max_steps" or len(res.removed_coords) != RESIMS:
        raise AssertionError(f"deploy resims: {len(res.removed_coords)} removals, "
                             f"terminal {res.terminal_reason}")
    if launches != expect:
        raise AssertionError(f"deploy resims: launches {launches}, expected {expect}")
    if not finite:
        raise AssertionError("deploy resims: non-finite re-simulated drag or lift")
    thr = cfg.agent.threshold
    if not (max(errs) < thr and res.drag_error_pct / 100 < thr):
        raise AssertionError(f"deploy resims: drag errors {errs}, final "
                             f"{res.drag_error_pct / 100:.3g}, above {thr}")
    # Drag only: the f32 lift of a 5000-step ys930 solve sits ~1e-3 from
    # f64 by the shedding's phase noise (PERF.md §6), in either package.
    if not f64_rel[0] < GATE:
        raise AssertionError(f"deploy resims: f32 and f64 final drag differ by "
                             f"{f64_rel[0]:.3g}, above {GATE}")
    return launches, launches64


def deploy_phase(cuda, flush):
    """The greedy deployment path on both packs, then ys930's timings and
    re-simulations; returns the launches counted, by counter."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    try:
        total = dict(NO_LAUNCHES)
        greedy = {}
        for pack in PACKS:
            greedy[pack] = deploy_greedy(cuda, pack, tmp)
            for k, v in greedy[pack][-1].items():
                total[k] += v
        deploy_timings(cuda, *greedy["ys930"][:4], flush)
        resim, f64 = deploy_resims(cuda, tmp, greedy["ys930"][3])
        for counted in (resim, f64):
            for k, v in counted.items():
                total[k] += v
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Training (cli.train): the learner against the JAX package's fixture, the
# batched forward, a full-width resumed run and a deploy probe.
# ----------------------------------------------------------------------

TRAIN_SWEEPS = 8  # sweeps of the resumed full-width run (--max-steps +8*32)
MEASURED_SWEEPS = 2  # sweeps profiled after it
UPDATE_REL_64 = 1e-9  # f64 steps against the JAX package's f64 steps
LOSS_REL_64 = 1e-11


def train_fixture():
    """(fixture arrays, the converted ys930 learner's arrays, DQNConfig)."""
    from meshdqn_tpu_torch.rl import DQNConfig

    data = os.path.join(REPO, "meshdqn_tpu_torch", "data")
    with np.load(os.path.join(data, "ys930_train_fixture.npz")) as z:
        fx = {k: z[k] for k in z.files}
    with np.load(os.path.join(data, "ys930_ckpt_state.npz")) as z:
        state = {k: z[k] for k in z.files if k not in ("step", "extras_json")}
    cfg = json.loads(str(fx["dqn_config_json"]))
    cfg["milestones"] = tuple(cfg["milestones"])
    return fx, state, DQNConfig(**cfg)


def train_steps_vs_fixture(dev, fx, state, cfg):
    """(a) K gradient steps from the converted checkpoint on the fixture's
    pool, f32 and f64, against the JAX package's: f64 within LOSS_REL_64 /
    UPDATE_REL_64, f32's deviation from f64 within 2x of JAX's own."""
    from meshdqn_tpu_torch.convert import dqn_state_from_numpy, dqn_state_to_numpy
    from meshdqn_tpu_torch.rl import ReplayStore, train_step_many_idx

    store = ReplayStore(**{k: torch.from_numpy(fx[f"pool/{k}"]).to(dev)
                           for k in ReplayStore._fields})
    idx = torch.from_numpy(fx["idx"]).to(dev)
    keys = sorted(k for k in state if k.startswith("params1/"))
    vec = lambda get: np.concatenate([np.asarray(get(k), np.float64).ravel()  # noqa: E731
                                      for k in keys])
    before = vec(lambda k: state[k])
    d64 = vec(lambda k: fx["f64/" + k[len("params1/"):]]) - before
    d32 = vec(lambda k: fx["f32/" + k[len("params1/"):]]) - before
    out = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        st = dqn_state_from_numpy(state, cfg, dev, dtype)
        st, losses = train_step_many_idx(st, store, idx, cfg)
        arrays = dqn_state_to_numpy(st)
        out[name] = (losses.cpu().numpy(), vec(lambda k: arrays[k]) - before)
    rms = lambda v: float(np.sqrt(np.mean(np.square(v))))  # noqa: E731
    l64 = fx["loss_f64"]
    upd = lambda d: float(np.linalg.norm(d - d64) / np.linalg.norm(d64))  # noqa: E731
    row = {"phase": "train", "step": "train_step_fixture", "K": int(idx.shape[0]),
           "B": int(idx.shape[1]), "config": {k: getattr(cfg, k) for k in (
               "target_mode", "double", "target_clip", "cql_alpha", "grad_clip", "head")},
           "loss_f64_rel_dev": float(np.max(np.abs(out["f64"][0] / l64 - 1))),
           "update_f64_rel_dev": upd(out["f64"][1]),
           "loss_f32_rms_dev": {"port": rms(out["f32"][0] / l64 - 1),
                                "jax": rms(fx["loss_f32"] / l64 - 1)},
           "update_f32_rel_dev": {"port": upd(out["f32"][1]), "jax": upd(d32)},
           "losses_f32": out["f32"][0].tolist(), "jax_losses_f32": fx["loss_f32"].tolist()}
    emit(row)
    if not (row["loss_f64_rel_dev"] <= LOSS_REL_64 and row["update_f64_rel_dev"] <= UPDATE_REL_64):
        raise AssertionError("train: the f64 steps differ from the JAX package's")
    for key in ("loss_f32_rms_dev", "update_f32_rel_dev"):
        if not row[key]["port"] <= 2 * row[key]["jax"]:
            raise AssertionError(f"train: f32 {key} outside 2x of the JAX package's")
    return row


def batched_forward_vs_single(dev, fx, state, cfg):
    """(b) batched_forward over the pool's 64 states against the per-graph
    forward, both on the card, by the repo's 2x rule: held to the exact
    evaluation of the same network (the per-graph forward in f64 on the
    card, which runs none of the batch axis's code), the batch's deviation
    (RMS over the graphs of max |dQ| / max |Q|) within 2x of the per-graph
    f32 forward's, and the same argmax as both.  Two f32 forwards that sum
    in different orders each lie up to ~2e-5 of max |Q| from the exact
    values, so their gap to each other is printed, not gated.  The CPU's
    batch is printed beside."""
    from meshdqn_tpu_torch.convert import dqn_state_from_numpy
    from meshdqn_tpu_torch.env import GraphState
    from meshdqn_tpu_torch.models import batched_forward, forward

    graphs = GraphState(*(torch.from_numpy(fx[f"pool/{k}"][0])
                          for k in ("x", "ei", "ea", "nm", "em")))
    on_dev = GraphState(*(t.to(dev) for t in graphs))
    params = dqn_state_from_numpy(state, cfg, dev).params1
    with torch.no_grad():
        q = batched_forward(params, on_dev, topk=cfg.topk, head=cfg.head).cpu().numpy()
        per_graph = lambda p: np.stack([  # noqa: E731
            forward(p, GraphState(*(t[b] for t in graphs)), topk=cfg.topk,
                    head=cfg.head).cpu().numpy() for b in range(len(q))])
        single = per_graph(params)
        q64 = per_graph(dqn_state_from_numpy(state, cfg, dev, torch.float64).params1)
        q_cpu = batched_forward(dqn_state_from_numpy(state, cfg, "cpu").params1, graphs,
                                topk=cfg.topk, head=cfg.head).numpy()
    scale = np.abs(q64).max(1)
    dev_of = lambda a: np.abs(a - q64).max(1) / scale  # noqa: E731
    rms = lambda v: float(np.sqrt(np.mean(np.square(v))))  # noqa: E731
    row = {"phase": "train", "step": "batched_forward", "graphs": len(q),
           "rms_dev_from_f64": {"batched": rms(dev_of(q)), "single": rms(dev_of(single)),
                                "cpu_batched": rms(dev_of(q_cpu))},
           "max_rel_dev_vs_single": float((np.abs(q - single).max(1) / scale).max()),
           "argmax_equal": bool((q.argmax(1) == single.argmax(1)).all()
                                and (q.argmax(1) == q64.argmax(1)).all()),
           "argmax_equal_cpu": bool((q.argmax(1) == q_cpu.argmax(1)).all())}
    emit(row)
    dev_rms = row["rms_dev_from_f64"]
    if not (row["argmax_equal"] and np.isfinite(q).all()
            and dev_rms["batched"] <= 2 * dev_rms["single"]):
        raise AssertionError("train: batched_forward differs from the per-graph forward")
    return row


def kernel_busy(fn):
    """(fn(), the summed device time of the kernels, copies and fills it ran
    in ms, their count), from torch.profiler's raw device records (CUDA
    activity only; key_averages' parse of a whole sweep's ~50k launches
    and their CPU ops takes longer than the sweep)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy_ns, ops = 0, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            busy_ns += ev.duration_ns()
            ops += 1
    return out, busy_ns / 1e6, ops


def ring_consistent(trainer, pushes: int) -> int:
    """Slots of the ring as pushed: slot s*n+i holds env i's s-th transition
    of the run, so each non-final transition's next state is the state of
    the env's next slot.  Returns the number of slot pairs checked."""
    n = len(trainer.envs)
    st = trainer.replay.store
    checked = 0
    for slot in range(pushes - n):
        if bool(st.non_final[slot]):
            for ring in ("x", "ei", "nm", "em"):
                r = getattr(st, ring)
                if not torch.equal(r[1, slot], r[0, slot + n]):
                    raise AssertionError(f"train: ring slot {slot + n} is not the next "
                                         f"state of slot {slot} ({ring})")
            checked += 1
    return checked


def sweep_marks(fn):
    """(fn(), marks): a (perf_counter, MESHDQN_TIMING buckets, num_grads)
    mark at the end of every full sweep of the Trainer that fn runs (where
    Trainer.train calls _maybe_stop)."""
    from meshdqn_tpu_torch.train import Trainer

    marks, inner = [], Trainer._maybe_stop

    def mark(self):
        marks.append((time.perf_counter(), dict(self.timing), self.dqn.num_grads))
        inner(self)

    Trainer._maybe_stop = mark
    try:
        return fn(), marks
    finally:
        Trainer._maybe_stop = inner


def steady_sweeps(marks, n_envs: int) -> dict:
    """The run's sweeps between two marks that applied a whole sweep's
    batches (n_envs gradient steps, queued by the sweep before): their wall
    ms and the MESHDQN_TIMING buckets' ms, as a mean and each.  The run's
    first sweeps (a resumed run starts with an empty ring), and its last,
    whose batches are applied after the return, are not steady."""
    sweeps = []
    for (t0, b0, g0), (t1, b1, g1) in zip(marks, marks[1:]):
        if g1 - g0 == n_envs:
            sweeps.append((1e3 * (t1 - t0), {k: 1e3 * (b1[k] - b0[k]) for k in b1
                                             if k != "sweeps"}))
    mean = lambda v: float(np.mean(v)) if v else None  # noqa: E731
    return {"count": len(sweeps), "of_marked": max(len(marks) - 1, 0),
            "grad_steps_each": n_envs, "ms_each": [ms for ms, _ in sweeps],
            "ms_mean": mean([ms for ms, _ in sweeps]),
            "buckets_ms_mean": {k: mean([b[k] for _, b in sweeps]) for k in
                                (sweeps[0][1] if sweeps else {})}}


def train_run(dev, tmp, fx, state, cfg, sweeps=TRAIN_SWEEPS, measured=MEASURED_SWEEPS,
              overrides=()):
    """(c) cli.train's main at the pack's config, resumed from the converted
    checkpoint in a temp run dir, for `sweeps` sweeps; (d) one deploy probe."""
    from meshdqn_tpu_torch.cli import train as cli_train
    from meshdqn_tpu_torch.convert import dqn_state_from_numpy, dqn_state_to_numpy
    from meshdqn_tpu_torch.rl import train_step_many_idx
    from meshdqn_tpu_torch.train import CheckpointManager, Trainer
    from meshdqn_tpu_torch.utils import Config

    marks = [("start", time.perf_counter())]
    cfg_path = pack_run_dir(tmp, "ys930")
    with np.load(os.path.join(REPO, "meshdqn_tpu_torch", "data", "ys930_ckpt_state.npz")) as z:
        step0, extras0 = int(z["step"]), json.loads(str(z["extras_json"]))
    run_dir = os.path.join(tmp, "ys930_results")
    CheckpointManager(os.path.join(run_dir, "ckpt")).save(
        step0, dqn_state_from_numpy(state, cfg, dev), extras0)
    config = Config.from_yaml(cfg_path).apply_overrides([f"save_dir={tmp}", *overrides])
    n_envs = config.agent.num_parallel
    gs0, grads0 = int(extras0["global_step"]), int(state["num_grads"])
    pushes = sweeps * n_envs
    zero_counters()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    os.environ["MESHDQN_TIMING"] = "1"
    t0 = time.perf_counter()
    argv = ["--config", cfg_path, "--max-steps", str(gs0 + pushes), f"save_dir={tmp}",
            *overrides] + (["--cpu"] if dev.type == "cpu" else [])
    counted = count_syncs if dev.type == "cuda" else (lambda fn: (fn(), None))
    (trainer, syncs), ends = sweep_marks(lambda: counted(lambda: cli_train.main(argv)))
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    trainer.metrics._flush_losses()
    losses = np.asarray(trainer.metrics.losses)
    queued = pushes - (config.optimizer.batch_size - 1)
    timing = dict(trainer.timing)
    marks.append(("run", time.perf_counter()))
    checked = ring_consistent(trainer, pushes)
    # A second Trainer resumes the checkpoint the run ended with.
    second = Trainer(config, resume=True, device=dev)
    resumed = {"global_step": second.state.global_step, "episode": second.state.episode,
               "num_grads": second.dqn.num_grads}
    same = all(np.array_equal(a, b) for a, b in zip(dqn_state_to_numpy(second.dqn).values(),
                                                   dqn_state_to_numpy(trainer.dqn).values()))
    del second
    marks.append(("ring_and_resume", time.perf_counter()))
    gate = {
        "losses_finite": bool(len(losses) and np.isfinite(losses).all()),
        "num_grads_equal_queued": trainer.dqn.num_grads - grads0 == queued,
        "ring_equal_pushes": (len(trainer.replay), trainer.replay._pos) == (pushes, pushes),
        "resumed_counters_equal": resumed == {"global_step": trainer.state.global_step,
                                              "episode": trainer.state.episode,
                                              "num_grads": trainer.dqn.num_grads},
        "resumed_learner_equal": same,
        "no_kernel_launches": launches == NO_LAUNCHES,
    }
    row = {"phase": "train", "step": "run", "nvidia_smi": nvidia_smi() if dev.type == "cuda"
           else None, "envs": n_envs, "batch": config.optimizer.batch_size,
           "replay_capacity": config.agent.replay_capacity, "sweeps": sweeps,
           "global_step": [gs0, trainer.state.global_step],
           "num_grads": [grads0, trainer.dqn.num_grads], "queued_batches": queued,
           "episodes_finished": trainer.state.episode - step0,
           "ring_slot_pairs_checked": checked, "wall_s_with_setup": wall_s,
           "timing_s": timing, "steady_sweeps": steady_sweeps(ends, n_envs),
           "syncs_whole_run": syncs, "peak_mem_GB": peak / 1e9 if peak else None,
           "launches": launches, "loss_median": float(np.median(losses)), "gate": gate}
    # Measured: MEASURED sweeps under the profiler, counting syncs (the
    # run's closing flush, metrics write and checkpoint included), and the
    # gradient step alone between events.
    if dev.type == "cuda" and measured:
        gs = trainer.state.global_step
        (s, busy_ms, ops), m_syncs = count_syncs(lambda: kernel_busy(
            lambda: trainer.train(max_steps=gs + measured * n_envs)))
        marks.append(("measured_sweeps", time.perf_counter()))
        idx = torch.from_numpy(np.stack([trainer.replay.sample_indices(
            config.optimizer.batch_size, np.random.default_rng(k)) for k in range(n_envs)])
        ).to(dev)
        train_step_many_idx(trainer.dqn, trainer.replay.store, idx[:2], trainer.dqn_cfg)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        start.record()
        train_step_many_idx(trainer.dqn, trainer.replay.store, idx, trainer.dqn_cfg)
        end.record()
        host_ms = (time.perf_counter() - t1) * 1e3
        torch.cuda.synchronize()
        (_, step_busy, step_ops) = kernel_busy(lambda: train_step_many_idx(
            trainer.dqn, trainer.replay.store, idx[:4], trainer.dqn_cfg))
        marks.append(("grad_step_timing", time.perf_counter()))
        row.update({
            "measured_sweeps": measured, "device_busy_ms_per_sweep": busy_ms / measured,
            "device_ops_per_sweep": ops / measured, "syncs_per_sweep": m_syncs / measured,
            "measured_wall_s_profiled": s["wall_s"],
            "grad_step_ms_events": start.elapsed_time(end) / n_envs,
            "grad_step_host_enqueue_ms": host_ms / n_envs,
            "grad_step_device_busy_ms": step_busy / 4, "grad_step_device_ops": step_ops / 4,
            "grad_steps_timed": n_envs})
    # (d) one greedy deploy probe episode on the card.
    t2 = time.perf_counter()
    probe = trainer._deploy_probe()
    row["deploy_probe"] = dict(probe, wall_s=time.perf_counter() - t2)
    marks.append(("deploy_probe", time.perf_counter()))
    row["phase_seconds"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    gate["probe_reward_finite"] = bool(np.isfinite(probe["reward"]))
    emit(row)
    failed = [k for k, v in gate.items() if not v]
    if failed:
        raise AssertionError(f"train: run gates failed: {failed}")
    return row


def train_phase(dev):
    """The training path on `dev`: (a)-(d) above."""
    fx, state, cfg = train_fixture()
    train_steps_vs_fixture(dev, fx, state, cfg)
    batched_forward_vs_single(dev, fx, state, cfg)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        return train_run(dev, tmp, fx, state, cfg)
    finally:
        os.environ.pop("MESHDQN_TIMING", None)
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--diag", action="store_true",
                        help="also run the cg_diag phase (~2 min more)")
    args = parser.parse_args(argv)
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
    pk = peaks(kind)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "mem_peak_B_s": pk[0],
          "f32_peak_flop_s": pk[1], "f64_peak_flop_s": pk[2]})

    sources = ("matvec", "banded", "ell")
    t0 = time.perf_counter()
    build.compile_all(sources)
    for name in sources:
        build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [f"meshdqn_tpu_torch/csrc/{n}.cu" for n in sources]})

    packs = {name: load_pack(name) for name in PACKS}
    finest = {name: load_finest(name) for name in AIRFOILS}
    flush = torch.empty(64 * 2**20 // 4, device=cuda)  # > the 50 MB L2
    summary = check_kernels(cuda, {n: p[0] for n, p in packs.items()},
                            pk[0], pk[1], flush)
    summary["matvec_cols"] = check_cols(cuda, {n: p[0] for n, p in packs.items()},
                                        pk[0], pk[1], flush)
    summary["matvec_group_df32"] = check_split(cuda, packs, pk[0], pk[1], flush)
    summary.update(check_cg_kernels(cuda, {n: f[0] for n, f in finest.items()},
                                    pk, flush))
    summary["ell_matmat"]["unfused_steps"] = check_unfused_ell(cuda, packs, pk, flush)
    del flush

    # The fused path (first slice).
    launches = {k: 0 for k in summary}
    by_path = {k: {} for k in summary}
    by_form = {k: 0 for k in GROUPED}
    rows, last = {}, None
    for name, (mesh, z, meta) in packs.items():
        solver, state, counted, rows[name] = solve_pack(cuda, name, mesh, z, meta,
                                                        pk[0])
        counted["matvec_group"] = sum(counted[k] for k in GROUPED)
        for k in ("matvec", "matvec_dual", "matvec_group"):
            launches[k] += counted[k]
            by_path[k]["solve"] = by_path[k].get("solve", 0) + counted[k]
        for k in GROUPED:
            by_form[k] += counted[k]
        grouped_bits(name, solver, state)
        if last is None:
            last = (solver, state)
        del solver, state
    profile_steps(*last, path="fused")
    del last
    for name, (mesh, z, meta) in packs.items():
        solve_f64(cuda, name, mesh, z, meta, rows[name])

    # The other dense modes: 'f64' (IPCSConfig()), 'mixed', f32 unfused and
    # 'df32'.
    by_split = {k: 0 for k in SPLIT}
    dense_rows = {}
    for mode in DENSE_MODES:
        for name, (mesh, z, meta) in packs.items():
            solver, out, row = dense_phase(cuda, mode, name, mesh, z, meta, rows[name])
            dense_rows[mode, name] = row
            counted = dict(row["launches"],
                           matvec_group_df32=sum(row["launches"][k] for k in SPLIT))
            for k in ("matvec", "ell_matmat", "matvec_group_df32"):
                if counted[k]:
                    launches[k] += counted[k]
                    by_path[k][mode] = by_path[k].get(mode, 0) + counted[k]
            for k in SPLIT:
                by_split[k] += counted[k]
            if name == PACKS[0]:
                profile_steps(solver, out["state"], path=mode)
            del solver, out
    emit({"phase": "df32_vs_f32", "final_rel_err": {
        name: {"fused_f32": dense_rows["df32", name]["fused_f32_drag_lift_rel_err"],
               "df32": [dense_rows["df32", name]["drag_rel_err"][-1],
                        dense_rows["df32", name]["lift_rel_err"][-1]],
               "jax_tpu_df32": JAX_TPU_DF32[name]}
        for name in packs}})

    # The large-mesh CG path.
    cg_rows = {}
    for name, (mesh, oracle) in finest.items():
        solver, out, row = cg_solve(cuda, name, mesh, oracle, pk)
        cg_rows[name] = (out, row["ms_per_step"])
        for k in ("banded_matmat", "ell_matmat"):
            launches[k] += row["launches"][k]
            by_path[k]["cg_solve"] = by_path[k].get("cg_solve", 0) + row["launches"][k]
        if name == AIRFOILS[0]:
            profile_steps(solver, out["state"], path="cg")
        del solver, out
    for name, (mesh, oracle) in finest.items():
        cg_oracle(name, mesh, oracle, profile=name == AIRFOILS[0])
    if args.diag:
        for name, (mesh, oracle) in finest.items():
            cg_diag(name, mesh, oracle, *cg_rows[name])

    # The ensemble (the k-column form) and the batched flows (the grouped
    # form's batched instance) on ys930.
    mesh, z, meta = packs[PACKS[0]]
    counted = ensemble_phase(cuda, mesh, z, meta, rows[PACKS[0]]["ms_per_step"])
    launches["matvec_cols"] = counted["matvec"]
    by_path["matvec_cols"] = {"ensemble": counted["matvec"]}
    flush = torch.empty(64 * 2**20 // 4, device=cuda)
    counted, summary["matvec_group_batched"] = batched_phase(cuda, mesh, meta, pk, flush)
    del flush
    by_batched_form = {k: counted[k] for k in BATCHED}
    launches["matvec_group_batched"] = sum(by_batched_form.values())
    by_path["matvec_group_batched"] = {"batched": launches["matvec_group_batched"]}

    # Greedy deployment: both packs' rollouts, the re-simulations on ys930.
    flush = torch.empty(64 * 2**20 // 4, device=cuda)
    counted = deploy_phase(cuda, flush)
    del flush
    counted["matvec_group"] = sum(counted[k] for k in GROUPED)
    for k in ("matvec", "matvec_group", "ell_matmat"):
        if counted[k]:
            launches[k] += counted[k]
            by_path[k]["deploy"] = counted[k]
    for k in GROUPED:
        by_form[k] += counted[k]

    # Training: no TPU kernel lies on its path (train_phase asserts that it
    # launches none of the port's kernels).
    train_phase(cuda)

    src = {"matvec": "matvec", "matvec_dual": "matvec", "matvec_group": "matvec",
           "matvec_group_df32": "matvec", "matvec_cols": "matvec",
           "matvec_group_batched": "matvec", "banded_matmat": "banded",
           "ell_matmat": "ell"}
    replaces = {"matvec": "meshdqn_tpu/ops/pallas_kernels.py:124",
                "matvec_group": "meshdqn_tpu/ops/pallas_kernels.py:124",
                "matvec_cols": "meshdqn_tpu/ops/pallas_kernels.py:124",
                "matvec_group_batched": "meshdqn_tpu/ops/pallas_kernels.py:124",
                "matvec_group_df32": "meshdqn_tpu/ops/pallas_kernels.py:124",
                "matvec_dual": "meshdqn_tpu/ops/pallas_kernels.py:134",
                "banded_matmat": "meshdqn_tpu/ops/pallas_kernels.py:250",
                "ell_matmat": "meshdqn_tpu/ops/pallas_kernels.py:39"}
    # The banded kernel also takes the aligned layout and bf16 blocks.
    also = {"banded_matmat": ["meshdqn_tpu/ops/pallas_kernels.py:318",
                              "scripts/banded_formulation_bench.py:180"]}
    note = {"matvec": "sums over the seven applies of one ys930 fused step (the "
                      "single form: the grouped launches' bitwise yardstick)",
            "matvec_group": "sums over the three grouped launches of one ys930 fused "
                            "step; composed_ms times the same step as seven single "
                            "launches and torch's elementwise ops, singles_ms sums "
                            "the single launches' own times",
            "matvec_group_df32": "sums over the three split launches of one ys930 "
                                 "df32 step on the production limbs; composed_ms "
                                 "times the same step through torch with the low "
                                 "limbs widened to f32 beforehand, f32_grouped_ms "
                                 "the f32 grouped launches on the high limbs",
            "matvec_dual": "sums over the seven applies of one ys930 fused step",
            "matvec_cols": "sums over the seven k-column launches of one ys930 "
                           "ensemble step at 16 members (F3s at 32 columns); "
                           "library_ms sums torch.matmul on the same products",
            "matvec_group_batched": "sums over the three batched launches of one "
                                    "step of the sweep's five members, on seeded "
                                    "operands at its stacked sizes; composed_ms "
                                    "times the same as five grouped launches a form",
            "banded_matmat": "sums over the 18 banded applies of one ys930 finest "
                             "production CG step",
            "ell_matmat": "sums over the 2 ELL applies of one ys930 finest "
                          "production CG step (f32); oracle_step sums the 54 of "
                          "one ys930 finest f64 oracle step, unfused_steps the "
                          "6 or 8 of one ys930 pack step of each unfused mode"}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": f"meshdqn_tpu_torch/csrc/{src[k]}.cu",
         "replaces": replaces[k], "also_replaces": also.get(k, []),
         "launches": launches[k],
         "launches_by_path": by_path[k], "on_main_path": launches[k] > 0,
         "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
         "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
         "library_ms": s["library_ms"],
         **{k: s[k] for k in ("read_bound_ms", "nnz_bound_ms", "stored_bound_ms",
                              "composed_ms", "singles_ms", "f32_grouped_ms",
                              "oracle_step", "unfused_steps") if k in s},
         **({"launches_by_form": by_form} if k == "matvec_group" else {}),
         **({"launches_by_form": by_split} if k == "matvec_group_df32" else {}),
         **({"launches_by_form": by_batched_form} if k == "matvec_group_batched"
            else {}),
         "note": f"ms, plain_ms, bound_ms and library_ms are {note[k]}"}
        for k, s in summary.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

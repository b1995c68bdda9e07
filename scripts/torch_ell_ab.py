#!/usr/bin/env python3
"""Time the ELL products of the CG paths and their solves on one GPU, for
the PyTorch/CUDA port of a given checkout, with chip_smoke.py's timer.

    python3 scripts/torch_ell_ab.py [--root DIR] [--label NAME] [--steps N]
        [--out FILE] [--against FILE ...] [--sweep]

--root names a checkout of this repository (default: this one) whose
`meshdqn_tpu_torch` is imported.  The timer (chip_smoke.time_ms: median of
25 launches, each after an L2 eviction and a 0.5 ms device spin), the
meshes, the shapes (chip_smoke.ELL_OPS) and the step plans
(chip_smoke.STEP_ELL, ORACLE_STEP) are this checkout's, so checkouts run one
after the other in one call are timed alike.  On both finest meshes it
reports:

* each operator of the ELL layout in f32 and f64 at the column count the
  solver gives it, built by `EllMatrix.from_scipy` and applied by its
  `matmat`, as the solver does: a digest of y (after a check against the
  plain version within ops.matvec.gap_tolerance), the kernel's and
  torch.sparse CSR's times, and the stored and read bytes; with --sweep
  also the kernel's time at every lane count, with slices of their own
  widths and uniform ones (each bit-equal to the default's y; the
  checkout's private packer `ops.sparse._pack`), the evidence for
  choose_lanes and choose_uniform;
* the sums over the ys930 production step's 2 applies (f32) and the f64
  oracle step's 54;
* with --steps N > 0, the production CG solve (chip_smoke.PRODUCTION) and
  the oracle's f64 ELL solve (chip_smoke.ORACLE) for N steps from rest:
  device ms/step (CUDA events), host ms/step, the launch counters, and the
  snapshot drag and lift as exact floats (float.hex).

Prints one JSON line (and writes it to --out).  --against names earlier
outputs of this script: every digest and every snapshot drag and lift that
both runs have must be equal, or the script exits non-zero.  To compare two
commits, unpack the parent's `meshdqn_tpu_torch/` (git archive) into a
git-ignored directory and run parent, change, change, parent in one call.
"""
import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def products(torch, cs, cuda, flush, sweep):
    """Every ELL operator of both finest meshes, f32 and f64."""
    from torch_matvec_ab import digest

    from meshdqn_tpu_torch.ops import matvec as mv
    from meshdqn_tpu_torch.ops import sparse
    from meshdqn_tpu_torch.solver import IPCSConfig
    from meshdqn_tpu_torch.solver.ipcs import cg_matrices

    out = {}
    for airfoil in cs.AIRFOILS:
        mesh, _ = cs.load_finest(airfoil)
        mats = cg_matrices(mesh, IPCSConfig(**cs.ORACLE))["matrices"]
        for dtype in (torch.float32, torch.float64):
            for op, m in cs.ELL_OPS:
                A = mats[op]
                e = sparse.EllMatrix.from_scipy(A, device=cuda, dtype=dtype)
                g = torch.Generator(device=cuda).manual_seed(A.shape[0] + m)
                X = torch.randn((A.shape[1],) if m == 1 else (A.shape[1], m),
                                device=cuda, dtype=dtype, generator=g)
                y = e.matmat(X)
                gap = mv.relative_gap(y, sparse.ell_matmat_reference(e.cols, e.vals, X))
                tol = mv.gap_tolerance(e.cols.shape[1], dtype)
                if not gap <= tol:
                    raise AssertionError(f"{airfoil} {op} {dtype}: ||y - plain|| / "
                                         f"||plain|| = {gap:.3g} above {tol:.3g}")
                xy = sum(A.shape) * m * X.element_size()
                csr = cs.csr_tensor(A, cuda, dtype)
                X2 = X.view(X.shape[0], -1)
                row = {"m": m, "K": e.cols.shape[1], "nnz": int(A.nnz),
                       "digest": digest(y), "gap": gap, "tol": tol,
                       "ms": cs.time_ms(lambda: e.matmat(X), flush),
                       "csr_ms": cs.time_ms(lambda: csr @ X2, flush),
                       "stored_MB": e.nbytes / 1e6,
                       "read_MB": (e.read_bytes(m) if hasattr(e, "read_bytes")
                                   else e.nbytes + xy) / 1e6,
                       "nnz_MB": (A.nnz * (X.element_size() + 4) + (A.shape[0] + 1) * 4
                                  + xy) / 1e6}
                if hasattr(e, "slices"):
                    row.update(lanes=e.slices.lanes, fill=e.slices.fill,
                               uniform=getattr(e.slices, "uniform", 0))
                if sweep and hasattr(sparse, "_pack"):
                    row["sweep_ms"] = {}
                    for lanes in sparse.LANES:
                        for uniform in (False, True):
                            el = dataclasses.replace(e, slices=sparse._pack(
                                e.cols.cpu().numpy(), e.vals.cpu().numpy(), A.shape[1],
                                device=cuda, lanes=lanes, uniform=uniform))
                            if not torch.equal(el.matmat(X), y):
                                raise AssertionError(f"{airfoil} {op} {dtype}: {lanes} "
                                                     f"lanes, uniform={uniform} change "
                                                     "the bits")
                            key = f"{lanes}{'u' if uniform else 's'}"
                            row["sweep_ms"][key] = cs.time_ms(lambda: el.matmat(X), flush)
                            del el
                out[f"{airfoil}/{str(dtype).replace('torch.', '')}/{op}"] = row
                del e, csr, X, X2, y
        del mats
    return out


def step_sums(cs, shapes):
    """The ys930 production step's 2 ELL applies (f32) and the f64 oracle
    step's 54: kernel, CSR and bound (read, stored and nnz bytes) in ms."""
    sums = {}
    for name, dtype, plan in (("production_f32", "float32", cs.STEP_ELL),
                              ("oracle_f64", "float64", cs.ORACLE_STEP)):
        tot = dict.fromkeys(("ms", "csr_ms", "read_MB", "stored_MB", "nnz_MB"), 0.0)
        for op, _, count in plan:
            r = shapes[f"{cs.AIRFOILS[0]}/{dtype}/{op}"]
            for k in tot:
                tot[k] += count * r[k]
        for k in ("read", "stored", "nnz"):
            tot[f"{k}_bound_ms"] = tot[f"{k}_MB"] * 1e6 / 3.35e12 * 1e3
        sums[name] = dict(tot, applies=sum(c for _, _, c in plan))
    return sums


def solves(torch, cs, cuda, steps, label):
    """cg_solve and cg_oracle for `steps` steps from rest on both meshes."""
    from meshdqn_tpu_torch.solver import FlowState, IPCSConfig, IPCSSolver

    out = {}
    for airfoil in cs.AIRFOILS:
        mesh, oracle = cs.load_finest(airfoil)
        for name, cfg in (("cg_solve", cs.PRODUCTION), ("cg_oracle", cs.ORACLE)):
            solver = IPCSSolver(mesh, IPCSConfig(**cfg))
            dt = solver.dev.t1.dtype
            g = torch.Generator(device=cuda).manual_seed(0)
            solver.evolve(FlowState(
                u=1e-3 * torch.randn(solver.ndofs_u, device=cuda, generator=g, dtype=dt),
                p=torch.zeros(solver.ndofs_p, device=cuda, dtype=dt)), 10)
            res, ms, host_ms, counts = cs.timed_solve(solver, steps, min(1000, steps))
            cs.check_finite(airfoil, solver, res)
            out[f"{airfoil}/{name}"] = {
                "ms_per_step": ms, "host_ms_per_step": host_ms, "launches": counts,
                "snap_drags": [float(d).hex() for d in res["snap_drags"]],
                "snap_lifts": [float(x).hex() for x in res["snap_lifts"]],
                "drag_minus_oracle": float(res["snap_drags"][-1]) - oracle["drag"],
                "lift_minus_oracle": float(res["snap_lifts"][-1]) - oracle["lift"]}
            if airfoil == cs.AIRFOILS[0] and name == "cg_oracle":
                cs.profile_steps(solver, res["state"], path=f"cg_oracle {label}")
            del solver, res
    return out


def compare(mine: dict, other: dict) -> list:
    """Paths of the digests and exact floats that both runs have and that
    differ."""
    diffs = []

    def walk(a, b, path):
        if isinstance(a, dict) and isinstance(b, dict):
            for k in a.keys() & b.keys():
                walk(a[k], b[k], path + [k])
        elif path[-1] in ("digest", "snap_drags", "snap_lifts") and a != b:
            diffs.append("/".join(path))

    walk({k: mine[k] for k in ("shapes", "solves")},
         {k: other[k] for k in ("shapes", "solves")}, [])
    return diffs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose port is timed")
    ap.add_argument("--label", default=None, help="name printed with the result")
    ap.add_argument("--steps", type=int, default=5000,
                    help="steps of each solve (0: no solves)")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--against", nargs="*", default=[],
                    help="earlier outputs whose digests and snapshots must be equal")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every lane count, sliced and uniform")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import chip_smoke as cs  # this checkout's; it imports the port only in calls

    sys.path.insert(0, root)
    import meshdqn_tpu_torch

    pkg = os.path.dirname(os.path.abspath(meshdqn_tpu_torch.__file__))
    if pkg != os.path.join(root, "meshdqn_tpu_torch"):
        raise AssertionError(f"imported the port from {pkg}, not from {root}")
    cuda = torch.device("cuda", torch.cuda.current_device())
    flush = torch.empty(64 * 2**20 // 4, device=cuda)  # > the 50 MB L2
    result = {"label": args.label, "root": root, "card": cs.nvidia_smi()}
    result["shapes"] = products(torch, cs, cuda, flush, args.sweep)
    result["step_sums"] = step_sums(cs, result["shapes"])
    result["solves"] = (solves(torch, cs, cuda, args.steps, args.label or root)
                        if args.steps > 0 else {})
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    failed = False
    for path in args.against:
        with open(path) as f:
            other = json.loads(f.readline())
        diffs = compare(result, other)
        print(json.dumps({"label": args.label, "against": other["label"],
                          "bits_equal": not diffs, "differences": diffs}), flush=True)
        failed |= bool(diffs)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of `correct` are set from.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]
        [--control-seeds K] [--out FILE]

For each seed, the cell's `compared_solves` solves from that seed's inputs,
each read by the numbers of portbench/check.py against the plain reference
in float64:

- program: the program's solve, as a run of the benchmark computes it;
- control: the reference itself in the program's place, with TF32
  products (the nearest precision below the float32 that the
  configuration states), for the first K seeds (default 3).

One JSON line per seed.  The limits in portbench/limits/<workload>.json lie
above the largest program reading and below the smallest control reading.
The benchmark's own runs do not run this.  Needs a CUDA card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(cell, seeds, control_seeds: int, device, emit=print) -> list:
    """One row a seed: {"seed", "program", "control" (or None), seconds}."""
    from portbench import check, harness
    from portbench.reference.ipcs import ReferenceFlow

    tr, flow = cell.traffic, cell.config["flow"]
    mesh_list = harness.meshes(cell)
    ns = [harness.Mesh(c, t).ns for c, t in mesh_list]
    driver = harness.part(cell, "drivers", tr["driver"]).Driver(
        cell.config, cell.mesh_set, mesh_list, device)
    refs = {}
    for prec in ("f64", "tf32"):
        refs[prec] = [ReferenceFlow(c, t, mu=flow["mu"], rho=flow["rho"], dt=flow["dt"],
                                    device=device, precision=prec) for c, t in mesh_list]
    rows = []
    for n, seed in enumerate(seeds):
        inputs = harness.Inputs(seed, tr["perturbation"], ns, driver.n_u)
        row = {"seed": seed, "program": [], "control": [] if n < control_seeds else None}
        secs = {"program_s": 0.0, "reference_s": 0.0, "control_s": 0.0}
        for i in range(tr["compared_solves"]):
            t = time.perf_counter()
            d, l, u, p = driver.solve(inputs.program(i))
            u, p = u.cpu().numpy(), p.cpu().numpy()
            secs["program_s"] += time.perf_counter() - t
            for b, u0 in enumerate(inputs.plain(i)):
                t = time.perf_counter()
                ref = refs["f64"][b].solve(u0, flow["solver_steps"])
                secs["reference_s"] += time.perf_counter() - t
                row["program"].append(check.gaps((d[b], l[b], u[b], p[b]), ref))
                if row["control"] is not None:
                    t = time.perf_counter()
                    ctl = refs["tf32"][b].solve(u0, flow["solver_steps"])
                    secs["control_s"] += time.perf_counter() - t
                    row["control"].append(check.gaps(ctl, ref))
        row["program"] = check.worst(row["program"])
        row["control"] = row["control"] and check.worst(row["control"])
        row.update(secs)
        emit(row)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(ROOT, args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps({"workload": args.workload, **row})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        readings(cell, args.seeds, args.control_seeds, torch.device("cuda", 0), emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path[0] = str(ROOT)
    sys.exit(main())

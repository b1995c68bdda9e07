#!/usr/bin/env python3
"""Time the fused step's dense products and its 5000-step solve on one GPU,
for the PyTorch/CUDA port of a given checkout, with chip_smoke.py's timer.

    python3 scripts/torch_matvec_ab.py [--root DIR] [--label NAME]
        [--steps N] [--out FILE] [--against FILE ...]

--root names a checkout of this repository (default: this one) whose
`meshdqn_tpu_torch` is imported.  The timer (chip_smoke.time_ms: median of
25 launches, each after an L2 eviction and a 0.5 ms device spin), the packs
and their shapes are this checkout's, so checkouts run one after the other
in one call are timed alike.  For each of the two airfoil packs it reports:

* each single-product shape of the step (chip_smoke.pack_shapes): the
  matvec kernel's time, torch.matmul's and torch.sum's over the same matrix
  (a streaming read of the same bytes), on seeded inputs, and a digest of
  the kernel's y;
* where the checkout has them, the three grouped launches of the step
  (ops.matvec.step_ustar, step_pressure, step_velocity) on seeded operands:
  their times, the same step's products as single launches with torch's
  elementwise ops, and digests of their outputs;
* the fused solve from rest (IPCSSolver.solve, save every 1000 steps):
  device ms/step (CUDA events), host ms/step, the launch counters, and the
  snapshot drag and lift as exact floats (float.hex);
* 50 steps under torch.profiler (chip_smoke.profile_steps): device ops and
  device busy ms per step.

Prints one JSON line (and writes it to --out).  --against names earlier
outputs of this script: every digest and every snapshot drag and lift that
both runs have must be equal, or the script exits non-zero.  To compare two
commits, unpack the parent's `meshdqn_tpu_torch/` (git archive) into a
git-ignored directory and run parent, change, change, parent in one call.
"""
import argparse
import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def seeded(torch, cuda, seed, shape):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(shape, device=cuda, generator=g)


def singles(torch, cs, mv, cuda, ns, npr, flush):
    out = {}
    for op, R, N, k in cs.pack_shapes(ns, npr):
        key = f"{R}x{N}x{k}"
        if key in out:
            out[key]["ops"].append(op)
            continue
        M = seeded(torch, cuda, R * 131 + N * 7 + k, (R, N))
        X = seeded(torch, cuda, R + N + k, (N,) if k == 1 else (N, k))
        out[key] = {"ops": [op], "digest": digest(mv.matvec(M, X)),
                    "ms": cs.time_ms(lambda: mv.matvec(M, X), flush),
                    "matmul_ms": cs.time_ms(lambda: torch.matmul(M, X), flush),
                    # torch.sum reads the same bytes: a yardstick of the
                    # read rate the card reaches in practice
                    "sum_ms": cs.time_ms(lambda: M.sum(), flush),
                    "bound_ms": 4 * (R * N + N * k + R * k) / 3.35e12 * 1e3}
        del M, X
    return out


def grouped(torch, cs, mv, cuda, ns, npr, flush):
    """The three grouped launches on seeded operands (chip_smoke.grouped_forms)."""
    nu = 2 * ns
    shapes = {"F1u": (nu, nu), "F1p": (nu, npr), "A1Z": (nu, nu), "k1": (nu,), "rho": (),
              "F2p": (npr, npr), "F2u": (npr, nu), "k2": (npr,), "F3s": (ns, ns),
              "F3p": (2, ns, npr), "k3": (nu,), "u": (nu,), "p": (npr,), "c": (nu,),
              "u_star": (nu,), "dp": (npr,)}
    t = {n: seeded(torch, cuda, i + 17 * ns, s) for i, (n, s) in enumerate(shapes.items())}
    out = {}
    for form, fn, plain, names, _, _ in cs.grouped_forms(mv, ns, npr):
        args = [t[n] for n in names]
        y = fn(*args)
        out[form] = {"digest": digest(*(y if isinstance(y, tuple) else (y,))),
                     "ms": cs.time_ms(lambda: fn(*args), flush),
                     "composed_ms": cs.time_ms(lambda: plain(*args, apply=mv.matvec),
                                               flush)}
    return out


def counters(mv):
    return {k: getattr(mv, k).launches for k in
            ("matvec", "step_ustar", "step_pressure", "step_velocity") if hasattr(mv, k)}


def solve(torch, cs, mv, cuda, name, steps):
    from meshdqn_tpu_torch.solver import FlowState, IPCSConfig, IPCSSolver

    mesh, z, meta = cs.load_pack(name)
    solver = IPCSSolver(mesh, IPCSConfig(mu=meta["mu"], rho=meta["rho"], dt=meta["dt"],
                                         precision="f32"))
    g = torch.Generator(device=cuda).manual_seed(0)
    solver.evolve(FlowState(u=1e-3 * torch.randn(solver.ndofs_u, device=cuda, generator=g),
                            p=torch.zeros(solver.ndofs_p, device=cuda)), 100)
    for k in counters(mv):
        getattr(mv, k).launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = solver.solve(steps, save_steps=min(1000, steps))
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    row = {"ms_per_step": start.elapsed_time(end) / steps, "host_ms_per_step": host_ms,
           "launches": counters(mv),
           "snap_drags": [float(d).hex() for d in out["snap_drags"]],
           "snap_lifts": [float(x).hex() for x in out["snap_lifts"]],
           "drag_rel_err": abs(float(out["snap_drags"][-1]) / z["gt_drag"][-1] - 1),
           "lift_rel_err": abs(float(out["snap_lifts"][-1]) / z["gt_lift"][-1] - 1)}
    return solver, out["state"], row


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

    walk(mine["packs"], other["packs"], [])
    return diffs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose port is timed")
    ap.add_argument("--label", default=None, help="name printed with the result")
    ap.add_argument("--steps", type=int, default=5000, help="steps of each solve")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--against", nargs="*", default=[],
                    help="earlier outputs whose digests and snapshots must be equal")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # this checkout's; it imports the port only in calls

    sys.path.insert(0, root)
    import meshdqn_tpu_torch
    from meshdqn_tpu_torch.ops import matvec as mv

    pkg = os.path.dirname(os.path.abspath(meshdqn_tpu_torch.__file__))
    if pkg != os.path.join(root, "meshdqn_tpu_torch"):
        raise AssertionError(f"imported the port from {pkg}, not from {root}")
    cuda = torch.device("cuda")
    flush = torch.empty(64 * 2**20 // 4, device=cuda)  # > the 50 MB L2
    result = {"label": args.label, "root": root, "card": cs.nvidia_smi(), "packs": {}}
    for name in cs.PACKS:
        mesh, _, _ = cs.load_pack(name)
        ns, npr = mesh.num_vertices + mesh.num_edges, mesh.num_vertices
        pack = {"singles": singles(torch, cs, mv, cuda, ns, npr, flush)}
        ops = pack["singles"].values()
        pack["singles_step_ms"] = sum(len(s["ops"]) * s["ms"] for s in ops)
        pack["matmul_step_ms"] = sum(len(s["ops"]) * s["matmul_ms"] for s in ops)
        if hasattr(mv, "step_ustar"):
            pack["grouped"] = grouped(torch, cs, mv, cuda, ns, npr, flush)
            pack["grouped_step_ms"] = sum(g["ms"] for g in pack["grouped"].values())
        solver, state, pack["solve"] = solve(torch, cs, mv, cuda, name, args.steps)
        if name == cs.PACKS[0]:
            cs.profile_steps(solver, state, path=f"fused {args.label or root}")
        del solver, state
        result["packs"][name] = pack
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

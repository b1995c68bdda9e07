#!/usr/bin/env python3
"""Generate a mesh-resolution sweep and solve it with one batched solve, with
the PyTorch port on the GPU.

The port's counterpart of scripts/make_sweep.py:

1. decimate the base mesh to several vertex budgets with the port's
   coarsening (meshdqn_tpu_torch.coarsen.remove_vertex: random interior
   removals, seeded by the target, as make_sweep.py), each smoothed 50
   passes;
2. write the variants as XDMF (meshdqn_tpu_torch.mesh.write_xdmf, which
   needs h5py);
3. solve all of them at once with the batched fused f32 solver
   (meshdqn_tpu_torch.solver.batch.BatchedFlows: three launches of the
   matvec kernel's batched grouped form a step for all meshes);
4. write a CSV in the reference's NUM_COORDS,RESOLUTION,TIME,DRAG,LIFT
   layout (TIME = each flow's share of the batched wall-clock).

--mesh takes an XDMF file, smoothed 50 passes after reading as make_sweep.py
does, or a pack's ground_truth.npz (checkpoints/*_results/), whose mesh was
smoothed when the pack was made and is used as it is.

Usage:  python3 scripts/torch_make_sweep.py [--mesh PATH] [--targets 850 820 790 760]
            [--steps 5000] [--out-dir artifacts/sweep] [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from meshdqn_tpu_torch.coarsen import RemovalStatus, remove_vertex  # noqa: E402
from meshdqn_tpu_torch.mesh import TriMesh, read_xdmf, smooth, write_xdmf  # noqa: E402
from meshdqn_tpu_torch.solver import IPCSConfig  # noqa: E402
from meshdqn_tpu_torch.solver.batch import BatchedFlows  # noqa: E402

PACK = os.path.join(REPO, "checkpoints", "ys930_results", "ground_truth.npz")


def load_mesh(path: str) -> TriMesh:
    """A pack's ground_truth.npz as it is, or an XDMF mesh smoothed 50
    passes."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return TriMesh(z["coords"], z["cells"])
    return smooth(read_xdmf(path), 50)


def decimate(mesh: TriMesh, target_vertices: int, seed: int = 0) -> TriMesh:
    rng = np.random.default_rng(seed)
    while mesh.num_vertices > target_vertices:
        removable = np.flatnonzero(~mesh.boundary_vertex_mask)
        v = int(rng.choice(removable))
        res = remove_vertex(mesh, v)
        if res.status == RemovalStatus.OK:
            mesh = res.mesh
    return mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=PACK)
    ap.add_argument("--targets", type=int, nargs="+", default=[850, 820, 790, 760])
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--out-dir", default="artifacts/sweep")
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    base = load_mesh(args.mesh)
    meshes = [base]
    names = [f"ys930_{base.num_vertices}"]
    for t in args.targets:
        m = smooth(decimate(base, t, seed=t), 50)
        meshes.append(m)
        names.append(f"ys930_{m.num_vertices}")
        write_xdmf(os.path.join(args.out_dir, names[-1] + "_triangle.xdmf"), m)
        print(f"decimated -> {m.num_vertices} vertices", flush=True)

    batched = BatchedFlows(meshes, IPCSConfig(precision="f32", fused=True),
                           device=args.device)
    print("batched operators built", flush=True)
    # One step first: the kernels are built at first use.
    _, d, _ = batched.evolve(batched.initial_state(), 1)
    float(d[0, -1])
    t0 = time.time()
    out = batched.solve(args.steps, save_steps=min(1000, args.steps))
    float(out["drags"][0, -1])  # waits for the device
    wall = time.time() - t0
    per_flow = wall / len(meshes)

    fields = ["NUM_COORDS", "RESOLUTION", "TIME", "DRAG", "LIFT"]
    rows = [
        {"NUM_COORDS": m.num_vertices, "RESOLUTION": "0.15000", "TIME": per_flow,
         "DRAG": float(out["snap_drags"][i, -1]), "LIFT": float(out["snap_lifts"][i, -1])}
        for i, m in enumerate(meshes)
    ]
    csv_path = os.path.join(args.out_dir, "ys930_decimation_benchmark.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
    print(" ".join(f"{k:>12}" for k in fields))
    for r in rows:
        print(" ".join(f"{r[k]:>12}" for k in fields))
    print(f"batched wall for {len(meshes)} flows x {args.steps} steps: {wall:.1f}s "
          f"({per_flow:.1f}s/flow)")
    print("csv:", csv_path)
    return rows


if __name__ == "__main__":
    main()

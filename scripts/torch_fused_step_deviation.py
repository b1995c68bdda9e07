#!/usr/bin/env python3
"""Write the JAX package's one-step deviation of the fused f32 step on both
packs, the yardstick of the port's card test of the same step.

    JAX_PLATFORMS=cpu python3 scripts/torch_fused_step_deviation.py [--steps 100]

Runs on the CPU with both packages (~2 min) and writes
meshdqn_tpu_torch/data/fused_f32_step_deviation_jax.json.  Per pack
(checkpoints/<pack>_results: its mesh and its mu, rho, dt): the exact
trajectory is the port's fused step in f64 from rest; from each of its first
`steps` states, rounded to f32, one step of the JAX package's fused f32
solver and one exact step.  Stored: the RMS over the states of the JAX
step's deviation in u and p (norm-relative) and in drag and lift
(absolute).  One f32 trajectory's deviation is one draw of a random walk,
so tests/test_torch_cuda.py holds the port's step on the card to 2x these
RMS values over the same states, as tests/test_torch_dense_modes.py does on
the CPU (its module note).
"""
import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "meshdqn_tpu_torch", "data",
                   "fused_f32_step_deviation_jax.json")
PACKS = ("ys930", "ah93w145")
METRICS = ("u", "p", "drag", "lift")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def pack_deviation(pack: str, steps: int) -> dict:
    import jax.numpy as jnp
    import torch

    from meshdqn_tpu.mesh import TriMesh as JaxMesh
    from meshdqn_tpu.solver import IPCSConfig as JaxConfig
    from meshdqn_tpu.solver import IPCSSolver as JaxSolver
    from meshdqn_tpu.solver.ipcs import FlowState as JaxState
    from meshdqn_tpu.solver.ipcs import evolve_fused_n
    from meshdqn_tpu_torch.mesh import TriMesh
    from meshdqn_tpu_torch.solver import (
        FlowState, IPCSConfig, build_fused_operators, fused_step,
    )

    run = os.path.join(REPO, "checkpoints", f"{pack}_results")
    z = np.load(os.path.join(run, "ground_truth.npz"))
    with open(os.path.join(run, "ground_truth_meta.json")) as f:
        meta = json.load(f)
    flow = {k: meta[k] for k in ("mu", "rho", "dt")}
    jax_solver = JaxSolver(JaxMesh(z["coords"], z["cells"]),
                           JaxConfig(precision="f32", **flow))
    dev64, nu, npr, _ = build_fused_operators(
        TriMesh(z["coords"], z["cells"]), IPCSConfig(precision="f32", **flow),
        device="cpu", dtype=torch.float64)
    exact = FlowState(u=torch.zeros(nu, dtype=torch.float64),
                      p=torch.zeros(npr, dtype=torch.float64))
    rows = []
    for _ in range(steps):
        exact, _ = fused_step(dev64, exact)
        u32, p32 = exact.u.float(), exact.p.float()
        ref, (rd, rl) = fused_step(dev64, FlowState(u32.double(), p32.double()))
        js, (jd, jl) = evolve_fused_n(
            jax_solver.dev, JaxState(jnp.asarray(u32.numpy()), jnp.asarray(p32.numpy())),
            1)
        rows.append((rel(js.u, ref.u.numpy()), rel(js.p, ref.p.numpy()),
                     abs(float(jd[0]) - rd.item()), abs(float(jl[0]) - rl.item())))
    rms = np.sqrt(np.mean(np.square(rows), axis=0))
    return dict(zip(METRICS, map(float, rms)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {"steps": args.steps, "metrics": list(METRICS),
           "rms": {pack: pack_deviation(pack, args.steps) for pack in PACKS}}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

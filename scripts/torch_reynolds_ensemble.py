#!/usr/bin/env python3
"""Drag/lift against inflow amplitude from ONE ensemble solve, with the
PyTorch port on the GPU.

The port's counterpart of scripts/reynolds_ensemble.py: B inflow amplitudes
of the ys930 flow run at once on shared fused operators
(meshdqn_tpu_torch.solver.ensemble.EnsembleFlows: each product of the step
is one launch of the matvec kernel's k-column form for all members), and
the final drag and lift are printed against the amplitude (equivalently the
Reynolds number Re = s * Um * L / nu), in the same lines as that script.
It draws no figure: the port has no plots yet (matplotlib is not on the
GPU machine; ROADMAP Queue 1 item 2).

--mesh takes a pack's ground_truth.npz, used as it is, or an XDMF file,
smoothed 50 passes after reading (as scripts/torch_make_sweep.py).

Usage: python3 scripts/torch_reynolds_ensemble.py [--mesh PATH] [--B 16] [--steps 5000]
           [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_make_sweep import PACK, load_mesh  # noqa: E402  (puts the repo on the path)

from meshdqn_tpu_torch.solver import IPCSConfig  # noqa: E402
from meshdqn_tpu_torch.solver.ensemble import EnsembleFlows  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=PACK)
    ap.add_argument("--B", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    args = ap.parse_args(argv)

    mesh = load_mesh(args.mesh)
    # amplitudes above ~1.4 exceed the explicit-convection CFL limit at
    # dt=1e-3 and diverge (the reference scheme has the same constraint).
    amps = np.linspace(0.4, 1.3, args.B)
    ens = EnsembleFlows(mesh, list(amps), IPCSConfig(precision="f32", fused=True),
                        device=args.device)
    st = ens.initial_state()
    t0 = time.time()
    st, drags, lifts = ens.evolve(st, args.steps)
    final_d = drags[:, -1].cpu().numpy()  # waits for the device
    wall = time.time() - t0
    final_l = lifts[:, -1].cpu().numpy()
    print(f"{args.B} flows x {args.steps} steps in {wall:.1f}s "
          f"({wall / args.B:.2f}s effective per flow)")
    for a, d, l in zip(amps, final_d, final_l):
        print(f"  amp {a:4.2f} (Re ~{1000 * a:4.0f}): drag {d:+.6f}  lift {l:+.6f}")
    return amps, final_d, final_l


if __name__ == "__main__":
    main()

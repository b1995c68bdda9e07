#!/usr/bin/env python3
"""Time the banded products of one ys930 production CG step on one GPU, for
the PyTorch/CUDA port of a given checkout, with chip_smoke.py's timer.

    python3 scripts/torch_banded_ab.py [--root DIR] [--label NAME]

--root names a checkout of this repository (default: this one) whose
`meshdqn_tpu_torch` is imported.  The timer (chip_smoke.time_ms: median of
25 launches, each after an L2 eviction and a 0.5 ms device spin), the mesh
and the step's plan (chip_smoke.STEP_BANDED: each banded operator, its
column count and its applies a step) are this checkout's, so two checkouts
run one after the other in one call are timed alike.  Every operator is
built through `BandedMatrix.from_scipy` and applied through its `matmat`,
as the solver does, and first held to the plain version within
ops.matvec.gap_tolerance.  Prints one JSON line: the card, each operator's
kernel and torch.sparse CSR ms, and their sums over one step.

To compare two commits, unpack the parent's `meshdqn_tpu_torch/` (git
archive) into a git-ignored directory and run parent, change, change,
parent in one call.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose port is timed")
    ap.add_argument("--label", default=None, help="name printed with the result")
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
    from meshdqn_tpu_torch.ops.banded import BandedMatrix, banded_matmat_reference
    from meshdqn_tpu_torch.solver import IPCSConfig
    from meshdqn_tpu_torch.solver.ipcs import cg_matrices

    pkg = os.path.dirname(os.path.abspath(meshdqn_tpu_torch.__file__))
    if pkg != os.path.join(root, "meshdqn_tpu_torch"):
        raise AssertionError(f"imported the port from {pkg}, not from {root}")
    cuda = torch.device("cuda")
    flush = torch.empty(64 * 2**20 // 4, device=cuda)  # > the 50 MB L2
    mesh, _ = cs.load_finest(cs.AIRFOILS[0])
    mats = cg_matrices(mesh, IPCSConfig(**cs.PRODUCTION))["matrices"]
    ops, step, csr_step = {}, 0.0, 0.0
    for op, m, count in cs.STEP_BANDED:
        A = mats[op]
        bm = BandedMatrix.from_scipy(A, device=cuda, dtype=torch.float32)
        gen = torch.Generator(device=cuda).manual_seed(A.shape[0] + m)
        X = torch.randn((A.shape[1],) if m == 1 else (A.shape[1], m), device=cuda,
                        generator=gen)
        yp = banded_matmat_reference(bm.blocks, X, pad=bm.pad, g=bm.g, aligned=False,
                                     n_rows=A.shape[0])
        gap = mv.relative_gap(bm.matmat(X), yp)
        tol = mv.gap_tolerance(bm.blocks.shape[2])
        if not gap <= tol:
            raise AssertionError(f"{op}: ||y - plain|| / ||plain|| = {gap:.3g} above "
                                 f"{tol:.3g}")
        Acsr = cs.csr_tensor(A, cuda, torch.float32)
        X2 = X.view(X.shape[0], -1)
        ms = cs.time_ms(lambda: bm.matmat(X), flush)
        csr_ms = cs.time_ms(lambda: Acsr @ X2, flush)
        ops[op] = {"m": m, "applies": count, "ms": ms, "csr_ms": csr_ms, "gap": gap,
                   "tol": tol}
        step += count * ms
        csr_step += count * csr_ms
        del bm, Acsr
    print(json.dumps({"label": args.label, "root": root, "card": cs.nvidia_smi(),
                      "ops": ops, "step_ms": step, "csr_step_ms": csr_step}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

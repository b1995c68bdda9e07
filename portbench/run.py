"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard output,
one JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), device, with --trace 1 a
breakdown, and last the numbers that decided `correct` beside their
limits, which also end standard error.  Exits non-zero with no result when
there is no CUDA card, when the program cannot be imported, or when JAX or
the JAX package was loaded.
"""
import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names no run may load, compared whole: the port's own
# name begins with the JAX package's and passes.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "meshdqn_tpu"})


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, *, root: Path = ROOT, require_card: bool = True,
         t0: float = T0) -> int:
    args = parse(argv)
    import torch

    from portbench import harness

    cell = harness.load_cell(root, args.workload)
    if require_card:
        chips = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"{args.workload} needs {chips} CUDA card(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    # float32 stays float32: no TF32 products anywhere in the run.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, t0,
                         log)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    # Run as a script, Python puts this folder first on the path; the
    # checkout's root goes there instead, so `portbench` and the program
    # import as packages and no file here shadows another module.
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path[0] = str(ROOT)
    # One host thread a library: the host issues the solve's launches, and
    # idle pool threads of numpy's or torch's would only compete with it for
    # the host's cores.  Set before either is imported.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.exit(main())

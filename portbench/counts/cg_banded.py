"""Bytes and floating-point operations of one CG step in the banded layout.

The step (the program's `ipcs_step_cg_banded`) at the configuration's
solver settings, which these constants repeat and a test holds to the
configuration file: PCG (6, 5) iterations for the velocity and mass
systems, block-Jacobi blocks of 128, one refinement of the pressure.

The least a step can move, in float32, each read or written once:

- each sparse operator's nonzeros (values only, no index) once per
  product: the 18 banded products (A1 7 times, the mass system A3 6 times
  on two columns, R1, P1m, B^T, Ms on two columns, G) and the two pressure
  products (Kp, A2 for the refinement residual);
- the block-Jacobi inverses, whole 128 x 128 blocks as the configuration
  states them, once per application (7 for A1, 6 for A3);
- the dense pressure inverse, Np x Np, once per application (1 + refine);
- the vectors each product and each application reads and writes, each
  PCG iteration's X, R and P read and written once, and the drag and lift
  functionals read against the new state.

Never the program's band storage: its padded blocks and tiles do not
enter.  The convection term and the step's elementwise mixes are left out,
so the bound is, if anything, low: a share of it reads low, never above
100%.  Operations: one multiply and one add per operator entry and column.

The harness hands only (Ns, Np), the scalar P2 dof count and the pressure
dof count of a mesh; the operators' nonzeros are carried in NONZEROS by
that key (portbench/tests/test_cg_counts.py recomputes them from the
frozen meshes with portbench/reference/fem.assemble).  A mesh not in the
table reads None.
"""
from __future__ import annotations

from portbench.counts.fused import F32, least_seconds  # noqa: F401

ITERS_U, ITERS_M, BLOCK, REFINE = 6, 5, 128, 1

# Numerical nonzeros of the step's operators, with Dirichlet rows and
# columns eliminated where the step solves with the operator (A1, A3, A2):
# the finest resolution-sweep ys930 row (0.05, the cell's mesh) and the
# 0.25 row (555 vertices, the coarsest that the CG path builds in the banded
# layout: the CPU tests' mesh).
NONZEROS = {
    (14884, 3796): {"A1": 643919, "R1": 674937, "P1m": 139628, "BT": 139629,
                    "Ms": 168916, "A3": 161350, "G": 139836, "Kp": 25972, "A2": 25848},
    (2064, 555): {"A1": 73620, "R1": 90140, "P1m": 18872, "BT": 18873,
                  "Ms": 22566, "A3": 18568, "G": 18866, "Kp": 3573, "A2": 3547},
}


def banded_products(ns: int, npr: int) -> list[tuple[str, int, int, int, int]]:
    """(operator, rows, columns, right-hand sides, products a step) of the
    step's banded products: 18 at (6, 5)."""
    nu = 2 * ns
    return [("A1", nu, nu, 1, 1 + ITERS_U), ("R1", nu, nu, 1, 1),
            ("P1m", nu, npr, 1, 1), ("BT", npr, nu, 1, 1), ("Ms", ns, ns, 2, 1),
            ("G", nu, npr, 1, 1), ("A3", ns, ns, 2, 1 + ITERS_M)]


def _products(nnz: dict, products) -> tuple[int, int]:
    """(bytes, operations) of sparse products (operator, rows, columns,
    right-hand sides, count)."""
    nbytes = ops = 0
    for name, rows, cols, m, times in products:
        nbytes += times * F32 * (nnz[name] + (rows + cols) * m)
        ops += times * 2 * nnz[name] * m
    return nbytes, ops


def kernel_counts(ns: int, npr: int) -> tuple[int, int] | None:
    """(bytes, operations) of the step's 18 banded products, or None for a
    mesh not in NONZEROS."""
    nnz = NONZEROS.get((ns, npr))
    return nnz and _products(nnz, banded_products(ns, npr))


def step_counts(ns: int, npr: int) -> tuple[int, int] | None:
    """(bytes, operations) of one whole step (see the module's note), or
    None for a mesh not in NONZEROS."""
    nnz = NONZEROS.get((ns, npr))
    if not nnz:
        return None
    nbytes, ops = _products(nnz, banded_products(ns, npr)
                            + [("Kp", npr, npr, 1, 1), ("A2", npr, npr, 1, REFINE)])
    nu = 2 * ns
    # Block-Jacobi applications: the blocks, residual in, preconditioned out.
    for n, m, times in ((nu, 1, 1 + ITERS_U), (ns, 2, 1 + ITERS_M)):
        entries = -(-n // BLOCK) * BLOCK * BLOCK
        nbytes += times * F32 * (entries + 2 * n * m)
        ops += times * 2 * entries * m
    # PCG iterations: X, R and P read and written once each.
    nbytes += F32 * 6 * (nu * ITERS_U + 2 * ns * ITERS_M)
    # The dense pressure inverse: b in, p out, each application.
    nbytes += (1 + REFINE) * F32 * (npr * npr + 2 * npr)
    ops += (1 + REFINE) * 2 * npr * npr
    # Drag and lift: four vectors, two dots.
    probes = 2 * (nu + npr)
    return nbytes + F32 * probes, ops + 2 * probes

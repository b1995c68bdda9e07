"""Reference-element tabulation and quadrature for triangles.

The reference repo delegates this to UFL/FFC runtime codegen (forms at
flow_solver.py:106-120, probes.py:26-30).  Our form set is fixed — the three
IPCS steps plus two boundary-stress functionals — so everything is tabulated
here once, exactly, with no codegen:

* P1 / P2 Lagrange bases on the unit triangle (vertices (0,0), (1,0), (0,1)),
  dolfin/UFC local ordering: vertex dofs first, then edge dofs where local
  edge i is opposite local vertex i.
* A degree-6 Dunavant rule (12 points): exact for every volume integrand in
  the IPCS forms (highest is the convection term u.grad(u).v = degree 5).
* 3-point Gauss–Legendre on facets: exact to degree 5 (boundary integrands
  are at most degree 3).
"""
from __future__ import annotations

import numpy as np

# ----------------------------------------------------------------------
# Quadrature
# ----------------------------------------------------------------------

def dunavant_6() -> tuple[np.ndarray, np.ndarray]:
    """Degree-6 Dunavant rule on the reference triangle.

    Returns (points (12, 2), weights (12,)); weights sum to the reference
    area 1/2.
    """
    groups = [
        (0.116786275726379, [0.501426509658179, 0.249286745170910, 0.249286745170910]),
        (0.050844906370207, [0.873821971016996, 0.063089014491502, 0.063089014491502]),
        (0.082851075618374, [0.053145049844816, 0.310352451033785, 0.636502499121399]),
    ]
    pts, wts = [], []
    for w, bary in groups:
        a, b, c = bary
        perms = {(a, b, c), (a, c, b), (b, a, c), (b, c, a), (c, a, b), (c, b, a)}
        for l0, l1, l2 in sorted(perms):
            # barycentric (l0, l1, l2) -> (x, y) = (l1, l2)
            pts.append((l1, l2))
            wts.append(w)
    pts = np.array(pts, dtype=np.float64)
    wts = np.array(wts, dtype=np.float64)
    wts *= 0.5 / wts.sum()
    return pts, wts


def gauss_legendre_1d(n: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss–Legendre on [0, 1]; weights sum to 1."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


# ----------------------------------------------------------------------
# Shape functions
# ----------------------------------------------------------------------

def p1_basis(points: np.ndarray) -> np.ndarray:
    """(Q, 3) P1 values at reference points (x, y)."""
    x, y = points[:, 0], points[:, 1]
    return np.stack([1.0 - x - y, x, y], axis=1)


def p1_grads() -> np.ndarray:
    """(3, 2) constant P1 reference gradients."""
    return np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])


def p2_basis(points: np.ndarray) -> np.ndarray:
    """(Q, 6) P2 values; dofs = 3 vertices then 3 edge midpoints, edge i
    opposite vertex i (so dof 3 <-> edge (v1, v2), 4 <-> (v0, v2), 5 <-> (v0, v1))."""
    x, y = points[:, 0], points[:, 1]
    l0, l1, l2 = 1.0 - x - y, x, y
    return np.stack(
        [
            l0 * (2 * l0 - 1),
            l1 * (2 * l1 - 1),
            l2 * (2 * l2 - 1),
            4 * l1 * l2,
            4 * l0 * l2,
            4 * l0 * l1,
        ],
        axis=1,
    )


def p2_grads(points: np.ndarray) -> np.ndarray:
    """(Q, 6, 2) P2 reference gradients at points."""
    x, y = points[:, 0], points[:, 1]
    l0 = 1.0 - x - y
    zeros = np.zeros_like(x)
    # d/dx, d/dy of each basis
    g = np.empty((len(points), 6, 2))
    g[:, 0, 0] = 1.0 - 4.0 * l0
    g[:, 0, 1] = 1.0 - 4.0 * l0
    g[:, 1, 0] = 4.0 * x - 1.0
    g[:, 1, 1] = zeros
    g[:, 2, 0] = zeros
    g[:, 2, 1] = 4.0 * y - 1.0
    g[:, 3, 0] = 4.0 * y
    g[:, 3, 1] = 4.0 * x
    g[:, 4, 0] = -4.0 * y
    g[:, 4, 1] = 4.0 * (l0 - y)
    g[:, 5, 0] = 4.0 * (l0 - x)
    g[:, 5, 1] = -4.0 * x
    return g


# Local edges of the reference triangle; edge i opposite vertex i.
LOCAL_EDGES = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int32)

# Reference vertex coordinates.
REF_VERTS = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])


def facet_points(local_edge: int, t: np.ndarray) -> np.ndarray:
    """Reference-cell coordinates of points at parameters t along local edge."""
    a = REF_VERTS[LOCAL_EDGES[local_edge, 0]]
    b = REF_VERTS[LOCAL_EDGES[local_edge, 1]]
    return a[None, :] * (1 - t[:, None]) + b[None, :] * t[:, None]

"""Boundary subdomain marking for the 2D channel-with-airfoil geometry.

Reproduces the reference's facet classification (flow_solver.py:9-30,
194-226): the channel is x in [-0.5, 3.0], y in [-0.5, 0.5]; markers are

    0 = top/bottom walls      (EdgeBndry)
    1 = airfoil surface       (AirfoilBndry)
    2 = inflow   x = -0.5     (Inflow)
    3 = outflow  x =  3.0     (Outflow)
    4 = unmarked default

Dolfin SubDomain.mark sets a facet's marker iff the predicate holds (with
on_boundary=True) at BOTH facet vertices AND the facet midpoint; subdomains
are applied in the order walls, airfoil, inflow, outflow with later marks
overwriting earlier ones (flow_solver.py:201-224).  DirichletBCs constructed
directly from a SubDomain (noslip walls/airfoil, outflow pressure;
flow_solver.py:124-128) use the predicate itself, independent of overwrite
order, so this module exposes both the overwritten marker array and the raw
per-subdomain predicate hits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .trimesh import TriMesh

DOLFIN_EPS = 3.0e-16

WALLS, AIRFOIL, INFLOW, OUTFLOW, UNMARKED = 0, 1, 2, 3, 4

# Channel extents are hard-coded in the reference's subdomain predicates
# (flow_solver.py:15-30), not derived from the mesh.
X_MIN, X_MAX, Y_MIN, Y_MAX = -0.5, 3.0, -0.5, 0.5


def _walls(x, y):
    return (y > Y_MAX - 2 * DOLFIN_EPS) | (y < Y_MIN + 2 * DOLFIN_EPS)


def _airfoil(x, y):
    return (
        (x < X_MAX - DOLFIN_EPS)
        & (x > X_MIN + DOLFIN_EPS)
        & (y < Y_MAX - DOLFIN_EPS)
        & (y > Y_MIN + DOLFIN_EPS)
    )


def _inflow(x, y):
    return x < X_MIN + DOLFIN_EPS


def _outflow(x, y):
    return x > X_MAX - 2 * DOLFIN_EPS


_PREDICATES = {WALLS: _walls, AIRFOIL: _airfoil, INFLOW: _inflow, OUTFLOW: _outflow}


@dataclass
class BoundaryMarkers:
    """Facet markers over a mesh's boundary facets.

    markers : (F,) int, dolfin-overwrite-order marker per boundary facet
    hits    : dict marker -> (F,) bool, raw predicate satisfaction per facet
    """

    markers: np.ndarray
    hits: dict


def _facet_predicate(mesh: TriMesh, pred) -> np.ndarray:
    """Predicate holds at both facet endpoints and the midpoint."""
    a = mesh.coords[mesh.boundary_facets[:, 0]]
    b = mesh.coords[mesh.boundary_facets[:, 1]]
    mid = 0.5 * (a + b)
    return (
        pred(a[:, 0], a[:, 1])
        & pred(b[:, 0], b[:, 1])
        & pred(mid[:, 0], mid[:, 1])
    )


def mark_boundaries(mesh: TriMesh) -> BoundaryMarkers:
    F = len(mesh.boundary_facets)
    markers = np.full(F, UNMARKED, dtype=np.int32)
    hits = {}
    # Application order matters for `markers` (later overwrites earlier),
    # mirroring flow_solver.py:205-224.
    for tag in (WALLS, AIRFOIL, INFLOW, OUTFLOW):
        hit = _facet_predicate(mesh, _PREDICATES[tag])
        hits[tag] = hit
        markers[hit] = tag
    return BoundaryMarkers(markers=markers, hits=hits)


def airfoil_polyline(mesh: TriMesh) -> np.ndarray:
    """Boundary vertices strictly inside the channel box, in vertex-index order.

    This is the ring the reference builds its shapely Polygon from
    (Env2DAirfoil.py:224-232); on the stock meshes these vertices are stored
    in order around the airfoil, so the polygon is a valid closed ring.
    Returns (K, 2) coordinates; the closing segment (last -> first) is implied.
    """
    bv = mesh.boundary_vertices()
    c = mesh.coords[bv]
    inside = (
        (c[:, 0] > X_MIN)
        & (c[:, 0] < X_MAX)
        & (c[:, 1] > Y_MIN)
        & (c[:, 1] < Y_MAX)
    )
    return c[inside]

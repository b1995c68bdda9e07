"""Unstructured triangle mesh with derived topology.

Host-side (NumPy) representation used for one-time topology work: edge
extraction, boundary detection, facet->cell adjacency.  Device code never sees
this object — it sees padded arrays derived from it (see fem/ and solver/).

Mirrors the capabilities the reference obtains from dolfin's Mesh /
BoundaryMesh / MeshEditor (reference flow_solver.py:59-78, Env2DAirfoil.py:
464-509) without any of dolfin's machinery.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TriMesh:
    """A 2D triangle mesh.

    coords : (V, 2) float64 vertex coordinates
    cells  : (C, 3) int32 vertex indices per triangle

    Derived topology (computed on construction):
    edges          : (E, 2) int32, sorted vertex pairs, lexicographically ordered
    cell_edges     : (C, 3) int32 global edge id; local edge i is OPPOSITE local
                     vertex i, i.e. edge 0 = (v1, v2), edge 1 = (v0, v2),
                     edge 2 = (v0, v1) — the dolfin/UFC convention, which the
                     P2 basis ordering in fem/reference.py relies on.
    boundary_facets: (F, 2) int32 vertex pairs of exterior edges
    facet_cells    : (F,) int32 the unique cell adjacent to each boundary facet
    facet_local    : (F,) int32 local edge index of the facet within facet_cells
    boundary_vertex_mask : (V,) bool
    """

    coords: np.ndarray
    cells: np.ndarray
    edges: np.ndarray = field(init=False)
    cell_edges: np.ndarray = field(init=False)
    boundary_facets: np.ndarray = field(init=False)
    facet_cells: np.ndarray = field(init=False)
    facet_local: np.ndarray = field(init=False)
    boundary_vertex_mask: np.ndarray = field(init=False)

    def __post_init__(self):
        self.coords = np.ascontiguousarray(self.coords, dtype=np.float64)
        self.cells = np.ascontiguousarray(self.cells, dtype=np.int32)
        self._build_topology()

    def _build_topology(self):
        cells = self.cells
        C = len(cells)
        # Local edge i opposite local vertex i.
        local = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int32)
        # (C, 3, 2) endpoint pairs, sorted within each pair.
        pairs = cells[:, local]  # (C, 3, 2)
        pairs = np.sort(pairs, axis=2)
        flat = pairs.reshape(-1, 2)  # (3C, 2)
        # Unique edges, lexicographic order.  Encoding each (a, b) pair
        # (a <= b < V) as the scalar key a*V + b turns the slow
        # np.unique(axis=0) void-view path into a plain 1-D int64 unique
        # with identical ordering (~5x faster; this rebuild runs on every
        # vertex removal).
        V = np.int64(len(self.coords))
        keys = flat[:, 0].astype(np.int64) * V + flat[:, 1]
        ukeys, inverse, counts = np.unique(
            keys, return_inverse=True, return_counts=True
        )
        edges = np.stack([ukeys // V, ukeys % V], axis=1)
        self.edges = edges.astype(np.int32)
        self.cell_edges = inverse.reshape(C, 3).astype(np.int32)

        # Boundary facets: edges adjacent to exactly one cell.
        is_boundary_slot = counts[self.cell_edges] == 1  # (C,3)
        cell_idx, local_idx = np.nonzero(is_boundary_slot)
        edge_ids = self.cell_edges[cell_idx, local_idx]
        # Order facets by their global edge id (deterministic).
        order = np.argsort(edge_ids, kind="stable")
        self.facet_cells = cell_idx[order].astype(np.int32)
        self.facet_local = local_idx[order].astype(np.int32)
        self.boundary_facets = self.edges[edge_ids[order]]

        mask = np.zeros(len(self.coords), dtype=bool)
        mask[self.boundary_facets.ravel()] = True
        self.boundary_vertex_mask = mask

    def with_coords(self, coords: np.ndarray) -> "TriMesh":
        """A mesh with the same connectivity but new vertex positions.

        Topology is purely combinatorial, so it is SHARED with self instead
        of rebuilt — smoothing (which only moves vertices) uses this to skip
        the ~10 ms np.unique edge extraction per remesh."""
        new = object.__new__(TriMesh)
        new.coords = np.ascontiguousarray(coords, dtype=np.float64)
        new.cells = self.cells
        for name in (
            "edges",
            "cell_edges",
            "boundary_facets",
            "facet_cells",
            "facet_local",
            "boundary_vertex_mask",
        ):
            setattr(new, name, getattr(self, name))
        return new

    # ------------------------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return len(self.coords)

    @property
    def num_cells(self) -> int:
        return len(self.cells)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def boundary_vertices(self) -> np.ndarray:
        """Indices of vertices lying on the exterior boundary (sorted).

        Equivalent of dolfin BoundaryMesh(mesh, 'local').entity_map(0)
        (reference Env2DAirfoil.py:464-465) up to ordering.
        """
        return np.flatnonzero(self.boundary_vertex_mask).astype(np.int32)

    def cell_volumes(self) -> np.ndarray:
        """(C,) signed->absolute triangle areas."""
        p = self.coords[self.cells]  # (C,3,2)
        d1 = p[:, 1] - p[:, 0]
        d2 = p[:, 2] - p[:, 0]
        return 0.5 * np.abs(d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])

    def facet_normals(self) -> np.ndarray:
        """(F, 2) unit outward normals of boundary facets.

        Outward = pointing away from the opposite vertex of the adjacent cell
        (the dolfin FacetNormal convention for exterior facets:
        reference flow_solver.py:99, probes.py:29).
        """
        a = self.coords[self.boundary_facets[:, 0]]
        b = self.coords[self.boundary_facets[:, 1]]
        t = b - a
        n = np.stack([t[:, 1], -t[:, 0]], axis=1)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        # Orient away from the opposite vertex (the cell's third vertex).
        opp = self.cells[self.facet_cells, self.facet_local]
        to_opp = self.coords[opp] - a
        flip = np.sum(n * to_opp, axis=1) > 0.0
        n[flip] *= -1.0
        return n

    def facet_lengths(self) -> np.ndarray:
        a = self.coords[self.boundary_facets[:, 0]]
        b = self.coords[self.boundary_facets[:, 1]]
        return np.linalg.norm(b - a, axis=1)

    def min_cell_quality(self) -> float:
        """Minimum radius-ratio quality over cells (1 = equilateral, 0 = degenerate)."""
        p = self.coords[self.cells]
        a = np.linalg.norm(p[:, 1] - p[:, 2], axis=1)
        b = np.linalg.norm(p[:, 0] - p[:, 2], axis=1)
        c = np.linalg.norm(p[:, 0] - p[:, 1], axis=1)
        s = 0.5 * (a + b + c)
        area = self.cell_volumes()
        with np.errstate(divide="ignore", invalid="ignore"):
            inradius = area / s
            circum = a * b * c / (4.0 * np.maximum(area, 1e-300))
            q = 2.0 * inradius / circum
        return float(np.nanmin(q))

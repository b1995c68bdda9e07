"""Degree-of-freedom maps for Taylor–Hood P2/P1 on a TriMesh.

Replaces the reference's dolfin FunctionSpace machinery
(flow_solver.py:85-86): the dof layout is ours to choose, and we choose one
that keeps device arrays simple:

* P1 scalar  : dof i == vertex i                       (ndofs = V)
* P2 scalar  : dofs [0, V) = vertices, [V, V+E) = edges (ndofs = V + E)
* P2 vector  : block layout [all x-dofs | all y-dofs]   (ndofs = 2 (V+E))

The block vector layout means component extraction is a slice — no
interleaving — which XLA handles as free reshapes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..mesh import TriMesh


@dataclass(frozen=True)
class P1Space:
    mesh: TriMesh

    @property
    def ndofs(self) -> int:
        return self.mesh.num_vertices

    def cell_dofs(self) -> np.ndarray:
        """(C, 3) global dofs per cell, matching the P1 local basis order."""
        return self.mesh.cells.astype(np.int32)

    def dof_coords(self) -> np.ndarray:
        return self.mesh.coords


@dataclass(frozen=True)
class P2Space:
    mesh: TriMesh

    @property
    def ndofs(self) -> int:
        return self.mesh.num_vertices + self.mesh.num_edges

    def cell_dofs(self) -> np.ndarray:
        """(C, 6) global dofs per cell: [v0, v1, v2, V+e0, V+e1, V+e2]
        with local edge i opposite local vertex i (fem/reference.py)."""
        V = self.mesh.num_vertices
        return np.concatenate(
            [self.mesh.cells, V + self.mesh.cell_edges], axis=1
        ).astype(np.int32)

    def dof_coords(self) -> np.ndarray:
        """(V+E, 2): vertices then edge midpoints."""
        mids = 0.5 * (
            self.mesh.coords[self.mesh.edges[:, 0]]
            + self.mesh.coords[self.mesh.edges[:, 1]]
        )
        return np.concatenate([self.mesh.coords, mids], axis=0)


@dataclass(frozen=True)
class VectorP2Space:
    """2-vector P2 space in block layout [x-dofs | y-dofs]."""

    mesh: TriMesh

    @property
    def scalar(self) -> P2Space:
        return P2Space(self.mesh)

    @property
    def ndofs(self) -> int:
        return 2 * self.scalar.ndofs

    def cell_dofs(self) -> np.ndarray:
        """(C, 12) global dofs: 6 x-component then 6 y-component."""
        s = self.scalar.cell_dofs()
        N = self.scalar.ndofs
        return np.concatenate([s, s + N], axis=1).astype(np.int32)

    def dof_coords(self) -> np.ndarray:
        """(2(V+E), 2): coordinates of each dof's node (both components)."""
        c = self.scalar.dof_coords()
        return np.concatenate([c, c], axis=0)

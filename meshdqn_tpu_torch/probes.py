"""Drag/lift boundary-stress probes.

Reference semantics (probes.py:13-50): the force functional over tagged
exterior facets

    F_e(u, p) = int_{ds(tag)} (sigma(u, p) . n) . e ds,
    sigma = 2 mu sym(grad u) - p I,

with e = (1,0) for drag, (0,1) for lift, n the outward facet normal and tag 1
the airfoil surface.  The functional is LINEAR in (u, p), so we assemble it
once per mesh into a pair of vectors (d_u, d_p); per-sample cost is two dot
products — this is what makes per-step drag tracking free on device
(cf. flow_solver.py:385-389 which re-assembles the UFL form every step).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .mesh import TriMesh, BoundaryMarkers, AIRFOIL
from .fem.reference import gauss_legendre_1d, p1_basis, p2_grads, facet_points
from .fem.assembly import cell_jacobians, _strain_basis
from .fem.spaces import P1Space, VectorP2Space


@dataclass
class ForceProbe:
    """Linear functional F(u, p) = d_u . u + d_p . p."""

    d_u: np.ndarray  # (2Ns,)
    d_p: np.ndarray  # (Np,)

    def sample(self, u, p) -> float:
        return float(self.d_u @ u + self.d_p @ p)


@lru_cache(maxsize=4)
def _ref_facet_tables(order: int = 3):
    """Mesh-independent reference tabulation for facet quadrature: the
    Gauss points/weights and the P2-gradient / P1-value tables at the
    quadrature points of each of the 3 local edges.  Probe assembly runs
    once per removal on the env hot path; recomputing these (leggauss +
    polynomial evaluation) cost ~1.5 ms/removal before caching."""
    t1d, w1d = gauss_legendre_1d(order)
    K = len(t1d)
    ref_pts = np.stack([facet_points(l, t1d) for l in range(3)])  # (3,K,2)
    flat = ref_pts.reshape(-1, 2)
    g2 = p2_grads(flat).reshape(3, K, 6, 2)
    phi1 = p1_basis(flat).reshape(3, K, 3)
    return w1d, g2, phi1


def _facet_tabulation(mesh: TriMesh, markers: BoundaryMarkers, tags: tuple):
    """Shared per-facet geometry/quadrature tabulation for force probes."""
    sel = np.isin(markers.markers, tags)
    fc = mesh.facet_cells[sel]
    fl = mesh.facet_local[sel]
    n = mesh.facet_normals()[sel]  # (F,2)
    L = mesh.facet_lengths()[sel]

    w1d, g2_tab, phi1_tab = _ref_facet_tables(3)

    # Jacobians only for the facet cells (F << C on the hot path).
    _, _, Jinv_fc = cell_jacobians(mesh, cell_ids=fc)
    g2f = np.einsum("fkad,fde->fkae", g2_tab[fl], Jinv_fc)  # (F,K,6,2)
    phi1f = phi1_tab[fl]  # (F,K,3)
    W = w1d[None, :] * L[:, None]  # (F,K)
    E = _strain_basis(g2f)  # (F,K,12,2,2)
    # Direction-independent kernels: contract with e afterwards.
    ker_u = np.einsum("fk,fkaij,fj->fai", W, E, n)  # (F,12,2)
    ker_p = -np.einsum("fk,fkb,fi->fbi", W, phi1f, n)  # (F,3,2)
    return fc, ker_u, ker_p


def _scatter_probe(mesh, fc, contrib_u, contrib_p) -> ForceProbe:
    V = VectorP2Space(mesh)
    Q = P1Space(mesh)
    d_u = np.zeros(V.ndofs)
    d_p = np.zeros(Q.ndofs)
    np.add.at(d_u, V.cell_dofs()[fc].ravel(), contrib_u.ravel())
    np.add.at(d_p, Q.cell_dofs()[fc].ravel(), contrib_p.ravel())
    return ForceProbe(d_u=d_u, d_p=d_p)


def assemble_force_probe(
    mesh: TriMesh,
    markers: BoundaryMarkers,
    mu: float,
    direction: tuple,
    tags: tuple = (AIRFOIL,),
) -> ForceProbe:
    e = np.asarray(direction, dtype=np.float64)
    fc, ker_u, ker_p = _facet_tabulation(mesh, markers, tags)
    return _scatter_probe(mesh, fc, 2.0 * mu * (ker_u @ e), ker_p @ e)


def force_probes(mesh, markers, mu, tags=(AIRFOIL,)):
    """(drag, lift) probes sharing one facet tabulation — assembled per
    remesh on the env hot path, so the geometry work is done once."""
    fc, ker_u, ker_p = _facet_tabulation(mesh, markers, tags)
    ex = np.array([1.0, 0.0])
    ey = np.array([0.0, 1.0])
    drag = _scatter_probe(mesh, fc, 2.0 * mu * (ker_u @ ex), ker_p @ ex)
    lift = _scatter_probe(mesh, fc, 2.0 * mu * (ker_u @ ey), ker_p @ ey)
    return drag, lift


def drag_probe(mesh, markers, mu, tags=(AIRFOIL,)) -> ForceProbe:
    return assemble_force_probe(mesh, markers, mu, (1.0, 0.0), tags)


def lift_probe(mesh, markers, mu, tags=(AIRFOIL,)) -> ForceProbe:
    return assemble_force_probe(mesh, markers, mu, (0.0, 1.0), tags)


@dataclass
class PenetratedForceProbe:
    """Force over a PENETRATED surface (reference probes.py:64-100):

        F_e(u, p) = int_{ds(tags)} ( -rho (u.n) u + sigma(u, p).n ) . e ds

    = the boundary-stress functional (linear; `base`) minus the momentum
    flux rho * int (u.n)(u.e) ds, which is QUADRATIC in u and therefore
    evaluated from a per-facet quadrature tabulation instead of a vector.
    """

    base: ForceProbe
    rho: float
    e: np.ndarray  # (2,)
    dofs: np.ndarray  # (F, 6) scalar P2 cell dofs of each tagged facet's cell
    phi: np.ndarray  # (F, K, 6) P2 values at facet quadrature points
    n: np.ndarray  # (F, 2) outward normals
    W: np.ndarray  # (F, K) quadrature weights * facet lengths
    ns: int  # scalar P2 dof count (block offset of the y component)

    def sample(self, u, p) -> float:
        u = np.asarray(u)
        ux = np.einsum("fka,fa->fk", self.phi, u[self.dofs])
        uy = np.einsum("fka,fa->fk", self.phi, u[self.ns + self.dofs])
        un = ux * self.n[:, None, 0] + uy * self.n[:, None, 1]
        ue = ux * self.e[0] + uy * self.e[1]
        flux = self.rho * float(np.sum(self.W * un * ue))
        return self.base.sample(u, p) - flux


def assemble_penetrated_probe(
    mesh: TriMesh,
    markers: BoundaryMarkers,
    mu: float,
    rho: float,
    direction: tuple,
    tags: tuple = (AIRFOIL,),
) -> PenetratedForceProbe:
    from .fem.reference import p2_basis

    base = assemble_force_probe(mesh, markers, mu, direction, tags)
    sel = np.isin(markers.markers, tags)
    fc = mesh.facet_cells[sel]
    fl = mesh.facet_local[sel]
    n = mesh.facet_normals()[sel]
    L = mesh.facet_lengths()[sel]
    t1d, w1d = gauss_legendre_1d(4)  # quadratic integrand of P2 -> degree 4
    K = len(t1d)
    F = len(fc)
    ref_pts = np.stack([facet_points(l, t1d) for l in range(3)])
    flat = ref_pts[fl].reshape(-1, 2)
    Vs = VectorP2Space(mesh).scalar
    return PenetratedForceProbe(
        base=base,
        rho=rho,
        e=np.asarray(direction, dtype=np.float64),
        dofs=Vs.cell_dofs()[fc],
        phi=p2_basis(flat).reshape(F, K, 6),
        n=n,
        W=w1d[None, :] * L[:, None],
        ns=Vs.ndofs,
    )


def penetrated_drag_probe(mesh, markers, mu, rho, tags=(AIRFOIL,)):
    return assemble_penetrated_probe(mesh, markers, mu, rho, (1.0, 0.0), tags)


def penetrated_lift_probe(mesh, markers, mu, rho, tags=(AIRFOIL,)):
    return assemble_penetrated_probe(mesh, markers, mu, rho, (0.0, 1.0), tags)

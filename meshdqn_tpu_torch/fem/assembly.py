"""Operator assembly for the IPCS scheme on Taylor–Hood P2/P1.

The reference assembles its three constant system matrices once through
FFC-generated kernels + dolfin SystemAssembler (flow_solver.py:134-144) and
re-assembles only RHS vectors per step.  We go further: every *linear* piece
of the RHS is also a constant operator, so the per-step device work reduces to
sparse matvecs + one nonlinear convection kernel (ops/convection.py) + dense
triangular-free solves with precomputed inverses (solver/ipcs.py).

Weak forms replicated exactly (flow_solver.py:106-120), with
U = (u^n + u)/2, sigma(u,p) = 2 mu eps(u) - p I, eps = sym(grad):

  step 1:  rho/dt (u - u^n, v) + rho ((u^n . grad)u^n, v)
           + (sigma(U, p^n), eps(v)) + <p^n n, v> - <mu (grad U)^T n, v> = 0
  step 2:  (grad p, grad q) = (grad p^n, grad q) - 1/dt (div u*, q)
  step 3:  (u, v) = (u*, v) - dt (grad(p - p^n), v)

Assembled constant operators (scipy CSR, f64):
  M   vector P2 mass                       (2Ns, 2Ns)
  Kv  2 mu (eps(u), eps(v))               (2Ns, 2Ns)
  S   mu <(grad u)^T n, v>_dOmega         (2Ns, 2Ns)
  B   (p, div v)                          (2Ns, Np)
  Bn  <p n, v>_dOmega                     (2Ns, Np)
  Kp  (grad p, grad q)                    (Np, Np)
  G   (grad p, v)                         (2Ns, Np)

so that  A1 = rho/dt M + 1/2 Kv - 1/2 S,   b1 = R1 u^n + (B - Bn) p^n - rho c(u^n)
         with R1 = rho/dt M - 1/2 Kv + 1/2 S
         A2 = Kp,                          b2 = Kp p^n - 1/dt B^T u*
         A3 = M,                           b3 = M u* - dt G (p_ - p^n)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from ..mesh import TriMesh, BoundaryMarkers, INFLOW, WALLS, AIRFOIL, OUTFLOW
from .reference import (
    dunavant_6,
    gauss_legendre_1d,
    p1_basis,
    p1_grads,
    p2_basis,
    p2_grads,
    facet_points,
)
from .spaces import P1Space, P2Space, VectorP2Space


# ----------------------------------------------------------------------
# Geometry helpers
# ----------------------------------------------------------------------

def cell_jacobians(mesh: TriMesh, cell_ids: np.ndarray | None = None):
    """Per-cell affine maps: J (C,2,2), |det J| (C,), J^{-1} (C,2,2).

    cell_ids restricts the tabulation to a subset of cells (e.g. the
    airfoil-facet cells on the probe-assembly hot path) — same layout,
    C = len(cell_ids)."""
    cells = mesh.cells if cell_ids is None else mesh.cells[cell_ids]
    p = mesh.coords[cells]  # (C,3,2)
    J = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], axis=2)  # columns
    det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    absdet = np.abs(det)
    inv = np.empty_like(J)
    inv[:, 0, 0] = J[:, 1, 1]
    inv[:, 0, 1] = -J[:, 0, 1]
    inv[:, 1, 0] = -J[:, 1, 0]
    inv[:, 1, 1] = J[:, 0, 0]
    inv /= det[:, None, None]
    return J, absdet, inv


def _strain_basis(g2: np.ndarray) -> np.ndarray:
    """eps of the 12 local vector-P2 basis functions.

    g2: (..., 6, 2) physical gradients of the scalar basis.
    Returns (..., 12, 2, 2); local vector dofs = [6 x-comp | 6 y-comp].
    """
    shape = g2.shape[:-2]
    E = np.zeros(shape + (12, 2, 2))
    gx, gy = g2[..., 0], g2[..., 1]
    E[..., :6, 0, 0] = gx
    E[..., :6, 0, 1] = 0.5 * gy
    E[..., :6, 1, 0] = 0.5 * gy
    E[..., 6:, 1, 1] = gy
    E[..., 6:, 0, 1] = 0.5 * gx
    E[..., 6:, 1, 0] = 0.5 * gx
    return E


def _scatter(Ae: np.ndarray, rows_map: np.ndarray, cols_map: np.ndarray, shape):
    """Sum (C, a, b) element blocks into a CSR matrix."""
    C, na, nb = Ae.shape
    rows = np.repeat(rows_map[:, :, None], nb, axis=2).ravel()
    cols = np.repeat(cols_map[:, None, :], na, axis=1).ravel()
    A = sp.coo_matrix((Ae.ravel(), (rows, cols)), shape=shape)
    return A.tocsr()


# ----------------------------------------------------------------------
# Assembled operator bundle
# ----------------------------------------------------------------------

@dataclass
class Operators:
    """All constant operators + BC data for one mesh."""

    mesh: TriMesh
    V: VectorP2Space
    Q: P1Space
    mu: float
    rho: float
    dt: float
    # CSR operators
    M: sp.csr_matrix
    Kv: sp.csr_matrix
    S: sp.csr_matrix
    B: sp.csr_matrix
    Bn: sp.csr_matrix
    Kp: sp.csr_matrix
    G: sp.csr_matrix
    # Dirichlet data
    u_bc_mask: np.ndarray  # (2Ns,) bool
    u_bc_values: np.ndarray  # (2Ns,) f64 (zero off bc dofs)
    p_bc_mask: np.ndarray  # (Np,) bool
    p_bc_values: np.ndarray  # (Np,)

    @property
    def A1(self) -> sp.csr_matrix:
        return (self.rho / self.dt) * self.M + 0.5 * self.Kv - 0.5 * self.S

    @property
    def R1(self) -> sp.csr_matrix:
        return (self.rho / self.dt) * self.M - 0.5 * self.Kv + 0.5 * self.S

    @property
    def A2(self) -> sp.csr_matrix:
        return self.Kp

    @property
    def A3(self) -> sp.csr_matrix:
        return self.M


def constant_inflow_profile(mesh: TriMesh, Um: float = 1.5):
    """Parabolic inlet profile of the reference (flow_solver.py:33-44).

    bot/top are taken from the mesh coordinate extents, exactly as the
    reference does with `mesh.coordinates().min/max(axis=0)[1]`.
    """
    bot = mesh.coords[:, 1].min()
    top = mesh.coords[:, 1].max()
    H = top - bot

    def ux(y):
        return -4.0 * Um * (y - bot) * (y - top) / (H * H)

    return ux


def velocity_bc(
    mesh: TriMesh, markers: BoundaryMarkers, profile
) -> tuple[np.ndarray, np.ndarray]:
    """Dirichlet mask/values on the vector P2 space.

    Application order inlet -> airfoil -> walls matches the reference's bcu
    list (flow_solver.py:131); values agree on overlaps (profile vanishes at
    the wall corners) so order only matters formally.
    """
    Vs = P2Space(mesh)
    Ns = Vs.ndofs
    nV = mesh.num_vertices
    mask = np.zeros(2 * Ns, dtype=bool)
    values = np.zeros(2 * Ns)
    facet_edges = mesh.cell_edges[mesh.facet_cells, mesh.facet_local]
    dof_y = Vs.dof_coords()[:, 1]

    def apply(facet_sel: np.ndarray, inlet: bool):
        verts = np.unique(mesh.boundary_facets[facet_sel].ravel())
        edges = np.unique(facet_edges[facet_sel])
        sdofs = np.concatenate([verts, nV + edges]).astype(np.int64)
        for comp in (0, 1):
            dofs = comp * Ns + sdofs
            mask[dofs] = True
            if inlet and comp == 0:
                values[dofs] = profile(dof_y[sdofs])
            else:
                values[dofs] = 0.0

    apply(markers.markers == INFLOW, inlet=True)
    apply(markers.hits[AIRFOIL], inlet=False)
    apply(markers.hits[WALLS], inlet=False)
    return mask, values


def pressure_bc(mesh: TriMesh, markers: BoundaryMarkers):
    """p = 0 on the outflow (flow_solver.py:124)."""
    mask = np.zeros(mesh.num_vertices, dtype=bool)
    verts = np.unique(mesh.boundary_facets[markers.hits[OUTFLOW]].ravel())
    mask[verts] = True
    return mask, np.zeros(mesh.num_vertices)


# ----------------------------------------------------------------------
# Main assembly
# ----------------------------------------------------------------------

def assemble_operators(
    mesh: TriMesh,
    markers: BoundaryMarkers,
    mu: float,
    rho: float,
    dt: float,
    inflow_profile=None,
) -> Operators:
    V = VectorP2Space(mesh)
    Q = P1Space(mesh)
    Ns = V.scalar.ndofs
    Np = Q.ndofs

    pts, w = dunavant_6()
    phi2 = p2_basis(pts)  # (Q,6)
    gref2 = p2_grads(pts)  # (Q,6,2)
    phi1 = p1_basis(pts)  # (Q,3)
    gref1 = p1_grads()  # (3,2)

    _, absdet, Jinv = cell_jacobians(mesh)
    # Physical gradients: row-vector grad = gref @ Jinv.
    g2 = np.einsum("qad,cde->cqae", gref2, Jinv)  # (C,Q,6,2)
    g1 = np.einsum("ad,cde->cae", gref1, Jinv)  # (C,3,2)

    wd = w[None, :] * absdet[:, None]  # (C,Q)

    cd2 = V.scalar.cell_dofs()  # (C,6)
    cd2v = V.cell_dofs()  # (C,12)
    cd1 = Q.cell_dofs()  # (C,3)

    # Scalar P2 mass -> vector mass (block diagonal over components).
    Me = np.einsum("cq,qa,qb->cab", wd, phi2, phi2)
    Ms = _scatter(Me, cd2, cd2, (Ns, Ns))
    M = sp.block_diag([Ms, Ms], format="csr")

    # Viscous: 2 mu (eps(u), eps(v))
    E = _strain_basis(g2)  # (C,Q,12,2,2)
    Kve = 2.0 * mu * np.einsum("cq,cqaij,cqbij->cab", wd, E, E)
    Kv = _scatter(Kve, cd2v, cd2v, (2 * Ns, 2 * Ns))

    # (p, div v):  div of vector basis
    dv = np.concatenate([g2[..., 0], g2[..., 1]], axis=2)  # (C,Q,12)
    Be = np.einsum("cq,cqa,qb->cab", wd, dv, phi1)
    B = _scatter(Be, cd2v, cd1, (2 * Ns, Np))

    # Pressure stiffness (grad p, grad q)
    Kpe = np.einsum("cad,cbd,c->cab", g1, g1, 0.5 * absdet)
    Kp = _scatter(Kpe, cd1, cd1, (Np, Np))

    # (grad p, v): vector test with components
    VB = np.zeros((len(mesh.cells), len(w), 12, 2))
    VB[:, :, :6, 0] = phi2[None]
    VB[:, :, 6:, 1] = phi2[None]
    Ge = np.einsum("cq,cqai,cbi->cab", wd, VB, g1)
    G = _scatter(Ge, cd2v, cd1, (2 * Ns, Np))

    # ---------------- boundary (ds over ALL exterior facets) -------------
    t1d, w1d = gauss_legendre_1d(3)
    F = len(mesh.boundary_facets)
    fc = mesh.facet_cells
    fl = mesh.facet_local
    # Reference coordinates of facet quadrature points within the owner cell.
    ref_pts = np.stack([facet_points(l, t1d) for l in range(3)])  # (3,K,2)
    fref = ref_pts[fl]  # (F,K,2)
    K = len(t1d)
    flat = fref.reshape(-1, 2)
    phi2f = p2_basis(flat).reshape(F, K, 6)
    phi1f = p1_basis(flat).reshape(F, K, 3)
    g2f = np.einsum("fkad,fde->fkae", p2_grads(flat).reshape(F, K, 6, 2), Jinv[fc])
    n = mesh.facet_normals()  # (F,2)
    L = mesh.facet_lengths()
    W = w1d[None, :] * L[:, None]  # (F,K)

    # S: mu <(grad u)^T n, v> ; test dof (i,a), trial dof (j,b):
    #    mu * phi_a * dphi_b/dx_i * n_j
    Sb = mu * np.einsum("fk,fka,fkbi,fj->fiajb", W, phi2f, g2f, n)
    Se = Sb.reshape(F, 12, 12)
    S = _scatter(Se, cd2v[fc], cd2v[fc], (2 * Ns, 2 * Ns))

    # Bn: <p n, v>
    Bnb = np.einsum("fk,fkb,fi,fka->fiab", W, phi1f, n, phi2f)
    Bne = Bnb.reshape(F, 12, 3)
    Bn = _scatter(Bne, cd2v[fc], cd1[fc], (2 * Ns, Np))

    # ---------------- Dirichlet data -------------------------------------
    if inflow_profile is None:
        inflow_profile = constant_inflow_profile(mesh)
    u_mask, u_vals = velocity_bc(mesh, markers, inflow_profile)
    p_mask, p_vals = pressure_bc(mesh, markers)

    return Operators(
        mesh=mesh,
        V=V,
        Q=Q,
        mu=mu,
        rho=rho,
        dt=dt,
        M=M,
        Kv=Kv,
        S=S,
        B=B,
        Bn=Bn,
        Kp=Kp,
        G=G,
        u_bc_mask=u_mask,
        u_bc_values=u_vals,
        p_bc_mask=p_mask,
        p_bc_values=p_vals,
    )


def apply_bc_symmetric(A: sp.csr_matrix, mask: np.ndarray) -> sp.csr_matrix:
    """Symmetric Dirichlet elimination: Z A Z + I_bc (SystemAssembler-style,
    flow_solver.py:138-144).  The matching RHS map lives in solver/ipcs.py."""
    z = (~mask).astype(np.float64)
    Zl = sp.diags(z)
    Abc = Zl @ A @ Zl + sp.diags(mask.astype(np.float64))
    return Abc.tocsr()

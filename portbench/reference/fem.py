"""Plain host assembly of the IPCS operators on Taylor–Hood P2/P1.

A frozen copy, condensed into one file, of the assembly the program under
test runs on the host (mesh topology, boundary marking, the P2/P1
tabulation, the weak forms of the three IPCS steps, the Dirichlet data and
the drag and lift functionals).  It imports numpy and scipy only: the
benchmark's reference works every operator out again from the raw mesh
file and shares no code with the program.

Dof layout: P1 dof i is vertex i; scalar P2 dofs are the vertices then the
edges (lexicographic vertex pairs); the vector P2 space is [x-dofs | y-dofs].
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

# The channel box of the paper's geometry and its facet predicates
# (dolfin SubDomain semantics: both facet ends and the midpoint).
EPS = 3.0e-16
X_MIN, X_MAX, Y_MIN, Y_MAX = -0.5, 3.0, -0.5, 0.5
WALLS, AIRFOIL, INFLOW, OUTFLOW = 0, 1, 2, 3
PREDICATES = {
    WALLS: lambda x, y: (y > Y_MAX - 2 * EPS) | (y < Y_MIN + 2 * EPS),
    AIRFOIL: lambda x, y: ((x < X_MAX - EPS) & (x > X_MIN + EPS)
                           & (y < Y_MAX - EPS) & (y > Y_MIN + EPS)),
    INFLOW: lambda x, y: x < X_MIN + EPS,
    OUTFLOW: lambda x, y: x > X_MAX - 2 * EPS,
}
LOCAL_EDGES = np.array([[1, 2], [0, 2], [0, 1]])  # edge i opposite vertex i
REF_VERTS = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
U_MAX = 1.5  # peak of the parabolic inflow


class Mesh:
    """Triangle mesh with the topology the forms need."""

    def __init__(self, coords, cells):
        self.coords = np.ascontiguousarray(coords, dtype=np.float64)
        self.cells = np.ascontiguousarray(cells, dtype=np.int64)
        nv = len(self.coords)
        pairs = np.sort(self.cells[:, LOCAL_EDGES], axis=2).reshape(-1, 2)
        keys = pairs[:, 0] * nv + pairs[:, 1]
        ukeys, inverse, counts = np.unique(keys, return_inverse=True,
                                           return_counts=True)
        self.edges = np.stack([ukeys // nv, ukeys % nv], axis=1)
        self.cell_edges = inverse.reshape(-1, 3)
        cell_idx, local_idx = np.nonzero(counts[self.cell_edges] == 1)
        edge_ids = self.cell_edges[cell_idx, local_idx]
        order = np.argsort(edge_ids, kind="stable")
        self.facet_cells = cell_idx[order]
        self.facet_local = local_idx[order]
        self.facets = self.edges[edge_ids[order]]

    @property
    def nv(self) -> int:
        return len(self.coords)

    @property
    def ns(self) -> int:
        """Scalar P2 dofs: vertices plus edges."""
        return len(self.coords) + len(self.edges)

    def p2_cell_dofs(self) -> np.ndarray:
        return np.concatenate([self.cells, self.nv + self.cell_edges], axis=1)

    def vec_cell_dofs(self) -> np.ndarray:
        s = self.p2_cell_dofs()
        return np.concatenate([s, s + self.ns], axis=1)

    def facet_normals(self) -> np.ndarray:
        a, b = self.coords[self.facets[:, 0]], self.coords[self.facets[:, 1]]
        t = b - a
        n = np.stack([t[:, 1], -t[:, 0]], axis=1)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        opp = self.cells[self.facet_cells, self.facet_local]
        n[np.sum(n * (self.coords[opp] - a), axis=1) > 0.0] *= -1.0
        return n

    def facet_lengths(self) -> np.ndarray:
        a, b = self.coords[self.facets[:, 0]], self.coords[self.facets[:, 1]]
        return np.linalg.norm(b - a, axis=1)

    def facet_hits(self, tag) -> np.ndarray:
        a, b = self.coords[self.facets[:, 0]], self.coords[self.facets[:, 1]]
        m = 0.5 * (a + b)
        pred = PREDICATES[tag]
        return pred(*a.T) & pred(*b.T) & pred(*m.T)

    def markers(self) -> np.ndarray:
        """Facet markers in dolfin's overwrite order (walls, airfoil,
        inflow, outflow), 4 where none holds."""
        out = np.full(len(self.facets), 4)
        for tag in (WALLS, AIRFOIL, INFLOW, OUTFLOW):
            out[self.facet_hits(tag)] = tag
        return out


# ---------------------------------------------------------------- tabulation

def dunavant_6():
    """Degree-6 Dunavant rule: (points (12, 2), weights summing to 1/2)."""
    groups = [
        (0.116786275726379, [0.501426509658179, 0.249286745170910, 0.249286745170910]),
        (0.050844906370207, [0.873821971016996, 0.063089014491502, 0.063089014491502]),
        (0.082851075618374, [0.053145049844816, 0.310352451033785, 0.636502499121399]),
    ]
    pts, wts = [], []
    for w, (a, b, c) in groups:
        for _, l1, l2 in sorted({(a, b, c), (a, c, b), (b, a, c), (b, c, a),
                                 (c, a, b), (c, b, a)}):
            pts.append((l1, l2))
            wts.append(w)
    wts = np.array(wts)
    return np.array(pts), wts * (0.5 / wts.sum())


def gauss_legendre(n: int = 3):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def p1_basis(pts):
    x, y = pts[:, 0], pts[:, 1]
    return np.stack([1.0 - x - y, x, y], axis=1)


P1_GRADS = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])


def p2_basis(pts):
    x, y = pts[:, 0], pts[:, 1]
    l0 = 1.0 - x - y
    return np.stack([l0 * (2 * l0 - 1), x * (2 * x - 1), y * (2 * y - 1),
                     4 * x * y, 4 * l0 * y, 4 * l0 * x], axis=1)


def p2_grads(pts):
    x, y = pts[:, 0], pts[:, 1]
    l0 = 1.0 - x - y
    g = np.zeros((len(pts), 6, 2))
    g[:, 0] = (1.0 - 4.0 * l0)[:, None]
    g[:, 1, 0] = 4.0 * x - 1.0
    g[:, 2, 1] = 4.0 * y - 1.0
    g[:, 3, 0], g[:, 3, 1] = 4.0 * y, 4.0 * x
    g[:, 4, 0], g[:, 4, 1] = -4.0 * y, 4.0 * (l0 - y)
    g[:, 5, 0], g[:, 5, 1] = 4.0 * (l0 - x), -4.0 * x
    return g


def facet_points(local_edge: int, t):
    a, b = REF_VERTS[LOCAL_EDGES[local_edge]]
    return a[None] * (1 - t[:, None]) + b[None] * t[:, None]


def jacobians(mesh: Mesh, cells=None):
    """(|det J| (C,), J^-1 (C, 2, 2)) of the cells' affine maps."""
    p = mesh.coords[mesh.cells if cells is None else mesh.cells[cells]]
    J = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], axis=2)
    det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    inv = np.stack([np.stack([J[:, 1, 1], -J[:, 0, 1]], 1),
                    np.stack([-J[:, 1, 0], J[:, 0, 0]], 1)], 1) / det[:, None, None]
    return np.abs(det), inv


def strain(g2):
    """eps of the 12 local vector basis functions, (..., 12, 2, 2)."""
    E = np.zeros(g2.shape[:-2] + (12, 2, 2))
    gx, gy = g2[..., 0], g2[..., 1]
    E[..., :6, 0, 0] = gx
    E[..., :6, 0, 1] = E[..., :6, 1, 0] = 0.5 * gy
    E[..., 6:, 1, 1] = gy
    E[..., 6:, 0, 1] = E[..., 6:, 1, 0] = 0.5 * gx
    return E


def scatter(Ae, rows, cols, shape):
    na, nb = Ae.shape[1:]
    r = np.repeat(rows[:, :, None], nb, axis=2).ravel()
    c = np.repeat(cols[:, None, :], na, axis=1).ravel()
    return sp.coo_matrix((Ae.ravel(), (r, c)), shape=shape).tocsr()


# ------------------------------------------------------------------ assembly

@dataclass
class Operators:
    mesh: Mesh
    M: sp.csr_matrix    # vector P2 mass
    Kv: sp.csr_matrix   # 2 mu (eps u, eps v)
    S: sp.csr_matrix    # mu <(grad u)^T n, v> over every exterior facet
    B: sp.csr_matrix    # (p, div v)
    Bn: sp.csr_matrix   # <p n, v>
    Kp: sp.csr_matrix   # (grad p, grad q)
    G: sp.csr_matrix    # (grad p, v)
    u_mask: np.ndarray  # Dirichlet velocity dofs
    u_vals: np.ndarray
    p_mask: np.ndarray  # Dirichlet pressure dofs (outflow)
    drag: tuple         # (d_u, d_p) of the drag functional
    lift: tuple


def assemble(mesh: Mesh, mu: float) -> Operators:
    ns, npr = mesh.ns, mesh.nv
    pts, w = dunavant_6()
    phi2, gref2, phi1 = p2_basis(pts), p2_grads(pts), p1_basis(pts)
    absdet, Jinv = jacobians(mesh)
    g2 = np.einsum("qad,cde->cqae", gref2, Jinv)
    g1 = np.einsum("ad,cde->cae", P1_GRADS, Jinv)
    wd = w[None] * absdet[:, None]
    cd2, cdv, cd1 = mesh.p2_cell_dofs(), mesh.vec_cell_dofs(), mesh.cells

    Ms = scatter(np.einsum("cq,qa,qb->cab", wd, phi2, phi2), cd2, cd2, (ns, ns))
    M = sp.block_diag([Ms, Ms], format="csr")
    E = strain(g2)
    Kv = scatter(2.0 * mu * np.einsum("cq,cqaij,cqbij->cab", wd, E, E), cdv, cdv,
                 (2 * ns, 2 * ns))
    dv = np.concatenate([g2[..., 0], g2[..., 1]], axis=2)
    B = scatter(np.einsum("cq,cqa,qb->cab", wd, dv, phi1), cdv, cd1, (2 * ns, npr))
    Kp = scatter(np.einsum("cad,cbd,c->cab", g1, g1, 0.5 * absdet), cd1, cd1,
                 (npr, npr))
    VB = np.zeros((len(mesh.cells), len(w), 12, 2))
    VB[:, :, :6, 0] = phi2[None]
    VB[:, :, 6:, 1] = phi2[None]
    G = scatter(np.einsum("cq,cqai,cbi->cab", wd, VB, g1), cdv, cd1, (2 * ns, npr))

    # Exterior facets: the viscous boundary term and the pressure's.
    t1d, w1d = gauss_legendre(3)
    fc, fl = mesh.facet_cells, mesh.facet_local
    F, K = len(fc), len(t1d)
    flat = np.stack([facet_points(l, t1d) for l in range(3)])[fl].reshape(-1, 2)
    phi2f = p2_basis(flat).reshape(F, K, 6)
    phi1f = p1_basis(flat).reshape(F, K, 3)
    g2f = np.einsum("fkad,fde->fkae", p2_grads(flat).reshape(F, K, 6, 2), Jinv[fc])
    n = mesh.facet_normals()
    W = w1d[None] * mesh.facet_lengths()[:, None]
    Se = mu * np.einsum("fk,fka,fkbi,fj->fiajb", W, phi2f, g2f, n).reshape(F, 12, 12)
    S = scatter(Se, cdv[fc], cdv[fc], (2 * ns, 2 * ns))
    Bne = np.einsum("fk,fkb,fi,fka->fiab", W, phi1f, n, phi2f).reshape(F, 12, 3)
    Bn = scatter(Bne, cdv[fc], cd1[fc], (2 * ns, npr))

    # Dirichlet data: parabolic inflow, no slip on the airfoil and walls,
    # p = 0 on the outflow.
    markers = mesh.markers()
    facet_edges = mesh.cell_edges[fc, fl]
    dof_y = np.concatenate([mesh.coords[:, 1],
                            mesh.coords[mesh.edges].mean(axis=1)[:, 1]])
    bot, top = mesh.coords[:, 1].min(), mesh.coords[:, 1].max()
    u_mask = np.zeros(2 * ns, dtype=bool)
    u_vals = np.zeros(2 * ns)
    for sel, inlet in ((markers == INFLOW, True), (mesh.facet_hits(AIRFOIL), False),
                       (mesh.facet_hits(WALLS), False)):
        sdofs = np.concatenate([np.unique(mesh.facets[sel]),
                                mesh.nv + np.unique(facet_edges[sel])])
        for comp in (0, 1):
            u_mask[comp * ns + sdofs] = True
            u_vals[comp * ns + sdofs] = (
                -4.0 * U_MAX * (dof_y[sdofs] - bot) * (dof_y[sdofs] - top)
                / (top - bot) ** 2 if inlet and comp == 0 else 0.0)
    p_mask = np.zeros(npr, dtype=bool)
    p_mask[np.unique(mesh.facets[mesh.facet_hits(OUTFLOW)])] = True

    # Drag and lift: the airfoil's boundary stress, a linear functional.
    on = markers == AIRFOIL
    sfc, sfl = fc[on], fl[on]
    _, Jinv_f = jacobians(mesh, sfc)
    tab = np.stack([facet_points(l, t1d) for l in range(3)])
    g2s = np.einsum("fkad,fde->fkae",
                    p2_grads(tab.reshape(-1, 2)).reshape(3, K, 6, 2)[sfl], Jinv_f)
    phi1s = p1_basis(tab.reshape(-1, 2)).reshape(3, K, 3)[sfl]
    ns_ = n[on]
    Ws = w1d[None] * mesh.facet_lengths()[on][:, None]
    ker_u = np.einsum("fk,fkaij,fj->fai", Ws, strain(g2s), ns_)
    ker_p = -np.einsum("fk,fkb,fi->fbi", Ws, phi1s, ns_)

    def functional(e):
        d_u, d_p = np.zeros(2 * ns), np.zeros(npr)
        np.add.at(d_u, cdv[sfc].ravel(), (2.0 * mu * (ker_u @ e)).ravel())
        np.add.at(d_p, cd1[sfc].ravel(), (ker_p @ e).ravel())
        return d_u, d_p

    return Operators(mesh=mesh, M=M, Kv=Kv, S=S, B=B, Bn=Bn, Kp=Kp, G=G,
                     u_mask=u_mask, u_vals=u_vals, p_mask=p_mask,
                     drag=functional(np.array([1.0, 0.0])),
                     lift=functional(np.array([0.0, 1.0])))


def convection_tables(mesh: Mesh):
    """(cell dofs (C, 12), phi (Q, 6), physical gradients (C, Q, 6, 2),
    quadrature weight times |det J| (C, Q)) of the convection term."""
    pts, w = dunavant_6()
    absdet, Jinv = jacobians(mesh)
    return (mesh.vec_cell_dofs(), p2_basis(pts),
            np.einsum("qad,cde->cqae", p2_grads(pts), Jinv), w[None] * absdet[:, None])

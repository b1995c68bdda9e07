"""Per-step convection assembly: c(u)_[(a,i)] = ((u.grad)u, Phi_a).

Counterpart of meshdqn_tpu/ops/convection.py, the only nonlinear term of the
IPCS step-1 right-hand side.  The tabulation is built once per mesh on the
host with numpy and moved to the device; `convection_vector` is plain torch:
gather the 12 local velocity dofs per cell, evaluate u and grad(u) at the
quadrature points, contract with the test basis, and sum into the global
vector.

The sum is deterministic.  Atomic scatters (`index_add_` on CUDA) change the
order of additions, and so the bits, from run to run; instead each global
dof owns a padded row of the (cell, local slot) entries it receives
(`dof_slots`, ascending in element order), pad slots point at an appended
zero, and the row is summed in fixed order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fem.assembly import cell_jacobians
from ..fem.reference import dunavant_6, p2_basis, p2_grads
from ..fem.spaces import VectorP2Space
from ..mesh import TriMesh


def dof_slots(cell_dofs: np.ndarray, ndofs: int) -> np.ndarray:
    """(ndofs, S) int64 incidence table of the flattened (C*12) element
    vector: row d lists, in ascending order, the flat positions whose entry
    sums into dof d, padded with C*12 (an appended zero)."""
    flat = np.asarray(cell_dofs, dtype=np.int64).ravel()
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=ndofs)
    width = max(int(counts.max(initial=0)), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(flat)) - np.repeat(starts, counts)
    table = np.full((ndofs, width), len(flat), dtype=np.int64)
    table[flat[order], rank] = order
    return table


@dataclass
class ConvectionKernel:
    """Static per-mesh tabulation for the convection vector, on one device.

    cell_dofs : (C, 12) int64 — global dofs (6 x-comp, 6 y-comp)
    phi       : (Q, 6) basis values (shared across cells)
    gphys     : (C, 6, Q, 2) physical gradients, local dof before quadrature
                point (the JAX kernel stores (C, Q, 6, 2)), so the per-cell
                contraction is one batched matmul
    wdet      : (C, Q) quadrature weight * |det J|
    dof_slots : (ndofs, S) int64 incidence table (see `dof_slots`)
    ndofs     : output size (2 Ns, or 2 ns_pad)
    """

    cell_dofs: torch.Tensor
    phi: torch.Tensor
    gphys: torch.Tensor
    wdet: torch.Tensor
    dof_slots: torch.Tensor
    ndofs: int

    @classmethod
    def from_arrays(cls, cell_dofs, phi, gphys, wdet, ndofs: int, *,
                    device, dtype) -> "ConvectionKernel":
        """From numpy arrays in the JAX kernel's layout (gphys (C, Q, 6, 2))."""
        cell_dofs = np.asarray(cell_dofs, dtype=np.int64)
        ndofs = int(ndofs)
        as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
        return cls(
            cell_dofs=torch.tensor(cell_dofs, device=device),
            phi=as_t(phi),
            gphys=as_t(np.ascontiguousarray(np.transpose(gphys, (0, 2, 1, 3)))),
            wdet=as_t(wdet),
            dof_slots=torch.as_tensor(dof_slots(cell_dofs, ndofs), device=device),
            ndofs=ndofs,
        )

    @classmethod
    def build(
        cls,
        mesh: TriMesh,
        *,
        device,
        dtype=torch.float64,
        ns_pad: int | None = None,
        dof_perm: np.ndarray | None = None,
        cells_pad: int = 0,
    ) -> "ConvectionKernel":
        """ns_pad: re-layout output dofs for a scalar block padded to ns_pad
        (solver pad_quantum): y-component dofs shift from +Ns to +ns_pad.
        dof_perm: old->new velocity dof map (the banded CG layout's
        interleaved RCM order); the gather indices, and with them the
        fixed-order slot table, are remapped so the kernel consumes and
        produces vectors in the new layout.
        cells_pad: quantize the cell count up to a multiple by repeating
        cell 0's tabulation with wdet=0 — exact, as in the JAX kernel (each
        cell's contribution is scaled by wdet)."""
        pts, w = dunavant_6()
        phi = p2_basis(pts)
        gref = p2_grads(pts)
        _, absdet, Jinv = cell_jacobians(mesh)
        gphys = np.einsum("qad,cde->cqae", gref, Jinv)
        wdet = w[None, :] * absdet[:, None]
        V = VectorP2Space(mesh)
        cell_dofs = np.asarray(V.cell_dofs())
        ndofs = V.ndofs
        if ns_pad is not None:
            ns = ndofs // 2
            cell_dofs = np.concatenate(
                [cell_dofs[:, :6], cell_dofs[:, 6:] - ns + ns_pad], axis=1
            )
            ndofs = 2 * ns_pad
        if dof_perm is not None:
            if ns_pad is not None:
                raise ValueError("dof_perm and ns_pad are exclusive")
            cell_dofs = np.asarray(dof_perm)[cell_dofs]
        if cells_pad:
            C = cell_dofs.shape[0]
            k = -(-C // cells_pad) * cells_pad - C
            if k:
                cell_dofs = np.concatenate(
                    [cell_dofs, np.repeat(cell_dofs[:1], k, axis=0)]
                )
                gphys = np.concatenate([gphys, np.repeat(gphys[:1], k, axis=0)])
                wdet = np.concatenate(
                    [wdet, np.zeros((k, wdet.shape[1]), wdet.dtype)]
                )
        return cls.from_arrays(
            cell_dofs, phi, gphys, wdet, ndofs, device=device, dtype=dtype
        )

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return convection_vector(self, u)


def convection_vector(k: ConvectionKernel, u: torch.Tensor) -> torch.Tensor:
    """Assemble ((u.grad)u, v) for the velocity field u (ndofs,)."""
    C = k.cell_dofs.shape[0]
    Q = k.phi.shape[0]
    U = u[k.cell_dofs].view(C, 2, 6)  # (cell, component, local dof)
    uq = U @ k.phi.T  # (C, 2, Q): u_x, u_y at the quadrature points
    # du_i/dx_j at the quadrature points: (C, 2, Q, 2) = (cell, i, q, j)
    du = torch.bmm(U, k.gphys.view(C, 6, 2 * Q)).view(C, 2, Q, 2)
    # (u . grad) u_i, in the JAX kernel's order: u_x du_i/dx + u_y du_i/dy
    conv = uq[:, 0, None, :] * du[..., 0] + uq[:, 1, None, :] * du[..., 1]
    # element vectors r[(i, a)] = sum_q wdet conv_i phi_a -> (C, 12)
    relem = ((k.wdet[:, None, :] * conv) @ k.phi).reshape(-1)
    padded = torch.cat([relem, relem.new_zeros(1)])
    return padded[k.dof_slots].sum(dim=1)

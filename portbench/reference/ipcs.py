"""Plain IPCS time loop: the benchmark's reference for the fused solve.

The three IPCS steps as the paper's solver states them, each system solved
by a dense inverse of the Dirichlet-eliminated matrix, every other linear
piece a sparse product, the convection term evaluated cell by cell:

    u*  = A1^-1 [z_u (R1 u + (B - Bn) p - rho c(u)) + t1]
    p'  = A2^-1 [z_p (Kp p - B^T u* / dt) + t2]
    u'_i = A3^-1 [z_s (Ms u*_i - dt G_i (p' - p)) + t3_i],   i = x, y

This is the unfused form of the step; the program composes the same algebra
into seven dense operators.  `precision='f64'` is the reference.
`precision='tf32'` is the control: state in float32 and every product's
operands rounded to TF32 (10 mantissa bits) with float32 sums, which is what
a float32 solve would compute with TF32 tensor-core products switched on.
It imports numpy, scipy and torch only.
"""
from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

from .fem import Mesh, assemble, convection_tables


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits), to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bits = bits + (0x0FFF + ((bits >> 13) & 1))
    return (bits & ~0x1FFF).view(torch.float32)


def _eliminate(A, mask):
    """Symmetric Dirichlet elimination Z A Z + I_bc."""
    z = sp.diags((~mask).astype(np.float64))
    return (z @ A @ z + sp.diags(mask.astype(np.float64))).tocsr()


class ReferenceFlow:
    """One mesh's plain IPCS solve on `device` in `precision`."""

    def __init__(self, coords, cells, *, mu, rho, dt, device, precision="f64"):
        if precision not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        mesh = Mesh(coords, cells)
        ops = assemble(mesh, mu)
        self.ns, self.np = ns, npr = mesh.ns, mesh.nv
        self.rho, self.dt = rho, dt
        self.dtype = torch.float64 if precision == "f64" else torch.float32
        self.rnd = to_tf32 if precision == "tf32" else (lambda x: x)
        f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
        cast = lambda t: self.rnd(t.to(self.dtype))

        A1 = (rho / dt) * ops.M + 0.5 * ops.Kv - 0.5 * ops.S
        R1 = (rho / dt) * ops.M - 0.5 * ops.Kv + 0.5 * ops.S
        Ms = ops.M[:ns, :ns].tocsr()
        zu = (~ops.u_mask).astype(np.float64)
        zp = (~ops.p_mask).astype(np.float64)
        gu = ops.u_vals
        self.zu, self.zp = f64(zu).to(self.dtype), f64(zp).to(self.dtype)
        self.zs = f64(zu[:ns, None]).to(self.dtype)
        self.t1 = f64(gu - zu * (A1 @ gu)).to(self.dtype)
        self.t2 = torch.zeros(npr, dtype=self.dtype, device=device)  # p = 0 there
        t3 = gu - zu * (ops.M @ gu)
        self.t3 = f64(np.stack([t3[:ns], t3[ns:]], axis=1)).to(self.dtype)

        def inverse(A):
            return cast(torch.linalg.inv(f64(A.toarray())))

        self.A1inv = inverse(_eliminate(A1, ops.u_mask))
        self.A2inv = inverse(_eliminate(ops.Kp, ops.p_mask))
        self.A3inv = inverse(_eliminate(Ms, ops.u_mask[:ns]))

        def sparse(A):
            A = sp.csr_matrix(A)
            A.sum_duplicates()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # "beta state"
                return torch.sparse_csr_tensor(
                    torch.as_tensor(A.indptr.astype(np.int64), device=device),
                    torch.as_tensor(A.indices.astype(np.int64), device=device),
                    cast(f64(A.data)), size=A.shape, check_invariants=True)

        # Each step's right-hand sides as one sparse product apiece:
        # b1 = [R1, B - Bn] [u; p],  b2 = [Kp, -B^T / dt] [p; u*],
        # b3 = [[Ms, 0, -dt Gx], [0, Ms, -dt Gy]] [u*; p' - p].
        Gx, Gy = ops.G[:ns], ops.G[ns:]
        self.S1 = sparse(sp.hstack([R1, ops.B - ops.Bn]))
        self.S2 = sparse(sp.hstack([ops.Kp, -ops.B.T / dt]))
        self.S3 = sparse(sp.bmat([[Ms, None, -dt * Gx], [None, Ms, -dt * Gy]]))
        self.Du = cast(f64(np.stack([ops.drag[0], ops.lift[0]])))
        self.Dp = cast(f64(np.stack([ops.drag[1], ops.lift[1]])))
        cd, phi, g, wd = convection_tables(mesh)
        self.cell_dofs = torch.as_tensor(cd, device=device)
        self.flat_dofs = self.cell_dofs.reshape(-1)
        self.phi = cast(f64(phi))                                   # (Q, 6)
        # (C, 6, Q * 2): gradient a at point q, component j at [a, 2 q + j]
        self.grads = cast(f64(np.ascontiguousarray(g.transpose(0, 2, 1, 3)))
                          ).reshape(len(cd), 6, -1)
        self.wdet = f64(wd).to(self.dtype)[:, None]                 # (C, 1, Q)

    def mv(self, A, x):
        """A x, with the precision's rounding of both operands."""
        return A @ self.rnd(x)

    def convection(self, u):
        """((u . grad) u, v) for every velocity test function."""
        U = self.rnd(u[self.cell_dofs].view(-1, 2, 6))          # (C, i, a)
        uq = U @ self.phi.T                                     # (C, j, q)
        du = torch.bmm(U, self.grads).view(len(U), 2, -1, 2)    # (C, i, q, j)
        conv = (du * uq.transpose(1, 2)[:, None]).sum(-1)       # (C, i, q)
        elem = self.rnd(self.wdet * conv) @ self.phi            # (C, i, a)
        return torch.zeros_like(u).index_add_(0, self.flat_dofs, elem.reshape(-1))

    def step(self, u, p):
        """One IPCS step; returns (u', p', [drag, lift])."""
        ns = self.ns
        b1 = torch.sub(self.mv(self.S1, torch.cat([u, p])), self.convection(u),
                       alpha=self.rho)
        us = self.mv(self.A1inv, torch.addcmul(self.t1, self.zu, b1))
        b2 = self.mv(self.S2, torch.cat([p, us]))
        p_new = self.mv(self.A2inv, torch.addcmul(self.t2, self.zp, b2))
        b3 = self.mv(self.S3, torch.cat([us, p_new - p])).view(2, ns).T
        y = self.mv(self.A3inv, torch.addcmul(self.t3, self.zs, b3))  # (Ns, 2)
        u_new = y.T.reshape(-1)
        return u_new, p_new, self.mv(self.Du, u_new) + self.mv(self.Dp, p_new)

    def solve(self, u0, steps: int):
        """`steps` steps from velocity u0 (2Ns,) and zero pressure; returns
        (drags (steps,), lifts (steps,), u (2Ns,), p (Np,)) as float64
        numpy arrays."""
        u = torch.as_tensor(np.asarray(u0), device=self.A1inv.device).to(self.dtype)
        p = torch.zeros(self.np, dtype=self.dtype, device=u.device)
        forces = torch.empty((steps, 2), dtype=self.dtype, device=u.device)
        for i in range(steps):
            u, p, forces[i] = self.step(u, p)
        out = (forces[:, 0], forces[:, 1], u, p)
        return tuple(t.double().cpu().numpy() for t in out)

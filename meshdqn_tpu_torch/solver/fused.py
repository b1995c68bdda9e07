"""Fused-operator IPCS step: the whole linear update as dense matvecs.

Counterpart of meshdqn_tpu/solver/fused.py.  Everything linear in the IPCS
step is constant, so the solve/assemble/BC pipeline composes into fixed dense
operators:

    u* = F1u u^n + F1p p^n - rho A1Z c(u^n) + k1
    p' = F2p p^n + F2u u* + k2
    u' = [F3s u*_x + F3px (p'-p^n) + k3x ; F3s u*_y + F3py (p'-p^n) + k3y]

with  F1u = A1Z R1,  F1p = A1Z (B - Bn),  A1Z = A1bc^{-1} Z_u,
      F2p = A2Z Kp,  F2u = -(1/dt) A2Z B^T,
      F3s = A3Zs Ms (scalar mass block),  F3p* = -dt [A3Zs G_x; A3Zs G_y],
      k_i = A_ibc^{-1} t_i.

`compose_fused` builds them in f64 with one LU factorisation per system on
the solver's device (Hopper has native f64, so the JAX package's
Newton–Schulz inverse and f32-LU refinement are not needed), then casts to
the working dtype.  `fused_step` sends every dense apply through
ops.matvec.matvec, the hand-written kernel on CUDA.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.convection import ConvectionKernel
from ..ops.matvec import matvec


class FlowState(NamedTuple):
    """Velocity/pressure dof vectors on the solver's mesh."""

    u: torch.Tensor  # (2Ns,)
    p: torch.Tensor  # (Np,)


class FusedOperators(NamedTuple):
    F1u: torch.Tensor  # (2Ns, 2Ns)
    F1p: torch.Tensor  # (2Ns, Np)
    A1Z: torch.Tensor  # (2Ns, 2Ns)
    k1: torch.Tensor  # (2Ns,)
    F2p: torch.Tensor  # (Np, Np)
    F2u: torch.Tensor  # (Np, 2Ns)
    k2: torch.Tensor  # (Np,)
    F3s: torch.Tensor  # (Ns, Ns)
    F3p: torch.Tensor  # (2, Ns, Np) stacked x/y blocks
    k3: torch.Tensor  # (2Ns,)
    conv: ConvectionKernel
    drag_u: torch.Tensor
    drag_p: torch.Tensor
    lift_u: torch.Tensor
    lift_p: torch.Tensor
    rho: torch.Tensor  # 0-d


def _dense64(A, device) -> torch.Tensor:
    """A scipy sparse matrix as a dense f64 tensor built on `device`.

    Duplicates are summed on the host first, so the device write is a plain
    (non-accumulating, hence deterministic) index_put_."""
    A = sp.coo_matrix(A)
    A.sum_duplicates()
    out = torch.zeros(A.shape, dtype=torch.float64, device=device)
    idx = (torch.as_tensor(A.row.astype(np.int64), device=device),
           torch.as_tensor(A.col.astype(np.int64), device=device))
    out.index_put_(idx, torch.as_tensor(A.data, dtype=torch.float64, device=device))
    return out


def compose_fused(
    *,
    A1bc,
    A2bc,
    A3bc_s,
    R1,
    P1m,
    Kp,
    BT,
    Ms,
    G,
    z_u,
    z_p,
    t1,
    t2,
    t3,
    dt,
    rho,
    conv: ConvectionKernel,
    drag_u,
    drag_p,
    lift_u,
    lift_p,
    device,
    dtype=torch.float32,
) -> FusedOperators:
    """Compose the fused operators in f64 on `device`, then cast to `dtype`.

    Same inputs (scipy sparse systems, numpy vectors) and the same algebra as
    meshdqn_tpu.solver.fused.build_fused_host_f64; A^-1 B is formed as
    lu_solve(lu_factor(A), B) rather than inv(A) @ B, so entries agree with
    the host-f64 composition to f64 rounding before the cast."""
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)
    D = lambda A: _dense64(A, device)
    cast = lambda a: a.to(dtype).contiguous()
    ns = A3bc_s.shape[0]
    zu, zp = f64(z_u), f64(z_p)

    def solve(A, *rhs):
        lu, piv = torch.linalg.lu_factor(D(A))
        return [torch.linalg.lu_solve(lu, piv, b) for b in rhs]

    # Tentative-velocity system: A1Z = A1^-1 diag(z_u).
    F1u, F1p, A1Z, k1 = solve(
        A1bc, zu[:, None] * D(R1), zu[:, None] * D(P1m), torch.diag(zu),
        f64(t1)[:, None],
    )
    # Pressure Poisson system.
    F2p, F2u, k2 = solve(
        A2bc, zp[:, None] * D(Kp), zp[:, None] * D(BT), f64(t2)[:, None]
    )
    F2u = -(1.0 / dt) * F2u
    # Scalar-mass (velocity-correction) system, both components at once.
    zs = zu[:ns, None]
    Gd = D(G)
    t3v = f64(t3)
    F3s, F3px, F3py, k3 = solve(
        A3bc_s, zs * D(Ms), zs * Gd[:ns], zs * Gd[ns:],
        torch.stack([t3v[:ns], t3v[ns:]], dim=1),
    )
    F3p = torch.stack([-dt * F3px, -dt * F3py])
    k3 = torch.cat([k3[:, 0], k3[:, 1]])
    return FusedOperators(
        F1u=cast(F1u),
        F1p=cast(F1p),
        A1Z=cast(A1Z),
        k1=cast(k1[:, 0]),
        F2p=cast(F2p),
        F2u=cast(F2u),
        k2=cast(k2[:, 0]),
        F3s=cast(F3s),
        F3p=cast(F3p),
        k3=cast(k3),
        conv=conv,
        drag_u=cast(f64(drag_u)),
        drag_p=cast(f64(drag_p)),
        lift_u=cast(f64(lift_u)),
        lift_p=cast(f64(lift_p)),
        rho=torch.tensor(rho, dtype=dtype, device=device),
    )


def fused_step(dev: FusedOperators, state: FlowState, apply=matvec):
    """One IPCS step via the fused dense operators; returns
    (new_state, (drag, lift)).  Works in the operators' dtype.

    `apply` does the seven dense products: the kernel's wrapper, or its
    plain version ops.matvec.matvec_reference for an f64 step on the card,
    which the f32-only kernel does not take."""
    u_n, p_n = state
    c = dev.conv(u_n)
    u_star = (
        apply(dev.F1u, u_n)
        + apply(dev.F1p, p_n)
        - dev.rho * apply(dev.A1Z, c)
        + dev.k1
    )
    p_new = apply(dev.F2p, p_n) + apply(dev.F2u, u_star) + dev.k2
    dp = p_new - p_n
    ns = dev.F3s.shape[0]
    ustack = torch.stack([u_star[:ns], u_star[ns:]], dim=1)  # (Ns, 2)
    y = apply(dev.F3s, ustack)  # (Ns, 2)
    # F3p as (2Ns, Np): its product with dp is [x-block; y-block], the
    # transpose of the (Ns, 2) stack.
    corr = apply(dev.F3p.view(2 * ns, -1), dp).view(2, ns)
    y = y + corr.T
    u_new = torch.cat([y[:, 0], y[:, 1]]) + dev.k3

    drag = dev.drag_u @ u_new + dev.drag_p @ p_new
    lift = dev.lift_u @ u_new + dev.lift_p @ p_new
    return FlowState(u=u_new, p=p_new), (drag, lift)

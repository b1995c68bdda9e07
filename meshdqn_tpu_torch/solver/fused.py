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
the working dtype.  `fused_step` runs the step's seven dense applies and
the elementwise work around them as three launches of the hand-written
matvec kernel's grouped form (ops.matvec.step_ustar, step_pressure,
step_velocity) on CUDA.

precision='df32' keeps each operator as an f32 high limb and a bf16 low
limb (`SplitLow`, from `compose_fused(..., split=True)`): the f32 step's
error is the operators' fixed f32 entry rounding applied on every step, and
the low limb removes most of it.  `fused_step_df32` runs the step as three
launches of the kernel's split form (ops.matvec.step_*_df32).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.convection import ConvectionKernel
from ..ops.matvec import (
    step_pressure, step_pressure_df32, step_pressure_df32_reference,
    step_pressure_reference, step_ustar, step_ustar_df32, step_ustar_df32_reference,
    step_ustar_reference, step_velocity, step_velocity_df32,
    step_velocity_df32_reference, step_velocity_reference,
)


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


class SplitLow(NamedTuple):
    """Low limbs of the fused operators for the 'df32' step
    (meshdqn_tpu/solver/fused.py SplitLow): each matrix limb is
    bf16(f32(x64 - f64(hi))), |lo| <= 2^-24 |hi| entrywise, which leaves
    ~2.4e-10 of the operator unrepresented; vector limbs are f32."""

    F1u: torch.Tensor
    F1p: torch.Tensor
    A1Z: torch.Tensor
    k1: torch.Tensor
    F2p: torch.Tensor
    F2u: torch.Tensor
    k2: torch.Tensor
    F3s: torch.Tensor
    F3p: torch.Tensor
    k3: torch.Tensor


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
    split: bool = False,
):
    """Compose the fused operators in f64 on `device`, then cast to `dtype`.

    Same inputs (scipy sparse systems, numpy vectors) and the same algebra as
    meshdqn_tpu.solver.fused.build_fused_host_f64; A^-1 B is formed as
    lu_solve(lu_factor(A), B) rather than inv(A) @ B, so entries agree with
    the host-f64 composition to f64 rounding before the cast.  With `split`
    (dtype float32) also returns the `SplitLow` of the same f64 operators,
    limbs made as build_fused_host_f64(split=True) makes them: a matrix's
    f64 remainder rounded to f32, then to bf16; a vector's to f32."""
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
    f64s = dict(F1u=F1u, F1p=F1p, A1Z=A1Z, k1=k1[:, 0], F2p=F2p, F2u=F2u,
                k2=k2[:, 0], F3s=F3s, F3p=F3p, k3=k3)
    hi = {name: cast(a) for name, a in f64s.items()}
    dev = FusedOperators(
        **hi,
        conv=conv,
        drag_u=cast(f64(drag_u)),
        drag_p=cast(f64(drag_p)),
        lift_u=cast(f64(lift_u)),
        lift_p=cast(f64(lift_p)),
        rho=torch.tensor(rho, dtype=dtype, device=device),
    )
    if not split:
        return dev
    if dtype != torch.float32:
        raise ValueError("split limbs are made for float32 high limbs")
    lo = {}
    for name, a in f64s.items():
        rest = (a - hi[name].double()).float()
        lo[name] = (rest if a.dim() == 1 else rest.bfloat16()).contiguous()
    return dev, SplitLow(**lo)


def fused_step(dev: FusedOperators, state: FlowState, apply=None):
    """One IPCS step via the fused dense operators; returns
    (new_state, (drag, lift)).  Works in the operators' dtype.

    By default the step is three grouped launches of the matvec kernel on
    CUDA (their plain versions on the CPU).  With `apply`, the same torch
    expressions with every dense product through `apply`: ops.matvec.matvec
    for seven single launches, which the grouped launches equal bit for bit,
    or its plain version ops.matvec.matvec_reference for an f64 step on the
    card, which the f32-only kernel does not take."""
    u_n, p_n = state
    c = dev.conv(u_n)
    if apply is None:
        u_star = step_ustar(dev.F1u, dev.F1p, dev.A1Z, dev.rho, dev.k1, u_n, p_n, c)
        p_new, dp = step_pressure(dev.F2p, dev.F2u, dev.k2, p_n, u_star)
        u_new = step_velocity(dev.F3s, dev.F3p, dev.k3, u_star, dp)
    else:
        u_star = step_ustar_reference(dev.F1u, dev.F1p, dev.A1Z, dev.rho, dev.k1,
                                      u_n, p_n, c, apply=apply)
        p_new, dp = step_pressure_reference(dev.F2p, dev.F2u, dev.k2, p_n, u_star,
                                            apply=apply)
        u_new = step_velocity_reference(dev.F3s, dev.F3p, dev.k3, u_star, dp,
                                        apply=apply)

    drag = dev.drag_u @ u_new + dev.drag_p @ p_new
    lift = dev.lift_u @ u_new + dev.lift_p @ p_new
    return FlowState(u=u_new, p=p_new), (drag, lift)


def fused_step_df32(dev: FusedOperators, lo: SplitLow, state: FlowState,
                    apply=None):
    """One IPCS step with split (f32 high + bf16 low limb) operators,
    meshdqn_tpu/solver/fused.py:fused_step_df32; returns (new_state, (drag,
    lift)).

    By default the step is three launches of the matvec kernel's split
    form on CUDA (their plain versions on the CPU).  With `apply`, the plain
    versions with the high limbs' products through `apply` (ops.matvec.matvec
    for single launches) and the low limbs' as bf16 products in torch."""
    u_n, p_n = state
    c = dev.conv(u_n)
    if apply is None:
        u_star = step_ustar_df32(dev.F1u, dev.F1p, dev.A1Z, dev.rho, dev.k1,
                                 lo.F1u, lo.F1p, lo.A1Z, lo.k1, u_n, p_n, c)
        p_new, dp = step_pressure_df32(dev.F2p, dev.F2u, dev.k2, lo.F2p, lo.F2u,
                                       lo.k2, p_n, u_star)
        u_new = step_velocity_df32(dev.F3s, dev.F3p, dev.k3, lo.F3s, lo.F3p, lo.k3,
                                   u_star, dp)
    else:
        u_star = step_ustar_df32_reference(dev.F1u, dev.F1p, dev.A1Z, dev.rho, dev.k1,
                                           lo.F1u, lo.F1p, lo.A1Z, lo.k1, u_n, p_n, c,
                                           apply=apply)
        p_new, dp = step_pressure_df32_reference(dev.F2p, dev.F2u, dev.k2, lo.F2p,
                                                 lo.F2u, lo.k2, p_n, u_star, apply=apply)
        u_new = step_velocity_df32_reference(dev.F3s, dev.F3p, dev.k3, lo.F3s, lo.F3p,
                                             lo.k3, u_star, dp, apply=apply)

    drag = dev.drag_u @ u_new + dev.drag_p @ p_new
    lift = dev.lift_u @ u_new + dev.lift_p @ p_new
    return FlowState(u=u_new, p=p_new), (drag, lift)

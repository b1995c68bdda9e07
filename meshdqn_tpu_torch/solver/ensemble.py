"""Ensemble flows: B inflow amplitudes on one mesh as matrix columns.

Counterpart of meshdqn_tpu/solver/ensemble.py.  The IPCS operators depend on
the mesh and the places of the Dirichlet dofs, not on the inflow values:
scaling the inlet amplitude Um -> s Um scales the boundary values, and with
them the affine step vectors k1 and k3, linearly.  So B amplitudes share
every fused operator: the B states are the columns of (n, B) matrices, and
each of the step's products is one launch of the matvec kernel's k-column
form (ops/matvec.py matvec), which streams the operator once for all
members.

The step groups its products as the JAX package's ensemble_step does: F1u,
F1p and A1Z on (., B); F2p and F2u; F3s on the (Ns, 2B) stack of both
velocity components of every member; F3p as one (2Ns, Np) product on dp.
Seven launches a step.  Every column of a k-column launch equals a k = 1
launch on that column bit for bit, those equal the grouped launches of the
fused step (solver/fused.py), and the elementwise sums run in the fused
step's order, so the member of amplitude 1.0 takes the fused step's
arithmetic: its state equals a solo fused f32 solve's bit for bit on the
card.  Its drag and lift are dot products against a column, summed in
another order than the solo step's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..mesh import TriMesh
from ..ops.convection import convection_columns
from ..ops.matvec import matvec
from .fused import FusedOperators
from .ipcs import IPCSConfig, IPCSSolver, _loop


class EnsembleState(NamedTuple):
    u: torch.Tensor  # (2Ns, B)
    p: torch.Tensor  # (Np, B)


def ensemble_step(dev: FusedOperators, K1: torch.Tensor, K3: torch.Tensor,
                  state: EnsembleState):
    """One IPCS step for all members; K1, K3 (2Ns, B) are the members'
    amplitude-scaled k1 and k3.  Returns (new_state, (drags (B,), lifts
    (B,))).  The products are matvec launches on CUDA (plain products on
    the CPU, in the tensors' dtype)."""
    u_n, p_n = state
    c = convection_columns(dev.conv, u_n)
    u_star = (matvec(dev.F1u, u_n) + matvec(dev.F1p, p_n)
              - dev.rho * matvec(dev.A1Z, c) + K1)
    p_new = matvec(dev.F2p, p_n) + matvec(dev.F2u, u_star) + dev.k2[:, None]
    dp = p_new - p_n
    ns = dev.F3s.shape[0]
    B = u_n.shape[1]
    # (Ns, 2B): both components of every member through the scalar block.
    y = matvec(dev.F3s, torch.cat([u_star[:ns], u_star[ns:]], dim=1))
    corr = matvec(dev.F3p.view(2 * ns, -1), dp)  # (2Ns, B): [x-block; y-block]
    u_new = torch.cat([y[:, :B] + corr[:ns], y[:, B:] + corr[ns:]]) + K3
    drag = dev.drag_u @ u_new + dev.drag_p @ p_new
    lift = dev.lift_u @ u_new + dev.lift_p @ p_new
    return EnsembleState(u=u_new, p=p_new), (drag, lift)


def evolve_ensemble_n(dev: FusedOperators, K1, K3, state: EnsembleState, n_steps: int):
    """n_steps ensemble steps; returns (state, (drags (n, B), lifts (n, B)))."""
    return _loop(lambda s: ensemble_step(dev, K1, K3, s), state, n_steps,
                 state.u.dtype, state.u.device, members=(state.u.shape[1],))


class EnsembleFlows:
    """B inflow amplitudes on one mesh, one fused f32 operator set, on
    `device` (CUDA unless named)."""

    def __init__(self, mesh: TriMesh, amplitudes: Sequence[float],
                 config: IPCSConfig | None = None, device=None):
        """amplitudes: multipliers of the reference inlet profile (Um = 1.5
        at amplitude 1.0)."""
        config = config or IPCSConfig(precision="f32", fused=True)
        if config.precision != "f32":
            raise ValueError("ensembles require the fused f32 path")
        config = dataclasses.replace(config, fused=True)
        self.solver = IPCSSolver(mesh, config, device=device)
        dev = self.solver.dev
        self.amps = torch.as_tensor(np.asarray(amplitudes, dtype=np.float32),
                                    device=self.solver.device)
        self.B = len(amplitudes)
        # The affine vectors scale linearly with the inlet amplitude.
        self.K1 = (dev.k1[:, None] * self.amps[None, :]).contiguous()
        self.K3 = (dev.k3[:, None] * self.amps[None, :]).contiguous()

    def initial_state(self) -> EnsembleState:
        s = self.solver
        return EnsembleState(
            u=torch.zeros(s.ndofs_u, self.B, dtype=torch.float32, device=s.device),
            p=torch.zeros(s.ndofs_p, self.B, dtype=torch.float32, device=s.device),
        )

    def evolve(self, state: EnsembleState, n_steps: int):
        """-> (state, drags (B, n), lifts (B, n))."""
        state, (d, l) = evolve_ensemble_n(self.solver.dev, self.K1, self.K3, state,
                                          n_steps)
        return state, d.T, l.T

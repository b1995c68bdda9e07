"""Batched flows: B transient solves of different meshes as one program.

Counterpart of meshdqn_tpu/solver/batch.py.  Each mesh's fused operators
(solver/fused.py) are padded to common dimensions and stacked with a
leading member axis; every step is the members' convection and three
launches of the matvec kernel's batched grouped form (ops/matvec.py
step_ustar, step_pressure, step_velocity on (B, R, N) operators), which
walk the rows of all members at once.

Velocity vectors keep the block layout [x-dofs | y-dofs], padded per
component: [x (ns) | 0 | y (ns) | 0] in blocks of ns_max, so the split at
ns_max inside the step stays aligned for every member.  Zero padding is
exact: padded operator rows and columns are zero and padded state entries
start at zero, so they stay zero through the whole recursion.

Each member keeps its own convection table (`FusedOperators.conv` of the
stacked operators is a tuple of them), its y-component dofs moved from +ns
to +ns_max, and runs the single convection call
(ops.convection.convection_members), so a member whose mesh is the largest
is stepped with its solo solve's bits.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..mesh import TriMesh
from ..ops.convection import ConvectionKernel, convection_members, dof_slots
from ..ops.matvec import step_pressure, step_ustar, step_velocity
from .fused import FlowState, FusedOperators
from .ipcs import IPCSConfig, IPCSSolver, _loop


def _pad_to(a: torch.Tensor, shape) -> torch.Tensor:
    out = a.new_zeros(tuple(shape))
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def _stack_padded(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    if arrays[0].dim() == 0:
        return torch.stack(list(arrays))
    target = [max(a.shape[d] for a in arrays) for d in range(arrays[0].dim())]
    return torch.stack([_pad_to(a, target) for a in arrays])


def _expand2(a: torch.Tensor, ns: int, ns_max: int, axis: int) -> torch.Tensor:
    """Re-layout a [x (ns) | y (ns)] axis into [x | 0 | y | 0] blocks of
    ns_max, so the component split survives padding."""
    m = a.movedim(axis, 0)
    z = m.new_zeros((ns_max - ns,) + tuple(m.shape[1:]))
    return torch.cat([m[:ns], z, m[ns:], z]).movedim(0, axis)


def _shift_conv(conv: ConvectionKernel, ns: int, ns_max: int) -> ConvectionKernel:
    """The member's convection table in the padded layout: y-component cell
    dofs move from +ns to +ns_max (ConvectionKernel.build's ns_pad), and the
    slot table follows, each dof's slots in the same order as before."""
    cd = conv.cell_dofs.cpu().numpy()
    cd = np.concatenate([cd[:, :6], cd[:, 6:] - ns + ns_max], axis=1)
    device = conv.cell_dofs.device
    return dataclasses.replace(
        conv,
        cell_dofs=torch.as_tensor(cd, device=device),
        dof_slots=torch.as_tensor(dof_slots(cd, 2 * ns_max), device=device),
        ndofs=2 * ns_max,
    )


def stack_fused(devs: Sequence[FusedOperators]) -> FusedOperators:
    """Stack per-mesh fused operators into batched (B, ...) operators, as
    meshdqn_tpu/solver/batch.py:stack_fused does: every velocity-sized axis
    padded per component, every other axis at its end; `conv` becomes the
    tuple of the members' tables in the padded layout."""
    ns_list = [d.F3s.shape[0] for d in devs]
    ns_max = max(ns_list)

    def vec2(vs):
        return torch.stack([_expand2(v, ns, ns_max, 0) for v, ns in zip(vs, ns_list)])

    def mat2(ms, axes):
        out = []
        for m, ns in zip(ms, ns_list):
            for ax in axes:
                m = _expand2(m, ns, ns_max, ax)
            out.append(m)
        return _stack_padded(out)

    return FusedOperators(
        F1u=mat2([d.F1u for d in devs], (0, 1)),
        F1p=mat2([d.F1p for d in devs], (0,)),
        A1Z=mat2([d.A1Z for d in devs], (0, 1)),
        k1=vec2([d.k1 for d in devs]),
        F2p=_stack_padded([d.F2p for d in devs]),
        F2u=mat2([d.F2u for d in devs], (1,)),
        k2=_stack_padded([d.k2 for d in devs]),
        F3s=_stack_padded([d.F3s for d in devs]),
        F3p=_stack_padded([d.F3p for d in devs]),
        k3=vec2([d.k3 for d in devs]),
        conv=tuple(_shift_conv(d.conv, ns, ns_max) for d, ns in zip(devs, ns_list)),
        drag_u=vec2([d.drag_u for d in devs]),
        drag_p=_stack_padded([d.drag_p for d in devs]),
        lift_u=vec2([d.lift_u for d in devs]),
        lift_p=_stack_padded([d.lift_p for d in devs]),
        rho=torch.stack([d.rho for d in devs]),
    )


def _dot(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-member w[b] . x[b] of (B, n) stacks, as (B,)."""
    return torch.matmul(x.unsqueeze(1), w.unsqueeze(2))[:, 0, 0]


def batched_step(dev: FusedOperators, state: FlowState):
    """One fused IPCS step of every member (meshdqn_tpu's vmapped
    fused_step): the members' convection, then the three batched grouped
    launches on CUDA (their per-member plain versions on the CPU).  Returns
    (new_state, (drags (B,), lifts (B,)))."""
    u_n, p_n = state
    c = convection_members(dev.conv, u_n)
    u_star = step_ustar(dev.F1u, dev.F1p, dev.A1Z, dev.rho, dev.k1, u_n, p_n, c)
    p_new, dp = step_pressure(dev.F2p, dev.F2u, dev.k2, p_n, u_star)
    u_new = step_velocity(dev.F3s, dev.F3p, dev.k3, u_star, dp)
    drag = _dot(dev.drag_u, u_new) + _dot(dev.drag_p, p_new)
    lift = _dot(dev.lift_u, u_new) + _dot(dev.lift_p, p_new)
    return FlowState(u=u_new, p=p_new), (drag, lift)


def evolve_batched_n(dev: FusedOperators, state: FlowState, n_steps: int):
    """n_steps batched steps; returns (state, (drags (n, B), lifts (n, B)))."""
    return _loop(lambda s: batched_step(dev, s), state, n_steps, state.u.dtype,
                 state.u.device, members=(state.u.shape[0],))


class BatchedFlows:
    """B meshes, one batched fused f32 IPCS program, on `device` (CUDA
    unless named)."""

    def __init__(self, meshes: Sequence[TriMesh], config: IPCSConfig | None = None,
                 device=None):
        config = config or IPCSConfig(precision="f32", fused=True)
        if config.precision != "f32":
            raise ValueError("batched flows require the fused f32 path")
        config = dataclasses.replace(config, fused=True)
        self.solvers = [IPCSSolver(m, config, device=device) for m in meshes]
        self.dev = stack_fused([s.dev for s in self.solvers])
        self.B = len(meshes)
        self.n_u = self.dev.F1u.shape[1]
        self.n_p = self.dev.F2p.shape[1]
        self.device = self.solvers[0].device

    def initial_state(self) -> FlowState:
        return FlowState(
            u=torch.zeros(self.B, self.n_u, dtype=torch.float32, device=self.device),
            p=torch.zeros(self.B, self.n_p, dtype=torch.float32, device=self.device),
        )

    def shard(self, mesh, axis: str = "dp"):
        """Sharding the flows over several devices is data parallelism, which
        the port does not have yet (ROADMAP Queue 1 item 3)."""
        raise NotImplementedError(
            "BatchedFlows.shard needs several devices: data parallelism is not "
            "ported yet (ROADMAP Queue 1 item 3)")

    def evolve(self, state: FlowState, n_steps: int):
        """-> (state, drags (B, n), lifts (B, n))."""
        state, (d, l) = evolve_batched_n(self.dev, state, n_steps)
        return state, d.T, l.T

    def solve(self, n_steps: int, save_steps: int | None = None):
        """From rest; the same dict as meshdqn_tpu's BatchedFlows.solve:
        state, drags and lifts (B, n_steps), the state every save_steps
        steps, and drag and lift there (numpy, (B, n_steps / save_steps))."""
        state = self.initial_state()
        save_steps = save_steps or n_steps
        if n_steps % save_steps:
            raise ValueError(f"n_steps={n_steps} is not a multiple of "
                             f"save_steps={save_steps}")
        drags, lifts, snaps = [], [], []
        for _ in range(n_steps // save_steps):
            state, d, l = self.evolve(state, save_steps)
            drags.append(d)
            lifts.append(l)
            snaps.append(state)
        drags = torch.cat(drags, dim=1)
        lifts = torch.cat(lifts, dim=1)
        return {
            "state": state,
            "drags": drags,
            "lifts": lifts,
            "snapshots": snaps,
            "snap_drags": drags.reshape(self.B, -1, save_steps)[:, :, -1].cpu().numpy(),
            "snap_lifts": lifts.reshape(self.B, -1, save_steps)[:, :, -1].cpu().numpy(),
        }

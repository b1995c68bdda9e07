"""IPCS incompressible Navier–Stokes stepper on CUDA: the fused f32 path.

Counterpart of meshdqn_tpu/solver/ipcs.py for `precision='f32'`,
`method='dense'`: Taylor–Hood P2/P1, explicit convection, Crank–Nicolson
viscosity, 3-step IPCS splitting with constant system matrices.  The systems
are assembled once on the host (fem/assembly.py), BC-eliminated, composed
into dense operators on the device (solver/fused.py) and applied every step
by the hand-written matvec kernel (ops/matvec.py).

The JAX package's other precisions ('f64', 'mixed', 'df32'), its unfused
step and its CG method are not ported yet (ROADMAP.md, Queue 1 items 4, 5
and 7); asking for them raises NotImplementedError.  `IPCSConfig` keeps
every field of the JAX config with the same defaults so configs/*.yaml load
unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..fem.assembly import apply_bc_symmetric, assemble_operators
from ..mesh import TriMesh, mark_boundaries
from ..ops.convection import ConvectionKernel
from ..probes import drag_probe, lift_probe
from .fused import FlowState, compose_fused, fused_step

__all__ = ["FlowState", "IPCSConfig", "IPCSSolver", "build_fused_operators",
           "resolve_device"]


@dataclass
class IPCSConfig:
    mu: float = 1e-3
    rho: float = 1.0
    dt: float = 1e-3
    precision: str = "f64"  # 'f64' | 'f32' | 'mixed' | 'df32'; only 'f32' is ported
    refine_iters: int = 2  # for 'mixed'
    # TPU-backend switches of the JAX solver, accepted so configs load;
    # the port composes in f64 on its own device whatever they say.
    invert_on_device: bool | None = None
    fused: bool | None = None
    compose_on_host: bool | None = None
    # 'dense' = invert-once / fused dense operators; 'cg' is not ported yet.
    method: str = "dense"
    cg_iters_u: int = 25
    cg_iters_m: int = 20
    cg_pressure_refine: int = 1
    cg_chunk: int = 0
    cg_layout: str = "banded"
    cg_banded_dtype: str = "f32"
    cg_precond: str = "jacobi"
    cg_block_size: int = 64
    # Quantize the fused systems' dof counts up to multiples of pad_quantum
    # (velocity-scalar block; pressure uses pad_quantum//4, min 32) by
    # zero-embedding + unit pad diagonal — exact: padded state entries start
    # at zero and stay zero.
    pad_quantum: int = 0


def resolve_device(device) -> torch.device:
    """The solver's device: CUDA unless the caller names another.  With no
    device named and no GPU present this raises rather than run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain torch path on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def _quantize_embed(n_old: int, n_new: int):
    """Zero-embedding E (n_new x n_old): E[i, i] = 1."""
    return sp.csr_matrix(
        (np.ones(n_old), (np.arange(n_old), np.arange(n_old))),
        shape=(n_new, n_old),
    )


def _pad_diag(n: int, start: int):
    """Unit diagonal on rows [start, n) — keeps padded systems invertible
    (inv is block-diagonal with an identity pad block; padded state entries
    start at zero and stay zero through the whole recursion)."""
    idx = np.arange(start, n)
    return sp.csr_matrix((np.ones(len(idx)), (idx, idx)), shape=(n, n))


def build_fused_operators(mesh: TriMesh, config: IPCSConfig, *, device,
                          dtype=torch.float32):
    """Assemble, BC-eliminate, optionally pad and compose the fused operators
    of `mesh` in `dtype` on `device`.

    Returns (operators, ndofs_u, ndofs_p, pad); pad is (Ns, nsq, Np, npq)
    when config.pad_quantum is set, else None.  `IPCSSolver` calls this with
    float32; the tests call it with float64 to hold the step against f64
    references."""
    cfg = config
    markers = mark_boundaries(mesh)
    ops = assemble_operators(mesh, markers, cfg.mu, cfg.rho, cfg.dt)
    A1, A2, A3 = ops.A1, ops.A2, ops.A3
    Ns = ops.V.scalar.ndofs
    A1bc = apply_bc_symmetric(A1, ops.u_bc_mask)
    A2bc = apply_bc_symmetric(A2, ops.p_bc_mask)
    # A3 = vector mass, block-diagonal with identical component blocks and
    # identical per-component BC masks -> compose with the scalar block.
    Ms = ops.M[:Ns, :Ns].tocsr()
    A3bc_s = apply_bc_symmetric(Ms, ops.u_bc_mask[:Ns])

    gu, gp = ops.u_bc_values, ops.p_bc_values
    zu = (~ops.u_bc_mask).astype(np.float64)
    zp = (~ops.p_bc_mask).astype(np.float64)
    dprobe = drag_probe(mesh, markers, cfg.mu)
    lprobe = lift_probe(mesh, markers, cfg.mu)

    R1sp = ops.R1
    P1msp = (ops.B - ops.Bn).tocsr()
    Kpsp = ops.Kp
    BTsp = ops.B.T.tocsr()
    Mssp = Ms
    Gsp = ops.G
    t1v = gu - zu * (A1 @ gu)
    t2v = gp - zp * (A2 @ gp)
    t3v = gu - zu * (A3 @ gu)
    du, dp_ = dprobe.d_u, dprobe.d_p
    lu, lp_ = lprobe.d_u, lprobe.d_p
    ndofs_u, ndofs_p = ops.V.ndofs, ops.Q.ndofs
    pad = None
    conv_ns_pad = None
    if cfg.pad_quantum:
        q = cfg.pad_quantum
        qp = max(q // 4, 32)
        npp = A2bc.shape[0]
        nsq = -(-Ns // q) * q
        nppq = -(-npp // qp) * qp
        pad = (Ns, nsq, npp, nppq)
        Es = _quantize_embed(Ns, nsq)
        Eu = sp.block_diag((Es, Es)).tocsr()
        Ep = _quantize_embed(npp, nppq)
        pad_u = sp.block_diag((_pad_diag(nsq, Ns), _pad_diag(nsq, Ns))).tocsr()
        A1bc = (Eu @ A1bc @ Eu.T + pad_u).tocsr()
        A2bc = (Ep @ A2bc @ Ep.T + _pad_diag(nppq, npp)).tocsr()
        A3bc_s = (Es @ A3bc_s @ Es.T + _pad_diag(nsq, Ns)).tocsr()
        R1sp = (Eu @ R1sp @ Eu.T).tocsr()
        P1msp = (Eu @ P1msp @ Ep.T).tocsr()
        Kpsp = (Ep @ Kpsp @ Ep.T).tocsr()
        BTsp = (Ep @ BTsp @ Eu.T).tocsr()
        Mssp = (Es @ Mssp @ Es.T).tocsr()
        Gsp = (Eu @ Gsp @ Ep.T).tocsr()
        zu, zp = Eu @ zu, Ep @ zp
        t1v, t2v, t3v = Eu @ t1v, Ep @ t2v, Eu @ t3v
        du, dp_ = Eu @ du, Ep @ dp_
        lu, lp_ = Eu @ lu, Ep @ lp_
        ndofs_u, ndofs_p = 2 * nsq, nppq
        conv_ns_pad = nsq

    dev = compose_fused(
        A1bc=A1bc, A2bc=A2bc, A3bc_s=A3bc_s, R1=R1sp, P1m=P1msp, Kp=Kpsp,
        BT=BTsp, Ms=Mssp, G=Gsp, z_u=zu, z_p=zp, t1=t1v, t2=t2v, t3=t3v,
        dt=cfg.dt, rho=cfg.rho,
        conv=ConvectionKernel.build(
            mesh, device=device, dtype=dtype, ns_pad=conv_ns_pad,
            cells_pad=256 if cfg.pad_quantum else 0,
        ),
        drag_u=du, drag_p=dp_, lift_u=lu, lift_p=lp_,
        device=device, dtype=dtype,
    )
    return dev, ndofs_u, ndofs_p, pad


class IPCSSolver:
    """Assemble-once IPCS stepper for one mesh, on `device` (CUDA unless
    named).  Only the fused f32 dense path is ported."""

    def __init__(self, mesh: TriMesh, config: IPCSConfig | None = None,
                 device=None):
        self.config = config or IPCSConfig()
        cfg = self.config
        if cfg.method != "dense":
            raise NotImplementedError(
                f"method={cfg.method!r} is not ported yet: the large-mesh CG "
                "path is ROADMAP.md Queue 1 item 7"
            )
        if cfg.precision != "f32":
            raise NotImplementedError(
                f"precision={cfg.precision!r} is not ported yet: 'f64' and "
                "'mixed' are ROADMAP.md Queue 1 item 4, 'df32' item 5; only "
                "the fused 'f32' path runs"
            )
        if cfg.fused is False:
            raise NotImplementedError(
                "fused=False (the unfused step) is not ported yet: ROADMAP.md "
                "Queue 1 item 4"
            )
        self.device = resolve_device(device)
        self.mesh = mesh
        self.work_dtype = torch.float32
        self.dev, self.ndofs_u, self.ndofs_p, self._pad = build_fused_operators(
            mesh, cfg, device=self.device, dtype=self.work_dtype
        )

    def unpad_u(self, u):
        """Strip pad_quantum padding from a velocity dof vector."""
        if self._pad is None:
            return u
        ns, nsq, _, _ = self._pad
        return torch.cat([u[:ns], u[nsq : nsq + ns]])

    def unpad_p(self, p):
        if self._pad is None:
            return p
        return p[: self._pad[2]]

    def initial_state(self) -> FlowState:
        """Zero initial condition (flow_solver.py:92-93 of the reference)."""
        return FlowState(
            u=torch.zeros(self.ndofs_u, dtype=self.work_dtype, device=self.device),
            p=torch.zeros(self.ndofs_p, dtype=self.work_dtype, device=self.device),
        )

    def evolve(self, state: FlowState, n_steps: int = 1):
        """Advance n_steps; returns (state, drags (n,), lifts (n,)).

        A plain Python loop of fused steps that never waits for the device:
        drag and lift land in preallocated device tensors."""
        drags = torch.empty(n_steps, dtype=self.work_dtype, device=self.device)
        lifts = torch.empty_like(drags)
        for i in range(n_steps):
            state, (d, l) = fused_step(self.dev, state)
            drags[i] = d
            lifts[i] = l
        return state, drags, lifts

    def solve(
        self,
        n_steps: int,
        save_steps: int | None = None,
        state: FlowState | None = None,
    ):
        """Run the full transient solve.

        Mirrors the reference's ground-truth loop (Env2DAirfoil.py:111-125):
        every `save_steps` steps, snapshot (u, p, drag, lift) — drag/lift
        sampled from the state just computed."""
        if state is None:
            state = self.initial_state()
        if save_steps is None:
            save_steps = n_steps
        if n_steps % save_steps:
            raise ValueError(f"n_steps={n_steps} is not a multiple of save_steps={save_steps}")
        drags, lifts, snaps = [], [], []
        for _ in range(n_steps // save_steps):
            state, d, l = self.evolve(state, save_steps)
            drags.append(d)
            lifts.append(l)
            snaps.append(state)
        drags = torch.cat(drags)
        lifts = torch.cat(lifts)
        return {
            "state": state,
            "drags": drags,
            "lifts": lifts,
            "snapshots": snaps,
            "snap_drags": drags.view(-1, save_steps)[:, -1].cpu().numpy(),
            "snap_lifts": lifts.view(-1, save_steps)[:, -1].cpu().numpy(),
        }

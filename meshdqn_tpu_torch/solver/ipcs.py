"""IPCS incompressible Navier–Stokes stepper on CUDA.

Counterpart of meshdqn_tpu/solver/ipcs.py: Taylor–Hood P2/P1, explicit
convection, Crank–Nicolson viscosity, 3-step IPCS splitting with constant
system matrices, assembled once on the host (fem/assembly.py) and
BC-eliminated.  The JAX package's methods and precisions, routed as there:

* method='dense', fused (the default for 'f32' and 'df32'): the systems are
  composed into dense operators on the device (solver/fused.py) and applied
  every step by the hand-written matvec kernel (ops/matvec.py), its grouped
  form in 'f32', its split form (f32 high and bf16 low limbs) in 'df32'.
* method='dense', unfused (the default for 'f64' and 'mixed'; fused=False
  for 'f32'): `ipcs_step`, three dense inverses built once in f64 on the
  device and every other linear piece a sparse product through the ELL
  kernel (ops/sparse.py).  'f64' works in f64; 'f32' in f32, its inverses
  applied by the matvec kernel; 'mixed' keeps the velocity path in f32 and
  the pressure path in f64 with iterative refinement.
* method='cg', precision 'f32' or 'f64': the large-mesh path.  The velocity
  systems stay sparse and are solved by warm-started fixed-iteration PCG
  (ops/cg.py); only the small pressure system keeps a dense inverse.  Its
  operators are banded blocks in an RCM order (cg_layout='banded', the
  hand-written kernel of ops/banded.py) or padded rows (cg_layout='ell',
  the hand-written kernel of ops/sparse.py).

Configurations the JAX package refuses raise here when the solver is made:
fused=True with 'f64' or 'mixed', as there, and 'df32' with fused=False,
whose unfused step the JAX package cannot run (below).  `IPCSConfig` keeps
every field of the JAX config with the same defaults so configs/*.yaml
load unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Union

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import torch

from ..fem.assembly import apply_bc_symmetric, assemble_operators
from ..mesh import TriMesh, mark_boundaries
from ..ops.banded import BandedMatrix, permute_interleave_u, rcm_permutation
from ..ops.cg import BlockJacobi, block_jacobi_inv, jacobi_inv, pcg
from ..ops.convection import ConvectionKernel
from ..ops.sparse import EllMatrix
from ..ops.matvec import matvec
from ..probes import drag_probe, lift_probe
from ..utils.profiling import count, span, tracing
from .fused import FlowState, _dense64, compose_fused, fused_step, fused_step_df32

__all__ = ["BandedCGOperators", "CGOperators", "CGStepGraph", "DeviceOperators",
           "FlowState", "IPCSConfig", "IPCSSolver", "build_cg_operators",
           "build_device_operators", "build_fused_operators", "cg_matrices",
           "evolve_cg_n", "evolve_fused_df32_n",
           "evolve_fused_n", "evolve_n", "ipcs_step", "ipcs_step_cg",
           "ipcs_step_cg_banded", "resolve_device"]

PRECISIONS = ("f64", "f32", "mixed", "df32")


@dataclass
class IPCSConfig:
    mu: float = 1e-3
    rho: float = 1.0
    dt: float = 1e-3
    # 'f64' | 'f32' | 'mixed' | 'df32' with method='dense'; 'f32' | 'f64'
    # with method='cg'.
    precision: str = "f64"
    refine_iters: int = 2  # for 'mixed'
    # TPU-backend switches of the JAX solver, accepted so configs load;
    # the port composes and inverts in f64 on its own device whatever they
    # say.
    invert_on_device: bool | None = None
    # The fused dense step (solver/fused.py); None: on for 'f32' and 'df32'.
    fused: bool | None = None
    compose_on_host: bool | None = None
    # 'dense' = invert-once / fused dense operators; 'cg' = the large-mesh
    # path: sparse velocity systems solved by warm-started PCG, a dense
    # inverse only for the pressure Poisson system.
    method: str = "dense"
    cg_iters_u: int = 25  # PCG iterations, tentative-velocity system
    cg_iters_m: int = 20  # PCG iterations, scalar-mass correction system
    cg_pressure_refine: int = 1  # dense-inverse refinement passes
    # The JAX package splits evolve() into programs of at most cg_chunk
    # steps (a TPU worker crashed on long scans).  The port's steps are a
    # Python loop with no program length to bound: accepted, no effect.
    cg_chunk: int = 0
    # 'banded': RCM banded blocks (ops/banded.py), the production layout;
    # 'ell': padded rows (ops/sparse.py), also taken when the RCM bandwidth
    # is too large for banded blocks.
    cg_layout: str = "banded"
    # Storage of the banded operators: 'f32' or 'bf16' (f32 accumulation;
    # needs precision='f32').
    cg_banded_dtype: str = "f32"
    # 'jacobi' (pointwise diagonal) or 'block' (ops/cg.BlockJacobi, dense
    # inverses of cg_block_size diagonal blocks in the RCM order).
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


def assemble(mesh: TriMesh, config: IPCSConfig):
    """(markers, operators): the mesh's boundary markers and its assembled
    FEM operators (fem/assembly.py), which every method builds from."""
    markers = mark_boundaries(mesh)
    return markers, assemble_operators(mesh, markers, config.mu, config.rho, config.dt)


def build_fused_operators(mesh: TriMesh, config: IPCSConfig, *, device,
                          dtype=torch.float32, split=False, assembled=None):
    """Assemble, BC-eliminate, optionally pad and compose the fused operators
    of `mesh` in `dtype` on `device`.

    Returns (operators, ndofs_u, ndofs_p, pad); pad is (Ns, nsq, Np, npq)
    when config.pad_quantum is set, else None.  With `split`, operators is
    the pair (FusedOperators, SplitLow) of the 'df32' step.  `IPCSSolver`
    calls this with float32; the tests call it with float64 to hold the step
    against f64 references.  `assembled` is `assemble(mesh, config)` where
    the caller has it."""
    cfg = config
    markers, ops = assembled or assemble(mesh, cfg)
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
        device=device, dtype=dtype, split=split,
    )
    return dev, ndofs_u, ndofs_p, pad



# --------------------------------------------------------------------------
# The unfused dense step (meshdqn_tpu/solver/ipcs.py:304): dense inverses of
# the three systems and sparse products for every other linear piece.
# --------------------------------------------------------------------------


class DeviceOperators(NamedTuple):
    """The unfused step's operators (meshdqn_tpu/solver/ipcs.py
    DeviceOperators).  A3 is block-diagonal over the two components with
    identical blocks, so only the scalar mass inverse (Ns x Ns) is stored
    and applied to both as one (Ns, 2) product.  A1bc and A3bc are always
    None, A2bc is set in 'mixed' only (its refinement residuals), as in the
    JAX package."""

    A1inv: torch.Tensor  # (2Ns, 2Ns)
    A2inv: torch.Tensor  # (Np, Np)
    A3inv_s: torch.Tensor  # (Ns, Ns) scalar-mass inverse
    A1bc: EllMatrix | None
    A2bc: EllMatrix | None
    A3bc: EllMatrix | None
    R1: EllMatrix
    P1m: EllMatrix  # B - Bn
    Kp: EllMatrix
    BT: EllMatrix
    M: EllMatrix
    G: EllMatrix
    z_u: torch.Tensor
    z_p: torch.Tensor
    t1: torch.Tensor
    t2: torch.Tensor
    t3: torch.Tensor
    conv: ConvectionKernel
    drag_u: torch.Tensor
    drag_p: torch.Tensor
    lift_u: torch.Tensor
    lift_p: torch.Tensor
    rho: torch.Tensor  # 0-d
    dt: torch.Tensor  # 0-d


def precision_dtypes(precision: str):
    """(work, pressure, inverse) dtypes of the unfused step, as the JAX
    package sets them (solver/ipcs.py:497-504): the velocity path works in
    f64 only for 'f64', the pressure path in f64 for 'f64' and 'mixed', the
    inverses are f32 for 'mixed' and 'f32'."""
    f32, f64 = torch.float32, torch.float64
    wdt = f64 if precision == "f64" else f32
    pdt = f64 if precision in ("f64", "mixed") else f32
    idt = f32 if precision in ("mixed", "f32") else f64
    return wdt, pdt, idt


def build_device_operators(mesh: TriMesh, config: IPCSConfig, *, device,
                           assembled=None) -> DeviceOperators:
    """The unfused step's operators of `mesh` on `device`, in the dtypes of
    config.precision.  The three inverses are built in f64 on the device
    (Hopper has native f64; the JAX package's on-device f32 inverse and its
    row limit are TPU workarounds) and cast; sparse operators and vectors
    are rounded to their dtype on the host, as the JAX package rounds them.
    `assembled` is `assemble(mesh, config)` where the caller has it."""
    cfg = config
    markers, ops = assembled or assemble(mesh, cfg)
    wdt, pdt, idt = precision_dtypes(cfg.precision)
    Ns = ops.V.scalar.ndofs
    A1bc = apply_bc_symmetric(ops.A1, ops.u_bc_mask)
    A2bc = apply_bc_symmetric(ops.A2, ops.p_bc_mask)
    Ms = ops.M[:Ns, :Ns].tocsr()
    A3bc_s = apply_bc_symmetric(Ms, ops.u_bc_mask[:Ns])
    gu, gp = ops.u_bc_values, ops.p_bc_values
    zu = (~ops.u_bc_mask).astype(np.float64)
    zp = (~ops.p_bc_mask).astype(np.float64)
    dprobe = drag_probe(mesh, markers, cfg.mu)
    lprobe = lift_probe(mesh, markers, cfg.mu)
    np_of = {torch.float32: np.float32, torch.float64: np.float64}
    vec = lambda a, dt: torch.tensor(np.asarray(a, dtype=np.float64).astype(np_of[dt]),
                                     device=device)
    ell = lambda A, dt: EllMatrix.from_scipy(A, device=device, dtype=dt)
    inv = lambda A: torch.linalg.inv(_dense64(A, device)).to(idt).contiguous()
    return DeviceOperators(
        A1inv=inv(A1bc),
        A2inv=inv(A2bc),
        A3inv_s=inv(A3bc_s),
        A1bc=None,
        A2bc=ell(A2bc, pdt) if cfg.precision == "mixed" else None,
        A3bc=None,
        R1=ell(ops.R1, wdt),
        P1m=ell(ops.B - ops.Bn, wdt),
        Kp=ell(ops.Kp, pdt),
        BT=ell(ops.B.T.tocsr(), pdt),
        M=ell(ops.M, wdt),
        G=ell(ops.G, wdt),
        z_u=vec(zu, wdt),
        z_p=vec(zp, pdt),
        t1=vec(gu - zu * (ops.A1 @ gu), wdt),
        t2=vec(gp - zp * (ops.A2 @ gp), pdt),
        t3=vec(gu - zu * (ops.A3 @ gu), wdt),
        conv=ConvectionKernel.build(mesh, device=device, dtype=wdt),
        drag_u=vec(dprobe.d_u, wdt),
        drag_p=vec(dprobe.d_p, pdt),
        lift_u=vec(lprobe.d_u, wdt),
        lift_p=vec(lprobe.d_p, pdt),
        rho=torch.tensor(cfg.rho, dtype=wdt, device=device),
        dt=torch.tensor(cfg.dt, dtype=wdt, device=device),
    )


def _inverse_apply(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A dense inverse applied: the matvec kernel in f32 (its plain version
    on the CPU); torch.matmul in f64, which the f32-only kernel does not
    take (the JAX package leaves this product to XLA)."""
    return matvec(m, x) if m.dtype == torch.float32 else m @ x


def ipcs_step(dev: DeviceOperators, state: FlowState, precision: str,
              refine_iters: int):
    """One IPCS step with dense inverses and sparse products
    (meshdqn_tpu/solver/ipcs.py:ipcs_step); returns (new_state, (drag,
    lift)).

    In 'mixed' the state is (u: f32, p: f64): every 2Ns-sized operator runs
    in f32, the Np-sized pressure system in f64, and the step-3 pressure
    difference is formed in f64 before the cast down.  The casts sit where
    the JAX step has them."""
    u_n, p_n = state
    wdt, pdt = dev.t1.dtype, dev.t2.dtype
    c = dev.conv(u_n)
    p_n_w = p_n.to(wdt)
    # Step 1: tentative velocity.
    b1 = (dev.R1 @ u_n) + (dev.P1m @ p_n_w) - dev.rho * c
    b1 = b1 * dev.z_u + dev.t1
    u_star = _inverse_apply(dev.A1inv, b1)
    # Step 2: pressure correction (f64 in 'mixed').
    u_star_p = u_star.to(pdt)
    b2 = (dev.Kp @ p_n) - (dev.BT @ u_star_p) / dev.dt.to(pdt)
    b2 = b2 * dev.z_p + dev.t2
    p_new = _inverse_apply(dev.A2inv, b2.to(dev.A2inv.dtype)).to(pdt)
    if precision == "mixed":
        for _ in range(refine_iters):
            r = b2 - (dev.A2bc @ p_new)
            p_new = p_new + _inverse_apply(dev.A2inv, r.to(dev.A2inv.dtype)).to(pdt)
    # Step 3: velocity correction; the pressure difference is formed at the
    # pressure's precision, cast after the subtraction.
    dp = (p_new - p_n).to(wdt)
    b3 = (dev.M @ u_star) - dev.dt * (dev.G @ dp)
    b3 = b3 * dev.z_u + dev.t3
    ns = dev.A3inv_s.shape[0]
    y = _inverse_apply(dev.A3inv_s, torch.stack([b3[:ns], b3[ns:]], dim=1))  # (Ns, 2)
    u_new = torch.cat([y[:, 0], y[:, 1]])

    drag = dev.drag_u @ u_new + dev.drag_p @ p_new
    lift = dev.lift_u @ u_new + dev.lift_p @ p_new
    return FlowState(u=u_new, p=p_new), (drag, lift)


def _loop(step, state, n_steps: int, dtype, device, members: tuple = ()):
    """n_steps of step(state) -> (state, (drag, lift)); drag and lift land in
    preallocated device tensors (n_steps, *members), so the loop never waits
    for the device.  Counts its steps as `steps` while tracing is on."""
    drags = torch.empty((n_steps, *members), dtype=dtype, device=device)
    lifts = torch.empty_like(drags)
    for i in range(n_steps):
        state, (drags[i], lifts[i]) = step(state)
    count("steps", n_steps)
    return state, (drags, lifts)


def evolve_n(dev: DeviceOperators, state: FlowState, n_steps: int, precision: str,
             refine_iters: int):
    """n_steps unfused steps; returns (state, (drags, lifts)), drag and lift
    in the wider of the two paths' dtypes (f64 in 'mixed')."""
    return _loop(lambda s: ipcs_step(dev, s, precision, refine_iters), state, n_steps,
                 torch.promote_types(dev.t1.dtype, dev.t2.dtype), dev.t1.device)


def evolve_fused_n(dev, state: FlowState, n_steps: int):
    """n_steps fused steps; returns (state, (drags, lifts))."""
    return _loop(lambda s: fused_step(dev, s), state, n_steps, dev.k1.dtype,
                 dev.k1.device)


def evolve_fused_df32_n(dev, lo, state: FlowState, n_steps: int):
    """n_steps 'df32' steps (split operators); returns (state, (drags,
    lifts))."""
    return _loop(lambda s: fused_step_df32(dev, lo, s), state, n_steps, dev.k1.dtype,
                 dev.k1.device)



Precond = Union[torch.Tensor, BlockJacobi]


class CGOperators(NamedTuple):
    """Operators of the CG step in the ELL layout (cg_layout='ell'): every
    sparse product goes through ops.sparse.ell_matmat."""

    A1bc: EllMatrix
    d1inv: Precond  # Jacobi diagonal (2Ns,) or BlockJacobi of A1bc
    A2inv: torch.Tensor  # (Np, Np) dense pressure inverse
    A2bc: EllMatrix  # pressure system, for refinement residuals
    A3bc_s: EllMatrix  # (Ns, Ns) scalar mass system
    d3inv: Precond
    R1: EllMatrix
    P1m: EllMatrix
    Kp: EllMatrix
    BT: EllMatrix
    M: EllMatrix
    G: EllMatrix
    z_u: torch.Tensor
    z_p: torch.Tensor
    t1: torch.Tensor
    t2: torch.Tensor
    t3: torch.Tensor
    conv: ConvectionKernel
    drag_u: torch.Tensor
    drag_p: torch.Tensor
    lift_u: torch.Tensor
    lift_p: torch.Tensor
    rho: torch.Tensor  # 0-d
    dt: torch.Tensor  # 0-d


def ipcs_step_cg(dev: CGOperators, state: FlowState, u_star_prev: torch.Tensor,
                 iters_u: int, iters_m: int, p_refine: int):
    """One IPCS step with PCG velocity solves warm-started from the previous
    step; returns (new_state, u_star, (drag, lift)).

    With tracing on (utils.profiling) each phase is a span, named as the
    fused step's: step.convection; step.ustar (b1 and the A1 PCG);
    step.pressure (b2, the dense inverse and its refinement); step.velocity
    (b3 and the mass PCG); step.probes."""
    u_n, p_n = state
    ns = dev.A3bc_s.shape[0]
    tr = tracing()
    if tr:
        tr.begin("step.convection")
    c = dev.conv(u_n)
    if tr:
        tr.next("step.ustar")
    # Step 1: tentative velocity.
    b1 = (dev.R1 @ u_n) + (dev.P1m @ p_n) - dev.rho * c
    b1 = b1 * dev.z_u + dev.t1
    u_star = pcg(dev.A1bc, dev.d1inv, b1[:, None], u_star_prev[:, None],
                 iters_u)[:, 0]
    if tr:
        tr.next("step.pressure")
    # Step 2: pressure correction, dense inverse plus refinement.
    b2 = (dev.Kp @ p_n) - (dev.BT @ u_star) / dev.dt
    b2 = b2 * dev.z_p + dev.t2
    p_new = dev.A2inv @ b2
    for _ in range(p_refine):
        p_new = p_new + dev.A2inv @ (b2 - dev.A2bc @ p_new)
    if tr:
        tr.next("step.velocity")
    # Step 3: velocity correction, both components as one two-column PCG.
    dp = p_new - p_n
    b3 = (dev.M @ u_star) - dev.dt * (dev.G @ dp)
    b3 = b3 * dev.z_u + dev.t3
    B3 = torch.stack([b3[:ns], b3[ns:]], dim=1)
    X0 = torch.stack([u_star[:ns], u_star[ns:]], dim=1)
    Y = pcg(dev.A3bc_s, dev.d3inv, B3, X0, iters_m)
    u_new = torch.cat([Y[:, 0], Y[:, 1]])
    if tr:
        tr.next("step.probes")
    drag = dev.drag_u @ u_new + dev.drag_p @ p_new
    lift = dev.lift_u @ u_new + dev.lift_p @ p_new
    if tr:
        tr.end()
    return FlowState(u=u_new, p=p_new), u_star, (drag, lift)


class BandedCGOperators(NamedTuple):
    """Operators of the CG step in the banded layout (cg_layout='banded').

    Velocity dofs live component-interleaved in scalar-RCM order
    (u[2j+c] = component c at scalar-RCM node j), so every velocity-row
    operator is banded and the component split of step 3 is a free (Ns, 2)
    view.  Pressure stays in the original vertex order (A2inv, A2bc and Kp,
    ELL); it enters the scalar order at `vert_pos`."""

    A1bc: BandedMatrix  # (2Ns, 2Ns) interleaved
    d1inv: Precond
    A2inv: torch.Tensor  # (Np, Np) dense, original pressure order
    A2bc: EllMatrix
    A3bc_s: BandedMatrix  # (Ns, Ns) scalar-RCM
    d3inv: Precond
    R1: BandedMatrix  # (2Ns, 2Ns)
    P1m_s: BandedMatrix  # (2Ns, Ns): takes pressure at scalar positions
    Kp: EllMatrix  # (Np, Np)
    BT_s: BandedMatrix  # (Ns, 2Ns): rows at the vertices' scalar positions
    Ms: BandedMatrix  # (Ns, Ns) unconstrained scalar mass (two columns)
    G_s: BandedMatrix  # (2Ns, Ns)
    vert_pos: torch.Tensor  # (Np,) int64 scalar-RCM position of vertex v
    z_u: torch.Tensor
    z_p: torch.Tensor
    t1: torch.Tensor
    t2: torch.Tensor
    t3: torch.Tensor
    conv: ConvectionKernel  # built with the interleaved dof map
    drag_u: torch.Tensor
    drag_p: torch.Tensor
    lift_u: torch.Tensor
    lift_p: torch.Tensor
    rho: torch.Tensor
    dt: torch.Tensor


def _at_vertices(dev: BandedCGOperators, p: torch.Tensor) -> torch.Tensor:
    """p (original vertex order) written into a zero scalar-RCM vector at
    `vert_pos`: each index once, so the write is deterministic."""
    ns = dev.A3bc_s.shape[0]
    return p.new_zeros(ns).index_copy_(0, dev.vert_pos, p)


def ipcs_step_cg_banded(dev: BandedCGOperators, state: FlowState,
                        u_star_prev: torch.Tensor, iters_u: int, iters_m: int,
                        p_refine: int):
    """ipcs_step_cg in the banded layout: 18 banded products a step at the
    production iteration counts (6, 5), and 1 + p_refine ELL products.
    Its phases are spans while tracing is on, as ipcs_step_cg's."""
    u_n, p_n = state
    ns = dev.A3bc_s.shape[0]
    tr = tracing()
    if tr:
        tr.begin("step.convection")
    c = dev.conv(u_n)
    if tr:
        tr.next("step.ustar")
    # Step 1: tentative velocity.
    b1 = (dev.R1 @ u_n) + (dev.P1m_s @ _at_vertices(dev, p_n)) - dev.rho * c
    b1 = b1 * dev.z_u + dev.t1
    u_star = pcg(dev.A1bc, dev.d1inv, b1[:, None], u_star_prev[:, None],
                 iters_u)[:, 0]
    if tr:
        tr.next("step.pressure")
    # Step 2: pressure correction; B^T u* is read off at the vertices.
    bt = (dev.BT_s @ u_star)[dev.vert_pos]
    b2 = (dev.Kp @ p_n) - bt / dev.dt
    b2 = b2 * dev.z_p + dev.t2
    p_new = dev.A2inv @ b2
    for _ in range(p_refine):
        p_new = p_new + dev.A2inv @ (b2 - dev.A2bc @ p_new)
    if tr:
        tr.next("step.velocity")
    # Step 3: velocity correction, two-column scalar mass solves.
    V = u_star.view(ns, 2)
    b3 = dev.Ms.matmat(V).view(-1) - dev.dt * (dev.G_s @ _at_vertices(dev, p_new - p_n))
    b3 = b3 * dev.z_u + dev.t3
    Y = pcg(dev.A3bc_s, dev.d3inv, b3.view(ns, 2), V, iters_m)
    u_new = Y.view(-1)
    if tr:
        tr.next("step.probes")
    drag = dev.drag_u @ u_new + dev.drag_p @ p_new
    lift = dev.lift_u @ u_new + dev.lift_p @ p_new
    if tr:
        tr.end()
    return FlowState(u=u_new, p=p_new), u_star, (drag, lift)


def _launch_counters():
    """The kernels' launch counters that a CG step can move, as (function,
    attribute) pairs."""
    from ..ops.banded import banded_matmat
    from ..ops.cg import pcg_update
    from ..ops.convection import convection_vector
    from ..ops.sparse import ell_matmat

    return [(banded_matmat, "launches"), (banded_matmat, "bf16_launches"),
            (ell_matmat, "launches"), (convection_vector, "launches"),
            (pcg_update, "launches")]


class CGStepGraph:
    """One CG step of either layout, captured once as a CUDA graph.

    The Python step issues ~350 kernels one host call at a time, so the
    host, not the card, sets its pace.  Replaying the graph issues the same
    kernels in the same order on the same shapes in one call: the bits are
    the Python step's.  The graph reads the state from static buffers and
    writes the new state back into them, and drag and lift into `probes`.
    The launch counters move on each replay by what one step launches, as
    the Python step moves them."""

    def __init__(self, dev, state: FlowState, ustar: torch.Tensor, iters: tuple):
        self.dev, self.iters = dev, iters
        self.step = (ipcs_step_cg_banded if isinstance(dev, BandedCGOperators)
                     else ipcs_step_cg)
        self.u, self.p, self.ustar = state.u.clone(), state.p.clone(), ustar.clone()
        self.probes = ustar.new_empty(2)
        counters = _launch_counters()
        before = [getattr(f, a) for f, a in counters]
        # A first run on the capture's stream makes every lazy allocation
        # (cuBLAS's workspace, the kernels' cached tables) before capture.
        # It moves the buffers, which `run` overwrites.
        side = torch.cuda.Stream(ustar.device)
        side.wait_stream(torch.cuda.current_stream(ustar.device))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(ustar.device).wait_stream(side)
        mid = [getattr(f, a) for f, a in counters]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side):
            self._body()
        self.per_step = [(f, a, getattr(f, a) - m) for (f, a), m in zip(counters, mid)]
        for (f, a), b in zip(counters, before):
            setattr(f, a, b)

    def _body(self):
        state, ustar, (drag, lift) = self.step(
            self.dev, FlowState(u=self.u, p=self.p), self.ustar, *self.iters)
        self.u.copy_(state.u)
        self.p.copy_(state.p)
        self.ustar.copy_(ustar)
        torch.stack([drag, lift], out=self.probes)

    def run(self, state: FlowState, ustar: torch.Tensor, n_steps: int):
        """evolve_cg_n's n_steps by replaying the graph."""
        self.u.copy_(state.u)
        self.p.copy_(state.p)
        self.ustar.copy_(ustar)
        probes = self.probes.new_empty(2, n_steps)
        for i in range(n_steps):
            self.graph.replay()
            probes[:, i].copy_(self.probes)
        for f, a, n in self.per_step:
            setattr(f, a, getattr(f, a) + n * n_steps)
        return (FlowState(u=self.u.clone(), p=self.p.clone()), self.ustar.clone(),
                (probes[0], probes[1]))


def evolve_cg_n(dev, state: FlowState, u_star0: torch.Tensor, n_steps: int,
                iters_u: int, iters_m: int, p_refine: int, graphs: dict | None = None):
    """n_steps CG steps of either layout; returns (state, u_star,
    (drags, lifts)), drag and lift in preallocated device tensors, so the
    loop never waits for the device.  Counts its steps as `steps` while
    tracing is on, as `_loop` does.

    On the card with tracing off and a `graphs` dict (the solver's own),
    the steps are replays of a CGStepGraph kept in it; while tracing, the
    Python step runs, so that its phases are spans."""
    iters = (iters_u, iters_m, p_refine)
    if graphs is not None and u_star0.is_cuda and n_steps and not tracing():
        if iters not in graphs:
            graphs[iters] = CGStepGraph(dev, state, u_star0, iters)
        return graphs[iters].run(state, u_star0, n_steps)
    step = ipcs_step_cg_banded if isinstance(dev, BandedCGOperators) else ipcs_step_cg
    drags = torch.empty(n_steps, dtype=dev.t1.dtype, device=dev.t1.device)
    lifts = torch.empty_like(drags)
    ustar = u_star0
    for i in range(n_steps):
        state, ustar, (drags[i], lifts[i]) = step(dev, state, ustar, *iters)
    count("steps", n_steps)
    return state, ustar, (drags, lifts)


def cg_matrices(mesh: TriMesh, config: IPCSConfig, assembled=None) -> dict:
    """The host side of the CG step's operators, as meshdqn_tpu's
    IPCSSolver builds them (solver/ipcs.py:519-573 and :740-828):

    * layout: 'banded', or 'ell' when asked for or when the RCM bandwidth is
      too large for dense blocks (the JAX package's own rule);
    * matrices: scipy CSR by operator field, in the layout's dof order;
    * vectors: f64 arrays by field (z_u, z_p, t1, t2, t3 and the probes);
    * A2inv: the pressure inverse, from host f64 LAPACK;
    * vert_pos, o2n_u: the vertices' scalar-RCM positions and the velocity
      old->new map (banded layout only).

    `assembled` is `assemble(mesh, config)` where the caller has it."""
    cfg = config
    markers, ops = assembled or assemble(mesh, cfg)
    Ns = ops.V.scalar.ndofs
    Ms = ops.M[:Ns, :Ns].tocsr()
    A1bc = apply_bc_symmetric(ops.A1, ops.u_bc_mask)
    A2bc = apply_bc_symmetric(ops.A2, ops.p_bc_mask)
    A3bc_s = apply_bc_symmetric(Ms, ops.u_bc_mask[:Ns])
    dprobe = drag_probe(mesh, markers, cfg.mu)
    lprobe = lift_probe(mesh, markers, cfg.mu)
    gu, gp = ops.u_bc_values, ops.p_bc_values
    zu = (~ops.u_bc_mask).astype(np.float64)
    zp = (~ops.p_bc_mask).astype(np.float64)
    vectors = dict(
        z_u=zu, z_p=zp, t1=gu - zu * (ops.A1 @ gu), t2=gp - zp * (ops.A2 @ gp),
        t3=gu - zu * (ops.A3 @ gu), drag_u=dprobe.d_u, drag_p=dprobe.d_p,
        lift_u=lprobe.d_u, lift_p=lprobe.d_p,
    )
    out = dict(layout="ell", A2inv=scipy.linalg.inv(A2bc.toarray()), vectors=vectors)
    if cfg.cg_layout == "banded":
        Np = A2bc.shape[0]
        perm_s = rcm_permutation(Ms)
        rank_s = np.empty(Ns, dtype=np.int64)
        rank_s[perm_s] = np.arange(Ns)
        n2o_u = permute_interleave_u(Ns, rank_s)
        o2n_u = np.empty_like(n2o_u)
        o2n_u[n2o_u] = np.arange(2 * Ns)
        A1p = A1bc.tocsr()[n2o_u][:, n2o_u].tocoo()
        span = int(np.abs(A1p.row - A1p.col).max())
        # Bandwidth guard: blocks are (n, ~2 span); past ~n/4 the dense band
        # stores too many zeros to pay off.
        if 2 * span <= max(512, A1p.shape[0] // 4):
            vert_pos = rank_s[:Np]
            # Injection of the pressure dofs (vertices) into their
            # scalar-RCM positions: S[v, rank_s[v]] = 1.
            S = sp.csr_matrix((np.ones(Np), (np.arange(Np), vert_pos)),
                              shape=(Np, Ns))
            perm = lambda A: A.tocsr()[perm_s][:, perm_s].tocsr()
            out.update(layout="banded", vert_pos=vert_pos, o2n_u=o2n_u, matrices=dict(
                A1bc=A1p.tocsr(),
                A2bc=A2bc,
                A3bc_s=perm(A3bc_s),
                R1=ops.R1.tocsr()[n2o_u][:, n2o_u].tocsr(),
                P1m_s=((ops.B - ops.Bn).tocsr()[n2o_u] @ S).tocsr(),
                Kp=ops.Kp,
                BT_s=(S.T @ ops.B.T.tocsr())[:, n2o_u].tocsr(),
                Ms=perm(Ms),
                G_s=(ops.G.tocsr()[n2o_u] @ S).tocsr(),
            ))
            for name in ("z_u", "t1", "t3", "drag_u", "lift_u"):
                vectors[name] = vectors[name][n2o_u]
            return out
    out["matrices"] = dict(
        A1bc=A1bc, A2bc=A2bc, A3bc_s=A3bc_s, R1=ops.R1, P1m=(ops.B - ops.Bn).tocsr(),
        Kp=ops.Kp, BT=ops.B.T.tocsr(), M=ops.M, G=ops.G,
    )
    return out


def build_cg_operators(mesh: TriMesh, config: IPCSConfig, *, device, dtype,
                       assembled=None):
    """The CG step's operators of `mesh` in `dtype` on `device` (see
    `cg_matrices`).  Returns (operators, export index): the export index
    maps the banded layout's velocity vector to [ux; uy], and is None for
    the ELL layout.  Everything is rounded to `dtype` on the host, as the
    JAX package rounds it; banded operators take bf16 storage with
    cg_banded_dtype='bf16'."""
    cfg = config
    host = cg_matrices(mesh, cfg, assembled)
    mats = host["matrices"]
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    vec = lambda a: torch.tensor(np.asarray(a, dtype=np.float64).astype(np_dtype),
                                 device=device)
    scalar = lambda x: torch.tensor(x, dtype=dtype, device=device)
    ell = lambda A: EllMatrix.from_scipy(A, device=device, dtype=dtype)

    def precond(A, A_ell=None):
        if cfg.cg_precond == "block":
            return block_jacobi_inv(A, cfg.cg_block_size, device=device, dtype=dtype)
        if A_ell is not None:  # JAX takes the ELL layout's diagonal
            return jacobi_inv(A_ell)
        d = A.diagonal()
        return vec(np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 1.0))

    common = dict(
        A2inv=vec(host["A2inv"]),
        A2bc=ell(mats["A2bc"]),
        Kp=ell(mats["Kp"]),
        **{name: vec(v) for name, v in host["vectors"].items()},
        rho=scalar(cfg.rho),
        dt=scalar(cfg.dt),
    )
    if host["layout"] == "banded":
        bdt = torch.bfloat16 if cfg.cg_banded_dtype == "bf16" else dtype
        band = lambda name: BandedMatrix.from_scipy(mats[name], device=device, dtype=bdt)
        o2n_u = host["o2n_u"]
        dev = BandedCGOperators(
            **{name: band(name) for name in ("A1bc", "A3bc_s", "R1", "P1m_s", "BT_s",
                                             "Ms", "G_s")},
            d1inv=precond(mats["A1bc"]),
            d3inv=precond(mats["A3bc_s"]),
            vert_pos=torch.tensor(host["vert_pos"], device=device),
            conv=ConvectionKernel.build(mesh, device=device, dtype=dtype,
                                        dof_perm=o2n_u),
            **common,
        )
        return dev, torch.tensor(o2n_u, device=device)
    A1ell, A3ell = ell(mats["A1bc"]), ell(mats["A3bc_s"])
    dev = CGOperators(
        A1bc=A1ell,
        A3bc_s=A3ell,
        **{name: ell(mats[name]) for name in ("R1", "P1m", "BT", "M", "G")},
        d1inv=precond(mats["A1bc"], A1ell),
        d3inv=precond(mats["A3bc_s"], A3ell),
        conv=ConvectionKernel.build(mesh, device=device, dtype=dtype),
        **common,
    )
    return dev, None


class IPCSSolver:
    """Assemble-once IPCS stepper for one mesh, on `device` (CUDA unless
    named), routed by method, precision and `fused` as the JAX package
    routes them (solver/ipcs.py:497-504, 575-583, 684-690, 890-902).

    Besides the solver's state it exposes what the environment reads, as the
    JAX solver does: `markers`, `operators` (the assembled FEM operators),
    the `drag` and `lift` probes, `removable` (the vertices off the
    boundary), `fused`, `dev_lo` (the 'df32' low limbs, else None),
    `work_dtype` and `pressure_dtype`."""

    def __init__(self, mesh: TriMesh, config: IPCSConfig | None = None,
                 device=None):
        self.config = config or IPCSConfig()
        cfg = self.config
        self.mesh = mesh
        self._pad = None
        self._u_export_idx = None
        self._cg_ustar = None
        self._cg_graphs = {}  # CGStepGraph by iteration counts (evolve_cg_n)
        self.dev_lo = None
        if cfg.method == "cg":
            if cfg.precision not in ("f64", "f32"):
                raise ValueError("method='cg' supports precision 'f64'|'f32'")
            if cfg.cg_banded_dtype == "bf16" and cfg.precision != "f32":
                raise ValueError("cg_banded_dtype='bf16' needs precision='f32'")
            self.fused = False
        elif cfg.method == "dense":
            if cfg.precision not in PRECISIONS:
                raise ValueError(f"unknown precision {cfg.precision!r}")
            self.fused = (cfg.fused if cfg.fused is not None
                          else cfg.precision in ("f32", "df32"))
            if self.fused and cfg.precision not in ("f32", "df32"):
                raise ValueError("fused=True requires precision 'f32' or 'df32'")
            if not self.fused and cfg.precision == "df32":
                # The JAX unfused step takes 'df32' as f32 state with f64
                # inverses, promotes u to f64 in its first step, and its
                # lax.scan refuses a carry whose dtype changes: the JAX
                # package runs no such solve.
                raise ValueError(
                    "precision='df32' needs the fused step: the JAX package's "
                    "unfused step cannot run it (f64 inverses promote the f32 "
                    "velocity to f64 in the first step, which its time loop "
                    "refuses)")
        else:
            raise ValueError(f"unknown method {cfg.method!r}")
        self.device = resolve_device(device)

        with span("setup.assemble"):
            self.markers, self.operators = assembled = assemble(mesh, cfg)
            self.drag = drag_probe(mesh, self.markers, cfg.mu)
            self.lift = lift_probe(mesh, self.markers, cfg.mu)
        # The reference's `removable` (flow_solver.py:75-78) with its
        # broadcasting bug fixed, as the JAX package has it: a vertex is
        # removable iff it is not on the boundary.
        self.removable = ~mesh.boundary_vertex_mask
        self.ndofs_u = self.operators.V.ndofs
        self.ndofs_p = self.operators.Q.ndofs

        with span("setup.compose"):
            if cfg.method == "cg":
                self.work_dtype = self.pressure_dtype = (
                    torch.float64 if cfg.precision == "f64" else torch.float32)
                self.dev, self._u_export_idx = build_cg_operators(
                    mesh, cfg, device=self.device, dtype=self.work_dtype,
                    assembled=assembled,
                )
                self.reset_warm_start()
            elif self.fused:
                self.work_dtype = self.pressure_dtype = torch.float32
                built, self.ndofs_u, self.ndofs_p, self._pad = build_fused_operators(
                    mesh, cfg, device=self.device, dtype=torch.float32,
                    split=cfg.precision == "df32", assembled=assembled,
                )
                if cfg.precision == "df32":
                    self.dev, self.dev_lo = built
                else:
                    self.dev = built
            else:
                self.work_dtype, self.pressure_dtype, _ = precision_dtypes(cfg.precision)
                self.dev = build_device_operators(mesh, cfg, device=self.device,
                                                  assembled=assembled)
            if tracing() and self.device.type == "cuda":
                # The span holds the card's part of the composition.
                torch.cuda.synchronize(self.device)

    def export_u(self, u):
        """A velocity vector in the canonical [ux; uy] layout (identity
        unless the banded CG layout's interleaved RCM order is active)."""
        return u if self._u_export_idx is None else u[self._u_export_idx]

    def import_u(self, u):
        """A velocity vector in the canonical [ux; uy] layout put into the
        solver's own layout: the inverse of `export_u` (identity unless the
        banded CG layout's interleaved RCM order is active)."""
        if self._u_export_idx is None:
            return u
        return torch.empty_like(u).index_copy_(0, self._u_export_idx, u)

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
        """Zero initial condition (flow_solver.py:92-93 of the reference), u
        in the work dtype and p in the pressure dtype.  Also resets the CG
        warm start, so a second trajectory through the same solver
        reproduces a fresh one."""
        self.reset_warm_start()
        return FlowState(
            u=torch.zeros(self.ndofs_u, dtype=self.work_dtype, device=self.device),
            p=torch.zeros(self.ndofs_p, dtype=self.pressure_dtype, device=self.device),
        )

    def reset_warm_start(self):
        """Zero the PCG warm start (no-op for the dense method)."""
        if self.config.method == "cg":
            self._cg_ustar = torch.zeros(self.ndofs_u, dtype=self.work_dtype,
                                         device=self.device)

    def evolve(self, state: FlowState, n_steps: int = 1):
        """Advance n_steps; returns (state, drags (n,), lifts (n,)).

        A plain Python loop of steps that never waits for the device: drag
        and lift land in preallocated device tensors.  The CG method carries
        its warm start across calls.  While tracing is on the call is one
        `evolve` span, the root of its steps' spans."""
        cfg = self.config
        with span("evolve"):
            if cfg.method == "cg":
                state, self._cg_ustar, (drags, lifts) = evolve_cg_n(
                    self.dev, state, self._cg_ustar, n_steps, cfg.cg_iters_u,
                    cfg.cg_iters_m, cfg.cg_pressure_refine, graphs=self._cg_graphs,
                )
            elif self.dev_lo is not None:
                state, (drags, lifts) = evolve_fused_df32_n(self.dev, self.dev_lo,
                                                            state, n_steps)
            elif self.fused:
                state, (drags, lifts) = evolve_fused_n(self.dev, state, n_steps)
            else:
                state, (drags, lifts) = evolve_n(self.dev, state, n_steps,
                                                 cfg.precision, cfg.refine_iters)
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
        sampled from the state just computed.  Snapshots are exported in the
        [ux; uy] layout; `state` stays in the solver's own layout so that it
        can continue evolve(): a velocity in [ux; uy] enters it through
        `import_u`.  With the CG method and an explicit `state`, call
        reset_warm_start() first if the state does not continue the
        solver's previous trajectory."""
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
            snaps.append(FlowState(u=self.export_u(state.u), p=state.p))
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

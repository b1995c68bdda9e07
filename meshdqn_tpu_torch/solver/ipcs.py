"""IPCS incompressible Navier–Stokes stepper on CUDA.

Counterpart of meshdqn_tpu/solver/ipcs.py: Taylor–Hood P2/P1, explicit
convection, Crank–Nicolson viscosity, 3-step IPCS splitting with constant
system matrices, assembled once on the host (fem/assembly.py) and
BC-eliminated.  Two methods are ported:

* method='dense', precision='f32': the systems are composed into dense
  operators on the device (solver/fused.py) and applied every step by the
  hand-written matvec kernel (ops/matvec.py).
* method='cg', precision 'f32' or 'f64': the large-mesh path.  The velocity
  systems stay sparse and are solved by warm-started fixed-iteration PCG
  (ops/cg.py); only the small pressure system keeps a dense inverse.  Its
  operators are banded blocks in an RCM order (cg_layout='banded', the
  hand-written kernel of ops/banded.py) or padded rows (cg_layout='ell',
  the hand-written kernel of ops/sparse.py).

The JAX package's precisions 'mixed' and 'df32' and its unfused dense step
are not ported yet (ROADMAP.md, Queue 1 items 4 and 5); asking for them
raises NotImplementedError.  `IPCSConfig` keeps every field of the JAX
config with the same defaults so configs/*.yaml load unchanged.
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
from ..probes import drag_probe, lift_probe
from .fused import FlowState, compose_fused, fused_step

__all__ = ["BandedCGOperators", "CGOperators", "FlowState", "IPCSConfig",
           "IPCSSolver", "build_cg_operators", "build_fused_operators",
           "cg_matrices",
           "evolve_cg_n", "ipcs_step_cg", "ipcs_step_cg_banded",
           "resolve_device"]


@dataclass
class IPCSConfig:
    mu: float = 1e-3
    rho: float = 1.0
    dt: float = 1e-3
    # 'f64' | 'f32' | 'mixed' | 'df32'.  Ported: 'f32' with method='dense'
    # (the fused step); 'f32' and 'f64' with method='cg'.
    precision: str = "f64"
    refine_iters: int = 2  # for 'mixed'
    # TPU-backend switches of the JAX solver, accepted so configs load;
    # the port composes in f64 on its own device whatever they say.
    invert_on_device: bool | None = None
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
    step; returns (new_state, u_star, (drag, lift))."""
    u_n, p_n = state
    ns = dev.A3bc_s.shape[0]
    c = dev.conv(u_n)
    # Step 1: tentative velocity.
    b1 = (dev.R1 @ u_n) + (dev.P1m @ p_n) - dev.rho * c
    b1 = b1 * dev.z_u + dev.t1
    u_star = pcg(dev.A1bc, dev.d1inv, b1[:, None], u_star_prev[:, None],
                 iters_u)[:, 0]
    # Step 2: pressure correction, dense inverse plus refinement.
    b2 = (dev.Kp @ p_n) - (dev.BT @ u_star) / dev.dt
    b2 = b2 * dev.z_p + dev.t2
    p_new = dev.A2inv @ b2
    for _ in range(p_refine):
        p_new = p_new + dev.A2inv @ (b2 - dev.A2bc @ p_new)
    # Step 3: velocity correction, both components as one two-column PCG.
    dp = p_new - p_n
    b3 = (dev.M @ u_star) - dev.dt * (dev.G @ dp)
    b3 = b3 * dev.z_u + dev.t3
    B3 = torch.stack([b3[:ns], b3[ns:]], dim=1)
    X0 = torch.stack([u_star[:ns], u_star[ns:]], dim=1)
    Y = pcg(dev.A3bc_s, dev.d3inv, B3, X0, iters_m)
    u_new = torch.cat([Y[:, 0], Y[:, 1]])

    drag = dev.drag_u @ u_new + dev.drag_p @ p_new
    lift = dev.lift_u @ u_new + dev.lift_p @ p_new
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
    production iteration counts (6, 5), and 1 + p_refine ELL products."""
    u_n, p_n = state
    ns = dev.A3bc_s.shape[0]
    c = dev.conv(u_n)
    # Step 1: tentative velocity.
    b1 = (dev.R1 @ u_n) + (dev.P1m_s @ _at_vertices(dev, p_n)) - dev.rho * c
    b1 = b1 * dev.z_u + dev.t1
    u_star = pcg(dev.A1bc, dev.d1inv, b1[:, None], u_star_prev[:, None],
                 iters_u)[:, 0]
    # Step 2: pressure correction; B^T u* is read off at the vertices.
    bt = (dev.BT_s @ u_star)[dev.vert_pos]
    b2 = (dev.Kp @ p_n) - bt / dev.dt
    b2 = b2 * dev.z_p + dev.t2
    p_new = dev.A2inv @ b2
    for _ in range(p_refine):
        p_new = p_new + dev.A2inv @ (b2 - dev.A2bc @ p_new)
    # Step 3: velocity correction, two-column scalar mass solves.
    V = u_star.view(ns, 2)
    b3 = dev.Ms.matmat(V).view(-1) - dev.dt * (dev.G_s @ _at_vertices(dev, p_new - p_n))
    b3 = b3 * dev.z_u + dev.t3
    Y = pcg(dev.A3bc_s, dev.d3inv, b3.view(ns, 2), V, iters_m)
    u_new = Y.view(-1)

    drag = dev.drag_u @ u_new + dev.drag_p @ p_new
    lift = dev.lift_u @ u_new + dev.lift_p @ p_new
    return FlowState(u=u_new, p=p_new), u_star, (drag, lift)


def evolve_cg_n(dev, state: FlowState, u_star0: torch.Tensor, n_steps: int,
                iters_u: int, iters_m: int, p_refine: int):
    """n_steps CG steps of either layout; returns (state, u_star,
    (drags, lifts)), drag and lift in preallocated device tensors, so the
    loop never waits for the device."""
    step = ipcs_step_cg_banded if isinstance(dev, BandedCGOperators) else ipcs_step_cg
    drags = torch.empty(n_steps, dtype=dev.t1.dtype, device=dev.t1.device)
    lifts = torch.empty_like(drags)
    ustar = u_star0
    for i in range(n_steps):
        state, ustar, (drags[i], lifts[i]) = step(dev, state, ustar, iters_u,
                                                  iters_m, p_refine)
    return state, ustar, (drags, lifts)


def cg_matrices(mesh: TriMesh, config: IPCSConfig) -> dict:
    """The host side of the CG step's operators, as meshdqn_tpu's
    IPCSSolver builds them (solver/ipcs.py:519-573 and :740-828):

    * layout: 'banded', or 'ell' when asked for or when the RCM bandwidth is
      too large for dense blocks (the JAX package's own rule);
    * matrices: scipy CSR by operator field, in the layout's dof order;
    * vectors: f64 arrays by field (z_u, z_p, t1, t2, t3 and the probes);
    * A2inv: the pressure inverse, from host f64 LAPACK;
    * vert_pos, o2n_u: the vertices' scalar-RCM positions and the velocity
      old->new map (banded layout only)."""
    cfg = config
    markers = mark_boundaries(mesh)
    ops = assemble_operators(mesh, markers, cfg.mu, cfg.rho, cfg.dt)
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


def build_cg_operators(mesh: TriMesh, config: IPCSConfig, *, device, dtype):
    """The CG step's operators of `mesh` in `dtype` on `device` (see
    `cg_matrices`).  Returns (operators, export index): the export index
    maps the banded layout's velocity vector to [ux; uy], and is None for
    the ELL layout.  Everything is rounded to `dtype` on the host, as the
    JAX package rounds it; banded operators take bf16 storage with
    cg_banded_dtype='bf16'."""
    cfg = config
    host = cg_matrices(mesh, cfg)
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
    named): the fused f32 dense path or the CG path."""

    def __init__(self, mesh: TriMesh, config: IPCSConfig | None = None,
                 device=None):
        self.config = config or IPCSConfig()
        cfg = self.config
        self.mesh = mesh
        self._pad = None
        self._u_export_idx = None
        self._cg_ustar = None
        if cfg.method == "cg":
            if cfg.precision not in ("f64", "f32"):
                raise ValueError("method='cg' supports precision 'f64'|'f32'")
            if cfg.cg_banded_dtype == "bf16" and cfg.precision != "f32":
                raise ValueError("cg_banded_dtype='bf16' needs precision='f32'")
            self.device = resolve_device(device)
            self.work_dtype = (torch.float64 if cfg.precision == "f64"
                               else torch.float32)
            self.dev, self._u_export_idx = build_cg_operators(
                mesh, cfg, device=self.device, dtype=self.work_dtype
            )
            self.ndofs_u = self.dev.t1.shape[0]
            self.ndofs_p = self.dev.t2.shape[0]
            self.reset_warm_start()
            return
        if cfg.method != "dense":
            raise ValueError(f"unknown method {cfg.method!r}")
        if cfg.precision != "f32":
            raise NotImplementedError(
                f"precision={cfg.precision!r} with method='dense' is not ported "
                "yet: 'f64' and 'mixed' are ROADMAP.md Queue 1 item 4, 'df32' "
                "item 5; the dense path runs 'f32' (fused), and method='cg' "
                "runs 'f32' and 'f64'"
            )
        if cfg.fused is False:
            raise NotImplementedError(
                "fused=False (the unfused step) is not ported yet: ROADMAP.md "
                "Queue 1 item 4"
            )
        self.device = resolve_device(device)
        self.work_dtype = torch.float32
        self.dev, self.ndofs_u, self.ndofs_p, self._pad = build_fused_operators(
            mesh, cfg, device=self.device, dtype=self.work_dtype
        )

    def export_u(self, u):
        """A velocity vector in the canonical [ux; uy] layout (identity
        unless the banded CG layout's interleaved RCM order is active)."""
        return u if self._u_export_idx is None else u[self._u_export_idx]

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
        """Zero initial condition (flow_solver.py:92-93 of the reference).
        Also resets the CG warm start, so a second trajectory through the
        same solver reproduces a fresh one."""
        self.reset_warm_start()
        return FlowState(
            u=torch.zeros(self.ndofs_u, dtype=self.work_dtype, device=self.device),
            p=torch.zeros(self.ndofs_p, dtype=self.work_dtype, device=self.device),
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
        its warm start across calls."""
        cfg = self.config
        if cfg.method == "cg":
            state, self._cg_ustar, (drags, lifts) = evolve_cg_n(
                self.dev, state, self._cg_ustar, n_steps, cfg.cg_iters_u,
                cfg.cg_iters_m, cfg.cg_pressure_refine,
            )
            return state, drags, lifts
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
        sampled from the state just computed.  Snapshots are exported in the
        [ux; uy] layout; `state` stays in the solver's own layout so that it
        can continue evolve().  With the CG method and an explicit `state`,
        call reset_warm_start() first if the state does not continue the
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

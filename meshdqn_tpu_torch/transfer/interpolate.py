"""Cross-mesh solution transfer: point location + polynomial evaluation.

The port of meshdqn_tpu/transfer/interpolate.py.  Reference semantics
(Env2DAirfoil.py:547-593): after each coarsening the S flow snapshots are
re-interpolated from the ORIGINAL mesh onto the new mesh, every new dof
point evaluated against the original P2/P1 polynomials; points outside the
source mesh are extrapolated from the least-violating cell.

The source mesh is frozen for a whole job, so its geometry (cell origins,
inverse Jacobians, dof gathers) is tabulated once on the device.  Point
location is a brute-force sweep over cells, argmax of the minimum
barycentric coordinate, run in f32 as the JAX package runs it; the chosen
cell's reference coordinates, the evaluation and the probe contraction are
f64.  Target points are padded to static budgets (the source's sizes), so no
tensor's shape depends on the episode.

This is plain torch: the JAX package runs it as XLA, with no Pallas kernel.
The device passes take a leading batch axis: the env's own step is a batch
of one, the trainer runs a sweep's removals and window shifts as one batch
each (`run_products_batched_*`, `gather_window_batched_*`).  A batch's
inputs cross as one packed buffer (f64 for the env's step; f32 on the
trainer's wire, cast to f64 on the device, as the JAX package ships them),
all its points are located in one sweep (`_step_products`), and its small
f32 results come back in one readback.  Each row's result is independent
of the others, so only the real rows run (the JAX package pads the batch to
a few static sizes for its compiler).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fem.assembly import cell_jacobians
from ..fem.spaces import P1Space, P2Space
from ..mesh import TriMesh
from ..utils.hostio import Readback, upload

F64 = torch.float64


@dataclass(frozen=True)
class SourceField:
    """Frozen source-mesh tabulation for evaluating P2/P1 functions."""

    p0: torch.Tensor  # (C, 2) f64 first-vertex coords
    Jinv: torch.Tensor  # (C, 2, 2) f64
    cell_dofs_p2: torch.Tensor  # (C, 6) int64
    cell_dofs_p1: torch.Tensor  # (C, 3) int64
    ns: int  # scalar P2 dofs on the source
    p0_32: torch.Tensor  # the sweep's f32 copies
    Jinv_32: torch.Tensor

    @classmethod
    def build(cls, mesh: TriMesh, device) -> "SourceField":
        _, _, Jinv = cell_jacobians(mesh)
        p0 = torch.tensor(mesh.coords[mesh.cells[:, 0]], dtype=F64, device=device)
        jinv = torch.tensor(Jinv, dtype=F64, device=device)
        as_long = lambda a: torch.tensor(np.asarray(a, np.int64), device=device)  # noqa: E731
        return cls(
            p0=p0, Jinv=jinv,
            cell_dofs_p2=as_long(P2Space(mesh).cell_dofs()),
            cell_dofs_p1=as_long(P1Space(mesh).cell_dofs()),
            ns=P2Space(mesh).ndofs,
            p0_32=p0.float(), Jinv_32=jinv.float(),
        )


def locate(src: SourceField, points: torch.Tensor):
    """For each point, the best cell and its reference coords.

    points: (P, 2) f64.  Returns (cells (P,) int64, xi (P, 2) f64).

    The O(P*C) candidate sweep runs in f32 (`interpolate.py:64-92` of the
    JAX package): xi = Jinv (x - p0) per cell, the minimum of the three
    barycentric coordinates, and its argmax over cells (the first cell on
    ties), i.e. the containing cell or the least-violating one.  The chosen
    cell's reference coordinates are then recomputed in f64."""
    p32 = points.float()
    dx = p32[:, 0:1] - src.p0_32[None, :, 0]  # (P, C)
    dy = p32[:, 1:2] - src.p0_32[None, :, 1]
    J = src.Jinv_32
    xi0 = dx * J[None, :, 0, 0] + dy * J[None, :, 0, 1]
    xi1 = dx * J[None, :, 1, 0] + dy * J[None, :, 1, 1]
    bary0 = 1.0 - xi0 - xi1
    minb = torch.minimum(bary0, torch.minimum(xi0, xi1))
    cells = torch.argmax(minb, dim=1)
    d = points - src.p0[cells]  # (P, 2) f64
    xi_best = (d[:, None, :] * src.Jinv[cells]).sum(-1)
    return cells, xi_best


def _p2_basis(xi):
    x, y = xi[..., 0], xi[..., 1]
    l0 = 1.0 - x - y
    return torch.stack(
        [l0 * (2 * l0 - 1), x * (2 * x - 1), y * (2 * y - 1),
         4 * x * y, 4 * l0 * y, 4 * l0 * x],
        dim=-1,
    )


def _p1_basis(xi):
    x, y = xi[..., 0], xi[..., 1]
    return torch.stack([1.0 - x - y, x, y], dim=-1)


def eval_p2_vector(src: SourceField, u: torch.Tensor, points: torch.Tensor):
    """Evaluate a block-layout vector P2 field at points -> (P, 2)."""
    cells, xi = locate(src, points)
    phi = _p2_basis(xi)
    dofs = src.cell_dofs_p2[cells]
    ux = (phi * u[dofs]).sum(1)
    uy = (phi * u[src.ns + dofs]).sum(1)
    return torch.stack([ux, uy], dim=1)


def eval_p1(src: SourceField, p: torch.Tensor, points: torch.Tensor):
    """Evaluate a P1 field at points -> (P,)."""
    cells, xi = locate(src, points)
    return (_p1_basis(xi) * p[src.cell_dofs_p1[cells]]).sum(1)


def _eval_all(src: SourceField, u_all, p_all, pts):
    """S vector-P2 and S P1 fields at each of B targets' points.

    u_all: (S, 2Ns), p_all: (S, Np), pts: (B, P, 2); one locate sweep over
    all B*P points.  Returns (B, S, P, 2) velocities and (B, S, P)
    pressures, f64."""
    B, P = pts.shape[:2]
    cells, xi = locate(src, pts.reshape(B * P, 2))
    cells, xi = cells.view(B, P), xi.view(B, P, 2)
    phi2 = _p2_basis(xi)  # (B, P, 6)
    dofs2 = src.cell_dofs_p2[cells]
    ux = (phi2 * u_all[:, dofs2]).sum(-1)  # (S, B, P)
    uy = (phi2 * u_all[:, src.ns + dofs2]).sum(-1)
    pv = (_p1_basis(xi) * p_all[:, src.cell_dofs_p1[cells]]).sum(-1)
    uv = torch.stack([ux, uy], dim=-1).transpose(0, 1).contiguous()
    return uv, pv.transpose(0, 1).contiguous()


def _gather_window(uv, pv, widx):
    """Window features of B targets' interpolants, uv (B, S, P, 2) and pv
    (B, S, P), at widx (B, W): (B, S*W*2 + S*W) f32, velocities first."""
    (B, S), W = uv.shape[:2], widx.shape[1]
    vel_w = torch.gather(uv, 2, widx[:, None, :, None].expand(B, S, W, 2))
    p_w = torch.gather(pv, 2, widx[:, None, :].expand(B, S, W))
    return torch.cat([vel_w.reshape(B, -1).float(), p_w.reshape(B, -1).float()], dim=1)


def _step_products(src: SourceField, u_all, p_all, pts, probe_u, probe_p, widx):
    """The env's device pass per mesh change, for B targets at once:
    interpolate all S snapshots onto each target's padded dof points,
    integrate the (padded) drag/lift functionals, gather the observation
    window's vertex features and a finiteness flag.

    pts: (B, P, 2); probe_u: (B, 2, 2, P) [drag, lift][x, y] zero-padded
    velocity functionals; probe_p: (B, 2, P); widx: (B, W) window vertex
    indices (the vertices are the first points of `pts`).

    Returns (uv (B, S, P, 2), pv (B, S, P), small (B, L)), each row of small
    packing [finite, drags (S,), lifts (S,), vel_w (S, W, 2), p_w (S, W)] in
    f32, as the JAX package packs it for one host readback."""
    uv, pv = _eval_all(src, u_all, p_all, pts)
    B = uv.shape[0]
    finite = torch.isfinite(uv).flatten(1).all(1) & torch.isfinite(pv).flatten(1).all(1)
    forces = (torch.einsum("bspc,bfcp->bfs", uv, probe_u)
              + torch.einsum("bsp,bfp->bfs", pv, probe_p))  # (B, 2, S)
    return uv, pv, torch.cat([finite.float()[:, None], forces.reshape(B, -1).float(),
                              _gather_window(uv, pv, widx)], dim=1)


# ----------------------------------------------------------------------
# Snapshot transfer onto a (coarsened) target mesh
# ----------------------------------------------------------------------

@dataclass
class SnapshotSet:
    """S flow snapshots on one mesh: u (S, 2Ns), p (S, Np), numpy."""

    u: np.ndarray
    p: np.ndarray

    @property
    def num_snapshots(self) -> int:
        return len(self.u)


class SnapshotTransfer:
    """Interpolates snapshots from a frozen source mesh onto target meshes
    (Env2DAirfoil.py:556-568), all snapshots and all target dof points in
    one device pass."""

    def __init__(self, source_mesh: TriMesh, snapshots: SnapshotSet,
                 window_budget: int = 180, device=None):
        from ..solver.ipcs import resolve_device

        self.device = resolve_device(device)
        self.src = SourceField.build(source_mesh, self.device)
        self.u_src = torch.tensor(np.stack(snapshots.u), dtype=F64, device=self.device)
        self.p_src = torch.tensor(np.stack(snapshots.p), dtype=F64, device=self.device)
        # Static padded target budgets: coarsening only shrinks the mesh, so
        # the source sizes bound every target.
        self._budget2 = P2Space(source_mesh).ndofs
        self._budget1 = source_mesh.num_vertices
        self.window_budget = window_budget

    def to_mesh(self, target: TriMesh) -> SnapshotSet:
        """Interpolate all snapshots onto `target`'s P2/P1 dofs: one locate
        over the padded P2 points serves velocity and pressure (the P1 dof
        points are the first V P2 dof points)."""
        Vs = P2Space(target)
        n2, n1 = Vs.ndofs, target.num_vertices
        pts = Vs.dof_coords()
        if n2 <= self._budget2:
            padded = np.zeros((self._budget2, 2))
            padded[:n2] = pts
            pts = padded
        uv, pv = _eval_all(self.src, self.u_src, self.p_src, upload(pts, self.device)[None])
        uv, pv = uv[0, :, :n2].cpu().numpy(), pv[0]
        return SnapshotSet(u=np.concatenate([uv[..., 0], uv[..., 1]], axis=1),
                           p=pv[:, :n1].cpu().numpy())

    def step_inputs(self, target: TriMesh, window: np.ndarray, dprobe, lprobe):
        """Host-side inputs of the per-removal device pass (numpy)."""
        Vs = P2Space(target)
        n2, n1 = Vs.ndofs, target.num_vertices
        P = max(self._budget2, n2)
        pts = np.zeros((P, 2))
        pts[:n2] = Vs.dof_coords()

        probe_u = np.zeros((2, 2, P))
        probe_p = np.zeros((2, P))
        for f, pr in enumerate((dprobe, lprobe)):
            probe_u[f, 0, :n2] = pr.d_u[:n2]
            probe_u[f, 1, :n2] = pr.d_u[n2:]
            probe_p[f, :n1] = pr.d_p

        W = self.window_budget
        widx = np.zeros(W, dtype=np.int32)
        widx[: len(window)] = window
        return {"pts": pts, "probe_u": probe_u, "probe_p": probe_p, "widx": widx,
                "n1": n1, "n2": n2, "k": len(window)}

    def _parse_small(self, small: np.ndarray, k: int):
        S = len(self.u_src)
        W = self.window_budget
        finite = bool(small[0])
        drags = small[1 : 1 + S].astype(np.float64)
        lifts = small[1 + S : 1 + 2 * S].astype(np.float64)
        off = 1 + 2 * S
        vel_w = small[off : off + S * W * 2].reshape(S, W, 2)[:, :k]
        p_w = small[off + S * W * 2 :].reshape(S, W)[:, :k]
        return finite, drags, lifts, vel_w, p_w

    def step_products(self, target: TriMesh, window: np.ndarray, dprobe, lprobe):
        """The per-removal device pass (see _step_products).

        Returns (dev_snaps, finite, drags (S,), lifts (S,), vel_w (S, k, 2),
        p_w (S, k)); dev_snaps = (uv, pv, n1, n2) stays on the device,
        padded; k = len(window)."""
        return self.step_products_from_inputs(self.step_inputs(target, window, dprobe,
                                                               lprobe))

    def step_products_from_inputs(self, inp: dict):
        """The device pass of one env from prepared step_inputs, its f64
        inputs shipped as they are (a batch of one, see
        run_products_batched_begin)."""
        return self.run_products_batched_finish(self.run_products_batched_begin([inp]))[0]

    def run_products_batched_begin(self, inputs: list[dict], wire: str = "f64"):
        """Enqueue many envs' device passes as one batched pass, and the
        copy of its results to the host; return a handle for
        `run_products_batched_finish`, which waits.

        The inputs cross as one packed buffer.  wire='f32' ships them
        rounded to f32 (points, probe functionals; the window indices are
        exact) and casts them to f64 on the device, as the JAX package's
        trainer ships them; 'f64' (the env's own step) ships them as they
        are."""
        if wire not in ("f32", "f64"):
            raise ValueError(f"wire must be 'f32' or 'f64', not {wire!r}")
        B, P = len(inputs), len(inputs[0]["pts"])
        dt = np.float32 if wire == "f32" else np.float64
        host = np.concatenate(
            [np.stack([i[key] for i in inputs]).reshape(B, -1).astype(dt)
             for key in ("pts", "probe_u", "probe_p", "widx")], axis=1)
        dev = upload(host, self.device).to(F64)
        pts = dev[:, : 2 * P].view(B, P, 2)
        probe_u = dev[:, 2 * P : 6 * P].view(B, 2, 2, P)
        probe_p = dev[:, 6 * P : 8 * P].view(B, 2, P)
        widx = dev[:, 8 * P :].long()
        uv, pv, small = _step_products(self.src, self.u_src, self.p_src, pts,
                                       probe_u, probe_p, widx)
        return uv, pv, Readback(small), list(inputs)

    def run_products_batched_finish(self, handle):
        """The readback half of run_products_batched_begin: a list of
        (dev_snaps, finite, drags, lifts, vel_w, p_w) in input order, as
        step_products returns them."""
        uv, pv, small, inputs = handle
        smalls = small.numpy()
        return [((uv[b], pv[b], inp["n1"], inp["n2"]), *self._parse_small(smalls[b], inp["k"]))
                for b, inp in enumerate(inputs)]

    def gather_window(self, dev_snaps, window: np.ndarray):
        """Window features from device-resident interpolants (the do-nothing
        step: the mesh, hence the interpolation, is unchanged)."""
        return self.gather_window_batched_finish(
            self.gather_window_batched_begin([(dev_snaps, window)]))[0]

    def gather_window_batched_begin(self, items: list[tuple]):
        """Enqueue the window gather of many envs' device-resident
        interpolants, items = [(dev_snaps, window), ...], and the copy of
        its result to the host; return a handle for
        `gather_window_batched_finish`."""
        B, W = len(items), self.window_budget
        uv = torch.stack([d[0] for d, _ in items])  # (B, S, P, 2)
        pv = torch.stack([d[1] for d, _ in items])
        widx = np.zeros((B, W), dtype=np.int64)
        for b, (_, window) in enumerate(items):
            widx[b, : len(window)] = window
        return Readback(_gather_window(uv, pv, upload(widx, self.device))), list(items)

    def gather_window_batched_finish(self, handle):
        """The readback half of gather_window_batched_begin: [(vel_w, p_w),
        ...] in item order."""
        small, items = handle
        smalls = small.numpy()
        S, W = len(self.u_src), self.window_budget
        out = []
        for b, (_, window) in enumerate(items):
            k = len(window)
            out.append((smalls[b, : S * W * 2].reshape(S, W, 2)[:, :k],
                        smalls[b, S * W * 2 :].reshape(S, W)[:, :k]))
        return out

    def materialize(self, dev_snaps) -> SnapshotSet:
        """Device-resident interpolants as an unpadded SnapshotSet."""
        uv, pv, n1, n2 = dev_snaps
        uvn = uv[:, :n2].cpu().numpy()
        return SnapshotSet(u=np.concatenate([uvn[..., 0], uvn[..., 1]], axis=1),
                           p=pv[:, :n1].cpu().numpy())

    def vertex_fields(self, target: TriMesh, snaps: SnapshotSet):
        """velocities (S, V, 2) and pressures (S, V) at target vertices: for
        nodal P2/P1 the values at vertices are the vertex dofs."""
        V = target.num_vertices
        Ns = P2Space(target).ndofs
        vel = np.stack([snaps.u[:, :V], snaps.u[:, Ns : Ns + V]], axis=2)
        return vel, snaps.p[:, :V]

"""Per-step convection assembly: c(u)_[(a,i)] = ((u.grad)u, Phi_a).

Counterpart of meshdqn_tpu/ops/convection.py, the only nonlinear term of the
IPCS step-1 right-hand side.  The tabulation is built once per mesh on the
host with numpy and moved to the device.  `convection_vector` gathers the
12 local velocity dofs per cell, evaluates u and grad(u) at the quadrature
points, contracts with the test basis, and sums into the global vector:

* on CUDA tensors, in one call into csrc/convection.cu (two launches: the
  element vectors, then the slot sums), f32 or f64 as the tables are;
* on CPU tensors, in plain torch, `convection_vector_reference`, which the
  tests hold against the JAX kernel and the card tests hold the kernel to.

`convection_columns` (the ensemble's velocity columns) and
`convection_members` (the batched flows' members, each with its own table)
call the single form once per column or member and stack the results.  A
batched form would sum in other shapes and orders; the loop gives each
column and member the single call's bits by construction, which the
ensemble's member of amplitude 1.0 and the batch's base member rely on to
equal their solo solves bit for bit.

The sum is deterministic.  Atomic scatters (`index_add_` on CUDA) change the
order of additions, and so the bits, from run to run; instead each global
dof owns a padded row of the (cell, local slot) entries it receives
(`dof_slots`, ascending in element order), pad slots point at an appended
zero, and the row is summed in fixed order, by the plain version and by the
kernel alike (the kernel reads the rows packed, `packed_slots`).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..fem.assembly import cell_jacobians
from ..fem.reference import dunavant_6, p2_basis, p2_grads
from ..fem.spaces import VectorP2Space
from ..mesh import TriMesh
from ..utils.profiling import count
from . import build

# Quadrature points a cell the kernel takes, at most (csrc/convection.cu
# kMaxPoints); the tables' rule has 12.
MAX_POINTS = 32
# The kernel's C entry point by the tables' dtype.
_ENTRY = {torch.float32: "convection_f32", torch.float64: "convection_f64"}

_LIB = None


def _lib():
    """csrc/convection.cu's library, built at first use, with its C
    signatures."""
    global _LIB
    if _LIB is None:
        lib = build.load("convection")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


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


def convection_vector_reference(k: ConvectionKernel, u: torch.Tensor) -> torch.Tensor:
    """Plain version of `convection_vector`, in torch, in the tables'
    dtype."""
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


def packed_slots(k: ConvectionKernel) -> torch.Tensor:
    """k's incidence table as the kernel reads it, (ndofs, W) int32: each
    row's entries in the table's order without the pad slots and the
    entries of cells of zero weight (every term of theirs is scaled by
    wdet = 0), then padded with 12 C to the widest row (at least 1).  A row
    sums to the table row's sum but for the sign of a zero result."""
    C = k.cell_dofs.shape[0]
    live = torch.cat([(k.wdet != 0).any(dim=1).repeat_interleave(12),
                      k.wdet.new_zeros(1, dtype=torch.bool)])
    keep = live[k.dof_slots]
    width = max(int(keep.sum(dim=1).max()), 1) if keep.numel() else 1
    # Stable: the kept entries move to the front of their row in order.
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    packed = torch.where(keep, k.dof_slots, 12 * C).gather(1, order)[:, :width]
    return packed.to(torch.int32).contiguous()


def _launch_args(k: ConvectionKernel) -> tuple:
    """(C entry point, pointers, (C, Q, W, ndofs), device, dtype, the
    packed slots, kept alive here) of k's tables, kept on k as `_checked`.
    The tables are constant over a solve, so they are checked and packed
    once: while k holds the same objects neither is repeated.  The check
    reads both index tables' ranges (a host sync), as the kernel gathers
    through them unchecked."""
    tables = (k.cell_dofs, k.phi, k.gphys, k.wdet, k.dof_slots, k.ndofs)
    held = getattr(k, "_checked", None)
    if held is not None and all(a is b for a, b in zip(held[0], tables)):
        return held[1]
    cell_dofs, phi, gphys, wdet, slots, ndofs = tables
    dtype, device = phi.dtype, phi.device
    if dtype not in _ENTRY:
        raise TypeError(f"the kernel takes float32 or float64 tables, got {dtype}")
    if wdet.dim() != 2 or slots.dim() != 2:
        raise ValueError("wdet and dof_slots must have two dimensions")
    (C, Q), S = wdet.shape, slots.shape[1]
    for name, t, shape, want in (
        ("cell_dofs", cell_dofs, (C, 12), torch.int64), ("phi", phi, (Q, 6), dtype),
        ("gphys", gphys, (C, 6, Q, 2), dtype), ("wdet", wdet, (C, Q), dtype),
        ("dof_slots", slots, (ndofs, S), torch.int64),
    ):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, phi on {device}")
        if t.dtype != want:
            raise TypeError(f"the kernel takes {want} for {name}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, not {shape}")
        if not t.is_contiguous():
            raise ValueError(f"the kernel takes contiguous tables; {name} is not")
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"the tables are on {device}, not on the current CUDA device")
    if not 1 <= Q <= MAX_POINTS:
        raise ValueError(f"the kernel takes 1 to {MAX_POINTS} quadrature points, got {Q}")
    for name, t, top in (("cell_dofs", cell_dofs, ndofs - 1),
                         ("dof_slots", slots, 12 * C)):
        if t.numel() and not (0 <= int(t.min()) and int(t.max()) <= top):
            raise ValueError(f"{name} holds an index outside [0, {top}]")
    packed = packed_slots(k)
    ptrs = (cell_dofs.data_ptr(), phi.data_ptr(), gphys.data_ptr(), wdet.data_ptr(),
            packed.data_ptr())
    args = (getattr(_lib(), _ENTRY[dtype]), ptrs, (C, Q, packed.shape[1], ndofs),
            device, dtype, packed)
    k._checked = (tables, args)
    return args


def convection_vector(k: ConvectionKernel, u: torch.Tensor) -> torch.Tensor:
    """Assemble ((u.grad)u, v) for the velocity field u (ndofs,): one call
    into the kernel on CUDA, counted in `convection_vector.launches` (and
    as `convection.launches` while tracing is on); the plain version on the
    CPU."""
    if not (u.is_cuda or k.phi.is_cuda):
        return convection_vector_reference(k, u)
    fn, ptrs, sizes, device, dtype, _ = _launch_args(k)
    C, _, _, ndofs = sizes
    if u.device != device:
        raise ValueError(f"u is on {u.device}, the tables on {device}")
    if u.dtype != dtype:
        raise TypeError(f"the tables are {dtype}, u is {u.dtype}")
    if u.shape != (ndofs,):
        raise ValueError(f"u must have shape ({ndofs},), got {tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError("the kernel takes a contiguous u")
    # The output and, behind it, the element vectors with their pad slot: a
    # fresh buffer a call (convection_columns and convection_members stack
    # several results).
    buf = torch.empty(ndofs + 12 * C + 1, dtype=dtype, device=device)
    out = buf.data_ptr()
    err = fn(u.data_ptr(), *ptrs, out + ndofs * buf.element_size(), out, *sizes,
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_ENTRY[dtype]} launch failed: cudaError_t {err}")
    convection_vector.launches += 1
    count("convection.launches")
    return buf[:ndofs]


convection_vector.launches = 0


def convection_columns(k: ConvectionKernel, u: torch.Tensor) -> torch.Tensor:
    """c(u[:, j]) for each column of u (ndofs, B), as (ndofs, B): the single
    call per column (see the module's note), on the columns made contiguous
    once."""
    cols = u.T.contiguous()
    return torch.stack([convection_vector(k, col) for col in cols], dim=1)


def convection_members(kernels, u: torch.Tensor) -> torch.Tensor:
    """kernels[b](u[b]) for each member of u (B, ndofs), as (B, ndofs): the
    single call per member, each with its own table."""
    if len(kernels) != u.shape[0]:
        raise ValueError(f"{len(kernels)} tables for {u.shape[0]} members")
    return torch.stack([convection_vector(k, u[b]) for b, k in enumerate(kernels)])

"""Dense f32 matvec: every operator apply of the fused IPCS step.

Kernels (csrc/matvec.cu, CUDA C++ for sm_90a, bound with ctypes):

* `matvec` replaces meshdqn_tpu/ops/pallas_kernels.py:matvec_pallas
  (_mv_kernel): y = m @ x, x of shape (N,) or (N, k) with k <= 2.
* `step_ustar`, `step_pressure`, `step_velocity`: the same kernel in its
  grouped form, the fused step's seven products and the elementwise work
  around them in three launches (solver/fused.py).  Each equals its plain
  version `step_*_reference` with `apply=matvec` (single launches and
  torch's elementwise ops) bit for bit: every row product is summed in
  `matvec`'s order, and the kernel rounds the epilogue as torch does.
* `step_ustar_df32`, `step_pressure_df32`, `step_velocity_df32`: the
  split form, the 'df32' step's three launches (solver/fused.py
  fused_step_df32).  Each operator is an f32 high limb and a bf16 low limb;
  a launch streams both once, sums the high limb as the grouped form does
  and the low limb against x rounded to bf16, and combines them in the
  order of meshdqn_tpu/solver/fused.py:fused_step_df32.  It replaces that
  step's f32 matmuls and its bf16 low-limb matmuls.  Plain versions
  `step_*_df32_reference`.
* `matvec_dual` replaces meshdqn_tpu/ops/pallas_kernels.py:matvec_dual_pallas
  (_mv_dual_kernel): y = m @ x_hi + m @ x_lo, reading m once, for a state
  carried as two f32 words.  No solver mode carries one, in the port or in
  the JAX package ('df32' splits the operators, not the state), so it has
  no caller.

All are bound by the bytes of the matrices: a matvec does two flops per
matrix entry and reuses none of it.  The kernel streams each matrix exactly
once with coalesced 16-byte loads, one warp per row, while x sits in shared
memory; per-lane sums are reduced in a fixed shuffle order with no atomics,
so results are bit-reproducible (the ys930 lift error is phase noise seeded
by per-step rounding, so steps must be repeatable).

On CUDA tensors the wrappers launch the kernel or raise.  On CPU tensors
they use the plain versions, which the tests hold against the JAX kernels
and the JAX step.  Each wrapper counts its launches in `<wrapper>.launches`.
On the card a kernel is held to its plain version by
`relative_gap(y, y_plain) <= gap_tolerance(N)`.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from . import build

# Largest dynamic shared memory a block may use on sm_90 (csrc/matvec.cu).
MAX_SMEM_BYTES = 232448

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


_LIB = None


def _lib():
    """csrc/matvec.cu's library, built at first use, with its C signatures."""
    global _LIB
    if _LIB is None:
        lib = build.load("matvec")
        lib.matvec_f32.argtypes = [_c_void_p] * 3 + [_c_int] * 3 + [_c_void_p]
        lib.matvec_f32.restype = _c_int
        lib.matvec_dual_f32.argtypes = [_c_void_p] * 4 + [_c_int] * 3 + [_c_void_p]
        lib.matvec_dual_f32.restype = _c_int
        lib.step_ustar_f32.argtypes = [_c_void_p] * 9 + [_c_int] * 2 + [_c_void_p]
        lib.step_pressure_f32.argtypes = [_c_void_p] * 7 + [_c_int] * 2 + [_c_void_p]
        lib.step_velocity_f32.argtypes = [_c_void_p] * 6 + [_c_int] * 2 + [_c_void_p]
        lib.step_ustar_df32.argtypes = [_c_void_p] * 13 + [_c_int] * 2 + [_c_void_p]
        lib.step_pressure_df32.argtypes = [_c_void_p] * 10 + [_c_int] * 2 + [_c_void_p]
        lib.step_velocity_df32.argtypes = [_c_void_p] * 9 + [_c_int] * 2 + [_c_void_p]
        for fn in (lib.step_ustar_f32, lib.step_pressure_f32, lib.step_velocity_f32,
                   lib.step_ustar_df32, lib.step_pressure_df32, lib.step_velocity_df32):
            fn.restype = _c_int
        _LIB = lib
    return _LIB


def matvec_reference(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of `matvec`, in the inputs' dtype."""
    return m @ x


def matvec_dual_reference(
    m: torch.Tensor, x_hi: torch.Tensor, x_lo: torch.Tensor
) -> torch.Tensor:
    """Plain version of `matvec_dual`, in the inputs' dtype."""
    return m @ x_hi + m @ x_lo


def relative_gap(y: torch.Tensor, ref: torch.Tensor, rows=None) -> float:
    """||y - ref|| / ||ref|| over all entries, in f64; with `rows` (a bool
    mask of the leading dimension) over those rows only."""
    y, ref = y.double(), ref.double()
    if rows is not None:
        y, ref = y[rows], ref[rows]
    return (torch.linalg.vector_norm(y - ref)
            / torch.linalg.vector_norm(ref)).item()


def gap_tolerance(n: int, dtype=torch.float32) -> float:
    """The `relative_gap` allowed between a kernel and its plain version for
    rows of n terms: 2 sqrt(n) u, with u = 2^-24 in f32 (and for bf16
    operands, which a kernel widens to f32 exactly) and 2^-53 in f64.

    Two sums of the same n products in different orders differ by a random
    walk of roundings; on unit-normal data its norm is about 0.1 sqrt(n) u of
    ||y|| (the kernel's order emulated against torch's on the CPU, n = 3 to
    6644), so the factor 2 leaves 6x headroom at small n and 20x at the
    step's widths.  Inputs rounded to TF32 (10-bit mantissa) land at
    >= 50 sqrt(n) 2^-24 and to bf16 at >= 400 sqrt(n) 2^-24, so a kernel
    that drops precision fails."""
    u = 2.0**-53 if dtype == torch.float64 else 2.0**-24
    return 2.0 * n**0.5 * u


def round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """f32 or f64 t rounded to `bits` mantissa bits (TF32 keeps 10, bf16 7):
    the inputs of a kernel that lost precision, which `gap_tolerance`
    rejects."""
    if t.dtype == torch.float64:
        drop, itype = 52 - bits, torch.int64
    else:
        drop, itype = 23 - bits, torch.int32
    i = t.contiguous().view(itype)
    return ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(t.dtype)


def _check_operand(name: str, t: torch.Tensor, device: torch.device,
                   dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the operators on {device}")
    if t.dtype != dtype:
        raise TypeError(f"the kernel takes {dtype} for {name}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"the kernel takes contiguous operands; {name} is not")


def _check_current_device(device: torch.device) -> None:
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"the operators are on {device}, not on the current CUDA "
                         "device")


def _check(m: torch.Tensor, xs) -> tuple[int, int, int]:
    """Validate CUDA operands for the kernel; returns (R, N, k)."""
    if m.dim() != 2:
        raise ValueError(f"m must be 2-D, got shape {tuple(m.shape)}")
    R, N = m.shape
    shape = xs[0].shape
    if len(shape) not in (1, 2) or shape[0] != N:
        raise ValueError(f"x of shape {tuple(shape)} does not match m {(R, N)}")
    k = 1 if len(shape) == 1 else shape[1]
    if k not in (1, 2):
        raise ValueError(f"the kernel takes k in (1, 2) right-hand sides, got {k}")
    smem = -(-N // 4) * 4 * k * len(xs) * 4  # each x column padded to 16 bytes
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"x needs {smem} bytes of shared memory, above the {MAX_SMEM_BYTES} "
            "a block may use"
        )
    for name, t in zip(("m", "x", "x_lo"), (m, *xs)):
        _check_operand(name, t, m.device)
    _check_current_device(m.device)
    for t in xs[1:]:
        if t.shape != shape:
            raise ValueError(f"x_hi {tuple(shape)} and x_lo {tuple(t.shape)} differ")
    return R, N, k


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def matvec(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = m @ x for m (R, N) and x (N,) or (N, k<=2), f32 on CUDA."""
    if not m.is_cuda and not x.is_cuda:
        return matvec_reference(m, x)
    R, N, k = _check(m, (x,))
    y = torch.empty((R,) if x.dim() == 1 else (R, k),
                    dtype=torch.float32, device=m.device)
    err = _lib().matvec_f32(m.data_ptr(), x.data_ptr(), y.data_ptr(), R, N, k,
                            _stream(m))
    _raise_on(err, "matvec_f32")
    matvec.launches += 1
    return y


def matvec_dual(
    m: torch.Tensor, x_hi: torch.Tensor, x_lo: torch.Tensor
) -> torch.Tensor:
    """y = m @ x_hi + m @ x_lo, streaming m once; f32 on CUDA."""
    if not (m.is_cuda or x_hi.is_cuda or x_lo.is_cuda):
        return matvec_dual_reference(m, x_hi, x_lo)
    R, N, k = _check(m, (x_hi, x_lo))
    y = torch.empty((R,) if x_hi.dim() == 1 else (R, k),
                    dtype=torch.float32, device=m.device)
    err = _lib().matvec_dual_f32(m.data_ptr(), x_hi.data_ptr(), x_lo.data_ptr(),
                                 y.data_ptr(), R, N, k, _stream(m))
    _raise_on(err, "matvec_dual_f32")
    matvec_dual.launches += 1
    return y


# --------------------------------------------------------------------------
# The fused step in three grouped launches (solver/fused.py).  The plain
# versions are the step's torch expressions with every product through
# `apply`: matvec_reference on the CPU, matvec for the seven single
# launches, which the grouped kernel equals bit for bit.
# --------------------------------------------------------------------------


def step_ustar_reference(F1u, F1p, A1Z, rho, k1, u, p, c, apply=matvec_reference):
    """Plain version of `step_ustar`: u* = F1u u + F1p p - rho A1Z c + k1."""
    return apply(F1u, u) + apply(F1p, p) - rho * apply(A1Z, c) + k1


def step_pressure_reference(F2p, F2u, k2, p, u_star, apply=matvec_reference):
    """Plain version of `step_pressure`: (p', p' - p) with
    p' = F2p p + F2u u* + k2."""
    p_new = apply(F2p, p) + apply(F2u, u_star) + k2
    return p_new, p_new - p


def step_velocity_reference(F3s, F3p, k3, u_star, dp, apply=matvec_reference):
    """Plain version of `step_velocity`: u' = [F3s u*_x + F3p[0] dp;
    F3s u*_y + F3p[1] dp] + k3, F3p the (2, Ns, Np) stacked x/y blocks."""
    ns = F3s.shape[0]
    ustack = torch.stack([u_star[:ns], u_star[ns:]], dim=1)  # (Ns, 2)
    y = apply(F3s, ustack)  # (Ns, 2)
    # F3p as (2Ns, Np): its product with dp is [x-block; y-block], the
    # transpose of the (Ns, 2) stack.
    corr = apply(F3p.view(2 * ns, -1), dp).view(2, ns)
    y = y + corr.T
    return torch.cat([y[:, 0], y[:, 1]]) + k3


# Per grouped form, weak references to the operator tensors last checked.
_checked_operators: dict[str, tuple] = {}


def _bind(sizes: dict, name: str, t: torch.Tensor, dims: tuple) -> None:
    """Record or compare t's sizes under the names in dims (an int is a
    fixed size)."""
    if t.dim() != len(dims):
        raise ValueError(f"{name} must have {len(dims)} dimensions, got shape "
                         f"{tuple(t.shape)}")
    for d, n in zip(dims, t.shape):
        want = d if isinstance(d, int) else sizes.setdefault(d, n)
        if n != want:
            raise ValueError(f"{name} of shape {tuple(t.shape)} does not match the "
                             f"other operands ({d} = {want})")


def _check_group(form: str, ops, vecs, staged) -> dict:
    """Validate a grouped launch's operands, given as (name, tensor, dims)
    or (name, tensor, dims, dtype): one device, float32 unless named,
    contiguous, sizes that agree; returns the sizes by name.  `staged`
    names the sizes of the x vectors the launch stages in shared memory.
    The operators are constant over a solve, so beyond their sizes they are
    checked once: while the same tensor objects come back, only the vectors
    are."""
    sizes: dict = {}
    for name, t, dims, *_ in (*ops, *vecs):
        _bind(sizes, name, t, dims)
    smem = 4 * sum(-(-sizes[d] // 4) * 4 for d in staged)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{form}'s x vectors need {smem} bytes of shared memory, "
                         f"above the {MAX_SMEM_BYTES} a block may use")
    device = ops[0][1].device
    refs = _checked_operators.get(form)
    fresh = refs is None or any(r() is not op[1] for r, op in zip(refs, ops))
    for name, t, _, *dtype in (*ops, *vecs) if fresh else vecs:
        _check_operand(name, t, device, *dtype)
    if fresh:
        _check_current_device(device)
        _checked_operators[form] = tuple(weakref.ref(op[1]) for op in ops)
    return sizes


def step_ustar(F1u, F1p, A1Z, rho, k1, u, p, c) -> torch.Tensor:
    """u* = F1u u + F1p p - rho A1Z c + k1 in one launch, f32 on CUDA; rho
    is a 0-d tensor, read on the device."""
    if not (u.is_cuda or F1u.is_cuda):
        return step_ustar_reference(F1u, F1p, A1Z, rho, k1, u, p, c)
    n = _check_group(
        "ustar",
        (("F1u", F1u, ("nu", "nu")), ("F1p", F1p, ("nu", "np")),
         ("A1Z", A1Z, ("nu", "nu")), ("rho", rho, ()), ("k1", k1, ("nu",))),
        (("u", u, ("nu",)), ("p", p, ("np",)), ("c", c, ("nu",))),
        ("nu", "np", "nu"),
    )
    out = torch.empty(n["nu"], dtype=torch.float32, device=u.device)
    err = _lib().step_ustar_f32(
        F1u.data_ptr(), F1p.data_ptr(), A1Z.data_ptr(), u.data_ptr(), p.data_ptr(),
        c.data_ptr(), rho.data_ptr(), k1.data_ptr(), out.data_ptr(), n["nu"], n["np"],
        _stream(u),
    )
    _raise_on(err, "step_ustar_f32")
    step_ustar.launches += 1
    return out


def step_pressure(F2p, F2u, k2, p, u_star) -> tuple[torch.Tensor, torch.Tensor]:
    """(p', p' - p) with p' = F2p p + F2u u* + k2, in one launch, f32 on
    CUDA."""
    if not (p.is_cuda or F2p.is_cuda):
        return step_pressure_reference(F2p, F2u, k2, p, u_star)
    n = _check_group(
        "pressure",
        (("F2p", F2p, ("np", "np")), ("F2u", F2u, ("np", "nu")), ("k2", k2, ("np",))),
        (("p", p, ("np",)), ("u_star", u_star, ("nu",))),
        ("np", "nu"),
    )
    p_new = torch.empty(n["np"], dtype=torch.float32, device=p.device)
    dp = torch.empty_like(p_new)
    err = _lib().step_pressure_f32(
        F2p.data_ptr(), F2u.data_ptr(), p.data_ptr(), u_star.data_ptr(), k2.data_ptr(),
        p_new.data_ptr(), dp.data_ptr(), n["np"], n["nu"], _stream(p),
    )
    _raise_on(err, "step_pressure_f32")
    step_pressure.launches += 1
    return p_new, dp


def step_velocity(F3s, F3p, k3, u_star, dp) -> torch.Tensor:
    """u' = [F3s u*_x + F3p[0] dp; F3s u*_y + F3p[1] dp] + k3 in one
    launch, f32 on CUDA; F3p is (2, Ns, Np)."""
    if not (u_star.is_cuda or F3s.is_cuda):
        return step_velocity_reference(F3s, F3p, k3, u_star, dp)
    n = _check_group(
        "velocity",
        (("F3s", F3s, ("ns", "ns")), ("F3p", F3p, (2, "ns", "np")),
         ("k3", k3, ("nu",))),
        (("u_star", u_star, ("nu",)), ("dp", dp, ("np",))),
        ("ns", "ns", "np"),
    )
    if n["nu"] != 2 * n["ns"]:
        raise ValueError(f"u* and k3 have {n['nu']} entries, not 2 Ns = {2 * n['ns']}")
    out = torch.empty(n["nu"], dtype=torch.float32, device=u_star.device)
    err = _lib().step_velocity_f32(
        F3s.data_ptr(), F3p.data_ptr(), u_star.data_ptr(), dp.data_ptr(), k3.data_ptr(),
        out.data_ptr(), n["ns"], n["np"], _stream(u_star),
    )
    _raise_on(err, "step_velocity_f32")
    step_velocity.launches += 1
    return out


# --------------------------------------------------------------------------
# The split form: the 'df32' step (solver/fused.py fused_step_df32) in three
# launches.  Each operator is an f32 high limb and a bf16 low limb, each
# vector constant an f32 high and low limb.  The plain versions compute the
# JAX package's expression: the high part through step_*_reference (its
# products through `apply`), the low products as `_mml`.
# --------------------------------------------------------------------------


def _mml(m_lo: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A bf16 low limb times x rounded to bf16, summed in f32: the JAX
    step's `mml`.  The product of two bf16 values is exact in f32."""
    return m_lo.float() @ x.bfloat16().float()


def step_ustar_df32_reference(F1u, F1p, A1Z, rho, k1, L1u, L1p, LA1Z, l1, u, p, c,
                              apply=matvec_reference):
    """Plain version of `step_ustar_df32`: u_hi + (((L1u b(u) + L1p b(p)) -
    rho LA1Z b(c)) + l1), u_hi = step_ustar_reference(...)."""
    u_hi = step_ustar_reference(F1u, F1p, A1Z, rho, k1, u, p, c, apply=apply)
    return u_hi + (_mml(L1u, u) + _mml(L1p, p) - rho * _mml(LA1Z, c) + l1)


def step_pressure_df32_reference(F2p, F2u, k2, L2p, L2u, l2, p, u_star,
                                 apply=matvec_reference):
    """Plain version of `step_pressure_df32`: (p', p' - p) with p' = p_hi +
    ((L2p b(p) + L2u b(u*)) + l2)."""
    p_hi, _ = step_pressure_reference(F2p, F2u, k2, p, u_star, apply=apply)
    p_new = p_hi + (_mml(L2p, p) + _mml(L2u, u_star) + l2)
    return p_new, p_new - p


def step_velocity_df32_reference(F3s, F3p, k3, L3s, L3p, l3, u_star, dp,
                                 apply=matvec_reference):
    """Plain version of `step_velocity_df32`: y = F3s u* + F3p dp (the
    (Ns, 2) stack), plus the same through the low limbs on b(u*) and b(dp),
    then + k3 + l3."""
    ns = F3s.shape[0]
    ustack = torch.stack([u_star[:ns], u_star[ns:]], dim=1)  # (Ns, 2)
    y = apply(F3s, ustack) + apply(F3p.view(2 * ns, -1), dp).view(2, ns).T
    y_lo = _mml(L3s, ustack) + _mml(L3p.view(2 * ns, -1), dp).view(2, ns).T
    y = y + y_lo
    return torch.cat([y[:, 0], y[:, 1]]) + k3 + l3


_BF16 = torch.bfloat16


def step_ustar_df32(F1u, F1p, A1Z, rho, k1, L1u, L1p, LA1Z, l1, u, p, c) -> torch.Tensor:
    """`step_ustar` with low limbs (L1u, L1p, LA1Z bf16, l1 f32) in one
    launch on CUDA."""
    if not (u.is_cuda or F1u.is_cuda):
        return step_ustar_df32_reference(F1u, F1p, A1Z, rho, k1, L1u, L1p, LA1Z, l1,
                                         u, p, c)
    n = _check_group(
        "ustar_df32",
        (("F1u", F1u, ("nu", "nu")), ("F1p", F1p, ("nu", "np")),
         ("A1Z", A1Z, ("nu", "nu")), ("rho", rho, ()), ("k1", k1, ("nu",)),
         ("L1u", L1u, ("nu", "nu"), _BF16), ("L1p", L1p, ("nu", "np"), _BF16),
         ("LA1Z", LA1Z, ("nu", "nu"), _BF16), ("l1", l1, ("nu",))),
        (("u", u, ("nu",)), ("p", p, ("np",)), ("c", c, ("nu",))),
        ("nu", "np", "nu") * 2,
    )
    out = torch.empty(n["nu"], dtype=torch.float32, device=u.device)
    err = _lib().step_ustar_df32(
        F1u.data_ptr(), F1p.data_ptr(), A1Z.data_ptr(), L1u.data_ptr(), L1p.data_ptr(),
        LA1Z.data_ptr(), u.data_ptr(), p.data_ptr(), c.data_ptr(), rho.data_ptr(),
        k1.data_ptr(), l1.data_ptr(), out.data_ptr(), n["nu"], n["np"], _stream(u),
    )
    _raise_on(err, "step_ustar_df32")
    step_ustar_df32.launches += 1
    return out


def step_pressure_df32(F2p, F2u, k2, L2p, L2u, l2, p, u_star):
    """`step_pressure` with low limbs (L2p, L2u bf16, l2 f32) in one launch
    on CUDA; returns (p', p' - p)."""
    if not (p.is_cuda or F2p.is_cuda):
        return step_pressure_df32_reference(F2p, F2u, k2, L2p, L2u, l2, p, u_star)
    n = _check_group(
        "pressure_df32",
        (("F2p", F2p, ("np", "np")), ("F2u", F2u, ("np", "nu")), ("k2", k2, ("np",)),
         ("L2p", L2p, ("np", "np"), _BF16), ("L2u", L2u, ("np", "nu"), _BF16),
         ("l2", l2, ("np",))),
        (("p", p, ("np",)), ("u_star", u_star, ("nu",))),
        ("np", "nu") * 2,
    )
    p_new = torch.empty(n["np"], dtype=torch.float32, device=p.device)
    dp = torch.empty_like(p_new)
    err = _lib().step_pressure_df32(
        F2p.data_ptr(), F2u.data_ptr(), L2p.data_ptr(), L2u.data_ptr(), p.data_ptr(),
        u_star.data_ptr(), k2.data_ptr(), l2.data_ptr(), p_new.data_ptr(),
        dp.data_ptr(), n["np"], n["nu"], _stream(p),
    )
    _raise_on(err, "step_pressure_df32")
    step_pressure_df32.launches += 1
    return p_new, dp


def step_velocity_df32(F3s, F3p, k3, L3s, L3p, l3, u_star, dp) -> torch.Tensor:
    """`step_velocity` with low limbs (L3s, L3p bf16, l3 f32) in one launch
    on CUDA; F3p and L3p are (2, Ns, Np)."""
    if not (u_star.is_cuda or F3s.is_cuda):
        return step_velocity_df32_reference(F3s, F3p, k3, L3s, L3p, l3, u_star, dp)
    n = _check_group(
        "velocity_df32",
        (("F3s", F3s, ("ns", "ns")), ("F3p", F3p, (2, "ns", "np")),
         ("k3", k3, ("nu",)), ("L3s", L3s, ("ns", "ns"), _BF16),
         ("L3p", L3p, (2, "ns", "np"), _BF16), ("l3", l3, ("nu",))),
        (("u_star", u_star, ("nu",)), ("dp", dp, ("np",))),
        ("ns", "ns", "np") * 2,
    )
    if n["nu"] != 2 * n["ns"]:
        raise ValueError(f"u* and k3 have {n['nu']} entries, not 2 Ns = {2 * n['ns']}")
    out = torch.empty(n["nu"], dtype=torch.float32, device=u_star.device)
    err = _lib().step_velocity_df32(
        F3s.data_ptr(), F3p.data_ptr(), L3s.data_ptr(), L3p.data_ptr(),
        u_star.data_ptr(), dp.data_ptr(), k3.data_ptr(), l3.data_ptr(),
        out.data_ptr(), n["ns"], n["np"], _stream(u_star),
    )
    _raise_on(err, "step_velocity_df32")
    step_velocity_df32.launches += 1
    return out


matvec.launches = 0
matvec_dual.launches = 0
step_ustar.launches = 0
step_pressure.launches = 0
step_velocity.launches = 0
step_ustar_df32.launches = 0
step_pressure_df32.launches = 0
step_velocity_df32.launches = 0

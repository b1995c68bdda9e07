"""Bytes and floating-point operations of one fused IPCS step.

The least a step can move is the seven dense operators of the fused
algebra at their unpadded float32 sizes and the step's vectors, each read
or written once.  Ns is the scalar P2 dof count (vertices plus edges) and
Np the pressure dof count (vertices) of the mesh; neither padding nor how
the program stores its operators enters.  Operations: one multiply and one
add per operator entry.  The convection term's cell tables (about 1.6 MB at
the largest mesh here) and its operations are left out, so the bound is, if
anything, low: a share of it reads low, never above 100%.
"""
from __future__ import annotations

F32 = 4


def operator_entries(ns: int, npr: int) -> dict:
    """Entries of the seven operators by name."""
    nu = 2 * ns
    return {"F1u": nu * nu, "A1Z": nu * nu, "F1p": nu * npr, "F2p": npr * npr,
            "F2u": npr * nu, "F3s": ns * ns, "F3p": nu * npr}


def kernel_vectors(ns: int, npr: int) -> int:
    """Vector entries the step's three grouped launches read or write once:
    u*: u, p, c, k1 in, u* out; p': p, u*, k2 in, p', p' - p out;
    u': u*, p' - p, k3 in, u' out."""
    nu = 2 * ns
    return (4 * nu + npr + nu) + (2 * npr + nu + 2 * npr) + (2 * nu + npr + nu)


def kernel_counts(ns: int, npr: int) -> tuple[int, int]:
    """(bytes, operations) of the grouped launches of one step."""
    entries = sum(operator_entries(ns, npr).values())
    return F32 * (entries + kernel_vectors(ns, npr)), 2 * entries


def step_counts(ns: int, npr: int) -> tuple[int, int]:
    """(bytes, operations) of one whole step: the launches, and the drag and
    lift functionals read against the new state (four vectors, two dots)."""
    b, ops = kernel_counts(ns, npr)
    probes = 2 * (2 * ns + npr)
    return b + F32 * probes, ops + 2 * probes


def least_seconds(nbytes: int, ops: int, peaks: dict) -> float:
    """The least time at the chip's peaks: the larger of bytes over the
    memory bandwidth and operations over the float32 rate."""
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["f32_flops_per_s"])

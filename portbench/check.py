"""The comparison that decides `correct`: a solve of the program against the
plain reference's solve from the same initial velocity.

Per flow of a compared solve, three numbers, each a widest gap:

- drag_gap: the largest |drag - reference drag| over every step of the
  solve, over the largest |reference drag| of the solve;
- lift_gap: the same for the lift;
- state_gap: the larger of ||u - u_ref|| / ||u_ref|| and ||p - p_ref|| /
  ||p_ref|| of the final state, over the program's whole padded vectors,
  the reference's embedded with zeros, so that padding that is not exactly
  zero counts too.

A run reads the largest of each over its compared solves and flows.
"""
from __future__ import annotations

import numpy as np

NUMBERS = ("drag_gap", "lift_gap", "state_gap")
FAILED_READING = 1e300


def embed_u(u: np.ndarray, n: int) -> np.ndarray:
    """A velocity [x (ns) | y (ns)] in the program's layout of length n:
    [x | 0 | y | 0] in blocks of n / 2."""
    ns, block = len(u) // 2, n // 2
    out = np.zeros(n)
    out[:ns], out[block:block + ns] = u[:ns], u[ns:]
    return out


def gaps(program, reference) -> dict:
    """The three numbers of one flow.  program: (drags (steps,), lifts,
    u (padded), p (padded)); reference: (drags, lifts, u (2Ns,), p (Np,))."""
    d, l, u, p = (np.asarray(a, dtype=np.float64) for a in program)
    rd, rl, ru, rp = (np.asarray(a, dtype=np.float64) for a in reference)
    pe = np.zeros(len(p))
    pe[:len(rp)] = rp
    ue = embed_u(ru, len(u))
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    out = {
        "drag_gap": float(np.max(np.abs(d - rd)) / np.max(np.abs(rd))),
        "lift_gap": float(np.max(np.abs(l - rl)) / np.max(np.abs(rl))),
        "state_gap": max(rel(u, ue), rel(p, pe)),
    }
    # A non-finite reading is a failed comparison, never a pass; it reads
    # as FAILED_READING, which JSON can carry.
    return {k: (v if np.isfinite(v) else FAILED_READING) for k, v in out.items()}


def worst(readings) -> dict:
    """The largest of each number over several flows' readings."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct when every number is
    at or under its limit."""
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in NUMBERS}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks

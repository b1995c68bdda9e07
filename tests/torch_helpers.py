"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

Every mesh comes from tracked files: the ys930 pack mesh (already smoothed)
and a small airfoil mesh generated from its airfoil ring by the JAX
package's generator (482 vertices, 2Ns = 3556, Np = 482).  Data crosses
between the packages as numpy arrays.
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PACK_YS930 = REPO / "checkpoints" / "ys930_results" / "ground_truth.npz"
CACHE_YS930_100 = REPO / "tests" / "_cache" / "ys930_gt_100steps.npz"

# The suite runs in six pytest workers on one host; two torch threads each
# keeps them from oversubscribing it.
TORCH_THREADS = 2


def cap_threads():
    torch.set_num_threads(TORCH_THREADS)


@functools.lru_cache(maxsize=None)
def pack_mesh_arrays() -> tuple[np.ndarray, np.ndarray]:
    z = np.load(PACK_YS930)
    return z["coords"], z["cells"]


@functools.lru_cache(maxsize=None)
def small_mesh_arrays() -> tuple[np.ndarray, np.ndarray]:
    from meshdqn_tpu.mesh import TriMesh, airfoil_polyline
    from meshdqn_tpu.mesh.generate import generate_channel_mesh

    ring = airfoil_polyline(TriMesh(*pack_mesh_arrays()))
    mesh = generate_channel_mesh(ring, 0.3)
    return mesh.coords, mesh.cells


def jax_mesh(arrays):
    from meshdqn_tpu.mesh import TriMesh

    return TriMesh(*arrays)


def port_mesh(arrays):
    from meshdqn_tpu_torch.mesh import TriMesh

    return TriMesh(*arrays)


def rel(a, b) -> float:
    """Norm-relative difference of a from b, in f64."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))

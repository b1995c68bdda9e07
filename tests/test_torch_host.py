"""The port's host layers against meshdqn_tpu's, and its import hygiene.

mesh/, fem/ and probes.py are numpy copies, so everything they build must be
bit-equal to the JAX package's on the same mesh: no tolerance.
"""
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import meshdqn_tpu.fem as jfem
import meshdqn_tpu.mesh as jmesh
import meshdqn_tpu.probes as jprobes
import meshdqn_tpu_torch.fem as tfem
import meshdqn_tpu_torch.mesh as tmesh
import meshdqn_tpu_torch.probes as tprobes
from tests.torch_helpers import (
    REPO, cap_threads, jax_mesh, pack_mesh_arrays, port_mesh, small_mesh_arrays,
)

cap_threads()

MESHES = {"small": small_mesh_arrays, "ys930_pack": pack_mesh_arrays}
MU, RHO, DT = 1e-3, 1.0, 1e-3


@pytest.fixture(scope="module", params=sorted(MESHES))
def pair(request):
    arrays = MESHES[request.param]()
    jm, tm = jax_mesh(arrays), port_mesh(arrays)
    return jm, jmesh.mark_boundaries(jm), tm, tmesh.mark_boundaries(tm)


def assert_csr_equal(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


class TestMeshAndMarkers:
    def test_topology_bit_equal(self, pair):
        jm, _, tm, _ = pair
        for name in ("coords", "cells", "edges", "cell_edges", "boundary_facets",
                     "facet_cells", "facet_local", "boundary_vertex_mask"):
            np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
        np.testing.assert_array_equal(tm.facet_normals(), jm.facet_normals())

    def test_markers_bit_equal(self, pair):
        _, jmk, _, tmk = pair
        np.testing.assert_array_equal(tmk.markers, jmk.markers)
        assert sorted(tmk.hits) == sorted(jmk.hits)
        for tag in jmk.hits:
            np.testing.assert_array_equal(tmk.hits[tag], jmk.hits[tag])

    def test_airfoil_polyline_bit_equal(self, pair):
        jm, _, tm, _ = pair
        np.testing.assert_array_equal(tmesh.airfoil_polyline(tm),
                                      jmesh.airfoil_polyline(jm))


class TestAssembly:
    def test_operators_and_bcs_bit_equal(self, pair):
        jm, jmk, tm, tmk = pair
        jo = jfem.assemble_operators(jm, jmk, MU, RHO, DT)
        to = tfem.assemble_operators(tm, tmk, MU, RHO, DT)
        for name in ("M", "Kv", "S", "B", "Bn", "Kp", "G", "A1", "R1"):
            assert_csr_equal(getattr(to, name), getattr(jo, name))
        for name in ("u_bc_mask", "u_bc_values", "p_bc_mask", "p_bc_values"):
            np.testing.assert_array_equal(getattr(to, name), getattr(jo, name))
        assert_csr_equal(tfem.apply_bc_symmetric(to.A1, to.u_bc_mask),
                         jfem.apply_bc_symmetric(jo.A1, jo.u_bc_mask))
        assert_csr_equal(tfem.apply_bc_symmetric(to.A2, to.p_bc_mask),
                         jfem.apply_bc_symmetric(jo.A2, jo.p_bc_mask))

    def test_cell_jacobians_bit_equal(self, pair):
        jm, _, tm, _ = pair
        for a, b in zip(tfem.cell_jacobians(tm), jfem.cell_jacobians(jm)):
            np.testing.assert_array_equal(a, b)


class TestProbes:
    @pytest.mark.parametrize("kind", ["drag", "lift"])
    def test_force_probe_bit_equal(self, pair, kind):
        jm, jmk, tm, tmk = pair
        jp = getattr(jprobes, f"{kind}_probe")(jm, jmk, MU)
        tp = getattr(tprobes, f"{kind}_probe")(tm, tmk, MU)
        np.testing.assert_array_equal(tp.d_u, jp.d_u)
        np.testing.assert_array_equal(tp.d_p, jp.d_p)

    def test_penetrated_probe_samples_equal(self, pair):
        jm, jmk, tm, tmk = pair
        jp = jprobes.penetrated_drag_probe(jm, jmk, MU, RHO)
        tp = tprobes.penetrated_drag_probe(tm, tmk, MU, RHO)
        rng = np.random.default_rng(0)
        u = rng.standard_normal(len(jp.base.d_u))
        p = rng.standard_normal(len(jp.base.d_p))
        assert tp.sample(u, p) == jp.sample(u, p)


_IMPORT_ALL = """
import importlib, pkgutil, sys
import meshdqn_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "meshdqn_tpu"
             or n.startswith("meshdqn_tpu."))
print(len([n for n in sys.modules if n.startswith("meshdqn_tpu_torch")]), bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, check=True, timeout=120,
    ).stdout.split(maxsplit=1)
    assert int(out[0]) >= 10  # every submodule was imported
    assert out[1].strip() == "[]"

"""The CG cell's counts: the nonzeros that portbench/counts/cg_banded.py
carries are those of the frozen meshes' operators, assembled again by the
plain reference; its iteration counts are the configuration's; a step
makes 18 banded products; a mesh not in its table reads None."""
import json

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import ROOT

CONFIG = json.loads((ROOT / "portbench/configs/ys930_finest.json").read_text())
MESHES = [CONFIG["mesh_sets"]["finest"]["meshes"][0]["file"],
          "meshdqn_tpu_torch/data/ys930_0.25000_gen.npz"]  # the CPU tests' banded mesh


def nonzeros(A) -> int:
    A = sp.csr_matrix(A, copy=True)
    A.sum_duplicates()
    A.eliminate_zeros()
    return int(A.nnz)


def eliminated(A, mask):
    """Z A Z + I on the Dirichlet dofs, as the reference eliminates them."""
    z = sp.diags((~mask).astype(np.float64))
    return (z @ A @ z + sp.diags(mask.astype(np.float64))).tocsr()


@pytest.mark.parametrize("mesh_file", MESHES)
def test_nonzeros_are_the_reference_operators(mesh_file):
    from portbench.counts.cg_banded import NONZEROS
    from portbench.reference.fem import Mesh, assemble

    flow = CONFIG["flow"]
    with np.load(ROOT / mesh_file) as z:
        mesh = Mesh(z["coords"], z["cells"])
    ops = assemble(mesh, flow["mu"])
    ns = mesh.ns
    k = flow["rho"] / flow["dt"]
    A1 = k * ops.M + 0.5 * ops.Kv - 0.5 * ops.S
    R1 = k * ops.M - 0.5 * ops.Kv + 0.5 * ops.S
    Ms = ops.M[:ns, :ns]
    assert NONZEROS[ns, mesh.nv] == {
        "A1": nonzeros(eliminated(A1, ops.u_mask)), "R1": nonzeros(R1),
        "P1m": nonzeros(ops.B - ops.Bn), "BT": nonzeros(ops.B.T), "Ms": nonzeros(Ms),
        "A3": nonzeros(eliminated(Ms, ops.u_mask[:ns])), "G": nonzeros(ops.G),
        "Kp": nonzeros(ops.Kp), "A2": nonzeros(eliminated(ops.Kp, ops.p_mask))}


def test_iterations_and_blocks_are_the_configurations():
    from portbench.counts import cg_banded as c

    solver = CONFIG["mesh_sets"]["finest"]["solver"]
    assert (c.ITERS_U, c.ITERS_M, c.BLOCK, c.REFINE) == (
        solver["cg_iters_u"], solver["cg_iters_m"], solver["cg_block_size"],
        solver["cg_pressure_refine"])
    assert solver["cg_precond"] == "block" and solver["cg_layout"] == "banded"


def test_eighteen_banded_products_and_unknown_meshes():
    from portbench.counts import cg_banded as c

    assert sum(n for *_, n in c.banded_products(14884, 3796)) == 18
    nbytes, ops = c.kernel_counts(14884, 3796)
    # The nonzeros' values and the products' vectors, in float32.
    assert round(nbytes / 1e6, 1) == 30.9 and ops == 15750990
    step_bytes, step_ops = c.step_counts(14884, 3796)
    assert round(step_bytes / 1e6, 1) == 310.7 and step_ops > ops
    assert c.kernel_counts(14884, 3795) is None and c.step_counts(1, 1) is None

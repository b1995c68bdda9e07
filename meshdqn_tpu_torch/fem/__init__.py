from .reference import (
    dunavant_6,
    gauss_legendre_1d,
    p1_basis,
    p1_grads,
    p2_basis,
    p2_grads,
    facet_points,
    LOCAL_EDGES,
)
from .spaces import P1Space, P2Space, VectorP2Space
from .assembly import (
    Operators,
    assemble_operators,
    apply_bc_symmetric,
    cell_jacobians,
    constant_inflow_profile,
    velocity_bc,
    pressure_bc,
)

__all__ = [
    "dunavant_6",
    "gauss_legendre_1d",
    "p1_basis",
    "p1_grads",
    "p2_basis",
    "p2_grads",
    "facet_points",
    "LOCAL_EDGES",
    "P1Space",
    "P2Space",
    "VectorP2Space",
    "Operators",
    "assemble_operators",
    "apply_bc_symmetric",
    "cell_jacobians",
    "constant_inflow_profile",
    "velocity_bc",
    "pressure_bc",
]

from .fused import FlowState, FusedOperators, compose_fused, fused_step
from .ipcs import (
    BandedCGOperators,
    CGOperators,
    IPCSConfig,
    IPCSSolver,
    build_cg_operators,
    build_fused_operators,
    evolve_cg_n,
    ipcs_step_cg,
    ipcs_step_cg_banded,
)

__all__ = [
    "BandedCGOperators",
    "CGOperators",
    "FlowState",
    "FusedOperators",
    "IPCSConfig",
    "IPCSSolver",
    "build_cg_operators",
    "build_fused_operators",
    "compose_fused",
    "evolve_cg_n",
    "fused_step",
    "ipcs_step_cg",
    "ipcs_step_cg_banded",
]

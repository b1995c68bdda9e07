from .fused import FlowState, FusedOperators, compose_fused, fused_step
from .ipcs import IPCSConfig, IPCSSolver, build_fused_operators

__all__ = [
    "FlowState",
    "FusedOperators",
    "IPCSConfig",
    "IPCSSolver",
    "build_fused_operators",
    "compose_fused",
    "fused_step",
]

from .layers import (
    gcn_conv,
    gcn_init,
    global_max_pool,
    global_mean_pool,
    linear,
    linear_init,
    sage_conv,
    sage_init,
    topk_init,
    topk_pool,
)
from .noderemoval import batched_forward, forward, init_params, stage_sizes

__all__ = [
    "gcn_conv",
    "gcn_init",
    "global_max_pool",
    "global_mean_pool",
    "linear",
    "linear_init",
    "sage_conv",
    "sage_init",
    "topk_init",
    "topk_pool",
    "batched_forward",
    "forward",
    "init_params",
    "stage_sizes",
]

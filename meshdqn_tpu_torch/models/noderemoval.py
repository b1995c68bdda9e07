"""NodeRemovalNet — the double-DQN Q-network over mesh graphs.

The port of meshdqn_tpu/models/noderemoval.py (the Q-network; the drag
surrogate is not ported yet).  Architecture replicated from the reference
(airfoilgcnn.py:24-145), active blocks only:

    SAGE(F->w) -> ReLU -> TopK(r) -> [gmp || gap] -> x1
    SAGE(w->w) -> ReLU -> TopK(r) -> [gmp || gap] -> x2
    GCN(w->w)  -> ReLU -> TopK(r) -> [gmp || gap] -> x4
    GCN(w->w)  -> ReLU -> TopK(r) -> [gmp || gap] -> x5
    x = x1+x2+x4+x5 -> Linear(2w,128) -> ReLU -> Linear(128,64) -> ReLU
      -> Linear(64, A) -> softmax (reference quirk) or raw ('linear' head)

The pooling cascade runs on static padded sizes ceil(r*N), ceil(r*ceil(r*N)),
... while the valid count follows PyG's ceil(ratio * n_valid) per graph.
Parameters are a dict of dicts of tensors keyed as the JAX package's tree
(convert.noderemoval_params_from_numpy builds it from trained weights).
"""
from __future__ import annotations

import math

import torch

from ..env.graph import GraphState
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


def stage_sizes(n_nodes: int, ratio: float, n_stages: int = 4) -> list[int]:
    sizes = []
    n = n_nodes
    for _ in range(n_stages):
        n = max(int(math.ceil(ratio * n)), 1)
        sizes.append(n)
    return sizes


def init_params(seed, in_dim: int, output_dim: int, conv_width: int = 64,
                device=None):
    """Random parameters of the JAX package's shapes and init scheme (all
    weights xavier-normal gain 0.9, biases standard normal, GCN biases
    zero), drawn from `seed`: a CPU torch.Generator, whose stream the draws
    advance (so two calls give two nets), or an int to seed a fresh one.
    The same distribution as `meshdqn_tpu.models.init_params`, not the same
    draws."""
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator(device="cpu").manual_seed(seed))
    w = conv_width
    params = {
        "conv1": sage_init(gen, in_dim, w),
        "pool1": topk_init(gen, w),
        "conv2": sage_init(gen, w, w),
        "pool2": topk_init(gen, w),
        "conv4": gcn_init(gen, w, w),
        "pool4": topk_init(gen, w),
        "conv5": gcn_init(gen, w, w),
        "pool5": topk_init(gen, w),
        "lin1": linear_init(gen, 2 * w, 128),
        "lin2": linear_init(gen, 128, 64),
        "lin3": linear_init(gen, 64, output_dim),
    }
    return {k: {n: t.to(device) for n, t in v.items()} for k, v in params.items()}


def params_device(params) -> torch.device:
    return params["lin3"]["w"].device


def _q_network(params, x, ei, em, nm, topk, embedding, head):
    """The network on one graph (x (N, F)) or a batch (x (B, N, F))."""
    k1, k2, k4, k5 = stage_sizes(x.shape[-2], topk)

    def block(conv_fn, cparams, pparams, x, ei, em, nm, k_static):
        h = torch.relu(conv_fn(cparams, x, ei, em, nm))
        pg = topk_pool(pparams, h, ei, em, nm, topk, k_static)
        read = torch.cat([global_max_pool(pg.x, pg.node_mask),
                          global_mean_pool(pg.x, pg.node_mask)], dim=-1)
        return pg, read

    pg, x1 = block(sage_conv, params["conv1"], params["pool1"], x, ei, em, nm, k1)
    pg, x2 = block(sage_conv, params["conv2"], params["pool2"], *pg, k2)
    pg, x4 = block(gcn_conv, params["conv4"], params["pool4"], *pg, k4)
    pg, x5 = block(gcn_conv, params["conv5"], params["pool5"], *pg, k5)

    h = x1 + x2 + x4 + x5  # (..., 2w)
    if embedding:
        return h
    h = torch.relu(linear(params["lin1"], h))
    h = torch.relu(linear(params["lin2"], h))
    h = linear(params["lin3"], h)
    if head == "softmax":
        return torch.softmax(h, dim=-1)
    return h


def forward(params, g: GraphState, topk: float = 0.5, embedding: bool = False,
            head: str = "softmax"):
    """Single-graph forward pass -> (A,) action values, on the parameters'
    device (the graph's tensors are moved there).

    head='softmax' reproduces the reference quirk (softmax over Q-values,
    airfoilgcnn.py:143); head='linear' returns the raw Q-values.  Greedy
    argmax is the same under both.  The features are cast to the
    parameters' dtype, as in batched_forward."""
    device = params_device(params)
    x = g.x.to(device=device, dtype=params["lin3"]["w"].dtype)
    return _q_network(params, x, g.edge_index.to(device),
                      g.edge_mask.to(device), g.node_mask.to(device), topk,
                      embedding, head)


def batched_forward(params, graphs: GraphState, topk: float = 0.5,
                    head: str = "softmax"):
    """graphs: a GraphState with a leading batch axis on every tensor ->
    (B, A), in one pass of batched kernels (the JAX package vmaps `forward`).

    The features are cast to the parameters' dtype (f32 in training; f64
    parameters give the exact evaluation the parity tests hold f32 to)."""
    device = params_device(params)
    x = graphs.x.to(device=device, dtype=params["lin3"]["w"].dtype)
    return _q_network(params, x, graphs.edge_index.to(device),
                      graphs.edge_mask.to(device), graphs.node_mask.to(device),
                      topk, False, head)

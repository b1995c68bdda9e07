"""Graph layers on padded graphs: SAGEConv, GCNConv, TopKPooling, pools.

The port of meshdqn_tpu/models/layers.py: plain functions over parameter
dicts of tensors, on static shapes — every graph carries a node mask and an
edge mask instead of a dynamic node count, so no call waits on the device.
Each layer takes one graph or a batch of them: a leading batch axis on
every tensor (x (B, N, F), edge_index (B, 2, E), masks (B, N) and (B, E))
is carried through, so a batch runs as one set of batched kernels where the
JAX package vmaps the single-graph layer.  On one graph the batched code
issues the same kernels as a single-graph layer would.

Semantics matched to PyG (and to the JAX package bit for bit in exact
arithmetic):
* SAGEConv:   out_i = W_l . mean_{j->i} x_j + b_l + W_r . x_i
* GCNConv:    self-loops added, symmetric deg^{-1/2} normalization, bias
              added post-aggregation
* TopKPooling: score_i = (x_i . w)/||w||; keep the top ceil(ratio * n_valid)
              valid nodes, ties to the lower index (as `jax.lax.top_k`);
              gate kept features by tanh(score); re-index surviving edges
* global max/mean pool over valid nodes; the max splits its gradient evenly
  among equal maxima, as JAX's reduce_max does (`amax`, not `max(dim)`)

The aggregation is the JAX package's dense formulation: the adjacency with
edge multiplicity (A[i, j] = #edges j->i, exact small integer counts in
f32, from one-hot products) times the features, one f32 matmul.  Gathers
and scatters go through torch.gather / scatter_, whose backward passes make
no host sync on CUDA (an indexed read's backward accumulates through
index_put_, which does).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


# ----------------------------------------------------------------------
# Initialisers (torch parity with the reference, airfoilgcnn.py:50-76)
# ----------------------------------------------------------------------

def xavier_normal(gen, shape, gain=0.9, device=None):
    """std = gain * sqrt(2/(fan_in+fan_out)), shape (fan_out, fan_in)."""
    fan_out, fan_in = shape[0], shape[1]
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=gen, device=device)


def std_normal(gen, shape, device=None):
    return torch.randn(shape, generator=gen, device=device)


def sage_init(gen, in_dim, out_dim, device=None):
    return {
        "lin_l_w": xavier_normal(gen, (out_dim, in_dim), device=device),
        "lin_l_b": std_normal(gen, (out_dim,), device=device),
        "lin_r_w": xavier_normal(gen, (out_dim, in_dim), device=device),
    }


def gcn_init(gen, in_dim, out_dim, device=None):
    return {
        "w": xavier_normal(gen, (out_dim, in_dim), device=device),
        "b": torch.zeros(out_dim, device=device),  # PyG zeros init
    }


def topk_init(gen, in_dim, device=None):
    return {"w": xavier_normal(gen, (1, in_dim), gain=1.0, device=device)[0]}


def linear_init(gen, in_dim, out_dim, bias_normal=True, device=None):
    return {
        "w": xavier_normal(gen, (out_dim, in_dim), device=device),
        "b": (std_normal(gen, (out_dim,), device=device) if bias_normal
              else torch.zeros(out_dim, device=device)),
    }


# ----------------------------------------------------------------------
# Message passing
# ----------------------------------------------------------------------

def _onehot(ids, mask, n_nodes, dtype):
    """(..., K, N) one-hot rows selecting node ids (masked rows are zero)."""
    r = torch.arange(n_nodes, device=ids.device)
    return ((ids.long()[..., None] == r) & mask[..., None]).to(dtype)


def _adjacency(edge_index, edge_mask, n_nodes, dtype):
    """(..., N, N) adjacency with edge multiplicity over the valid edges,
    A[i, j] = #edges j->i, as the product of the destination and source
    one-hot matrices (sums of 0/1 products: exact in f32, whatever the
    order; and no host sync, which an accumulating index_put makes on
    CUDA)."""
    src_oh = _onehot(edge_index[..., 0, :], edge_mask, n_nodes, dtype)
    dst_oh = _onehot(edge_index[..., 1, :], edge_mask, n_nodes, dtype)
    return dst_oh.transpose(-2, -1) @ src_oh


def sage_conv(params, x, edge_index, edge_mask, node_mask):
    """x: (..., N, F); edge_index: (..., 2, E) src->dst; masks bool."""
    adj = _adjacency(edge_index, edge_mask, x.shape[-2], x.dtype)
    summed = adj @ x
    count = adj.sum(dim=-1)
    mean = summed / torch.clamp(count, min=1.0)[..., None]
    out = mean @ params["lin_l_w"].T + params["lin_l_b"] + x @ params["lin_r_w"].T
    return out * node_mask[..., None].to(x.dtype)


def gcn_conv(params, x, edge_index, edge_mask, node_mask):
    nm = node_mask.to(x.dtype)
    adj = _adjacency(edge_index, edge_mask, x.shape[-2], x.dtype)
    deg = adj.sum(dim=-1) + nm  # self-loops on valid nodes
    dinv = torch.where(deg > 0, torch.rsqrt(deg), torch.zeros_like(deg))
    norm_adj = adj * dinv[..., :, None] * dinv[..., None, :]
    agg = norm_adj @ x
    agg = agg + x * (dinv * dinv * nm)[..., None]  # self-loop term
    out = agg @ params["w"].T + params["b"]
    return out * nm[..., None]


# ----------------------------------------------------------------------
# TopKPooling
# ----------------------------------------------------------------------

class PooledGraph(NamedTuple):
    x: torch.Tensor
    edge_index: torch.Tensor
    edge_mask: torch.Tensor
    node_mask: torch.Tensor


def topk_pool(params, x, edge_index, edge_mask, node_mask, ratio: float, k_static: int):
    """Select the top ceil(ratio * n_valid) of each graph's valid nodes; a
    graph padded to k_static nodes (static shape)."""
    w = params["w"]
    score = (x @ w) / torch.clamp(torch.linalg.vector_norm(w), min=1e-12)  # (..., N)
    score = torch.where(node_mask, score, torch.full_like(score, -math.inf))

    # ceil in f64, as the JAX package computes it under x64.
    n_valid = node_mask.sum(dim=-1).to(torch.float64)
    k_dyn = torch.clamp(torch.ceil(ratio * n_valid), 0, k_static).long()

    # jax.lax.top_k puts the lower index first among equal scores: a stable
    # descending sort does the same (torch.topk promises no order on ties).
    top_scores, top_idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[..., :k_static], top_idx[..., :k_static]
    slots = torch.arange(k_static, device=x.device)
    new_mask = slots < k_dyn[..., None]
    gate = torch.where(new_mask, torch.tanh(top_scores), torch.zeros_like(top_scores))
    picked = torch.gather(x, -2, top_idx[..., None].expand(*top_idx.shape, x.shape[-1]))
    new_x = torch.where(new_mask[..., None], picked,
                        torch.zeros((), dtype=x.dtype, device=x.device))
    new_x = new_x * gate[..., None]

    # Re-index edges: old node -> new slot, or -1.  top_idx holds distinct
    # nodes, so the scatter has one writer per entry.
    slot_of = torch.full(x.shape[:-1], -1, dtype=torch.long, device=x.device)
    slot_of.scatter_(-1, top_idx, torch.where(new_mask, slots, torch.full_like(slots, -1)))
    src_new = torch.gather(slot_of, -1, edge_index[..., 0, :].long())
    dst_new = torch.gather(slot_of, -1, edge_index[..., 1, :].long())
    keep = (src_new >= 0) & (dst_new >= 0) & edge_mask
    zero = torch.zeros_like(src_new)
    new_edges = torch.stack([torch.where(keep, src_new, zero),
                             torch.where(keep, dst_new, zero)], dim=-2).to(edge_index.dtype)
    return PooledGraph(new_x, new_edges, keep, new_mask)


# ----------------------------------------------------------------------
# Global pools
# ----------------------------------------------------------------------

def global_max_pool(x, node_mask):
    masked = torch.where(node_mask[..., None], x, torch.full_like(x, -math.inf))
    out = masked.amax(dim=-2)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def global_mean_pool(x, node_mask):
    w = node_mask.to(x.dtype)
    return (x * w[..., None]).sum(dim=-2) / torch.clamp(w.sum(dim=-1), min=1.0)[..., None]


# ----------------------------------------------------------------------
# Linear
# ----------------------------------------------------------------------

def linear(params, x):
    return x @ params["w"].T + params["b"]

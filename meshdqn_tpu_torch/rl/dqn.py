"""Double-DQN learner with alternating online/target roles.

The port of meshdqn_tpu/rl/dqn.py.  Semantics from the reference
(airfoil_dqn.py:151-310): TWO NodeRemovalNets; the online net's Q(s, a)
regresses onto r + gamma * V(s') with Huber loss; Adam(lr, weight_decay)
with a MultiStepLR schedule (milestones 0.5M/1M/1.5M, gamma 0.1,
airfoil_dqn.py:172-176); greedy actions always come from net 1
(airfoil_dqn.py:208-209).  As in the JAX package: one persistent optimizer
per net, gradients applied to the net they came from, then roles swap
('swap'), or net 2 a frozen copy of net 1 refreshed every target_update
gradient applications ('copy').

The optimizer is JAX's optax chain written with torch: the global-norm
clip as optax writes it (scale by max_norm / norm only when norm >=
max_norm, where `torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6),
then `torch.optim.Adam` (b1 0.9, b2 0.999, eps 1e-8, `weight_decay` as the
L2 term added to the clipped gradient, as optax.add_decayed_weights before
scale_by_adam) and a `MultiStepLR` whose count is optax's schedule count.

The parameters are leaf tensors (dicts of dicts keyed as the JAX tree);
`num_grads` and `select` are host counters, so a step branches without
reading the device.  A step's loss stays on the device.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..env.graph import GraphState
from ..models.noderemoval import batched_forward, forward
from .replay import ReplayStore, TransitionBatch, gather_batch


@dataclass(frozen=True)
class DQNConfig:
    lr: float = 1e-5
    weight_decay: float = 1e-6
    gamma: float = 1.0
    target_update: int = 50
    topk: float = 0.1
    huber_delta: float = 1.0
    milestones: tuple = (500_000, 1_000_000, 1_500_000)
    milestone_gamma: float = 0.1
    head: str = "softmax"  # 'softmax' = the reference's head quirk; 'linear'
    grad_clip: float = 0.0  # global-norm clip before the optimizer; 0 = off
    target_mode: str = "swap"  # 'swap' (the reference) or 'copy'
    double: bool = False  # van Hasselt: online picks a*, target evaluates it
    target_clip: float = 0.0  # clamp the Bellman target to [-c, c]; 0 = off
    cql_alpha: float = 0.0  # conservative-Q regularizer weight; 0 = off


@dataclass
class DQNState:
    """Both nets, each net's Adam and LR schedule, and the host counters."""

    params1: dict
    params2: dict
    opt1: torch.optim.Adam
    opt2: torch.optim.Adam
    sched1: torch.optim.lr_scheduler.MultiStepLR
    sched2: torch.optim.lr_scheduler.MultiStepLR
    num_grads: int = 0
    select: bool = True  # True -> net 1 is online


def param_leaves(params: dict) -> list:
    """(layer/name, tensor) of a parameter tree, in its order."""
    return [(f"{layer}/{name}", t) for layer, d in params.items() for name, t in d.items()]


def milestones(cfg: DQNConfig) -> list[int]:
    """The LR milestones in one optimizer's own count.  Under 'swap' each
    net's optimizer steps only while the net is online, half the global
    gradient applications, so its milestones sit at half the global ones."""
    div = 2 if cfg.target_mode == "swap" else 1
    return [int(m) // div for m in cfg.milestones]


def make_optimizer(params: dict, cfg: DQNConfig):
    """(Adam, MultiStepLR) over one net's leaves."""
    opt = torch.optim.Adam([t for _, t in param_leaves(params)], lr=cfg.lr,
                           betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, milestones(cfg),
                                                 gamma=cfg.milestone_gamma)
    return opt, sched


def init_dqn(params1: dict, params2: dict, cfg: DQNConfig) -> DQNState:
    """The learner over two parameter trees (copied into fresh leaves).
    Under 'copy' net 2 starts as an exact copy of net 1."""
    def leaves(params):
        return {layer: {name: t.detach().clone().requires_grad_(True)
                        for name, t in d.items()} for layer, d in params.items()}

    p1 = leaves(params1)
    p2 = leaves(params1 if cfg.target_mode == "copy" else params2)
    opt1, sched1 = make_optimizer(p1, cfg)
    opt2, sched2 = make_optimizer(p2, cfg)
    return DQNState(p1, p2, opt1, opt2, sched1, sched2)


def set_schedule_count(opt, sched, cfg: DQNConfig, count: int):
    """Put an optimizer's LR schedule at `count` applications (optax's
    schedule count): the LR is lr * gamma^(milestones <= count)."""
    sched.last_epoch = int(count)
    n = bisect.bisect_right(sorted(milestones(cfg)), int(count))
    for group in opt.param_groups:
        group["lr"] = cfg.lr * cfg.milestone_gamma ** n


def state_arrays(state: DQNState) -> dict:
    """The learner as a flat dict of tensors, keyed as
    scripts/torch_convert_checkpoint.py writes a JAX state: params1/<path>,
    params2/<path>, opt{1,2}/mu/<path>, opt{1,2}/nu/<path>, opt{1,2}/count
    (Adam's), opt{1,2}/schedule_count, num_grads, select."""
    out = {}
    for net, params, opt, sched in (("1", state.params1, state.opt1, state.sched1),
                                    ("2", state.params2, state.opt2, state.sched2)):
        count = 0
        for path, t in param_leaves(params):
            out[f"params{net}/{path}"] = t.detach()
            st = opt.state.get(t, {})
            out[f"opt{net}/mu/{path}"] = st.get("exp_avg", torch.zeros_like(t)).detach()
            out[f"opt{net}/nu/{path}"] = st.get("exp_avg_sq", torch.zeros_like(t)).detach()
            count = int(st["step"]) if "step" in st else 0
        out[f"opt{net}/count"] = torch.tensor(count, dtype=torch.int32)
        out[f"opt{net}/schedule_count"] = torch.tensor(sched.last_epoch, dtype=torch.int32)
    out["num_grads"] = torch.tensor(state.num_grads, dtype=torch.int32)
    out["select"] = torch.tensor(bool(state.select))
    return out


def load_state_arrays(state: DQNState, arrays: dict, cfg: DQNConfig) -> DQNState:
    """Set `state` in place from arrays keyed as `state_arrays` writes them
    (tensors or numpy arrays, any device); returns it."""
    def value(key, like):
        v = arrays[key]
        v = v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
        return v.to(device=like.device, dtype=like.dtype)

    for net, params, opt, sched in (("1", state.params1, state.opt1, state.sched1),
                                    ("2", state.params2, state.opt2, state.sched2)):
        count = int(arrays[f"opt{net}/count"])
        with torch.no_grad():
            for path, t in param_leaves(params):
                t.copy_(value(f"params{net}/{path}", t))
                opt.state[t] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": value(f"opt{net}/mu/{path}", t).clone(),
                    "exp_avg_sq": value(f"opt{net}/nu/{path}", t).clone(),
                }
        set_schedule_count(opt, sched, cfg, int(arrays[f"opt{net}/schedule_count"]))
    state.num_grads = int(arrays["num_grads"])
    state.select = bool(arrays["select"])
    return state


def _q_values(params, graphs: GraphState, cfg: DQNConfig):
    return batched_forward(params, graphs, topk=cfg.topk, head=cfg.head)  # (B, A)


def huber_loss(pred, target, delta: float):
    """optax.huber_loss, term for term."""
    abs_errors = (pred - target).abs()
    quadratic = torch.minimum(abs_errors, torch.full_like(abs_errors, delta))
    linear = abs_errors - quadratic
    return 0.5 * quadratic**2 + delta * linear


def dqn_loss(online, target, batch: TransitionBatch, cfg: DQNConfig):
    """The JAX package's loss: Huber on Q(s, a) against the bootstrap (plain
    max, or van Hasselt's double), masked on terminals, clipped, with no
    gradient through the target; plus the CQL logsumexp term."""
    q = _q_values(online, batch.state, cfg)  # (B, A)
    q_sa = q.gather(1, batch.action.long()[:, None])[:, 0]
    with torch.no_grad():
        q_next = _q_values(target, batch.next_state, cfg)
        if cfg.double:
            a_star = _q_values(online, batch.next_state, cfg).argmax(dim=1)
            v_next = q_next.gather(1, a_star[:, None])[:, 0]
        else:
            v_next = q_next.amax(dim=1)
        v_next = torch.where(batch.non_final, v_next, torch.zeros_like(v_next))
        tgt = batch.reward.to(q.dtype) + cfg.gamma * v_next
        if cfg.target_clip > 0:
            tgt = torch.clamp(tgt, -cfg.target_clip, cfg.target_clip)
    loss = huber_loss(q_sa, tgt, cfg.huber_delta).mean()
    if cfg.cql_alpha > 0:
        loss = loss + cfg.cql_alpha * (torch.logsumexp(q, dim=1) - q_sa).mean()
    return loss


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax.clip_by_global_norm: t unchanged while the global norm is below
    max_norm, else (t / norm) * max_norm.  No host sync: the branch is a
    device-side choice of divisor and factor (1 and 1 when not clipping),
    applied with foreach ops (a few launches for all the leaves)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    grads = torch._foreach_div(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return grads


def _step_net(online, target, opt, sched, batch, cfg: DQNConfig):
    leaves = [t for _, t in param_leaves(online)]
    loss = dqn_loss(online, target, batch, cfg)
    grads = list(torch.autograd.grad(loss, leaves))
    if cfg.grad_clip > 0:
        grads = clip_by_global_norm(grads, cfg.grad_clip)
    for t, g in zip(leaves, grads):
        t.grad = g
    opt.step()
    sched.step()
    for t in leaves:
        t.grad = None
    return loss.detach()


def train_step(state: DQNState, batch: TransitionBatch, cfg: DQNConfig):
    """One gradient application, in place; returns (state, loss on the
    device)."""
    if cfg.target_mode == "copy":
        loss = _step_net(state.params1, state.params2, state.opt1, state.sched1, batch, cfg)
        state.num_grads += 1
        if state.num_grads % cfg.target_update == 0:
            with torch.no_grad():
                for (_, a), (_, b) in zip(param_leaves(state.params1),
                                          param_leaves(state.params2)):
                    b.copy_(a)
        return state, loss
    if state.select:
        loss = _step_net(state.params1, state.params2, state.opt1, state.sched1, batch, cfg)
    else:
        loss = _step_net(state.params2, state.params1, state.opt2, state.sched2, batch, cfg)
    state.num_grads += 1
    if state.num_grads % cfg.target_update == 0:
        state.select = not state.select
    return state, loss


def train_step_idx(state: DQNState, store: ReplayStore, idx, cfg: DQNConfig):
    """One gradient application on the batch gathered on the device from a
    DeviceReplay store by (B,) indices (a device tensor)."""
    return train_step(state, gather_batch(store, idx), cfg)


def train_step_many_idx(state: DQNState, store: ReplayStore, idx, cfg: DQNConfig):
    """K successive gradient applications, batches gathered on the device by
    (K, B) indices; returns (state, losses (K,) on the device)."""
    losses = [train_step_idx(state, store, idx[k], cfg)[1] for k in range(idx.shape[0])]
    return state, torch.stack(losses)


def select_action(params1: dict, g: GraphState, topk: float = 0.1) -> torch.Tensor:
    """Greedy action from net 1 (airfoil_dqn.py:208-209): the argmax of the
    softmax head, as the JAX package takes it (the first action on ties).
    A 0-d tensor on the parameters' device."""
    with torch.no_grad():
        return torch.argmax(forward(params1, g, topk=topk))


def select_actions_batched(params1: dict, graphs: GraphState, topk: float = 0.1):
    """Greedy actions for a stacked batch of graphs -> (B,) on the device,
    from the softmax head as the JAX package takes them."""
    with torch.no_grad():
        return torch.argmax(batched_forward(params1, graphs, topk=topk), dim=1)


def epsilon(steps_done: float, start: float, end: float, decay: float) -> float:
    """eps = end + (start-end) exp(-steps/decay) (airfoil_dqn.py:455)."""
    return end + (start - end) * math.exp(-steps_done / decay)

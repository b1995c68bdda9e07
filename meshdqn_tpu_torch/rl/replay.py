"""Replay buffers over padded graph transitions.

The port of meshdqn_tpu/rl/replay.py.  The reference's ReplayMemory is a
Ray actor holding a Python list of PyG objects (airfoil_dqn.py:48-67); here
the padded graph tensors live in preallocated device rings (`DeviceReplay`),
with the JAX package's dtypes and shapes, so a ring saved by either package
loads in the other.  The JAX package's host ring (`ReplayBuffer`) and
`stack_batches` serve only its data-parallel trainer, which the port does
not have yet.

Terminal transitions store a zeroed next-state and non_final=False, which the
DQN target masks out (the reference passes literal None and rebuilds a mask
per batch, airfoil_dqn.py:246-248).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..env.graph import GraphState
from ..utils.hostio import TORCH_DTYPE, upload_packed


class TransitionBatch(NamedTuple):
    state: GraphState  # leaves have a leading batch dim
    action: torch.Tensor  # (B,) int32
    next_state: GraphState
    reward: torch.Tensor  # (B,) f32
    non_final: torch.Tensor  # (B,) bool


_GRAPH = (("x", "x"), ("ei", "edge_index"), ("ea", "edge_attr"), ("nm", "node_mask"),
          ("em", "edge_mask"))
_FIELDS = ("x", "ei", "ea", "nm", "em", "action", "reward", "non_final")


def _ring_shapes(c: int, n: int, f: int, e: int) -> dict:
    """Ring name -> (shape, numpy dtype), [state, next] on the leading axis."""
    return {"x": ((2, c, n, f), np.float32), "ei": ((2, c, 2, e), np.int32),
            "ea": ((2, c, e), np.float32), "nm": ((2, c, n), np.bool_),
            "em": ((2, c, e), np.bool_), "action": ((c,), np.int32),
            "reward": ((c,), np.float32), "non_final": ((c,), np.bool_)}


def stack_graphs(graphs: list, device) -> GraphState:
    """GraphStates (host tensors or arrays) stacked on a leading axis, on
    `device`, in one host-to-device copy."""
    arrays = {name: np.stack([np.asarray(getattr(g, name)) for g in graphs])
              for _, name in _GRAPH}
    return GraphState(**upload_packed(arrays, device))


class ReplayStore(NamedTuple):
    """The device rings backing DeviceReplay (leading [slot, capacity] dims:
    slot 0 the state, slot 1 the next state)."""

    x: torch.Tensor  # (2, c, n, f) f32
    ei: torch.Tensor  # (2, c, 2, e) i32
    ea: torch.Tensor  # (2, c, e) f32
    nm: torch.Tensor  # (2, c, n) bool
    em: torch.Tensor  # (2, c, e) bool
    action: torch.Tensor  # (c,) i32
    reward: torch.Tensor  # (c,) f32
    non_final: torch.Tensor  # (c,) bool


def gather_batch(store: ReplayStore, idx: torch.Tensor) -> TransitionBatch:
    """The transitions at ring slots idx (B,), gathered on the device; the
    int32 edge indices stay int32 (the forward widens them)."""
    idx = idx.long()

    def graph(slot):
        return GraphState(**{name: getattr(store, ring)[slot, idx] for ring, name in _GRAPH})

    return TransitionBatch(state=graph(0), action=store.action[idx], next_state=graph(1),
                           reward=store.reward[idx], non_final=store.non_final[idx])


class DeviceReplay:
    """Device-resident replay ring (the JAX package's DeviceReplay).

    The rings live in device memory (~2.7 GB at capacity 50k with 180 nodes,
    17 features and 1152 edges).  `push` stages a transition on the host;
    `flush()` lands the staged ones with one host-to-device copy of a packed
    buffer and an `index_copy_` per ring at their ring positions.  Gradient
    batches are gathered on the device by index (rl/dqn.py
    train_step_many_idx).

    `sample_indices` draws from the same rng stream with the same call as
    the JAX package at the same call point; the gather is deferred to the
    flush, so a full ring may serve a slot overwritten later in the same
    sweep, as in the JAX package.
    """

    def __init__(self, capacity: int, n_nodes: int, n_features: int, edge_budget: int,
                 device="cpu"):
        self.capacity = capacity
        self.device = torch.device(device)
        self._shapes = _ring_shapes(capacity, n_nodes, n_features, edge_budget)
        self.store = ReplayStore(**{
            name: torch.zeros(shape, dtype=TORCH_DTYPE[np.dtype(dt)], device=self.device)
            for name, (shape, dt) in self._shapes.items()})
        self._pos = 0
        self._size = 0
        self._staged: list = []

    def push(self, state, action, next_state, reward):
        self._staged.append((state, action, next_state, reward))
        self._pos = (self._pos + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)

    def __len__(self):
        return self._size

    def sample_indices(self, batch_size: int, rng: np.random.Generator) -> np.ndarray:
        """(B,) int32 indices against the CURRENT ring size (the JAX
        package's rng call)."""
        return rng.choice(self._size, size=batch_size, replace=False).astype(np.int32)

    def flush(self):
        """Land the staged transitions on the device."""
        if not self._staged:
            return
        k = len(self._staged)
        start = (self._pos - k) % self.capacity
        pos = (start + np.arange(k)) % self.capacity
        # More staged than slots: the later writes win, as in sequential pushes.
        staged, pos = self._staged[-self.capacity:], pos[-self.capacity:]
        self._staged = []
        arrays = {"pos": pos.astype(np.int64)}
        for ring, name in _GRAPH:
            shape, dt = self._shapes[ring]
            zero = np.zeros(shape[2:], dt)
            arrays[ring] = np.stack([
                np.stack([np.asarray(getattr(t[slot], name)) if t[slot] is not None else zero
                          for t in staged])
                for slot in (0, 2)])
        arrays["action"] = np.array([t[1] for t in staged], np.int32)
        arrays["reward"] = np.array([t[3] for t in staged], np.float32)
        arrays["non_final"] = np.array([t[2] is not None for t in staged], bool)
        dev = upload_packed(arrays, self.device)
        p = dev.pop("pos")
        for name, vals in dev.items():
            ring = getattr(self.store, name)
            ring.index_copy_(1 if ring.dim() > 1 else 0, p, vals)

    def save(self, path: str):
        """Persist the ring, keys as the JAX package's DeviceReplay.save."""
        self.flush()
        np.savez(path, **{k: v.cpu().numpy() for k, v in self.store._asdict().items()},
                 pos=self._pos, size=self._size)

    def load(self, path: str) -> bool:
        z = np.load(path)
        if z["x"].shape != tuple(self.store.x.shape):
            return False  # budgets changed under the same prefix
        for k in ReplayStore._fields:
            getattr(self.store, k).copy_(torch.from_numpy(z[k]))
        self._pos = int(z["pos"])
        self._size = int(z["size"])
        return True


"""Training metrics recorder.

The port of meshdqn_tpu/train/metrics.py, the counterpart of the reference's
DataHandler Ray actor (airfoil_dqn.py:76-147): per-episode rewards, losses,
actions and epsilon values, written as the same five .npy artifacts
(`<prefix>reward.npy`, `rewards.npy`, `losses.npy`, `actions.npy`,
`eps.npy`, pickled object arrays), so either package's recorder reads the
other's runs and the reference's analysis scripts read both.  The reward
plot is not ported (matplotlib is not a dependency of the port).
"""
from __future__ import annotations

import os

import numpy as np
import torch


class MetricsRecorder:
    def __init__(self, save_dir: str, prefix: str = ""):
        self.save_dir = save_dir
        self.prefix = prefix
        os.makedirs(save_dir, exist_ok=True)
        self.rewards: list[float] = []  # per-episode summed reward
        self.ep_rewards: list[list] = []  # per-episode reward lists
        self.losses: list[float] = []
        self.actions: list[list] = []
        self.epss: list[float] = []
        self._pending: list = []  # device loss scalars awaiting readback

    # -- accumulation (DataHandler API) --------------------------------
    def add_eps(self, eps: float):
        self.epss.append(eps)

    def num_eps(self) -> int:
        return len(self.epss)

    def add_loss(self, loss):
        """Accepts a float or a 0-d tensor.  Tensors are read back 256 at a
        time in one copy: a `float(loss)` per gradient step would make the
        host wait for the device at every step."""
        self._pending.append(loss)
        if len(self._pending) >= 256:
            self._flush_losses()

    def _flush_losses(self):
        if not self._pending:
            return
        tensors = [v for v in self._pending if torch.is_tensor(v)]
        host = iter(torch.stack([t.detach() for t in tensors]).cpu().tolist()
                    if tensors else [])
        self.losses.extend(next(host) if torch.is_tensor(v) else float(v)
                           for v in self._pending)
        self._pending = []

    def add_episode(self, ep_rew: list, ep_action: list):
        self.rewards.append(float(np.sum(ep_rew)))
        self.ep_rewards.append(list(ep_rew))
        self.actions.append(list(ep_action))

    # -- artifacts ------------------------------------------------------
    def _p(self, name: str) -> str:
        return os.path.join(self.save_dir, self.prefix + name)

    def _atomic_save(self, name: str, values: list):
        """np.save via tmp + rename: a kill mid-write must never truncate
        the committed artifact."""
        path = self._p(name)
        tmp = path + ".tmp.npy"
        np.save(tmp, np.array(values, dtype=object), allow_pickle=True)
        os.replace(tmp, path)

    def write(self):
        self._flush_losses()
        self._atomic_save("reward.npy", self.rewards)
        self._atomic_save("rewards.npy", self.ep_rewards)
        self._atomic_save("losses.npy", self.losses)
        self._atomic_save("actions.npy", self.actions)
        self._atomic_save("eps.npy", self.epss)

    def load(self):
        """Resume accumulation from previously written artifacts (pickled
        object arrays, written by this recorder or the JAX package's)."""
        def _load(name, default):
            try:
                return list(np.load(self._p(name), allow_pickle=True))
            except OSError:
                return default

        self.rewards = [float(r) for r in _load("reward.npy", [])]
        self.ep_rewards = _load("rewards.npy", [])
        self.losses = _load("losses.npy", [])
        self.actions = _load("actions.npy", [])
        self.epss = _load("eps.npy", [])

    def truncate(self, episodes: int, steps: int, losses: int | None = None):
        """Align resumed arrays with the restored checkpoint counters: metric
        writes and checkpoint saves run on separate cadences, so the arrays
        can run a few entries ahead of the checkpoint resumed from.  The
        losses are cut to the count the checkpoint recorded, when it did."""
        self.rewards = self.rewards[:episodes]
        self.ep_rewards = self.ep_rewards[:episodes]
        self.actions = self.actions[:episodes]
        self.epss = self.epss[:steps]
        if losses is not None:
            self.losses = self.losses[: int(losses)]

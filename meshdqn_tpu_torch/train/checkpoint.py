"""Versioned checkpoint/resume.

The port of meshdqn_tpu/train/checkpoint.py, with its directory layout:
one `step_N/` directory per checkpoint holding `extras.json` (the host-side
counters) and the learner, the newest `max_to_keep` kept.  Where the JAX
package writes an orbax tree, the port writes `tree.pt`: a `torch.save` of
`rl.dqn.state_arrays` (both nets, both Adam states with their counts, both
LR schedule counts, num_grads, select) as CPU tensors, read back with
`weights_only=True`.  Resume restores everything exactly.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import torch

from ..rl.dqn import DQNState, load_state_arrays, state_arrays

_STEP_RE = re.compile(r"^step_(\d+)$")


def _to_host(arrays: dict) -> dict:
    """The tensors on the CPU, with one device-to-host copy per dtype."""
    out = {k: v for k, v in arrays.items() if not v.is_cuda}
    by_dtype: dict = {}
    for k, v in arrays.items():
        if v.is_cuda:
            by_dtype.setdefault(v.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([arrays[k].reshape(-1) for k in keys]).cpu()
        for k, part in zip(keys, flat.split([arrays[k].numel() for k in keys])):
            out[k] = part.view(arrays[k].shape).clone()
    return out


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, "extras.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def save(self, step: int, dqn: DQNState, extras: dict[str, Any]):
        path = self._path(step)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)
        torch.save(_to_host(state_arrays(dqn)), os.path.join(path, "tree.pt"))
        with open(os.path.join(path, "extras.json"), "w") as f:
            json.dump(extras, f)
        for old in self._steps()[: -self.max_to_keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template_dqn: DQNState, cfg):
        """(template_dqn set from the latest checkpoint, extras, step), or
        None when there is none; cfg is the learner's DQNConfig."""
        step = self.latest_step()
        if step is None:
            return None
        path = self._path(step)
        tree = torch.load(os.path.join(path, "tree.pt"), map_location="cpu",
                          weights_only=True)
        with open(os.path.join(path, "extras.json")) as f:
            extras = json.load(f)
        return load_state_arrays(template_dqn, tree, cfg), extras, step

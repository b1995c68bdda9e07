"""Typed configuration with YAML loading and CLI overrides.

The port's counterpart of meshdqn_tpu/utils/config.py: the same dataclasses,
defaults, reference-schema mapping and `section.key=value` overrides, so
`configs/*.yaml` and the packs' `checkpoints/*/config.yaml` load unchanged
(TPU-only keys such as `pad_quantum` included).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import yaml


@dataclass
class FlowConfig:
    mu: float = 1e-3
    rho: float = 1.0
    inflow: str = "constant"
    mesh: str = ""
    dt: float = 1e-3
    solver_type: str = "lu"  # kept for schema parity; the solver ignores it
    smooth: bool = True
    precision: str = "f64"  # 'f64' | 'f32' | 'df32' | 'mixed'
    refine_iters: int = 2
    # Shape-quantized padding of the fused operators (solver/ipcs.py).  The
    # JAX package used it for compile reuse on its TPU; exact, 0 = off.
    pad_quantum: int = 0
    # Vertex-removal re-triangulation: 'global' = the reference's global
    # Delaunay; 'cavity' = the local cavity fill (coarsen/cavity.py).
    retriangulation: str = "global"


@dataclass
class AgentConfig:
    solver_steps: int = 5000
    episodes: int = 1_000_000
    timesteps: int = 10_000
    threshold: float = 1e-3
    N_closest: int = 180
    gt_drag: Any = -1
    gt_time: Any = -1
    u: Any = -1
    p: Any = -1
    do_nothing: bool = True
    time_reward: float = 0.005
    smoothing: bool = True
    save_steps: int = 1000
    goal_vertices: float = 0.95
    plot_dir: str = ""
    target_update: int = 50
    num_workers: int = 1
    num_parallel: int = 12
    # The reference's faithful bug (Env2DAirfoil.py:349): False returns the
    # ordinary reward on a threshold termination, True the intended -0.5.
    terminal_penalty: bool = False
    edge_budget: int = 1152  # padded directed-edge capacity of state graphs
    write_every: int = 25
    checkpoint_every: int = 25
    # Q-network head: 'softmax' (reference quirk) or 'linear' (raw Q).
    head: str = "softmax"
    target_mode: str = "swap"
    double: bool = False
    replay_capacity: int = 10_000
    probe_every: int = 0


@dataclass
class OptimizerConfig:
    lr: float = 1e-5
    weight_decay: float = 1e-6
    batch_size: int = 32
    grad_clip: float = 0.0
    target_clip: float = 0.0
    cql_alpha: float = 0.0


@dataclass
class EpsilonConfig:
    decay: float = 10_000.0
    start: float = 1.0
    end: float = 0.01
    gamma: float = 1.0


@dataclass
class Config:
    flow: FlowConfig = field(default_factory=FlowConfig)
    agent: AgentConfig = field(default_factory=AgentConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    epsilon: EpsilonConfig = field(default_factory=EpsilonConfig)
    seed: int = 1370  # airfoil_dqn.py:28
    save_dir: str = "training_results"
    prefix: str = "run_"

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        with open(path) as f:
            raw = yaml.safe_load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        cfg = cls()
        # Reference schema: flow_config/{flow_params, geometry_params,
        # solver_params}, agent_params, optimizer, epsilon.
        fc = raw.get("flow_config", {})
        _fill(cfg.flow, fc.get("flow_params", {}))
        _fill(cfg.flow, fc.get("geometry_params", {}))
        _fill(cfg.flow, fc.get("solver_params", {}))
        _fill(cfg.flow, raw.get("flow", {}))
        _fill(cfg.agent, raw.get("agent_params", {}))
        _fill(cfg.agent, raw.get("agent", {}))
        _fill(cfg.optimizer, raw.get("optimizer", {}))
        _fill(cfg.epsilon, raw.get("epsilon", {}))
        for key in ("seed", "save_dir", "prefix"):
            if key in raw:
                setattr(cfg, key, raw[key])
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f)

    def apply_overrides(self, overrides: list[str]) -> "Config":
        """Apply `section.key=value` strings (e.g. 'optimizer.lr=3e-4')."""
        for item in overrides:
            key, _, value = item.partition("=")
            parts = key.strip().split(".")
            obj = self
            for p in parts[:-1]:
                obj = getattr(obj, p)
            current = getattr(obj, parts[-1])
            setattr(obj, parts[-1], _coerce(value, current))
        return self


def _fill(obj, src: dict):
    for k, v in src.items():
        if hasattr(obj, k):
            current = getattr(obj, k)
            setattr(obj, k, _coerce(v, current))


def _coerce(value, current):
    if isinstance(value, str):
        if isinstance(current, bool):
            return value.lower() in ("1", "true", "yes")
        if isinstance(current, int) and not isinstance(current, bool):
            try:
                return int(value)
            except ValueError:
                return int(float(value))
        if isinstance(current, float):
            return float(value)
    if isinstance(current, float) and isinstance(value, (int, str)):
        return float(value)
    return value

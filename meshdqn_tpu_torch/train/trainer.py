"""DQN training loop.

The port of meshdqn_tpu/train/trainer.py, on `device` (CUDA unless the
caller names another).  One process steps `num_parallel` environments
round-robin, selects the sweep's greedy actions with one batched forward,
runs the sweep's removals as one batched transfer pass and its window shifts
as one batched gather, and applies one double-DQN gradient step per
environment transition, on batches gathered on the device from the replay
ring.  The JAX package's mirrored behaviours hold (airfoil_dqn.py
references in its docstring): epsilon-greedy with one shared global step,
exploration over all N_closest+1 actions, transitions (s, a, s'|None, r),
one optimize call per env step once the ring holds a batch, the metric
artifacts and checkpoints on an episode cadence.

The trainer draws its epsilon coins, explore actions and replay indices from
one `np.random.default_rng(seed)` at the JAX trainer's call points, in its
order, and keeps its deferred optimizer flush: the batches queued during a
sweep are applied at the top of the next one, after that sweep's batched env
passes are enqueued and before its pushes, so the next sweep's greedy
actions see the flushed parameters.  On the CPU it reproduces the JAX
trainer step for step (tests/test_torch_train.py).

Not ported: the TPU client's RSS recycle and the PAUSE handshake (their
config keys are accepted), data parallelism (ROADMAP Queue 1 item 3), the
reward plot, and the JAX trainer's tolerance of up to 5 failed batched env
passes: a CUDA error is sticky, so it propagates.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..env import AirfoilEnv, GroundTruth
from ..models import init_params
from ..rl import (
    DeviceReplay,
    DQNConfig,
    epsilon,
    init_dqn,
    select_action,
    select_actions_batched,
    stack_graphs,
    train_step_idx,
    train_step_many_idx,
)
from ..solver.ipcs import resolve_device
from ..transfer import SnapshotTransfer
from ..utils import Config, JsonLogger
from ..utils.hostio import upload
from .checkpoint import CheckpointManager
from .gtcache import load_or_compute_ground_truth
from .metrics import MetricsRecorder

REPLAY_CAPACITY = 10_000  # reference default (airfoil_dqn.py:412)
TIMING_KEYS = ("select", "prep", "dev", "gather", "complete", "opt", "done")


@dataclass
class TrainerState:
    global_step: int = 0
    episode: int = 0


class Trainer:
    def __init__(
        self,
        config: Config,
        ground_truth: GroundTruth | None = None,
        resume: bool = True,
        data_parallel: bool | None = None,
        device=None,
    ):
        """data_parallel: None or False (one device); True raises, as data
        parallelism is not ported (ROADMAP Queue 1 item 3)."""
        if data_parallel:
            raise NotImplementedError(
                "data-parallel training is not ported yet (ROADMAP Queue 1 item 3)")
        self.device = resolve_device(device)
        self.config = config
        agent = config.agent
        self.save_dir = os.path.join(config.save_dir, config.prefix.rstrip("_"))
        os.makedirs(self.save_dir, exist_ok=True)
        config.to_yaml(os.path.join(self.save_dir, "config.yaml"))

        self.gt = load_or_compute_ground_truth(config, self.save_dir, ground_truth,
                                               device=self.device)
        # One shared transfer: the sweep batches every env's device pass.
        self._shared_transfer = SnapshotTransfer(
            self.gt.mesh, self.gt.snapshots, window_budget=agent.N_closest,
            device=self.device)
        self.envs = [
            AirfoilEnv(config, ground_truth=self.gt, transfer=self._shared_transfer,
                       device=self.device)
            for _ in range(agent.num_parallel)
        ]

        n_actions = agent.N_closest + 1
        n_feat = 2 + 3 * (agent.solver_steps // agent.save_steps)
        gen = torch.Generator(device="cpu").manual_seed(config.seed)
        p1 = init_params(gen, n_feat, n_actions, conv_width=128, device=self.device)
        p2 = init_params(gen, n_feat, n_actions, conv_width=128, device=self.device)
        opt = config.optimizer
        self.dqn_cfg = DQNConfig(
            lr=opt.lr,
            weight_decay=opt.weight_decay,
            gamma=config.epsilon.gamma,
            target_update=agent.target_update,
            topk=0.1,
            head=agent.head,
            grad_clip=opt.grad_clip,
            target_mode=agent.target_mode,
            double=agent.double,
            target_clip=opt.target_clip,
            cql_alpha=opt.cql_alpha,
        )
        self.dqn = init_dqn(p1, p2, self.dqn_cfg)
        capacity = getattr(agent, "replay_capacity", REPLAY_CAPACITY)
        self.replay = DeviceReplay(capacity, agent.N_closest, n_feat, agent.edge_budget,
                                   device=self.device)
        self.batch_size = opt.batch_size
        self.rng = np.random.default_rng(config.seed)

        self._pending_batches: list = []
        self.metrics = MetricsRecorder(self.save_dir, config.prefix)
        self.jsonlog = JsonLogger(os.path.join(self.save_dir, "train_log.jsonl"))
        self.ckpt = CheckpointManager(os.path.join(self.save_dir, "ckpt"))
        # Best-policy snapshot on a new high of the 1000-episode reward
        # moving average at a checkpoint boundary.
        self.ckpt_best = CheckpointManager(os.path.join(self.save_dir, "ckpt_best"),
                                           max_to_keep=1)
        self._best_ma: float = float("-inf")
        self.best_window = 1000
        # Deploy-aware model selection: every probe_every episodes one
        # greedy probe episode; ckpt_best_deploy/ tracks the high water of
        # its removals within the threshold.
        self.probe_every = int(getattr(agent, "probe_every", 0))
        self.ckpt_best_deploy = CheckpointManager(
            os.path.join(self.save_dir, "ckpt_best_deploy"), max_to_keep=1)
        self._best_deploy: tuple[int, float] = (-1, float("-inf"))
        self._probe_env = None
        self.state = TrainerState()
        self.write_every = agent.write_every
        self.checkpoint_every = agent.checkpoint_every
        self._last_saved_episode = -1
        self._replay_path = os.path.join(self.save_dir, "replay.npz")
        # MESHDQN_TIMING=1: host seconds by phase, summed over the run.
        self.timing = {k: 0.0 for k in TIMING_KEYS} | {"sweeps": 0}

        if resume:
            restored = self.ckpt.restore(self.dqn, self.dqn_cfg)
            if restored is not None:
                self.dqn, extras, _ = restored
                self.state.global_step = int(extras["global_step"])
                self.state.episode = int(extras["episode"])
                self.metrics.load()
                # Metric arrays are written on their own cadence and can run
                # ahead of the checkpoint's counters; cut them back so resumed
                # episodes are not recorded twice.
                self.metrics.truncate(episodes=self.state.episode,
                                      steps=self.state.global_step,
                                      losses=extras.get("n_losses"))
                self._best_ma = float(extras.get("best_ma", float("-inf")))
                self._best_deploy = (
                    int(extras.get("best_deploy_removals", -1)),
                    float(extras.get("best_deploy_reward", float("-inf"))),
                )
                if os.path.exists(self._replay_path):
                    ok = self.replay.load(self._replay_path)
                    self.jsonlog.log("replay_restore", ok=ok, size=len(self.replay))

    # ------------------------------------------------------------------
    def _optimize(self):
        """Queue one gradient step (airfoil_dqn.py:315-319 skip-until-batch):
        its replay indices are drawn now, against the ring's current size;
        `_flush_optimize` gathers and applies the queued batches."""
        if len(self.replay) < self.batch_size:
            return
        self._pending_batches.append(self.replay.sample_indices(self.batch_size, self.rng))

    def _flush_optimize(self):
        if not self._pending_batches:
            return
        batches = self._pending_batches
        self._pending_batches = []
        self.replay.flush()
        idx = upload(np.stack(batches), self.device)
        if len(batches) < len(self.envs):
            # Warm-up partial sweep: single steps, as the JAX trainer runs them.
            for k in range(len(batches)):
                self.dqn, loss = train_step_idx(self.dqn, self.replay.store, idx[k],
                                                self.dqn_cfg)
                self.metrics.add_loss(loss)
        else:
            self.dqn, losses = train_step_many_idx(self.dqn, self.replay.store, idx,
                                                   self.dqn_cfg)
            for i in range(len(batches)):
                self.metrics.add_loss(losses[i])

    # ------------------------------------------------------------------
    def train(self, num_episodes: int | None = None, max_steps: int | None = None):
        """Run episodes round-robin over the parallel envs."""
        cfg = self.config
        eps_cfg = cfg.epsilon
        num_episodes = num_episodes or cfg.agent.episodes
        t_start = time.time()

        env_states = [env.reset() for env in self.envs]
        ep_rewards = [[] for _ in self.envs]
        ep_actions = [[] for _ in self.envs]
        n_envs = len(self.envs)
        timing = os.environ.get("MESHDQN_TIMING") == "1"
        tacc = self.timing

        while self.state.episode < num_episodes:
            _t0 = time.time()
            # Phase 1: epsilon-greedy decisions for the whole sweep; every
            # exploit action from one batched forward over all envs.
            eps_sweep = [
                epsilon(self.state.global_step + i, eps_cfg.start, eps_cfg.end,
                        eps_cfg.decay)
                for i in range(n_envs)
            ]
            explore = [self.rng.random() <= e for e in eps_sweep]
            actions = [
                int(self.rng.integers(0, self.config.agent.N_closest + 1))
                if explore[i] else None
                for i in range(n_envs)
            ]
            if not all(explore):
                stacked = stack_graphs(env_states, self.device)
                chosen = select_actions_batched(self.dqn.params1, stacked,
                                                topk=self.dqn_cfg.topk).cpu().numpy()
                for i in range(n_envs):
                    if actions[i] is None:
                        actions[i] = int(chosen[i])
            if timing:
                tacc["select"] += time.time() - _t0; _t0 = time.time()

            # Phase 2 (host): mesh surgery and device-pass inputs for every
            # env; phase 3 (device): one batched pass for the removing envs
            # and one batched gather for the window-shift envs.
            preps = [env.prepare_step(actions[i]) for i, env in enumerate(self.envs)]
            if timing:
                tacc["prep"] += time.time() - _t0; _t0 = time.time()
            results: dict[int, tuple] = {}
            removal_idx = [i for i, p in enumerate(preps) if p.inputs is not None]
            gather_idx = [i for i, p in enumerate(preps) if p.post_window is not None]
            prod_handle = None
            if removal_idx:
                prod_handle = self._shared_transfer.run_products_batched_begin(
                    [preps[i].inputs for i in removal_idx], wire="f32")
            gather_handle = None
            if gather_idx:
                gather_handle = self._shared_transfer.gather_window_batched_begin(
                    [(self.envs[i]._dev_snaps, preps[i].post_window) for i in gather_idx])
            # Deferred optimizer flush: the batches queued during the
            # previous sweep, enqueued behind this sweep's env passes, landing
            # before this sweep's pushes and the next sweep's selection.
            if timing:
                _t1 = time.time()
            self._flush_optimize()
            if timing:
                tacc["opt"] += time.time() - _t1; _t0 += time.time() - _t1
            if prod_handle is not None:
                outs = self._shared_transfer.run_products_batched_finish(prod_handle)
                results = dict(zip(removal_idx, outs))
            if timing:
                tacc["dev"] += time.time() - _t0; _t0 = time.time()
            if gather_handle is not None:
                feats = self._shared_transfer.gather_window_batched_finish(gather_handle)
                for i, (vel_w, p_w) in zip(gather_idx, feats):
                    self.envs[i]._cached_state_inputs = (preps[i].post_window, vel_w, p_w)
            if timing:
                tacc["gather"] += time.time() - _t0; _t0 = time.time()

            for i, env in enumerate(self.envs):
                eps_val = eps_sweep[i]
                action = actions[i]
                nxt, rew, done, info = env.complete_step(preps[i], results.get(i))
                self.replay.push(env_states[i], action, None if done else nxt, rew)
                env_states[i] = nxt
                ep_rewards[i].append(rew)
                ep_actions[i].append(action)
                self.metrics.add_eps(eps_val)
                self.state.global_step += 1

                if timing:
                    tacc["complete"] += time.time() - _t0; _t0 = time.time()
                self._optimize()
                if timing:
                    tacc["opt"] += time.time() - _t0; _t0 = time.time()

                if done:
                    self.metrics.add_episode(ep_rewards[i], ep_actions[i])
                    self.jsonlog.log(
                        "episode",
                        episode=self.state.episode + 1,
                        env=i,
                        steps=len(ep_rewards[i]),
                        reward=float(np.sum(ep_rewards[i])),
                        eps=eps_val,
                        global_step=self.state.global_step,
                    )
                    ep_rewards[i], ep_actions[i] = [], []
                    env_states[i] = env.reset()
                    self.state.episode += 1
                    if self.state.episode % self.write_every == 0:
                        self._flush_optimize()
                        self.metrics.write()
                    if self.state.episode % self.checkpoint_every == 0:
                        self._flush_optimize()
                        self._save_checkpoint()
                    if self.probe_every and self.state.episode % self.probe_every == 0:
                        self._flush_optimize()
                        self._deploy_probe()
                    if self.state.episode >= num_episodes:
                        break
                if max_steps is not None and self.state.global_step >= max_steps:
                    self._flush_optimize()
                    self.metrics.write()
                    self._save_checkpoint()
                    if timing:
                        print({k: round(v, 2) for k, v in tacc.items()}, flush=True)
                    return self.summary(t_start)
            else:
                # No flush here: the sweep's queued batches are applied at the
                # top of the next sweep, behind its batched env passes.
                if timing:
                    tacc["done"] += time.time() - _t0
                    tacc["sweeps"] += 1
                    if tacc["sweeps"] % 10 == 0:
                        print({k: round(v, 2) for k, v in tacc.items()}, flush=True)
                self._maybe_stop()
                continue
            break
        self._flush_optimize()
        self.metrics.write()
        self._save_checkpoint()
        self.replay.save(self._replay_path)
        return self.summary(t_start)

    def _maybe_stop(self):
        """exit(0) losslessly when a STOP file appears in the run dir: save
        the checkpoint, the metrics and the replay ring first, so a fresh
        Trainer resumes where this one stopped."""
        stop = os.path.join(self.save_dir, "STOP")
        if not os.path.exists(stop):
            return
        self._flush_optimize()
        self.metrics.write()
        self.replay.save(self._replay_path)
        self._last_saved_episode = -1  # force a fresh checkpoint
        self._save_checkpoint()
        self.jsonlog.log("stop", episode=self.state.episode,
                         global_step=self.state.global_step)
        try:
            os.remove(stop)
        except OSError:
            pass
        import sys

        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)

    def _extras(self) -> dict:
        return {
            "global_step": self.state.global_step,
            "episode": self.state.episode,
            # Metric-array lengths at save time let resume truncate the
            # arrays back into exact alignment with the counters.
            "n_losses": len(self.metrics.losses) + len(self.metrics._pending),
            "best_ma": self._best_ma,
            "best_deploy_removals": self._best_deploy[0],
            "best_deploy_reward": self._best_deploy[1],
        }

    def _save_checkpoint(self):
        if self.state.episode == self._last_saved_episode:
            return
        self._last_saved_episode = self.state.episode
        rewards = self.metrics.rewards
        w = self.best_window
        ma = float(np.mean(rewards[-w:])) if len(rewards) >= w else None
        new_best = ma is not None and ma > self._best_ma
        if new_best:
            self._best_ma = ma
        extras = self._extras()
        self.ckpt.save(self.state.episode, self.dqn, extras)
        if new_best:
            self.ckpt_best.save(self.state.episode, self.dqn, dict(extras, best_ma1000=ma))
            self.jsonlog.log("best_checkpoint", episode=self.state.episode,
                             ma1000=round(ma, 4))

    def _deploy_probe(self, max_steps: int = 100):
        """Roll one greedy (eps = 0) episode on a dedicated probe env and
        snapshot the nets to ckpt_best_deploy/ when its removals within the
        threshold make a new high (ties broken by the episode's reward)."""
        if self._probe_env is None:
            self._probe_env = AirfoilEnv(self.config, ground_truth=self.gt,
                                         transfer=self._shared_transfer,
                                         device=self.device)
        env = self._probe_env
        thr = 100.0 * self.config.agent.threshold
        gtd = float(np.asarray(self.gt.gt_drag)[-1])
        state = env.reset()
        env.calculate_reward()
        removals_ok, removals, removals_failed, total = 0, 0, 0, 0.0
        reason = "max_steps"
        for _ in range(max_steps):
            if os.path.exists(os.path.join(self.save_dir, "STOP")):
                self.jsonlog.log("deploy_probe", episode=self.state.episode,
                                 removals=removals, removals_ok=removals_ok,
                                 reward=round(total, 3), terminal="aborted_pause",
                                 best=False)
                return
            a = int(select_action(self.dqn.params1, state, topk=self.dqn_cfg.topk))
            state, rew, done, info = env.step(a)
            total += rew
            # Only removals the env executed count (a failed removal leaves
            # new_drags stale).
            if a < env.action_space_n and info.removed == 0:
                removals += 1
                err = 100.0 * abs(float(env.new_drags[-1]) - gtd) / abs(gtd)
                if err <= thr:
                    removals_ok += 1
            elif a < env.action_space_n:
                removals_failed += 1
            if done:
                reason = info.terminal_reason or "done"
                break
        score = (removals_ok, total)
        new_best = score > self._best_deploy
        self.jsonlog.log("deploy_probe", episode=self.state.episode, removals=removals,
                         removals_ok=removals_ok, removals_failed=removals_failed,
                         reward=round(total, 3), terminal=reason, best=new_best)
        if new_best:
            self._best_deploy = score
            self.ckpt_best_deploy.save(
                self.state.episode, self.dqn,
                dict(self._extras(), best_deploy_removals=removals_ok,
                     best_deploy_reward=total, probe_removals_total=removals,
                     probe_terminal=reason))
        return {"removals": removals, "removals_ok": removals_ok,
                "removals_failed": removals_failed, "reward": total,
                "terminal": reason, "best": new_best}

    def summary(self, t_start: float) -> dict:
        return {
            "episodes": self.state.episode,
            "global_steps": self.state.global_step,
            "wall_s": time.time() - t_start,
            "mean_reward": float(np.mean(self.metrics.rewards))
            if self.metrics.rewards else float("nan"),
            "grad_steps": int(self.dqn.num_grads),
        }

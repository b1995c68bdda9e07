"""The port's trainer against meshdqn_tpu's, on the CPU.

A JAX Trainer and the port's Trainer on the small config (the ys930 config
at the pack's widths with the 100-step ground truth: 2 envs, batch 4, a
64-transition ring, epsilon from 0.3 so that both greedy and explore
actions occur), both from the JAX trainer's initial learner carried across,
for 14 env steps: the warm-up's single gradient steps and then two-batch
flushes.  A third run, the port's trainer on the same learner in f64, is the
exact evaluation the f32 runs are held to (the port's f64 steps equal the
JAX package's f64 steps, tests/test_torch_rl.py).  Then the port alone:
resume with metric truncation, the metric artifacts read by the JAX
package, the STOP file's lossless exit, one deploy probe against JAX's, and
cli.train on the CPU.
"""
import copy
import importlib.util
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import meshdqn_tpu.env as jenv
import meshdqn_tpu.train as jtrain
import meshdqn_tpu.utils as jutils
import meshdqn_tpu_torch.env as tenv
import meshdqn_tpu_torch.train as ttrain
import meshdqn_tpu_torch.utils as tutils
from meshdqn_tpu_torch.cli import train as tcli
from meshdqn_tpu_torch.convert import dqn_state_from_numpy, dqn_state_to_numpy
from meshdqn_tpu_torch.train.gtcache import gt_fingerprint
from tests.torch_helpers import CACHE_YS930_100, REPO, cap_threads

cap_threads()

STEPS = 14
REWARD_REL = 1e-9


def _converter():
    spec = importlib.util.spec_from_file_location(
        "torch_convert_checkpoint", REPO / "scripts" / "torch_convert_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CONVERT = _converter()


def _config(module, save_dir, prefix):
    cfg = module.Config.from_yaml(str(REPO / "configs" / "ys930.yaml"))
    cfg.agent.solver_steps, cfg.agent.save_steps = 100, 20
    cfg.agent.num_parallel = 2
    cfg.agent.replay_capacity = 64
    cfg.agent.probe_every = 0
    cfg.optimizer.batch_size = 4
    cfg.epsilon.start = 0.3
    cfg.save_dir = str(save_dir)
    cfg.prefix = prefix
    return cfg


def _port_trainer(save_dir, prefix, resume=False):
    return ttrain.Trainer(_config(tutils, save_dir, prefix),
                          ground_truth=tenv.GroundTruth.load(str(CACHE_YS930_100)),
                          resume=resume, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    jt = jtrain.Trainer(_config(jutils, tmp, "jax_"),
                        ground_truth=jenv.GroundTruth.load(str(CACHE_YS930_100)),
                        resume=False, data_parallel=False)
    start = CONVERT.dqn_state_arrays(jt.dqn)
    ports = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        tr = _port_trainer(tmp, f"port{name}_")
        tr.dqn = dqn_state_from_numpy(start, tr.dqn_cfg, "cpu", dtype)
        ports[name] = (tr, tr.train(max_steps=STEPS))
    return tmp, (jt, jt.train(max_steps=STEPS)), ports


def test_trainer_matches_jax(runs):
    _, (jt, js), ports = runs
    (t32, s32), (t64, _) = ports["f32"], ports["f64"]
    for k in ("episodes", "global_steps", "grad_steps"):
        assert js[k] == s32[k] == ports["f64"][1][k], k
    assert js["global_steps"] == STEPS and js["grad_steps"] >= 8
    jm, tm = jt.metrics, t32.metrics
    assert tm.actions == jm.actions == t64.metrics.actions
    assert tm.epss == jm.epss
    # Both kinds of action occurred.
    flat = [a for ep in jm.actions for a in ep]
    assert len(jm.actions) >= 2 and len(set(flat)) >= 3
    np.testing.assert_allclose(tm.rewards, jm.rewards, rtol=REWARD_REL, atol=0)
    for a, b in zip(tm.ep_rewards, jm.ep_rewards):
        np.testing.assert_allclose(a, b, rtol=REWARD_REL, atol=0)
    assert len(t32.replay) == len(jt.replay) and t32.replay._pos == jt.replay._pos
    ja, ta, ea = (CONVERT.dqn_state_arrays(jt.dqn), dqn_state_to_numpy(t32.dqn),
                  dqn_state_to_numpy(t64.dqn))
    for k in ("num_grads", "select", "opt1/count", "opt1/schedule_count", "opt2/count"):
        assert ja[k] == ta[k] == ea[k], k
    # Losses and parameters: within 2x of JAX's own deviation from the f64 run.
    for m in (jm, tm, t64.metrics):
        m._flush_losses()
    lj, lt, le = (np.asarray(m.losses) for m in (jm, tm, t64.metrics))
    assert len(lj) == len(lt) == len(le) == js["grad_steps"]
    rms = lambda v: float(np.sqrt(np.mean(np.square(v))))  # noqa: E731
    assert rms((lt - le) / le) <= 2 * rms((lj - le) / le)
    assert rms((lj - le) / le) < 1e-4
    keys = sorted(k for k in ja if k.startswith("params"))
    vec = lambda a: np.concatenate([np.asarray(a[k], np.float64).ravel() for k in keys])  # noqa: E731
    assert np.linalg.norm(vec(ta) - vec(ea)) <= 2 * np.linalg.norm(vec(ja) - vec(ea))
    # The replay rings hold the same transitions.
    t32.replay.flush()
    jt.replay.flush()
    for name in ("x", "ei", "action", "reward", "non_final"):
        np.testing.assert_array_equal(getattr(t32.replay.store, name).numpy(),
                                      np.asarray(getattr(jt.replay.store, name)), name)


def test_metric_artifacts_read_by_jax(runs):
    tmp, _, ports = runs
    tr = ports["f32"][0]
    jm = jtrain.MetricsRecorder(tr.save_dir, tr.config.prefix)
    jm.load()
    assert jm.rewards == tr.metrics.rewards
    assert jm.actions == tr.metrics.actions
    assert jm.epss == tr.metrics.epss
    assert jm.losses == tr.metrics.losses
    assert [list(r) for r in jm.ep_rewards] == tr.metrics.ep_rewards
    events = [e["event"] for e in tutils.read_jsonl(os.path.join(tr.save_dir,
                                                                 "train_log.jsonl"))]
    assert events.count("episode") == tr.state.episode


def test_resume_and_metric_truncation(runs):
    """A fresh Trainer resumes the checkpoint the run ended with: counters,
    both nets and both Adam states exactly; metric arrays written ahead of
    the checkpoint are cut back to its counters."""
    tmp, _, ports = runs
    tr = ports["f32"][0]
    d = tmp / "resume"
    shutil.copytree(tr.save_dir, d / "portf32")
    m = ttrain.MetricsRecorder(str(d / "portf32"), "portf32_")
    m.load()
    m.rewards += [1.0, 2.0]
    m.ep_rewards += [[1.0], [2.0]]
    m.actions += [[3], [4]]
    m.epss += [0.5] * 3
    m.losses += [9.0] * 5
    m.write()
    t2 = _port_trainer(d, "portf32_", resume=True)
    assert (t2.state.global_step, t2.state.episode) == (tr.state.global_step, tr.state.episode)
    for a, b in zip(dqn_state_to_numpy(tr.dqn).items(), dqn_state_to_numpy(t2.dqn).items()):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1], a[0])
    assert t2.metrics.rewards == tr.metrics.rewards
    assert t2.metrics.actions == tr.metrics.actions
    assert t2.metrics.epss == tr.metrics.epss
    assert t2.metrics.losses == tr.metrics.losses
    for a, b in ((t2.dqn.opt1, tr.dqn.opt1), (t2.dqn.opt2, tr.dqn.opt2)):
        assert [g["lr"] for g in a.param_groups] == [g["lr"] for g in b.param_groups]
    assert t2.dqn.sched1.last_epoch == tr.dqn.sched1.last_epoch
    s = t2.train(max_steps=t2.state.global_step + 4)
    assert s["global_steps"] == tr.state.global_step + 4


def test_stop_file_lossless_exit(runs, monkeypatch):
    tmp, _, _ = runs
    tr = _port_trainer(tmp / "stop", "stop_")
    tr.train(max_steps=5)
    open(os.path.join(tr.save_dir, "STOP"), "w").close()

    class _Exit(Exception):
        pass

    monkeypatch.setattr(os, "_exit", lambda code: (_ for _ in ()).throw(_Exit(code)))
    with pytest.raises(_Exit) as ei:
        tr.train(num_episodes=10**6, max_steps=10**9)
    assert ei.value.args[0] == 0
    assert not os.path.exists(os.path.join(tr.save_dir, "STOP"))
    events = [e["event"] for e in tutils.read_jsonl(os.path.join(tr.save_dir,
                                                                 "train_log.jsonl"))]
    assert "stop" in events
    t2 = _port_trainer(tmp / "stop", "stop_", resume=True)
    assert (t2.state.global_step, t2.state.episode) == (tr.state.global_step, tr.state.episode)
    assert (len(t2.replay), t2.replay._pos) == (len(tr.replay), tr.replay._pos)
    for name in ("x", "ei", "action", "reward", "non_final"):
        assert torch.equal(getattr(t2.replay.store, name), getattr(tr.replay.store, name))
    for a, b in zip(dqn_state_to_numpy(tr.dqn).values(), dqn_state_to_numpy(t2.dqn).values()):
        np.testing.assert_array_equal(a, b)


def test_deploy_probe_matches_jax(runs):
    """One greedy probe episode from the trained nets: the same removals,
    reward and terminal as the JAX trainer's probe, and ckpt_best_deploy
    written on the new high."""
    _, (jt, _), ports = runs
    tr = ports["f32"][0]
    jt._deploy_probe(max_steps=6)
    got = tr._deploy_probe(max_steps=6)
    last = lambda path: [e for e in tutils.read_jsonl(path)  # noqa: E731
                         if e["event"] == "deploy_probe"][-1]
    je = last(os.path.join(jt.save_dir, "train_log.jsonl"))
    te = last(os.path.join(tr.save_dir, "train_log.jsonl"))
    for k in ("removals", "removals_ok", "removals_failed", "terminal", "best"):
        assert te[k] == je[k], k
    assert te["reward"] == pytest.approx(je["reward"], rel=REWARD_REL, abs=1e-12)
    assert got["best"] and ttrain.CheckpointManager(
        os.path.join(tr.save_dir, "ckpt_best_deploy")).latest_step() == tr.state.episode


def test_cli_train_cpu(tmp_path):
    cfg = _config(tutils, tmp_path, "cli_")
    run = tmp_path / "cli"
    run.mkdir()
    shutil.copy(CACHE_YS930_100, run / "ground_truth.npz")
    (run / "ground_truth_meta.json").write_text(json.dumps(gt_fingerprint(cfg)))
    path = tmp_path / "cli.yaml"
    cfg.to_yaml(str(path))
    tr = tcli.main(["--config", str(path), "--cpu", "--max-steps", "6", "--no-resume",
                    "agent.num_parallel=3"])
    assert len(tr.envs) == 3 and tr.state.global_step == 6
    assert tr.device.type == "cpu" and int(tr.dqn.num_grads) >= 1
    for f in ("config.yaml", "train_log.jsonl", "cli_reward.npy", "cli_losses.npy",
              "cli_eps.npy", "cli_actions.npy", "cli_rewards.npy"):
        assert (run / f).exists(), f
    step = ttrain.CheckpointManager(str(run / "ckpt")).latest_step()
    assert (run / "ckpt" / f"step_{step}" / "tree.pt").exists()
    assert json.loads((run / "ckpt" / f"step_{step}" / "extras.json").read_text())[
        "global_step"] == 6


def test_entry_points_need_cuda_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(tutils, tmp_path, "nocuda_")
    gt = tenv.GroundTruth.load(str(CACHE_YS930_100))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.Trainer(cfg, ground_truth=gt)
    path = tmp_path / "c.yaml"
    cfg.to_yaml(str(path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--config", str(path), "--max-steps", "1"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        ttrain.Trainer(copy.deepcopy(cfg), ground_truth=gt, data_parallel=True, device="cpu")
    assert jax.default_backend() == "cpu"

#!/usr/bin/env python3
"""Write the JAX package's gradient steps on ys930 for the port to match.

    JAX_PLATFORMS=cpu python3 scripts/torch_train_fixture.py

Runs on the CPU with the JAX package (~1 min) and writes
meshdqn_tpu_torch/data/ys930_train_fixture.npz (savez_compressed):

* a pool of POOL transitions from a seeded rollout of the ys930 pack's env
  (its config.yaml and ground_truth.npz; each action the trained greedy
  net's with probability 1/2, else uniform over the 181 actions; resets on
  episode end), stored as the replay ring stores them: x, ei, ea, nm, em
  with a leading [state, next] axis, action, reward, non_final;
* `idx`: K x B indices into the pool, drawn without replacement per step;
* `loss_f32`, `loss_f64`: the K losses of the JAX package's train_step,
  started from meshdqn_tpu_torch/data/ys930_ckpt_state.npz (the pack's
  latest checkpoint, step 46075) under the pack's DQNConfig, in f32 and in
  f64 (parameters, Adam moments and features in f64; the JAX forward casts
  its features to f32, so the f64 run evaluates the same network with the
  cast removed);
* `f32/<path>`, `f64/<path>`: params1 after the K steps.
"""
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "meshdqn_tpu_torch", "data", "ys930_train_fixture.npz")
STATE = os.path.join(REPO, "meshdqn_tpu_torch", "data", "ys930_ckpt_state.npz")
POOL, K, B, SEED = 64, 4, 32, 8


def forward_f64(params, g, topk=0.5, embedding=False, head="softmax"):
    """meshdqn_tpu.models.forward with the features in the parameters'
    dtype instead of f32."""
    import jax
    import jax.numpy as jnp

    from meshdqn_tpu.models import layers as L
    from meshdqn_tpu.models.noderemoval import stage_sizes

    x = g.x.astype(params["lin3"]["w"].dtype)
    ei, em, nm = g.edge_index, g.edge_mask, g.node_mask
    reads = []
    blocks = [(L.sage_conv, "conv1", "pool1"), (L.sage_conv, "conv2", "pool2"),
              (L.gcn_conv, "conv4", "pool4"), (L.gcn_conv, "conv5", "pool5")]
    for (conv, c, p), k in zip(blocks, stage_sizes(x.shape[0], topk)):
        h = jax.nn.relu(conv(params[c], x, ei, em, nm))
        pg = L.topk_pool(params[p], h, ei, em, nm, topk, k)
        reads.append(jnp.concatenate([L.global_max_pool(pg.x, pg.node_mask),
                                      L.global_mean_pool(pg.x, pg.node_mask)]))
        x, ei, em, nm = pg.x, pg.edge_index, pg.edge_mask, pg.node_mask
    h = reads[0] + reads[1] + reads[2] + reads[3]
    h = jax.nn.relu(L.linear(params["lin1"], h))
    h = jax.nn.relu(L.linear(params["lin2"], h))
    h = L.linear(params["lin3"], h)
    return jax.nn.softmax(h) if head == "softmax" else h


def rollout(cfg, gt, params1):
    """POOL transitions as ring arrays."""
    from meshdqn_tpu.env import AirfoilEnv
    from meshdqn_tpu.rl import ReplayBuffer, select_action

    env = AirfoilEnv(cfg, ground_truth=gt)
    n_feat = 2 + 3 * (cfg.agent.solver_steps // cfg.agent.save_steps)
    buf = ReplayBuffer(POOL, cfg.agent.N_closest, n_feat, cfg.agent.edge_budget)
    rng = np.random.default_rng(SEED)
    state = env.reset()
    while len(buf) < POOL:
        if rng.random() < 0.5:
            a = int(rng.integers(0, cfg.agent.N_closest + 1))
        else:
            a = int(select_action(params1, state, topk=0.1))
        nxt, rew, done, _ = env.step(a)
        buf.push(state, a, None if done else nxt, rew)
        state = env.reset() if done else nxt
    return {k: getattr(buf, "_" + k) for k in
            ("x", "ei", "ea", "nm", "em", "action", "reward", "non_final")}


def run_steps(state, pool, idx, cfg):
    """K train_steps on the pool's batches: (losses, params1 leaves)."""
    import jax.numpy as jnp

    from meshdqn_tpu.env.graph import GraphState
    from meshdqn_tpu.rl import TransitionBatch, train_step

    losses = []
    for k in range(len(idx)):
        i = idx[k]

        def graph(slot):
            return GraphState(x=jnp.asarray(pool["x"][slot, i]),
                              edge_index=jnp.asarray(pool["ei"][slot, i]),
                              edge_attr=jnp.asarray(pool["ea"][slot, i]),
                              node_mask=jnp.asarray(pool["nm"][slot, i]),
                              edge_mask=jnp.asarray(pool["em"][slot, i]))

        batch = TransitionBatch(graph(0), jnp.asarray(pool["action"][i]), graph(1),
                                jnp.asarray(pool["reward"][i]),
                                jnp.asarray(pool["non_final"][i]))
        state, loss = train_step(state, batch, cfg)
        losses.append(float(loss))
    leaves = {f"{layer}/{name}": np.asarray(v) for layer, d in state.params1.items()
              for name, v in d.items()}
    return np.asarray(losses), leaves


def main() -> int:
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import jax.numpy as jnp

    import meshdqn_tpu.rl.dqn as jdqn
    from meshdqn_tpu.env import GroundTruth
    from meshdqn_tpu.utils import Config
    from torch_convert_checkpoint import jax_dqn_config, jax_dqn_state

    run = os.path.join(REPO, "checkpoints", "ys930_results")
    cfg = Config.from_yaml(os.path.join(run, "config.yaml"))
    gt = GroundTruth.load(os.path.join(run, "ground_truth.npz"))
    dcfg = jax_dqn_config(cfg)
    with np.load(STATE) as z:
        arrays = {k: z[k] for k in z.files if k not in ("step", "extras_json")}
        step = int(z["step"])
    state32 = jax_dqn_state(arrays, dcfg)
    pool = rollout(cfg, gt, state32.params1)
    rng = np.random.default_rng(SEED + 1)
    idx = np.stack([rng.choice(POOL, B, replace=False) for _ in range(K)]).astype(np.int32)

    loss32, p32 = run_steps(state32, pool, idx, dcfg)
    forward = jdqn.forward
    jdqn.forward = forward_f64  # read by dqn_loss's vmap when it traces
    try:
        loss64, p64 = run_steps(jax_dqn_state(arrays, dcfg, jnp.float64), pool, idx, dcfg)
    finally:
        jdqn.forward = forward
    np.savez_compressed(
        OUT, idx=idx, loss_f32=loss32, loss_f64=loss64, state_step=np.int64(step),
        dqn_config_json=np.asarray(json.dumps(dcfg.__dict__, default=list)),
        **{f"pool/{k}": v for k, v in pool.items()},
        **{f"f32/{k}": v for k, v in p32.items()},
        **{f"f64/{k}": v for k, v in p64.items()})
    print(f"pool {POOL} (non_final {int(pool['non_final'].sum())}), K={K}, B={B}; "
          f"losses f32 {loss32.tolist()}, f64 {loss64.tolist()}; "
          f"{OUT} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

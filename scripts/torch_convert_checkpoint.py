#!/usr/bin/env python3
"""Convert a pack's checkpoint into a numpy file the PyTorch/CUDA port loads.

    JAX_PLATFORMS=cpu python3 scripts/torch_convert_checkpoint.py [PACK ...]
    JAX_PLATFORMS=cpu python3 scripts/torch_convert_checkpoint.py --state [PACK ...]

PACK names a pack under checkpoints/ (default: ys930 and ah93w145; with
--state: ys930).  The checkpoint is an orbax tree of the JAX package's
DQNState; orbax restores it only into a template whose optimizer chain has
the trained config's shape, so the template is built from the pack's own
config.yaml exactly as meshdqn_tpu/train/trainer.py builds it.

Without --state, the greedy net of `ckpt_best_deploy` goes to
meshdqn_tpu_torch/data/<pack>_ckpt_best_deploy.npz
(`meshdqn_tpu_torch.convert.load_deploy_weights`):

* one array per leaf of `params1`, keyed by its path in the parameter tree
  (`conv1/lin_l_w`, ..., `pool5/w`, `lin3/b`), f32;
* `step`: the checkpoint's step;
* `extras_json`: the checkpoint's extras.json, as text.

With --state, the whole learner of the latest `ckpt` checkpoint (the one
training resumes from) goes to meshdqn_tpu_torch/data/<pack>_ckpt_state.npz
(`meshdqn_tpu_torch.convert.load_dqn_state`), keyed as
`meshdqn_tpu_torch.rl.dqn.state_arrays`: params1/<path>, params2/<path>,
opt{1,2}/mu/<path> and opt{1,2}/nu/<path> (Adam's moments), opt{1,2}/count
(Adam's count) and opt{1,2}/schedule_count (the LR schedule's), num_grads,
select, with `step` and `extras_json` as above.

Runs on the CPU with the JAX package; the GPU machine needs only the npz.
"""
import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(REPO, "meshdqn_tpu_torch", "data")


def jax_dqn_config(cfg):
    """The JAX package's DQNConfig of a run config, as its Trainer makes it."""
    from meshdqn_tpu.rl import DQNConfig

    return DQNConfig(
        lr=cfg.optimizer.lr, weight_decay=cfg.optimizer.weight_decay,
        gamma=cfg.epsilon.gamma, target_update=cfg.agent.target_update, topk=0.1,
        head=cfg.agent.head, grad_clip=cfg.optimizer.grad_clip,
        target_mode=cfg.agent.target_mode, double=cfg.agent.double,
        target_clip=cfg.optimizer.target_clip, cql_alpha=cfg.optimizer.cql_alpha,
    )


def restore(pack: str, subdir: str):
    """(JAX DQNState, extras, step, run config) of the latest checkpoint
    under checkpoints/<pack>_results/<subdir>, restored through the JAX
    package."""
    import jax

    from meshdqn_tpu.models import init_params
    from meshdqn_tpu.rl import init_dqn
    from meshdqn_tpu.train import CheckpointManager
    from meshdqn_tpu.utils import Config

    run = os.path.join(REPO, "checkpoints", f"{pack}_results")
    cfg = Config.from_yaml(os.path.join(run, "config.yaml"))
    n_actions = cfg.agent.N_closest + 1
    n_feat = 2 + 3 * (cfg.agent.solver_steps // cfg.agent.save_steps)
    p1 = init_params(jax.random.PRNGKey(0), n_feat, n_actions, conv_width=128, topk=0.1)
    p2 = init_params(jax.random.PRNGKey(1), n_feat, n_actions, conv_width=128, topk=0.1)
    dqn = init_dqn(p1, p2, jax_dqn_config(cfg))
    restored = CheckpointManager(os.path.join(run, subdir)).restore(dqn)
    if restored is None:
        raise SystemExit(f"{pack}: no checkpoint under {run}/{subdir}")
    state, extras, step = restored
    return state, extras, step, cfg


def restore_params1(pack: str):
    """(params1 leaves by path, step, extras) of checkpoints/<pack>_results/
    ckpt_best_deploy, restored through the JAX package."""
    state, extras, step, _ = restore(pack, "ckpt_best_deploy")
    leaves = {f"{layer}/{name}": np.asarray(value)
              for layer, params in state.params1.items()
              for name, value in params.items()}
    return leaves, step, extras


def dqn_state_arrays(state) -> dict:
    """A JAX DQNState's leaves as numpy arrays, keyed as the port's
    `rl.dqn.state_arrays`.  Each optimizer is optax's chain (clip,)
    add_decayed_weights, scale_by_adam (count, mu, nu), scale_by_schedule
    (count); the clip and the weight decay hold no state."""
    out = {}
    for net in ("1", "2"):
        chain = getattr(state, f"opt{net}")
        adam = next(s for s in chain if type(s).__name__ == "ScaleByAdamState")
        sched = next(s for s in chain if type(s).__name__ == "ScaleByScheduleState")
        for kind, tree in (("params", getattr(state, f"params{net}")),
                           ("mu", adam.mu), ("nu", adam.nu)):
            prefix = f"params{net}" if kind == "params" else f"opt{net}/{kind}"
            for layer, params in tree.items():
                for name, value in params.items():
                    out[f"{prefix}/{layer}/{name}"] = np.asarray(value)
        out[f"opt{net}/count"] = np.asarray(adam.count, np.int32)
        out[f"opt{net}/schedule_count"] = np.asarray(sched.count, np.int32)
    out["num_grads"] = np.asarray(state.num_grads, np.int32)
    out["select"] = np.asarray(state.select, bool)
    return out


def jax_dqn_state(arrays: dict, cfg, dtype=None):
    """The inverse of dqn_state_arrays: a JAX DQNState under DQNConfig cfg
    from arrays keyed as the port's `rl.dqn.state_arrays`, float leaves cast
    to `dtype` (default: as stored)."""
    import jax.numpy as jnp

    from meshdqn_tpu.rl import init_dqn

    def tree(prefix):
        out: dict = {}
        for key, value in arrays.items():
            if key.startswith(prefix + "/"):
                layer, name = key[len(prefix) + 1:].split("/")
                out.setdefault(layer, {})[name] = jnp.asarray(np.asarray(value), dtype)
        return out

    state = init_dqn(tree("params1"), tree("params2"), cfg)
    if cfg.target_mode == "copy":  # init_dqn copies net 1; keep net 2's own
        state = state._replace(params2=tree("params2"))
    opts = {}
    for net in ("1", "2"):
        chain = []
        for s in getattr(state, f"opt{net}"):
            name = type(s).__name__
            if name == "ScaleByAdamState":
                s = s._replace(count=jnp.asarray(arrays[f"opt{net}/count"], jnp.int32),
                               mu=tree(f"opt{net}/mu"), nu=tree(f"opt{net}/nu"))
            elif name == "ScaleByScheduleState":
                s = s._replace(count=jnp.asarray(arrays[f"opt{net}/schedule_count"],
                                                 jnp.int32))
            chain.append(s)
        opts[f"opt{net}"] = tuple(chain)
    return state._replace(num_grads=jnp.asarray(arrays["num_grads"], jnp.int32),
                          select=jnp.asarray(arrays["select"], bool), **opts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("packs", nargs="*")
    ap.add_argument("--state", action="store_true",
                    help="the whole learner of ckpt/ into <pack>_ckpt_state.npz")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    os.makedirs(OUT_DIR, exist_ok=True)
    if args.state:
        for pack in args.packs or ["ys930"]:
            state, extras, step, _ = restore(pack, "ckpt")
            arrays = dqn_state_arrays(state)
            out = os.path.join(OUT_DIR, f"{pack}_ckpt_state.npz")
            np.savez_compressed(out, step=np.int64(step),
                                extras_json=np.asarray(json.dumps(extras)), **arrays)
            print(f"{pack}: step {step}, num_grads {int(arrays['num_grads'])}, "
                  f"{len(arrays)} arrays -> {out} ({os.path.getsize(out)} bytes)")
        return 0
    for pack in args.packs or ["ys930", "ah93w145"]:
        leaves, step, extras = restore_params1(pack)
        out = os.path.join(OUT_DIR, f"{pack}_ckpt_best_deploy.npz")
        np.savez(out, step=np.int64(step), extras_json=np.asarray(json.dumps(extras)),
                 **leaves)
        n = sum(v.size for v in leaves.values())
        print(f"{pack}: step {step}, {len(leaves)} leaves, {n} parameters -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

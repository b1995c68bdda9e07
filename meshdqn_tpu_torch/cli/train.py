"""Training entry point of the PyTorch/CUDA port.

    python -m meshdqn_tpu_torch.cli.train --config CONFIG.yaml \
        [--episodes N] [--max-steps N] [--no-resume] [--device cuda|cpu | --cpu] \
        [section.key=value ...]

The flags of meshdqn_tpu/cli/train.py, plus --device.  Runs on CUDA unless
--device or --cpu names another device.  The run directory is
save_dir/<prefix without its trailing '_'>: it must hold the pack's
ground_truth.npz and ground_truth_meta.json (or the config must name a mesh
file to compute one from); the trainer writes there config.yaml,
train_log.jsonl, the metric .npy files, ckpt/, ckpt_best/,
ckpt_best_deploy/ and, at the end of a run that reaches its episode count,
replay.npz.  A run resumes from the newest checkpoint under ckpt/ unless
--no-resume.  Prints the run's summary as one JSON line.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    """Run the trainer; returns it (the summary is printed)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--episodes", type=int, default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA, which must be present")
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")
    ap.add_argument("overrides", nargs="*", help="section.key=value")
    args = ap.parse_args(argv)

    from ..train import Trainer
    from ..utils import Config

    cfg = Config.from_yaml(args.config).apply_overrides(args.overrides)
    trainer = Trainer(cfg, resume=not args.no_resume,
                      device="cpu" if args.cpu else args.device)
    summary = trainer.train(num_episodes=args.episodes, max_steps=args.max_steps)
    print(json.dumps(summary), flush=True)
    return trainer


if __name__ == "__main__":
    main()

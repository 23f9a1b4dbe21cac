"""Standalone transparent-pipeline evaluation (counterpart of
tools/eval_transparent.py): load the latest checkpoint of a training run
(the port's ckpt/<step>/state.pt) of the model the config's
module.transparent_model names (TRPESNet or the PSPNet generation's
TransparentPoseNet), run the trainer's eval over the
dataset the config names (ClearGrasp's val split, or the synthetic
fixture with --synthetic, 16 frames an object), print the per-object
ADD(-S) table as JSON.

Usage:
  python -m pose_estimation_tpu_torch.tools.eval_transparent \\
      --config transparent_cleargrasp --ckpt runs/transparent/ckpt \\
      --dataset_root data/cleargrasp [--max_batches N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="transparent_cleargrasp",
                   help="preset name in configs.schema or a .py file")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint directory of a training run (ckpt/)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--dataset_root", default="data/cleargrasp")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--log_dir", default="runs/eval_transparent")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    args = p.parse_args(argv)

    from pose_estimation_tpu_torch.cli import build_dataset, load_config
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        TransparentTrainer)

    cfg = load_config(args.config)
    ds = build_dataset(cfg, argparse.Namespace(
        synthetic=args.synthetic, dataset_root=args.dataset_root,
        frames_per_object=16), mode="eval")
    trainer = TransparentTrainer(cfg, ds, log_dir=args.log_dir,
                                 resume=args.ckpt, device=args.device)
    trainer.init_state()
    summary = trainer.test_epoch(0, max_batches=args.max_batches)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()

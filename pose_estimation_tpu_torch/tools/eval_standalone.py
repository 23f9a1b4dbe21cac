"""Standalone per-object evaluation (counterpart of
tools/eval_standalone.py, tools/script/eval.py rebuilt).

Loads the latest checkpoint of a training run, runs the trainer's
full-coverage eval over the dataset the config names, with the
on-device pose recovery (optionally region-decoded coordinates,
eval.py:94-105), and prints the per-object ADD(-S) summary at the 0.1d /
0.05d / 0.02d thresholds (eval.py:199-224) as JSON. The dataset is built
as the JAX tool builds it, in mode "train": the train split (train_pbr in
the BOP layout), with the training augmentation. The test split is what
`cli.py --eval_mode` evaluates.

Usage:
  python -m pose_estimation_tpu_torch.tools.eval_standalone \
      --config cfg.py --ckpt runs/exp/ckpt --dataset_root data/linemod \
      [--max_batches N] [--region_decode] [--device cpu]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="lm_v3_1",
                   help="preset name in configs.schema or a .py file")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint directory of a training run (ckpt/)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--dataset_root", default="data/linemod")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--log_dir", default="runs/eval")
    p.add_argument("--region_decode", action="store_true",
                   help="region-decoded coordinates before PnP "
                        "(tools/script/eval.py:94-105); requires a "
                        "checkpoint trained with module.xyz_offset_decode")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    p.add_argument("--enable_rot", action="store_true",
                   help="KRRN with its two rotation heads (the model the "
                        "checkpoint was trained with)")
    args = p.parse_args(argv)

    from pose_estimation_tpu_torch.cli import build_dataset, load_config
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    if args.region_decode:
        cfg = schema.override(cfg, **{"module.xyz_offset_decode": True})
    ds = build_dataset(cfg, argparse.Namespace(
        synthetic=args.synthetic, dataset_root=args.dataset_root,
        frames_per_object=16))
    trainer = Trainer(cfg, ds, log_dir=args.log_dir, device=args.device,
                      enable_rot=args.enable_rot)
    trainer.init_state()
    if args.ckpt:
        from pose_estimation_tpu_torch.train.checkpoint import (
            CheckpointManager)
        CheckpointManager(args.ckpt).restore(trainer.state)
    summary = trainer.test_epoch(0, max_batches=args.max_batches)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()

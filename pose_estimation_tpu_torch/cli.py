"""Training command line (counterpart of the KRRN half of cli.py).

  python -m pose_estimation_tpu_torch.cli --config cfg.py --synthetic \
      --debug --epochs 1 --log_dir runs/smoke [--device cpu]

`--config` is a preset of configs/schema.py or a .py file whose
`get_config()` returns a Config. Only the synthetic dataset is ported (the
LineMOD readers and the transparent trainer are not). The run writes
log_dir/train.jsonl, log_dir/eval.jsonl and checkpoints under
log_dir/ckpt; each eval summary is echoed to stdout as a JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys

from pose_estimation_tpu_torch.configs import schema


def load_config(spec: str) -> schema.Config:
    if spec.endswith(".py"):
        mod_spec = importlib.util.spec_from_file_location("user_config", spec)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.get_config()
    factory = getattr(schema, spec, None)
    if factory is None:
        raise SystemExit(f"unknown config preset: {spec}")
    return factory()


def build_dataset(cfg: schema.Config, args):
    if not (cfg.dataset == "synthetic" or args.synthetic):
        raise SystemExit(f"dataset {cfg.dataset!r}: only --synthetic is "
                         "ported")
    if cfg.pipeline != "krrn":
        raise SystemExit(f"pipeline {cfg.pipeline!r}: only krrn is ported")
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    return SyntheticPoseDataset(num_objects=cfg.module.num_cls,
                                frames_per_object=args.frames_per_object,
                                num_regions=cfg.data.num_regions)


def main(argv=None):
    p = argparse.ArgumentParser("pose_estimation_tpu_torch")
    p.add_argument("--config", "--config_file", default="lm_v3_1",
                   help="preset name in configs.schema or a .py file")
    p.add_argument("--log_file", "--log_dir", dest="log_dir",
                   default="runs/default")
    p.add_argument("--eval_mode", action="store_true")
    p.add_argument("--resume", "--resume_posenet", dest="resume",
                   default=None, help="checkpoint directory to resume from")
    p.add_argument("--debug", action="store_true", help="5-step epochs")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic fixture dataset")
    p.add_argument("--frames_per_object", type=int, default=64)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    dataset = build_dataset(cfg, args)
    from pose_estimation_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg, dataset, log_dir=args.log_dir, resume=args.resume,
                      device=args.device)
    trainer.init_state()
    if args.eval_mode:
        print(json.dumps(trainer.test_epoch(0), indent=2))
        return 0
    trainer.fit(num_epochs=args.epochs,
                steps_per_epoch=5 if args.debug else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())

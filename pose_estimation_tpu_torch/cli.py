"""Training command line (counterpart of cli.py).

  python -m pose_estimation_tpu_torch.cli --config cfg.py --dataset linemod \
      --cls_type all --dataset_root data/linemod --debug --epochs 1 \
      --log_dir runs/smoke [--device cpu]
  python -m pose_estimation_tpu_torch.cli --config transparent_cleargrasp \
      --dataset_root data/cleargrasp --log_dir runs/transparent

`--config` is a preset of configs/schema.py or a .py file whose
`get_config()` returns a Config; `--dataset` and `--cls_type` override its
fields. A config with pipeline="transparent" trains the transparent
model its module.transparent_model names, TRPESNet ("trpes") or the
PSPNet generation's TransparentPoseNet ("posenet")
(train/transparent_trainer.py), any other KRRN. The datasets are the
synthetic fixture (`--synthetic`: the transparent one under the
transparent pipeline), LineMOD in the BOP or the classic layout, YCB-V
(BOP layout) and ClearGrasp under `--dataset_root`. The run writes
log_dir/train.jsonl, log_dir/eval.jsonl and checkpoints under
log_dir/ckpt; each eval summary is echoed to stdout as a JSON line.
`--eval_mode` evaluates the test split (ClearGrasp's val split) once
instead of training.

On N cards of a node, under torchrun (one process a card, NCCL):

  torchrun --nproc_per_node=N -m pose_estimation_tpu_torch.cli ...

trains data-parallel: train.batch_size rows a card, a global batch of
batch_size x N (parallel/dist.py); rank 0 writes the logs, the
checkpoints and stdout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys

from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.parallel import dist

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


def build_dataset(cfg: schema.Config, args, mode: str = "train"):
    """The dataset `cfg` names, for `mode` ("train", "test" or "eval"):
    `args` carries synthetic, frames_per_object, dataset_root and
    background_dir."""
    if cfg.dataset == "synthetic" or getattr(args, "synthetic", False):
        from pose_estimation_tpu_torch.data.synthetic import (
            SyntheticPoseDataset, SyntheticTransparentDataset)
        ds_cls = (SyntheticTransparentDataset
                  if cfg.pipeline == "transparent" else SyntheticPoseDataset)
        return ds_cls(num_objects=cfg.module.num_cls,
                      frames_per_object=args.frames_per_object,
                      num_regions=cfg.data.num_regions)
    if cfg.dataset == "linemod":
        from pose_estimation_tpu_torch.data.linemod import LinemodDataset
        return LinemodDataset(args.dataset_root, mode=mode,
                              cls_type=cfg.cls_type, cfg=cfg)
    if cfg.dataset == "ycb":
        from pose_estimation_tpu_torch.data.ycb import YCBVideoDataset
        # split='train' composes train_real + train_synt with synthetic
        # background paste (dataset.py:43-50,236-244)
        split = "train" if mode == "train" else "test"
        return YCBVideoDataset(args.dataset_root, split=split,
                               cls_type=cfg.cls_type,
                               num_regions=cfg.data.num_regions,
                               background_dir=getattr(
                                   args, "background_dir", None))
    if cfg.dataset == "cleargrasp":
        from pose_estimation_tpu_torch.data.cleargrasp import (
            ClearGraspDataset)
        return ClearGraspDataset(
            args.dataset_root, split="train" if mode == "train" else "val")
    raise SystemExit(f"unknown dataset: {cfg.dataset}")


def main(argv=None):
    p = argparse.ArgumentParser("pose_estimation_tpu_torch")
    p.add_argument("--config", "--config_file", default="lm_v3_1",
                   help="preset name in configs.schema or a .py file")
    p.add_argument("--dataset", default=None,
                   help="synthetic, linemod, ycb or cleargrasp (overrides "
                        "the config)")
    p.add_argument("--cls_type", default=None,
                   help="one object's name, or all (overrides the config)")
    p.add_argument("--dataset_root", default="data/linemod")
    p.add_argument("--log_file", "--log_dir", dest="log_dir",
                   default="runs/default")
    p.add_argument("--eval_mode", action="store_true")
    p.add_argument("--resume", "--resume_posenet", dest="resume",
                   default=None, help="checkpoint directory to resume from")
    p.add_argument("--resume_backbone_only", action="store_true",
                   help="partial restore: copy the --resume checkpoint's "
                        "parameters whose name and shape match, start "
                        "everything else fresh")
    p.add_argument("--debug", action="store_true", help="5-step epochs")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic fixture dataset")
    p.add_argument("--frames_per_object", type=int, default=64)
    p.add_argument("--background_dir", default=None,
                   help="background images pasted behind synthetic frames "
                        "(procedural textures when unset)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    p.add_argument("--enable_rot", action="store_true",
                   help="KRRN with its two rotation heads (pred_r)")
    args = p.parse_args(argv)

    joined = not dist.is_initialized() and dist.distributed_init(
        "gloo" if args.device == "cpu" else None)
    try:
        return _run(args)
    finally:
        if joined:
            dist.destroy()


def _run(args) -> int:
    cfg = load_config(args.config)
    if args.dataset:
        cfg = cfg.replace(dataset=args.dataset)
    if args.cls_type:
        cfg = cfg.replace(cls_type=args.cls_type)

    mode = "eval" if args.eval_mode else "train"
    dataset = build_dataset(cfg, args, mode=mode)
    if cfg.pipeline == "transparent":
        from pose_estimation_tpu_torch.train.transparent_trainer import (
            TransparentTrainer)
        try:
            trainer = TransparentTrainer(cfg, dataset, log_dir=args.log_dir,
                                         resume=args.resume,
                                         device=args.device)
        except ValueError as e:      # build_model refuses the config
            raise SystemExit(str(e)) from e
    else:
        from pose_estimation_tpu_torch.train.trainer import Trainer
        trainer = Trainer(cfg, dataset, log_dir=args.log_dir,
                          resume=args.resume,
                          resume_backbone_only=args.resume_backbone_only,
                          device=args.device, enable_rot=args.enable_rot)
    trainer.init_state()
    if args.eval_mode:
        summary = trainer.test_epoch(0)
        if dist.is_primary():
            print(json.dumps(summary, indent=2))
        return 0
    trainer.fit(num_epochs=args.epochs,
                steps_per_epoch=5 if args.debug else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())

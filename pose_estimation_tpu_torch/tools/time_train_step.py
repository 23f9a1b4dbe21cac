"""Median time of the KRRN train step on the card, as chip_smoke.py phases
7 and 13 take it: schema.Config() (bf16), bs 8, one fixed synthetic batch,
seeded random weights, lr 3e-4 without warmup; with --options the
training options the shipped config leaves off (BatchNorm, the refine
loss, Adam). Prints one JSON line with the package it timed.

  python -m pose_estimation_tpu_torch.tools.time_train_step [--options]

To compare two versions of the package on one card, run this file with
the other version's checkout first on PYTHONPATH, in turns:

  PYTHONPATH=/path/to/other python \\
      pose_estimation_tpu_torch/tools/time_train_step.py --options
"""

from __future__ import annotations

import argparse
import json
import time

import torch

import pose_estimation_tpu_torch
from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.data.batching import make_batch
from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.train.optim import make_optimizer
from pose_estimation_tpu_torch.train.state import TrainState
from pose_estimation_tpu_torch.train.train_step import build_train_step

OPTIONS = {"module.norm": "bn", "train.refine": True,
           "train.optimizer.type": "Adam"}
BS = 8


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--options", action="store_true",
                    help="BatchNorm, the refine loss and Adam")
    ap.add_argument("--steps", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_train_step: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = schema.override(schema.Config(), **{
        "train.lr.lr": 3e-4, "train.lr.warmup_iters": 0,
        **(OPTIONS if args.options else {})})
    ds = SyntheticPoseDataset(num_objects=cfg.module.num_cls,
                              frames_per_object=4,
                              num_regions=cfg.data.num_regions)
    batch = make_batch(ds, [4 * j for j in range(BS)],
                       torch.Generator().manual_seed(3),
                       cfg.data.input_size, cfg.data.num_points)
    batch = {k: v.to(dev) for k, v in batch.items()}
    torch.manual_seed(0)
    model = KRRN(cfg, dtype=torch.bfloat16).to(dev)
    tx = make_optimizer(cfg, total_steps=1000)
    state = TrainState.create(model, tx,
                              torch.Generator(device=dev).manual_seed(0))
    step = build_train_step(model, tx, cfg)
    times = []
    for i in range(args.steps + 2):                      # 2 warm-up steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch, opt_pose=True)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    out = {"package": pose_estimation_tpu_torch.__file__,
           "options": args.options, "bs": BS,
           "median_ms": sorted(times)[len(times) // 2], "ms": times,
           "device": torch.cuda.get_device_name(0)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

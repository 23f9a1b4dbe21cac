"""KRRN's program half: the port's KRRN, its serving entry
(serve.InferStep) and its train step (TrainStep), called as the trainer
calls it."""

from __future__ import annotations

from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.serve import build_infer_step
from pose_estimation_tpu_torch.train.train_step import build_train_step


def build(cfg, dtype, cfg_file: dict):
    return KRRN(cfg, dtype=dtype,
                fusion_variant=cfg_file.get("fusion_variant", "lite"))


infer_step = build_infer_step
train_step = build_train_step


def call_train(step, state, batch):
    return step(state, batch, opt_pose=True)

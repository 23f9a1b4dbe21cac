"""TRPESNet's program half: the port's TRPESNet on the UNet and its
train step (TransparentTrainStep), called as the trainer calls it. It
has no serving entry."""

from __future__ import annotations

from pose_estimation_tpu_torch.models.transparent import TRPESNet
from pose_estimation_tpu_torch.train.transparent_trainer import (
    TransparentTrainStep, loss_weights)


def build(cfg, dtype, cfg_file: dict):
    return TRPESNet(num_points=cfg.data.num_points,
                    num_obj=cfg.module.num_cls, dtype=dtype)


def train_step(model, tx, cfg):
    return TransparentTrainStep(model, tx, loss_weights(cfg))


def call_train(step, state, batch):
    return step(state, batch)

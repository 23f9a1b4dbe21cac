"""The PSPNet generation's program half: the port's TransparentPoseNet
built by the transparent trainer's own build_model, and its train step
(TransparentTrainStep), called as the trainer calls it. It has no
serving entry."""

from __future__ import annotations

from pose_estimation_tpu_torch.train.transparent_trainer import (
    TransparentTrainStep, build_model, loss_weights)


def build(cfg, dtype, cfg_file: dict):
    model = build_model(cfg, device="meta")
    if model.dtype != dtype:
        raise ValueError(f"train.amp gives {model.dtype}, the configuration "
                         f"file states {dtype}")
    return model


def train_step(model, tx, cfg):
    return TransparentTrainStep(model, tx, loss_weights(cfg))


def call_train(step, state, batch):
    return step(state, batch)

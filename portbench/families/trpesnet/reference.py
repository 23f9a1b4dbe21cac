"""TRPESNet's reference half: the plain fp32 TRPESNet (the UNet,
GeometryNet, DenseFusion and its heads), its pool of transparent frames,
its loss with the chosen pixels' draw, one step for the FLOP count and
its tiny CPU cut. Imports nothing of the program."""

from __future__ import annotations

import torch

from portbench.gen.pool import transparent_pool
from portbench.reference.trpesnet import (TRPESNet, loss_weights,
                                          transparent_loss)


def reference_model(cfg_file: dict, q):
    return TRPESNet(cfg_file["schema"], q)


def pool(schema: dict, mix: dict, seed: int) -> list:
    if mix["driver"] == "serve":
        raise ValueError("no serving traffic for the transparent model")
    return transparent_pool(schema, mix, seed)


def loss(model, schema: dict, batch: dict, gen):
    """The training loss at the chosen pixels, one permutation of H*W
    drawn from `gen` as the program draws it."""
    hw = batch["img"].shape[1] * batch["img"].shape[2]
    choose = torch.randperm(hw, generator=gen,
                            device=gen.device)[:model.num_points]
    return transparent_loss(model(batch, choose), batch,
                            loss_weights(schema))


def flop_step(model, schema: dict, batch: dict, train: bool):
    """The forward of one step at fixed chosen pixels (the count does not
    depend on which), and its loss when `train`."""
    hw = batch["img"].shape[1] * batch["img"].shape[2]
    choose = torch.arange(model.num_points, device=batch["img"].device) % hw
    out = model(batch, choose)
    return transparent_loss(out, batch, loss_weights(schema)) if train \
        else None


def tiny(schema: dict):
    """Cut `schema` in place to a CPU size."""
    schema["module"].update(num_cls=3)
    schema["data"].update(num_points=32, input_size=32)

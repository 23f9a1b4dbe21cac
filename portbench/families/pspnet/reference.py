"""The PSPNet generation's reference half: the plain fp32
TransparentPoseNet (reference/pspnet.py), its pool of transparent frames,
its loss with the program's draws (the pixels [B, n] with replacement,
then the decoder's seven dropout masks), one step for the FLOP count and
its tiny CPU cut. Imports nothing of the program."""

from __future__ import annotations

import torch

from portbench.gen.pool import transparent_pool
from portbench.reference.pspnet import (TransparentPoseNet, draws,
                                        loss_weights, transparent_loss)


def reference_model(cfg_file: dict, q):
    return TransparentPoseNet(cfg_file["schema"], q)


def pool(schema: dict, mix: dict, seed: int) -> list:
    if mix["driver"] == "serve":
        raise ValueError("no serving traffic for the transparent model")
    return transparent_pool(schema, mix, seed)


def loss(model, schema: dict, batch: dict, gen):
    """The training loss, its draws from `gen` as the program makes
    them."""
    b, h, w, _ = batch["img"].shape
    choose, masks = draws(gen, b, h, w, model.num_points)
    return transparent_loss(model(batch, choose, masks), batch,
                            loss_weights(schema))


def flop_step(model, schema: dict, batch: dict, train: bool):
    """The forward of one step at fixed pixels and without dropout (the
    count depends on neither), and its loss when `train`."""
    b, h, w, _ = batch["img"].shape
    choose = (torch.arange(model.num_points, device=batch["img"].device)
              % (h * w)).expand(b, -1)
    out = model(batch, choose)
    return transparent_loss(out, batch, loss_weights(schema)) if train \
        else None


def tiny(schema: dict):
    """Cut `schema` in place to a CPU size (64-px crops: the PSP pyramid
    pools 6 x 6 of the 8 x 8 features)."""
    schema["module"].update(num_cls=3)
    schema["data"].update(num_points=32, input_size=64)

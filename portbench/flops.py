"""The model FLOPs of one step, counted once with
torch.utils.flop_counter on the benchmark's plain reference at the cell's
shapes, on the meta device (no memory, no compute): matrix products and
convolutions, forward (serving) or forward, loss and backward (training).
A later change to the program cannot change the count."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.layers import Precision
from portbench.reference.train import krrn_loss
from portbench.reference.trpesnet import loss_weights, transparent_loss
from portbench.weights import reference_model


def _meta_batch(batch: dict) -> dict:
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in batch.items()}


def step_flops(cfg_file: dict, batch: dict, train: bool) -> float:
    """FLOPs of one step on a batch shaped like `batch`."""
    with torch.device("meta"):
        model = reference_model(cfg_file, Precision("fp32"))
    b = _meta_batch(batch)
    with FlopCounterMode(display=False) as counter:
        if cfg_file["model"] == "krrn":
            out = model(b["img"], b["cloud"], b["choose"], b["cls"])
            if train:
                lw = cfg_file["schema"]["train"]["loss"]
                krrn_loss(out, b, lw).backward()
        else:
            hw = b["img"].shape[1] * b["img"].shape[2]
            choose = torch.arange(model.num_points, device="meta") % hw
            out = model(b, choose)
            if train:
                transparent_loss(out, b, loss_weights(cfg_file["schema"])
                                 ).backward()
    return float(counter.get_total_flops())

"""The model FLOPs of one step, counted once with
torch.utils.flop_counter on the benchmark's plain reference at the cell's
shapes, on the meta device (no memory, no compute): matrix products and
convolutions, forward (serving) or forward, loss and backward (training).
A later change to the program cannot change the count."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.layers import Precision
from portbench import found


def _meta_batch(batch: dict) -> dict:
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in batch.items()}


def step_flops(cfg_file: dict, batch: dict, train: bool) -> float:
    """FLOPs of one step on a batch shaped like `batch`."""
    fam = found.family(cfg_file["model"], "reference")
    with torch.device("meta"):
        model = fam.reference_model(cfg_file, Precision("fp32"))
    b = _meta_batch(batch)
    with FlopCounterMode(display=False) as counter:
        loss = fam.flop_step(model, cfg_file["schema"], b, train)
        if train:
            loss.backward()
    return float(counter.get_total_flops())

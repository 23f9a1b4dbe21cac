"""Checkpoints of the whole TrainState (counterpart of train/checkpoint.py's
CheckpointManager): one directory per step under `directory`, holding
`state.pt` (torch.save of TrainState.state_dict(): parameters and a
BatchNorm's running statistics, optimizer state, step, generator state,
best distance, LR scale) and `metrics.json`. The newest `max_to_keep` steps
are kept. A save writes to a temporary file first, so a step directory
never holds a half-written state. Under a process group rank 0 writes
and every rank waits at a barrier until the step is on disk; every rank
reads (the trainer loads a checkpoint on every rank or on none).

`merge_partial_params` is the partial (backbone-only) restore, and
`save_params_npz` writes a model's parameters in the JAX package's
params-only .npz layout.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from pose_estimation_tpu_torch.convert import torch_to_flax
from pose_estimation_tpu_torch.parallel import dist


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, "state.pt")))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, metrics: dict | None = None):
        """Write `state` as step `step` (an existing one is replaced): on
        rank 0, then a barrier of the group."""
        if dist.is_primary():
            path = os.path.join(self.directory, str(int(step)))
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, "state.pt.tmp")
            torch.save(state.state_dict(), tmp)
            os.replace(tmp, os.path.join(path, "state.pt"))
            with open(os.path.join(path, "metrics.json"), "w") as f:
                json.dump(metrics or {}, f)
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        dist.barrier()

    def read(self, step: int) -> dict:
        """Step `step`'s saved state dict, on the CPU."""
        return torch.load(os.path.join(self.directory, str(step), "state.pt"),
                          map_location="cpu", weights_only=True)

    def restore(self, state):
        """Load the latest step into `state` in place and return it; None
        when there is no checkpoint."""
        step = self.latest_step()
        if step is None:
            return None
        return state.load_state_dict(self.read(step))

    @torch.no_grad()
    def merge_partial_params(self, model: torch.nn.Module) -> int:
        """Partial / backbone-only restore (load_part_module,
        lib/utils/utlis.py:37-52): read the latest checkpoint with no
        template (the saved model may differ), copy into `model` every
        parameter whose name it has with the same shape, leave the rest
        (a BatchNorm's running statistics stay fresh, as the JAX
        version merges `params` leaves only), and return the count of
        parameters copied (0 with no checkpoint)."""
        step = self.latest_step()
        if step is None:
            return 0
        saved = self.read(step)["model"]
        merged = 0
        for name, p in model.named_parameters():
            src = saved.get(name)
            if src is not None and tuple(src.shape) == tuple(p.shape):
                p.copy_(src)
                merged += 1
        return merged


def save_params_npz(path: str, model: torch.nn.Module) -> None:
    """The model's parameters (no running statistics, as the JAX file
    holds `params` only) as one .npz in the flax layout, '/'-joined key
    paths (convert.torch_to_flax): the file the JAX package's
    save_params_npz writes, which its load_params_npz, this package's
    convert.load_params_npz and both tools/infer.py --params read."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **torch_to_flax(dict(model.named_parameters())))
    os.replace(tmp, path)

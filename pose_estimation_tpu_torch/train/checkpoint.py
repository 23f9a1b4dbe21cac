"""Checkpoints of the whole TrainState (counterpart of
train/checkpoint.py's CheckpointManager): one directory per step under
`directory`, holding `state.pt` (torch.save of TrainState.state_dict():
parameters, optimizer state, step, generator state, best distance, LR
scale) and `metrics.json`. The newest `max_to_keep` steps are kept. A
save writes to a temporary file first, so a step directory never holds a
half-written state.
"""

from __future__ import annotations

import json
import os
import shutil

import torch


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
        """Write `state` as step `step` (an existing one is replaced)."""
        path = os.path.join(self.directory, str(int(step)))
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "state.pt.tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))
        with open(os.path.join(path, "metrics.json"), "w") as f:
            json.dump(metrics or {}, f)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, state):
        """Load the latest step into `state` in place and return it; None
        when there is no checkpoint."""
        step = self.latest_step()
        if step is None:
            return None
        sd = torch.load(os.path.join(self.directory, str(step), "state.pt"),
                        map_location="cpu", weights_only=True)
        return state.load_state_dict(sd)

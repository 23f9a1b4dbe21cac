"""Serving traffic, one request at a time in a closed loop (run.py's loop).
Each request copies a pool batch from pinned host memory to the card,
calls InferStep.__call__ with the batch's RANSAC subsets, and copies the
poses back to the host."""

from __future__ import annotations

import time

import torch

from portbench import program
from portbench.check import serve as check_serve
from portbench.gen.pool import make_pool
from portbench.weights import make_weights

OUT_KEYS = ("pred_r", "pred_t", "pnp_t", "num_inliers")
STAGES = ("forward", "solve")


class Serve:
    kind = "serve"
    stages = STAGES

    def __init__(self, cfg_file: dict, mix: dict, seed: int, device):
        self.cfg_file, self.mix, self.seed, self.dev = (cfg_file, mix, seed,
                                                        device)
        t = time.perf_counter()
        self.weights = make_weights(cfg_file, seed, device)
        self.timings = {"weights": time.perf_counter() - t}
        self.pool = [{k: v.pin_memory() if device.type == "cuda" else v
                      for k, v in b.items()} for b in
                     make_pool(cfg_file, mix, seed)]
        self.timings["pool"] = time.perf_counter() - t - self.timings["weights"]
        model = program.build_model(cfg_file, self.weights, device)
        self.entry = program.infer_step(model, cfg_file)
        self.timings["model"] = time.perf_counter() - t - sum(
            self.timings.values())
        self.outputs = []            # host outputs of the window's requests
        self.forward_out = {}        # the last forward's outputs per batch
        self._current = 0
        forward = self.entry.forward

        def keep_forward(batch):
            out = forward(batch)
            self.forward_out[self._current] = out
            return out
        self.entry.forward = keep_forward
        self.batch_size = mix["batch_size"]

    def step(self, i: int, record: bool = True):
        p = i % len(self.pool)
        self._current = p
        batch = {k: v.to(self.dev, non_blocking=True)
                 for k, v in self.pool[p].items()}
        out = self.entry(batch, subset_ids=batch["subset_ids"])
        host = {k: out[k].to("cpu") for k in OUT_KEYS}
        if record:
            self.outputs.append((p, host))
        return host

    def units(self, steps: int) -> int:
        return steps * self.batch_size

    def release(self, steps: int = 0):
        """Drop the program's objects, keeping the window's outputs and
        the last forward outputs per batch."""
        self.entry = None

    def check(self, limits: dict) -> dict:
        return check_serve.numbers(self, limits)

    def control(self) -> dict:
        return check_serve.control_numbers(self)


Driver = Serve

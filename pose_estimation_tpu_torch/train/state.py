"""Train state (counterpart of train/state.py): the model's parameters, the
optimizer state, the step count, the generator of the training draws, the
best eval distance and the manual-decay LR scale, all of which a
checkpoint carries.

Unlike the JAX package's immutable pytree, the port updates in place:
`apply_gradients` adds the updates to the module's parameters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn


def _params(model: nn.Module) -> dict:
    return {k: p.detach() for k, p in model.named_parameters()}


def _to(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    return obj


@dataclass
class TrainState:
    model: nn.Module
    opt_state: dict
    generator: torch.Generator
    step: int = 0
    best_dis: float = math.inf
    lr_scale: float = 1.0

    @classmethod
    def create(cls, model: nn.Module, tx, generator: torch.Generator):
        return cls(model=model, opt_state=tx.init(_params(model)),
                   generator=generator)

    @property
    def params(self) -> dict:
        return _params(self.model)

    @torch.no_grad()
    def apply_gradients(self, tx, grads: dict) -> "TrainState":
        params = self.params
        updates, self.opt_state = tx.update(grads, self.opt_state, params,
                                            lr_scale=self.lr_scale)
        for k, p in params.items():
            p.add_(updates[k])
        self.step += 1
        return self

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "opt_state": self.opt_state,
                "generator": self.generator.get_state(),
                "best_dis": self.best_dis, "lr_scale": self.lr_scale}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> "TrainState":
        self.model.load_state_dict(sd["model"], strict=True)
        self.opt_state = _to(sd["opt_state"],
                             next(self.model.parameters()).device)
        self.generator.set_state(sd["generator"].cpu())
        self.step = int(sd["step"])
        self.best_dis = float(sd["best_dis"])
        self.lr_scale = float(sd["lr_scale"])
        return self

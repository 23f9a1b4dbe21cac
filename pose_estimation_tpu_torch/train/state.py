"""Train state (counterpart of train/state.py): the model's parameters and
running statistics (a BatchNorm model's batch_stats), the optimizer state,
the step count, the generator of the training draws, the best eval distance
and the manual-decay LR scale, all of which a checkpoint carries.

Unlike the JAX package's immutable pytree, the port updates in place:
`apply_gradients` adds the updates to the module's parameters
(`apply_ranger`, Ranger's step on the card, the optimizer state too), and a
training forward moves the running statistics, on a step that the NaN
guard skips too (the JAX step applies new_batch_stats whatever the guard
says).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from pose_estimation_tpu_torch.ops.optim import ranger_apply
from pose_estimation_tpu_torch.utils.profiling import span


def _params(model: nn.Module) -> dict:
    return {k: p.detach() for k, p in model.named_parameters()}


def _check_fits(path: str, own, new) -> None:
    """Raise ValueError unless `new` has the keys, and tensors of the
    shapes, that `own` has (nested dicts of tensors and scalars)."""
    if isinstance(own, dict):
        if not isinstance(new, dict) or own.keys() != new.keys():
            raise ValueError(f"{path}: keys differ")
        for k in own:
            _check_fits(f"{path}.{k}", own[k], new[k])
    elif isinstance(own, torch.Tensor) and (
            not isinstance(new, torch.Tensor) or own.shape != new.shape):
        raise ValueError(f"{path}: shape {tuple(own.shape)}, checkpoint "
                         f"{getattr(new, 'shape', type(new).__name__)}")


def _to(obj, dev):
    """obj's tensors copied to `dev`, contiguous: the optimizer state is
    updated in place on the card (ops.optim.ranger_apply), so it shares
    no memory with the state dict it came from."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev, copy=True, memory_format=torch.contiguous_format)
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
        with span("optim.update"):
            updates, self.opt_state = tx.update(
                grads, self.opt_state, params, lr_scale=self.lr_scale)
        with span("state.apply"):
            for k, p in params.items():
                p.add_(updates[k])
        self.step += 1
        return self

    @torch.no_grad()
    def apply_ranger(self, tx, grads: dict, loss: torch.Tensor) -> tuple:
        """The NaN guard and `tx`'s (a Ranger's) update in place, in one
        call of ops.optim.ranger_apply; (gnorm, finite) as the guard
        reports them."""
        with span("optim.update"):
            out = ranger_apply(self.params, grads, self.opt_state, loss,
                               **tx.step_args(self.opt_state["count"],
                                              self.lr_scale))
        self.step += 1
        return out

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "opt_state": self.opt_state,
                "generator": self.generator.get_state(),
                "best_dis": self.best_dis, "lr_scale": self.lr_scale}

    def check_state_dict(self, sd: dict) -> tuple:
        """Raise ValueError unless `sd` fits this state: its keys, the
        shapes of the parameters, the optimizer state and the generator
        state (a CPU and a CUDA generator's differ); its scalars (step,
        best_dis, lr_scale) read."""
        _check_fits("state", self.state_dict(), sd)
        return (int(sd["step"]), float(sd["best_dis"]),
                float(sd["lr_scale"]))

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> "TrainState":
        """Load `sd` in place, or raise and change nothing: it is checked
        (check_state_dict) before anything is copied
        (nn.Module.load_state_dict copies every tensor whose shape fits
        before it raises on one that does not)."""
        step, best_dis, lr_scale = self.check_state_dict(sd)
        self.model.load_state_dict(sd["model"], strict=True)
        self.opt_state = _to(sd["opt_state"],
                             next(self.model.parameters()).device)
        self.generator.set_state(sd["generator"].cpu())
        self.step, self.best_dis, self.lr_scale = step, best_dis, lr_scale
        return self

"""Ranger, Adam and the LR schedules (counterpart of train/optim.py),
written in torch.

Parameters, gradients, updates and moments are dicts {name: tensor} in the
port's layout (a module's named_parameters). `make_optimizer` composes what
the JAX package chains with optax, in the same order:

  clip_by_global_norm(grad_clip)     when grad_clip > 0
  gradient centralisation            rank > 1 leaves
  scale_by_radam(b1 .95, b2 .999, eps 1e-5, threshold 5, eps_root 0)
  add_decayed_weights(weight_decay)  when weight_decay > 0
  scale_by_learning_rate(schedule)   -lr(count), count before the step
  manual_lr_scale                    x lr_scale (the trainer's decay)
  lookahead(sync 6, alpha 0.5)

Any other `train.optimizer.type` is Adam, as in the JAX package:

  clip_by_global_norm(grad_clip)     when grad_clip > 0
  scale_by_adam(b1 .9, b2 .999, eps 1e-8 outside the sqrt, eps_root 0)
  add_decayed_weights(weight_decay)  when weight_decay > 0 (optax.adamw:
                                     every leaf, before the learning rate)
  scale_by_learning_rate(schedule)   -lr(count), count before the step
  manual_lr_scale                    x lr_scale

optax keeps three step counters (RAdam, schedule, Lookahead); they advance
together on every update, so one `count` stands for them. The count-only
scalars (bias corrections, the RAdam rectifier, the schedule) are computed
in float32 as JAX computes them, on the host: the count is a host integer,
so the step needs no device sync to take the RAdam branch.

Gradient centralisation subtracts the mean over every axis but the flax
layout's axis 0 (optim.py:32-35), wherever that axis lands in the port's
layout (convert.flax_axis0_dim): a conv kernel is grouped by kernel row,
a Dense kernel by input row. This is the JAX package's rule, not the
reference's per-output-filter GC.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pose_estimation_tpu_torch.convert import flax_axis0_dim

_F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32)


def _pow_f32(base: float, n: int) -> np.float32:
    """float32(base) ** n correctly rounded to float32: a jitted XLA
    program's optax decay ** count gives the same bits for b1 = .95 and
    b2 = .999 through count 57 (and within an ulp later), where RAdam's
    rectifier near its threshold is sensitive to the last bit."""
    return np.float32(np.float64(np.float32(base)) ** n)


def flat_and_anneal_schedule(base_lr: float, total_steps: int,
                             warmup_iters: int = 1000,
                             warmup_factor: float = 1e-3,
                             warmup_method: str = "linear",
                             anneal_point: float = 0.72,
                             anneal_method: str = "cosine",
                             gamma: float = 0.1):
    """Warmup -> flat -> {cosine|linear|poly|step} anneal from
    anneal_point of total_steps; float32 arithmetic."""
    anneal_start = int(anneal_point * total_steps)

    def schedule(step: int) -> float:
        s = _f32(step)
        if warmup_method == "linear":
            wf = warmup_factor + (1 - warmup_factor) * torch.clamp(
                s / max(warmup_iters, 1), max=1.0)
        else:
            wf = _f32(warmup_factor if step < warmup_iters else 1.0)
        frac = torch.clamp((s - anneal_start)
                           / max(total_steps - anneal_start, 1), 0.0, 1.0)
        if anneal_method == "cosine":
            af = 0.5 * (torch.cos(frac * math.pi) + 1.0)
        elif anneal_method == "linear":
            af = 1.0 - frac
        elif anneal_method == "poly":
            af = (1.0 - frac) ** 0.9
        elif anneal_method == "step":
            af = _f32(gamma if step >= anneal_start else 1.0)
        else:
            af = torch.ones_like(frac)
        return float(base_lr * wf * (1.0 if step < anneal_start else af))

    return schedule


def step_schedule(base_lr: float, steps_per_epoch: int, step_size: int,
                  gamma: float):
    """Epoch step decay; float32 arithmetic."""

    def schedule(step: int) -> float:
        epoch = _f32(step) / max(steps_per_epoch, 1)
        return float(base_lr * _f32(gamma) ** torch.floor(epoch / step_size))

    return schedule


def make_schedule(cfg, total_steps: int | None = None,
                  steps_per_epoch: int = 1000):
    lr = cfg.train.lr
    total = total_steps or steps_per_epoch * cfg.train.num_epoch
    if lr.scheduler in ("lambda", "flat_anneal"):
        return flat_and_anneal_schedule(
            lr.lr, total, lr.warmup_iters, lr.warmup_factor,
            lr.warmup_method, lr.anneal_point, lr.anneal_method, lr.gamma)
    if lr.scheduler in ("step", "epoch"):
        return step_schedule(lr.lr, steps_per_epoch, lr.step_size, lr.gamma)
    # 'manual': constant here; the trainer decays through lr_scale
    return lambda step: float(_f32(lr.lr))


def centralise(name: str, g: torch.Tensor) -> torch.Tensor:
    """Gradient centralisation of the leaf `name` (a state_dict key):
    subtract the mean over every dim but the one holding flax's axis 0;
    1-D leaves pass unchanged."""
    if g.ndim <= 1:
        return g
    keep = flax_axis0_dim(name)
    return g - g.mean(dim=[d for d in range(g.ndim) if d != keep],
                      keepdim=True)


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """optax.clip_by_global_norm; max_norm 0 passes the gradients."""
    if not max_norm:
        return grads
    gnorm = torch.sqrt(sum(torch.sum(v * v) for v in grads.values()))
    keep = gnorm < max_norm
    return {k: torch.where(keep, v, (v / gnorm) * max_norm)
            for k, v in grads.items()}


def nan_guard(grads: dict, loss: torch.Tensor):
    """The train step's NaN guard (the JAX package's, to the letter):
    (grads, gnorm, finite), gnorm the global norm of `grads` before any
    clip, finite whether it and `loss` are finite, grads zeroed where
    they are not."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads.values()))
    finite = torch.isfinite(loss) & torch.isfinite(gnorm)
    return ({k: torch.where(finite, g, torch.zeros_like(g))
             for k, g in grads.items()}, gnorm, finite)


@torch.no_grad()
def ranger_chain(grads: dict, state: dict, params: dict, *, grad_clip,
                 weight_decay, count, c1, c2, r, step_size, lr_scale, sync):
    """Ranger's update from its host scalars (Ranger.step_args): the clip,
    centralisation, RAdam (the rectifier r, or plain momentum where r is
    None), weight decay, the learning rate and Lookahead, leaf by leaf.
    (updates, new state), the state's count `count`."""
    b1, b2, eps, alpha = Ranger.b1, Ranger.b2, Ranger.eps, Ranger.alpha
    grads = clip_by_global_norm(grads, grad_clip)
    mu, nu, slow, updates = {}, {}, {}, {}
    for k, p in params.items():
        v = centralise(k, grads[k])
        mu[k] = (1 - b1) * v + b1 * state["mu"][k]
        nu[k] = (1 - b2) * (v * v) + b2 * state["nu"][k]
        u = mu[k] / c1
        if r is not None:
            u = r * u / (torch.sqrt(nu[k] / c2) + eps)
        if weight_decay:
            u = u + weight_decay * p
        u = (step_size * u) * lr_scale
        s = state["slow"][k]
        if sync:
            synced = s + alpha * ((p + u) - s)
            updates[k], slow[k] = synced - p, synced
        else:
            updates[k], slow[k] = u, s
    return updates, {"count": count, "mu": mu, "nu": nu, "slow": slow}


class Ranger:
    """The clip + Ranger chain above, optax-style: `init(params)` ->
    state, `update(grads, state, params, lr_scale)` -> (updates, state),
    with the reference's constants (ranger.py defaults)."""

    b1, b2, eps = 0.95, 0.999, 1e-5
    threshold = 5.0               # RAdam's variance tractability
    sync_period, alpha = 6, 0.5   # Lookahead

    def __init__(self, schedule, weight_decay: float = 0.0,
                 grad_clip: float = 0.0):
        self.schedule = schedule
        self.weight_decay, self.grad_clip = weight_decay, grad_clip

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
                "slow": {k: p.detach().clone() for k, p in params.items()}}

    def _radam_scalars(self, count: int):
        """(1 - b1^t, 1 - b2^t, rectifier r or None below the threshold),
        in float32 as optax computes them."""
        f = np.float32
        b2t = _pow_f32(self.b2, count)
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        ro = f(ro_inf) - f(2 * count) * b2t / (f(1) - b2t)
        r = None
        if ro >= self.threshold:
            r = float(np.sqrt((ro - f(4)) * (ro - f(2)) * f(ro_inf)
                              / (f((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
        return (float(f(1) - _pow_f32(self.b1, count)), float(f(1) - b2t),
                r)

    def step_args(self, count: int, lr_scale: float = 1.0) -> dict:
        """The host scalars of the update from the state's `count`: the
        keywords of ranger_chain and ops.optim.ranger_apply (count, the
        count after it)."""
        new = count + 1
        c1, c2, r = self._radam_scalars(new)
        return {"grad_clip": self.grad_clip,
                "weight_decay": self.weight_decay, "count": new, "c1": c1,
                "c2": c2, "r": r, "step_size": -self.schedule(count),
                "lr_scale": lr_scale, "sync": new % self.sync_period == 0}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict,
               lr_scale: float = 1.0):
        return ranger_chain(grads, state, params,
                            **self.step_args(state["count"], lr_scale))


class Adam:
    """The clip + Adam(W) chain above, with the Ranger interface. The
    state is {count, mu, nu}; the bias corrections are float32 on the
    host, as optax computes them."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, schedule, weight_decay: float = 0.0,
                 grad_clip: float = 0.0):
        self.schedule = schedule
        self.weight_decay, self.grad_clip = weight_decay, grad_clip

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict,
               lr_scale: float = 1.0):
        grads = clip_by_global_norm(grads, self.grad_clip)
        count = state["count"] + 1
        f = np.float32
        c1 = float(f(1) - _pow_f32(self.b1, count))
        c2 = float(f(1) - _pow_f32(self.b2, count))
        step_size = -self.schedule(state["count"])
        mu, nu, updates = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = (1 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = (1 - self.b2) * (g * g) + self.b2 * state["nu"][k]
            u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            updates[k] = (step_size * u) * lr_scale
        return updates, {"count": count, "mu": mu, "nu": nu}


def make_optimizer(cfg, total_steps: int | None = None):
    """Ranger when train.optimizer.type is "ranger" (any case), else Adam,
    with the config's schedule, weight decay and global-norm clip.
    `total_steps` is the flat-anneal horizon (steps per epoch x epochs);
    without it the schedule assumes 1000 steps per epoch."""
    opt = cfg.train.optimizer
    cls = Ranger if opt.type.lower() == "ranger" else Adam
    return cls(make_schedule(cfg, total_steps),
               weight_decay=opt.weight_decay, grad_clip=opt.grad_clip)

"""The training comparison. The fp32 reference follows the program's
first three steps from the same weights, on the same three batches, with
the same draws (a generator seeded as the program's train state's, drawn
in the program's order), and the same optimizer (clip, centralisation,
Ranger at the configuration's learning rate); after the window it takes
the program's parameters and generator state before one more step, on
the same batch:

- `loss_gap`: the worst of those four steps' |loss - reference loss| /
  |reference|;
- `grad_gap_worst`, `grad_gap_median`: the first step's gradient as
  autograd gives it (the program's from a hook on each parameter), leaf
  by leaf: |norm - reference norm| over the larger of the leaf's
  reference norm and the median leaf's; the worst leaf and the median
  leaf;
- `update_gap_worst`, `update_gap_median`: the parameters' change over
  the three steps, the same way, leaving out the leaves whose reference
  gradient is under a thousandth of the median leaf's (their change is
  round-off).

Each cell's limits file names the numbers it compares: the worst leaf
where it parts the program from the control, the median leaf where a
look at the worst finds the number itself at fault (in a bfloat16
backward the gradient of a GroupNorm scale or shift is a sum over every
pixel that cancels, and a bf16 reference reads alike), and none of a
kind whose sound runs and control overlap (TRPESNet's first gradient:
on an H100 one decoder conv's worst-leaf gap read 0.64 on one seed of
24, where the reference in bf16 read 0.60; the numbers are still
computed and printed).

The control puts the reference in the program's place one precision
down (activations in float8 e4m3 where the program runs bfloat16); the
faults are a step that leaves the state unchanged (update 1) and a loss
over half of the batch."""

from __future__ import annotations

import numpy as np
import torch

from portbench import found
from portbench.reference.layers import Precision
from portbench.reference.train import Ranger, leaf_gap
from portbench.weights import reference_model

STEPS = 3
ROUND_OFF = 1e-3


def lr_at(schema: dict, total_steps: int, step: int) -> float:
    """The flat-and-anneal schedule with a linear warm-up (the program's
    "lambda" scheduler) at the update's count before the step."""
    lr = schema["train"]["lr"]
    if lr["scheduler"] not in ("lambda", "flat_anneal") or \
            lr["warmup_method"] != "linear" or lr["anneal_method"] != "cosine":
        raise ValueError("the reference follows the linear warm-up, flat, "
                         "cosine schedule only")
    wf = lr["warmup_factor"] + (1 - lr["warmup_factor"]) * min(
        step / max(lr["warmup_iters"], 1), 1.0)
    start = int(lr["anneal_point"] * total_steps)
    frac = min(max((step - start) / max(total_steps - start, 1), 0.0), 1.0)
    af = 0.5 * (np.cos(frac * np.pi) + 1.0) if step >= start else 1.0
    return lr["lr"] * wf * af


def _model(cfg_file: dict, params: dict, device, mode: str):
    model = reference_model(cfg_file, Precision(mode)).to_empty(
        device=device)
    model.load_state_dict(params, strict=True)
    return model


def _loss(model, cfg_file: dict, batch: dict, gen):
    """The family's loss, its draws from `gen` in the program's order."""
    return found.family(cfg_file["model"], "reference").loss(
        model, cfg_file["schema"], batch, gen)


def follow(cfg_file: dict, weights: dict, batches: list, gen_seed: int,
           total_steps: int, device, mode: str = "fp32",
           half_batch: bool = False):
    """The reference's three steps: (losses, first gradient, parameters
    after the last step, gradient norms)."""
    schema = cfg_file["schema"]
    model = _model(cfg_file, weights, device, mode)
    params = dict(model.named_parameters())
    opt = schema["train"]["optimizer"]
    if opt["type"].lower() != "ranger" or opt["weight_decay"]:
        raise ValueError("the reference follows Ranger without weight decay")
    ranger = Ranger(0.0, opt["grad_clip"])
    state = ranger.init({k: p.detach() for k, p in params.items()})
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    losses, first, norms = [], None, []
    for i in range(STEPS):
        batch = batches[i]
        if half_batch:
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        loss = _loss(model, cfg_file, batch, gen)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        ranger.lr = lr_at(schema, total_steps, i)
        ranger.step({k: p.data for k, p in params.items()}, grads, state)
        losses.append(float(loss.detach()))
        norms.append(float(torch.sqrt(sum(torch.sum(g * g)
                                          for g in grads.values()))))
        if i == 0:
            first = grads
    return (losses, first, {k: p.detach() for k, p in params.items()},
            norms)


def loss_at(cfg_file: dict, params: dict, batch: dict, gen_state, device):
    """The reference's loss at `params` on `batch`, its draws from a
    generator in `gen_state`."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    with torch.no_grad():
        return float(_loss(_model(cfg_file, params, device, "fp32"),
                           cfg_file, batch, gen))


def _rel(a: float, b: float) -> float:
    g = abs(a - b) / max(abs(b), 1e-30)
    return g if g == g else float("inf")


def compare(weights, losses, first, params, grad_norms, ref,
            after=()) -> dict:
    """The numbers of a program's (or stand-in's) three steps against the
    reference's; `after` adds (loss, reference loss) pairs to loss_gap."""
    r_losses, r_first, r_params, r_norms = ref
    loss_gap = max(_rel(a, b) for a, b in
                   list(zip(losses, r_losses)) + list(after))
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in r_first.items()}
    med = float(np.median(list(norms.values())))
    moving = {k for k, v in norms.items() if v >= ROUND_OFF * med}
    grad = leaf_gap(first, r_first)
    update = leaf_gap({k: params[k] - weights[k] for k in weights},
                      {k: r_params[k] - weights[k] for k in weights}, moving)
    return {"loss_gap": loss_gap,
            "grad_gap_worst": grad["worst"],
            "grad_gap_median": grad["median"],
            "update_gap_worst": update["worst"],
            "update_gap_median": update["median"],
            "_grad_worst_at": grad["at"], "_update_worst_at": update["at"],
            "_left_out": len(weights) - len(moving),
            "_grad_norms": [list(grad_norms), list(r_norms)]}


def numbers(driver, limits=None) -> dict:
    total = driver.mix["total_steps"]
    ref = follow(driver.cfg_file, driver.weights, driver.pool,
                 driver.gen_seed, total, driver.dev)
    after = ()
    if driver.after is not None:
        b, params, gen_state, loss = driver.after
        after = ((loss, loss_at(driver.cfg_file, {**driver.weights, **params},
                                driver.pool[b],
                                gen_state, driver.dev)),)
    return compare(driver.weights, driver.losses, driver.first_grad,
                   driver.params3, driver.grad_norms, ref, after)


def control_numbers(driver) -> dict:
    """The control (fp8) and the half-batch fault in the program's place,
    against the fp32 reference (the unchanged state reads 1), and the
    reference at the program's own bf16 rounding, a witness of what
    rounding alone reads."""
    args = (driver.cfg_file, driver.weights, driver.pool, driver.gen_seed,
            driver.mix["total_steps"], driver.dev)
    ref = follow(*args)
    out = {}
    for name, kw in (("control", {"mode": "fp8"}),
                     ("half_batch", {"half_batch": True}),
                     ("bf16_reference", {"mode": "bf16"})):
        out[name] = compare(driver.weights, *follow(*args, **kw), ref)
    return out

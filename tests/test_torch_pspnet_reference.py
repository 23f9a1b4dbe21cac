"""The port's PSPNet generation (TransparentPoseNet, built by
transparent_trainer.build_model, stepped by TransparentTrainStep) against
the benchmark's plain float32 reference (portbench/reference/pspnet.py)
on the CPU, at the family's tiny size (3 objects, 32 points, 64-px
crops, batch 2), on make_weights weights of two seeds and a batch of the
benchmark's own transparent pool:

  the training draws one for one from generators seeded alike (the
      pixels [B, n] with replacement, then the seven dropout masks);
  float32: the eight outputs, each loss term (the boundary term among
      them) and the total, every leaf's gradient, and three train steps
      (Ranger, as the benchmark's check follows them);
  bfloat16: the program against the float32 reference within what
      bfloat16 rounding moves (the loss, the median leaf's gradient),
      and the reference rounded through float8 e4m3 in its place
      outside it;
  the reference's files import neither JAX nor the program.
"""

import ast
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.train.transparent_trainer import (
    TransparentTrainStep, apply_transparent_model, build_model,
    loss_weights)
from portbench import found, program
from portbench.check import train as check_train
from portbench.gen.pool import make_pool
from portbench.reference import pspnet as ref_pspnet
from portbench.reference.layers import Precision
from portbench.weights import make_weights

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (2 ** 33 + 18, 3180000501)
GEN_SEED = 11
BATCH = 2
# the program's loss terms under the reference's names
TERMS = {"distance": "loss_add", "rotation": "loss_r", "normal": "loss_n",
         "depth": "loss_d", "mask": "loss_m", "boundary": "loss_b"}

# float32 on both sides: the same operations in another order (the CPU's
# convolution algorithms, ATen's against F.interpolate's resize, the
# gathers); measured at most 4.5e-6 of the largest output (the normal
# map, a division by the length of a 3-vector), 2e-7 of the loss and
# 1.8e-6 of a leaf's gradient (over the larger of its norm and the median
# leaf's)
FP32_OUT, FP32_LOSS, FP32_GRAD = 1e-4, 1e-5, 1e-4
# bfloat16 activations keep 8 bits of mantissa (2^-9 relative): the loss,
# a mean over every pixel and hypothesis, moved by 1.2e-4 and 4.6e-4 on
# the two seeds, the median leaf's gradient by 0.005-0.007 as relus and
# the PReLUs' kinks flip on rounding; float8 e4m3 (2^-4) in the program's
# place reads 0.014-0.020 and 0.15-0.16
BF16_LOSS, BF16_GRAD_MEDIAN = 0.005, 0.05


def _cfg_file() -> dict:
    with open(ROOT / "portbench/configs/pspnet_cleargrasp.json") as f:
        cfg_file = json.load(f)
    cfg_file = copy.deepcopy(cfg_file)
    found.family("pspnet", "reference").tiny(cfg_file["schema"])
    return cfg_file


CFG_FILE = _cfg_file()
SCHEMA = CFG_FILE["schema"]
N = SCHEMA["data"]["num_points"]


@pytest.fixture(scope="module")
def batches():
    mix = {"driver": "train", "batch_size": BATCH, "pool_batches": 3}
    return make_pool(CFG_FILE, mix, SEEDS[0])


def _program(weights: dict, amp: bool):
    cfg = schema.override(program.config(CFG_FILE), **{"train.amp": amp})
    model = build_model(cfg)
    model.load_state_dict({k: v.clone() for k, v in weights.items()},
                          strict=True)
    return model, TransparentTrainStep(model, None, loss_weights(cfg))


def _reference(weights: dict, mode: str = "fp32"):
    model = ref_pspnet.TransparentPoseNet(SCHEMA, Precision(mode))
    model.load_state_dict({k: v.clone() for k, v in weights.items()},
                          strict=True)
    return model


def _draws(batch: dict):
    b, h, w, _ = batch["img"].shape
    return ref_pspnet.draws(torch.Generator().manual_seed(GEN_SEED), b, h,
                            w, N)


def _rel(a, b) -> float:
    return float((a.float() - b).abs().max() / b.abs().max())


def _leaf_gaps(got: dict, want: dict) -> dict:
    """|got - want| / max(|want|, the median leaf's |want|), leaf by leaf
    (norms over the leaf)."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    return {k: float((got[k].float() - want[k]).norm())
            / max(norms[k], med) for k in want}


def _reference_grads(model, batch, choose, masks):
    loss = ref_pspnet.transparent_loss(model(batch, choose, masks), batch,
                                       ref_pspnet.loss_weights(SCHEMA))
    names, params = zip(*model.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


@pytest.mark.parametrize("gen_seed", (GEN_SEED, 2 ** 40 + 3))
def test_draws_one_for_one(batches, gen_seed):
    batch = batches[0]
    _, step = _program(make_weights(CFG_FILE, SEEDS[0], "cpu"), False)
    g_prog = torch.Generator().manual_seed(gen_seed)
    g_ref = torch.Generator().manual_seed(gen_seed)
    choose, masks = step.draws(g_prog, batch)
    b, h, w, _ = batch["img"].shape
    r_choose, r_masks = ref_pspnet.draws(g_ref, b, h, w, N)
    assert choose.shape == (b, N) and torch.equal(choose, r_choose)
    assert len(masks) == len(r_masks) == 7
    for m, r in zip(masks, r_masks):
        assert m.dtype == torch.bool and torch.equal(m, r)
    assert torch.equal(g_prog.get_state(), g_ref.get_state())


@pytest.mark.parametrize("seed", SEEDS)
def test_fp32_outputs_and_loss_terms(batches, seed):
    weights = make_weights(CFG_FILE, seed, "cpu")
    model, step = _program(weights, False)
    ref = _reference(weights)
    batch = batches[0]
    choose, masks = _draws(batch)
    with torch.no_grad():
        got = apply_transparent_model(model, batch, choose, masks)
        want = ref(batch, choose, masks)
        losses = step.losses(batch, choose, masks)
        terms = ref_pspnet.loss_terms(want, batch)
        total = ref_pspnet.transparent_loss(want, batch,
                                            ref_pspnet.loss_weights(SCHEMA))
    assert sorted(got) == sorted(want) and len(want) == 8
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) <= FP32_OUT, (k, _rel(got[k], want[k]))
    assert float(terms["boundary"]) > 0
    for k, name in TERMS.items():
        gap = abs(float(losses[name]) - float(terms[k])) / abs(float(terms[k]))
        assert gap <= FP32_LOSS, (k, gap)
    gap = abs(float(losses["all_loss"]) - float(total)) / float(total)
    assert gap <= FP32_LOSS, gap


@pytest.mark.parametrize("seed", SEEDS)
def test_fp32_every_gradient(batches, seed):
    weights = make_weights(CFG_FILE, seed, "cpu")
    _, step = _program(weights, False)
    batch = batches[1]
    choose, masks = _draws(batch)
    grads = step.gradients(step.losses(batch, choose, masks))
    _, want = _reference_grads(_reference(weights), batch, choose, masks)
    assert sorted(grads) == sorted(want) and len(want) == 153
    gaps = _leaf_gaps(grads, want)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= FP32_GRAD, (worst, gaps[worst])


@pytest.mark.parametrize("seed", SEEDS)
def test_fp32_three_train_steps(batches, seed):
    """Three TransparentTrainSteps from the generator's own draws against
    the benchmark's check (check/train.follow: the reference's loss, its
    draws from a generator seeded alike, clipping, centralisation,
    Ranger): each step's loss and the three steps' update, leaf by
    leaf."""
    weights = make_weights(CFG_FILE, seed, "cpu")
    cfg_file = copy.deepcopy(CFG_FILE)
    cfg_file["schema"]["train"]["amp"] = False
    cfg_file["dtype"] = "float32"
    model = program.build_model(cfg_file, weights, "cpu")
    state, _, call = program.train_objects(model, cfg_file, 100000,
                                           GEN_SEED)
    losses = [float(call(state, b)["all_loss"]) for b in batches]
    r_losses, _, r_params, _ = check_train.follow(
        cfg_file, weights, batches, GEN_SEED, 100000, "cpu")
    for a, b in zip(losses, r_losses):
        assert abs(a - b) / abs(b) <= FP32_LOSS, (losses, r_losses)
    params = dict(model.named_parameters())
    gaps = _leaf_gaps({k: params[k].detach() - weights[k] for k in weights},
                      {k: r_params[k] - weights[k] for k in weights})
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 1e-3, (worst, gaps[worst])


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_within_rounding_and_fp8_outside(batches, seed):
    weights = make_weights(CFG_FILE, seed, "cpu")
    batch = batches[2]
    choose, masks = _draws(batch)
    loss, want = _reference_grads(_reference(weights), batch, choose, masks)
    _, step = _program(weights, True)
    losses = step.losses(batch, choose, masks)
    got = step.gradients(losses)

    def gaps(total, grads):
        total, ref = float(total.detach()), float(loss.detach())
        return (abs(total - ref) / abs(ref),
                float(np.median(list(_leaf_gaps(grads, want).values()))))

    loss_gap, grad_median = gaps(losses["all_loss"], got)
    assert loss_gap <= BF16_LOSS and grad_median <= BF16_GRAD_MEDIAN, (
        loss_gap, grad_median)
    fp8_loss, fp8_grads = _reference_grads(_reference(weights, "fp8"), batch,
                                           choose, masks)
    loss_gap, grad_median = gaps(fp8_loss, fp8_grads)
    assert loss_gap > BF16_LOSS or grad_median > BF16_GRAD_MEDIAN, (
        loss_gap, grad_median)


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_reference_imports_no_jax_and_no_program():
    """The reference's files and every portbench module they import, read
    as text: no jax, jaxlib or flax, nothing of pose_estimation_tpu or
    pose_estimation_tpu_torch."""
    todo = ["portbench.reference.pspnet",
            "portbench.families.pspnet.reference"]
    seen = set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        path = ROOT / (name.replace(".", "/") + ".py")
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "pose_estimation_tpu",
                               "pose_estimation_tpu_torch"), (name, mod)
            if top == "portbench" and (ROOT / (mod.replace(".", "/")
                                               + ".py")).is_file():
                todo.append(mod)
    assert "portbench.reference.trpesnet" in seen

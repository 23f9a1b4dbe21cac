"""The tiny transparent setup of tests/test_torch_transparent_*.py and
tests/test_torch_pspnet*.py (TRPESNet and the PSPNet generation's
TransparentPoseNet), and the rank processes of their 2-rank gloo groups.

Each rank joins a gloo group through the port's distributed_init on a
FileStore, runs the port's transparent train step on its rows of the
global batch with the test's draws (or with its generator's own), and
saves what it saw (torch.save, <out_dir>/<task>_<rank>.pt). It imports
torch, numpy and the port only.
"""

from __future__ import annotations

import os

import numpy as np
import torch

NUM_POINTS, NUM_OBJ, CROP, MODEL_POINTS = 32, 3, 32, 16
GLOBAL_BS = 4
TOTAL_STEPS = 40
CHOOSE_SEED = 3


def config(schema, **over):
    """transparent_cleargrasp cut to the JAX tests' TRPESNet(num_points=32,
    num_obj=3) on 32-px crops, fp32, Ranger without warmup, in `schema`'s
    types (the port's or the JAX package's config module)."""
    return schema.override(schema.transparent_cleargrasp(), **{
        "module.num_cls": NUM_OBJ, "data.num_points": NUM_POINTS,
        "data.input_size": CROP, "train.batch_size": GLOBAL_BS // 2,
        "train.amp": False, "train.lr.warmup_iters": 0,
        "train.ckpt_every": 0, **over})


def tiny_batch(seed: int = 0, b: int = GLOBAL_BS, h: int = CROP,
               m: int = MODEL_POINTS) -> dict:
    """A numpy batch in make_transparent_batch's schema: symmetric and
    non-symmetric samples, gt normals zero on a share of the pixels that
    differs by sample (the masked normal term's count differs between the
    halves)."""
    rng = np.random.RandomState(seed)
    mp = (rng.randn(b, m, 3) * 0.05).astype(np.float32)
    target = (mp + np.array([0.0, 0.0, 0.8], np.float32)
              + rng.randn(b, m, 3).astype(np.float32) * 0.01)
    normal = rng.randn(b, h, h, 3).astype(np.float32)
    for i in range(b):
        normal[i, : 4 * (i + 1)] = 0.0
    return {
        "img": rng.rand(b, h, h, 3).astype(np.float32),
        "intrinsic": np.tile(np.array([[300.0, 300.0, h / 2, h / 2]],
                                      np.float32), (b, 1)),
        "xmap": np.tile(np.arange(h, dtype=np.float32)[None, None, :],
                        (b, h, 1)),
        "ymap": np.tile(np.arange(h, dtype=np.float32)[None, :, None],
                        (b, 1, h)),
        "d_scale": np.ones(b, np.float32),
        "obj": (np.arange(b) % NUM_OBJ).astype(np.int32),
        "target": target.astype(np.float32),
        "model_points": mp,
        "sym_mask": (np.arange(b) % 2 == 0).astype(np.float32),
        "axis": np.tile(np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 1.0]],
                                 np.float32), (b // 2, 1)),
        "r": np.broadcast_to(np.eye(3, dtype=np.float32), (b, 3, 3)).copy(),
        "t": np.tile(np.array([0.0, 0.0, 0.8], np.float32), (b, 1)),
        "normal": normal,
        "depth": rng.rand(b, h, h, 1).astype(np.float32),
        "mask": rng.rand(b, h, h, 1).astype(np.float32),
    }


def choose_perm(hw: int = CROP * CROP) -> np.ndarray:
    """The test's permutation of the crop's pixels (its first NUM_POINTS
    are the training pixels)."""
    return np.random.RandomState(CHOOSE_SEED).permutation(hw)


def port_setup(gen_seed: int = 0):
    """(state, step) of the tiny port model with weights seeded 1."""
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.models.transparent import TRPESNet
    from pose_estimation_tpu_torch.train.optim import make_optimizer
    from pose_estimation_tpu_torch.train.state import TrainState
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        TransparentTrainStep, loss_weights)
    cfg = config(schema)
    torch.manual_seed(1)
    model = TRPESNet(NUM_POINTS, NUM_OBJ)
    tx = make_optimizer(cfg, total_steps=TOTAL_STEPS)
    state = TrainState.create(model, tx,
                              torch.Generator().manual_seed(gen_seed))
    return state, TransparentTrainStep(model, tx, loss_weights(cfg))


# the PSPNet generation (TransparentPoseNet) at 48-px crops: 6 x 6
# features, the smallest its PSP pyramid pools (the JAX tests' size)
PSP_CROP = 48
DRAW_SEED = 7


def posenet_batch(seed: int = 0, b: int = GLOBAL_BS) -> dict:
    """tiny_batch at PSP_CROP with a boundary label (a tenth of the
    pixels), drawn from its own seed."""
    batch = tiny_batch(seed, b, PSP_CROP)
    rng = np.random.RandomState(seed + 100)
    batch["boundary"] = (rng.rand(b, PSP_CROP, PSP_CROP, 1) > 0.9).astype(
        np.float32)
    return batch


def posenet_draws(b: int = GLOBAL_BS) -> tuple:
    """The test's TransparentPoseNet training draws at the global batch:
    the pixels [b, NUM_POINTS] (with repeats) and the decoder's seven
    keep masks, NCHW bool, in flax's trace order."""
    from pose_estimation_tpu_torch.models.pspnet import (
        DROPOUT_RATES, dropout_shapes)
    rng = np.random.RandomState(DRAW_SEED)
    choose = rng.randint(0, PSP_CROP * PSP_CROP, (b, NUM_POINTS)).astype(
        np.int32)
    masks = [rng.rand(*shape) < 1.0 - rate for shape, rate in zip(
        dropout_shapes(b, PSP_CROP, PSP_CROP), DROPOUT_RATES)]
    return choose, masks


def posenet_setup(gen_seed: int = 0):
    """(state, step) of the tiny TransparentPoseNet with weights seeded 2."""
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.train.optim import make_optimizer
    from pose_estimation_tpu_torch.train.state import TrainState
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        TransparentTrainStep, build_model, loss_weights)
    cfg = config(schema, **{"module.transparent_model": "posenet",
                            "data.input_size": PSP_CROP})
    torch.manual_seed(2)
    model = build_model(cfg)
    tx = make_optimizer(cfg, total_steps=TOTAL_STEPS)
    state = TrainState.create(model, tx,
                              torch.Generator().manual_seed(gen_seed))
    return state, TransparentTrainStep(model, tx, loss_weights(cfg))


def local_batch(batch: dict) -> dict:
    """This rank's rows of a global numpy batch, as torch tensors."""
    from pose_estimation_tpu_torch.parallel import dist
    return {k: dist.rank_rows(torch.from_numpy(np.array(v)))
            for k, v in batch.items()}


def snapshot(state, metrics: dict) -> dict:
    from pose_estimation_tpu_torch import convert
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": convert.torch_to_flax(dict(
                state.model.named_parameters())),
            "step": state.step, "generator": state.generator.get_state()}


def step_injected(batch: dict) -> dict:
    """One step at the test's pixels."""
    state, step = port_setup()
    losses = step.losses(local_batch(batch),
                         torch.from_numpy(choose_perm()[:NUM_POINTS]))
    return snapshot(state, step.apply(state, losses, step.gradients(losses)))


def step_seeded(batch: dict, steps: int = 2) -> dict:
    """`steps` steps with the generator's own pixel draws, seeded 5 on
    every rank."""
    state, step = port_setup(gen_seed=5)
    tb = local_batch(batch)
    return {"steps": [snapshot(state, step(state, tb)) for _ in range(steps)]}


def step_posenet_injected(batch: dict) -> dict:
    """One TransparentPoseNet step at the test's draws, this rank's rows
    of them."""
    from pose_estimation_tpu_torch.parallel import dist
    state, step = posenet_setup()
    choose, masks = posenet_draws()
    rows = lambda a: dist.rank_rows(torch.from_numpy(a))
    losses = step.losses(local_batch(batch), rows(choose),
                         [rows(m) for m in masks])
    return snapshot(state, step.apply(state, losses, step.gradients(losses)))


TASKS = {
    "injected": lambda p: step_injected(p["batch"]),
    "seeded": lambda p: step_seeded(p["batch"]),
}
def step_posenet_seeded(batch: dict) -> dict:
    """One TransparentPoseNet step with the generator's own draws, seeded
    5 on every rank."""
    state, step = posenet_setup(gen_seed=5)
    return snapshot(state, step(state, local_batch(batch)))


POSENET_TASKS = {
    "posenet_injected": lambda p: step_posenet_injected(p["batch"]),
    "posenet_seeded": lambda p: step_posenet_seeded(p["batch"]),
}


def run(rank: int, world: int, store: str, tasks: list, payload: dict):
    """One rank: join the group, run `tasks`, save each one's result."""
    torch.set_num_threads(1)
    from pose_estimation_tpu_torch.parallel import dist
    if not dist.distributed_init("gloo", f"file://{store}", world, rank):
        raise RuntimeError("distributed_init did not join the group")
    try:
        for name in tasks:
            torch.save({**TASKS, **POSENET_TASKS}[name](payload),
                       os.path.join(payload["out_dir"], f"{name}_{rank}.pt"))
    finally:
        dist.destroy()

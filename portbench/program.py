"""Everything the benchmark takes from the program under test
(pose_estimation_tpu_torch): its configuration type, its models, the
serving and training entry points, the optimizer and train state, and
the ops whose launches it counts. Nothing else in portbench imports the
program, and the reference imports none of it."""

from __future__ import annotations

import dataclasses

import torch

import pose_estimation_tpu_torch as _pkg  # noqa: F401  (the system under test)
from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.models.transparent import TRPESNet
from pose_estimation_tpu_torch.ops import gcn, pointops
from pose_estimation_tpu_torch.serve import build_infer_step
from pose_estimation_tpu_torch.train.optim import make_optimizer
from pose_estimation_tpu_torch.train.state import TrainState
from pose_estimation_tpu_torch.train.train_step import build_train_step
from pose_estimation_tpu_torch.train.transparent_trainer import (
    TransparentTrainStep, loss_weights)

# the op entry points the kernel spans wrap: (module, attribute)
OPS = ((gcn, "linear_multi"), (gcn, "surface_multi"), (gcn, "aggregate"),
       (pointops, "knn"), (pointops, "nearest_multi"))


def _build(cls, value):
    """A frozen dataclass of `cls` from the dict `value` (nested groups
    alike, lists as tuples)."""
    kw = {}
    default = cls()
    for f in dataclasses.fields(cls):
        v = value[f.name]
        cur = getattr(default, f.name)
        if dataclasses.is_dataclass(cur):
            v = _build(type(cur), v)
        elif isinstance(v, list):
            v = _tuples(v)
        kw[f.name] = v
    return cls(**kw)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def config(cfg_file: dict) -> schema.Config:
    """The program's Config from a configuration file's `schema`."""
    return _build(schema.Config, cfg_file["schema"])


def build_model(cfg_file: dict, weights: dict, device) -> torch.nn.Module:
    """The program's model of the configuration, built without
    initialising anything, its parameters set to `weights` (copies)."""
    cfg = config(cfg_file)
    dtype = getattr(torch, cfg_file["dtype"])
    with torch.device("meta"):
        if cfg_file["model"] == "krrn":
            model = KRRN(cfg, dtype=dtype,
                         fusion_variant=cfg_file.get("fusion_variant",
                                                     "lite"))
        elif cfg_file["model"] == "trpesnet":
            model = TRPESNet(num_points=cfg.data.num_points,
                             num_obj=cfg.module.num_cls, dtype=dtype)
        else:
            raise ValueError(f"model {cfg_file['model']!r}")
    model = model.to_empty(device=device)
    model.load_state_dict({k: v.clone() for k, v in weights.items()},
                          strict=True)
    return model


def infer_step(model, cfg_file: dict):
    return build_infer_step(model, config(cfg_file))


def train_objects(model, cfg_file: dict, total_steps: int, gen_seed: int):
    """(state, step): the train state with its generator on the model's
    device seeded with `gen_seed`, and the configuration's train step."""
    cfg = config(cfg_file)
    dev = next(model.parameters()).device
    tx = make_optimizer(cfg, total_steps=total_steps)
    state = TrainState.create(model, tx,
                              torch.Generator(device=dev).manual_seed(
                                  gen_seed))
    if cfg_file["model"] == "krrn":
        step = build_train_step(model, tx, cfg)
    else:
        step = TransparentTrainStep(model, tx, loss_weights(cfg))
    return state, step


def call_train(step, state, batch):
    """One training step through the entry the trainer calls."""
    if isinstance(step, TransparentTrainStep):
        return step(state, batch)
    return step(state, batch, opt_pose=True)


def launches() -> dict:
    """The ops' launch counters."""
    return {f"{getattr(m, a).__module__.rsplit('.', 1)[-1]}.{a}":
            getattr(getattr(m, a), "launches", 0) for m, a in OPS}


def wrap_ops(hook):
    """Replace each op entry point in its module by `hook(name, fn)`'s
    wrapper, carrying the launch counter over. Callers reach the ops
    through their modules (models/fusion.py and gcn3d.py through ops.gcn,
    core/pointops through ops.pointops), and the ops count their launches
    through the same module names, so the counters go on in the
    wrappers."""
    for mod, attr in OPS:
        fn = getattr(mod, attr)
        wrapped = hook(attr, fn)
        wrapped.launches = getattr(fn, "launches", 0)
        setattr(mod, attr, wrapped)

"""Everything the benchmark takes from the program under test
(pose_estimation_tpu_torch): its configuration type, the optimizer and
train state, each model family's model and entry points (through the
family's program half, families/<model>/program.py), and the kernel ops
whose launches it counts and whose calls it wraps (their entry points
named by the op files, ops/<op>.py). Besides the families' program
halves, nothing else in portbench imports the program, and the
reference imports none of it."""

from __future__ import annotations

import dataclasses
import functools
import importlib

import torch

import pose_estimation_tpu_torch as _pkg  # noqa: F401  (the system under test)
from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.train.optim import make_optimizer
from pose_estimation_tpu_torch.train.state import TrainState
from portbench import found


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
    fam = found.family(cfg_file["model"], "program")  # outside the meta device
    with torch.device("meta"):
        model = fam.build(cfg, dtype, cfg_file)
    model = model.to_empty(device=device)
    model.load_state_dict({k: v.clone() for k, v in weights.items()},
                          strict=True)
    return model


def infer_step(model, cfg_file: dict):
    return found.family(cfg_file["model"], "program").infer_step(
        model, config(cfg_file))


def train_objects(model, cfg_file: dict, total_steps: int, gen_seed: int):
    """(state, step, call): the train state with its generator on the
    model's device seeded with `gen_seed`, the family's train step, and
    call(state, batch), one step through the entry the trainer calls."""
    cfg = config(cfg_file)
    fam = found.family(cfg_file["model"], "program")
    dev = next(model.parameters()).device
    tx = make_optimizer(cfg, total_steps=total_steps)
    state = TrainState.create(model, tx,
                              torch.Generator(device=dev).manual_seed(
                                  gen_seed))
    step = fam.train_step(model, tx, cfg)
    return state, step, functools.partial(fam.call_train, step)


def _entry(op) -> tuple:
    """(module, attribute) of an op file's entry point."""
    return importlib.import_module(op.ENTRY[0]), op.ENTRY[1]


def launches() -> dict:
    """The launch counters of every op file's op."""
    return {f"{getattr(m, a).__module__.rsplit('.', 1)[-1]}.{a}":
            getattr(getattr(m, a), "launches", 0)
            for m, a in map(_entry, found.ops().values())}


def wrap_ops(hook, names):
    """Replace the entry point of each op in `names` in its module by
    `hook(op, fn, least)`'s wrapper, `least` the op file's least time of
    a call, carrying the launch counter over. Callers reach the ops
    through their modules (models/fusion.py and gcn3d.py through ops.gcn,
    core/pointops through ops.pointops, models/layers.py through
    ops.resize), and the ops count their launches through the same module
    names, so the counters go on in the wrappers."""
    for name in names:
        op = found.op(name)
        mod, attr = _entry(op)
        fn = getattr(mod, attr)
        wrapped = hook(name, fn, op.least)
        wrapped.launches = getattr(fn, "launches", 0)
        setattr(mod, attr, wrapped)

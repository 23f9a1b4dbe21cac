"""Training traffic: train steps at the mix's batch size on a pool of
distinct batches held on the card, each through the trainer's own entry
(the family's `call_train`: TrainStep.__call__,
TransparentTrainStep.__call__), each ending in a sync of its metrics.

Set-up builds one train state and runs its first three steps through the
same call on three different batches, keeping what the check compares:
each step's total loss and gradient norm, the first step's gradient as
autograd hands it to the step (a hook on each parameter) and the
parameters after the third step. After the
window the same state takes one more step on the next pool batch, and
the check keeps its loss, the parameters and the generator's state it
started from. Only the model's parameters, the generator the benchmark
made, hooks on its parameters and the step's returned metrics are
read."""

from __future__ import annotations

import time

import torch

from portbench import program
from portbench.check import train as check_train
from portbench.gen.pool import make_pool, seeds
from portbench.weights import make_weights

STAGES = ("losses", "gradients", "apply")
CHECKED_STEPS = 3


class Train:
    kind = "train"
    stages = STAGES

    def __init__(self, cfg_file: dict, mix: dict, seed: int, device):
        self.cfg_file, self.mix, self.seed, self.dev = (cfg_file, mix, seed,
                                                        device)
        self.batch_size = mix["batch_size"]
        t = time.perf_counter()
        self.weights = make_weights(cfg_file, seed, device)
        self.timings = {"weights": time.perf_counter() - t}
        self.pool = [{k: v.to(device) for k, v in b.items()}
                     for b in make_pool(cfg_file, mix, seed)]
        if len(self.pool) < CHECKED_STEPS:
            raise ValueError(f"a training pool needs {CHECKED_STEPS} "
                             "batches or more")
        self.timings["pool"] = time.perf_counter() - t - self.timings["weights"]
        self.model = program.build_model(cfg_file, self.weights, device)
        self.gen_seed = seeds(seed)[4]
        self.state, self.entry, self.call = program.train_objects(
            self.model, cfg_file, mix["total_steps"], self.gen_seed)
        self.total = self.entry.total
        self.losses, self.grad_norms, self.first_grad = [], [], {}
        named = dict(self.model.named_parameters())
        hooks = [p.register_hook(
            lambda g, k=k: self.first_grad.__setitem__(k, g.detach().clone()))
            for k, p in named.items()]
        for i in range(CHECKED_STEPS):
            m = self.call(self.state, self.pool[i])
            self.losses.append(float(m[self.total]))
            self.grad_norms.append(float(m["grad_norm"]))
            if i == 0:
                for h in hooks:
                    h.remove()
        # a parameter that the loss does not reach has a zero gradient
        self.first_grad = {k: self.first_grad.get(k, torch.zeros_like(p))
                           for k, p in named.items()}
        self.params3 = self.params()
        self.steps_done = CHECKED_STEPS
        self.after = None
        self.timings["model and 3 steps"] = time.perf_counter() - t - sum(
            self.timings.values())

    def params(self) -> dict:
        return {k: p.detach().clone()
                for k, p in self.model.named_parameters()}

    def step(self, i: int, record: bool = True):
        batch = self.pool[(self.steps_done + i) % len(self.pool)]
        m = self.call(self.state, batch)
        return torch.stack([v.float() for v in m.values()]).to("cpu")

    def units(self, steps: int) -> int:
        return steps * self.batch_size

    def release(self, steps: int = 0):
        """One more step after the window's `steps`, through the same
        call on the next pool batch, keeping (batch index, parameters and
        generator state before it, its loss); then drop the program's
        objects."""
        if self.state is not None:
            b = (self.steps_done + steps) % len(self.pool)
            before = (b, self.params(), self.state.generator.get_state())
            m = self.call(self.state, self.pool[b])
            self.after = before + (float(m[self.total]),)
        self.state = self.entry = self.call = self.model = None

    def check(self, limits: dict) -> dict:
        return check_train.numbers(self, limits)

    def control(self) -> dict:
        return check_train.control_numbers(self)


Driver = Train

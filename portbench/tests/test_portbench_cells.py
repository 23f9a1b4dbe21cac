"""Each cell's traffic at a tiny size on the CPU, through the harness's
run past its look for a chip: set-up, the window, the end-to-end metrics
and the comparison; and the same run with the timed path broken
underneath, which the comparison has to call not correct."""

from __future__ import annotations

import math
import time

import pytest
import torch

from portbench import check, run
from portbench.check import serve as check_serve
from portbench.check import train as check_train
from portbench.drivers.serve import Serve
from portbench.drivers.train import Train
from portbench.tests.tiny import tiny_cell

CELLS = ("krrn.serve_bs256", "trpesnet.train_bs8")
TRAIN_CELLS = CELLS[1:]
KEYS = ("correct", "attempted", "failed", "metrics", "device")
SEED = 2 ** 33 + 12345              # more than 32 bits


def _run(workload, seed=SEED, seconds=0.3):
    bench, cell, cfg_file, mix = tiny_cell(workload)
    return run.run_cell(bench, cell, cfg_file, mix, seed, seconds, False,
                        torch.device("cpu"), time.time(),
                        check.load_limits(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_reports(workload):
    code, out = _run(workload)
    assert code == 0
    assert list(out)[:5] == list(KEYS) and list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    bench, cell, _, _ = tiny_cell(workload)
    want = {m["name"] for m in run.metrics_for(bench, cell, False)}
    assert set(out["metrics"]) == want and "setup_s" in want
    for m in out["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert set(out["checks"]) == set(check.load_limits(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_same_seed_same_inputs(workload):
    from portbench.gen.pool import make_pool
    _, _, cfg_file, mix = tiny_cell(workload)
    a = make_pool(cfg_file, mix, SEED)
    b = make_pool(cfg_file, mix, SEED)
    c = make_pool(cfg_file, mix, SEED + 1)
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not torch.equal(a[0]["img"], c[0]["img"])


def _rotate_first(out):
    r = out["pred_r"].clone()
    r[0] = r[0] @ torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                                [0.0, 0.0, 1.0]])
    return dict(out, pred_r=r)


def _serve_fault(kind, monkeypatch):
    from pose_estimation_tpu_torch.serve import InferStep
    if kind == "answer":
        solve = InferStep.solve
        monkeypatch.setattr(InferStep, "solve", lambda self, *a, **k:
                            _rotate_first(solve(self, *a, **k)))
        return
    call = InferStep.__call__

    def half(self, batch, generator=None, subset_ids=None):
        b = batch["img"].shape[0]
        keep = max(b // 2, 1)
        out = call(self, {k: v[:keep] for k, v in batch.items()},
                   generator, subset_ids[:keep])
        return {k: torch.cat([v, v[:1].expand(b - keep, *v.shape[1:])])
                for k, v in out.items()}
    monkeypatch.setattr(InferStep, "__call__", half)


@pytest.mark.parametrize("kind", ("answer", "half_batch"))
def test_serving_fault_is_not_correct(kind, monkeypatch):
    _serve_fault(kind, monkeypatch)
    code, out = _run("krrn.serve_bs256")
    assert code == 0 and out["correct"] is False


def _train_fault(kind, monkeypatch):
    from pose_estimation_tpu_torch.train.state import TrainState
    from pose_estimation_tpu_torch.train.train_step import TrainStep
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        TransparentTrainStep)
    if kind == "unchanged":
        monkeypatch.setattr(TrainState, "apply_gradients",
                            lambda self, tx, grads: self)
        return
    for cls in (TrainStep, TransparentTrainStep):
        def half(self, batch, *a, _losses=cls.losses, **k):
            b = batch["img"].shape[0]
            return _losses(self, {k2: v[:max(b // 2, 1)]
                                  for k2, v in batch.items()}, *a, **k)
        monkeypatch.setattr(cls, "losses", half)


@pytest.mark.parametrize("workload", TRAIN_CELLS)
@pytest.mark.parametrize("kind", ("unchanged", "half_batch"))
def test_training_fault_is_not_correct(kind, workload, monkeypatch):
    _train_fault(kind, monkeypatch)
    code, out = _run(workload)
    assert code == 0 and out["correct"] is False
    if kind == "unchanged":
        # no parameter moved: a leaf at or over the median reads 1
        for k, (v, _) in out["checks"].items():
            if k.startswith("update_gap"):
                assert v > 0.9, (k, v)


def test_serving_control_is_not_correct():
    """The reference one precision down in the program's place fails the
    cell's limits."""
    _, _, cfg_file, mix = tiny_cell("krrn.serve_bs256")
    d = Serve(cfg_file, mix, SEED, torch.device("cpu"))
    nums = check_serve.control_numbers(d)
    assert not check.judge(nums, check.load_limits("krrn.serve_bs256"))


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_training_control_is_not_correct(workload):
    _, _, cfg_file, mix = tiny_cell(workload)
    d = Train(cfg_file, mix, SEED, torch.device("cpu"))
    d.release()
    nums = check_train.control_numbers(d)
    limits = check.load_limits(workload)
    assert not check.judge(nums["control"], limits)

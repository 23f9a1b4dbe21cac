"""The cell pspnet.train_bs8 (the PSPNet generation, configuration
pspnet_cleargrasp) through the harness at a tiny size on the CPU: the
run is correct and reports its end-to-end metrics; with the timed path
broken underneath, or the reference one precision down in the program's
place, it is not. And the cell enters as new files alone: in a copy of
portbench/ from which its files and BENCHMARK.json's additions are taken
out, adding them back as new files changes no other file and the copy
runs the cell correct."""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import check, run
from portbench.check import train as check_train
from portbench.drivers.train import Train
from portbench.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CELL = "pspnet.train_bs8"
CONFIG = "pspnet_cleargrasp"
METRIC = "resize_roofline.train"
# At this tiny size a two-sample batch's loss moves more with rounding
# than at the cell's size: on some seeds bfloat16 rounding alone (the
# reference rounded to bf16) reads over the cell's loss_gap limit, which
# is set from full-size runs (0.00605 on 2 ** 33 + 5, the program 0.00629
# there). On this seed the program reads 0.00096 and the fp8 control
# fails both limits.
SEED = 2 ** 33 + 1801
# the cell's files, relative to portbench/
FILES = ("families/pspnet/program.py", "families/pspnet/reference.py",
         "reference/pspnet.py", f"configs/{CONFIG}.json",
         f"limits/{CELL}.json", f"metrics/{METRIC}.py")


def _run(seed=SEED, seconds=0.3):
    bench, cell, cfg_file, mix = tiny_cell(CELL)
    return run.run_cell(bench, cell, cfg_file, mix, seed, seconds, False,
                        torch.device("cpu"), time.time(),
                        check.load_limits(CELL))


def test_the_cell_runs_correct_and_reports():
    code, out = _run()
    assert code == 0 and out["correct"] is True, out["checks"]
    assert sorted(out["metrics"]) == ["setup_s", "train_samples_per_s"]
    for m in out["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert sorted(out["checks"]) == ["loss_gap", "update_gap_worst"]
    bench, cell, _, _ = tiny_cell(CELL)
    assert METRIC in {m["name"] for m in run.metrics_for(bench, cell, True)}
    assert "resize_bilinear" in run.traced_ops(bench, cell)


def _break(kind, monkeypatch):
    from pose_estimation_tpu_torch.train.state import TrainState
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        TransparentTrainStep)
    if kind == "unchanged":
        monkeypatch.setattr(TrainState, "apply_gradients",
                            lambda self, tx, grads: self)
    elif kind == "half_batch":
        losses = TransparentTrainStep.losses

        def half(self, batch, choose, masks=None):
            keep = max(batch["img"].shape[0] // 2, 1)
            return losses(self, {k: v[:keep] for k, v in batch.items()},
                          choose[:keep], [m[:keep] for m in masks])
        monkeypatch.setattr(TransparentTrainStep, "losses", half)
    else:                           # every dropout mask keeps everything
        draws = TransparentTrainStep.draws

        def no_dropout(self, generator, batch):
            choose, masks = draws(self, generator, batch)
            return choose, [torch.ones_like(m) for m in masks]
        monkeypatch.setattr(TransparentTrainStep, "draws", no_dropout)


@pytest.mark.parametrize("kind", ("unchanged", "half_batch", "no_dropout"))
def test_a_broken_timed_path_is_not_correct(kind, monkeypatch):
    _break(kind, monkeypatch)
    code, out = _run()
    assert code == 0 and out["correct"] is False, out["checks"]


def test_the_fp8_control_is_not_correct():
    _, _, cfg_file, mix = tiny_cell(CELL)
    d = Train(cfg_file, mix, SEED, torch.device("cpu"))
    d.release()
    nums = check_train.control_numbers(d)
    limits = check.load_limits(CELL)
    assert not check.judge(nums["control"], limits)
    assert not check.judge(nums["half_batch"], limits)


def _strip(bench: dict) -> dict:
    """BENCHMARK.json without the cell's additions."""
    bench = json.loads(json.dumps(bench))
    bench["configs"] = [c for c in bench["configs"] if c["name"] != CONFIG]
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != CELL]
    bench["per_layer"] = [m for m in bench["per_layer"]
                          if m["name"] != METRIC]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    return bench


def _hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_the_cell_enters_as_new_files(tmp_path):
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    stripped = _strip(bench)
    # the additions only append: every list keeps its entries in order
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert bench[key][:len(stripped[key])] == [
            dict(e, workloads=e["workloads"] + [CELL])
            if CELL in bench[key][i].get("workloads", ()) else e
            for i, e in enumerate(stripped[key])], key

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    for rel in FILES + ("tests/test_portbench_pspnet.py",):
        (pb / rel).unlink()
    (pb / "families/pspnet").rmdir()
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(stripped, indent=1))
    before = _hashes(tmp_path)
    for rel in FILES:
        path = pb / rel
        assert not path.exists(), rel
        path.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / "portbench" / rel, path)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = (
        "import json, sys, time, torch\n"
        "from portbench import check, run\n"
        "from portbench.tests.tiny import tiny_cell\n"
        f"b, c, f, m = tiny_cell({CELL!r})\n"
        f"code, out = run.run_cell(b, c, f, m, {SEED}, 0.2, False,\n"
        "    torch.device('cpu'), time.time(),\n"
        f"    check.load_limits({CELL!r}))\n"
        "print(json.dumps({'code': code, 'correct': out['correct'],\n"
        "    'family': sys.modules['portbench.families.pspnet.reference']"
        ".__file__}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["code"] == 0 and got["correct"] is True
    assert Path(got["family"]).is_relative_to(tmp_path)
    after = _hashes(tmp_path)
    assert {k: after[k] for k in before} == before
    assert sorted(set(after) - set(before)) == sorted(
        f"portbench/{rel}" for rel in FILES)

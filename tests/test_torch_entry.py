"""The port's entry points on the CPU: the component profiler at the tiny
config with one rep, the rule that every entry point runs on the card
unless the caller asks for the CPU (no card raises; nothing falls back),
and the trainer taking a model of the caller's (the full-fusion KRRN)
through its train and eval steps unchanged."""

import json

import numpy as np
import pytest
import torch

from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
from pose_estimation_tpu_torch.models.krrn import KRRN

torch.set_num_threads(1)

TINY = schema.override(schema.Config(dataset="synthetic"), **{
    "module.num_cls": 2, "data.num_regions": 8, "data.num_points": 128,
    "data.input_size": 64, "module.backbone_outc": 16,
    "module.stem_width": 8,
    "module.hrnet_stages": ((1, 1, (8, 8)), (1, 1, (8, 8, 16)),
                            (1, 1, (8, 8, 16, 16))),
    "module.xyznet": schema.HeadConfig(hidden=16),
    "module.nmlnet": schema.HeadConfig(hidden=16),
    "module.gcn3d": schema.Gcn3dConfig(neighbor_num=4, support_num=2),
    "train.batch_size": 2, "train.amp": False, "train.start_pose_epoch": 0,
    "eval.num_pnp_points": 32, "eval.pnp_hypotheses": 8})

COMPONENTS = 14


def test_profile_eval_times_every_component(capsys):
    """At the tiny config the model parts are small; the ops keep the JAX
    tool's widths (K=10, S=7, O=128) at bs=32."""
    from pose_estimation_tpu_torch.tools import profile_eval
    times = profile_eval.main(["--device", "cpu", "--reps", "1"], cfg=TINY)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device=cpu")
    assert len(times) == COMPONENTS
    assert all(np.isfinite(t) and t > 0 for t in times.values())
    assert [ln.split("  ")[0] for ln in lines[1:-1]] == list(times)
    assert json.loads(lines[-1])["ms"] == times


def test_profile_eval_only_picks_tags(capsys):
    from pose_estimation_tpu_torch.tools import profile_eval
    times = profile_eval.main(["--device", "cpu", "--reps", "1", "--only",
                               "hrnet,pnp"], cfg=TINY)
    assert list(times) == ["HRNet backbone", "pnp_ransac b=32 h=32"]


def _infer(tmp_path):
    from pose_estimation_tpu_torch.tools import infer
    infer.main(["--synthetic", "--frames_per_object", "1", "--output",
                str(tmp_path / "poses.jsonl")], cfg=TINY)


def _cli(tmp_path):
    from pose_estimation_tpu_torch import cli
    cli.main(["--config", "lm_v3_1", "--synthetic", "--log_dir",
              str(tmp_path / "run")])


def _trainer(tmp_path):
    from pose_estimation_tpu_torch.train.trainer import Trainer
    Trainer(TINY, SyntheticPoseDataset(num_objects=2, frames_per_object=1,
                                       num_regions=8),
            log_dir=str(tmp_path / "run"))


def _profile(tmp_path):
    from pose_estimation_tpu_torch.tools import profile_eval
    profile_eval.main(["--reps", "1"], cfg=TINY)


@pytest.mark.parametrize("entry", [_infer, _cli, _trainer, _profile],
                         ids=["infer", "cli", "trainer", "profile_eval"])
def test_entry_points_raise_without_a_card(entry, tmp_path, monkeypatch):
    """Without a card and without --device cpu each entry point raises
    before it builds anything; none carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(tmp_path)
    assert not (tmp_path / "run" / "train.jsonl").exists()


def test_trainer_takes_the_full_fusion_model(tmp_path):
    from pose_estimation_tpu_torch.train.trainer import Trainer
    torch.manual_seed(0)
    model = KRRN(TINY, fusion_variant="full")
    tr = Trainer(TINY, SyntheticPoseDataset(num_objects=2,
                                            frames_per_object=2,
                                            num_regions=8),
                 log_dir=str(tmp_path / "run"), model=model, device="cpu")
    assert tr.model is model and tr.device == torch.device("cpu")
    tr.init_state()
    before = model.FusionNet_0.ConvLayer_3.weights.detach().clone()
    tr.train_epoch(0, steps=1)
    assert tr.state.step == 1
    assert not torch.equal(model.FusionNet_0.ConvLayer_3.weights, before)
    summary = tr.test_epoch(0, max_batches=1)
    assert np.isfinite(summary["overall"]["add_dis"])

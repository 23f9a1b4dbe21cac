"""The port's repairs that need no JAX: a stale checkpoint starts the
trainer fresh, as the JAX trainer does, and ops.check_config holds a
configuration to the kernels' limits, naming the config field. All on the
CPU at the tiny config of the verify recipe; the kernels at each limit's
edge are in tests/test_torch_gpu.py."""

import os

import pytest
import torch

from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
from pose_estimation_tpu_torch.models.fusion import FusionNet, FusionNetLite
from pose_estimation_tpu_torch.ops import check_config
from pose_estimation_tpu_torch.serve import linear_layers

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
    "train.batch_size": 2, "train.amp": False, "train.start_pose_epoch": 0})


def _trainer(cfg, log_dir):
    from pose_estimation_tpu_torch.train.trainer import Trainer
    ds = SyntheticPoseDataset(num_objects=2, frames_per_object=1,
                              num_regions=8)
    return Trainer(cfg, ds, log_dir=str(log_dir), device="cpu")


def _drop_step(ckpt):
    path = os.path.join(ckpt.directory, str(ckpt.latest_step()), "state.pt")
    sd = torch.load(path, weights_only=False)
    del sd["step"]
    torch.save(sd, path)


@pytest.mark.parametrize("case", ["other_config", "missing_step"])
def test_stale_checkpoint_starts_fresh(tmp_path, capsys, case):
    """A checkpoint that does not fit is skipped with the JAX trainer's
    message, and the state is the seeded fresh one. other_config: another
    backbone_outc (16 against 8: the same keys, other shapes), where
    nn.Module.load_state_dict would have copied the tensors whose shapes
    fit before raising. missing_step: this config's tensors without the
    step, where reading the step after the copy would keep the weights."""
    tr = _trainer(TINY, tmp_path / "run")
    tr.init_state()
    tr.train_epoch(0, steps=1)
    tr.ckpt.save(tr.state.step, tr.state)
    other = TINY
    if case == "other_config":
        other = schema.override(TINY, **{"module.backbone_outc": 8})
    else:
        _drop_step(tr.ckpt)
    capsys.readouterr()
    stale = _trainer(other, tmp_path / "run").init_state()
    assert ("[trainer] checkpoint restore failed (ValueError); starting "
            "fresh") in capsys.readouterr().out
    fresh = _trainer(other, tmp_path / "empty").init_state()
    assert stale.step == 0 and fresh.step == 0
    for (k, a), (_, b) in zip(stale.model.state_dict().items(),
                              fresh.model.state_dict().items(),
                              strict=True):
        assert torch.equal(a, b), k
    for k in ("mu", "nu", "slow"):
        for name, t in fresh.opt_state[k].items():
            assert torch.equal(stale.opt_state[k][name], t), (k, name)
    assert stale.opt_state["count"] == fresh.opt_state["count"] == 0
    assert torch.equal(stale.generator.get_state(),
                       fresh.generator.get_state())


def test_checkpoint_of_the_same_config_still_resumes(tmp_path, capsys):
    tr = _trainer(TINY, tmp_path / "run")
    tr.init_state()
    tr.train_epoch(0, steps=1)
    tr.ckpt.save(tr.state.step, tr.state)
    again = _trainer(TINY, tmp_path / "run").init_state()
    assert "starting fresh" not in capsys.readouterr().out
    assert again.step == 1
    for (k, a), (_, b) in zip(again.model.state_dict().items(),
                              tr.state.model.state_dict().items(),
                              strict=True):
        assert torch.equal(a, b), k


FUSION = {"lite": FusionNetLite, "full": FusionNet}


def _layers(variant, cfg, dtype):
    """serve.linear_layers of the fusion net a KRRN of `cfg` builds."""
    g = cfg.module.gcn3d
    return linear_layers(FUSION[variant](g.neighbor_num, g.support_num,
                                         dtype=dtype))


@pytest.mark.parametrize("variant", ["lite", "full"])
@pytest.mark.parametrize("amp", [True, False])
def test_shipped_and_tiny_configs_are_inside_every_limit(variant, amp):
    dtype = torch.bfloat16 if amp else torch.float32
    for cfg in (schema.Config(), TINY):
        check_config(cfg, _layers(variant, cfg, dtype))


def _gcn(cfg, **kw):
    return schema.override(cfg, **{"module.gcn3d": schema.Gcn3dConfig(
        **{"neighbor_num": 10, "support_num": 7, **kw})})


def test_neighbor_num_edge():
    """KNN takes 32 neighbours a search; a self search asks for
    neighbor_num + 1."""
    check_config(_gcn(schema.Config(), neighbor_num=31))
    with pytest.raises(ValueError, match=r"module\.gcn3d\.neighbor_num = 32"
                       r".*neighbor_num <= 31"):
        check_config(_gcn(schema.Config(), neighbor_num=32))


@pytest.mark.parametrize("variant,dtype,last", [
    ("lite", torch.bfloat16, 32), ("lite", torch.float32, 16),
    ("full", torch.bfloat16, 16), ("full", torch.float32, 8)])
def test_support_num_edge(variant, dtype, last):
    """The fused linear aggregate takes S*O <= 4096 bf16 or 2048 fp32
    values; the full FusionNet's level 1 has O = 256, the lite one's
    O = 128. The layers' dtype, not cfg.train.amp, decides."""
    cfg = _gcn(schema.Config(), support_num=last)
    check_config(cfg, _layers(variant, cfg, dtype))
    cfg = _gcn(schema.Config(), support_num=last + 1)
    with pytest.raises(ValueError, match=rf"module\.gcn3d\.support_num = "
                       rf"{last + 1}.*support_num <= {last}"):
        check_config(cfg, _layers(variant, cfg, dtype))


def test_layer_width_must_be_a_multiple_of_8():
    check_config(TINY, [(2, 8, torch.float32)])
    with pytest.raises(ValueError, match=r"width 12.*a multiple of 8"):
        check_config(TINY, [(2, 12, torch.float32)])


@pytest.mark.parametrize("variant,s,widths", [
    ("lite", 7, [128]), ("full", 7, [128, 256]), ("full", 1, [256])])
def test_linear_widths_are_the_fusion_nets(variant, s, widths):
    """The layers check_model holds to S*O are the 3-D narrow ConvLayers
    each fusion net hands linear_multi; at S = 1 only the full net's
    128 -> 256 stream layers stay narrow, the others go to the wide-table
    aggregate."""
    cfg = _gcn(TINY, support_num=s)
    assert _layers(variant, cfg, torch.bfloat16) == [
        (s, o, torch.bfloat16) for o in widths]


def test_model_check_waits_for_a_card():
    """On the CPU the plain versions take any shape, so the serving step
    builds for a configuration the kernels refuse."""
    from pose_estimation_tpu_torch.models.krrn import KRRN
    from pose_estimation_tpu_torch.serve import build_infer_step
    cfg = _gcn(TINY, neighbor_num=40)
    with pytest.raises(ValueError):
        check_config(cfg)
    build_infer_step(KRRN(cfg), cfg)

"""The transparent pipeline's data layer and entry points on the CPU:

  data/exr.py against the JAX package's codec on tests/test_exr.py's
      cases (float32 and half, the compressions, single channel, chunk
      boundaries, incompressible rows): the same arrays read and the
      same bytes written;
  ClearGraspDataset on tests/golden/cleargrasp: the instances, model
      points and every array of every frame equal to the JAX reader's,
      bit for bit;
  make_transparent_batch on the fixture and on SyntheticTransparentDataset
      (whose frames equal the JAX fixture's): equal to the JAX batch for
      the same indices and seed, bit for bit;
  cli.py --synthetic on a tiny transparent config (TRPESNet(num_points=32,
      num_obj=3), 32-px crops, train.refine: the eval runs ICP) for one
      debug epoch, then tools/eval_transparent.py on its checkpoint and the
      JAX tool on the same weights (an orbax checkpoint of the JAX
      package): the summaries' keys equal, the counts and accept bits
      equal, the distances and errors at 1e-4 relative (the eval
      forward's fp32 drift, test_torch_transparent_models.py, through
      ADD(-S) and ICP);
  cli.py --dataset cleargrasp on the fixture (one object of the three the
      config names has a mesh: the ADD thresholds are taken for the
      objects evaluated); transparent_model="posenet" refuses crops too
      small for its PSP pyramid; the CLI, the eval tool and the trainer raise without a
      card unless asked for the CPU.
"""

import glob
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from pose_estimation_tpu.data import cleargrasp as jcg
from pose_estimation_tpu.data import exr as jexr
from pose_estimation_tpu.data import synthetic as jsyn
from pose_estimation_tpu.data import transparent_batching as jtb
from pose_estimation_tpu_torch import cli
from pose_estimation_tpu_torch.data import cleargrasp as tcg
from pose_estimation_tpu_torch.data import exr as texr
from pose_estimation_tpu_torch.data import synthetic as tsyn
from pose_estimation_tpu_torch.data import transparent_batching as ttb

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cleargrasp")
CONFIG_PY = """\
from {pkg}.configs import schema


def get_config():
    return schema.override(schema.transparent_cleargrasp(), **{{
        "module.num_cls": 3, "data.num_points": 32, "data.input_size": 32,
        "train.batch_size": 2, "train.amp": False, "train.ckpt_every": 0,
        "train.lr.warmup_iters": 0, "train.refine": True}})
"""


# --- EXR ----------------------------------------------------------------------

EXR_CASES = ([("rgb", c, False) for c in ("none", "zip", "zips")]
             + [("rgb", c, True) for c in ("none", "zip")]
             + [("depth", "zip", False)]
             + [(f"h{h}", "zip", False) for h in (15, 16, 17, 32, 33)]
             + [("tiny", "zips", False)])


def _exr_image(kind, rng):
    if kind == "rgb":
        return rng.rand(37, 53, 3).astype(np.float32) * 4.0 - 1.0
    if kind == "depth":
        return (rng.rand(24, 31) * 3.0).astype(np.float32)
    if kind == "tiny":
        return rng.rand(4, 4, 3).astype(np.float32)
    return rng.rand(int(kind[1:]), 8, 3).astype(np.float32)


@pytest.mark.parametrize("kind,compression,half", EXR_CASES)
def test_exr_codec_matches_jax(tmp_path, kind, compression, half):
    img = _exr_image(kind, np.random.RandomState(0))
    paths = []
    for name, mod in (("jax", jexr), ("port", texr)):
        p = str(tmp_path / f"{name}.exr")
        mod.write_exr(p, img, compression=compression, half=half)
        paths.append(p)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    got, ref = texr.read_exr(paths[0]), jexr.read_exr(paths[0])
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_exr_rejects_non_exr(tmp_path):
    p = str(tmp_path / "x.exr")
    with open(p, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nnot an exr")
    with pytest.raises(ValueError):
        texr.read_exr(p)


# --- ClearGrasp ---------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    return jcg.ClearGraspDataset(GOLDEN), tcg.ClearGraspDataset(GOLDEN)


def test_cleargrasp_frames_match_jax(golden):
    ref, got = golden
    assert len(got) == len(ref) == 2
    for a, b in zip(ref.instances, got.instances):
        for f in ("obj_name", "obj_id", "instance_id"):
            assert getattr(a, f) == getattr(b, f)
        for f in ("r", "t", "k"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    np.testing.assert_array_equal(got.model_points(0), ref.model_points(0))
    np.testing.assert_array_equal(got.axis(0), ref.axis(0))
    for i in range(len(ref)):
        fa, fb = ref[i], got[i]
        assert sorted(fa) == sorted(fb)
        for k in fa:
            np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)
    for path in glob.glob(os.path.join(GOLDEN, "*", "*", "*.exr")):
        np.testing.assert_array_equal(tcg.read_exr(path), jcg.read_exr(path))


def _assert_batches_equal(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("seed", [0, 5])
def test_transparent_batch_on_cleargrasp_matches_jax(golden, seed):
    ref, got = golden
    kw = dict(seed=seed, img_size=64, num_model=100)
    _assert_batches_equal(ttb.make_transparent_batch(got, [1, 0], **kw),
                          jtb.make_transparent_batch(ref, [1, 0], **kw))


def test_synthetic_transparent_batch_matches_jax():
    kw = dict(num_objects=2, frames_per_object=2, im_h=120, im_w=160,
              num_regions=8, sym_objects=(1,))
    ref, got = (jsyn.SyntheticTransparentDataset(**kw),
                tsyn.SyntheticTransparentDataset(**kw))
    for i in range(len(ref)):
        fa, fb = ref[i], got[i]
        assert sorted(fa) == sorted(fb)
        for k in fa:
            np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)
    np.testing.assert_array_equal(got.model_points(1, 64),
                                  ref.model_points(1, 64))
    batch = ttb.make_transparent_batch(got, [3, 0, 1], seed=2, img_size=48,
                                       num_model=64)
    _assert_batches_equal(batch, jtb.make_transparent_batch(
        ref, [3, 0, 1], seed=2, img_size=48, num_model=64))
    np.testing.assert_array_equal(batch["sym_mask"].numpy(), [1.0, 0.0, 1.0])


# --- the entry points -----------------------------------------------------------

def _config_file(tmp_path, pkg="pose_estimation_tpu_torch") -> str:
    path = tmp_path / f"{pkg}_cfg.py"
    path.write_text(CONFIG_PY.format(pkg=pkg))
    return str(path)


def _summary(out: str) -> dict:
    """The last indented JSON object printed."""
    return json.loads(out[out.rindex("{\n  \"per_object\""):])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("transparent_cli")
    log_dir = tmp / "run"
    assert cli.main(["--config", _config_file(tmp), "--synthetic", "--debug",
                     "--epochs", "1", "--frames_per_object", "2",
                     "--log_dir", str(log_dir), "--device", "cpu"]) == 0
    return tmp, log_dir


def test_cli_trains_and_evaluates(run):
    _, log_dir = run
    train = [json.loads(x) for x in open(log_dir / "train.jsonl")]
    evals = [json.loads(x) for x in open(log_dir / "eval.jsonl")]
    for k in ("all_loss", "loss_add", "loss_r", "loss_n", "loss_m", "loss_d",
              "distance", "skipped_nonfinite", "grad_norm"):
        assert np.isfinite(train[0][k]), k
    assert train[0]["skipped_nonfinite"] == 0.0
    assert evals[-1]["count"] == 6
    for k in ("add_dis", "add_ok", "rot_deg", "trans_m", "deg_cm_ok",
              "add_dis_icp", "add_ok_icp", "rot_deg_icp", "trans_m_icp",
              "icp_accepted"):
        assert np.isfinite(evals[-1][k]), k
    assert os.path.exists(log_dir / "ckpt" / "3" / "state.pt")


def test_cli_eval_mode_restores_the_run(run, capsys):
    """--eval_mode on the run's log dir restores its checkpoint (step 3)
    and prints the summary of the test split."""
    tmp, log_dir = run
    assert cli.main(["--config", _config_file(tmp), "--synthetic",
                     "--eval_mode", "--frames_per_object", "2", "--log_dir",
                     str(log_dir), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out.splitlines()[0])["step"] == 3
    assert _summary(out)["overall"]["count"] == 6


def test_eval_tool_matches_the_jax_tool(run, tmp_path, capsys):
    from pose_estimation_tpu.cli import load_config as jload_config
    from pose_estimation_tpu.tools import eval_transparent as jtool
    from pose_estimation_tpu.train.checkpoint import (
        CheckpointManager as JManager)
    from pose_estimation_tpu.train.state import TrainState as JTrainState
    from pose_estimation_tpu.train.transparent_trainer import (
        TransparentTrainer as JTrainer)
    from pose_estimation_tpu_torch import convert
    from pose_estimation_tpu_torch.tools import eval_transparent
    from pose_estimation_tpu_torch.train.checkpoint import CheckpointManager
    tmp, log_dir = run
    cfg_jax = _config_file(tmp_path, "pose_estimation_tpu")
    args = ["--synthetic", "--max_batches", "2"]
    got = eval_transparent.main(["--config", _config_file(tmp), "--ckpt",
                                 str(log_dir / "ckpt"), "--log_dir",
                                 str(tmp_path / "port_eval"), "--device",
                                 "cpu", *args])
    capsys.readouterr()

    # the run's weights as an orbax checkpoint of the JAX package
    ckpt = CheckpointManager(str(log_dir / "ckpt"))
    params = convert.torch_to_flax(ckpt.read(ckpt.latest_step())["model"])
    nested = {}
    for k, v in params.items():
        node = nested
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jax.numpy.asarray(v)
    jcfg = jload_config(cfg_jax)
    jtr = JTrainer(jcfg, jsyn.SyntheticTransparentDataset(
        num_objects=3, frames_per_object=1,
        num_regions=jcfg.data.num_regions), log_dir=str(tmp_path / "jinit"))
    JManager(str(tmp_path / "jckpt")).save(1, JTrainState.create(
        nested, jtr.tx, jax.random.PRNGKey(0)))
    jtool.main(["--config", cfg_jax, "--ckpt", str(tmp_path / "jckpt"),
                "--log_dir", str(tmp_path / "jax_eval"), *args])
    ref = _summary(capsys.readouterr().out)

    assert sorted(got["per_object"]) == sorted(ref["per_object"])
    for part in [("overall",)] + [("per_object", c) for c in ref["per_object"]]:
        g, r = got, ref
        for key in part:
            g, r = g[key], r[key]
        assert sorted(g) == sorted(r), part
        for k, v in r.items():
            if k == "count" or k.startswith(("add_ok", "deg_cm_ok",
                                             "icp_accepted")):
                assert g[k] == v, (part, k)
            else:
                np.testing.assert_allclose(g[k], v, rtol=1e-4, atol=1e-6,
                                           err_msg=str((part, k)))
    assert got["overall"]["count"] == 4


def test_cli_on_the_cleargrasp_fixture(tmp_path):
    log_dir = tmp_path / "cg"
    assert cli.main(["--config", _config_file(tmp_path), "--dataset",
                     "cleargrasp", "--dataset_root", GOLDEN, "--debug",
                     "--epochs", "1", "--log_dir", str(log_dir),
                     "--device", "cpu"]) == 0
    train = [json.loads(x) for x in open(log_dir / "train.jsonl")]
    evals = [json.loads(x) for x in open(log_dir / "eval.jsonl")]
    assert len(train) == 1 and np.isfinite(train[0]["all_loss"])
    assert evals[-1]["count"] == 2 and np.isfinite(evals[-1]["add_dis"])


def test_posenet_generation_refuses(tmp_path):
    """The PSPNet generation refuses this file's 32-px crops: its PSP
    pyramid pools 6 x 6 features, 48-px crops at least (its CPU tests:
    test_torch_pspnet_train.py)."""
    path = tmp_path / "posenet.py"
    path.write_text(CONFIG_PY.format(pkg="pose_estimation_tpu_torch").replace(
        '"train.refine": True', '"train.refine": True,\n        '
        '"module.transparent_model": "posenet"'))
    with pytest.raises(SystemExit, match=re.escape("at least 48 px")):
        cli.main(["--config", str(path), "--synthetic", "--device", "cpu",
                  "--log_dir", str(tmp_path / "r")])


def _transparent_cli(tmp_path):
    cli.main(["--config", "transparent_cleargrasp", "--synthetic",
              "--frames_per_object", "1", "--log_dir", str(tmp_path / "run")])


def _eval_tool(tmp_path):
    from pose_estimation_tpu_torch.tools import eval_transparent
    eval_transparent.main(["--config", "transparent_cleargrasp",
                           "--synthetic", "--log_dir", str(tmp_path / "run")])


def _transparent_trainer(tmp_path):
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        TransparentTrainer)
    TransparentTrainer(schema.transparent_cleargrasp(),
                       tsyn.SyntheticTransparentDataset(num_objects=5,
                                                        frames_per_object=1),
                       log_dir=str(tmp_path / "run"))


@pytest.mark.parametrize("entry", [_transparent_cli, _eval_tool,
                                   _transparent_trainer],
                         ids=["cli", "eval_transparent", "trainer"])
def test_transparent_entry_points_raise_without_a_card(entry, tmp_path,
                                                       monkeypatch):
    """Without a card and without --device cpu each entry point raises
    before it builds the model; none carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(tmp_path)
    assert not (tmp_path / "run" / "train.jsonl").exists()

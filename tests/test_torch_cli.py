"""The port's entry points on a LineMOD tree, on the CPU (tiny config).

- cli.py --dataset linemod trains and evaluates on a fake BOP tree (the
  port's own writer), and --eval_mode evaluates its test split; YCB-V
  builds through --dataset ycb; the transparent pipeline's PSPNet
  generation refuses a crop under its PSP pyramid's 48 px;
- --resume_backbone_only from a run with another head width copies
  exactly the tensors whose name and shape match, and nothing else;
- train/checkpoint.save_params_npz is read by the JAX package's
  load_params_npz, and the flax KRRN gives the port's pred_t;
- tools/infer.py serves the port's own checkpoint (--ckpt), one record
  per frame, reads a --config .py file, and refuses --params with --ckpt
  and a checkpoint directory without a checkpoint;
- tools/eval_standalone.py prints the JAX tool's summary on the same
  weights, tree and random draws;
- where the two packages' pred_t part on random weights, at 8- and
  16-wide heads: fp32 drift in the 2-D network, bf16 rounding at kernel
  1's inputs, and near-ties in a pool layer's KNN.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_estimation_tpu.configs import schema as jschema
from pose_estimation_tpu.models.krrn import KRRN as JKRRN
from pose_estimation_tpu.parallel import train_step as jstep
from pose_estimation_tpu.train.checkpoint import load_params_npz
from pose_estimation_tpu_torch import cli
from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.data.testing import write_fake_bop_tree
from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.train.checkpoint import (
    CheckpointManager, save_params_npz)

torch.set_num_threads(1)

FRAMES = 3          # per object and split; 2 objects
# the widths of tests/test_torch_slice.py's TINY (16-wide heads), where
# its pred_t tolerance holds; at 8-wide heads a near-tie in a pool layer's
# KNN parts the packages by 1e-3-1e-2 on some frames
# (test_pred_t_gap_traced_to_its_layers)
OVER = {"module.num_cls": 2, "data.num_regions": 8,
        "data.num_points": 128, "data.input_size": 64,
        "module.backbone_outc": 16, "train.amp": False,
        "module.stem_width": 8,
        "module.hrnet_stages": ((1, 1, (8, 8)), (1, 1, (8, 8, 16)),
                                (1, 1, (8, 8, 16, 16))),
        "module.gcn3d": lambda m: m.Gcn3dConfig(neighbor_num=4,
                                                support_num=2),
        "module.nmlnet": lambda m: m.HeadConfig(hidden=16),
        "train.batch_size": 2, "train.ckpt_every": 0,
        "train.start_pose_epoch": 0, "eval.num_pnp_points": 32,
        "eval.pnp_hypotheses": 8}
CONFIG_PY = """\
from pose_estimation_tpu_torch.configs import schema


def get_config():
    return schema.override(
        schema.Config(dataset="{dataset}", cls_type="all"),
        **{{"module.num_cls": 2, "data.num_regions": 8,
           "data.num_points": 128, "data.input_size": 64,
           "module.backbone_outc": 16, "train.amp": False,
           "module.stem_width": 8,
           "module.hrnet_stages": ((1, 1, (8, 8)), (1, 1, (8, 8, 16)),
                                   (1, 1, (8, 8, 16, 16))),
           "module.gcn3d": schema.Gcn3dConfig(neighbor_num=4, support_num=2),
           "module.xyznet": schema.HeadConfig(hidden={hidden}),
           "module.nmlnet": schema.HeadConfig(hidden=16),
           "train.batch_size": 2, "train.ckpt_every": 0,
           "train.start_pose_epoch": 0, "eval.num_pnp_points": 32,
           "eval.pnp_hypotheses": 8}})
"""


def _cfg(mod, hidden=16, **extra):
    """The config of CONFIG_PY, from the port's schema or the JAX one."""
    over = {k: v(mod) if callable(v) else v for k, v in OVER.items()}
    over["module.xyznet"] = mod.HeadConfig(hidden=hidden)
    over.update(extra)
    return mod.override(mod.Config(cls_type="all"), **over)


def _config_file(tmp_path, dataset="linemod", hidden=16):
    path = tmp_path / f"cfg_{dataset}_{hidden}.py"
    path.write_text(CONFIG_PY.format(dataset=dataset, hidden=hidden))
    return str(path)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bop"))
    write_fake_bop_tree(root, num_objects=2, frames_per_object=FRAMES)
    return root


@pytest.fixture(scope="module")
def run(tree, tmp_path_factory):
    """One debug epoch of cli.py --dataset linemod on the CPU."""
    tmp = tmp_path_factory.mktemp("run")
    log_dir = str(tmp / "run")
    rc = cli.main(["--config", _config_file(tmp, "synthetic"),
                   "--dataset", "linemod", "--cls_type", "all",
                   "--dataset_root", tree, "--log_dir", log_dir,
                   "--debug", "--epochs", "1", "--device", "cpu"])
    assert rc == 0
    return tmp, log_dir


def _jsonl(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def test_cli_trains_and_evaluates_on_a_linemod_tree(run):
    """--dataset and --cls_type override the file's synthetic config; the
    train split (train_pbr, 6 frames) gives 3 steps at bs=2, then one eval
    pass over it, and a checkpoint of the best eval."""
    tmp, log_dir = run
    train = _jsonl(f"{log_dir}/train.jsonl")
    evals = _jsonl(f"{log_dir}/eval.jsonl")
    assert train and np.isfinite(train[0]["loss"])
    assert len(evals) == 1 and evals[0]["count"] == 2 * FRAMES
    assert np.isfinite(evals[0]["add_dis"])
    assert CheckpointManager(f"{log_dir}/ckpt").latest_step() == 3


def test_cli_eval_mode_reads_the_test_split(run, tree, capsys):
    tmp, _ = run
    rc = cli.main(["--config", _config_file(tmp), "--dataset_root", tree,
                   "--log_dir", str(tmp / "eval_run"), "--eval_mode",
                   "--device", "cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert summary["overall"]["count"] == 2 * FRAMES
    assert sorted(summary["per_object"]) == ["0", "1"]


def test_cli_ycb_and_the_parts_not_ported(tmp_path, capsys):
    root = str(tmp_path / "ycb")
    write_fake_bop_tree(root, num_objects=2, frames_per_object=1,
                        splits=("train_real", "train_synt", "test"))
    rc = cli.main(["--config", _config_file(tmp_path), "--dataset", "ycb",
                   "--dataset_root", root, "--log_dir",
                   str(tmp_path / "run"), "--eval_mode", "--device", "cpu"])
    assert rc == 0
    assert '"count": 2' in capsys.readouterr().out
    # the PSPNet generation refuses a crop its PSP pyramid cannot pool
    posenet = tmp_path / "posenet.py"
    posenet.write_text(
        "from pose_estimation_tpu_torch.configs import schema\n\n\n"
        "def get_config():\n"
        "    return schema.override(schema.transparent_cleargrasp(),\n"
        "        **{'module.transparent_model': 'posenet',\n"
        "           'data.input_size': 32})\n")
    with pytest.raises(SystemExit, match="at least 48 px"):
        cli.main(["--config", str(posenet), "--synthetic",
                  "--frames_per_object", "1", "--device", "cpu",
                  "--log_dir", str(tmp_path / "posenet_run")])


def test_resume_backbone_only_merges_the_shape_matching_tensors(run, tree,
                                                                capsys):
    """A model whose xyz head is 12 wide instead of 16 takes every tensor
    of the 16-wide run whose name and shape match; the others keep their
    fresh values, and the optimizer state and step stay fresh."""
    from pose_estimation_tpu_torch.train.trainer import Trainer
    tmp, log_dir = run
    saved = torch.load(f"{log_dir}/ckpt/3/state.pt", weights_only=True)
    torch.manual_seed(0)
    fresh = KRRN(_cfg(schema, hidden=12)).state_dict()
    want = {k for k, v in fresh.items()
            if k in saved["model"] and saved["model"][k].shape == v.shape}
    assert 0 < len(want) < len(fresh)

    rc = cli.main(["--config", _config_file(tmp, hidden=12),
                   "--dataset_root", tree, "--log_dir",
                   str(tmp / "partial_cli"), "--resume", f"{log_dir}/ckpt",
                   "--resume_backbone_only", "--eval_mode", "--device",
                   "cpu"])
    assert rc == 0
    n = re.search(r"partial restore: (\d+) matching param leaves",
                  capsys.readouterr().out)
    assert n and int(n.group(1)) == len(want)

    from pose_estimation_tpu_torch.data.linemod import LinemodDataset
    cfg = _cfg(schema, hidden=12)
    tr = Trainer(cfg, LinemodDataset(tree, cls_type="all", cfg=cfg),
                 log_dir=str(tmp / "partial"), resume=f"{log_dir}/ckpt",
                 resume_backbone_only=True, device="cpu")
    state = tr.init_state()
    got = tr.model.state_dict()
    for k, v in got.items():
        ref = saved["model"][k] if k in want else fresh[k]
        assert torch.equal(v, ref), k
    assert state.step == 0
    for k, v in state.opt_state["slow"].items():
        assert torch.equal(v, fresh[k]), k


def test_save_params_npz_feeds_the_flax_model(run, tree):
    """The port's checkpoint -> save_params_npz -> the JAX package's
    load_params_npz -> flax KRRN: pred_t within the tolerance of
    tests/test_torch_slice.py (2e-3 x max(1, |ref|))."""
    from pose_estimation_tpu_torch import serve
    from pose_estimation_tpu_torch.convert import load_params_npz as tload
    from pose_estimation_tpu_torch.data.batching import make_batch
    from pose_estimation_tpu_torch.data.linemod import LinemodDataset
    tmp, log_dir = run
    cfg, jcfg = _cfg(schema), _cfg(jschema)
    model = KRRN(cfg)
    CheckpointManager(f"{log_dir}/ckpt").merge_partial_params(model)
    path = str(tmp / "params.npz")
    save_params_npz(path, model)
    again = tload(KRRN(cfg), path)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k

    ds = LinemodDataset(tree, mode="eval", cls_type="all", cfg=cfg)
    batch = make_batch(ds, range(len(ds)), torch.Generator().manual_seed(0),
                       cfg.data.input_size, cfg.data.num_points)
    _, pred_t = serve.build_infer_step(model.eval(), cfg).forward(batch)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    ref = jax.jit(lambda p, b: jstep._decoded_xyz_and_t(
        JKRRN(cfg=jcfg), jcfg, {"params": p}, b))(load_params_npz(path),
                                                  jbatch)[1]
    ref = np.asarray(ref)
    tol = 2e-3 * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(pred_t.numpy() - ref).max()) <= tol


def _nested(flat: dict) -> dict:
    out = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("hidden", [8, 16])
def test_pred_t_gap_traced_to_its_layers(tree, hidden, monkeypatch):
    """Where the two packages' pred_t part, on random weights, at 8-wide
    heads (where the gap reaches 1e-3-1e-2 on some frames) and 16-wide:

    - the 2-D network (HRNet, the xyz and normal heads; fp32) drifts by
      fp32 rounding alone: within 1e-3 of its scale at the heads. In the
      fusion net that drift can flip a feature to the next bf16 value
      where kernel 1 takes its inputs in bf16 (in both packages);
    - handed the port's head outputs, the JAX model still parts on a frame
      where the normal stream's pool layer meets a near-tie: points with
      normals equal to within one fp32 step, whose order in the KNN
      (and so which of them exclude_self drops as the query itself) the
      rounding of |a|^2 + |b|^2 - 2 a.b decides, differently in the two
      packages;
    - handed the heads and the port's KNN indices too, the JAX model
      gives the port's pred_t within 1e-5 on every frame, and the frames
      that parted with the heads alone are among those whose KNN
      neighbour sets differ."""
    import flax.linen as nn
    from pose_estimation_tpu.core import pointops as jpo
    from pose_estimation_tpu_torch.convert import torch_to_flax
    from pose_estimation_tpu_torch.core.pointops import neighbors as tpo
    from pose_estimation_tpu_torch.data.batching import make_batch
    from pose_estimation_tpu_torch.data.linemod import LinemodDataset
    heads = {"module.nmlnet": lambda m: m.HeadConfig(hidden=hidden)}
    cfg = _cfg(schema, hidden, **{k: f(schema) for k, f in heads.items()})
    jcfg = _cfg(jschema, hidden,
                **{k: f(jschema) for k, f in heads.items()})
    torch.manual_seed(0)
    model = KRRN(cfg).eval()
    params = {"params": _nested(torch_to_flax(model.state_dict()))}
    ds = LinemodDataset(tree, mode="eval", cls_type="all", cfg=cfg)
    batch = make_batch(ds, range(len(ds)), torch.Generator().manual_seed(0),
                       cfg.data.input_size, cfg.data.num_points)
    got_heads = {}
    for name in ("XYZHead_0", "NMLHead_0"):
        getattr(model, name).register_forward_hook(
            lambda m, i, o, name=name: got_heads.__setitem__(
                name, o.detach().permute(0, 2, 3, 1).numpy()))
    with torch.no_grad():
        pred_t = model(batch["img"], batch["cloud"], batch["choose"],
                       batch["cls"], opt_pose=True)["pred_t"].numpy()
    jmodel = JKRRN(cfg=jcfg)
    args = [jnp.asarray(batch[k].numpy())
            for k in ("img", "cloud", "choose", "cls")]
    ref, inter = jmodel.apply(
        params, *args, train=False, opt_pose=True, mutable=["intermediates"],
        capture_intermediates=lambda m, _: m.name in got_heads)
    ref = np.asarray(ref["pred_t"])
    for name, got in got_heads.items():
        want = np.asarray(inter["intermediates"][name]["__call__"][0])
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), name

    def hand_over(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and (context.module.name
                                                  in got_heads):
            return jnp.asarray(got_heads[context.module.name])
        return next_fun(*args, **kwargs)

    def forward():
        with nn.intercept_methods(hand_over):
            return np.asarray(jmodel.apply(params, *args, train=False,
                                           opt_pose=True)["pred_t"])

    handed = np.abs(pred_t - forward()).max(-1)
    parted = set()

    def port_knn(jfun, tfun):
        def knn(*a, **kw):
            want = np.asarray(jfun(*a, **kw))
            got = tfun(*[torch.from_numpy(np.array(x)) if hasattr(
                x, "shape") else x for x in a], **kw).numpy()
            rows = (np.sort(got, -1) != np.sort(want, -1)).any(-1)
            parted.update(np.nonzero(rows.any(-1))[0].tolist())
            return jnp.asarray(got)
        return knn

    for name in ("knn_indices", "knn_indices_cross"):
        monkeypatch.setattr(jpo, name, port_knn(getattr(jpo, name),
                                                getattr(tpo, name)))
    same = np.abs(pred_t - forward()).max(-1)
    print(f"hidden={hidden} pred_t gap per frame: whole model "
          f"{np.abs(pred_t - ref).max(-1).tolist()}, heads handed over "
          f"{handed.tolist()}, heads and KNN {same.tolist()}; KNN sets "
          f"differ on frames {sorted(parted)}")
    tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    assert same.max() <= tol, same
    assert set(np.nonzero(handed > tol)[0].tolist()) <= parted
    if hidden == 16:
        assert np.abs(pred_t - ref).max() <= 2e-3 * max(
            1.0, float(np.abs(ref).max()))


def test_infer_serves_the_ports_checkpoint(run, tree):
    """--ckpt restores the run's TrainState: the records equal those of
    the same weights handed over as a params .npz; one record per frame
    of the test split. --config takes a .py file (it took only a preset
    name before)."""
    from pose_estimation_tpu_torch.tools import infer
    tmp, log_dir = run
    base = ["--config", _config_file(tmp), "--dataset_root", tree,
            "--batch_size", "4", "--device", "cpu"]
    a = infer.main(base + ["--ckpt", f"{log_dir}/ckpt", "--output",
                           str(tmp / "a.jsonl")])
    model = KRRN(_cfg(schema))
    CheckpointManager(f"{log_dir}/ckpt").merge_partial_params(model)
    save_params_npz(str(tmp / "p.npz"), model)
    infer.main(base + ["--params", str(tmp / "p.npz"), "--output",
                       str(tmp / "b.jsonl")])
    ra, rb = _jsonl(tmp / "a.jsonl"), _jsonl(tmp / "b.jsonl")
    assert a["frames"] == len(ra) == 2 * FRAMES
    assert [r["index"] for r in ra] == list(range(2 * FRAMES))
    assert ra == rb
    fresh = infer.main(base + ["--output", str(tmp / "c.jsonl")])
    assert fresh["frames"] == 2 * FRAMES
    assert _jsonl(tmp / "c.jsonl") != ra
    one = infer.main(base + ["--ckpt", f"{log_dir}/ckpt", "--max_batches",
                             "1", "--output", str(tmp / "d.jsonl")])
    assert one["frames"] == 4


def test_infer_reads_a_config_file(tmp_path):
    """--config takes a .py file's get_config(), as the JAX tool's does
    through cli.load_config (the port's tool took only a preset name)."""
    from pose_estimation_tpu_torch.tools import infer
    out = infer.main(["--config", _config_file(tmp_path, "synthetic"),
                      "--synthetic", "--frames_per_object", "1",
                      "--device", "cpu", "--output",
                      str(tmp_path / "poses.jsonl")])
    assert out["frames"] == 2


def test_infer_refuses_two_weight_sources_and_an_empty_ckpt(run, tree,
                                                            tmp_path):
    from pose_estimation_tpu_torch.tools import infer
    tmp, log_dir = run
    base = ["--config", _config_file(tmp), "--dataset_root", tree,
            "--device", "cpu", "--output", str(tmp_path / "x.jsonl")]
    with pytest.raises(SystemExit, match="mutually exclusive"):
        infer.main(base + ["--ckpt", f"{log_dir}/ckpt", "--params",
                           str(tmp_path / "p.npz")])
    with pytest.raises(SystemExit, match="no checkpoint found"):
        infer.main(base + ["--ckpt", str(tmp_path / "empty")])


def _summary(out: str) -> dict:
    """The indented summary JSON a tool prints last."""
    return json.loads(out[out.index("{\n"):])


def _assert_same_summary(ref, got, tol, rot_deg_tol):
    assert sorted(got) == sorted(ref)
    assert sorted(got["per_object"]) == sorted(ref["per_object"])
    pairs = [(ref["overall"], got["overall"])] + [
        (ref["per_object"][k], got["per_object"][k])
        for k in ref["per_object"]]
    for r, g in pairs:
        assert sorted(g) == sorted(r)
        assert g["count"] == r["count"]
        for k in r:
            atol = rot_deg_tol if k == "rot_deg" else tol
            np.testing.assert_allclose(g[k], r[k], rtol=tol, atol=atol,
                                       err_msg=k)


def test_eval_standalone_matches_the_jax_tool(run, tree, tmp_path,
                                              monkeypatch, capsys):
    """Both tools, on the run's weights (the port's checkpoint, and the
    same parameters through save_params_npz -> load_params_npz -> an orbax
    checkpoint of the JAX package) and the same tree, evaluate the same
    frames (mode "train": the train_pbr split, as the JAX tool reads it)
    and print the same summary. The port takes the JAX tool's random
    draws: its choose noises and its RANSAC subsets, derived from the JAX
    trainer's keys. Every value agrees within 2e-3 but the rotation
    error, held to 5 degrees: the random network's coordinates give PnP
    no inlier, so its LM refine fits all 32 points of noise, and the
    1e-4 drift of the heads (test_pred_t_gap_traced_to_its_layers) moves
    that fit by up to a few degrees on a frame (3.7 on one of these
    four)."""
    from pose_estimation_tpu.core.solvers import pnp as jpnp
    from pose_estimation_tpu.tools import eval_standalone as jtool
    from pose_estimation_tpu.train.checkpoint import (
        CheckpointManager as JManager)
    from pose_estimation_tpu.train.state import TrainState as JTrainState
    from pose_estimation_tpu.train.trainer import Trainer as JTrainer
    from pose_estimation_tpu_torch.core.solvers import pnp
    from pose_estimation_tpu_torch.data import batching
    from pose_estimation_tpu_torch.tools import eval_standalone
    tmp, log_dir = run
    cfg, jcfg = _cfg(schema), _cfg(jschema)
    model = KRRN(cfg)
    CheckpointManager(f"{log_dir}/ckpt").merge_partial_params(model)
    save_params_npz(str(tmp_path / "p.npz"), model)
    jcfg_file = tmp_path / "jcfg.py"
    jcfg_file.write_text(CONFIG_PY.format(dataset="linemod", hidden=16)
                         .replace("pose_estimation_tpu_torch.",
                                  "pose_estimation_tpu."))
    from pose_estimation_tpu.data.linemod import LinemodDataset as JDataset
    jtr = JTrainer(jcfg.replace(dataset="linemod"),
                   JDataset(tree, cls_type="all", cfg=jcfg),
                   log_dir=str(tmp_path / "jinit"))
    JManager(str(tmp_path / "jckpt")).save(1, JTrainState.create(
        load_params_npz(str(tmp_path / "p.npz")), jtr.tx,
        jax.random.PRNGKey(0)))

    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 2), 0)
    crop = cfg.data.input_size
    calls = {"batch": 0, "solve": 0}
    make_batch = batching.make_batch

    def jax_noises(dataset, idx, generator, crop_size, num_points):
        kb = jax.random.fold_in(jax.random.fold_in(key, 1000),
                                calls["batch"])
        calls["batch"] += 1
        noises = [torch.from_numpy(np.asarray(jax.random.uniform(
            jax.random.fold_in(kb, j), (crop * crop,))))
            for j in range(len(idx))]
        return make_batch(dataset, idx, None, crop_size, num_points,
                          noises=noises)

    def jax_subsets(generator, mask, num, num_subsets):
        keys = jax.random.split(jax.random.fold_in(key, calls["solve"]),
                                mask.shape[0])
        calls["solve"] += 1
        return torch.from_numpy(np.stack([np.asarray(jpnp._minimal_subsets(
            k, mask.shape[1], num, num_subsets, jnp.asarray(m.numpy())))
            for k, m in zip(keys, mask)]).astype(np.int64))

    monkeypatch.setattr(batching, "make_batch", jax_noises)
    monkeypatch.setattr(pnp, "minimal_subsets", jax_subsets)
    args = ["--dataset_root", tree, "--max_batches", "2"]
    jtool.main(["--config", str(jcfg_file), "--ckpt",
                str(tmp_path / "jckpt"), "--log_dir",
                str(tmp_path / "jev")] + args)
    ref = _summary(capsys.readouterr().out)
    got = eval_standalone.main(["--config", _config_file(tmp), "--ckpt",
                                f"{log_dir}/ckpt", "--log_dir",
                                str(tmp_path / "ev"), "--device",
                                "cpu"] + args)
    printed = _summary(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(got))
    assert calls == {"batch": 2, "solve": 2}
    assert printed["overall"]["count"] == ref["overall"]["count"] == 4
    _assert_same_summary(ref, printed, 2e-3, rot_deg_tol=5.0)


def test_eval_standalone_raises_without_a_card(tree, tmp_path, monkeypatch):
    from pose_estimation_tpu_torch.tools import eval_standalone
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_standalone.main(["--config", _config_file(tmp_path),
                              "--dataset_root", tree, "--log_dir",
                              str(tmp_path / "ev")])
    assert not (tmp_path / "ev" / "eval.jsonl").exists()

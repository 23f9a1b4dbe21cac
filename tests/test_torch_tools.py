"""The port's solver-parity, ICP-refine, convergence, solver-sweep and demo
tools against the JAX package's, on the CPU.

- parity_check: make_scenes bit for bit; run_backend's CPU rows against
  the JAX tool's on the same scenes with the JAX tool's draws (its RANSAC
  subsets and Umeyama hypotheses, from PRNGKey(100 + i)) handed over;
- refine_declarative: the JAX tool's choose draws handed over, the ICP's
  inputs (the visible surface, the cloud, the perturbed poses) at 1e-6,
  "before" at 1e-4, and "after" and the residual at 1e-4 given the JAX
  ICP's output. Each with its own ICP, "after" is held at 0.2 mm or
  degree: the expanded squared distance |t|^2 + |s|^2 - 2 t.s cancels at
  the fixture's 0.6-1.1 m, so the packages' correspondences and trims
  part on near-ties and an input rounding apart moves the result (up to
  0.07 on 16 frames);
- train_synthetic_convergence: make_cfg field for field for every
  variant, merge_variants, the output's keys against the JAX tool's
  committed RESULTS_synthetic.json, --eval_from_ckpt reproducing the
  per-object table, --append;
- eval_solver_sweep: the four sweeps' summaries against the JAX tool's on
  the same weights (save_params_npz -> the JAX trainer's state) and draws,
  with the coordinates both solve from posed (_posed_coordinates), at
  tests/test_torch_cli.py::test_eval_standalone_matches_the_jax_tool's
  tolerance (2e-3; the rotation error held at 2e-3 too, not its 5
  degrees);
- train_transparent_convergence: make_cfg field for field, the output's
  keys against RESULTS_transparent.json, --eval_from_ckpt;
- train_synthetic_demo: its config field for field;
- every tool raises without a card unless given --device cpu.

The tools run on the tiny config (make_cfg patched) and on datasets of 4
frames an object.
"""

import contextlib
import dataclasses
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_estimation_tpu.configs import schema as jschema
from pose_estimation_tpu.data import synthetic as jsynthetic
from pose_estimation_tpu.tools import eval_solver_sweep as jsweep
from pose_estimation_tpu.tools import parity_check as jparity
from pose_estimation_tpu.tools import refine_declarative as jrefine
from pose_estimation_tpu.tools import train_synthetic_convergence as jconv
from pose_estimation_tpu.tools import train_transparent_convergence as jtconv
from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.data import batching
from pose_estimation_tpu_torch.data import synthetic
from pose_estimation_tpu_torch.tools import (
    eval_solver_sweep, parity_check, refine_declarative,
    train_synthetic_convergence, train_synthetic_demo,
    train_transparent_convergence)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
FRAMES = 4          # frames an object of every synthetic set


def tiny(mod) -> dict:
    return {"module.num_cls": 4, "data.num_regions": 16,
            "data.num_points": 128, "data.input_size": 64,
            "module.backbone_outc": 16, "module.stem_width": 8,
            "module.hrnet_stages": ((1, 1, (8, 8)), (1, 1, (8, 8, 16)),
                                    (1, 1, (8, 8, 16, 16))),
            "module.xyznet": mod.HeadConfig(hidden=16),
            "module.nmlnet": mod.HeadConfig(hidden=16),
            "module.gcn3d": mod.Gcn3dConfig(neighbor_num=4, support_num=2),
            "train.batch_size": 8, "train.amp": False,
            "eval.num_pnp_points": 32}


def _small(cls):
    class Small(cls):
        def __init__(self, *a, **k):
            k["frames_per_object"] = min(k.get("frames_per_object", 8),
                                         FRAMES)
            super().__init__(*a, **k)
    return Small


@pytest.fixture
def tiny_tools(monkeypatch):
    """Both packages' convergence make_cfg on the tiny config and their
    synthetic sets at FRAMES frames an object."""
    for conv, mod in ((train_synthetic_convergence, schema),
                      (jconv, jschema)):
        orig = conv.make_cfg
        monkeypatch.setattr(conv, "make_cfg", lambda s, *a, _o=orig, **k:
                            s.override(_o(s, *a, **k), **tiny(s)))
    for mod in (synthetic, jsynthetic):
        monkeypatch.setattr(mod, "SyntheticPoseDataset",
                            _small(mod.SyntheticPoseDataset))
        monkeypatch.setattr(mod, "SyntheticTransparentDataset",
                            _small(mod.SyntheticTransparentDataset))


def _same_cfg(got, ref):
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


# ------------------------------------------------------------ parity_check
def test_parity_check_scenes_and_cpu_rows():
    scenes = parity_check.make_scenes(4, 64, 1.0, 0.25)
    ref_scenes = jparity.make_scenes(4, 64, 1.0, 0.25)
    for s, r in zip(scenes, ref_scenes):
        assert s.keys() == r.keys()
        for k in s:
            np.testing.assert_array_equal(s[k], r[k])
    from pose_estimation_tpu.core.solvers import pnp as jpnp
    draws = []
    for i, s in enumerate(scenes):
        key, n = jax.random.PRNGKey(100 + i), len(s["pw"])
        draws.append({
            "subsets": torch.from_numpy(np.array(jpnp._minimal_subsets(
                key, n, 6, 32, jnp.ones(n))).astype(np.int64))[None],
            "hypotheses": torch.from_numpy(np.array(jax.random.randint(
                key, (128, 4), 0, n)).astype(np.int64))})
    rows = parity_check.run_backend(torch.device("cpu"), scenes, draws)
    ref = jparity.run_backend(jax.devices("cpu")[0], ref_scenes,
                              jnp.float32)
    # RANSAC: the same subsets, the LM refine from the same winner; EPnP:
    # the cube scenes' PCA control points nearly tie (test_torch_geometry_
    # rest.py holds the solver at 1e-4 on well-posed scenes); Umeyama: the
    # fp32 pose read through arccos near 0 degrees
    tol = {"ransac_deg": 0.01, "ransac_m": 1e-5, "epnp_deg": 0.05,
           "epnp_m": 5e-4, "umeyama_deg": 0.1, "umeyama_m": 1e-6,
           "rot_roundtrip": 1e-5}
    for got, want in zip(rows, ref):
        assert got.keys() == want.keys() == tol.keys()
        for k, t in tol.items():
            assert abs(got[k] - want[k]) <= t, (k, got[k], want[k])
        assert got["rot_roundtrip"] <= 1e-5
    summary = parity_check.summarize(rows)
    assert summary.keys() == jparity.summarize(ref).keys()


# ------------------------------------------------------ refine_declarative
def _jax_choose_noises(monkeypatch):
    """The port's make_batch with the JAX tool's choose draws:
    uniform(fold_in(PRNGKey(0), j)) for sample j."""
    make = batching.make_batch

    def with_noises(dataset, indices, generator, crop, num_points):
        key = jax.random.PRNGKey(0)
        noises = [torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, j), (crop * crop,))))
            for j in range(len(indices))]
        return make(dataset, indices, None, crop, num_points, noises=noises)

    monkeypatch.setattr(batching, "make_batch", with_noises)


def _spy(calls):
    """An icp_refine that runs calls["fn"] and records its inputs and
    outputs in calls["in"] and calls["out"]."""
    def icp_refine(src, dst, r0, t0, iters=10, trim_fraction=0.0):
        calls["in"] = [np.array(x) for x in (src, dst, r0, t0)]
        out = calls["fn"](src, dst, r0, t0, iters=iters,
                          trim_fraction=trim_fraction)
        calls["out"] = [np.array(x) for x in out]
        return out
    return icp_refine


def _assert_refine(got, ref, tol):
    assert got.keys() == ref.keys() and got["noise"] == ref["noise"]
    for part in ("before", "after"):
        assert got[part].keys() == ref[part].keys()
        for k in ref[part]:
            t = 1e-4 if part == "before" else tol
            assert abs(got[part][k] - ref[part][k]) <= t, (part, k)
    assert abs(got["mean_residual_mm"] - ref["mean_residual_mm"]) <= tol


def test_refine_declarative_matches_the_jax_tool(monkeypatch):
    from pose_estimation_tpu.core.solvers import icp as jicp
    from pose_estimation_tpu_torch.core.solvers import icp
    args = ["--frames", "8"]
    # the JAX tool unrounded, its ICP run eagerly with its inputs and
    # outputs recorded
    jcalls = {"fn": jicp.icp_refine}
    with monkeypatch.context() as m:
        m.setattr(jrefine, "round", lambda x, n=None: x, raising=False)
        m.setattr(jax, "jit", lambda f, **kw: f)
        m.setattr(jicp, "icp_refine", _spy(jcalls))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            jrefine.main(args)
    ref = json.loads(out.getvalue())

    _jax_choose_noises(monkeypatch)
    calls = {"fn": icp.icp_refine}
    monkeypatch.setattr(icp, "icp_refine", _spy(calls))
    got = refine_declarative.main(args + ["--device", "cpu"])
    for x, y in zip(calls["in"], jcalls["in"]):       # src, cloud, r0, t0
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
    _assert_refine(got, ref, 0.2)
    assert got["after"]["trans_mm"] < got["before"]["trans_mm"]

    # given the JAX ICP's poses and residuals, the same report
    calls["fn"] = lambda *a, **k: tuple(torch.from_numpy(x)
                                        for x in jcalls["out"])
    _assert_refine(refine_declarative.main(args + ["--device", "cpu"]),
                   ref, 1e-4)


# ---------------------------------------------- train_synthetic_convergence
@pytest.mark.parametrize("flags", [(False, False, False), (True, False, False),
                                   (False, True, False), (True, True, False),
                                   (False, False, True), (True, False, True)])
def test_convergence_configs_field_for_field(flags):
    region_decode, capacity, flagship = flags
    for epochs in (160, 3):
        _same_cfg(train_synthetic_convergence.make_cfg(
            schema, region_decode, epochs, capacity, flagship),
            jconv.make_cfg(jschema, region_decode, epochs, capacity,
                           flagship))


def test_other_tool_configs_field_for_field(monkeypatch):
    for refine in (False, True):
        _same_cfg(train_transparent_convergence.make_cfg(schema, 7, refine),
                  jtconv.make_cfg(jschema, 7, refine))
    # the JAX demo builds its config inside main(): taken from its Trainer
    import pose_estimation_tpu.train.trainer as jtrainer
    from pose_estimation_tpu.tools import train_synthetic_demo as jdemo

    class Stop(Exception):
        pass

    def grab(cfg, *a, **k):
        raise Stop(cfg)

    monkeypatch.setattr(jtrainer, "Trainer", grab)
    monkeypatch.setattr(jsynthetic, "SyntheticPoseDataset",
                        lambda *a, **k: None)
    with pytest.raises(Stop) as e:
        jdemo.main()
    _same_cfg(train_synthetic_demo.make_cfg(schema), e.value.args[0])


def test_merge_variants_as_the_jax_tool():
    old = [{"variant": "a", "x": 1}, {"variant": "b", "x": 2}]
    new = [{"variant": "b", "x": 3}, {"variant": "c", "x": 4}]
    for existing, produced in ((old, new), ([], new), (old, [])):
        assert (train_synthetic_convergence.merge_variants(existing, produced)
                == jconv.merge_variants(existing, produced))


def test_convergence_tool_runs_resumes_and_appends(tmp_path, tiny_tools):
    out = str(tmp_path / "results.json")
    args = ["--epochs", "1", "--frames_per_object", str(FRAMES),
            "--device", "cpu", "--out", out, "--log_root",
            str(tmp_path / "runs")]
    res = train_synthetic_convergence.main(
        args + ["--variants", "raw_xyz,region_decoded", "--eval_ablation"])
    committed = json.loads((REPO / "RESULTS_synthetic.json").read_text())
    assert res.keys() == committed.keys()
    assert json.loads(Path(out).read_text()) == json.loads(json.dumps(res))
    keys = set(committed["variants"][0])            # with eval_ablation
    raw, region = res["variants"]
    assert [raw["variant"], region["variant"]] == ["raw_xyz",
                                                   "region_decoded"]
    assert set(raw) == set(region) == keys
    assert raw["steps"] == 2 and raw["train_fps"] > 0
    assert set(region["eval_ablation"]) == {"h32_hard_top1", "no_robust",
                                            "top1", "p512", "hard_decode"}
    ckpt = tmp_path / "runs" / "raw_xyz" / "ckpt"
    assert (ckpt / "2" / "state.pt").exists()
    assert (tmp_path / "runs" / "raw_xyz" / "viz" / "epoch_0999.png").exists()

    again = train_synthetic_convergence.main(
        args + ["--variants", "raw_xyz", "--eval_from_ckpt", str(ckpt),
                "--out", str(tmp_path / "again.json"), "--log_root",
                str(tmp_path / "again")])
    (entry,) = again["variants"]
    assert entry["eval_from_ckpt"] == str(ckpt)
    assert entry["train_seconds"] is None and entry["steps"] == 2
    assert entry["per_object"] == raw["per_object"]
    assert entry["overall"] == raw["overall"]

    merged = train_synthetic_convergence.main(
        args + ["--variants", "raw_xyz", "--eval_from_ckpt", str(ckpt),
                "--append", "--log_root", str(tmp_path / "again")])
    assert [v["variant"] for v in merged["variants"]] == [
        "region_decoded", "raw_xyz"]
    assert merged["variants"][1] == entry
    with pytest.raises(SystemExit):
        train_synthetic_convergence.main(args + ["--variants", "nope"])


# -------------------------------------------------------- eval_solver_sweep
def _posed_coordinates(xp, batch):
    """(xyz_emb, pred_t) standing in for the network's, alike in both
    packages (`xp` is jax.numpy or torch): the ground-truth normalised
    coordinates at the chosen pixels, every 4th point 0.3 off (an
    outlier), the rest moved by 0.01 sin(997 x cloud); pred_t the ground
    truth 1 cm off in x."""
    xyz, choose, cloud = batch["xyz"], batch["choose"], batch["cloud"]
    b, s = xyz.shape[0], xyz.shape[1]
    flat = xyz.reshape(b, s * s, 3)
    if xp is torch:
        gt = torch.gather(flat, 1, choose.long()[..., None].expand(-1, -1, 3))
        n = torch.arange(choose.shape[1])
    else:
        gt = jnp.take_along_axis(flat, choose[..., None], 1)
        n = jnp.arange(choose.shape[1])
    noisy = gt + 0.01 * xp.sin(997.0 * cloud)
    xyz_emb = xp.where((n % 4 == 0)[None, :, None], gt + 0.3, noisy)
    return xyz_emb, batch["target_t"] + xp.asarray([0.01, 0.0, 0.0])


def test_eval_solver_sweep_matches_the_jax_tool(tmp_path, tiny_tools,
                                                monkeypatch):
    """Both tools on the same weights (a port checkpoint, which the port's
    tool restores, and its parameters through save_params_npz as the JAX
    trainer's state) and test set, the port given the JAX trainer's draws for
    test_epoch(2000): its choose noises and its RANSAC subsets. The
    network's coordinates and translation are replaced in both by
    _posed_coordinates: on random weights PnP is ill-posed, the LM refine
    starts from EPnP on six random points, and the packages' rotations
    part by up to 56 degrees a frame (mean 9 over 16 frames), so a random
    network would hold nothing. The network itself is held against JAX
    in tests/test_torch_slice.py."""
    from pose_estimation_tpu.core.solvers import pnp as jpnp
    from pose_estimation_tpu.parallel import train_step as jstep
    from pose_estimation_tpu.train.checkpoint import load_params_npz
    from pose_estimation_tpu_torch import serve
    from pose_estimation_tpu.train.state import TrainState as JTrainState
    from pose_estimation_tpu.train.trainer import Trainer as JTrainer
    from pose_estimation_tpu_torch.core.solvers import pnp
    from pose_estimation_tpu_torch.train.checkpoint import save_params_npz
    from pose_estimation_tpu_torch.train.trainer import Trainer

    cfg = train_synthetic_convergence.make_cfg(schema)
    test = synthetic.SyntheticPoseDataset(num_objects=4, frames_per_object=32,
                                          im_h=240, im_w=320,
                                          num_regions=16, pose_seed=7,
                                          sym_objects=(3,))
    tr = Trainer(cfg, test, log_dir=str(tmp_path / "init"), device="cpu")
    tr.init_state()
    tr.ckpt.save(1, tr.state)
    save_params_npz(str(tmp_path / "p.npz"), tr.model)
    params = load_params_npz(str(tmp_path / "p.npz"))

    def jax_state(self, key=None):
        # the JAX trainer's state from those parameters: its eager flax
        # init (38 s here) is skipped, as the network is not run
        self.state = JTrainState.create(params, self.tx,
                                        jax.random.PRNGKey(0))
        return self.state

    monkeypatch.setattr(JTrainer, "init_state", jax_state)
    monkeypatch.setattr(jstep, "_decoded_xyz_and_t",
                        lambda model, cfg, variables, batch:
                        _posed_coordinates(jnp, batch))
    monkeypatch.setattr(serve.InferStep, "forward",
                        lambda self, batch: _posed_coordinates(torch, batch))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jsweep.main(["--ckpt", str(tmp_path / "unused")])
    ref = {line.split("]")[0][len("[sweep "):]:
           json.loads(line.split("] ", 1)[1])
           for line in out.getvalue().splitlines()
           if line.startswith("[sweep ")}

    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 2), 2000)
    n_batches = 2                       # 16 frames at bs 8
    calls = {"batch": 0, "solve": 0}
    crop = cfg.data.input_size
    make = batching.make_batch

    def jax_noises(dataset, idx, generator, crop_size, num_points):
        kb = jax.random.fold_in(jax.random.fold_in(key, 1000),
                                calls["batch"] % n_batches)
        calls["batch"] += 1
        noises = [torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(kb, j), (crop * crop,))))
            for j in range(len(idx))]
        return make(dataset, idx, None, crop_size, num_points, noises=noises)

    def jax_subsets(generator, mask, num, num_subsets):
        keys = jax.random.split(jax.random.fold_in(
            key, calls["solve"] % n_batches), mask.shape[0])
        calls["solve"] += 1
        return torch.from_numpy(np.stack([np.array(jpnp._minimal_subsets(
            k, mask.shape[1], num, num_subsets, jnp.asarray(m.numpy())))
            for k, m in zip(keys, mask)]).astype(np.int64))

    monkeypatch.setattr(batching, "make_batch", jax_noises)
    monkeypatch.setattr(pnp, "minimal_subsets", jax_subsets)
    got = eval_solver_sweep.main(["--ckpt", str(tr.ckpt.directory),
                                  "--log_dir", str(tmp_path / "ev"),
                                  "--device", "cpu",
                                  "--out", str(tmp_path / "sweep.json")])
    assert calls == {"batch": 4 * n_batches, "solve": 4 * n_batches}
    assert list(got) == list(ref) == list(eval_solver_sweep.SWEEPS)
    assert json.loads((tmp_path / "sweep.json").read_text()) == got
    for name, r in ref.items():
        g = got[name]
        assert sorted(g) == sorted(r) and g["count"] == r["count"] == 16
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=2e-3, atol=2e-3,
                                       err_msg=f"{name} {k}")
    assert got["default"]["rot_deg"] < 5.0
    assert got["default"] != got["h32_hard_top1"]


# -------------------------------------------- train_transparent_convergence
def test_transparent_convergence_tool(tmp_path, monkeypatch, tiny_tools):
    orig = train_transparent_convergence.make_cfg
    monkeypatch.setattr(
        train_transparent_convergence, "make_cfg",
        lambda s, *a, **k: s.override(orig(s, *a, **k), **{
            "data.num_points": 32, "data.input_size": 32,
            "train.batch_size": 4, "train.amp": False}))
    args = ["--frames_per_object", str(FRAMES), "--refine", "--device",
            "cpu", "--log_root", str(tmp_path / "runs")]
    res = train_transparent_convergence.main(
        args + ["--epochs", "2", "--out", str(tmp_path / "a.json")])
    committed = json.loads((REPO / "RESULTS_transparent.json").read_text())
    assert set(res) == set(committed) - {"eval_from_ckpt"}
    assert res["steps"] == 8 and res["refine_icp"] is True
    assert "add_dis_icp" in res["overall"]
    ckpt = tmp_path / "runs" / "trpes" / "ckpt"
    again = train_transparent_convergence.main(
        args + ["--eval_from_ckpt", str(ckpt), "--out",
                str(tmp_path / "b.json")])
    assert set(again) == set(committed)
    assert again["overall"] == res["overall"]
    assert again["per_object"] == res["per_object"]
    assert again["train_fps"] is None and again["steps"] == 8


# ------------------------------------------------------------- no card
TOOLS = {
    "parity_check": (parity_check, []),
    "refine_declarative": (refine_declarative, []),
    "train_synthetic_convergence": (train_synthetic_convergence,
                                    ["--variants", "raw_xyz"]),
    "eval_solver_sweep": (eval_solver_sweep, ["--ckpt", "none"]),
    "train_transparent_convergence": (train_transparent_convergence, []),
    "train_synthetic_demo": (train_synthetic_demo, []),
}


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_raises_without_a_card(name, tmp_path, monkeypatch):
    mod, extra = TOOLS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(extra)
    assert list(tmp_path.iterdir()) == []

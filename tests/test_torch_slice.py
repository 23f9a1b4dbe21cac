"""The serving slice end to end: sample preparation, the two-stage serving
step on the tiny config with converted params, the serving CLI, and the
rule that the port imports no JAX.

Tolerances: stage 1 xyz_emb at the model tolerance, 1e-4 * max(1,
max |ref|); pred_t at 2e-3 * max(1, max |ref|): the reference runs the
ConvSurface theta in bf16 even in an fp32 model (pallas_gcn._fwd_xla
casts to bf16 when there is no feature table), so the ~1e-5 difference
that conv summation order leaves in xyz_emb flips some bf16 roundings
and FusionNetLite amplifies them (fed identical inputs, the port's
FusionNetLite holds 1e-4: test_torch_models.test_fusion_net_lite).
Stage 2 at the solver tolerance (rotation <= 0.01 deg, translation
<= 1e-4 m) with the JAX sampler's subsets injected.
"""

import ast
import dataclasses
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_estimation_tpu.configs import schema
from pose_estimation_tpu.data import batching as jbatching
from pose_estimation_tpu.data import pipeline as jpipeline
from pose_estimation_tpu.data.synthetic import SyntheticPoseDataset
from pose_estimation_tpu.models.krrn import KRRN as JKRRN
from pose_estimation_tpu.parallel import train_step as jstep
from pose_estimation_tpu_torch import convert, serve
from pose_estimation_tpu_torch.data import batching, pipeline
from pose_estimation_tpu_torch.models.krrn import KRRN

jpnp = importlib.import_module("pose_estimation_tpu.core.solvers.pnp")

torch.set_num_threads(1)

TINY_STAGES = ((1, 1, (8, 8)), (1, 1, (8, 8, 16)), (1, 1, (8, 8, 16, 16)))
TINY = schema.override(schema.Config(), **{
    "module.num_cls": 2, "data.num_regions": 8, "data.num_points": 128,
    "data.input_size": 64, "module.backbone_outc": 16,
    "module.stem_width": 8, "module.hrnet_stages": TINY_STAGES,
    "module.xyznet": schema.HeadConfig(hidden=16),
    "module.nmlnet": schema.HeadConfig(hidden=16),
    "module.gcn3d": schema.Gcn3dConfig(neighbor_num=4, support_num=2),
    "train.amp": False, "eval.num_pnp_points": 32,
    "eval.pnp_hypotheses": 8, "eval.refine_top_k": 2})
SOLVER = dict(num_pnp_points=32, pnp_hypotheses=8, robust_refine=True,
              refine_top_k=2)
GT_KEYS = ("target", "target_r", "target_t", "model_points", "sym_mask",
           "diameter", "multi_cls_mask", "xyz", "normal", "region", "valid")


@pytest.fixture(scope="module")
def dataset():
    return SyntheticPoseDataset(num_objects=2, frames_per_object=2,
                                im_h=240, im_w=320, num_regions=8)


@pytest.fixture(scope="module")
def jbatch(dataset):
    b = jbatching.make_batch(dataset, [0, 1], jax.random.PRNGKey(0),
                             TINY.data.input_size, TINY.data.num_points)
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def models(jbatch):
    jm = JKRRN(cfg=TINY)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jbatch["img"],
                              jbatch["cloud"], jbatch["choose"],
                              jbatch["cls"])["params"]
    flat = {}

    def walk(t, pre):
        for k, v in t.items():
            key = f"{pre}/{k}" if pre else k
            if hasattr(v, "items"):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(params, "")
    tm = convert.load_flax_params(KRRN(TINY), flat).eval()
    return jm, params, tm


def _tb(jbatch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in jbatch.items()}


def _rot_deg(r1, r2):
    d = np.asarray(r1, np.float64) - np.asarray(r2, np.float64)
    fro = np.sqrt((d * d).sum((-1, -2)))
    return np.degrees(2.0 * np.arcsin(np.minimum(fro / np.sqrt(8.0), 1.0)))


def test_prepare_sample_matches_jax(dataset):
    frame = dataset[1]
    obj = dataset.objects[frame["cls_id"]]
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.uniform(key, (64 * 64,)))
    jframe = {k: jnp.asarray(frame[k]) for k in
              ("rgb", "depth", "mask", "coordinate", "normal", "region", "k")}
    ref = jpipeline.prepare_sample(key, jframe, jnp.asarray(obj.lf_border),
                                   jnp.asarray(obj.extent), crop_size=64,
                                   num_points=128)
    tframe = {k: torch.from_numpy(np.asarray(frame[k])) for k in jframe}
    got = pipeline.prepare_sample(tframe, torch.from_numpy(obj.lf_border),
                                  torch.from_numpy(obj.extent), 64, 128,
                                  noise=torch.from_numpy(noise))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_make_batch_matches_jax(dataset, jbatch):
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), j) for j in range(2)]
    noises = [torch.from_numpy(np.asarray(jax.random.uniform(k, (64 * 64,))))
              for k in keys]
    got = batching.make_batch(dataset, [0, 1], None, 64, 128, noises=noises)
    assert sorted(got) == sorted(jbatch)
    for k in jbatch:
        np.testing.assert_allclose(got[k].numpy(), jbatch[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_serving_stage1_matches_jax(models, jbatch):
    jm, params, tm = models
    ref = jax.jit(lambda p, b: jstep._decoded_xyz_and_t(
        jm, TINY, {"params": p}, b))(params, jbatch)
    xyz_emb, pred_t = serve.build_infer_step(tm, TINY).forward(_tb(jbatch))
    for g, r, rtol in ((xyz_emb, ref[0], 1e-4), (pred_t, ref[1], 2e-3)):
        r = np.asarray(r)
        tol = rtol * max(1.0, float(np.abs(r).max()))
        assert float(np.abs(g.numpy() - r).max()) <= tol


def test_serving_stage2_matches_jax(jbatch):
    """The pose stage fed the same stage-1 output: the ground-truth
    coordinates at `choose` (random weights would hand PnP an ill-posed
    problem whose answer no tolerance pins down)."""
    b, s = jbatch["xyz"].shape[:2]
    xyz = np.take_along_axis(jbatch["xyz"].reshape(b, s * s, 3),
                             jbatch["choose"][..., None].astype(np.int64), 1)
    key = jax.random.PRNGKey(2)
    ref = jax.jit(lambda x, bt: jstep._solve_pnp(
        x, None, bt, key, num_pnp_points=32, pnp_hypotheses=8,
        robust_refine=True, refine_top_k=2))(xyz, jbatch)
    keys = jax.random.split(key, b)
    sub = np.stack([np.asarray(jpnp._minimal_subsets(
        keys[i], 32, 6, 8, jnp.ones(32))) for i in range(b)])
    step = serve.build_infer_step(None, TINY, **SOLVER)
    got = step.solve(torch.from_numpy(xyz), torch.zeros(b, 3), _tb(jbatch),
                     subset_ids=torch.from_numpy(sub).long())
    assert _rot_deg(got["pred_r"].numpy(), ref["r"]).max() <= 0.01
    assert np.abs(got["pnp_t"].numpy() - np.asarray(ref["t"])).max() <= 1e-4
    np.testing.assert_array_equal(got["num_inliers"].numpy(),
                                  np.asarray(ref["num_inliers"]))


def test_infer_step_reads_no_ground_truth(models, jbatch):
    _, _, tm = models
    batch = {k: v for k, v in _tb(jbatch).items() if k not in GT_KEYS}
    out = serve.build_infer_step(tm, TINY)(
        batch, generator=torch.Generator().manual_seed(0))
    assert out["pred_r"].shape == (2, 3, 3)
    for v in out.values():
        assert torch.isfinite(v.float()).all()


def test_eval_step_metrics(models, jbatch):
    _, _, tm = models
    out = serve.build_eval_step(tm, TINY)(
        _tb(jbatch), generator=torch.Generator().manual_seed(0))
    for k in ("add_dis", "rot_deg", "add_ok", "deg_cm_ok"):
        assert out[k].shape == (2,) and torch.isfinite(out[k]).all()


def test_infer_cli_writes_one_record_per_frame(tmp_path):
    from pose_estimation_tpu_torch.tools import infer
    out = tmp_path / "poses.jsonl"
    summary = infer.main(["--synthetic", "--frames_per_object", "2",
                          "--batch_size", "3", "--output", str(out),
                          "--device", "cpu"], cfg=TINY)
    records = [json.loads(x) for x in out.read_text().splitlines()]
    assert summary["frames"] == len(records) == 4
    assert [r["index"] for r in records] == [0, 1, 2, 3]
    assert all(len(r["r"]) == 3 and len(r["t"]) == 3 for r in records)


def test_infer_cli_loads_jax_params(models, tmp_path):
    """--params takes the JAX package's save_params_npz file."""
    from pose_estimation_tpu.train.checkpoint import save_params_npz
    from pose_estimation_tpu_torch.tools import infer
    _, params, _ = models
    path = tmp_path / "params.npz"
    save_params_npz(str(path), jax.tree.map(np.asarray, params))
    out = tmp_path / "poses.jsonl"
    summary = infer.main(["--synthetic", "--frames_per_object", "1",
                          "--batch_size", "2", "--output", str(out),
                          "--device", "cpu", "--params", str(path)],
                         cfg=TINY)
    assert summary["frames"] == 2


def test_port_schema_and_fixture_match_the_jax_package():
    """The port carries its own copies of the config schema and the
    synthetic fixture; they must not drift from the JAX package's."""
    from pose_estimation_tpu.configs import schema as jschema
    from pose_estimation_tpu_torch.configs import schema as tschema
    from pose_estimation_tpu_torch.data import synthetic as tsyn
    for name in ("lm_v3_1", "lm_ape_cpu", "transparent_cleargrasp"):
        assert (dataclasses.asdict(getattr(tschema, name)())
                == dataclasses.asdict(getattr(jschema, name)()))
    kw = dict(num_objects=2, frames_per_object=1, im_h=120, im_w=160,
              num_regions=8, sym_objects=(1,))
    ref, got = SyntheticPoseDataset(**kw), tsyn.SyntheticPoseDataset(**kw)
    for a, b in zip(ref.objects, got.objects):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(b, f.name),
                                          getattr(a, f.name))
    for i in range(len(ref)):
        fa, fb = ref[i], got[i]
        assert sorted(fa) == sorted(fb)
        for k in fa:
            np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports JAX, flax, optax or the
    JAX package."""
    repo = Path(__file__).resolve().parents[1]
    root = repo / "pose_estimation_tpu_torch"
    banned = {"jax", "flax", "optax", "pose_estimation_tpu"}
    files = sorted(root.rglob("*.py")) + [repo / "chip_smoke.py"]
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in banned:
                    offenders.append(f"{path.name}: {n}")
    assert not offenders, offenders
    assert len(files) > 20

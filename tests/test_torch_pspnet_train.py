"""The PSPNet generation's train and eval steps, the trainer's model
families and the CLI against the JAX package on the CPU (fp32,
TransparentPoseNet(num_obj=3, num_points=32) on 48-px crops, the JAX
tests' size), on the same numpy batch and converted parameters:

  one train step against build_transparent_train_step with the JAX step's
      draws replaced by the test's while it is traced (its randint gives
      the pixels [B, n], with repeats; its bernoulli the seven dropout
      masks in flax's trace order): the loss terms at 1e-5 relative
      (measured ~4e-7), loss_b among them and positive, the gradient's
      global norm at 1e-4 relative against jax.grad of the same loss, the
      parameters after the Ranger update (gradient centralisation on every
      new leaf) at 1e-5 x max(1, max|ref|) (measured ~5e-10);
  a step on a batch with a NaN target: skipped in both, the parameters
      after the update at 1e-5;
  the eval step with and without ICP (icp_iters=3, icp_points=64) against
      the JAX eval step with ICP, whose add_dis is the one without:
      add_dis and add_dis_icp at 1e-5, the accept flags equal;
  a 2-rank gloo group (tests/torch_transparent_worker.py) at bs 2 a rank
      against the JAX step at the global batch of 4 (the test's draws,
      each rank its rows): the loss terms at 1e-5 relative, the parameters
      at 1e-5; and, with the generator's own draws (seeded alike on both
      ranks), against the port's one process at bs 4: the loss terms and
      gradient norm at 1e-5 relative, the parameters at 1e-5, the
      generator states equal, which holds the global-shape draws;
  build_model's families (an unknown one and a crop under the PSP
      pyramid raise ValueError); the train step's own draws (shapes, the
      pixels' range); cli.py --device cpu with transparent_model="posenet"
      on the ClearGrasp fixture (one step, one eval), then
      tools/eval_transparent.py --ckpt from its checkpoint.
"""

import importlib
import json
import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from flax.traverse_util import flatten_dict

import torch_transparent_worker as W
from pose_estimation_tpu.configs import schema as jschema
from pose_estimation_tpu.models.pspnet import TransparentPoseNet as JPoseNet
from pose_estimation_tpu.train import optim as joptim
from pose_estimation_tpu.train import transparent_trainer as jtt
from pose_estimation_tpu.train.state import TrainState as JTrainState
from pose_estimation_tpu_torch import cli, convert
from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.models.pspnet import (
    TransparentPoseNet, dropout_shapes)
from pose_estimation_tpu_torch.train import transparent_trainer as tt

jloss = importlib.import_module("pose_estimation_tpu.losses.transparent_loss")

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 600
POSENET = {"module.transparent_model": "posenet",
           "data.input_size": W.PSP_CROP}
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cleargrasp")


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _hold_params(got: dict, ref: dict, tol: float):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert _rel_err(got[k], ref[k]) <= tol, (k, _rel_err(got[k], ref[k]))


def _nest(flat: dict) -> dict:
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _flat_params(state) -> dict:
    return {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(state.params).items()}


def _nan_batch() -> dict:
    batch = W.posenet_batch()
    batch["target"][1, 2, 0] = np.nan
    return batch


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX step (one compile, the test's draws traced in), its results
    on the batch and on the NaN batch, and jax.grad's norm on the batch."""
    flat = convert.torch_to_flax(dict(
        W.posenet_setup()[0].model.named_parameters()))
    choose, masks = W.posenet_draws()
    jcfg = W.config(jschema, **POSENET)
    weights = tt.loss_weights(W.config(schema, **POSENET))
    model = JPoseNet(num_obj=W.NUM_OBJ, num_points=W.NUM_POINTS)
    tx = joptim.make_optimizer(jcfg, total_steps=W.TOTAL_STEPS)
    queue = []

    def bernoulli(key, p=0.5, shape=None):
        m = queue.pop(0)
        assert m.shape == tuple(shape)
        return jnp.asarray(m)

    out = {}
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(jax.random, "randint",
                       lambda *a, **k: jnp.asarray(choose))
        mpatch.setattr(jax.random, "bernoulli", bernoulli)
        step = jtt.build_transparent_train_step(model, tx, weights)
        for name, batch in (("step", W.posenet_batch()),
                            ("nan", _nan_batch())):
            queue[:] = [np.transpose(m, (0, 2, 3, 1)) for m in masks]
            state = JTrainState.create(_nest(flat), tx, jax.random.PRNGKey(0))
            new, metrics = step(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
            out[name] = (_flat_params(new), {k: float(v) for k, v in
                                             metrics.items()})

        queue[:] = [np.transpose(m, (0, 2, 3, 1)) for m in masks]
        jb = {k: jnp.asarray(v) for k, v in W.posenet_batch().items()}

        @jax.jit
        def grad_norm(params):
            def loss(p):
                pred = jtt.apply_transparent_model(
                    model, p, jb, rng=jax.random.PRNGKey(0), train=True)
                return jloss.transparent_loss(pred, jb, weights)["all_loss"]
            g = jax.grad(loss)(params)
            return jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree.leaves(g)))

        out["grad_norm"] = float(grad_norm(_nest(flat)))
    return out


def _port_step(batch):
    state, step = W.posenet_setup()
    choose, masks = W.posenet_draws()
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    losses = step.losses(tb, torch.from_numpy(choose),
                         [torch.from_numpy(m) for m in masks])
    metrics = step.apply(state, losses, step.gradients(losses))
    return state, {k: float(v) for k, v in metrics.items()}


def test_posenet_train_step_matches_jax(jax_ref):
    ref_params, ref = jax_ref["step"]
    state, got = _port_step(W.posenet_batch())
    assert got["skipped_nonfinite"] == ref["skipped_nonfinite"] == 0.0
    assert sorted(ref) == sorted(k for k in got if k != "grad_norm")
    assert got["loss_b"] > 0.0
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(got["grad_norm"], jax_ref["grad_norm"],
                               rtol=1e-4)
    _hold_params(convert.torch_to_flax(dict(state.model.named_parameters())),
                 ref_params, 1e-5)
    assert state.step == 1


def test_posenet_nan_step_is_skipped_in_both(jax_ref):
    ref_params, ref = jax_ref["nan"]
    state, got = _port_step(_nan_batch())
    assert got["skipped_nonfinite"] == ref["skipped_nonfinite"] == 1.0
    assert not math.isfinite(got["all_loss"])
    _hold_params(convert.torch_to_flax(dict(state.model.named_parameters())),
                 ref_params, 1e-5)


def test_posenet_eval_step_matches_jax():
    state, _ = W.posenet_setup()
    flat = convert.torch_to_flax(dict(state.model.named_parameters()))
    batch = W.posenet_batch(seed=4)
    jstate = JTrainState.create(_nest(flat), joptim.make_optimizer(
        W.config(jschema, **POSENET), total_steps=W.TOTAL_STEPS),
        jax.random.PRNGKey(0))
    ref = jtt.build_transparent_eval_step(
        JPoseNet(num_obj=W.NUM_OBJ, num_points=W.NUM_POINTS),
        refine_icp=True, icp_iters=3, icp_points=64)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    plain = tt.build_transparent_eval_step(state.model)(tb)
    got = tt.build_transparent_eval_step(state.model, refine_icp=True,
                                         icp_iters=3, icp_points=64)(tb)
    assert sorted(got) == sorted(ref)
    assert "add_dis_icp" not in plain
    for out in (plain, got):
        for k in ("add_dis", "trans_m"):
            np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    for k in ("add_dis_icp", "trans_m_icp", "icp_residual"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got["icp_accepted"].numpy(),
                                  np.asarray(ref["icp_accepted"]))


# --- a 2-rank group -----------------------------------------------------------

@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_posenet")
    payload = {"batch": W.posenet_batch(), "out_dir": str(tmp)}
    tasks = list(W.POSENET_TASKS)
    ctx = mp.start_processes(W.run, args=(2, str(tmp / "store"), tasks,
                                          payload),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"2 ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return {t: [torch.load(tmp / f"{t}_{r}.pt", weights_only=False)
                for r in range(2)] for t in tasks}


def _same_on_both_ranks(results):
    a, b = results
    assert a["metrics"] == b["metrics"]
    for k, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][k], v, err_msg=k)
    return a


def test_posenet_two_ranks_match_jax_at_the_global_batch(two, jax_ref):
    got = _same_on_both_ranks(two["posenet_injected"])
    ref_params, ref = jax_ref["step"]
    for k, v in ref.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _hold_params(got["params"], ref_params, 1e-5)


def test_posenet_two_ranks_draw_as_one_process(two):
    want = W.step_posenet_seeded(W.posenet_batch())
    got = _same_on_both_ranks(two["posenet_seeded"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _hold_params(got["params"], want["params"], 1e-5)
    assert torch.equal(got["generator"], want["generator"])


# --- the trainer's families and the entry points --------------------------------

def test_build_model_dispatches_on_the_family():
    cfg = W.config(schema, **POSENET)
    assert isinstance(tt.build_model(cfg), TransparentPoseNet)
    assert isinstance(tt.build_model(W.config(schema)), tt.TRPESNet)
    with pytest.raises(ValueError, match="not one of"):
        tt.build_model(W.config(schema, **{
            "module.transparent_model": "unet2"}))
    with pytest.raises(ValueError, match="48 px"):
        tt.build_model(W.config(schema, **{
            "module.transparent_model": "posenet"}))


def test_posenet_train_step_draws():
    """The step's own draws: the pixels [B, n] in [0, H*W), drawn per
    sample with replacement, then the seven masks of dropout_shapes, kept
    at about 1 - rate."""
    state, step = W.posenet_setup(gen_seed=3)
    tb = {k: torch.from_numpy(v) for k, v in W.posenet_batch().items()}
    choose, masks = step.draws(state.generator, tb)
    hw = W.PSP_CROP ** 2
    assert choose.shape == (W.GLOBAL_BS, W.NUM_POINTS)
    assert 0 <= int(choose.min()) and int(choose.max()) < hw
    assert [tuple(m.shape) for m in masks] == dropout_shapes(
        W.GLOBAL_BS, W.PSP_CROP, W.PSP_CROP)
    assert abs(masks[0].float().mean().item() - 0.7) < 0.01
    assert abs(masks[1].float().mean().item() - 0.85) < 0.01
    metrics = step(state, tb)
    assert metrics["skipped_nonfinite"].item() == 0.0 and state.step == 1


def _posenet_config(tmp_path) -> str:
    path = tmp_path / "posenet_cfg.py"
    path.write_text(
        "from pose_estimation_tpu_torch.configs import schema\n\n\n"
        "def get_config():\n"
        "    return schema.override(schema.transparent_cleargrasp(), **{\n"
        "        'module.num_cls': 3, 'data.num_points': 32,\n"
        "        'data.input_size': 48, 'train.batch_size': 2,\n"
        "        'train.amp': False, 'train.ckpt_every': 0,\n"
        "        'train.lr.warmup_iters': 0, 'train.refine': True,\n"
        "        'module.transparent_model': 'posenet'})\n")
    return str(path)


def test_cli_trains_and_evaluates_the_posenet_generation(tmp_path, capsys):
    from pose_estimation_tpu_torch.tools import eval_transparent
    config = _posenet_config(tmp_path)
    log_dir = tmp_path / "cg"
    assert cli.main(["--config", config, "--dataset", "cleargrasp",
                     "--dataset_root", GOLDEN, "--debug", "--epochs", "1",
                     "--log_dir", str(log_dir), "--device", "cpu"]) == 0
    train = [json.loads(x) for x in open(log_dir / "train.jsonl")]
    evals = [json.loads(x) for x in open(log_dir / "eval.jsonl")]
    assert len(train) == 1 and np.isfinite(train[0]["all_loss"])
    assert train[0]["loss_b"] > 0.0 and train[0]["skipped_nonfinite"] == 0.0
    assert evals[-1]["count"] == 2 and np.isfinite(evals[-1]["add_dis_icp"])
    capsys.readouterr()
    summary = eval_transparent.main([
        "--config", config, "--ckpt", str(log_dir / "ckpt"), "--synthetic",
        "--max_batches", "1", "--log_dir", str(tmp_path / "tool"),
        "--device", "cpu"])
    assert "restore failed" not in capsys.readouterr().out
    assert summary["overall"]["count"] == 2

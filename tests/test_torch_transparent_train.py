"""The transparent pipeline's train step, ICP and eval step against the JAX
package on the CPU (fp32, TRPESNet(num_points=32, num_obj=3) on 32-px
crops, the JAX tests' size), on the same numpy batch and converted
parameters:

  one train step against build_transparent_train_step with the JAX
      step's training pixels replaced by the test's while it is traced:
      loss terms at 1e-5 relative (measured 5.8e-7), the gradient's
      global norm at 1e-4 relative against jax.grad of the same loss
      (measured 3.6e-6), the parameters after the Ranger update at 1e-5 x
      max(1, max|ref|) (measured 1.9e-9);
  a step on a batch with a NaN target: skipped in both packages, the
      parameters after the update (the moments move, the gradients are
      zeroed) at 1e-5;
  icp_refine / gated_icp_refine / trimmed_residual on a partial view of
      the model at a pose off the initial one, accepted and rejected:
      the residuals at 1e-5, the accept flags equal, the rotations
      within 0.01 degree of the JAX ones (the SVD's signs may part the
      entries, not the rotation), the translations within 1e-5 m. The
      scene sits 5 cm from the origin: the distances are JAX's
      pairwise_sqdist, |t|^2 + |s|^2 - 2 t.s, and at 0.7 m an fp32 ulp
      of the 0.5 m^2 terms is ~1e-3 of a 7 mm distance's square, so the
      two packages' different summation orders of t.s part the trimmed
      residual by 5e-5 there and the trim's threshold keeps different
      points (0.08 degree apart after 5 iterations);
  the eval step with refine_icp (icp_iters=3, icp_points=64): add_dis and
      add_dis_icp at 1e-5, icp_accepted equal, the ICP rotations within
      0.01 degree;
  a 2-rank gloo group (tests/torch_transparent_worker.py) at bs 2 a rank
      against the JAX step at the global batch of 4 (the test's pixels;
      the ranks' valid-normal counts differ): loss terms at 1e-5 relative,
      parameters at 1e-5; and against the port's one process at bs 4 from
      the same generator seed, two steps of the generator's own draws:
      loss terms and gradient norm at 1e-5 relative, parameters at 1e-5,
      the generator states equal (one permutation, drawn alike on every
      rank).
"""

import importlib
import math
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
from pose_estimation_tpu.core.geometry import rotations as jrot
from pose_estimation_tpu.core.solvers import icp as jicp
from pose_estimation_tpu.models.transparent import TRPESNet as JTRPESNet
from pose_estimation_tpu.train import optim as joptim
from pose_estimation_tpu.train import transparent_trainer as jtt
from pose_estimation_tpu.train.state import TrainState as JTrainState
from pose_estimation_tpu_torch import convert
from pose_estimation_tpu_torch.core.solvers import icp
from pose_estimation_tpu_torch.train import transparent_trainer as tt

jloss = importlib.import_module("pose_estimation_tpu.losses.transparent_loss")

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 600


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _hold_params(got: dict, ref: dict, tol: float):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert _rel_err(got[k], ref[k]) <= tol, (k, _rel_err(got[k], ref[k]))


def _geodesic_deg(a, b) -> np.ndarray:
    """Angle between rotations in fp64 from atan2 of the relative
    rotation's skew and trace parts: accurate near 0, where acos of the
    trace is not (fp32 matrices orthonormal to 1e-7 alone give acos 0.07
    degree; angular_distance's clamp margin 0.026)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rel = np.swapaxes(a, -1, -2) @ b
    skew = np.stack([rel[..., 2, 1] - rel[..., 1, 2],
                     rel[..., 0, 2] - rel[..., 2, 0],
                     rel[..., 1, 0] - rel[..., 0, 1]], -1)
    tr = np.trace(rel, axis1=-2, axis2=-1)
    return np.degrees(np.arctan2(np.linalg.norm(skew, axis=-1) / 2.0,
                                 (tr - 1.0) / 2.0))


@pytest.fixture(scope="module")
def setup():
    """The port's seeded tiny model (weights seeded 1) as the JAX
    package's flax params, and both configs."""
    from pose_estimation_tpu_torch.configs import schema
    state, _ = W.port_setup()
    flat = convert.torch_to_flax(dict(state.model.named_parameters()))
    return flat, W.config(schema), W.config(jschema)


def _nest(flat: dict) -> dict:
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _jax_step(setup, batch, monkeypatch):
    """The JAX train step at `batch` with the test's pixels: (new state,
    metrics)."""
    flat, cfg, jcfg = setup
    perm = W.choose_perm()
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, x, *a, **k: jnp.asarray(perm))
    tx = joptim.make_optimizer(jcfg, total_steps=W.TOTAL_STEPS)
    state = JTrainState.create(_nest(flat), tx, jax.random.PRNGKey(0))
    model = JTRPESNet(num_points=W.NUM_POINTS, num_obj=W.NUM_OBJ)
    step = jtt.build_transparent_train_step(model, tx, tt.loss_weights(cfg))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return new, {k: float(v) for k, v in metrics.items()}


def _jax_grad_norm(setup, batch, monkeypatch) -> float:
    flat, cfg, _ = setup
    perm = W.choose_perm()
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, x, *a, **k: jnp.asarray(perm))
    model = JTRPESNet(num_points=W.NUM_POINTS, num_obj=W.NUM_OBJ)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        pred = jtt.apply_transparent_model(model, params, jb,
                                           rng=jax.random.PRNGKey(0),
                                           train=True)
        return jloss.transparent_loss(pred, jb,
                                      tt.loss_weights(cfg))["all_loss"]

    grads = jax.grad(loss)(_nest(flat))
    return float(jnp.sqrt(sum(jnp.sum(g * g)
                              for g in jax.tree.leaves(grads))))


def _port_step(batch):
    state, step = W.port_setup()
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    losses = step.losses(tb, torch.from_numpy(W.choose_perm()[:W.NUM_POINTS]))
    metrics = step.apply(state, losses, step.gradients(losses))
    return state, {k: float(v) for k, v in metrics.items()}


def test_train_step_matches_jax(setup, monkeypatch):
    batch = W.tiny_batch()
    ref_state, ref = _jax_step(setup, batch, monkeypatch)
    state, got = _port_step(batch)
    assert got["skipped_nonfinite"] == ref["skipped_nonfinite"] == 0.0
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    ref_norm = _jax_grad_norm(setup, batch, monkeypatch)
    np.testing.assert_allclose(got["grad_norm"], ref_norm, rtol=1e-4)
    _hold_params(convert.torch_to_flax(dict(state.model.named_parameters())),
                 {"/".join(k): v for k, v in
                  flatten_dict(ref_state.params).items()}, 1e-5)
    assert state.step == int(ref_state.step) == 1


def test_nan_step_is_skipped_in_both(setup, monkeypatch):
    batch = W.tiny_batch()
    batch["target"][1, 2, 0] = np.nan
    ref_state, ref = _jax_step(setup, batch, monkeypatch)
    state, got = _port_step(batch)
    assert got["skipped_nonfinite"] == ref["skipped_nonfinite"] == 1.0
    assert not math.isfinite(got["all_loss"])
    _hold_params(convert.torch_to_flax(dict(state.model.named_parameters())),
                 {"/".join(k): v for k, v in
                  flatten_dict(ref_state.params).items()}, 1e-5)


# --- ICP --------------------------------------------------------------------

def _icp_case(seed, b=3, n=200, m=64):
    """Model points, the visible half of them posed at (r_true, t_true)
    with noise as the observed cloud, and initial poses 3 degrees and
    5 mm off (sample 0, 1) or 40 degrees off (sample 2: outside the trust
    region). The scene sits 5 cm from the origin: at 0.7 m the
    expanded-form distance's cancellation (module docstring) reorders
    near-equal correspondences at the trim's threshold, in either
    package, and the two then keep different points."""
    rng = np.random.RandomState(seed)
    src = (rng.randn(b, n, 3) * np.array([0.04, 0.03, 0.02])).astype(
        np.float32)
    q = rng.randn(b, 4)
    r_true = np.asarray(jrot.quat_to_matrix(jnp.asarray(q, jnp.float32)))
    t_true = np.array([0.0, 0.0, 0.05]) + rng.randn(b, 3) * 0.02
    posed = src @ r_true.transpose(0, 2, 1) + t_true[:, None]
    dst = np.stack([p[np.argsort(p[:, 2])[:m]] for p in posed])
    dst = (dst + rng.randn(*dst.shape) * 5e-4).astype(np.float32)
    angles = np.array([3.0, 3.0, 40.0])
    axis = rng.randn(b, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    off = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(
        axis * np.radians(angles)[:, None], jnp.float32)))
    r0 = (off @ r_true).astype(np.float32)
    t0 = (t_true + np.array([0.005, -0.003, 0.004])).astype(np.float32)
    return src, dst, r0, t0


@pytest.mark.parametrize("trim", [0.0, 0.3])
def test_icp_matches_jax(trim):
    src, dst, r0, t0 = _icp_case(0)
    j = [jnp.asarray(x) for x in (src, dst, r0, t0)]
    t = [torch.from_numpy(x) for x in (src, dst, r0, t0)]
    rr, tr_, res = jicp.icp_refine(*j, iters=5, trim_fraction=trim)
    gr, gt, gres = icp.icp_refine(*t, iters=5, trim_fraction=trim)
    assert _geodesic_deg(gr.numpy(), rr).max() <= 0.01
    np.testing.assert_allclose(gt.numpy(), tr_, atol=1e-5)
    np.testing.assert_allclose(gres.numpy(), res, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(
        icp.trimmed_residual(*t, trim_fraction=trim).numpy(),
        jicp.trimmed_residual(*j, trim_fraction=trim), rtol=1e-5)

    rr, tr_, acc, res = jicp.gated_icp_refine(*j, iters=10,
                                              trim_fraction=trim)
    gr, gt, gacc, gres = icp.gated_icp_refine(*t, iters=10,
                                              trim_fraction=trim)
    np.testing.assert_array_equal(gacc.numpy(), np.asarray(acc))
    assert list(np.asarray(acc)) == [True, True, False]
    assert _geodesic_deg(gr.numpy(), rr).max() <= 0.01
    np.testing.assert_allclose(gt.numpy(), tr_, atol=1e-5)
    np.testing.assert_allclose(gres.numpy(), res, rtol=1e-5, atol=1e-8)


def test_eval_step_with_icp_matches_jax(setup):
    flat, _, _ = setup
    batch = W.tiny_batch(seed=4)
    model = JTRPESNet(num_points=W.NUM_POINTS, num_obj=W.NUM_OBJ)
    state = JTrainState.create(_nest(flat), joptim.make_optimizer(
        setup[2], total_steps=W.TOTAL_STEPS), jax.random.PRNGKey(0))
    ref = jtt.build_transparent_eval_step(model, refine_icp=True,
                                          icp_iters=3, icp_points=64)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, _ = W.port_setup()
    got = tt.build_transparent_eval_step(
        tstate.model, refine_icp=True, icp_iters=3, icp_points=64)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(ref)
    for k in ("add_dis", "add_dis_icp", "trans_m", "trans_m_icp",
              "icp_residual"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(got["icp_accepted"].numpy(),
                                  np.asarray(ref["icp_accepted"]))
    for k in ("pred_r", "pred_r_icp"):
        assert _geodesic_deg(got[k].numpy(), ref[k]).max() <= 0.01, k
    for k in ("pred_normal", "pred_depth", "pred_mask"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], atol=1e-4,
                                   err_msg=k)


# --- a 2-rank group -----------------------------------------------------------

@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two")
    payload = {"batch": W.tiny_batch(), "out_dir": str(tmp)}
    tasks = list(W.TASKS)
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


def test_halves_have_different_normal_counts():
    valid = (W.tiny_batch()["normal"] != 0).any(-1)
    counts = valid.reshape(2, -1).sum(1)
    assert counts[0] != counts[1], counts


def test_two_ranks_match_jax_at_the_global_batch(two, setup, monkeypatch):
    got = _same_on_both_ranks(two["injected"])
    ref_state, ref = _jax_step(setup, W.tiny_batch(), monkeypatch)
    for k, v in ref.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _hold_params(got["params"], {"/".join(k): v for k, v in
                                 flatten_dict(ref_state.params).items()},
                 1e-5)


def test_two_ranks_match_one_process(two):
    ref = W.step_seeded(W.tiny_batch())["steps"]
    got = two["seeded"]
    for i, want in enumerate(ref):
        g = _same_on_both_ranks([r["steps"][i] for r in got])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(g["metrics"][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=(i, k))
        _hold_params(g["params"], want["params"], 1e-5)
        assert torch.equal(g["generator"], want["generator"])
        assert g["step"] == want["step"] == i + 1

"""The transparent pipeline's geometry, models and loss against the JAX
package on the CPU (fp32), on the same numpy inputs and converted
parameters:

  quat_to_matrix, allo_to_ego_matrix / ego_to_allo_matrix and the ray
      quaternion: 1e-6 (measured 6e-8; quat_to_matrix bit for bit);
  the UNet's three maps and TRPESNet's eval forward (all six outputs,
      the per-object heads of every object): 1e-4 x max(1, max|ref|)
      (measured 6.1e-6: fp32 convolution orders);
  TRPESNet's flax tree both ways: a strict flax_to_torch of a freshly
      initialised JAX model and torch_to_flax back, key for key and bit
      for bit (the options the shipped config leaves off:
      test_torch_transparent_options.py);
  transparent_loss: every term at 1e-5 relative (measured 1.0e-6) on
      symmetric and non-symmetric samples, with a hypothesis that puts a
      model point exactly on its target (zero direct and chamfer
      distance): the gradient stays finite; focal_loss and smooth_l1 at
      1e-6; a NaN in an unselected object's head channels reaches the
      output (the one-hot contraction), as JAX's einsum lets it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import torch_transparent_worker as W
from pose_estimation_tpu.core.geometry import allocentric as jallo
from pose_estimation_tpu.core.geometry import rotations as jrot
from pose_estimation_tpu.models.transparent import TRPESNet as JTRPESNet
from pose_estimation_tpu.models.unet import UNet as JUNet
from pose_estimation_tpu_torch import convert
from pose_estimation_tpu_torch.core.geometry import allocentric
from pose_estimation_tpu_torch.core.geometry.rotations import quat_to_matrix
from pose_estimation_tpu_torch.losses import transparent_loss as tloss
from pose_estimation_tpu_torch.models.transparent import TRPESNet

jloss = importlib.import_module("pose_estimation_tpu.losses.transparent_loss")

torch.set_num_threads(1)

INPUTS = ("img", "intrinsic", "xmap", "ymap", "d_scale", "obj")


def _flat(params) -> dict:
    return {"/".join(k): np.asarray(v) for k, v in
            flatten_dict(params).items()}


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, tol)
    return err


# --- geometry ---------------------------------------------------------------

def test_quat_to_matrix_matches_jax():
    q = np.random.RandomState(0).randn(64, 4).astype(np.float32)
    q[0] = 0.0                                   # the clamped normalisation
    q[1, 0] = -1.0                               # the sign flip
    ref = np.asarray(jrot.quat_to_matrix(jnp.asarray(q)))
    got = quat_to_matrix(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_allocentric_matches_jax():
    rng = np.random.RandomState(1)
    t = (rng.randn(64, 3) * 0.1 + [0.0, 0.0, 0.8]).astype(np.float32)
    t[0] = [0.0, 0.0, 0.9]                       # on the optical axis
    q = rng.randn(64, 4).astype(np.float32)
    r = np.array(jrot.quat_to_matrix(jnp.asarray(q)))
    np.testing.assert_allclose(
        allocentric._ray_quat(torch.from_numpy(t)).numpy(),
        np.asarray(jallo._ray_quat(jnp.asarray(t))), atol=1e-6)
    for fn, jfn in ((allocentric.allo_to_ego_matrix, jallo.allo_to_ego_matrix),
                    (allocentric.ego_to_allo_matrix,
                     jallo.ego_to_allo_matrix)):
        got = fn(torch.from_numpy(t), torch.from_numpy(r)).numpy()
        ref = np.asarray(jfn(jnp.asarray(t), jnp.asarray(r)))
        np.testing.assert_allclose(got, ref, atol=1e-6)
    back = allocentric.ego_to_allo_matrix(
        torch.from_numpy(t),
        allocentric.allo_to_ego_matrix(torch.from_numpy(t),
                                       torch.from_numpy(r)))
    np.testing.assert_allclose(back.numpy(), r, atol=1e-5)


# --- models -----------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The JAX TRPESNet initialised from PRNGKey(0), the port's loaded with
    its parameters (strict), and the batch."""
    batch = W.tiny_batch()
    jm = JTRPESNet(num_points=W.NUM_POINTS, num_obj=W.NUM_OBJ)
    variables = jm.init({"params": jax.random.PRNGKey(0)},
                        *[jnp.asarray(batch[k]) for k in INPUTS])
    flat = _flat(variables["params"])
    tm = convert.load_flax_params(TRPESNet(W.NUM_POINTS, W.NUM_OBJ), flat)
    return jm, variables, tm, flat, batch


def test_trpesnet_flax_tree_both_ways(models):
    _, _, tm, flat, _ = models
    assert any(k.startswith("UNet_0/Up_9/DoubleConv_0/") for k in flat)
    assert "DenseFusion_0/Dense_8/kernel" in flat
    assert "PosePredHead_0/Dense_11/kernel" in flat
    sd = convert.flax_to_torch(flat, TRPESNet(W.NUM_POINTS, W.NUM_OBJ))
    assert sorted(sd) == sorted(tm.state_dict())
    back = convert.torch_to_flax(tm.state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError, match="missing"):
        convert.flax_to_torch({k: v for k, v in flat.items()
                               if not k.startswith("GeometryNet_0/")},
                              TRPESNet(W.NUM_POINTS, W.NUM_OBJ))


def test_unet_matches_jax(models):
    _, variables, tm, _, batch = models
    img = batch["img"]
    ref = JUNet().apply({"params": variables["params"]["UNet_0"]},
                        jnp.asarray(img))
    with torch.no_grad():
        got = tm.UNet_0(torch.from_numpy(img).permute(0, 3, 1, 2))
    for g, r in zip(got, ref):
        _close(g.permute(0, 2, 3, 1).numpy(), r, 1e-4)
    norms = torch.linalg.norm(got[1], dim=1)
    assert torch.allclose(norms[norms > 1e-3], torch.ones(()), atol=1e-5)


@pytest.mark.parametrize("obj", [0, 1, 2])
def test_trpesnet_eval_forward_matches_jax(models, obj):
    jm, variables, tm, _, batch = models
    batch = dict(batch, obj=np.full(W.GLOBAL_BS, obj, np.int32))
    ref = jm.apply(variables, *[jnp.asarray(batch[k]) for k in INPUTS])
    with torch.no_grad():
        got = tm(*[torch.from_numpy(batch[k]) for k in INPUTS])
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        _close(g.numpy(), r, 1e-4)


def test_trpesnet_training_choose_matches_jax(models, monkeypatch):
    """The training pixels handed to both: the JAX model's permutation is
    replaced while it runs."""
    jm, variables, tm, _, batch = models
    perm = W.choose_perm()
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, x, *a, **k: jnp.asarray(perm))
    ref = jm.apply(variables, *[jnp.asarray(batch[k]) for k in INPUTS],
                   train=True, rngs={"choose": jax.random.PRNGKey(1)})
    with torch.no_grad():
        got = tm(*[torch.from_numpy(batch[k]) for k in INPUTS],
                 choose=torch.from_numpy(perm[:W.NUM_POINTS]))
    for g, r in zip(got[:3], ref[:3]):
        _close(g.numpy(), r, 1e-4)


def test_head_select_keeps_a_nan_of_another_object(models):
    """A NaN in object 2's output channels reaches every sample's output,
    as the JAX einsum carries it (and the step's guard then skips)."""
    _, _, tm, _, batch = models
    head = tm.PosePredHead_0.Dense_3
    saved = head.bias.detach().clone()
    try:
        with torch.no_grad():
            head.bias[2 * 4] = float("nan")      # object 2, quaternion w
            out = tm(*[torch.from_numpy(dict(
                batch, obj=np.zeros(W.GLOBAL_BS, np.int32))[k])
                for k in INPUTS])
        assert torch.isnan(out[0][..., 0]).all()
        assert torch.isfinite(out[1]).all()
    finally:
        with torch.no_grad():
            head.bias.copy_(saved)


# --- the loss ---------------------------------------------------------------

def _pred(seed=0, b=W.GLOBAL_BS, n=8, h=W.CROP):
    rng = np.random.RandomState(seed)
    trans = (rng.randn(b, n, 3) * 0.02 + [0.0, 0.0, 0.8]).astype(np.float32)
    quat = rng.randn(b, n, 4).astype(np.float32)
    # sample 0, hypothesis 0: identity on the optical axis, so its posed
    # model points are model_points + t exactly
    quat[0, 0], trans[0, 0] = [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.8]
    return {"quat": quat, "trans": trans,
            "conf": rng.uniform(0.05, 0.95, (b, n, 1)).astype(np.float32),
            "normal": rng.randn(b, h, h, 3).astype(np.float32),
            "depth": rng.rand(b, h, h, 1).astype(np.float32),
            "mask": rng.rand(b, h, h, 1).astype(np.float32)}


def _loss_inputs():
    gt, pred = W.tiny_batch(), _pred()
    # a model point of sample 0 exactly on its target under hypothesis 0:
    # zero distance in the direct and the chamfer forms
    gt["target"][0, 3] = gt["model_points"][0, 3] + np.float32(0.8) * \
        np.array([0.0, 0.0, 1.0], np.float32)
    return pred, gt


def test_transparent_loss_terms_match_jax():
    pred, gt = _loss_inputs()
    weights = {"distance": 1.0, "rotation": 0.7, "normal": 0.5,
               "depth": 1.3, "mask": 0.9, "boundary": 1.0}
    ref = jloss.transparent_loss({k: jnp.asarray(v) for k, v in pred.items()},
                                 {k: jnp.asarray(v) for k, v in gt.items()},
                                 weights)
    got = tloss.transparent_loss(
        {k: torch.from_numpy(v) for k, v in pred.items()},
        {k: torch.from_numpy(v) for k, v in gt.items()}, weights)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_transparent_loss_gradient_finite_at_a_coincident_point():
    pred, gt = _loss_inputs()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in pred.items()}
    tg = {k: torch.from_numpy(v) for k, v in gt.items()}
    posed = tg["model_points"][0, 3] + tp["trans"][0, 0].detach()
    assert torch.equal(posed, tg["target"][0, 3])
    losses = tloss.transparent_loss(tp, tg, dict.fromkeys(
        ("distance", "rotation", "normal", "depth", "mask"), 1.0))
    grads = torch.autograd.grad(losses["all_loss"], list(tp.values()))
    assert all(torch.isfinite(g).all() for g in grads)

    def jtotal(p):
        return jloss.transparent_loss(p, {k: jnp.asarray(v)
                                          for k, v in gt.items()},
                                      dict.fromkeys(("distance", "rotation",
                                                     "normal", "depth",
                                                     "mask"), 1.0))["all_loss"]

    jg = jax.grad(jtotal)({k: jnp.asarray(v) for k, v in pred.items()})
    for (k, v), g in zip(tp.items(), grads):
        _close(g.numpy(), jg[k], 1e-4)


def test_focal_loss_and_smooth_l1_match_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(4, 7, 3).astype(np.float32)
    target = rng.randint(0, 3, (4, 7))
    alpha = np.array([0.2, 0.3, 0.5], np.float32)
    for gamma, a in ((0.0, None), (2.0, alpha)):
        ref = jloss.focal_loss(jnp.asarray(logits), jnp.asarray(target), gamma,
                               None if a is None else jnp.asarray(a))
        got = tloss.focal_loss(torch.from_numpy(logits),
                               torch.from_numpy(target), gamma,
                               None if a is None else torch.from_numpy(a))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    x, y = (rng.randn(50).astype(np.float32) * 2 for _ in range(2))
    np.testing.assert_allclose(
        float(tloss.smooth_l1(torch.from_numpy(x), torch.from_numpy(y))),
        float(jloss.smooth_l1(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)

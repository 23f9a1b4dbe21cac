"""The full FusionNet and KRRN(fusion_variant="full") against the JAX
package, fp32, on the CPU, with the parameters of a flax init converted by
pose_estimation_tpu_torch.convert (strictly: every name and shape of the
flax tree, in its creation order):

  FusionNet at S=2 on 512 points, so that level 2 keeps k2 = 4 neighbour
      slots (at 128 points it has one, which hides the max over slots),
      and its wide first fuse layer (768 >= 2*256) runs the wide-table
      aggregate: the output and the gradients of its parameters at
      1e-4 * max(1, max|ref|) (the model tolerance; measured 5.8e-7 and
      1.0e-6), the ConvSurface directions at bf16 precision 2^-7 (their
      aggregate runs in bf16; measured 4.3e-3), and the gradients of the
      xyz and normal inputs, part of which flows back through that bf16
      aggregate, at 1e-3 (measured 1.9e-4);
  KRRN(fusion_variant="full") on the tiny config of the verify recipe
      (S=2): the maps and xyz_emb at 1e-4, pred_t at 2e-3 (the reason is
      the lite model's, tests/test_torch_slice.py: the ~1e-5 that conv
      summation order leaves in xyz_emb flips bf16 roundings of the
      surface aggregate that the fusion net amplifies);
  one train step of that model (opt_pose=True, the deterministic
      forward) against the JAX package's step composed from its own
      functions: the loss terms at rtol 5e-3 and the gradient's global
      norm at rtol 1e-2, for the lite model's reason
      (tests/test_torch_train.py).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_estimation_tpu.configs import schema as jschema
from pose_estimation_tpu.data import batching as jbatching
from pose_estimation_tpu.data.synthetic import SyntheticPoseDataset
from pose_estimation_tpu.models import fusion as jfusion
from pose_estimation_tpu.models.krrn import KRRN as JKRRN
from pose_estimation_tpu.parallel import train_step as jstep
from pose_estimation_tpu_torch import convert
from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.models import fusion
from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.train import optim
from pose_estimation_tpu_torch.train.train_step import build_train_step

jpose = importlib.import_module("pose_estimation_tpu.losses.pose_loss")

torch.set_num_threads(1)

TINY_OVERRIDES = {
    "module.num_cls": 2, "data.num_regions": 8, "data.num_points": 128,
    "data.input_size": 64, "module.backbone_outc": 16,
    "module.stem_width": 8,
    "module.hrnet_stages": ((1, 1, (8, 8)), (1, 1, (8, 8, 16)),
                            (1, 1, (8, 8, 16, 16))),
    "module.xyznet": schema.HeadConfig(hidden=16),
    "module.nmlnet": schema.HeadConfig(hidden=16),
    "module.gcn3d": schema.Gcn3dConfig(neighbor_num=4, support_num=2),
    "train.batch_size": 2, "train.amp": False}
TINY = schema.override(schema.Config(dataset="synthetic"), **TINY_OVERRIDES)
JTINY = jschema.override(jschema.Config(dataset="synthetic"),
                         **{k: (jschema.HeadConfig(**dataclasses.asdict(v))
                                if isinstance(v, schema.HeadConfig) else
                                jschema.Gcn3dConfig(**dataclasses.asdict(v))
                                if isinstance(v, schema.Gcn3dConfig) else v)
                            for k, v in TINY_OVERRIDES.items()})


def _err(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert np.shape(got) == ref.shape
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _clouds(seed, b, n):
    rng = np.random.RandomState(seed)
    v = (rng.randn(b, n, 3) * 0.05 + [0, 0, 0.8]).astype(np.float32)
    xyz = rng.rand(b, n, 3).astype(np.float32)
    nml = rng.randn(b, n, 3).astype(np.float32)
    nml /= np.linalg.norm(nml, axis=-1, keepdims=True)
    return v, xyz, nml


def test_fusion_net_matches_jax_forward_and_grad():
    v, xyz, nml = _clouds(16, 1, 512)
    ct = np.random.RandomState(17).randn(1, 512, 1664).astype(np.float32)
    jm = jfusion.FusionNet(neighbor_num=4, support_num=2)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), v, xyz, nml)["params"]
    ref_out, ref_vjp = jax.vjp(lambda p, x, n: jm.apply({"params": p}, v, x, n),
                               params, xyz, nml)
    ref = ref_vjp(jnp.asarray(ct))
    tm = fusion.FusionNet(4, 2)
    convert.load_flax_params(tm, convert.flatten_tree(params))
    assert tm.ConvLayer_3.narrow is False       # fm_4 is the wide layer
    tx = torch.from_numpy(xyz).requires_grad_()
    tn = torch.from_numpy(nml).requires_grad_()
    names, ps = zip(*tm.named_parameters())
    out = tm(torch.from_numpy(v), tx, tn)
    assert out.shape == (1, 512, 1664)
    assert _err(out, ref_out) <= 1e-4
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                list(ps) + [tx, tn])
    got = convert.torch_to_flax(dict(zip(names, grads[:-2])))
    got.update(xyz=grads[-2].numpy(), nml=grads[-1].numpy())
    want = dict(convert.flatten_tree(ref[0]), xyz=ref[1], nml=ref[2])
    assert sorted(got) == sorted(want)
    for k, r in want.items():
        tol = (2.0 ** -7 if k.endswith("conv0/directions")
               else 1e-3 if k in ("xyz", "nml") else 1e-4)
        assert _err(got[k], r) <= tol, k


def test_fusion_net_children_follow_flax_creation_order():
    """Names and shapes checked against the flax init tree, not a list by
    hand: the numbering within a class is flax's creation order, which
    the shapes tell apart (ConvLayer_0..2 are 256 -> 256 on 3-D
    directions, ConvLayer_3 768 -> 256 and ConvLayer_4 256 -> 512 on 9-D
    ones)."""
    v, xyz, nml = _clouds(18, 1, 64)
    jm = jfusion.FusionNet(neighbor_num=4, support_num=2)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), v, xyz, nml)["params"]
    tm = fusion.FusionNet(4, 2)
    assert sorted(params) == sorted(n for n, _ in tm.named_children())
    want = convert.flatten_tree(params)
    got = convert.torch_to_flax(tm.state_dict())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k


@pytest.mark.parametrize("cls", ["FusionNetLite", "FusionNet"])
def test_fusion_at_one_support_raises_in_both_packages(cls):
    """At S = 1 every level-0 ConvLayer is wide (in_ch >= S*O), which the
    fused multi-stream call does not take: both packages raise."""
    v, xyz, nml = _clouds(19, 1, 64)
    with pytest.raises(ValueError):
        getattr(jfusion, cls)(neighbor_num=4, support_num=1).init(
            jax.random.PRNGKey(0), v, xyz, nml)
    with torch.no_grad(), pytest.raises(ValueError):
        getattr(fusion, cls)(4, 1)(*map(torch.from_numpy, (v, xyz, nml)))


@pytest.fixture(scope="module")
def setup():
    ds = SyntheticPoseDataset(num_objects=2, frames_per_object=2,
                              im_h=240, im_w=320, num_regions=8)
    jbatch = {k: np.asarray(v) for k, v in jbatching.make_batch(
        ds, [0, 3], jax.random.PRNGKey(0), 64, 128).items()}
    jm = JKRRN(cfg=JTINY, fusion_variant="full")
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jbatch["img"],
                              jbatch["cloud"], jbatch["choose"],
                              jbatch["cls"])["params"]
    tm = convert.load_flax_params(KRRN(TINY, fusion_variant="full"),
                                  convert.flatten_tree(params))
    return jm, params, tm, jbatch


def _tb(jbatch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in jbatch.items()}


def test_krrn_full_matches_jax(setup):
    jm, params, tm, jbatch = setup
    args = [jbatch[k] for k in ("img", "cloud", "choose", "cls")]
    ref = jax.jit(jm.apply)({"params": params}, *args)
    with torch.no_grad():
        got = tm.eval()(*map(torch.from_numpy, args))
    assert tm.fusion_name == "FusionNet_0"
    for k in ("xyz", "region", "mask", "xyz_emb"):
        assert _err(got[k], ref[k]) <= 1e-4, k
    assert _err(got["pred_t"], ref["pred_t"]) <= 2e-3


def test_krrn_full_train_step_matches_jax(setup):
    jm, params, tm, jbatch = setup
    weights = jstep.loss_weights_dict(JTINY)

    def loss_fn(p):
        out = jm.apply({"params": p}, jbatch["img"], jbatch["cloud"],
                       jbatch["choose"], jbatch["cls"], train=False,
                       opt_pose=True)
        losses = jpose.krrn_loss(out, jbatch, weights, opt_pose=True)
        return losses["loss"], losses

    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    ref_norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                                  for g in jax.tree.leaves(grads))))
    tm.train()
    step = build_train_step(tm, optim.make_optimizer(TINY, total_steps=10),
                            TINY)
    losses = step.losses(_tb(jbatch), opt_pose=True, train=False)
    got = step.gradients(losses)
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in got.values())))
    for k in ref:
        np.testing.assert_allclose(float(losses[k].detach()), float(ref[k]),
                                   rtol=5e-3, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(norm, ref_norm, rtol=1e-2)

"""The KRRN training options off in the shipped config, port against the
JAX package, on the CPU, on the tiny config of the verify recipe (fp32):

  BatchNorm against flax nn.BatchNorm(momentum=0.9) on the three layouts
      the model feeds it (NCHW maps, [B, N, C] points, [B, C] vectors):
      output and running mean / variance after each of 3 training calls,
      then an eval call, at rtol 1e-5 (bf16 activations at one bf16 ulp);
  KRRN with module.norm="bn": the eval forward on running statistics
      (maps at 1e-5 x max(1, max|ref|), measured 4.8e-7; pred_t at 2e-3,
      measured 9.5e-5);
      3 train steps (opt_pose=False, train=True, Ranger) against the JAX
      step composed from its own functions: after the first, parameters
      and running statistics at 1e-5 x max(1, max|ref|) (measured 3e-8
      and 1.1e-6) and the loss terms at rtol 1e-5; after the second and
      third, parameters at 2e-4 (measured 9.0e-5), statistics at 1e-3
      (measured 2.9e-4) and the loss terms at 1e-3 (measured 3.1e-4). A
      NaN in the target or the image: the step is skipped, the statistics
      still move (NaN in the image's case, in both), parameters and
      statistics at 1e-5 (measured 5.3e-6), Ranger's moments at 1e-3 /
      1e-4 (measured 5.2e-4 / 1.7e-5), all NaN where the JAX package's
      are;
  Adam and AdamW (weight decay 1e-2) with the global-norm clip: 8 steps
      against optim.make_optimizer, the manual schedule at lr_scale 0.6,
      at 1e-6 x max(1, max|ref|);
  pnp_implicit: the gradients to pw, uv and k against jax.vjp of the JAX
      function at 1e-5 x max(1, max|ref|) (measured 3.6e-7), and against
      finite differences;
  the refine loss against build_refine_loss with the JAX package's RANSAC
      subsets, with and without xyz_offset_decode: value at rtol 1e-4,
      the gradient to xyz_emb at 1e-4 x max(1, max|ref|) (measured
      2.5e-6); and a train step with only weight_refine set moves
      XYZHead_0;
  the rotation heads: vertical_rot_vectors and rot_mat_y_first at 1e-6,
      PoseNet's codes at 1e-5 and their gradients at 1e-4 fed the same
      features, KRRN(enable_rot)'s pred_r at 5e-4 (measured 1.1e-4), and
      the gradients reaching both RotBases;
  checkpoints and tools: a BN state round trip through state.pt,
      merge_partial_params (parameters only, counted as the JAX version
      counts), save_params_npz (no running statistics), tools/infer.py
      --params refusing a BN config with the JAX tool's message, and the
      CLI, infer --ckpt and eval_standalone with every option on.

Why the BN steps loosen after the first: the tiny BN model's gradient is
ill-conditioned in fp32. Against the port run in fp64, both packages'
fp32 gradients are off by 1.2% (global norm), most in the low-resolution
branches' BatchNorms, where E[x^2] - E[x]^2 over the 32 values of a 4x4
map cancels; the two fp32 gradients differ by 0.6%, and the first
updates carry that into the parameters and so into the next batch
statistics.
"""

import dataclasses
import importlib
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from pose_estimation_tpu.configs import schema as jschema
from pose_estimation_tpu.core.solvers import pnp as jpnp
from pose_estimation_tpu.core.solvers.lm import refine_pose_lm as jlm
from pose_estimation_tpu.data import batching as jbatching
from pose_estimation_tpu.data.synthetic import SyntheticPoseDataset
from pose_estimation_tpu.models import posenet as jposenet
from pose_estimation_tpu.models.krrn import KRRN as JKRRN
from pose_estimation_tpu.parallel import train_step as jstep
from pose_estimation_tpu.train import checkpoint as jckpt
from pose_estimation_tpu.train import optim as joptim
from pose_estimation_tpu.train.state import TrainState as JTrainState
from pose_estimation_tpu_torch import cli, convert
from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.core.solvers.lm import refine_pose_lm
from pose_estimation_tpu_torch.core.solvers.pnp import pnp_implicit
from pose_estimation_tpu_torch.models import layers, posenet
from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.train import optim
from pose_estimation_tpu_torch.train.checkpoint import (
    CheckpointManager, save_params_npz)
from pose_estimation_tpu_torch.train.state import TrainState
from pose_estimation_tpu_torch.train.train_step import (
    build_refine_loss, build_train_step)

jpose = importlib.import_module("pose_estimation_tpu.losses.pose_loss")

torch.set_num_threads(1)

TINY_STAGES = ((1, 1, (8, 8)), (1, 1, (8, 8, 16)), (1, 1, (8, 8, 16, 16)))
OVERRIDES = {
    "module.num_cls": 2, "data.num_regions": 8, "data.num_points": 128,
    "data.input_size": 64, "module.backbone_outc": 16,
    "module.stem_width": 8, "module.hrnet_stages": TINY_STAGES,
    "module.xyznet": schema.HeadConfig(hidden=16),
    "module.nmlnet": schema.HeadConfig(hidden=16),
    "module.gcn3d": schema.Gcn3dConfig(neighbor_num=4, support_num=2),
    "train.batch_size": 2, "train.amp": False,
    "train.lr.lr": 1e-3, "train.lr.warmup_iters": 0,
    "eval.num_pnp_points": 32, "eval.pnp_hypotheses": 8,
    "eval.refine_top_k": 2}
BN = {"module.norm": "bn"}
ALL = dict(BN, **{"train.optimizer.type": "Adam", "train.refine": True,
                  "train.start_pose_epoch": 0})
TOTAL_STEPS = 40


def _jval(v):
    if isinstance(v, schema.HeadConfig):
        return jschema.HeadConfig(**dataclasses.asdict(v))
    if isinstance(v, schema.Gcn3dConfig):
        return jschema.Gcn3dConfig(**dataclasses.asdict(v))
    return v


def _cfgs(**extra):
    """(port config, JAX config) of the tiny model with `extra`."""
    over = dict(OVERRIDES, **extra)
    return (schema.override(schema.Config(dataset="synthetic"), **over),
            jschema.override(jschema.Config(dataset="synthetic"),
                             **{k: _jval(v) for k, v in over.items()}))


TINY, JTINY = _cfgs()
TINY_BN, JTINY_BN = _cfgs(**BN)


def _nest(flat: dict) -> dict:
    """'/'-joined flat dict -> the nested tree flax takes."""
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _hold(got: dict, ref: dict, tol: float, what=""):
    """Leaf by leaf: |got - ref| <= tol * max(1, max|ref|), NaN where ref
    has NaN."""
    assert sorted(got) == sorted(ref), what
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r),
                                      err_msg=f"{what} {k}")
        ok = ~np.isnan(r)
        if ok.any():
            err = _rel_err(g[ok], r[ok])
            assert err <= tol, (what, k, err, tol)


def _tb(jbatch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in jbatch.items()}


@pytest.fixture(scope="module")
def jbatch():
    ds = SyntheticPoseDataset(num_objects=2, frames_per_object=2,
                              im_h=240, im_w=320, num_regions=8)
    return {k: np.asarray(v) for k, v in jbatching.make_batch(
        ds, [0, 3], jax.random.PRNGKey(0), 64, 128).items()}


# --- BatchNorm ----------------------------------------------------------------

LAYOUTS = {"nchw": (4, 6, 5, 7), "points": (3, 40, 12), "vector": (8, 12)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_batchnorm_matches_flax(layout, dtype):
    rng = np.random.RandomState(0)
    shape = LAYOUTS[layout]
    c = shape[1] if layout == "nchw" else shape[-1]
    to_j = ((lambda x: np.moveaxis(x, 1, -1)) if layout == "nchw"
            else (lambda x: x))
    xs = [(rng.randn(*shape) * 2 + rng.randn(c).reshape(
        [-1 if (d == 1 and layout == "nchw") or (d == len(shape) - 1
                                                 and layout != "nchw")
         else 1 for d in range(len(shape))])).astype(np.float32)
          for _ in range(4)]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    params = {"scale": jnp.asarray(rng.rand(c).astype(np.float32) + 0.5),
              "bias": jnp.asarray(rng.randn(c).astype(np.float32))}
    jm = fnn.BatchNorm(momentum=0.9, dtype=jdt)
    stats = jm.init(jax.random.PRNGKey(0), to_j(xs[0]),
                    use_running_average=True)["batch_stats"]
    tm = layers.BatchNorm(c, dtype=tdt)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.asarray(params["scale"])))
        tm.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
    assert sorted(tm.state_dict()) == ["bias", "running_mean",
                                       "running_var", "weight"]
    rtol = 1e-5 if dtype == "float32" else 8e-3

    def check(got, ref):
        assert got.dtype == tdt
        np.testing.assert_allclose(to_j(got.detach().float().numpy()),
                                   np.asarray(ref, np.float32), rtol=rtol,
                                   atol=rtol)

    tm.train()
    for x in xs[:3]:
        xj = jnp.asarray(to_j(x)).astype(jdt)
        ref, mut = jm.apply({"params": params, "batch_stats": stats}, xj,
                            use_running_average=False,
                            mutable=["batch_stats"])
        stats = mut["batch_stats"]
        check(tm(torch.from_numpy(x).to(tdt)), ref)
        np.testing.assert_allclose(tm.running_mean.numpy(), stats["mean"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tm.running_var.numpy(), stats["var"],
                                   rtol=1e-5, atol=1e-7)
    tm.eval()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    ref = jm.apply({"params": params, "batch_stats": stats},
                   jnp.asarray(to_j(xs[3])).astype(jdt),
                   use_running_average=True)
    check(tm(torch.from_numpy(xs[3]).to(tdt)), ref)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_batchnorm_running_variance_is_the_biased_one():
    """The trap of torch's batch_norm: flax moves running_var by the
    biased batch variance."""
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    bn = layers.BatchNorm(3).train()
    bn(x)
    want = 0.9 + 0.1 * x.var(0, unbiased=False)
    torch.testing.assert_close(bn.running_var, want, rtol=1e-5, atol=1e-6)
    assert not torch.allclose(bn.running_var,
                              0.9 + 0.1 * x.var(0, unbiased=True))


# --- KRRN with BatchNorm --------------------------------------------------------

def _bn_model(seed=1, moved_stats=False):
    torch.manual_seed(seed)
    model = KRRN(TINY_BN)
    if moved_stats:
        g = torch.Generator().manual_seed(seed)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.05 * torch.randn(buf.shape, generator=g))
            else:
                buf.copy_(0.8 + 0.45 * torch.rand(buf.shape, generator=g))
    return model


def _jtrees(model):
    params, stats = convert.flax_trees(model)
    return _nest(params), _nest(stats)


def test_bn_model_has_flax_trees():
    model = _bn_model()
    params, stats = convert.flax_trees(model)
    assert len(stats) == 2 * sum(
        isinstance(m, layers.BatchNorm) for m in model.modules()) > 0
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: JKRRN(cfg=JTINY_BN).init(
        jax.random.PRNGKey(0), x, jnp.zeros((1, 128, 3)),
        jnp.zeros((1, 128), jnp.int32), jnp.zeros((1,), jnp.int32)))
    for tree, ours in ((shapes["params"], params),
                       (shapes["batch_stats"], stats)):
        want = {"/".join(p.key for p in path): leaf.shape for path, leaf
                in jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert sorted(want) == sorted(ours)
        assert all(want[k] == ours[k].shape for k in want)
    assert any(k.endswith("Norm_0/BatchNorm_0/mean") for k in stats)
    assert any("norm1/BatchNorm_0" in k for k in stats)
    again = convert.load_flax_params(KRRN(TINY_BN), params, stats)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    with pytest.raises(KeyError, match="missing"):
        convert.flax_to_torch(params, KRRN(TINY_BN))      # no statistics
    with pytest.raises(KeyError, match="unused"):
        convert.flax_to_torch(params, KRRN(TINY), stats)  # no BatchNorm
    bad = dict(stats)
    bad[next(iter(bad))] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.flax_to_torch(params, KRRN(TINY_BN), bad)


def test_bn_eval_forward_matches_jax(jbatch):
    model = _bn_model(moved_stats=True)
    params, stats = _jtrees(model)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    ref = jax.jit(lambda v: JKRRN(cfg=JTINY_BN).apply(
        v, jb["img"], jb["cloud"], jb["choose"], jb["cls"], train=False))(
            {"params": params, "batch_stats": stats})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tb = _tb(jbatch)
    with torch.no_grad():
        got = model(tb["img"], tb["cloud"], tb["choose"], tb["cls"])
    for k in ("xyz", "region", "mask", "normal", "xyz_emb"):
        assert _rel_err(got[k].numpy(), ref[k]) <= 1e-5, k
    assert _rel_err(got["pred_t"].numpy(), ref["pred_t"]) <= 2e-3
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.fixture(scope="module")
def bn_step():
    """The JAX package's BN train step (opt_pose=False), composed from its
    own functions as parallel/train_step.py composes them."""
    jm = JKRRN(cfg=JTINY_BN)
    tx = joptim.make_optimizer(JTINY_BN, total_steps=TOTAL_STEPS)
    weights = jstep.loss_weights_dict(JTINY_BN)

    @jax.jit
    def step(state, batch):
        def loss_fn(p):
            out, mut = jm.apply(
                {"params": p, "batch_stats": state.batch_stats},
                batch["img"], batch["cloud"], batch["choose"], batch["cls"],
                train=True, opt_pose=False, mutable=["batch_stats"])
            losses = jpose.krrn_loss(out, batch, weights, opt_pose=False)
            return losses["loss"], (losses, mut["batch_stats"])

        (loss, (losses, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                             for g in jax.tree.leaves(grads)))
        finite = jnp.isfinite(loss) & jnp.isfinite(gnorm)
        grads = jax.tree.map(
            lambda g: jnp.where(finite, g, jnp.zeros_like(g)), grads)
        return (state.apply_gradients(tx, grads, new_batch_stats=new_bs),
                losses, (~finite).astype(jnp.float32))

    return tx, step


def _bn_pair(tx_ref):
    model = _bn_model()
    params, stats = _jtrees(model)
    ref = JTrainState.create(params, tx_ref, jax.random.PRNGKey(0),
                             batch_stats=stats)
    tx = optim.make_optimizer(TINY_BN, total_steps=TOTAL_STEPS)
    state = TrainState.create(model, tx, torch.Generator().manual_seed(0))
    return ref, state, build_train_step(model, tx, TINY_BN)


def _hold_state(state, ref, tol, stats_tol, what):
    params, stats = convert.flax_trees(state.model)
    _hold(params, convert.flatten_tree(ref.params), tol, f"{what} params")
    _hold(stats, convert.flatten_tree(ref.batch_stats), stats_tol,
          f"{what} batch_stats")


def test_bn_train_steps_match_jax(jbatch, bn_step):
    tx_ref, jax_step = bn_step
    ref, state, step = _bn_pair(tx_ref)
    _, stats0 = convert.flax_trees(state.model)
    batch = _tb(jbatch)
    for i in range(3):
        ref, losses, skipped = jax_step(ref, jbatch)
        m = step(state, batch, opt_pose=False, train=True)
        assert float(m["skipped_nonfinite"]) == float(skipped) == 0.0
        for k in losses:
            np.testing.assert_allclose(float(m[k]), float(losses[k]),
                                       rtol=1e-5 if i == 0 else 1e-3,
                                       atol=1e-5)
        _hold_state(state, ref, *((1e-5, 1e-5) if i == 0 else (2e-4, 1e-3)),
                    f"step {i}")
    _, stats = convert.flax_trees(state.model)
    assert max(float(np.abs(stats[k] - stats0[k]).max()) for k in stats) > 0
    assert state.step == int(ref.step) == 3


@pytest.mark.parametrize("where", ["target", "image"])
def test_bn_nan_step_matches_jax(jbatch, bn_step, where):
    """A NaN in the xyz target (finite statistics) or in the image (NaN
    statistics): the update is skipped, the running statistics move all
    the same, and parameters, statistics and Ranger's state equal the JAX
    package's."""
    tx_ref, jax_step = bn_step
    ref, state, step = _bn_pair(tx_ref)
    bad = {k: v.copy() for k, v in jbatch.items()}
    if where == "target":
        b, h, w = np.nonzero(bad["valid"])
        bad["xyz"][b[0], h[0], w[0], 0] = np.nan
    else:
        bad["img"][0, 3, 4, 1] = np.nan
    for i, bt in enumerate([jbatch, bad]):
        _, before = convert.flax_trees(state.model)
        ref, _, skipped = jax_step(ref, bt)
        m = step(state, _tb(bt), opt_pose=False, train=True)
        assert float(m["skipped_nonfinite"]) == float(skipped) == float(i)
    assert not torch.isfinite(m["loss"])
    _, after = convert.flax_trees(state.model)
    moved = [k for k in after
             if not np.array_equal(after[k], before[k], equal_nan=True)]
    assert moved
    if where == "target":
        assert all(np.isfinite(v).all() for v in after.values())
    _hold_state(state, ref, 1e-5, 1e-5, "after the NaN step")
    _, radam, _, _, look = ref.opt_state[1]
    assert state.opt_state["count"] == int(radam.count) == 2
    for name, tree, tol in (("mu", radam.mu, 1e-3), ("nu", radam.nu, 1e-4),
                            ("slow", look.slow, 1e-6)):
        _hold(state.opt_state[name], convert.tree_to_torch(tree), tol, name)


# --- Adam -----------------------------------------------------------------------

def _flax_tree(seed):
    """A parameter tree with every layout the port converts."""
    rng = np.random.RandomState(seed)
    shapes = {"A/Conv_0/kernel": (3, 3, 4, 5), "A/Conv_0/bias": (5,),
              "B/ConvTranspose_0/kernel": (4, 4, 5, 6),
              "C/Dense_0/kernel": (7, 8), "C/Dense_0/bias": (8,),
              "D/BatchNorm_0/scale": (8,), "D/BatchNorm_0/bias": (8,),
              "E/conv0/directions": (3, 12), "E/ConvLayer_0/weights": (6, 16),
              "E/ConvLayer_0/bias": (16,)}
    return _nest({k: (rng.randn(*s) * 0.3).astype(np.float32)
                  for k, s in shapes.items()})


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("kind", ["Adam", "adam", "SGD"])
def test_adam_matches_optax(kind, weight_decay):
    """Any type but "ranger" is Adam (AdamW with weight decay), as
    make_optimizer's dispatch in the JAX package."""
    over = {"train.optimizer.type": kind, "train.lr.scheduler": "manual",
            "train.lr.lr": 1e-2, "train.optimizer.weight_decay": weight_decay}
    tx_ref = joptim.make_optimizer(jschema.override(jschema.Config(),
                                                    **over), total_steps=8)
    tx = optim.make_optimizer(schema.override(schema.Config(), **over),
                              total_steps=8)
    assert isinstance(tx, optim.Adam)
    tree = _flax_tree(0)
    ref = JTrainState.create(tree, tx_ref, jax.random.PRNGKey(0))
    ref = ref.replace(lr_scale=jnp.float32(0.6))
    params = convert.tree_to_torch(tree)
    state = tx.init(params)
    apply = jax.jit(lambda st, g: st.apply_gradients(tx_ref, g))
    rng = np.random.RandomState(10)
    for i in range(8):
        # steps 2 and 5 carry a global norm above the clip of 10
        g = jax.tree.map(lambda p: jnp.asarray((rng.randn(*p.shape) * (
            20.0 if i in (2, 5) else 0.5)).astype(np.float32)), tree)
        ref = apply(ref, g)
        upd, state = tx.update(convert.tree_to_torch(g), state, params,
                               lr_scale=0.6)
        params = {k: p + upd[k] for k, p in params.items()}
        _hold(params, convert.tree_to_torch(ref.params), 1e-6, f"step {i}")
    adam = [s for s in jax.tree.leaves(
        ref.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    assert state["count"] == int(adam.count) == 8
    _hold(state["mu"], convert.tree_to_torch(adam.mu), 1e-6, "mu")
    _hold(state["nu"], convert.tree_to_torch(adam.nu), 1e-6, "nu")


# --- pnp_implicit ---------------------------------------------------------------

K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
              [0.0, 0.0, 1.0]], np.float32)


def _case(rng, n=32, noise=0.5):
    """tests/test_solvers.py's case: a random pose, points in front of the
    camera, noisy projections."""
    rv = rng.randn(3) * 0.6
    r_gt, _ = cv2.Rodrigues(rv)
    t_gt = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1),
                     rng.uniform(0.6, 1.2)])
    pw = (rng.rand(n, 3) - 0.5) * 0.2
    pc = pw @ r_gt.T + t_gt
    uv = pc[:, :2] / pc[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    uv = uv + rng.randn(n, 2) * noise
    pose0 = np.concatenate([cv2.Rodrigues(r_gt)[0][:, 0], t_gt])
    return (pw.astype(np.float32), uv.astype(np.float32),
            pose0.astype(np.float32))


def test_pnp_implicit_matches_jax_vjp():
    """Two instances of the LM-from-near-ground-truth case, batched in the
    port: the gradients to pw, uv and k from the exact Hessian."""
    rng = np.random.RandomState(0)
    cases = [_case(rng) for _ in range(2)]
    w = np.ones(32, np.float32)
    w[::5] = 0.3
    gbar = np.arange(6, dtype=np.float32) - 2.0
    poses, refs = [], []
    for pw, uv, pose0 in cases:
        pose, _ = jlm(jnp.asarray(pose0), pw, uv, K, w, iters=30)
        _, vjp = jax.vjp(lambda a, b, c: jpnp.pnp_implicit(pose, a, b, c, w),
                         pw, uv, K)
        poses.append(np.asarray(pose))
        refs.append([np.asarray(g) for g in vjp(jnp.asarray(gbar))])
    stack = lambda i: torch.from_numpy(np.stack([c[i] for c in cases]))
    pw, uv = stack(0).requires_grad_(), stack(1).requires_grad_()
    k = torch.from_numpy(np.stack([K, K])).requires_grad_()
    out = pnp_implicit(torch.from_numpy(np.stack(poses)), pw, uv, k,
                       torch.from_numpy(np.stack([w, w])))
    torch.testing.assert_close(out, torch.from_numpy(np.stack(poses)))
    (out * torch.from_numpy(gbar)).sum().backward()
    for b in range(2):
        for got, ref in zip((pw.grad[b], uv.grad[b], k.grad[b]), refs[b]):
            assert _rel_err(got.numpy(), ref) <= 1e-5


def test_pnp_implicit_matches_finite_differences():
    """The JAX test's check on the port: LM from near ground truth, then
    pnp_implicit; d(sum(pose * arange(6)))/d(uv) against central
    differences at three coordinates."""
    pw, uv, pose0 = _case(np.random.RandomState(0))
    pw_t, k_t = torch.from_numpy(pw)[None], torch.from_numpy(K)[None]
    w = torch.ones(1, 32)

    def solve(uv_in):
        with torch.no_grad():
            pose, _ = refine_pose_lm(torch.from_numpy(pose0)[None], pw_t,
                                     uv_in.detach(), k_t, w, iters=30)
        pose = pnp_implicit(pose, pw_t, uv_in, k_t, w)
        return torch.sum(pose * torch.arange(6.0))

    uv_t = torch.from_numpy(uv)[None].requires_grad_()
    solve(uv_t).backward()
    g = uv_t.grad[0]
    assert torch.isfinite(g).all()
    eps = 0.05
    for i, j in [(0, 0), (5, 1), (17, 0)]:
        up, dn = uv_t.detach().clone(), uv_t.detach().clone()
        up[0, i, j] += eps
        dn[0, i, j] -= eps
        fd = (float(solve(up)) - float(solve(dn))) / (2 * eps)
        an = float(g[i, j])
        assert abs(fd - an) < max(0.15 * abs(fd), 2e-3), (i, j, fd, an)


# --- the refine loss --------------------------------------------------------------

@pytest.mark.parametrize("offset_decode", [False, True])
def test_refine_loss_matches_jax(jbatch, offset_decode):
    """build_refine_loss on coordinates near the ground truth (a random
    head would hand PnP an ill-posed problem), the JAX package's RANSAC
    subsets handed to the port."""
    cfg, jcfg = _cfgs(**{"module.xyz_offset_decode": offset_decode})
    rng = np.random.RandomState(5)
    b, s = jbatch["xyz"].shape[:2]
    n = jbatch["choose"].shape[1]
    gt = np.take_along_axis(jbatch["xyz"].reshape(b, s * s, 3),
                            jbatch["choose"][..., None].astype(np.int64), 1)
    region = rng.randn(b, s, s, 9).astype(np.float32)
    out = {"region": jnp.asarray(region)}
    if offset_decode:
        gt = gt - np.asarray(jstep.region_base_at_choose(
            {"region": out["region"]}, jbatch, soft=True))
    xyz_emb = (gt + 0.003 * rng.randn(*gt.shape)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    ref_loss = jstep.build_refine_loss(jcfg)
    val, grad = jax.value_and_grad(lambda x: ref_loss(
        dict(out, xyz_emb=x), jbatch, key))(jnp.asarray(xyz_emb))
    keys = jax.random.split(key, b)
    sub = np.stack([np.asarray(jpnp._minimal_subsets(
        keys[i], n, 6, 8, jnp.ones(n))) for i in range(b)])

    x = torch.from_numpy(xyz_emb).requires_grad_()
    got = build_refine_loss(cfg)(
        {"xyz_emb": x, "region": torch.from_numpy(region)}, _tb(jbatch),
        subset_ids=torch.from_numpy(sub).long())
    got.backward()
    np.testing.assert_allclose(float(got), float(val), rtol=1e-4)
    assert _rel_err(x.grad.numpy(), grad) <= 1e-4
    assert float(np.abs(np.asarray(grad)).max()) > 0


def test_train_step_refine_grads_reach_xyz_head(jbatch):
    """The JAX test of the same name on the port: with every loss weight
    zeroed but weight_refine, one step still moves XYZHead_0, whose only
    path to the loss runs through the PnP solve."""
    cfg, _ = _cfgs(**{
        "train.refine": True, "train.loss.weight_xyz": 0.0,
        "train.loss.weight_region": 0.0, "train.loss.weight_mask": 0.0,
        "train.loss.weight_normal": 0.0, "train.loss.weight_pose": 0.0,
        "train.loss.weight_refine": 1.0})
    torch.manual_seed(0)
    model = KRRN(cfg)
    tx = optim.make_optimizer(cfg)
    state = TrainState.create(model, tx, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.XYZHead_0.state_dict().items()}
    m = build_train_step(model, tx, cfg)(state, _tb(jbatch), opt_pose=True)
    assert torch.isfinite(m["loss_refine"]) and float(m["loss_refine"]) > 0
    assert float(m["skipped_nonfinite"]) == 0.0
    assert max(float((v - before[k]).abs().max())
               for k, v in model.XYZHead_0.state_dict().items()) > 0


# --- the rotation heads -------------------------------------------------------------

def test_rotation_functions_match_jax():
    rng = np.random.RandomState(2)
    v1, v2 = (rng.randn(6, 3).astype(np.float32) for _ in range(2))
    v1 /= np.linalg.norm(v1, axis=-1, keepdims=True)
    v2 /= np.linalg.norm(v2, axis=-1, keepdims=True)
    c1, c2 = (rng.rand(6, 1).astype(np.float32) for _ in range(2))
    ref = jposenet.vertical_rot_vectors(c1, c2, v1, v2)
    got = posenet.vertical_rot_vectors(*map(torch.from_numpy,
                                            (c1, c2, v1, v2)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, atol=1e-6)
    y, x = (np.asarray(a) for a in ref)
    r_ref = jposenet.rot_mat_y_first(y, x)
    r_got = posenet.rot_mat_y_first(torch.from_numpy(y), torch.from_numpy(x))
    np.testing.assert_allclose(r_got.numpy(), r_ref, rtol=1e-6, atol=1e-6)
    eye = r_got.transpose(-1, -2) @ r_got
    torch.testing.assert_close(eye, torch.eye(3).expand(6, 3, 3),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("norm", ["gn", "bn"])
def test_posenet_rotation_codes_and_grads_match_jax(norm):
    """PoseNet(enable_rot) fed the same features: its three outputs at
    1e-5, and the gradients of a loss on the codes into both RotBases at
    1e-4."""
    rng = np.random.RandomState(1)
    feat = rng.randn(2, 24, 20).astype(np.float32)
    torch.manual_seed(3)
    tm = posenet.PoseNet(20, enable_rot=True, norm=norm).eval()
    assert [n for n, _ in tm.named_children()] == ["TBase_0", "RotBase_0",
                                                   "RotBase_1"]
    params, stats = convert.flax_trees(tm)
    jm = jposenet.PoseNet(enable_rot=True, norm=norm)
    cot = [rng.randn(2, 4).astype(np.float32) for _ in range(2)]
    variables = {"params": _nest(params)}
    if stats:
        variables["batch_stats"] = _nest(stats)

    def jloss(p):
        green, red, t = jm.apply(dict(variables, params=p), feat)
        return jnp.sum(green * cot[0]) + jnp.sum(red * cot[1]), (green, red,
                                                                 t)

    (_, ref), grads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    got = tm(torch.from_numpy(feat))
    for g, r in zip(got, ref):
        assert _rel_err(g.detach().numpy(), r) <= 1e-5
    loss = sum(torch.sum(g * torch.from_numpy(c))
               for g, c in zip(got[:2], cot))
    loss.backward()
    tg = convert.torch_to_flax({k: p.grad for k, p in tm.named_parameters()
                                if k.startswith("RotBase")})
    rg = {k: v for k, v in convert.flatten_tree(grads).items()
          if k.startswith("RotBase")}
    _hold(tg, rg, 1e-4, "RotBase grads")
    for head in ("RotBase_0", "RotBase_1"):
        assert max(float(np.abs(v).max()) for k, v in tg.items()
                   if k.startswith(head)) > 0


def test_krrn_pred_r_matches_jax(jbatch):
    """pred_r of the whole model: looser than PoseNet's 1e-5 above, because
    the fusion net's inputs differ by ~1e-6 (conv summation order), which
    flips a few of its max-over-neighbour picks (the same cause as
    pred_t's 2e-3 in tests/test_torch_slice.py)."""
    torch.manual_seed(2)
    model = KRRN(TINY, enable_rot=True)
    params, _ = convert.flax_trees(model)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    ref = jax.jit(lambda p: JKRRN(cfg=JTINY, enable_rot=True).apply(
        {"params": p}, jb["img"], jb["cloud"], jb["choose"], jb["cls"]))(
            _nest(params))
    tb = _tb(jbatch)
    got = model(tb["img"], tb["cloud"], tb["choose"], tb["cls"])
    pred_r = got["pred_r"]
    assert pred_r.shape == (2, 3, 3)
    np.testing.assert_allclose(pred_r.detach().numpy(), ref["pred_r"],
                               rtol=0, atol=5e-4)
    torch.testing.assert_close(pred_r.transpose(-1, -2) @ pred_r,
                               torch.eye(3).expand(2, 3, 3), rtol=0,
                               atol=1e-5)
    pred_r.sum().backward()
    for head in ("RotBase_0", "RotBase_1"):
        grads = [p.grad for p in getattr(model.PoseNet_0, head).parameters()]
        assert all(g is not None and torch.isfinite(g).all() for g in grads)
        assert max(float(g.abs().max()) for g in grads) > 0


# --- checkpoints and tools ------------------------------------------------------------

def _bn_state(jbatch, steps=1):
    """A BN train state after `steps` steps (statistics moved)."""
    model = _bn_model()
    tx = optim.make_optimizer(TINY_BN, total_steps=TOTAL_STEPS)
    state = TrainState.create(model, tx, torch.Generator().manual_seed(0))
    step = build_train_step(model, tx, TINY_BN)
    for _ in range(steps):
        step(state, _tb(jbatch), opt_pose=False, train=True)
    return state


def test_bn_state_round_trips_through_state_pt(jbatch, tmp_path):
    state = _bn_state(jbatch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, state)
    fresh = _bn_state(jbatch, steps=0)
    assert mgr.restore(fresh) is fresh
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for name in ("mu", "nu", "slow"):
        for k, v in state.opt_state[name].items():
            assert torch.equal(fresh.opt_state[name][k], v), (name, k)
    assert fresh.step == state.step == 1

    # all or nothing: a running statistic of another shape loads nothing
    sd = torch.load(tmp_path / "ckpt" / "1" / "state.pt", weights_only=True)
    key = next(k for k in sd["model"] if k.endswith("running_var"))
    sd["model"][key] = torch.ones(3)
    other = _bn_state(jbatch, steps=0)
    before = {k: v.clone() for k, v in other.model.state_dict().items()}
    with pytest.raises(ValueError, match="running_var"):
        other.load_state_dict(sd)
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_merge_partial_params_merges_parameters_only(jbatch, tmp_path):
    """As the JAX version, which merges the checkpoint's `params` leaves:
    the running statistics stay fresh, and the count is of parameters, the
    JAX version's count on the same model."""
    state = _bn_state(jbatch)
    CheckpointManager(str(tmp_path / "port")).save(1, state)
    params, stats = _jtrees(state.model)
    jmgr = jckpt.CheckpointManager(str(tmp_path / "jax"))
    jmgr.save(1, JTrainState.create(params, joptim.make_optimizer(JTINY_BN),
                                    jax.random.PRNGKey(0),
                                    batch_stats=stats))
    _, n_jax = jmgr.merge_partial_params(params)

    fresh = _bn_model(seed=7)
    fresh_bufs = {k: v.clone() for k, v in fresh.named_buffers()}
    n = CheckpointManager(str(tmp_path / "port")).merge_partial_params(fresh)
    assert n == n_jax == len(list(fresh.parameters()))
    for k, v in fresh.named_buffers():
        assert torch.equal(v, fresh_bufs[k]), k
    saved = dict(state.model.named_parameters())
    for k, v in fresh.named_parameters():
        assert torch.equal(v, saved[k]), k


def test_save_params_npz_holds_parameters_only(jbatch, tmp_path):
    state = _bn_state(jbatch)
    path = str(tmp_path / "params.npz")
    save_params_npz(path, state.model)
    params, _ = convert.flax_trees(state.model)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(params)
        assert not any(k.endswith(("/mean", "/var")) for k in z.files)
    loaded = convert.flatten_tree(jckpt.load_params_npz(path))
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(loaded[k]), v)


def _write_config(path, extra, package):
    over = ", ".join(f"{k!r}: {v!r}" for k, v in dict(OVERRIDES,
                                                        **extra).items())
    path.write_text(
        f"from {package}.configs import schema\n"
        f"from {package}.configs.schema import HeadConfig, Gcn3dConfig\n\n"
        "def get_config():\n"
        "    return schema.override(schema.Config(dataset='synthetic'), "
        f"**{{{over}}})\n")
    return str(path)


def test_infer_params_refuses_a_bn_config(tmp_path, jbatch):
    from pose_estimation_tpu.tools import infer as jinfer
    from pose_estimation_tpu_torch.tools import infer
    npz = str(tmp_path / "params.npz")
    save_params_npz(npz, _bn_model())
    msgs = []
    for mod, pkg in ((jinfer, "pose_estimation_tpu"),
                     (infer, "pose_estimation_tpu_torch")):
        cfg = _write_config(tmp_path / f"{pkg}.py", BN, pkg)
        args = ["--config", cfg, "--synthetic", "--frames_per_object", "1",
                "--params", npz, "--output", str(tmp_path / "p.jsonl")]
        with pytest.raises(SystemExit) as e:
            mod.main(args + (["--device", "cpu"] if mod is infer else []))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "batch_stats" in msgs[1]


def test_cli_and_tools_run_every_option(tmp_path):
    """cli.py with norm="bn", train.refine, Adam and the rotation heads,
    one debug epoch; tools/infer.py --ckpt and tools/eval_standalone.py
    from its checkpoint, with the running statistics it saved."""
    from pose_estimation_tpu_torch.tools import eval_standalone, infer
    cfg = _write_config(tmp_path / "cfg.py", ALL,
                        "pose_estimation_tpu_torch")
    log_dir = tmp_path / "run"
    assert cli.main(["--config", cfg, "--synthetic", "--debug", "--epochs",
                     "1", "--frames_per_object", "3", "--log_dir",
                     str(log_dir), "--device", "cpu", "--enable_rot"]) == 0
    train = [json.loads(x) for x in (log_dir / "train.jsonl").read_text()
             .splitlines()]
    assert np.isfinite(train[0]["loss_refine"]) and train[0]["loss_add"] > 0
    assert "add_dis" in json.loads(
        (log_dir / "eval.jsonl").read_text().splitlines()[-1])
    sd = torch.load(next((log_dir / "ckpt").glob("*/state.pt")),
                    weights_only=True)
    assert any(k.endswith("running_mean") for k in sd["model"])
    assert any(k.startswith("PoseNet_0.RotBase_1") for k in sd["model"])
    assert set(sd["opt_state"]) == {"count", "mu", "nu"}

    out = tmp_path / "poses.jsonl"
    summary = infer.main(["--config", cfg, "--synthetic",
                          "--frames_per_object", "2", "--ckpt",
                          str(log_dir / "ckpt"), "--output", str(out),
                          "--batch_size", "2", "--device", "cpu",
                          "--enable_rot"])
    assert summary["frames"] == 4 == len(out.read_text().splitlines())
    got = eval_standalone.main(["--config", cfg, "--synthetic", "--ckpt",
                                str(log_dir / "ckpt"), "--max_batches", "1",
                                "--log_dir", str(tmp_path / "ev"),
                                "--device", "cpu", "--enable_rot"])
    assert got["overall"]["count"] == 2

"""The training slice against the JAX package, on the CPU, on the tiny
config of the verify recipe (fp32):

  schedules: flat-anneal (each anneal method, both warmups) and step,
      against optim.make_schedule, rtol 1e-6;
  Ranger with the global-norm clip: 8 steps (across the RAdam threshold
      at step 6 and Lookahead's sync at step 6) against make_optimizer(cfg)
      on converted parameters and gradients, for the flat-anneal, step and
      manual schedules (the manual one with lr_scale 0.6): parameters and
      moments at 1e-6 * max(1, max|ref|);
  three train steps against the JAX package's step composed from its own
      functions (KRRN.apply with train=False, krrn_loss, make_optimizer,
      TrainState.apply_gradients, the guard of train_step.py:155-168),
      parameters after each step: with opt_pose=False at 1e-4 *
      max(1, max|ref|) (measured 1.3e-5 after 3 steps); with opt_pose=True
      at 1e-4 on the pose branch (FusionNetLite, PoseNet; measured 5.8e-6)
      and 1e-3 on the leaves upstream of it (measured 5.6e-4), and the
      first step's pose-branch gradients at 1e-1 (measured 2.9e-2); the
      loss terms at rtol 1e-4, and 5e-3 with opt_pose (measured 7e-4);
  a step with a NaN in the batch: skipped_nonfinite 1, and parameters and
      optimizer state equal to the JAX package's after it;
  the training draws on their own (they cannot equal JAX's random bits):
      one PoolLayer permutation shared across the batch, flax's dropout
      scaling;
  checkpoints, the guard's escalation, the epoch sampler, the prefetcher,
      and the CLI.

Why opt_pose=True is looser: fed identical inputs, FusionNetLite's
gradients agree to 1e-6, the ConvSurface directions to bf16 precision
(test_torch_losses.test_fusion_net_lite_grad_matches_jax). In the whole
model its inputs xyz_emb and nml_emb differ by ~1e-6 (conv summation
order), which flips a few max-over-neighbour choices and bf16 roundings
of the random-weight model; the pose branch's gradient then differs by a
few percent, and that gradient flows back into the heads and the backbone.
"""

import dataclasses
import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_estimation_tpu.configs import schema as jschema
from pose_estimation_tpu.data import batching as jbatching
from pose_estimation_tpu.data.synthetic import SyntheticPoseDataset
from pose_estimation_tpu.models.krrn import KRRN as JKRRN
from pose_estimation_tpu.models import posenet as jposenet
from pose_estimation_tpu.parallel import train_step as jstep
from pose_estimation_tpu.train import optim as joptim
from pose_estimation_tpu.train.state import TrainState as JTrainState
from pose_estimation_tpu_torch import convert
from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.data import batching
from pose_estimation_tpu_torch.data.prefetch import Prefetcher
from pose_estimation_tpu_torch.models import gcn3d, posenet
from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.train import optim
from pose_estimation_tpu_torch.train.checkpoint import CheckpointManager
from pose_estimation_tpu_torch.train.guards import TrainGuard
from pose_estimation_tpu_torch.train.state import TrainState
from pose_estimation_tpu_torch.train.train_step import build_train_step

jpose = importlib.import_module("pose_estimation_tpu.losses.pose_loss")

torch.set_num_threads(1)

TINY_STAGES = ((1, 1, (8, 8)), (1, 1, (8, 8, 16)), (1, 1, (8, 8, 16, 16)))
TINY_OVERRIDES = {
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
TINY = schema.override(schema.Config(dataset="synthetic"), **TINY_OVERRIDES)
JTINY = jschema.override(jschema.Config(dataset="synthetic"),
                         **{k: (jschema.HeadConfig(**dataclasses.asdict(v))
                                if isinstance(v, schema.HeadConfig) else
                                jschema.Gcn3dConfig(**dataclasses.asdict(v))
                                if isinstance(v, schema.Gcn3dConfig) else v)
                            for k, v in TINY_OVERRIDES.items()})
TOTAL_STEPS = 40
POSE_PREFIXES = ("FusionNetLite_0/", "PoseNet_0/")


def _rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _hold(got: dict, ref: dict, tol, what=""):
    """Leaf by leaf: |got - ref| <= tol * max(1, max|ref|); `tol` may be a
    function of the leaf's key."""
    assert sorted(got) == sorted(ref)
    for k in ref:
        t = tol(k) if callable(tol) else tol
        err = _rel_err(np.asarray(got[k]), np.asarray(ref[k]))
        assert err <= t, (what, k, err, t)


# --- schedules and Ranger -----------------------------------------------------

SCHEDULES = [
    {"train.lr.scheduler": "lambda", "train.lr.anneal_method": m,
     "train.lr.warmup_method": w, "train.lr.warmup_iters": 3,
     "train.lr.anneal_point": 0.5}
    for m in ("cosine", "linear", "poly", "step") for w in ("linear", "const")
] + [{"train.lr.scheduler": "step", "train.lr.step_size": 2},
     {"train.lr.scheduler": "manual"}]


@pytest.mark.parametrize("over", SCHEDULES,
                         ids=lambda o: "-".join(str(v) for v in o.values()))
def test_schedule_matches_optim(over):
    ref = joptim.make_schedule(jschema.override(jschema.Config(), **over),
                               total_steps=20, steps_per_epoch=3)
    got = optim.make_schedule(schema.override(schema.Config(), **over),
                              total_steps=20, steps_per_epoch=3)
    for step in range(24):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6)


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


def _flax_tree(seed):
    """A parameter tree with every layout the port converts."""
    rng = np.random.RandomState(seed)
    shapes = {"A/Conv_0/kernel": (3, 3, 4, 5), "A/Conv_0/bias": (5,),
              "B/ConvTranspose_0/kernel": (4, 4, 5, 6),
              "C/Dense_0/kernel": (7, 8), "C/Dense_0/bias": (8,),
              "D/GroupNorm_0/scale": (8,), "D/GroupNorm_0/bias": (8,),
              "E/conv0/directions": (3, 12), "E/ConvLayer_0/weights": (6, 16),
              "E/ConvLayer_0/bias": (16,)}
    return _nest({k: (rng.randn(*s) * 0.3).astype(np.float32)
                  for k, s in shapes.items()})


def _grads_like(tree, seed, scale):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        (rng.randn(*p.shape) * scale).astype(np.float32)), tree)


@pytest.mark.parametrize("scheduler", ["lambda", "step", "manual"])
def test_ranger_matches_optax(scheduler):
    over = {"train.lr.scheduler": scheduler, "train.lr.lr": 1e-2,
            "train.lr.warmup_iters": 2, "train.lr.anneal_point": 0.5,
            "train.lr.step_size": 1}
    tx_ref = joptim.make_optimizer(jschema.override(jschema.Config(),
                                                    **over), total_steps=8)
    tx = optim.make_optimizer(schema.override(schema.Config(), **over),
                              total_steps=8)
    tree = _flax_tree(0)
    ref = JTrainState.create(tree, tx_ref, jax.random.PRNGKey(0))
    lr_scale = 0.6 if scheduler == "manual" else 1.0
    ref = ref.replace(lr_scale=jnp.float32(lr_scale))
    params = convert.tree_to_torch(tree)
    state = tx.init(params)
    apply = jax.jit(lambda st, g: st.apply_gradients(tx_ref, g))
    for i in range(8):
        # steps 2 and 5 carry a global norm above the clip of 10
        g = _grads_like(tree, 10 + i, 20.0 if i in (2, 5) else 0.5)
        ref = apply(ref, g)
        upd, state = tx.update(convert.tree_to_torch(g), state, params,
                               lr_scale=lr_scale)
        params = {k: p + upd[k] for k, p in params.items()}
        _hold(params, convert.tree_to_torch(ref.params), 1e-6, f"step {i}")
    assert state["count"] == int(ref.step) == 8
    _, radam, _, _, look = ref.opt_state[1]
    _hold(state["mu"], convert.tree_to_torch(radam.mu), 1e-6, "mu")
    _hold(state["nu"], convert.tree_to_torch(radam.nu), 1e-6, "nu")
    _hold(state["slow"], convert.tree_to_torch(look.slow), 1e-6, "slow")


def test_gradient_centralisation_groups_by_flax_axis0():
    """The parity trap: GC means over every flax axis but 0, which lands
    on a conv kernel's row (port dim 2) and a Dense kernel's input (dim
    1)."""
    g = _grads_like(_flax_tree(1), 2, 1.0)
    gc_ref = joptim.gradient_centralization().update(g, None)[0]
    got = {k: optim.centralise(k, v)
           for k, v in convert.tree_to_torch(g).items()}
    _hold(got, convert.tree_to_torch(gc_ref), 1e-6)


# --- train steps against the JAX composition -------------------------------------

@pytest.fixture(scope="module")
def setup():
    ds = SyntheticPoseDataset(num_objects=2, frames_per_object=2,
                              im_h=240, im_w=320, num_regions=8)
    jbatch = {k: np.asarray(v) for k, v in jbatching.make_batch(
        ds, [0, 3], jax.random.PRNGKey(0), 64, 128).items()}
    jm = JKRRN(cfg=JTINY)
    torch.manual_seed(1)            # the port's init, carried to flax
    params = _nest(convert.torch_to_flax(KRRN(TINY).state_dict()))
    tx = joptim.make_optimizer(JTINY, total_steps=TOTAL_STEPS)
    weights = jstep.loss_weights_dict(JTINY)

    @functools.partial(jax.jit, static_argnames=("opt_pose",))
    def step(state, batch, opt_pose):
        def loss_fn(p):
            out = jm.apply({"params": p}, batch["img"], batch["cloud"],
                           batch["choose"], batch["cls"], train=False,
                           opt_pose=opt_pose)
            losses = jpose.krrn_loss(out, batch, weights, opt_pose=opt_pose)
            return losses["loss"], losses

        (loss, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                             for g in jax.tree.leaves(grads)))
        finite = jnp.isfinite(loss) & jnp.isfinite(gnorm)
        grads = jax.tree.map(
            lambda g: jnp.where(finite, g, jnp.zeros_like(g)), grads)
        return (state.apply_gradients(tx, grads), losses,
                (~finite).astype(jnp.float32), grads)

    return ds, jbatch, params, step


def _port(params):
    model = convert.load_flax_params(KRRN(TINY), convert.flatten_tree(params))
    tx = optim.make_optimizer(TINY, total_steps=TOTAL_STEPS)
    state = TrainState.create(model, tx, torch.Generator().manual_seed(0))
    return state, build_train_step(model, tx, TINY)


def _tb(jbatch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in jbatch.items()}


def _pose_leaf(key):
    return key.replace(".", "/").startswith(POSE_PREFIXES)


@pytest.mark.parametrize("opt_pose", [False, True])
def test_train_steps_match_jax(setup, opt_pose):
    _, jbatch, params, jax_step = setup
    ref = JTrainState.create(params, joptim.make_optimizer(
        JTINY, total_steps=TOTAL_STEPS), jax.random.PRNGKey(0))
    state, step = _port(params)
    batch = _tb(jbatch)
    param_tol = ((lambda k: 1e-4 if _pose_leaf(k) else 1e-3) if opt_pose
                 else 1e-4)
    for i in range(3):
        ref, losses, skipped, grads = jax_step(ref, jbatch, opt_pose=opt_pose)
        if opt_pose and i == 0:
            got = convert.torch_to_flax(step.gradients(
                step.losses(batch, True, False)))
            ref_g = convert.flatten_tree(grads)
            pose = [k for k in ref_g if _pose_leaf(k)]
            _hold({k: got[k] for k in pose}, {k: ref_g[k] for k in pose},
                  1e-1, "pose-branch grads")
        m = step(state, batch, opt_pose=opt_pose, train=False)
        assert float(m["skipped_nonfinite"]) == float(skipped) == 0.0
        for k in losses:
            np.testing.assert_allclose(float(m[k]), float(losses[k]),
                                       rtol=5e-3 if opt_pose else 1e-4,
                                       atol=1e-5)
        _hold(convert.torch_to_flax(state.model.state_dict()),
              convert.flatten_tree(ref.params), param_tol,
              f"params step {i}")
    assert state.step == int(ref.step) == 3


def test_nan_step_matches_jax(setup):
    """A NaN in the image: the gradients are zeroed but the update still
    runs, so momentum moves the parameters and every count advances."""
    _, jbatch, params, jax_step = setup
    ref = JTrainState.create(params, joptim.make_optimizer(
        JTINY, total_steps=TOTAL_STEPS), jax.random.PRNGKey(0))
    state, step = _port(params)
    bad = dict(jbatch, img=jbatch["img"].copy())
    bad["img"][0, 3, 4, 1] = np.nan
    for i, b in enumerate([jbatch, bad]):
        ref, _, skipped, _ = jax_step(ref, b, opt_pose=False)
        m = step(state, _tb(b), opt_pose=False, train=False)
        assert float(m["skipped_nonfinite"]) == float(skipped) == float(i)
    assert not torch.isfinite(m["loss"])
    _hold(convert.torch_to_flax(state.model.state_dict()),
          convert.flatten_tree(ref.params), 1e-4, "params")
    _, radam, _, _, look = ref.opt_state[1]
    assert state.opt_state["count"] == int(radam.count) == int(look.count) == 2
    for name, tree in (("mu", radam.mu), ("nu", radam.nu),
                       ("slow", look.slow)):
        _hold(state.opt_state[name], convert.tree_to_torch(tree), 1e-4, name)


# --- the training draws ----------------------------------------------------------

def test_pool_layer_training_draw():
    rng = np.random.RandomState(3)
    v = torch.from_numpy(rng.randn(3, 64, 3).astype(np.float32))
    f = torch.from_numpy(rng.randn(3, 64, 5).astype(np.float32))
    pool = gcn3d.PoolLayer(4, 4, return_sample=True)
    g = torch.Generator().manual_seed(7)
    vs, fs, sample = pool(v, f, generator=g)
    want = torch.randperm(64, generator=torch.Generator().manual_seed(7))[:16]
    assert torch.equal(sample, want)            # one permutation for all
    assert torch.equal(vs, v[:, want])          # rows of the batch
    assert len(set(sample.tolist())) == 16
    inj = torch.arange(16) * 2
    assert torch.equal(pool(v, f, sample=inj, generator=g)[2], inj)
    assert torch.equal(pool(v, f)[2], torch.arange(16) * 4)    # eval


def test_tbase_dropout_follows_flax():
    """flax's TBase in training, its dropout mask read off its own
    intermediates and injected into the port: same output; and the keep
    rate of a generator draw is 1 - rate."""
    x = np.random.RandomState(4).randn(2, 40, 12).astype(np.float32)
    jm = jposenet.TBase()
    variables = jm.init(jax.random.PRNGKey(0), x)
    ref, inter = jm.apply(variables, x, train=True,
                          rngs={"dropout": jax.random.PRNGKey(5)},
                          capture_intermediates=True)
    inter = inter["intermediates"]
    pre = np.asarray(inter["MLP1d_0"]["__call__"][0])
    post = np.asarray(inter["Dropout_0"]["__call__"][0])
    keep = torch.from_numpy((post != 0) | (pre == 0))
    np.testing.assert_allclose(post[post != 0], pre[post != 0] / 0.8,
                               rtol=1e-6)
    tm = posenet.TBase(12)
    convert.load_flax_params(tm, convert.flatten_tree(variables["params"]))
    got = tm(torch.from_numpy(x), train=True, keep=keep)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    big = torch.ones(400, 1000)
    drawn = posenet.TBase(1000)
    mask = torch.rand(big.shape, generator=torch.Generator().manual_seed(1))
    assert abs(float((mask < 0.8).float().mean()) - 0.8) < 0.01
    assert drawn.rate == 0.2


def test_train_step_with_draws(setup):
    _, jbatch, params, _ = setup
    state, step = _port(params)
    before = state.generator.get_state()
    m = step(state, _tb(jbatch), opt_pose=True)
    assert float(m["skipped_nonfinite"]) == 0.0
    assert all(torch.isfinite(v) for v in m.values())
    assert not torch.equal(state.generator.get_state(), before)


# --- checkpoints, data, CLI ------------------------------------------------------

def test_checkpoint_round_trip(setup, tmp_path):
    _, jbatch, params, _ = setup
    state, step = _port(params)
    step(state, _tb(jbatch), opt_pose=True)
    state.best_dis, state.lr_scale = 0.25, 0.6
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, state, metrics={"add_dis": 0.25})
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    fresh, _ = _port(params)
    assert mgr.restore(fresh) is fresh
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for name in ("mu", "nu", "slow"):
        for k, v in state.opt_state[name].items():
            assert torch.equal(fresh.opt_state[name][k], v)
    assert fresh.opt_state["count"] == state.opt_state["count"] == 1
    assert (fresh.step, fresh.best_dis, fresh.lr_scale) == (1, 0.25, 0.6)
    assert torch.equal(fresh.generator.get_state(),
                       state.generator.get_state())
    assert CheckpointManager(str(tmp_path / "empty")).restore(fresh) is None


def test_per_object_table_matches_jax():
    """add_auc and PerObjectAccumulator against the JAX package's, on
    batches that leave one class empty and put distances past max_dis."""
    from pose_estimation_tpu.metrics import metric as jmetric
    from pose_estimation_tpu_torch.metrics import metric
    rng = np.random.RandomState(5)
    ref, got = jmetric.PerObjectAccumulator(4), metric.PerObjectAccumulator(4)
    for _ in range(3):
        cls = rng.choice([0, 1, 3], 6)
        m = {"add_dis": (rng.rand(6) * 0.15).astype(np.float32),
             "add_ok": (rng.rand(6) > 0.5).astype(np.float32)}
        ref.update(cls, m)
        got.update(cls, m)
    assert got.summary() == ref.summary()
    d = rng.rand(50) * 0.2
    assert metric.add_auc(d) == jmetric.add_auc(d)
    assert metric.add_auc(np.array([0.5])) == jmetric.add_auc(np.array([0.5]))


def test_epoch_indices_and_prefetch():
    b = batching.epoch_indices(torch.Generator().manual_seed(0), 23, 4)
    assert b.shape == (5, 4) and len(set(b.ravel().tolist())) == 20
    again = batching.epoch_indices(torch.Generator().manual_seed(0), 23, 4)
    assert np.array_equal(b, again)

    assert list(Prefetcher(iter(range(5)))) == list(range(5))

    def broken():
        yield 1
        raise KeyError("bad frame")

    stream = Prefetcher(broken())
    assert next(stream) == 1
    with pytest.raises(KeyError):
        next(stream)
    early = Prefetcher(iter(range(100)))
    assert next(early) == 0
    early.close()
    assert not early._t.is_alive()


def test_guard_checkpoints_once_and_aborts(setup, tmp_path):
    """The host policy around the step's NaN guard: an emergency
    checkpoint on the first skipped step of a run, none on the next ones,
    and the abort after max_consecutive skipped steps in a row."""
    _, _, params, _ = setup
    state, _ = _port(params)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    guard = TrainGuard(ckpt_manager=mgr)
    bad, good = {"skipped_nonfinite": 1.0}, {"skipped_nonfinite": 0.0}
    assert not guard.observe(4, bad, train_state=state)
    assert not guard.observe(5, bad, train_state=state)
    assert mgr.steps() == [4]
    assert not guard.observe(6, good, train_state=state)
    assert guard.consecutive_nonfinite == 0
    aborts = [guard.observe(7 + i, bad, train_state=state)
              for i in range(TrainGuard.max_consecutive)]
    assert aborts == [False] * (TrainGuard.max_consecutive - 1) + [True]
    assert mgr.steps() == [4, 7]


def test_cli_trains_and_evaluates(tmp_path, capsys):
    from pose_estimation_tpu_torch import cli
    cfg_file = tmp_path / "tiny.py"
    over = dict(TINY_OVERRIDES, **{"train.start_pose_epoch": 0})
    cfg_file.write_text(
        "from pose_estimation_tpu_torch.configs import schema\n"
        "from pose_estimation_tpu_torch.configs.schema import (\n"
        "    Gcn3dConfig, HeadConfig)\n"
        "def get_config():\n"
        f"    return schema.override(schema.Config(dataset='synthetic'), "
        f"**{over!r})\n")
    log_dir = tmp_path / "run"
    assert cli.main(["--config", str(cfg_file), "--synthetic", "--debug",
                     "--epochs", "1", "--frames_per_object", "3",
                     "--log_dir", str(log_dir), "--device", "cpu"]) == 0
    train = [json.loads(x) for x in
             (log_dir / "train.jsonl").read_text().splitlines()]
    assert train and {"loss", "loss_add", "skipped_nonfinite"} <= set(train[0])
    assert train[0]["loss_add"] > 0                  # the pose branch ran
    evals = [json.loads(x) for x in
             (log_dir / "eval.jsonl").read_text().splitlines()]
    assert len(evals) == 1 and evals[0]["count"] == 6
    assert np.isfinite(evals[0]["add_dis"])
    assert "add_dis" in capsys.readouterr().out
    assert CheckpointManager(str(log_dir / "ckpt")).latest_step() == 3

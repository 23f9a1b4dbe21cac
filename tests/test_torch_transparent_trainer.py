"""The transparent trainer's loop against the JAX TransparentTrainer on the
CPU, driving both with one tiny model (two Dense layers, the same
parameters through convert) so that the loop, not the network, is what is
held:

  the NaN guard: a NaN parameter makes every step non-finite; both
      trainers abort at the step the guard's 20th observation names
      (state.step 20), save their one emergency checkpoint under step 1
      holding the state after step 1, and end with the same parameters
      (NaN where the JAX ones are) and Ranger state (count 20, the moments
      and slow weights at 1e-6); an epoch of one non-finite step is
      observed (its emergency checkpoint saved, the count at 1) in both;
  the eval's dataset: the port's TransparentTrainer(cfg, train,
      test_dataset=X).test_epoch equals the JAX TransparentTrainer(cfg,
      X).test_epoch (add_dis at 1e-5, the per-object counts equal) on
      tests/mp_worker.py's split (15 training frames, 9 test frames drawn
      with pose_seed=11); the JAX trainer given the same test_dataset
      scores its training frames instead (the one place the port departs
      from it on purpose; README, caveats).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pose_estimation_tpu.configs import schema as jschema
from pose_estimation_tpu.data import synthetic as jsyn
from pose_estimation_tpu.parallel.mesh import replicated
from pose_estimation_tpu.train import transparent_trainer as jtt
from pose_estimation_tpu.train.checkpoint import CheckpointManager as JManager
from pose_estimation_tpu.train.state import TrainState as JTrainState
from pose_estimation_tpu_torch import convert
from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.data import synthetic as tsyn
from pose_estimation_tpu_torch.models.layers import Dense, Named
from pose_estimation_tpu_torch.train.checkpoint import CheckpointManager
from pose_estimation_tpu_torch.train.transparent_trainer import (
    TransparentTrainer)

torch.set_num_threads(1)

NUM_POINTS, NUM_OBJ, CROP, WIDTH = 4, 3, 16, 8


class JTiny(fnn.Module):
    """A TRPESNet-shaped stand-in: per-pixel features and a pooled head."""

    num_points: int = NUM_POINTS

    @fnn.compact
    def __call__(self, img, intrinsic, xmap, ymap, d_scale, obj,
                 train: bool = False):
        b = img.shape[0]
        feat = fnn.Dense(WIDTH)(img)
        head = fnn.Dense(self.num_points * 8)(feat.mean((1, 2))).reshape(
            b, self.num_points, 8)
        return (head[..., :4], head[..., 4:7] * 0.01 + jnp.array(
                    [0.0, 0.0, 0.8]), jax.nn.sigmoid(head[..., 7:]),
                feat[..., :3], feat[..., 3:4], jax.nn.sigmoid(feat[..., 4:5]))


class Tiny(Named):
    """JTiny in the port: the TRPESNet interface, the pixels unused."""

    def __init__(self):
        super().__init__()
        self.num_points = NUM_POINTS
        self.child(Dense(3, WIDTH))
        self.child(Dense(WIDTH, NUM_POINTS * 8))

    def forward(self, img, intrinsic, xmap, ymap, d_scale, obj, choose=None):
        b = img.shape[0]
        feat = self.Dense_0(img)
        head = self.Dense_1(feat.mean((1, 2))).reshape(b, NUM_POINTS, 8)
        return (head[..., :4], head[..., 4:7] * 0.01 + torch.tensor(
                    [0.0, 0.0, 0.8]), torch.sigmoid(head[..., 7:]),
                feat[..., :3], feat[..., 3:4], torch.sigmoid(feat[..., 4:5]))


def _config(pkg, **over):
    return pkg.override(pkg.transparent_cleargrasp(), **{
        "module.num_cls": NUM_OBJ, "data.num_points": 32,
        "data.input_size": CROP, "train.batch_size": 1, "train.amp": False,
        "train.ckpt_every": 0, "train.lr.warmup_iters": 0, "mesh.data": 1,
        **over})


def _datasets(pkg, frames_per_object, **kw):
    return pkg.SyntheticTransparentDataset(
        num_objects=NUM_OBJ, frames_per_object=frames_per_object, im_h=120,
        im_w=160, num_regions=8, cache_frames=True, **kw)


def _tiny_params(nan: bool) -> dict:
    rng = np.random.RandomState(0)
    flat = {"Dense_0/kernel": rng.randn(3, WIDTH) * 0.5,
            "Dense_0/bias": rng.randn(WIDTH) * 0.1,
            "Dense_1/kernel": rng.randn(WIDTH, NUM_POINTS * 8) * 0.5,
            "Dense_1/bias": rng.randn(NUM_POINTS * 8) * 0.1}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    if nan:
        flat["Dense_1/kernel"][2, 5] = np.nan
    return flat


def _nest(flat: dict) -> dict:
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _port_trainer(cfg, ds, log_dir, flat, test_dataset=None):
    tr = TransparentTrainer(cfg, ds, test_dataset=test_dataset,
                            log_dir=str(log_dir),
                            model=convert.load_flax_params(Tiny(), flat),
                            device="cpu")
    tr.init_state()
    return tr


def _jax_trainer(cfg, ds, log_dir, flat):
    tr = jtt.TransparentTrainer(cfg, ds, log_dir=str(log_dir), model=JTiny())
    tr.init_state()
    tr.state = jax.device_put(JTrainState.create(
        _nest(flat), tr.tx, jax.random.PRNGKey(0)), replicated(tr.mesh))
    return tr


def _equal_with_nan(got, ref, tol, name):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=name)
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=tol, atol=tol,
                               err_msg=name)


@pytest.fixture(scope="module")
def nan_runs(tmp_path_factory):
    """Both trainers from the NaN parameters over one epoch of 24 steps
    (aborted), and over an epoch of one step."""
    tmp = tmp_path_factory.mktemp("guard")
    cfg, jcfg = _config(schema), _config(jschema)
    ds, jds = _datasets(tsyn, 8), _datasets(jsyn, 8)
    flat = _tiny_params(nan=True)
    runs = {}
    for name, steps in (("abort", None), ("one", 1)):
        port = _port_trainer(cfg, ds, tmp / f"port_{name}", flat)
        port.train_epoch(0, steps)
        ref = _jax_trainer(jcfg, jds, tmp / f"jax_{name}", flat)
        ref.train_epoch(0, steps)
        runs[name] = (port, ref, tmp / f"port_{name}", tmp / f"jax_{name}")
    return runs


def test_guard_aborts_at_the_jax_step(nan_runs):
    port, ref, _, _ = nan_runs["abort"]
    assert len(port.dataset) == 24
    assert port.state.step == int(ref.state.step) == 20
    assert port.guard.consecutive_nonfinite == \
        ref.guard.state.consecutive_nonfinite == 20


def test_guard_emergency_checkpoint_matches_jax(nan_runs):
    port, ref, port_dir, jax_dir = nan_runs["abort"]
    ckpt = CheckpointManager(str(port_dir / "ckpt"))
    jckpt = JManager(str(jax_dir / "ckpt"))
    assert ckpt.steps() == list(jckpt.mgr.all_steps()) == [1]
    restored = jckpt.restore(ref.state)
    assert ckpt.read(1)["step"] == int(restored.step) == 1


def test_guard_abort_state_matches_jax(nan_runs):
    port, ref, _, _ = nan_runs["abort"]
    params = convert.torch_to_flax(dict(port.model.named_parameters()))
    for k, v in convert.flatten_tree(ref.state.params).items():
        _equal_with_nan(params[k], v, 1e-6, k)
    _, radam, _, _, look = ref.state.opt_state[1]
    assert port.state.opt_state["count"] == int(radam.count) == 20
    for name, tree in (("mu", radam.mu), ("nu", radam.nu),
                       ("slow", look.slow)):
        want = convert.tree_to_torch(tree)
        for k, v in port.state.opt_state[name].items():
            _equal_with_nan(v.numpy(), want[k].numpy(), 1e-6, (name, k))


def test_guard_observes_the_last_step_of_an_epoch(nan_runs):
    port, ref, port_dir, jax_dir = nan_runs["one"]
    assert port.state.step == int(ref.state.step) == 1
    assert port.guard.consecutive_nonfinite == \
        ref.guard.state.consecutive_nonfinite == 1
    assert CheckpointManager(str(port_dir / "ckpt")).steps() == list(
        JManager(str(jax_dir / "ckpt")).mgr.all_steps()) == [1]


def test_eval_reads_the_test_dataset(tmp_path):
    """tests/mp_worker.py's split; the JAX trainer's eval of X is the JAX
    TransparentTrainer(cfg, X)'s (whose training set is X)."""
    cfg = _config(schema, **{"train.batch_size": 4})
    jcfg = _config(jschema, **{"train.batch_size": 4})
    train, test = _datasets(tsyn, 5), _datasets(tsyn, 3, pose_seed=11)
    jtrain, jtest = _datasets(jsyn, 5), _datasets(jsyn, 3, pose_seed=11)
    assert len(train) == 15 and len(test) == 9
    flat = _tiny_params(nan=False)
    got = _port_trainer(cfg, train, tmp_path / "port", flat,
                        test_dataset=test).test_epoch(0)
    ref = _jax_trainer(jcfg, jtest, tmp_path / "jax", flat).test_epoch(0)
    jax_on_train = _jax_trainer(jcfg, jtrain, tmp_path / "jax_train", flat)
    jax_on_train.test_dataset = jtest
    other = jax_on_train.test_epoch(0)
    assert got["overall"]["count"] == ref["overall"]["count"] == 9
    np.testing.assert_allclose(got["overall"]["add_dis"],
                               ref["overall"]["add_dis"], rtol=1e-5)
    assert {k: v["count"] for k, v in got["per_object"].items()} == \
        {k: v["count"] for k, v in ref["per_object"].items()}
    for k, v in ref["per_object"].items():
        np.testing.assert_allclose(got["per_object"][k]["add_dis"],
                                   v["add_dis"], rtol=1e-5, err_msg=k)
    assert not np.isclose(other["overall"]["add_dis"],
                          ref["overall"]["add_dis"], rtol=1e-3)

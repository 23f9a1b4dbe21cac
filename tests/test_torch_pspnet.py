"""The PSPNet generation's modules (models/pspnet.py) and the layers it
needs against the JAX package on the CPU (fp32), on the same numpy inputs
and converted parameters:

  Conv with kernel_dilation 2 and 4 (SAME over the dilated extent)
      against flax nn.Conv, the SAME 3x3 stride-2 max-pool at even and
      odd sizes against nn.max_pool (XLA pads (0, 1) with -inf on an even
      input), resize_bilinear at 3 -> 32 and 6 -> 32 (non-integer ratios)
      against jax.image.resize: 1e-5 x max(1, max|ref|);
  PSPModule at 13 x 13 features (the remainder dropped, a non-integer
      resize) and 32 x 32 (the full crop's map): 1e-4 x max(1, max|ref|);
  TransparentPoseNet at 48-px crops (6 x 6 features), num_points 32, 3
      objects: its parameter tree key for key and shape for shape the one
      the JAX model initialises (jax.eval_shape), flax -> torch -> flax
      bit for bit; the eval forward (every output, each object's heads)
      and the train forward with the pixels and the seven dropout masks
      handed to both (the JAX model's bernoulli draws replaced while it
      runs): 1e-4 x max(1, max|ref|) (measured ~8e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict

import torch_transparent_worker as W
from pose_estimation_tpu.models import layers as jlayers
from pose_estimation_tpu.models import pspnet as jpsp
from pose_estimation_tpu_torch import convert
from pose_estimation_tpu_torch.models import layers, pspnet

torch.set_num_threads(1)

INPUTS = ("img", "intrinsic", "xmap", "ymap", "d_scale", "obj")


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, tol)
    return err


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _nest(flat: dict) -> dict:
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


# --- layers -----------------------------------------------------------------

@pytest.mark.parametrize("dilation,stride,size",
                         [(2, 1, 12), (4, 1, 12), (2, 1, 9), (1, 2, 12)])
def test_dilated_conv_matches_flax(dilation, stride, size):
    x = np.random.RandomState(dilation).randn(2, size, size, 5).astype(
        np.float32)
    conv = fnn.Conv(6, (3, 3), strides=(stride, stride),
                    kernel_dilation=(dilation, dilation), use_bias=False)
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = conv.apply(variables, jnp.asarray(x))
    port = layers.Conv(5, 6, 3, stride, False, dilation=dilation)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.asarray(
            variables["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        got = port(_nchw(x))
    _close(_nhwc(got), ref, 1e-5)


@pytest.mark.parametrize("size", [12, 13, 24, 25])
def test_max_pool_same_matches_flax(size):
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(np.float32)
    x[:, 0, :] = -50.0                 # the padded edge must never win
    ref = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                       padding="SAME")
    _close(_nhwc(layers.max_pool_same(_nchw(x))), ref, 1e-5)


@pytest.mark.parametrize("src", [3, 6])
def test_resize_bilinear_non_integer_ratio_matches_jax(src):
    x = np.random.RandomState(src).randn(2, src, src, 4).astype(np.float32)
    ref = jlayers.resize_bilinear(jnp.asarray(x), 32, 32)
    _close(_nhwc(layers.resize_bilinear(_nchw(x), 32, 32)), ref, 1e-5)


@pytest.mark.parametrize("size", [13, 32])
def test_psp_module_matches_jax(size):
    """The pyramid's windows of h // s pixels at stride h // s (13: 13, 6,
    4 and 2 pixels, the remainder dropped), not adaptive pooling."""
    c = 16
    x = np.random.RandomState(size).rand(2, size, size, c).astype(np.float32)
    jm = jpsp.PSPModule(out_features=24)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = jm.apply(variables, jnp.asarray(x))
    port = pspnet.PSPModule(c, 24)
    convert.load_flax_params(port, {"/".join(k): np.asarray(v) for k, v in
                                    flatten_dict(variables["params"]).items()})
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), ref, 1e-4)
    # not the adaptive pool: at 13 the size-6 windows are 2 pixels wide
    pooled = torch.nn.functional.avg_pool2d(_nchw(x), 2, 2)
    adaptive = torch.nn.functional.adaptive_avg_pool2d(_nchw(x), 6)
    if size == 13:
        assert not torch.allclose(pooled, adaptive)


def test_psp_module_refuses_a_map_under_the_pyramid():
    with pytest.raises(ValueError, match="48 px"):
        pspnet.PSPModule(8, 8)(torch.zeros(1, 8, 4, 4))


# --- the model ----------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """The port's seeded tiny TransparentPoseNet (W.posenet_setup), its
    parameters as flax's tree, the JAX model and the batch."""
    state, _ = W.posenet_setup()
    flat = convert.torch_to_flax(dict(state.model.named_parameters()))
    jm = jpsp.TransparentPoseNet(num_obj=W.NUM_OBJ, num_points=W.NUM_POINTS)
    return state.model, flat, jm, W.posenet_batch()


def _eval_choose(b):
    hw = W.PSP_CROP ** 2
    stride = max(hw // W.NUM_POINTS, 1)
    return np.broadcast_to(np.arange(W.NUM_POINTS) * stride % hw,
                           (b, W.NUM_POINTS)).astype(np.int32)


def test_pspnet_flax_tree_both_ways(model):
    tm, flat, jm, batch = model
    shapes = jax.eval_shape(
        jm.init, {"params": jax.random.PRNGKey(0)},
        *[jnp.asarray(batch[k]) for k in INPUTS],
        jnp.asarray(_eval_choose(W.GLOBAL_BS)))["params"]
    want = {"/".join(k): tuple(v.shape)
            for k, v in flatten_dict(shapes).items()}
    assert {k: v.shape for k, v in flat.items()} == want
    for k in ("ResNet18Stride8_0/ResNetBlock_7/Conv_1/kernel",
              "ResNet18Stride8_0/ResNetBlock_2/ConvNorm_0/Conv_0/kernel",
              "PSPModule_0/Conv_4/bias",
              "PSPDecoder_0/PSPUpsample_8/prelu_alpha",
              "PointFeatNet_0/Dense_9/kernel",
              "PosePredNet_0/Dense_11/kernel", "GeoNet_0/Conv_1/kernel"):
        assert k in want, k
    assert want["PSPDecoder_0/PSPUpsample_0/prelu_alpha"] == ()
    back = convert.torch_to_flax(
        convert.flax_to_torch(flat, pspnet.TransparentPoseNet(
            W.NUM_OBJ, W.NUM_POINTS)))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("obj", [0, 1, 2])
def test_pspnet_eval_forward_matches_jax(model, obj):
    tm, flat, jm, batch = model
    batch = dict(batch, obj=np.full(W.GLOBAL_BS, obj, np.int32))
    choose = _eval_choose(W.GLOBAL_BS)
    ref = jm.apply({"params": _nest(flat)},
                   *[jnp.asarray(batch[k]) for k in INPUTS],
                   jnp.asarray(choose))
    with torch.no_grad():
        got = tm(*[torch.from_numpy(batch[k]) for k in INPUTS],
                 torch.from_numpy(choose))
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        _close(got[k].numpy(), r, 1e-4)


def test_pspnet_train_forward_with_the_draws_handed_over(model, monkeypatch):
    """The pixels (repeats included) and the seven dropout masks of the
    train step, given to both; the masks reach JAX through its
    bernoulli, in flax's trace order, each of the shape flax asks."""
    tm, flat, jm, batch = model
    choose, masks = W.posenet_draws()
    queue = [np.transpose(m, (0, 2, 3, 1)) for m in masks]

    def bernoulli(key, p=0.5, shape=None):
        m = queue.pop(0)
        assert m.shape == tuple(shape)
        return jnp.asarray(m)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    ref = jm.apply({"params": _nest(flat)},
                   *[jnp.asarray(batch[k]) for k in INPUTS],
                   jnp.asarray(choose), train=True,
                   rngs={"dropout": jax.random.PRNGKey(3)})
    assert not queue
    with torch.no_grad():
        got = tm(*[torch.from_numpy(batch[k]) for k in INPUTS],
                 torch.from_numpy(choose),
                 [torch.from_numpy(m) for m in masks])
        plain = tm(*[torch.from_numpy(batch[k]) for k in INPUTS],
                   torch.from_numpy(choose))
    for k, r in ref.items():
        _close(got[k].numpy(), r, 1e-4)
    assert not torch.allclose(got["quat"], plain["quat"])

"""The port's model modules against the flax modules, fp32, on the tiny
config of the verify recipe: same params (JAX-initialised, converted by
pose_estimation_tpu_torch.convert), same seeded inputs, max |delta| <=
1e-4 * max(1, max |ref|). Also pins the conversion traps: flax's
unflipped ConvTranspose kernel, XLA's asymmetric stride-2 'SAME' padding,
flax's GroupNorm epsilon, jax.image.resize vs F.interpolate.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pose_estimation_tpu.configs import schema
from pose_estimation_tpu.models import fusion as jfusion
from pose_estimation_tpu.models import gcn3d as jgcn3d
from pose_estimation_tpu.models import hrnet as jhrnet
from pose_estimation_tpu.models import krrn as jkrrn
from pose_estimation_tpu.models import layers as jlayers
from pose_estimation_tpu.models import posenet as jposenet
from pose_estimation_tpu_torch import convert
from pose_estimation_tpu_torch.models import fusion, gcn3d, hrnet, krrn
from pose_estimation_tpu_torch.models import layers, posenet

torch.set_num_threads(1)

TINY_STAGES = ((1, 1, (8, 8)), (1, 1, (8, 8, 16)), (1, 1, (8, 8, 16, 16)))
TINY = schema.override(schema.Config(), **{
    "module.num_cls": 2, "data.num_regions": 8, "data.num_points": 128,
    "data.input_size": 64, "module.backbone_outc": 16,
    "module.stem_width": 8, "module.hrnet_stages": TINY_STAGES,
    "module.xyznet": schema.HeadConfig(hidden=16),
    "module.nmlnet": schema.HeadConfig(hidden=16),
    "module.gcn3d": schema.Gcn3dConfig(neighbor_num=4, support_num=2),
    "train.amp": False})


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def port(jmod, tmod, *args, seed=0):
    """Init the flax module on `args`, load its params into the torch
    module; returns (flax apply fn, params)."""
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed),
                                *[jnp.asarray(a) for a in args])["params"]
    convert.load_flax_params(tmod, flat(params))
    tmod.eval()
    return params


def close(got, ref, scale=1e-4):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    tol = scale * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (err, tol)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).permute(
        0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


RNG = np.random.RandomState


# --- converter ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_krrn():
    rng = RNG(0)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    cloud = (rng.randn(2, 128, 3) * 0.05 + [0, 0, 0.8]).astype(np.float32)
    choose = rng.randint(0, 64 * 64, (2, 128)).astype(np.int32)
    cls = np.array([0, 1], np.int32)
    jm = jkrrn.KRRN(cfg=TINY)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x, cloud, choose,
                              cls)["params"]
    return jm, params, (x, cloud, choose, cls)


def test_converter_round_trip(tiny_krrn):
    _, params, _ = tiny_krrn
    src = flat(params)
    model = krrn.KRRN(TINY)
    convert.load_flax_params(model, src)
    back = convert.torch_to_flax(model.state_dict())
    assert sorted(back) == sorted(src)
    for k in src:
        np.testing.assert_array_equal(back[k], src[k], err_msg=k)


def test_converter_is_strict(tiny_krrn):
    _, params, _ = tiny_krrn
    src = flat(params)
    model = krrn.KRRN(TINY)
    extra = dict(src, **{"HRNet_0/Conv_9/bias": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        convert.flax_to_torch(extra, model)
    missing = dict(src)
    missing.pop("PoseNet_0/TBase_0/Dense_0/bias")
    with pytest.raises(KeyError):
        convert.flax_to_torch(missing, model)
    bad = dict(src)
    bad["PoseNet_0/TBase_0/Dense_0/bias"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError):
        convert.flax_to_torch(bad, model)
    with pytest.raises(KeyError):
        convert.flax_to_torch({"Conv_0/mystery": np.zeros(1)})


# --- conversion traps --------------------------------------------------------

@pytest.mark.parametrize("kernel", [3, 4])
def test_conv_transpose_kernel_is_flipped(kernel):
    x = RNG(1).randn(2, 5, 6, 4).astype(np.float32)
    jm = fnn.ConvTranspose(6, (kernel, kernel), strides=(2, 2),
                           padding="SAME", use_bias=False)
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    ref = jm.apply({"params": params}, x)
    tm = layers.ConvTranspose(4, 6, kernel)
    tm.weight.data = convert.flax_to_torch(
        {"ConvTranspose_0/kernel": np.asarray(params["kernel"])})[
            "ConvTranspose_0.weight"]
    close(nhwc(tm(nchw(x))), ref, 1e-5)
    # the unflipped kernel is the trap: it does not match
    unflipped = torch.from_numpy(np.ascontiguousarray(
        np.asarray(params["kernel"]).transpose(2, 3, 0, 1)))
    y = F.conv_transpose2d(nchw(x), unflipped, None, 2, kernel - 1 - tm.lo)
    assert np.abs(nhwc(y[:, :, :10, :12]).numpy() - np.asarray(ref)).max() > 1e-2


def test_stride2_same_padding_is_asymmetric():
    x = RNG(2).randn(2, 8, 8, 3).astype(np.float32)
    jm = fnn.Conv(5, (3, 3), strides=(2, 2), use_bias=False)
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    ref = jm.apply({"params": params}, x)
    tm = layers.Conv(3, 5, 3, 2, bias=False)
    tm.weight.data = convert.flax_to_torch(
        {"Conv_0/kernel": np.asarray(params["kernel"])})["Conv_0.weight"]
    close(nhwc(tm(nchw(x))), ref, 1e-5)
    sym = F.conv2d(nchw(x), tm.weight, None, 2, 1)           # torch's (1, 1)
    assert np.abs(nhwc(sym).detach().numpy() - np.asarray(ref)).max() > 1e-2


@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (2, 12, 8)])
def test_groupnorm_matches_flax_eps(shape):
    # small variance: torch's default eps (1e-5) would show
    x = (RNG(3).randn(*shape) * 3e-3).astype(np.float32)
    jm = fnn.GroupNorm(num_groups=4)
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    ref = jm.apply({"params": params}, x)
    tm = layers.GroupNorm(4, 8)
    arg = torch.from_numpy(x) if len(shape) == 3 else nchw(x)
    got = tm(arg)
    got = got if len(shape) == 3 else nhwc(got)
    close(got, ref, 1e-5)
    gn = torch.nn.GroupNorm(4, 8)                      # eps 1e-5
    dflt = (gn(arg.transpose(1, 2)).transpose(1, 2) if len(shape) == 3
            else nhwc(gn(arg)))
    assert np.abs(dflt.detach().numpy() - np.asarray(ref)).max() > 1e-3


@pytest.mark.parametrize("ratio", [2, 4, 8])
def test_resize_bilinear_matches_jax_image(ratio):
    x = RNG(4).randn(2, 4, 5, 3).astype(np.float32)
    ref = jlayers.resize_bilinear(jnp.asarray(x), 4 * ratio, 5 * ratio)
    got = layers.resize_bilinear(nchw(x), 4 * ratio, 5 * ratio)
    close(nhwc(got), ref, 1e-6)


# --- layers, HRNet, heads ----------------------------------------------------

LAYER_CASES = {
    "convnorm_s2": (lambda: jlayers.ConvNorm(8, 3, 2),
                    lambda: layers.ConvNorm(6, 8, 3, 2), (2, 8, 8, 6)),
    "basicblock_proj": (lambda: jlayers.BasicBlock(8),
                        lambda: layers.BasicBlock(4, 8), (2, 8, 8, 4)),
    "bottleneck": (lambda: jlayers.Bottleneck(4),
                   lambda: layers.Bottleneck(8, 4), (2, 8, 8, 8)),
    "convtransposenorm": (lambda: jlayers.ConvTransposeNorm(8, 4),
                          lambda: layers.ConvTransposeNorm(6, 8, 4),
                          (2, 5, 5, 6)),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layers(case):
    jf, tf, shape = LAYER_CASES[case]
    x = RNG(5).randn(*shape).astype(np.float32)
    jm, tm = jf(), tf()
    params = port(jm, tm, x)
    close(nhwc(tm(nchw(x))), jm.apply({"params": params}, x))


def test_mlp1d():
    x = RNG(6).randn(2, 16, 12).astype(np.float32)
    jm = jlayers.MLP1d((32, 16, 8), final_act=True)
    tm = layers.MLP1d(12, (32, 16, 8), final_act=True)
    params = port(jm, tm, x)
    close(tm(torch.from_numpy(x)), jm.apply({"params": params}, x))


def test_hrnet_tiny():
    x = RNG(7).rand(2, 64, 64, 3).astype(np.float32)
    jm = jhrnet.HRNet(backbone_outc=16, stages=TINY_STAGES, stem_width=8)
    tm = hrnet.HRNet(3, 16, TINY_STAGES, 8)
    params = port(jm, tm, x)
    rq, rh = jm.apply({"params": params}, x)
    with torch.no_grad():
        gq, gh = tm(nchw(x))
    close(nhwc(gq), rq)
    close(nhwc(gh), rh)


@pytest.mark.parametrize("head", ["xyz", "nml"])
def test_krrn_heads(head):
    if head == "xyz":
        x = RNG(8).randn(2, 16, 16, 16).astype(np.float32)
        jm, tm = jkrrn.XYZHead(16, 18), krrn.XYZHead(16, 16, 18)
    else:
        x = RNG(9).randn(2, 32, 32, 16).astype(np.float32)
        jm, tm = jkrrn.NMLHead(16, 6), krrn.NMLHead(16, 16, 6)
    params = port(jm, tm, x)
    with torch.no_grad():
        close(nhwc(tm(nchw(x))), jm.apply({"params": params}, x))


def test_select_class_and_gather_pixels():
    rng = RNG(10)
    maps = rng.randn(3, 8, 8, 12).astype(np.float32)
    cls = np.array([0, 3, 2], np.int32)
    choose = rng.randint(0, 64, (3, 20)).astype(np.int32)
    ref = jkrrn._gather_pixels(jkrrn._select_class(maps, cls, 4), choose)
    got = krrn._gather_pixels(krrn._select_class(
        torch.from_numpy(maps), torch.from_numpy(cls), 4),
        torch.from_numpy(choose))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --- 3D-GCN ------------------------------------------------------------------

def _cloud(seed, b=2, n=64):
    return (RNG(seed).randn(b, n, 3) * 0.05).astype(np.float32)


def test_conv_surface():
    v = _cloud(11)
    idx = np.asarray(jax.jit(lambda a: jnp.argsort(a)[..., :4])(
        RNG(12).rand(2, 64, 64))).astype(np.int32)
    jm = jgcn3d.ConvSurface(8, 3)
    tm = gcn3d.ConvSurface(8, 3)
    params = port(jm, tm, idx, v)
    ref = jm.apply({"params": params}, idx, v)
    close(tm(torch.from_numpy(idx), torch.from_numpy(v)), ref)


@pytest.mark.parametrize("in_ch,point_dim", [(12, 3), (40, 3), (12, 9)])
def test_conv_layer(in_ch, point_dim):
    """Narrow (in_ch < S*O = 24) and wide paths; 9-D fuse directions."""
    rng = RNG(13)
    v = (rng.randn(2, 48, point_dim) * 0.05).astype(np.float32)
    f = rng.randn(2, 48, in_ch).astype(np.float32)
    idx = rng.randint(0, 48, (2, 48, 4)).astype(np.int32)
    jm = jgcn3d.ConvLayer(8, 3, point_dim=point_dim)
    tm = gcn3d.ConvLayer(in_ch, 8, 3, point_dim=point_dim)
    assert tm.narrow == (in_ch < 24)
    params = port(jm, tm, idx, v, f)
    ref = jm.apply({"params": params}, idx, v, f)
    with torch.no_grad():
        close(tm(torch.from_numpy(idx), torch.from_numpy(v),
                 torch.from_numpy(f)), ref)


@pytest.mark.parametrize("random_sample", [False, True])
def test_pool_layer(random_sample):
    v = _cloud(14, n=64)
    f = RNG(15).randn(2, 64, 6).astype(np.float32)
    jm = jgcn3d.PoolLayer(4, 4, return_sample=True)
    if random_sample:
        key = jax.random.PRNGKey(3)
        rv, rf, rs = jm.apply({}, v, f, rngs={"pool": key})
        sample = torch.from_numpy(np.asarray(rs))
    else:
        rv, rf, rs = jm.apply({}, v, f)
        sample = None
    tv, tf, ts = gcn3d.PoolLayer(4, 4, return_sample=True)(
        torch.from_numpy(v), torch.from_numpy(f), sample=sample)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(rf))


def test_fusion_net_lite():
    rng = RNG(16)
    v = (rng.randn(2, 128, 3) * 0.05 + [0, 0, 0.8]).astype(np.float32)
    xyz = rng.rand(2, 128, 3).astype(np.float32)
    nml = rng.randn(2, 128, 3).astype(np.float32)
    nml /= np.linalg.norm(nml, axis=-1, keepdims=True)
    jm = jfusion.FusionNetLite(neighbor_num=4, support_num=2)
    tm = fusion.FusionNetLite(4, 2)
    params = port(jm, tm, v, xyz, nml)
    ref = jax.jit(jm.apply)({"params": params}, v, xyz, nml)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (v, xyz, nml)))
    close(got, ref)


def test_posenet_tbase():
    x = RNG(17).randn(2, 32, 40).astype(np.float32)
    jm = jposenet.PoseNet()
    tm = posenet.PoseNet(40)
    params = port(jm, tm, x)
    _, _, ref = jm.apply({"params": params}, x)
    with torch.no_grad():
        close(tm(torch.from_numpy(x))[2], ref)


def test_krrn_tiny_maps(tiny_krrn):
    jm, params, inputs = tiny_krrn
    tm = krrn.KRRN(TINY)
    convert.load_flax_params(tm, flat(params))
    ref = jax.jit(jm.apply)({"params": params}, *inputs)
    with torch.no_grad():
        got = tm.eval()(*(torch.from_numpy(a) for a in inputs))
    for k in ("xyz", "region", "mask", "xyz_emb"):
        close(got[k], ref[k])

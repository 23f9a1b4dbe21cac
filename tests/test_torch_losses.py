"""The training slice's numerics against the JAX package, on the CPU, fp32
unless said:

  kernel 4 (nearest source point): the plain version against
      neighbors.min_dists and _min_dists_pallas(interpret=True) at rtol
      1e-5 and atol 1e-5 (tests/test_pointops.py holds the Pallas kernel
      at atol 1e-3), indices against neighbors.nearest_index exactly; the
      min_dists autograd.Function's gradient against jax.grad for both
      clouds, coincident points included, at 1e-5;
  map_loss (l1, cosine, ce) and krrn_loss on a mixed symmetric /
      non-symmetric batch: values and gradients with respect to the model
      outputs at 1e-5;
  kernels 1 and 2 as trained: autograd through the plain versions, and
      the autograd.Functions' own backward (their forward fed by the plain
      version, since the kernels run only on a card), against jax.vjp of
      pallas_gcn._linear_multi_xla (1e-5) and _surface_multi_xla (bf16:
      the XLA form computes the surface aggregate in bf16, so its
      gradient holds to bf16 precision, 2^-7 * max(1, max|ref|)).
Inputs avoid exactly tied minima: JAX splits a gradient between them,
torch.min gives it to the lower index.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_estimation_tpu.core.pointops import neighbors as jnb
from pose_estimation_tpu.ops import pallas_gcn as pg
from pose_estimation_tpu.ops import pallas_pointops as pp
from pose_estimation_tpu_torch.losses import map_loss, pose_loss
from pose_estimation_tpu_torch.ops import gcn, pointops

# the package re-exports functions of the same names as these modules
jmap = importlib.import_module("pose_estimation_tpu.losses.map_loss")
jpose = importlib.import_module("pose_estimation_tpu.losses.pose_loss")

torch.set_num_threads(1)

RNG = np.random.RandomState


def _clouds(seed, b=2, n=300, m=200, coincide=0):
    """Unit-scale clouds, as tests/test_pointops.py uses: the expanded
    form |t|^2 + |s|^2 - 2 t.s loses ~ulp(|t|^2) to cancellation, so two
    summation orders agree on a distance to ~ulp(|t|^2) / dist (measured
    <= 7.7e-6 absolute here), which the atol of 1e-5 covers."""
    rng = RNG(seed)
    t = rng.randn(b, n, 3).astype(np.float32)
    s = rng.randn(b, m, 3).astype(np.float32)
    t[:, :coincide] = s[:, :coincide]          # closer than eps: distance 0
    return t, s


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


# --- kernel 4: nearest source point -------------------------------------------

@pytest.mark.parametrize("n,m", [(300, 200), (64, 700), (257, 513)])
def test_nearest_plain_matches_xla_and_pallas(n, m):
    t, s = _clouds(n + m, n=n, m=m)
    dist, idx = pointops.nearest(torch.from_numpy(t), torch.from_numpy(s))
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32
    _close(dist, jnb.min_dists(jnp.asarray(t), jnp.asarray(s)), 1e-5)
    _close(dist, pp._min_dists_pallas(jnp.asarray(t), jnp.asarray(s),
                                      interpret=True), 1e-5)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jnb.nearest_index(jnp.asarray(t),
                                                  jnp.asarray(s))))
    assert pointops.min_dists(torch.from_numpy(t),
                              torch.from_numpy(s)).equal(dist)


def test_nearest_index_ties_go_to_the_lower_index():
    rng = RNG(3)
    s = rng.randn(1, 30, 3).astype(np.float32)
    s[0, 20:] = s[0, :10]                      # duplicated sources
    t = (s[:, :15] + 1e-3).astype(np.float32)
    got = pointops.nearest_index(torch.from_numpy(t), torch.from_numpy(s))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnb.nearest_index(jnp.asarray(t),
                                                  jnp.asarray(s))))


def test_min_dists_grad_matches_jax():
    """Targets 0.25 from sources 5.., and 5 targets on sources 0-4: JAX's
    gradient is 2t g' - 2s g' with g' = g / (2 dist), which cancels to
    about ulp(|t| g'); at 0.25 that stays well under 1e-5, while at a
    coincident pair the expanded form's rounding noise makes g' huge, so
    those sources get no other target (their gradient is 0 in both)."""
    rng = RNG(7)
    s = rng.randn(2, 30, 3).astype(np.float32)
    u = rng.randn(2, 40, 3)
    u = 0.25 * u / np.linalg.norm(u, axis=-1, keepdims=True)
    u[:, :5] = 0.0
    rows = np.concatenate([np.arange(5), rng.randint(5, 30, 35)])
    t = (s[:, rows] + u).astype(np.float32)
    w = RNG(8).rand(2, 40).astype(np.float32)
    ref_t, ref_s = jax.grad(
        lambda a, b: jnp.sum(w * jnb.min_dists(a, b)), argnums=(0, 1))(
            jnp.asarray(t), jnp.asarray(s))
    tt = torch.from_numpy(t).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    (torch.from_numpy(w) * pointops.min_dists(tt, ts)).sum().backward()
    _close(tt.grad, ref_t, 1e-5)
    _close(ts.grad, ref_s, 1e-5)
    assert float(tt.grad[:, :5].abs().max()) == 0.0   # clamped: no gradient


def test_min_dists_source_only_gradient():
    t, s = _clouds(9, n=40, m=30)
    ts = torch.from_numpy(s).requires_grad_()
    pointops.min_dists(torch.from_numpy(t), ts).sum().backward()
    ref = jax.grad(lambda b: jnp.sum(jnb.min_dists(jnp.asarray(t), b)))(
        jnp.asarray(s))
    _close(ts.grad, ref, 1e-5)


# --- map and pose losses -------------------------------------------------------

def _maps(seed, b=2, h=6, w=5, c=4):
    rng = RNG(seed)
    pred = rng.randn(b, h, w, c).astype(np.float32)
    target = rng.randn(b, h, w, c).astype(np.float32)
    target[:, :2] = 0.0                        # invalid by the target rule
    pred[:, -1, :2] = 0.0                      # exactly-zero predictions
    labels = rng.randint(0, c, (b, h, w)).astype(np.int32)
    valid = rng.rand(b, h, w) > 0.3
    return pred, target, labels, valid


@pytest.mark.parametrize("kind", ["l1", "cosine", "ce"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_map_loss_matches_jax(kind, with_valid):
    pred, target, labels, valid = _maps(11)
    tgt = labels if kind == "ce" else target
    v = valid if with_valid else None
    ref, ref_g = jax.value_and_grad(
        lambda p: jmap.map_loss(kind, p, jnp.asarray(tgt),
                                None if v is None else jnp.asarray(v)))(
        jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = map_loss.map_loss(kind, tp, torch.from_numpy(tgt),
                            None if v is None else torch.from_numpy(v))
    got.backward()
    _close(got, ref, 1e-5)
    _close(tp.grad, ref_g, 1e-5)


def _krrn_case(seed, b=4, h=8, w=8, n=50, regions=5, cls=3):
    rng = RNG(seed)
    mp = (rng.randn(b, n, 3) * 0.05).astype(np.float32)
    r = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(b)])
    r = (r * np.sign(np.linalg.det(r))[:, None, None]).astype(np.float32)
    r[1] = np.eye(3)         # sample 1: prediction on the target exactly,
    t = (rng.randn(b, 3) * 0.05 + [0, 0, 0.8]).astype(np.float32)
    pred_t = (t + rng.randn(b, 3) * 0.05).astype(np.float32)
    pred_t[1] = t[1]         # the ADD branch at distance 0 in both frameworks
    valid = rng.rand(b, h, w) > 0.4
    pred = {
        "xyz": rng.randn(b, h, w, 3).astype(np.float32),
        "normal": rng.randn(b, h, w, 3).astype(np.float32),
        "region": rng.randn(b, h, w, regions).astype(np.float32),
        "mask": rng.randn(b, h, w, cls + 1).astype(np.float32),
        "pred_t": pred_t,
    }
    pred["normal"][:, 0, 0] = 0.0
    gt = {
        "xyz": np.where(valid[..., None], rng.rand(b, h, w, 3), 0).astype(
            np.float32),
        "normal": np.where(valid[..., None], rng.randn(b, h, w, 3),
                           0).astype(np.float32),
        "region": np.where(valid, rng.randint(1, regions, (b, h, w)),
                           0).astype(np.int32),
        "multi_cls_mask": np.where(valid, 2, 0).astype(np.int32),
        "valid": valid,
        "target_r": r,
        "target": (np.einsum("bnj,bij->bni", mp, r) + t[:, None]).astype(
            np.float32),
        "model_points": mp,
        "sym_mask": np.array([1, 0, 1, 0], np.float32)[:b],
    }
    return pred, gt


@pytest.mark.parametrize("opt_pose", [True, False])
def test_krrn_loss_matches_jax(opt_pose):
    pred, gt = _krrn_case(12)
    weights = {"weight_xyz": 1.0, "weight_region": 0.5, "weight_mask": 2.0,
               "weight_normal": 1.5, "weight_pose": 3.0}
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}

    def jloss(p):
        out = jpose.krrn_loss(p, jgt, weights, opt_pose=opt_pose)
        return out["loss"], out

    (_, ref), ref_g = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in pred.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in pred.items()}
    got = pose_loss.krrn_loss(tp, {k: torch.from_numpy(v)
                                   for k, v in gt.items()}, weights,
                              opt_pose=opt_pose)
    got["loss"].backward()
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k], ref[k], 1e-5)
    for k in pred:
        g = tp[k].grad if tp[k].grad is not None else torch.zeros_like(tp[k])
        _close(g, ref_g[k], 1e-5)
        assert torch.isfinite(g).all()


# --- kernels 1 and 2 as trained ------------------------------------------------

def _gcn_case(seed, b=2, n=40, m=40, k=4, s=3, o=8, cin=12, streams=3):
    rng = RNG(seed)
    nds, dirs, xs, ws, bs = [], [], [], [], []
    for _ in range(streams):
        nd = rng.randn(b, n, k, 3).astype(np.float32)
        nds.append(nd / np.linalg.norm(nd, axis=-1, keepdims=True))
        dd = rng.randn(3, s * o).astype(np.float32)
        dirs.append(dd / np.linalg.norm(dd, axis=0, keepdims=True))
        xs.append(rng.randn(b, m, cin).astype(np.float32))
        ws.append((rng.randn(cin, s * o) * 0.1).astype(np.float32))
        bs.append((rng.randn(s * o) * 0.1).astype(np.float32))
    idx = rng.randint(0, m, (b, n, k)).astype(np.int32)
    g = rng.randn(streams, b, n, o).astype(np.float32)
    return nds, dirs, xs, ws, bs, idx, s, g


def _plain_launch(plain):
    """A stand-in for a kernel launch on the CPU: the plain forward,
    concatenated as the kernel writes it."""
    return lambda *a: torch.cat(plain(*a), -1)


@pytest.mark.parametrize("through", ["plain", "function"])
def test_linear_multi_grad_matches_jax_vjp(through, monkeypatch):
    nds, dirs, xs, ws, bs, idx, s, g = _gcn_case(20)
    groups = [nds, dirs, xs, ws, bs]
    f = lambda *a: pg._linear_multi_xla(*a, jnp.asarray(idx), s)
    _, vjp = jax.vjp(f, *[[jnp.asarray(a) for a in grp] for grp in groups])
    ref = vjp([jnp.asarray(x) for x in g])
    leaves = [[torch.from_numpy(a).requires_grad_() for a in grp]
              for grp in groups]
    tidx = torch.from_numpy(idx)
    if through == "plain":
        outs = gcn.linear_multi(*leaves, tidx, s)
    else:
        monkeypatch.setattr(gcn, "_linear_launch",
                            _plain_launch(gcn.linear_multi_plain))
        flat = [t for grp in leaves for t in grp]
        outs = gcn._split(gcn._LinearMulti.apply(s, 3, *flat, tidx), 3)
    torch.autograd.backward(outs, [torch.from_numpy(x) for x in g])
    for grp, rgrp in zip(leaves, ref):
        for t, r in zip(grp, rgrp):
            _close(t.grad, r, 1e-5)


@pytest.mark.parametrize("through", ["plain", "function"])
def test_surface_multi_grad_matches_jax_vjp(through, monkeypatch):
    nds, dirs, _, _, _, _, s, g = _gcn_case(21)
    f = lambda a, b: pg._surface_multi_xla(a, b, s)
    _, vjp = jax.vjp(f, [jnp.asarray(a) for a in nds],
                     [jnp.asarray(a) for a in dirs])
    ref = vjp([jnp.asarray(x) for x in g])
    leaves = [[torch.from_numpy(a).requires_grad_() for a in grp]
              for grp in (nds, dirs)]
    if through == "plain":
        outs = gcn.surface_multi(*leaves, s)
    else:
        monkeypatch.setattr(gcn, "_surface_launch",
                            _plain_launch(gcn.surface_multi_plain))
        outs = gcn._split(gcn._SurfaceMulti.apply(
            s, 3, *leaves[0], *leaves[1]), 3)
    torch.autograd.backward(outs, [torch.from_numpy(x) for x in g])
    for grp, rgrp in zip(leaves, ref):
        for t, r in zip(grp, rgrp):
            r = np.asarray(r, np.float32)
            tol = 2.0 ** -7 * max(1.0, float(np.abs(r).max()))
            assert float(np.abs(t.grad.numpy() - r).max()) <= tol


def test_function_gives_idx_no_gradient(monkeypatch):
    nds, dirs, xs, ws, bs, idx, s, g = _gcn_case(22, streams=1)
    monkeypatch.setattr(gcn, "_linear_launch",
                        _plain_launch(gcn.linear_multi_plain))
    x = torch.from_numpy(xs[0]).requires_grad_()
    out = gcn._LinearMulti.apply(s, 1, torch.from_numpy(nds[0]),
                                 torch.from_numpy(dirs[0]), x,
                                 torch.from_numpy(ws[0]),
                                 torch.from_numpy(bs[0]),
                                 torch.from_numpy(idx))
    out.sum().backward()
    ref = torch.from_numpy(xs[0]).requires_grad_()
    gcn.linear_multi_plain(
        [torch.from_numpy(nds[0])], [torch.from_numpy(dirs[0])], [ref],
        [torch.from_numpy(ws[0])], [torch.from_numpy(bs[0])],
        torch.from_numpy(idx), s)[0].sum().backward()
    assert torch.equal(x.grad, ref.grad)


def test_fusion_net_lite_grad_matches_jax():
    """FusionNetLite as trained, fed the same inputs: the gradients of its
    parameters and of the xyz and normal streams against jax.grad at
    1e-4 * max(1, max|ref|) (the model tolerance), the ConvSurface
    directions at bf16 precision 2^-7 (their aggregate runs in bf16)."""
    from pose_estimation_tpu.models import fusion as jfusion
    from pose_estimation_tpu_torch import convert
    from pose_estimation_tpu_torch.models import fusion
    rng = RNG(16)
    v = (rng.randn(2, 128, 3) * 0.05 + [0, 0, 0.8]).astype(np.float32)
    xyz = rng.rand(2, 128, 3).astype(np.float32)
    nml = rng.randn(2, 128, 3).astype(np.float32)
    nml /= np.linalg.norm(nml, axis=-1, keepdims=True)
    ct = rng.randn(2, 128, 1280).astype(np.float32)
    jm = jfusion.FusionNetLite(neighbor_num=4, support_num=2)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), v, xyz, nml)["params"]
    ref = jax.jit(jax.grad(
        lambda p, x, n: jnp.sum(jm.apply({"params": p}, v, x, n) * ct),
        argnums=(0, 1, 2)))(params, xyz, nml)
    tm = fusion.FusionNetLite(4, 2)
    convert.load_flax_params(tm, convert.flatten_tree(params))
    tx = torch.from_numpy(xyz).requires_grad_()
    tn = torch.from_numpy(nml).requires_grad_()
    names, ps = zip(*tm.named_parameters())
    out = tm(torch.from_numpy(v), tx, tn)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                list(ps) + [tx, tn])
    got = convert.torch_to_flax(dict(zip(names, grads[:-2])))
    got.update(xyz=grads[-2], nml=grads[-1])
    want = dict(convert.flatten_tree(ref[0]), xyz=ref[1], nml=ref[2])
    assert sorted(got) == sorted(want)
    for k, r in want.items():
        r = np.asarray(r)
        tol = 2.0 ** -7 if k.endswith("conv0/directions") else 1e-4
        err = float(np.abs(np.asarray(got[k]) - r).max())
        assert err <= tol * max(1.0, float(np.abs(r).max())), (k, err)

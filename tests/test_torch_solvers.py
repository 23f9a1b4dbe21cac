"""The port's geometry, solvers and metrics against the JAX package.

Solver scenes are well posed (tests/test_solvers.py's construction: 0.2 m
objects 0.6-1.2 m in front of the LineMOD camera); RANSAC hypotheses use
the same minimal subsets (the JAX sampler's draw, injected into the
port). Tolerances: rotation <= 0.01 deg (angle of R_port^T R_jax, fp64)
and translation <= 1e-4 m; the geometry helpers at fp32 rounding level.
"""

import importlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_estimation_tpu.core import pointops as jpo
from pose_estimation_tpu.core.geometry import intrinsics as jintr
from pose_estimation_tpu.core.geometry import rotations as jrot
from pose_estimation_tpu.core.geometry import umeyama as jume
from pose_estimation_tpu.core.geometry import warp as jwarp
from pose_estimation_tpu.metrics import metric as jmetric
from pose_estimation_tpu_torch.core import pointops as tpo
from pose_estimation_tpu_torch.core.geometry import intrinsics as tintr
from pose_estimation_tpu_torch.core.geometry import rotations as trot
from pose_estimation_tpu_torch.core.geometry import umeyama as tume
from pose_estimation_tpu_torch.core.geometry import warp as twarp
from pose_estimation_tpu_torch.core.solvers import epnp as tepnp
from pose_estimation_tpu_torch.core.solvers import lm as tlm
from pose_estimation_tpu_torch.core.solvers import pnp as tpnp
from pose_estimation_tpu_torch.metrics import metric as tmetric

jepnp = importlib.import_module("pose_estimation_tpu.core.solvers.epnp")
jlm = importlib.import_module("pose_estimation_tpu.core.solvers.lm")
jpnp = importlib.import_module("pose_estimation_tpu.core.solvers.pnp")

torch.set_num_threads(1)

K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899],
              [0, 0, 1]], np.float32)
B = 4


def _case(rng, n, noise=0.0):
    r_gt, _ = cv2.Rodrigues(rng.randn(3) * 0.6)
    t_gt = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1),
                     rng.uniform(0.6, 1.2)])
    pw = (rng.rand(n, 3) - 0.5) * 0.2
    pc = pw @ r_gt.T + t_gt
    uv = pc[:, :2] / pc[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    uv = uv + rng.randn(n, 2) * noise
    return (pw.astype(np.float32), uv.astype(np.float32),
            r_gt.astype(np.float32), t_gt.astype(np.float32))


def _batch(seed, n, noise=0.0):
    rng = np.random.RandomState(seed)
    cs = [_case(rng, n, noise) for _ in range(B)]
    return [np.stack([c[i] for c in cs]) for i in range(4)]


def _rot_deg(r1, r2):
    """Angle between rotations, 2 asin(|R1 - R2|_F / sqrt(8)): stable near
    0, where the trace formula's arccos loses ~0.02 deg to fp32 rounding."""
    d = np.asarray(r1, np.float64) - np.asarray(r2, np.float64)
    fro = np.sqrt((d * d).sum((-1, -2)))
    return np.degrees(2.0 * np.arcsin(np.minimum(fro / np.sqrt(8.0), 1.0)))


def _pose_close(r, t, jr, jt):
    assert _rot_deg(r, jr).max() <= 0.01
    assert np.abs(np.asarray(t) - np.asarray(jt)).max() <= 1e-4


KB = np.broadcast_to(K, (B, 3, 3)).copy()


def test_epnp_fast():
    pw, uv, _, _ = _batch(0, 6, noise=0.5)
    jr, jt = jax.vmap(jepnp.epnp_fast)(pw, uv, KB)
    r, t = tepnp.epnp_fast(torch.from_numpy(pw), torch.from_numpy(uv),
                           torch.from_numpy(KB))
    _pose_close(r.numpy(), t.numpy(), jr, jt)


def test_refine_pose_lm():
    pw, uv, r_gt, t_gt = _batch(1, 64, noise=0.3)
    rng = np.random.RandomState(2)
    p0 = np.stack([np.concatenate([cv2.Rodrigues(r)[0][:, 0]
                                   + rng.randn(3) * 0.05,
                                   t + rng.randn(3) * 0.02])
                   for r, t in zip(r_gt, t_gt)]).astype(np.float32)
    w = rng.rand(B, 64).astype(np.float32)
    jp, jm = jax.vmap(lambda *a: jlm.refine_pose_lm(*a, iters=5))(
        p0, pw, uv, KB, w)
    tp, tm = tlm.refine_pose_lm(*(torch.from_numpy(a)
                                  for a in (p0, pw, uv, KB, w)), iters=5)
    _pose_close(trot.axis_angle_to_matrix(tp[:, :3]).numpy(), tp[:, 3:],
                jrot.axis_angle_to_matrix(jp[:, :3]), jp[:, 3:])
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("robust,top_k", [(False, 1), (True, 4)])
def test_pnp_ransac_with_injected_subsets(robust, top_k):
    pw, uv, _, _ = _batch(3, 128, noise=0.5)
    rng = np.random.RandomState(4)
    for i in range(B):                                  # 25% outliers
        bad = rng.choice(128, 32, replace=False)
        uv[i, bad] += rng.randn(32, 2) * 40
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    kw = dict(num_hypotheses=32, robust_refine=robust, refine_top_k=top_k)
    ref = jax.vmap(lambda kk, a, b, c: jpnp.pnp_ransac(kk, a, b, c, **kw))(
        keys, pw, uv, KB)
    sub = np.stack([np.asarray(jpnp._minimal_subsets(
        keys[i], 128, 6, 32, jnp.ones(128))) for i in range(B)])
    got = tpnp.pnp_ransac(torch.from_numpy(pw), torch.from_numpy(uv),
                          torch.from_numpy(KB),
                          subset_ids=torch.from_numpy(sub).long(), **kw)
    _pose_close(got["r"].numpy(), got["t"].numpy(), ref["r"], ref["t"])
    np.testing.assert_array_equal(got["num_inliers"].numpy(),
                                  np.asarray(ref["num_inliers"]))
    np.testing.assert_allclose(got["mean_err"].numpy(),
                               np.asarray(ref["mean_err"]), rtol=1e-3,
                               atol=1e-4)


def test_minimal_subsets_distinct_and_valid():
    mask = torch.ones((3, 50))
    mask[1, 20:] = 0                                     # 20 valid points
    g = torch.Generator().manual_seed(0)
    sub = tpnp.minimal_subsets(g, mask, 6, 16)
    assert sub.shape == (3, 16, 6)
    for b in range(3):
        for h in range(16):
            ids = sub[b, h].tolist()
            assert len(set(ids)) == 6
            assert all(mask[b, i] > 0 for i in ids)


@pytest.mark.parametrize("sym", [0.0, 1.0])
def test_add_metric_and_pose_accuracy(sym):
    rng = np.random.RandomState(6)
    mp = (rng.randn(B, 200, 3) * 0.03).astype(np.float32)
    gr = np.stack([cv2.Rodrigues(rng.randn(3))[0] for _ in range(B)]
                  ).astype(np.float32)
    pr = np.stack([cv2.Rodrigues(rng.randn(3) * 0.05)[0] @ r
                   for r in gr]).astype(np.float32)
    gt = rng.rand(B, 3).astype(np.float32)
    pt = gt + (rng.randn(B, 3) * 0.01).astype(np.float32)
    symm = np.full(B, sym, np.float32)
    diam = np.full(B, 0.15, np.float32)
    args = (pr, pt, gr, gt, mp, symm, diam)
    ref = jmetric.pose_accuracy(*args)
    got = tmetric.pose_accuracy(*(torch.from_numpy(a) for a in args))
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_rotations_and_projection():
    rng = np.random.RandomState(7)
    v = (rng.randn(6, 3) * 1.2).astype(np.float32)
    v[0] = 0.0
    v[1] = 1e-7
    r = jrot.axis_angle_to_matrix(v)
    tr = trot.axis_angle_to_matrix(torch.from_numpy(v))
    np.testing.assert_allclose(tr.numpy(), np.asarray(r), atol=1e-6)
    np.testing.assert_allclose(
        trot.matrix_to_axis_angle(tr).numpy(),
        np.asarray(jrot.matrix_to_axis_angle(r)), atol=1e-5)
    np.testing.assert_allclose(
        trot.angular_distance(tr[:3], tr[3:]).numpy(),
        np.asarray(jrot.angular_distance(r[:3], r[3:])), atol=1e-3)
    pts = (rng.randn(6, 10, 3) * 0.1).astype(np.float32)
    t = (rng.randn(6, 3) * 0.1 + [0, 0, 1]).astype(np.float32)
    pc = trot.transform_points(torch.from_numpy(pts), tr, torch.from_numpy(t))
    np.testing.assert_allclose(
        pc.numpy(), np.asarray(jrot.transform_points(pts, r, t)), atol=1e-6)
    np.testing.assert_allclose(
        tintr.project_points(pc, torch.from_numpy(K)).numpy(),
        np.asarray(jintr.project_points(jnp.asarray(pc.numpy()), K)),
        rtol=1e-6, atol=1e-3)


def test_kabsch_weighted():
    rng = np.random.RandomState(8)
    src = rng.randn(B, 30, 3).astype(np.float32)
    dst = (src @ np.asarray(jrot.axis_angle_to_matrix(
        rng.randn(3).astype(np.float32))).T + 0.3
           + rng.randn(B, 30, 3) * 0.01).astype(np.float32)
    w = rng.rand(B, 30).astype(np.float32)
    jr, jt, _ = jume.kabsch(src, dst, weights=w)
    r, t = tume.kabsch(*(torch.from_numpy(a) for a in (src, dst, w)))
    _pose_close(r.numpy(), t.numpy(), jr, jt)


def test_warp_crop_and_samplers():
    rng = np.random.RandomState(9)
    img = rng.rand(48, 64, 3).astype(np.float32)
    center = np.array([30.3, 22.7], np.float32)
    side = np.float32(41.5)
    jc = jwarp.crop_affine_coords(jnp.asarray(center), jnp.asarray(side),
                                  (16, 16))
    tc = twarp.crop_affine_coords(torch.from_numpy(center),
                                  torch.tensor(side), (16, 16))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    coords = (rng.rand(20, 2) * [70, 54] - 3).astype(np.float32)
    for jf, tf in ((jwarp.bilinear_sample, twarp.bilinear_sample),
                   (jwarp.nearest_sample, twarp.nearest_sample)):
        np.testing.assert_allclose(
            tf(torch.from_numpy(img), torch.from_numpy(coords)).numpy(),
            np.asarray(jf(jnp.asarray(img), jnp.asarray(coords))),
            atol=1e-6)


def test_neighbour_ops():
    rng = np.random.RandomState(10)
    v = rng.randn(2, 40, 3).astype(np.float32)
    v[:, 20:30] = v[:, :10]                   # coincident points
    f = rng.randn(2, 40, 5).astype(np.float32)
    idx = rng.randint(0, 40, (2, 12, 4)).astype(np.int32)
    tv, tf, ti = (torch.from_numpy(a) for a in (v, f, idx))
    idx_full = rng.randint(0, 40, (2, 40, 4)).astype(np.int32)
    np.testing.assert_allclose(
        tpo.neighbor_directions(tv, torch.from_numpy(idx_full)).numpy(),
        np.asarray(jpo.neighbor_directions(v, idx_full)), atol=1e-6)
    np.testing.assert_array_equal(
        tpo.gather_neighbors_max(tf, ti).numpy(),
        np.asarray(jpo.gather_neighbors_max(f, idx)))
    np.testing.assert_array_equal(
        tpo.gather_rows(tf, ti[..., 0]).numpy(),
        np.asarray(jpo.gather_rows(f, idx[..., 0])))
    # no coincident pairs here: at d = 0 the |a|^2 + |b|^2 - 2ab form
    # leaves rounding noise of ~1e-7 that the sqrt lifts to ~1e-3
    tgt = v[:, :15] + np.float32(0.05)
    np.testing.assert_allclose(
        tpo.min_dists(torch.from_numpy(tgt), tv).numpy(),
        np.asarray(jpo.min_dists(tgt, v)), rtol=1e-4, atol=1e-6)

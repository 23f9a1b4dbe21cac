"""The rest of the JAX package's core/ in the port, against the JAX
functions on the CPU: the ortho6d and Euler forms and random rotations,
the intrinsics helpers, crop_resize, umeyama_ransac, the full EPnP, FPS
and the random pool, and the three export lists.

Tolerances: rotations and intrinsics 1e-6 (fp32 rounding); crop_resize
1e-5 (bilinear weights of coordinates that may part by an ulp);
umeyama_ransac 1e-5 with the JAX hypothesis indices handed over, the
inlier mask equal; EPnP rotation and translation 1e-4 (rotation as the
angle of R_port^T R_jax, 1e-4 rad) on well-posed scenes: tools/
parity_check.py's (0.5-1.2 m in front of the LineMOD camera, 1 px noise,
no outliers) with the 128 points in a box of distinct sides, so that the
PCA control points are well determined, and 12-point subsets of them; FPS indices exactly; the pool 1e-6 with JAX's permutation
handed over.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_estimation_tpu.core.geometry import intrinsics as jintr
from pose_estimation_tpu.core.geometry import rotations as jrot
from pose_estimation_tpu.core.geometry import umeyama as jume
from pose_estimation_tpu.core.geometry import warp as jwarp
from pose_estimation_tpu.core.pointops import neighbors as jnb
from pose_estimation_tpu.core.solvers.epnp import epnp as jepnp
from pose_estimation_tpu_torch.core.geometry import intrinsics as tintr
from pose_estimation_tpu_torch.core.geometry import rotations as trot
from pose_estimation_tpu_torch.core.geometry import umeyama as tume
from pose_estimation_tpu_torch.core.geometry import warp as twarp
from pose_estimation_tpu_torch.core.pointops import neighbors as tnb
from pose_estimation_tpu_torch.core.solvers.epnp import epnp as tepnp
from pose_estimation_tpu_torch.tools.parity_check import make_scenes

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


REPO = Path(__file__).resolve().parents[1]


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=tol)


def _angle(r1, r2):
    """Angle between rotations, 2 asin(|R1 - R2|_F / sqrt(8)), radians."""
    d = np.asarray(r1, np.float64) - np.asarray(r2, np.float64)
    fro = np.sqrt((d * d).sum((-1, -2)))
    return 2.0 * np.arcsin(np.minimum(fro / np.sqrt(8.0), 1.0))


# ---------------------------------------------------------------- rotations
def test_ortho6d_both_ways():
    rng = np.random.RandomState(0)
    six = rng.randn(5, 7, 6).astype(np.float32)
    m = trot.ortho6d_to_matrix(T(six))
    _close(m, jrot.ortho6d_to_matrix(jnp.asarray(six)), 1e-6)
    _close(trot.matrix_to_ortho6d(m),
           jrot.matrix_to_ortho6d(jnp.asarray(m.numpy())), 1e-6)
    r = m.numpy()
    back = trot.ortho6d_to_matrix(trot.matrix_to_ortho6d(m))
    _close(back, r, 1e-6)


@pytest.mark.parametrize("order", ["xyz", "zyx", "yxz"])
def test_euler_to_matrix(order):
    angles = np.random.RandomState(1).uniform(-3, 3, (4, 3)).astype(
        np.float32)
    _close(trot.euler_to_matrix(T(angles), order),
           jrot.euler_to_matrix(jnp.asarray(angles), order), 1e-6)


def test_random_rotation_with_the_jax_draws():
    key = jax.random.PRNGKey(3)
    ref = jrot.random_rotation(key, (6,))
    normals = T(np.asarray(jax.random.normal(key, (6, 4))))
    _close(trot.random_rotation(normals=normals), ref, 1e-6)
    r = trot.random_rotation(torch.Generator().manual_seed(0), (2, 3))
    assert r.shape == (2, 3, 3, 3)
    _close(r @ r.transpose(-1, -2), np.broadcast_to(np.eye(3), r.shape),
           1e-6)
    _close(torch.linalg.det(r), np.ones((2, 3)), 1e-6)


# --------------------------------------------------------------- intrinsics
def test_intrinsics_helpers():
    rng = np.random.RandomState(2)
    kv = np.array([[572.4, 573.6, 325.3, 242.0], [500.0, 510.0, 160.0, 120.5]],
                  np.float32)
    k = tintr.intrinsic_vec_to_matrix(T(kv))
    _close(k, jintr.intrinsic_vec_to_matrix(jnp.asarray(kv)), 1e-6)
    _close(tintr.intrinsic_matrix_to_vec(k), kv, 1e-6)
    kn = k.numpy()
    uvd = np.concatenate([rng.rand(2, 9, 2) * 300, rng.rand(2, 9, 1) + 0.5],
                         -1).astype(np.float32)
    _close(tintr.uvd_to_cloud(T(uvd), k),
           jintr.uvd_to_cloud(jnp.asarray(uvd), jnp.asarray(kn)), 1e-6)
    depth = (rng.rand(2, 5, 7) + 0.5).astype(np.float32)
    _close(tintr.depth_map_to_cloud(T(depth), k, 10.0, 20.0),
           jintr.depth_map_to_cloud(jnp.asarray(depth), jnp.asarray(kn),
                                    10.0, 20.0), 1e-6)
    _close(tintr.depth_map_to_cloud(T(depth[0]), k[0]),
           jintr.depth_map_to_cloud(jnp.asarray(depth[0]),
                                    jnp.asarray(kn[0])), 1e-6)
    for u0, v0, s in ((12.0, 30.0, 1.0), (3.5, 7.0, 0.5)):
        _close(tintr.crop_intrinsics(k, u0, v0, s),
               jintr.crop_intrinsics(jnp.asarray(kn), u0, v0, s), 1e-6)
    s = np.array([0.5, 2.0], np.float32)
    _close(tintr.crop_intrinsics(k, T(np.float32([1, 2])),
                                 T(np.float32([3, 4])), T(s)),
           jintr.crop_intrinsics(jnp.asarray(kn), jnp.float32([1, 2]),
                                 jnp.float32([3, 4]), jnp.asarray(s)), 1e-6)


# --------------------------------------------------------------------- warp
@pytest.mark.parametrize("rot_deg,method", [(0.0, "bilinear"),
                                            (0.0, "nearest"),
                                            (30.0, "bilinear")])
def test_crop_resize(rot_deg, method):
    rng = np.random.RandomState(4)
    img = rng.rand(60, 80, 3).astype(np.float32)
    center = np.array([41.3, 27.9], np.float32)
    for scale, size in ((np.float32(37.5), 16),
                        (np.array([44.0, 44.0], np.float32), (12, 20))):
        ref = jax.jit(jwarp.crop_resize, static_argnums=(3, 4, 5))(
            jnp.asarray(img), jnp.asarray(center), jnp.asarray(scale), size,
            rot_deg, method)
        got = twarp.crop_resize(T(img), T(center), T(np.asarray(scale)),
                                size, rot_deg, method)
        _close(got, ref, 1e-5)
    got = twarp.crop_resize(T(img[..., 0]), center, 30.0, 8)
    _close(got, jwarp.crop_resize(jnp.asarray(img[..., 0]),
                                  jnp.asarray(center), 30.0, 8), 1e-5)


# ------------------------------------------------------------------ umeyama
def _alignment_case(seed, n=64, bad=12):
    rng = np.random.RandomState(seed)
    src = (rng.rand(n, 3) - 0.5).astype(np.float32) * 0.2
    r = np.asarray(jrot.axis_angle_to_matrix(
        jnp.asarray(rng.randn(3).astype(np.float32))))
    dst = 1.3 * src @ r.T + np.float32([0.1, -0.05, 0.8])
    dst[:bad] += rng.uniform(-0.3, 0.3, (bad, 3))
    return src, dst.astype(np.float32)


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_ransac_with_the_jax_hypotheses(with_scale):
    src, dst = _alignment_case(5)
    key = jax.random.PRNGKey(7)
    jr, jt, js, jin = jume.umeyama_ransac(key, jnp.asarray(src),
                                          jnp.asarray(dst),
                                          with_scale=with_scale)
    hyp = T(np.asarray(jax.random.randint(key, (128, 4), 0, len(src))))
    r, t, s, inl = tume.umeyama_ransac(None, T(src), T(dst),
                                       with_scale=with_scale, hypotheses=hyp)
    _close(r, jr, 1e-5)
    _close(t, jt, 1e-5)
    _close(s, js, 1e-5)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jin))
    # its own draws: the 12 corrupted points are the outliers
    r2, _, _, inl2 = tume.umeyama_ransac(torch.Generator().manual_seed(0),
                                         T(src), T(dst),
                                         with_scale=with_scale)
    if with_scale:
        assert not inl2[:12].any() and inl2[12:].all()
        assert _angle(r2.numpy(), r.numpy()) < 1e-4


def test_kabsch_with_scale():
    src, dst = _alignment_case(6, bad=0)
    w = np.random.RandomState(6).rand(len(src)).astype(np.float32)
    jr, jt, js = jume.kabsch(jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(w), with_scale=True)
    r, t, s = tume.kabsch(T(src), T(dst), T(w), with_scale=True)
    for got, ref in ((r, jr), (t, jt), (s, js)):
        _close(got, ref, 1e-5)
    assert abs(float(s) - 1.3) < 1e-4


# --------------------------------------------------------------------- EPnP
def _anisotropic_scenes(n_scenes, n_pts, seed):
    """parity_check's scenes with the object points in a 0.16 x 0.10 x
    0.05 m box: distinct principal axes, so that the PCA control points
    (an eigh of the points' covariance) are well determined. In its cube
    of equal sides the three eigenvalues nearly tie, the two packages'
    eigh pick different axes, and with 1 px noise the EPnP solutions from
    the two control-point sets part by up to 0.3 degree."""
    scenes = make_scenes(n_scenes, n_pts, 1.0, 0.0, seed=seed)
    box = np.array([0.16, 0.10, 0.05]) / 0.12
    k = scenes[0]["k"]
    for s in scenes:
        s["pw"] = s["pw"] * box
        pc = s["pw"] @ s["r"].T + s["t"]
        uv = pc @ k.T
        s["uv"] = uv[:, :2] / uv[:, 2:3] + np.random.RandomState(
            seed).randn(n_pts, 2)
    return scenes


@pytest.mark.parametrize("null_basis", ["iterative", "eigh"])
def test_epnp_on_well_posed_scenes(null_basis):
    """128-point scenes in a box of distinct sides (above), 1 px noise, no
    outliers, one at a time (as the JAX solver takes them) and batched,
    with a weight mask too; and 12-point subsets of them. Six noisy
    points, RANSAC's minimal sets, are not well posed: the null space's
    four smallest eigenvalues nearly tie, and the packages' fp32 results
    part by up to 0.01 rad (iterative) and 1.3 rad (eigh)."""
    scenes = _anisotropic_scenes(4, 128, seed=1)
    rng = np.random.RandomState(8)
    pws = np.stack([s["pw"] for s in scenes]).astype(np.float32)
    uvs = np.stack([s["uv"] for s in scenes]).astype(np.float32)
    k = scenes[0]["k"].astype(np.float32)
    w = (rng.rand(4, 128) > 0.3).astype(np.float32)
    kb = T(np.broadcast_to(k, (4, 3, 3)).copy())
    r, t = tepnp(T(pws), T(uvs), kb, null_basis=null_basis)
    rw, tw = tepnp(T(pws), T(uvs), kb, T(w), null_basis=null_basis)
    for i in range(4):
        ref = jepnp(jnp.asarray(pws[i]), jnp.asarray(uvs[i]), jnp.asarray(k),
                    null_basis=null_basis)
        ref_w = jepnp(jnp.asarray(pws[i]), jnp.asarray(uvs[i]),
                      jnp.asarray(k), jnp.asarray(w[i]),
                      null_basis=null_basis)
        for (got_r, got_t), (jr, jt) in (((r[i], t[i]), ref),
                                         ((rw[i], tw[i]), ref_w)):
            assert _angle(got_r.numpy(), jr) < 1e-4
            _close(got_t, jt, 1e-4)
        one = tepnp(T(pws[i]), T(uvs[i]), T(k), null_basis=null_basis)
        assert _angle(one[0].numpy(), r[i].numpy()) < 1e-4
        assert _angle(r[i].numpy(), scenes[i]["r"]) < 0.05   # 1 px noise
    sub = np.stack([rng.choice(128, 12, replace=False) for _ in range(4)])
    pw12 = np.take_along_axis(pws, sub[..., None], 1)
    uv12 = np.take_along_axis(uvs, sub[..., None], 1)
    r12, t12 = tepnp(T(pw12), T(uv12), kb, null_basis=null_basis)
    for i in range(4):
        jr, jt = jepnp(jnp.asarray(pw12[i]), jnp.asarray(uv12[i]),
                       jnp.asarray(k), null_basis=null_basis)
        assert _angle(r12[i].numpy(), jr) < 1e-4
        _close(t12[i], jt, 1e-4)


# ----------------------------------------------------------------- pointops
def test_farthest_point_sampling_indices_equal():
    rng = np.random.RandomState(9)
    pts = rng.randn(3, 200, 3).astype(np.float32)
    ref = jnb.farthest_point_sampling(jnp.asarray(pts), 40, start_index=5)
    got = tnb.farthest_point_sampling(T(pts), 40, start_index=5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    one = tnb.farthest_point_sampling(T(pts[1]), 17)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jnb.farthest_point_sampling(
            jnp.asarray(pts[1]), 17)))
    # a tie: two copies of the farthest point, the first one wins
    tie = np.array([[0, 0, 0], [1, 0, 0], [1, 0, 0], [0.5, 0, 0]],
                   np.float32)
    np.testing.assert_array_equal(
        tnb.farthest_point_sampling(T(tie), 3).numpy(),
        np.asarray(jnb.farthest_point_sampling(jnp.asarray(tie), 3)))


def test_random_subsample_pool_with_the_jax_permutation():
    rng = np.random.RandomState(10)
    verts = rng.randn(2, 48, 5).astype(np.float32)
    feats = rng.randn(2, 48, 6).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jv, jf = jnb.random_subsample_pool(key, jnp.asarray(verts),
                                       jnp.asarray(feats), 12, 4)
    perm = T(np.asarray(jax.random.permutation(key, 48)))
    v, f = tnb.random_subsample_pool(None, T(verts), T(feats), 12, 4,
                                     permutation=perm)
    _close(v, jv, 1e-6)
    _close(f, jf, 1e-6)
    v2, _ = tnb.random_subsample_pool(torch.Generator().manual_seed(0),
                                      T(verts), T(feats), 12)
    assert v2.shape == (2, 12, 5)


# ------------------------------------------------------------------ exports
@pytest.mark.parametrize("pkg", ["geometry", "pointops", "solvers"])
def test_every_jax_core_name_is_exported(pkg):
    import importlib
    tree = ast.parse((REPO / "pose_estimation_tpu" / "core" / pkg
                      / "__init__.py").read_text())
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) for a in node.names]
    port = importlib.import_module(f"pose_estimation_tpu_torch.core.{pkg}")
    assert names and [n for n in names if not hasattr(port, n)] == []
    assert all(callable(getattr(port, n)) for n in names)

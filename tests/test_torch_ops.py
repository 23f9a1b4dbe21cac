"""The port's hand-written kernels, through their plain PyTorch versions
(what the wrappers run for CPU tensors), against the JAX package.

  kernel 1 (fused linear aggregate): vs pallas_gcn._linear_multi_xla in
      fp32 at rtol = atol = 1e-5, and vs the Pallas body in interpret mode
      in bf16 at 0.05 (as tests/test_gcn_fused.py holds the Pallas kernel);
  kernel 2 (fused surface aggregate): the same two references; the XLA
      one computes theta in bf16, which the plain version reproduces, so
      1e-5 holds there too;
  kernel 3 (KNN): exact index equality with neighbors.knn_indices /
      knn_indices_cross on distinct random points; neighbour distances vs
      the Pallas KNN in interpret mode.
The kernels themselves run only on a CUDA card: tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_estimation_tpu.core.pointops import neighbors as jnb
from pose_estimation_tpu.ops import pallas_gcn as pg
from pose_estimation_tpu.ops import pallas_pointops as pp
from pose_estimation_tpu_torch.ops import gcn, pointops

torch.set_num_threads(1)


def _mk(seed, b=2, n=96, m=96, k=5, s=3, o=16, cin=12, streams=3, d=3):
    rng = np.random.RandomState(seed)
    nds, dirs, xs, ws, bs = [], [], [], [], []
    for _ in range(streams):
        nd = rng.randn(b, n, k, d).astype(np.float32)
        nds.append(nd / (np.linalg.norm(nd, axis=-1, keepdims=True) + 1e-9))
        dd = rng.randn(d, s * o).astype(np.float32)
        dirs.append(dd / np.linalg.norm(dd, axis=0, keepdims=True))
        xs.append(rng.randn(b, m, cin).astype(np.float32))
        ws.append((rng.randn(cin, s * o) * 0.1).astype(np.float32))
        bs.append((rng.randn(s * o) * 0.1).astype(np.float32))
    idx = rng.randint(0, m, (b, n, k)).astype(np.int32)
    return nds, dirs, xs, ws, bs, idx, s


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


# (n, m): a padded tile and a ragged point count (300 is no multiple of 8
# or 256), as the Pallas tests use
SHAPES = [(96, 96), (300, 64)]


@pytest.mark.parametrize("n,m", SHAPES)
def test_linear_multi_plain_matches_xla(n, m):
    nds, dirs, xs, ws, bs, idx, s = _mk(0, n=n, m=m)
    ref = pg._linear_multi_xla(_j(nds), _j(dirs), _j(xs), _j(ws), _j(bs),
                               jnp.asarray(idx), s)
    got = gcn.linear_multi(_t(nds), _t(dirs), _t(xs), _t(ws), _t(bs),
                           torch.from_numpy(idx), s)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("n,m", SHAPES)
def test_linear_multi_plain_matches_pallas_interpret(n, m):
    nds, dirs, xs, ws, bs, idx, s = _mk(1, n=n, m=m)
    ref = pg._linear_multi_tpu_impl(_j(nds), _j(dirs), _j(xs), _j(ws),
                                    _j(bs), jnp.asarray(idx), s,
                                    interpret=True)
    got = gcn.linear_multi(_t(nds), _t(dirs), _t(xs, torch.bfloat16),
                           _t(ws), _t(bs), torch.from_numpy(idx), s)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0.05,
                                   atol=0.05)


@pytest.mark.parametrize("n", [96, 300])
def test_surface_multi_plain_matches_xla_and_pallas(n):
    nds, dirs, _, _, _, _, s = _mk(2, n=n)
    xla = pg._surface_multi_xla(_j(nds), _j(dirs), s)
    pal = pg._surface_multi_impl(_j(nds), _j(dirs), s, interpret=True)
    got = gcn.surface_multi(_t(nds), _t(dirs), s)
    for x, p, g in zip(xla, pal, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=0.05,
                                   atol=0.05)


def test_aggregate_linear_level2_matches_xla():
    """Level 2's 9-D per-stream ConvLayer aggregate (plain in the port)."""
    nds, dirs, xs, ws, bs, idx, s = _mk(3, n=40, m=40, k=4, d=9, streams=1)
    ref = pg.gcn_aggregate_linear(jnp.asarray(nds[0]), jnp.asarray(dirs[0]),
                                  jnp.asarray(xs[0]), jnp.asarray(ws[0]),
                                  jnp.asarray(bs[0]), jnp.asarray(idx), s)
    got = gcn.aggregate_linear(*_t([nds[0], dirs[0], xs[0], ws[0], bs[0]]),
                               torch.from_numpy(idx), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_aggregate_wide_matches_xla():
    nds, dirs, xs, _, _, idx, s = _mk(4, n=40, m=40, k=4, streams=1,
                                      cin=3 * 16)
    ref = pg.gcn_aggregate(jnp.asarray(nds[0]), jnp.asarray(dirs[0]),
                           jnp.asarray(xs[0]), jnp.asarray(idx), s)
    got = gcn.aggregate(*_t([nds[0], dirs[0], xs[0]]),
                        torch.from_numpy(idx), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n,k", [(128, 10), (96, 8), (64, 4)])
def test_knn_self_matches_xla(n, k):
    pts = np.random.RandomState(n + k).randn(2, n, 3).astype(np.float32)
    ref = jnb.knn_indices(jnp.asarray(pts), k)
    got = pointops.knn(torch.from_numpy(pts), torch.from_numpy(pts), k, True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("exclude_self", [True, False])
def test_knn_cross_matches_xla(exclude_self):
    rng = np.random.RandomState(5)
    keys = rng.randn(2, 160, 3).astype(np.float32)
    q = (np.ascontiguousarray(keys[:, ::4]) if exclude_self
         else rng.randn(2, 40, 3).astype(np.float32))
    ref = jnb.knn_indices_cross(jnp.asarray(q), jnp.asarray(keys), 4,
                                exclude_self=exclude_self)
    got = pointops.knn(torch.from_numpy(q), torch.from_numpy(keys), 4,
                       exclude_self)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_knn_distances_match_pallas_interpret():
    pts = np.random.RandomState(6).randn(2, 200, 3).astype(np.float32)
    ref = np.asarray(pp._knn_pallas(jnp.asarray(pts), 6, True,
                                    interpret=True))
    got = pointops.knn(torch.from_numpy(pts), torch.from_numpy(pts), 6,
                       True).numpy()

    def dist(idx):
        nb = pts[np.arange(2)[:, None, None], idx]
        return np.sort(((nb - pts[:, :, None]) ** 2).sum(-1), -1)

    np.testing.assert_allclose(dist(got), dist(ref), rtol=1e-5, atol=1e-7)


def test_ties_go_to_the_lower_index():
    """Exact duplicates (wrap-padded `choose`): the stable sort keeps
    lax.top_k's order."""
    rng = np.random.RandomState(7)
    pts = rng.randn(1, 20, 3).astype(np.float32)
    pts[0, 10:] = pts[0, :10]
    ref = jnb.knn_indices(jnp.asarray(pts), 5)
    got = pointops.knn(torch.from_numpy(pts), torch.from_numpy(pts), 5, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrappers_have_no_fallback():
    """A tensor that is neither on the CPU nor on a card raises; it is not
    quietly computed by the plain version."""
    pts = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError):
        pointops.knn(pts, pts, 2, True)
    nd = torch.zeros((1, 8, 2, 3), device="meta")
    dirs = torch.zeros((3, 4), device="meta")
    with pytest.raises(ValueError):
        gcn.surface_multi([nd], [dirs], 2)
    with pytest.raises(ValueError):
        gcn.linear_multi([nd], [dirs], [torch.zeros((1, 8, 4),
                                                    device="meta")],
                         [torch.zeros((4, 4), device="meta")],
                         [torch.zeros((4,), device="meta")],
                         torch.zeros((1, 8, 2), dtype=torch.int32,
                                     device="meta"), 2)

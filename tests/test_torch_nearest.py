"""The merged nearest-source call and kernel 2's rounding identity, on the
CPU:

  nearest_multi (plain version): the indices of the fusion nets' two
      up-sampling maps from one call equal the JAX package's FusionNetLite
      maps, which take both from one distance matrix (fusion.py: d1 =
      pairwise_sqdist(vertices, pool_1), near_1 = argmin d1, near_2 =
      argmin of d1's s2 columns, pool_2 = pool_1[:, s2]); each pair is
      nearest_plain of its cloud;
  kernel 2's order: csrc/gcn.cu:surface_kernel keeps the unrounded maximum
      of theta over k and takes relu and the bf16 rounding after it. That
      relies on max_k relu(bf16(x_k)) == bf16(relu(max_k x_k)), which holds
      bit for bit (rounding to nearest is monotone; bf16(x) <= 0 for
      x <= 0), checked here on fp32 values with negatives, +-0, NaN and
      values on bf16 rounding midpoints; and the kernel's whole order,
      written out in PyTorch, equals surface_multi_plain bit for bit;
  nearest_plain in blocks of targets (its memory bound at the transparent
      loss's 500,000 targets) equals the unblocked search bit for bit,
      blocks ending inside the clouds and at their last target, eps > 0
      and eps = 0 (ICP's trimmed residual).
Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_estimation_tpu.core.pointops import neighbors as jnb
from pose_estimation_tpu_torch.core import pointops as tpo
from pose_estimation_tpu_torch.ops import gcn, pointops

torch.set_num_threads(1)

_BF16 = torch.bfloat16


@pytest.mark.parametrize("seed,b,n", [(0, 2, 256), (1, 3, 128), (2, 1, 512)])
def test_upsampling_maps_match_the_jax_fusion_maps(seed, b, n):
    rng = np.random.RandomState(seed)
    verts = (rng.randn(b, n, 3) * 0.05 + [0, 0, 0.8]).astype(np.float32)
    feat_9d = np.concatenate([verts, rng.randn(b, n, 6).astype(np.float32)],
                             -1)
    s1 = rng.permutation(n)[:n // 4]
    pool_1 = feat_9d[:, s1]                                # PoolLayer draws
    s2 = rng.permutation(n // 4)[:n // 16]
    pool_2 = pool_1[:, s2]

    d1 = jnb.pairwise_sqdist(jnp.asarray(verts), jnp.asarray(pool_1[..., :3]))
    near_1 = np.asarray(jnp.argmin(d1, axis=-1).astype(jnp.int32))
    near_2 = np.asarray(jnp.argmin(jnp.take(d1, jnp.asarray(s2), axis=-1),
                                   axis=-1).astype(jnp.int32))

    t = torch.from_numpy(verts)
    srcs = [torch.from_numpy(np.ascontiguousarray(p[..., :3]))
            for p in (pool_1, pool_2)]
    got = tpo.nearest_index_multi(t, srcs)
    np.testing.assert_array_equal(got[0].numpy(), near_1)
    np.testing.assert_array_equal(got[1].numpy(), near_2)
    pairs = pointops.nearest_multi(t, srcs)
    for (d, i), s in zip(pairs, srcs, strict=True):
        dp, ip = pointops.nearest_plain(t, s)
        assert torch.equal(d, dp) and torch.equal(i, ip)
        assert torch.equal(i, pointops.nearest_index(t, s))


def _bf16_midpoints(rng, size):
    """fp32 values halfway between two neighbouring bf16 values, both
    signs: a bf16 value is an fp32 one whose low 16 bits are 0, so setting
    only bit 15 of those puts a value on the midpoint above it (in
    magnitude), which rounds half to even."""
    x = torch.from_numpy(rng.randn(size).astype(np.float32))
    return ((x.view(torch.int32) & ~0xFFFF) | 0x8000).view(torch.float32)


def _columns(seed, k=10, m=4000):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(k, m).astype(np.float32))
    mid = _bf16_midpoints(rng, k * m).reshape(k, m)
    x[:, ::3] = mid[:, ::3]                                 # on ties
    x[:, 1::7] = -x[:, 1::7].abs()                          # all negative
    x[:, 2::11] = 0.0
    x[::2, 5::13] = -0.0                                    # +-0 only
    x[1::2, 5::13] = 0.0
    x[:, 6::17] = x[:, 6::17] * 3e38                        # bf16 overflow
    x[3, 7::19] = float("nan")
    return x


def _relu_round_then_max(x):
    """The plain version's order: per slot bf16, relu, then the max."""
    acc = None
    for row in x:
        th = torch.relu(row.to(_BF16).float())
        acc = th if acc is None else torch.maximum(acc, th)
    return acc


def _max_then_relu_round(x):
    """The kernel's order: the max of the unrounded values, then relu and
    one bf16 rounding."""
    acc = x[0]
    for row in x[1:]:
        acc = torch.maximum(acc, row)
    return torch.relu(acc).to(_BF16).float()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_relu_and_bf16_rounding_commute_with_the_max(seed):
    x = _columns(seed)
    a, b = _relu_round_then_max(x), _max_then_relu_round(x)
    assert torch.equal(a.isnan(), b.isnan()) and a.isnan().any()
    keep = ~a.isnan()
    # the same values (-0 == +0), and the same bits once zeros are +0
    assert torch.equal(a[keep], b[keep])
    assert torch.equal((a[keep] + 0.0).view(torch.int32),
                       (b[keep] + 0.0).view(torch.int32))


def test_midpoints_are_ties():
    """The helper's values really sit halfway between two bf16 values."""
    m = _bf16_midpoints(np.random.RandomState(5), 1000)
    r = m.to(_BF16).float()
    other = 2 * m - r
    assert torch.equal(other.to(_BF16).float(), other)      # a bf16 value
    assert torch.equal((m - r).abs(), (other - m).abs())
    assert (r != other).all()


def _surface_kernel_order(nds, dirs_list, s):
    """csrc/gcn.cu:surface_kernel's arithmetic in PyTorch: the dot term by
    term, the running maximum of the unrounded dot, then per (s, o) relu
    and bf16, the supports summed in order in fp32, bf16 at the end."""
    outs = []
    for nd, dirs in zip(nds, dirs_list):
        nd = nd.to(_BF16).float()
        dirs = dirs.to(_BF16).float()
        m = None
        for kk in range(nd.shape[2]):
            n = nd[:, :, kk]
            th = (n[..., 0:1] * dirs[0] + n[..., 1:2] * dirs[1]) \
                + n[..., 2:3] * dirs[2]
            m = th if m is None else torch.maximum(m, th)
        r = torch.relu(m).to(_BF16).float().reshape(*m.shape[:-1], s, -1)
        acc = r[..., 0, :]
        for j in range(1, s):
            acc = acc + r[..., j, :]
        outs.append(acc.to(_BF16).float())
    return outs


@pytest.mark.parametrize("s,o,k", [(7, 128, 10), (3, 40, 5), (1, 8, 4)])
def test_surface_kernel_order_matches_plain(s, o, k):
    rng = np.random.RandomState(s + o)
    nds = [torch.from_numpy(rng.randn(2, 50, k, 3).astype(np.float32))
           for _ in range(3)]
    dirs = [torch.from_numpy(rng.randn(3, s * o).astype(np.float32))
            for _ in range(3)]
    nds[1] = nds[1].to(_BF16)
    for got, ref in zip(_surface_kernel_order(nds, dirs, s),
                        gcn.surface_multi_plain(nds, dirs, s), strict=True):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("chunk", [1, 7, 64, 100, 101, 4096])
@pytest.mark.parametrize("eps", [1e-8, 0.0])
def test_nearest_plain_in_blocks_equals_unblocked(chunk, eps):
    rng = np.random.RandomState(3)
    t = torch.from_numpy((rng.randn(2, 101, 3) * 0.05).astype(np.float32))
    s = torch.from_numpy((rng.randn(2, 37, 3) * 0.05).astype(np.float32))
    t[0, 64] = s[0, 5]                 # a zero distance on a block's edge
    t[1, 100] = s[1, 36]
    d2 = pointops.sqdist(t, s)
    best, idx = torch.min(d2, dim=-1)
    want_d = torch.sqrt(torch.clamp(best, min=eps * eps))
    got_d, got_i = pointops.nearest_plain(t, s, eps, chunk=chunk)
    assert torch.equal(got_d, want_d) and torch.equal(got_i, idx.int())
    assert got_d[0, 64] == (eps if eps else 0.0)

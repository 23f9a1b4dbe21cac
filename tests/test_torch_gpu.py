"""The port's CUDA kernels on a card, against their plain versions.

Every test here needs a CUDA card and skips without one. The file imports
no JAX; on the machine with the card it runs on its own:

  python -m pytest --noconftest -p no:cacheprovider -m gpu \
      tests/test_torch_gpu.py -q

(--noconftest skips tests/conftest.py, which sets JAX up for the CPU
tests.) chip_smoke.py checks the
serving path's full shapes; these tests cover small and ragged shapes, the
wrappers' input checks and the launch counts of tiny models (FusionNetLite
and the full FusionNet).
"""

import numpy as np
import pytest
import torch

from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.core.mathsafe import safe_normalize
from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.ops import _build, gcn, pointops, resize

pytestmark = pytest.mark.gpu

TINY = schema.override(schema.Config(), **{
    "module.num_cls": 2, "data.num_regions": 8, "data.num_points": 128,
    "data.input_size": 64, "module.backbone_outc": 16,
    "module.stem_width": 8,
    "module.hrnet_stages": ((1, 1, (8, 8)), (1, 1, (8, 8, 16)),
                            (1, 1, (8, 8, 16, 16))),
    "module.xyznet": schema.HeadConfig(hidden=16),
    "module.nmlnet": schema.HeadConfig(hidden=16),
    "module.gcn3d": schema.Gcn3dConfig(neighbor_num=4, support_num=2),
    "train.amp": False})


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gcn_inputs(dev, n, m, k, s=3, o=16, cin=12, streams=3, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    nds = [safe_normalize(r(2, n, k, 3)) for _ in range(streams)]
    dirs = [safe_normalize(r(3, s * o), dim=0) for _ in range(streams)]
    xs = [r(2, m, cin) for _ in range(streams)]
    ws = [r(cin, s * o) * 0.1 for _ in range(streams)]
    bs = [r(s * o) * 0.1 for _ in range(streams)]
    idx = torch.randint(0, m, (2, n, k), generator=g, device=dev,
                        dtype=torch.int32)
    return nds, dirs, xs, ws, bs, idx, s


@pytest.mark.parametrize("n,m,o,s,cin", [
    (300, 300, 16, 3, 12), (37, 90, 40, 3, 12), (64, 64, 128, 3, 12),
    (90, 37, 40, 3, 40), (50, 300, 128, 7, 40), (300, 90, 128, 7, 128),
    (64, 64, 256, 7, 256), (50, 40, 16, 3, 520)])
def test_linear_multi_matches_plain(dev, n, m, o, s, cin):
    """Shapes that break kernel 1's tiles: B*M rows not a multiple of the
    table pass's 128-row tile, Cin not a multiple of 16 (or of 8: the
    unvectorised load), S*O not a multiple of its 128-column tile, the
    full FusionNet's O=256 from Cin 256, and a Cin past the tensor-core
    pass's 512 (the CUDA-core table pass in bf16)."""
    nds, dirs, xs, ws, bs, idx, s = _gcn_inputs(dev, n, m, 6, s=s, o=o,
                                                cin=cin)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = [t.to(dt) for t in xs]
        got = gcn.linear_multi(nds, dirs, x, ws, bs, idx, s)
        ref = gcn.linear_multi_plain(nds, dirs, x, ws, bs, idx, s)
        for a, b in zip(got, ref):
            assert a.shape == (2, n, o) and a.dtype == torch.float32
            torch.testing.assert_close(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("n,s", [(300, 3), (64, 7), (5, 1)])
def test_surface_multi_matches_plain(dev, n, s):
    nds, dirs, _, _, _, _, _ = _gcn_inputs(dev, n, n, 5, s=s)
    for dt in (torch.float32, torch.bfloat16):
        got = gcn.surface_multi([t.to(dt) for t in nds],
                                [t.to(dt) for t in dirs], s)
        ref = gcn.surface_multi_plain(nds, dirs, s)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n,k,s,o,streams", [
    (300, 10, 1, 8, 1), (37, 5, 2, 40, 2), (5, 3, 3, 128, 3),
    (64, 10, 4, 8, 3), (300, 7, 5, 40, 1), (100, 10, 6, 128, 2),
    (33, 10, 7, 128, 3), (70, 4, 8, 40, 3), (50, 6, 3, 5, 2),
    (40, 9, 2, 600, 4), (90, 10, 9, 128, 3), (30, 8, 13, 7, 2),
    (20, 128, 17, 16, 1)])
def test_surface_multi_is_bit_exact(dev, n, k, s, o, streams):
    """Kernel 2 against surface_multi_plain, bit for bit: N not a multiple
    of the 64-point tile, S = 1..8 (one pass of supports) and 9, 13, 17
    (two and three passes), 1-4 streams, O = 8, 40, 128, odd O (one
    channel a thread), O = 600 (more channel groups than a block holds)
    and K = 128, the last K taken, each stream's nd and dirs in fp32 or
    bf16 as they come."""
    nds, dirs, _, _, _, _, _ = _gcn_inputs(dev, n, n, k, s=s, o=o,
                                           streams=streams, seed=n + s)
    for first in (torch.float32, torch.bfloat16):
        other = torch.bfloat16 if first == torch.float32 else torch.float32
        a = [t.to(first if i % 2 == 0 else other) for i, t in enumerate(nds)]
        d = [t.to(other if i % 2 == 0 else first) for i, t in
             enumerate(dirs)]
        gcn.surface_multi.launches = 0
        got = gcn.surface_multi(a, d, s)
        assert gcn.surface_multi.launches == 1
        for x, r in zip(got, gcn.surface_multi_plain(a, d, s)):
            assert x.shape == (2, n, o) and x.dtype == torch.float32
            assert torch.equal(x, r)


def test_surface_multi_on_bf16_rounding_ties(dev):
    """nd and dirs drawn from values whose products and sums are exact in
    fp32 and land on bf16 rounding midpoints (1 + 2^-8 = 1 + 2^-4 * 2^-4,
    ...), with zeros and negatives: theta is rounded half to even after
    the max over k exactly as the plain version rounds each slot."""
    g = torch.Generator(device=dev).manual_seed(11)
    vals = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0 ** -4, -2.0 ** -4,
                         1.0 + 2.0 ** -7, -(1.0 + 2.0 ** -7), 0.5, 2.0 ** -3,
                         -2.0 ** -8], device=dev)
    pick = lambda *shape: vals[torch.randint(0, len(vals), shape,
                                             generator=g, device=dev)]
    for s, o in ((3, 16), (7, 128)):
        nds = [pick(2, 130, 6, 3) for _ in range(3)]
        dirs = [pick(3, s * o) for _ in range(3)]
        got = gcn.surface_multi(nds, dirs, s)
        for x, r in zip(got, gcn.surface_multi_plain(nds, dirs, s)):
            assert torch.equal(x, r)


@pytest.mark.parametrize("nq,nk,k,ex", [(300, 300, 10, True),
                                        (75, 300, 4, True),
                                        (40, 1500, 16, False),
                                        (2000, 2000, 3, True),
                                        (5, 70, 1, False),
                                        (3, 40, 16, True),
                                        (130, 1030, 17, False),
                                        (3000, 3000, 10, True),
                                        (5000, 5000, 4, True),
                                        (300, 300, 23, True),
                                        (40, 1500, 31, True),
                                        (2000, 2000, 32, False)])
def test_knn_matches_plain(dev, nq, nk, k, ex):
    """Indices equal to the plain version's: ragged query and key counts,
    fewer queries than a query's lane group, kk = 1, 17, 24 and 32 (each
    of the four compiled list sizes, and the last kk taken), more keys
    than one shared-memory tile, and query counts that give 32, 16 and 8
    lanes per query at batch 2."""
    g = torch.Generator(device=dev).manual_seed(1)
    keys = torch.randn((2, nk, 3), generator=g, device=dev)
    q = (keys[:, ::nk // nq][:, :nq].contiguous() if ex
         else torch.randn((2, nq, 3), generator=g, device=dev))
    got = pointops.knn(q, keys, k, ex)
    ref = pointops.knn_plain(q, keys, k, ex)
    assert got.shape == (2, nq, k) and got.dtype == torch.int32
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n,side", [(600, 4), (3000, 4), (5000, 4),
                                    (3000, 2)])
def test_knn_ties_go_to_the_lower_index(dev, n, side):
    """A cloud on a coarse grid of side**3 positions with every point
    twice: many exactly equal distances, which the lanes' merge must hand
    to the lower index, as the plain version's stable sort does. At 8
    positions each holds ~375 copies, more ties at or below the bound than
    any candidate list holds (64, 96 or 128 keys for kk <= 16, 24, 32), so
    every query rescans, at each list size."""
    g = torch.Generator(device=dev).manual_seed(7)
    keys = (torch.randint(0, side, (2, n, 3), generator=g, device=dev)
            * (1.0 / side))
    keys[:, n // 2:] = keys[:, :n // 2]
    for q, ex in ((keys, True), (keys[:, ::3].contiguous(), False)):
        for k in (1, 10, 16, 23, 31):
            got = pointops.knn(q, keys, k, ex)
            assert torch.equal(got, pointops.knn_plain(q, keys, k, ex))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    pts = torch.randn((2, 64, 3), device=dev)
    with pytest.raises(ValueError):
        pointops.knn(pts[:, ::2], pts, 4, True)           # not contiguous
    with pytest.raises(TypeError):
        pointops.knn(pts.double(), pts.double(), 4, True)
    with pytest.raises(ValueError):
        pointops.knn(pts, pts, 40, True)                   # k+1 > 32
    with pytest.raises(ValueError):
        pointops.knn(pts, pts.cpu(), 4, True)              # mixed devices
    nds, dirs, xs, ws, bs, idx, s = _gcn_inputs(dev, 16, 16, 4)
    with pytest.raises(ValueError):
        gcn.linear_multi(nds, dirs, xs, ws, bs, idx.long(), s)
    with pytest.raises(TypeError):
        gcn.linear_multi(nds, dirs, [x.half() for x in xs], ws, bs, idx, s)
    nds, dirs, xs, ws, bs, idx, s = _gcn_inputs(dev, 16, 16, 4, o=12)
    with pytest.raises(ValueError):                        # O % 8
        gcn.linear_multi(nds, dirs, xs, ws, bs, idx, s)


def test_tiny_krrn_launch_counts_and_plain_cpu_parity(dev):
    torch.manual_seed(0)
    model = KRRN(TINY).eval()
    rng = np.random.RandomState(0)
    args = (rng.rand(2, 64, 64, 3).astype(np.float32),
            (rng.randn(2, 128, 3) * 0.05 + [0, 0, 0.8]).astype(np.float32),
            rng.randint(0, 64 * 64, (2, 128)).astype(np.int64),
            np.array([0, 1]))
    cpu_args = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        ref = model(*cpu_args)
        model.to(dev)
        for f in (gcn.linear_multi, gcn.surface_multi, pointops.knn,
                  pointops.nearest_multi):
            f.launches = 0
        got = model(*[a.to(dev) for a in cpu_args])
    assert (gcn.linear_multi.launches, gcn.surface_multi.launches,
            pointops.knn.launches,
            pointops.nearest_multi.launches) == (2, 1, 8, 1)
    for key, rtol in (("xyz_emb", 1e-4), ("pred_t", 2e-3)):
        r = ref[key]
        tol = rtol * max(1.0, r.abs().max().item())
        assert (got[key].cpu() - r).abs().max().item() <= tol, key


@pytest.mark.parametrize("b,n,m", [(2, 300, 500), (3, 1, 2500),
                                   (1, 1025, 7), (2, 2048, 2048)])
def test_nearest_matches_plain(dev, b, n, m):
    """Ragged target counts, several source tiles: bit for bit."""
    g = torch.Generator(device=dev).manual_seed(2)
    t = torch.randn((b, n, 3), generator=g, device=dev)
    s = torch.randn((b, m, 3), generator=g, device=dev)
    t[:, :1] = s[:, :1]                                  # distance 0
    d, i = pointops.nearest(t, s)
    dp, ip = pointops.nearest_plain(t, s)
    assert d.shape == (b, n) and i.dtype == torch.int32
    assert torch.equal(d, dp) and torch.equal(i, ip)


def _assert_nearest_equal(got, ref):
    for (d, i), (dp, ip) in zip(got, ref, strict=True):
        assert d.shape == dp.shape and i.dtype == torch.int32
        torch.testing.assert_close(d, dp, rtol=0, atol=0, equal_nan=True)
        assert torch.equal(i, ip)


@pytest.mark.parametrize("b,n,sizes", [
    (2, 300, (500,)), (3, 1, (2500, 7, 300)), (2, 1025, (256, 64)),
    (32, 1024, (256, 64)), (8, 1024, (500,)), (2, 2048, (2048, 90, 1030)),
    (8, 3000, (3000,)), (1, 70, (1, 2, 3, 33))])
def test_nearest_multi_matches_plain(dev, b, n, sizes):
    """One launch for 1-4 source clouds of different sizes, against a loop
    of nearest_plain, bit for bit: batch * targets below what fills the
    card (32 lanes a target) and above it (1-2 lanes), one source, large
    clouds (two targets a lane group), several source tiles."""
    g = torch.Generator(device=dev).manual_seed(sum(sizes) + n)
    t = torch.randn((b, n, 3), generator=g, device=dev)
    srcs = [torch.randn((b, m, 3), generator=g, device=dev) for m in sizes]
    t[:, :1] = srcs[0][:, :1]                             # distance 0
    pointops.nearest_multi.launches = 0
    got = pointops.nearest_multi(t, srcs)
    assert pointops.nearest_multi.launches == 1
    _assert_nearest_equal(got, pointops.nearest_multi_plain(t, srcs))


@pytest.mark.parametrize("b,n,m", [(2, 300, 500), (32, 1024, 256),
                                   (4, 2048, 4096)])
def test_nearest_multi_ties_and_nans(dev, b, n, m):
    """Duplicated sources on a coarse grid (many exactly equal distances:
    the lower index wins, across a target's lanes too) and a NaN source
    row, a NaN target and an infinite source (the first NaN wins, as
    torch.min's)."""
    g = torch.Generator(device=dev).manual_seed(m)
    grid = lambda *shape: torch.randint(0, 4, shape, generator=g,
                                        device=dev) * 0.25
    s = grid(b, m, 3)
    s[:, m // 2:] = s[:, :m - m // 2]
    t = grid(b, n, 3)
    nan_s = s.clone()
    nan_s[:, m // 3] = float("nan")
    nan_s[:, m // 5, 1] = float("inf")
    nan_t = t.clone()
    nan_t[:, n // 2, 0] = float("nan")
    for tt, srcs in ((t, [s]), (t, [s, nan_s]), (nan_t, [nan_s, s])):
        _assert_nearest_equal(pointops.nearest_multi(tt, srcs),
                              pointops.nearest_multi_plain(tt, srcs))


def test_nearest_rejects_what_the_kernel_does_not_take(dev):
    pts = torch.randn((2, 64, 3), device=dev)
    with pytest.raises(ValueError):
        pointops.nearest(pts[:, ::2], pts)                 # not contiguous
    with pytest.raises(TypeError):
        pointops.nearest(pts.half(), pts.half())
    with pytest.raises(ValueError):
        pointops.nearest(pts, pts.cpu())
    with pytest.raises(ValueError):
        pointops.nearest(pts, pts[:1].contiguous())        # batch sizes
    with pytest.raises(ValueError):
        pointops.nearest_multi(pts, [pts] * 5)             # > 4 clouds
    with pytest.raises(ValueError):
        pointops.nearest_multi(pts, [pts, pts[:1].contiguous()])


def test_min_dists_backward_matches_plain_autograd(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    t = torch.randn((2, 400, 3), generator=g, device=dev).requires_grad_()
    s = torch.randn((2, 300, 3), generator=g, device=dev).requires_grad_()
    w = torch.rand((2, 400), generator=g, device=dev)
    got = torch.autograd.grad((pointops.min_dists(t, s) * w).sum(), (t, s))
    plain = torch.sqrt(torch.clamp(
        pointops.sqdist(t, s).min(dim=-1).values, min=1e-16))
    ref = torch.autograd.grad((plain * w).sum(), (t, s))
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)


def test_function_backwards_match_plain_autograd(dev):
    """The kernels' autograd.Functions: the backward recomputes the plain
    version, so its gradients are those of autograd through it, up to the
    order of the atomic adds in the gather's backward (one ulp: 1e-4 in
    fp32, 2e-2 for bf16 gradients)."""
    nds, dirs, xs, ws, bs, idx, s = _gcn_inputs(dev, 100, 100, 5)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        leaves = [[t.clone().requires_grad_() for t in grp]
                  for grp in (nds, dirs, [x.to(dt) for x in xs], ws, bs)]
        twins = [[t.detach().clone().requires_grad_() for t in grp]
                 for grp in leaves]
        cot = [torch.randn(2, 100, 16, device=dev) for _ in range(3)]
        torch.autograd.backward(gcn.linear_multi(*leaves, idx, s), cot)
        torch.autograd.backward(gcn.linear_multi_plain(*twins, idx, s), cot)
        for grp, tw in zip(leaves, twins):
            for a, b in zip(grp, tw):
                torch.testing.assert_close(a.grad, b.grad, rtol=tol,
                                           atol=tol)
        surf = [[t.clone().requires_grad_() for t in grp]
                for grp in (nds, dirs)]
        stw = [[t.detach().clone().requires_grad_() for t in grp]
               for grp in surf]
        torch.autograd.backward(gcn.surface_multi(*surf, s), cot)
        torch.autograd.backward(gcn.surface_multi_plain(*stw, s), cot)
        for grp, tw in zip(surf, stw):
            for a, b in zip(grp, tw):
                torch.testing.assert_close(a.grad, b.grad, rtol=tol,
                                           atol=tol)


def test_tiny_train_step_launch_counts(dev):
    from pose_estimation_tpu_torch.train.optim import make_optimizer
    from pose_estimation_tpu_torch.train.state import TrainState
    from pose_estimation_tpu_torch.train.train_step import build_train_step
    cfg = TINY
    torch.manual_seed(0)
    model = KRRN(cfg).to(dev)
    tx = make_optimizer(cfg, total_steps=10)
    state = TrainState.create(model, tx,
                              torch.Generator(device=dev).manual_seed(0))
    rng = np.random.RandomState(1)
    b, hw, n = 2, 64, 128
    batch = {
        "img": rng.rand(b, hw, hw, 3), "cloud": rng.randn(b, n, 3) * 0.05
        + [0, 0, 0.8], "choose": rng.randint(0, hw * hw, (b, n)),
        "cls": np.array([0, 1]), "xyz": rng.rand(b, hw, hw, 3),
        "normal": rng.randn(b, hw, hw, 3), "valid": rng.rand(b, hw, hw) > .5,
        "region": rng.randint(0, 9, (b, hw, hw)),
        "multi_cls_mask": rng.randint(0, 3, (b, hw, hw)),
        "target": rng.randn(b, 50, 3) * 0.05 + [0, 0, 0.8],
        "model_points": rng.randn(b, 50, 3) * 0.05,
        "target_r": np.stack([np.eye(3)] * b), "sym_mask": np.array([1., 0.])}
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in
             batch.items()}
    batch = {k: (v.float() if v.is_floating_point() else v.long()
                 if k in ("choose", "cls", "region", "multi_cls_mask") else v)
             for k, v in batch.items()}
    for f in (gcn.linear_multi, gcn.surface_multi, pointops.knn,
              pointops.nearest_multi):
        f.launches = 0
    m = build_train_step(model, tx, cfg)(state, batch, opt_pose=True)
    assert (gcn.linear_multi.launches, gcn.surface_multi.launches,
            pointops.knn.launches,
            pointops.nearest_multi.launches) == (2, 1, 8, 2)
    assert float(m["skipped_nonfinite"]) == 0.0
    assert all(torch.isfinite(v) for v in m.values())


def test_library_is_built_once(dev):
    lib = _build.library()
    assert _build.library() is lib
    so = _build.BUILD_ROOT / _build.source_hash() / "libpose_kernels.so"
    assert so.exists()


def _agg_inputs(dev, n, m, k, d, s, o, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    idx = torch.randint(0, m, (2, n, k), generator=g, device=dev,
                        dtype=torch.int32)
    return (safe_normalize(r(2, n, k, d)), safe_normalize(r(d, s * o), dim=0),
            r(2, m, s * o), idx)


@pytest.mark.parametrize("d,n,k,s,o", [
    (3, 300, 10, 7, 128), (9, 64, 8, 2, 256), (9, 37, 5, 3, 40),
    (3, 5, 1, 1, 1000), (3, 70, 6, 1, 5), (9, 33, 4, 4, 8),
    (3, 130, 7, 5, 600), (9, 20, 3, 6, 1024), (3, 17, 9, 8, 1100),
    (9, 41, 8, 9, 40), (3, 50, 10, 3, 256), (9, 1, 2, 2, 3)])
def test_aggregate_matches_plain(dev, d, n, k, s, o):
    """Kernel 5 against aggregate_plain, bit for bit, for N not a multiple
    of the tile, S = 1..9, D = 3 and 9, O = 3, 5, 8, 40, 128, 256, 600,
    1000, 1024 and 1100 (more 16-byte chunks than a block has threads),
    fp32 and bf16 tables, nd and dirs each fp32 or bf16, and the table
    contiguous or a column slice of a wider one, as the wide ConvLayer
    passes it (16-byte loads where its rows are aligned, else one value at
    a time); one launch a call."""
    m = n + 13
    nd, dirs, feats, idx = _agg_inputs(dev, n, m, k, d, s, o, seed=n + s + o)
    wide = torch.randn((2, m, (s + 1) * o), device=dev)
    for dt in (torch.float32, torch.bfloat16):
        for table in (feats.to(dt), wide.to(dt)[..., o:]):
            for a, b in ((torch.float32, torch.bfloat16),
                         (torch.bfloat16, torch.float32)):
                args = (nd.to(a), dirs.to(b), table, idx, s)
                gcn.aggregate.launches = 0
                got = gcn.aggregate(*args)
                assert gcn.aggregate.launches == 1
                assert got.shape == (2, n, o) and got.dtype == torch.float32
                assert torch.equal(got, gcn.aggregate_plain(*args))


def _pick(dev, vals, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.tensor(vals, device=dev)
    return v[torch.randint(0, len(vals), shape, generator=g, device=dev)]


# bf16 rounding midpoints ((1 + 2^-4)^2 = 1 + 2^-3 + 2^-8, 1 + 2^-8), ±0,
# subnormal values and products (2^-64 * 2^-64, 3 * 2^-66, 2^-133), a
# normal value at the edge (1.5 * 2^-126)
SPECIAL = [0.0, -0.0, 1.0, -1.0, 2.0 ** -4, 1.0 + 2.0 ** -4,
           -(1.0 + 2.0 ** -4), 1.0 + 2.0 ** -7, 0.5, 2.0 ** -3, -2.0 ** -8,
           2.0 ** -64, 3 * 2.0 ** -66, -2.0 ** -130, 2.0 ** -133,
           1.5 * 2.0 ** -126]


@pytest.mark.parametrize("d,s,o", [(3, 3, 16), (9, 2, 256), (9, 7, 40)])
def test_aggregate_rounding_ties_subnormals_and_nans(dev, d, s, o):
    """nd, dirs and table drawn from SPECIAL: the packed bf16x2 products,
    sums and maxima round as PyTorch's fp32-then-bf16 ops at ties and
    below the normal range; then inf in a table row (NaN where theta is
    0), a NaN nd entry and a NaN direction column give the plain
    version's NaN positions."""
    n, m, k = 90, 70, 6
    g = torch.Generator(device=dev).manual_seed(d + s)
    idx = torch.randint(0, m, (2, n, k), generator=g, device=dev,
                        dtype=torch.int32)
    nd = _pick(dev, SPECIAL, (2, n, k, d), 1)
    dirs = _pick(dev, SPECIAL, (d, s * o), 2)
    feats = _pick(dev, SPECIAL, (2, m, s * o), 3)
    for dt in (torch.float32, torch.bfloat16):
        got = gcn.aggregate(nd, dirs, feats.to(dt), idx, s)
        assert torch.equal(got, gcn.aggregate_plain(nd, dirs, feats.to(dt),
                                                    idx, s))
    feats[0, idx[0, 5, 1]] = float("inf")
    feats[1, idx[1, 9, 0], ::3] = -float("inf")
    nd[1, 20, 2, 1] = float("nan")
    dirs[0, o + 1] = float("nan")
    for dt in (torch.float32, torch.bfloat16):
        got = gcn.aggregate(nd, dirs, feats.to(dt), idx, s)
        ref = gcn.aggregate_plain(nd, dirs, feats.to(dt), idx, s)
        assert ref.isnan().any() and ref.isinf().any()
        torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)


def test_aggregate_relu_of_negative_zero(dev):
    """theta = -0 (every product -0), where the kernel's relu is a max.NaN
    with +0 and torch.relu keeps the sign: the outputs compare equal."""
    nd = torch.ones((1, 4, 1, 3), device=dev)
    dirs = torch.full((3, 8), -0.0, device=dev)
    feats = torch.ones((1, 4, 8), device=dev)
    idx = torch.zeros((1, 4, 1), dtype=torch.int32, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        got = gcn.aggregate(nd, dirs, feats.to(dt), idx, 1)
        ref = gcn.aggregate_plain(nd, dirs, feats.to(dt), idx, 1)
        assert torch.equal(got, ref) and not got.any()


def test_aggregate_largest_k(dev):
    """A tile of one point with K = 3000 slots at D = 9 fits in shared
    memory and equals the plain version; K = 5000 does not, and the
    wrapper raises before the launch."""
    for k, ok in ((3000, True), (5000, False)):
        nd, dirs, feats, idx = _agg_inputs(dev, 1, 40, k, 9, 8, 1100)
        gcn.aggregate.launches = 0
        if ok:
            got = gcn.aggregate(nd, dirs, feats, idx, 8)
            assert torch.equal(got, gcn.aggregate_plain(nd, dirs, feats,
                                                        idx, 8))
        else:
            with pytest.raises(ValueError, match="not supported"):
                gcn.aggregate(nd, dirs, feats, idx, 8)
        assert gcn.aggregate.launches == int(ok)


def test_aggregate_backward_matches_plain_autograd(dev):
    nd, dirs, feats, idx = _agg_inputs(dev, 64, 64, 8, 9, 2, 256)
    cot = torch.randn(2, 64, 256, device=dev)
    leaves = [t.clone().requires_grad_() for t in (nd, dirs, feats)]
    twins = [t.clone().requires_grad_() for t in (nd, dirs, feats)]
    gcn.aggregate(*leaves, idx, 2).backward(cot)
    gcn.aggregate_plain(*twins, idx, 2).backward(cot)
    for a, b in zip(leaves, twins):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)


def test_aggregate_theta_only_launches_the_surface_kernel(dev):
    nd, dirs, _, idx = _agg_inputs(dev, 50, 50, 6, 3, 3, 16)
    gcn.aggregate.launches = gcn.surface_multi.launches = 0
    got = gcn.aggregate(nd, dirs, None, idx, 3)
    assert (gcn.aggregate.launches, gcn.surface_multi.launches) == (0, 1)
    ref = gcn.aggregate_plain(nd, dirs, None, idx, 3)
    tol = 2.0 ** -8 * max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= tol
    nd9, dirs9, _, _ = _agg_inputs(dev, 50, 50, 6, 9, 3, 16)
    with pytest.raises(ValueError):
        gcn.aggregate(nd9, dirs9, None, idx, 3)


def test_aggregate_rejects_what_the_kernel_does_not_take(dev):
    nd, dirs, feats, idx = _agg_inputs(dev, 16, 16, 4, 3, 2, 8)
    with pytest.raises(ValueError):
        gcn.aggregate(nd, dirs, feats, idx.long(), 2)
    with pytest.raises(TypeError):
        gcn.aggregate(nd, dirs, feats.half(), idx, 2)
    with pytest.raises(ValueError):
        gcn.aggregate(nd, dirs, feats, idx, 3)           # S*O % S
    with pytest.raises(ValueError):
        gcn.aggregate(nd, dirs, feats.cpu(), idx, 2)     # mixed devices
    nd4, dirs4, feats4, _ = _agg_inputs(dev, 16, 16, 4, 4, 2, 8)
    with pytest.raises(ValueError):
        gcn.aggregate(nd4, dirs4, feats4, idx, 2)        # D = 4


def test_tiny_full_krrn_launch_counts_and_plain_cpu_parity(dev):
    """The full FusionNet at S=2: its first fuse layer is wide, so one
    wide-table aggregate launch per forward beside 3 linear, 1 surface,
    8 KNN and 1 nearest-source launch (both up-sampling maps)."""
    torch.manual_seed(0)
    model = KRRN(TINY, fusion_variant="full").eval()
    rng = np.random.RandomState(0)
    args = (rng.rand(2, 64, 64, 3).astype(np.float32),
            (rng.randn(2, 128, 3) * 0.05 + [0, 0, 0.8]).astype(np.float32),
            rng.randint(0, 64 * 64, (2, 128)).astype(np.int64),
            np.array([0, 1]))
    cpu_args = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        ref = model(*cpu_args)
        model.to(dev)
        for f in (gcn.linear_multi, gcn.surface_multi, pointops.knn,
                  pointops.nearest_multi, gcn.aggregate):
            f.launches = 0
        got = model(*[a.to(dev) for a in cpu_args])
    assert (gcn.linear_multi.launches, gcn.surface_multi.launches,
            pointops.knn.launches, pointops.nearest_multi.launches,
            gcn.aggregate.launches) == (3, 1, 8, 1, 1)
    for key, rtol in (("xyz_emb", 1e-4), ("pred_t", 2e-3)):
        r = ref[key]
        tol = rtol * max(1.0, r.abs().max().item())
        assert (got[key].cpu() - r).abs().max().item() <= tol, key


def _exact_linear_inputs(dev, n, m, k, s, o, cin=12, seed=9):
    """Kernel 1's inputs from values with few significant bits, so that
    theta (FMA or not), the table X @ W + b (in any order, in bf16 too)
    and the products are exact: the kernel and the plain version then
    agree bit for bit, and NaN where they should."""
    nds = [_pick(dev, [0.0, 1.0, -1.0, 0.5, -0.5, 0.25], (2, n, k, 3),
                 seed + i) for i in range(2)]
    dirs = [_pick(dev, [0.0, 1.0, -0.5, 0.5, -0.25], (3, s * o), seed + 2 + i)
            for i in range(2)]
    xs = [_pick(dev, [0.0, 1.0, -1.0, 2.0, 0.5], (2, m, cin), seed + 4 + i)
          for i in range(2)]
    ws = [_pick(dev, [0.0, 0.25, -0.5, 0.5, 1.0], (cin, s * o), seed + 6 + i)
          for i in range(2)]
    bs = [_pick(dev, [0.0, 0.125, -0.125], (s * o,), seed + 8 + i)
          for i in range(2)]
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, m, (2, n, k), generator=g, device=dev,
                        dtype=torch.int32)
    return nds, dirs, xs, ws, bs, idx


def test_linear_multi_propagates_nan(dev):
    """Kernel 1's relu and max over k propagate NaN as the plain
    version's torch.relu and torch.maximum: an inf in an input row (its
    table row +-inf, NaN where W is 0, and NaN where theta is 0), a NaN
    nd entry and a NaN direction column."""
    s, o = 3, 16
    nds, dirs, xs, ws, bs, idx = _exact_linear_inputs(dev, 70, 50, 6, s, o)
    for dt in (torch.float32, torch.bfloat16):
        x = [t.to(dt) for t in xs]
        got = gcn.linear_multi(nds, dirs, x, ws, bs, idx, s)
        for a, r in zip(got, gcn.linear_multi_plain(nds, dirs, x, ws, bs,
                                                    idx, s)):
            assert torch.equal(a, r)
    xs[0][0, idx[0, 4, 1], 3] = float("inf")
    nds[1][1, 8, 2, 0] = float("nan")
    dirs[0][2, o + 3] = float("nan")
    for dt in (torch.float32, torch.bfloat16):
        x = [t.to(dt) for t in xs]
        got = gcn.linear_multi(nds, dirs, x, ws, bs, idx, s)
        ref = gcn.linear_multi_plain(nds, dirs, x, ws, bs, idx, s)
        assert all(r.isnan().any() for r in ref)
        for a, r in zip(got, ref):
            torch.testing.assert_close(a, r, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dt,s,o,ok", [
    (torch.bfloat16, 16, 256, True), (torch.bfloat16, 513, 8, False),
    (torch.float32, 8, 256, True), (torch.float32, 257, 8, False),
    (torch.bfloat16, 9, 128, True), (torch.float32, 12, 40, True)])
def test_linear_multi_row_limit(dev, dt, s, o, ok):
    """Pass B takes S*O up to 512 16-byte chunks (4096 bf16, 2048 fp32
    values) and any S: the last S*O taken runs and equals the plain
    version (bit for bit on exact inputs), the first refused raises
    before any launch."""
    nds, dirs, xs, ws, bs, idx = _exact_linear_inputs(dev, 40, 30, 5, s, o)
    x = [t.to(dt) for t in xs]
    gcn.linear_multi.launches = 0
    if ok:
        got = gcn.linear_multi(nds, dirs, x, ws, bs, idx, s)
        for a, r in zip(got, gcn.linear_multi_plain(nds, dirs, x, ws, bs,
                                                    idx, s)):
            assert torch.equal(a, r)
    else:
        with pytest.raises(ValueError, match="S\\*O <= "):
            gcn.linear_multi(nds, dirs, x, ws, bs, idx, s)
    assert gcn.linear_multi.launches == int(ok)


def test_surface_and_knn_limits_raise_before_launch(dev):
    """The first value past each limit: K = 129 and 5 streams for the
    surface kernel, 33 neighbours for KNN."""
    nds, dirs, _, _, _, _, s = _gcn_inputs(dev, 20, 20, 129, streams=1)
    gcn.surface_multi.launches = pointops.knn.launches = 0
    with pytest.raises(ValueError, match="K <= 128"):
        gcn.surface_multi(nds, dirs, s)
    nds, dirs, _, _, _, _, s = _gcn_inputs(dev, 20, 20, 8, streams=5)
    with pytest.raises(ValueError, match="at most 4 streams"):
        gcn.surface_multi(nds, dirs, s)
    pts = torch.randn((2, 64, 3), device=dev)
    with pytest.raises(ValueError, match="<= 32 neighbours"):
        pointops.knn(pts, pts, 32, True)
    with pytest.raises(ValueError, match="<= 32 neighbours"):
        pointops.knn(pts, pts, 33, False)
    assert gcn.surface_multi.launches == pointops.knn.launches == 0


def _neighbours(cfg, k):
    return schema.override(cfg, **{"module.gcn3d": schema.Gcn3dConfig(
        neighbor_num=k, support_num=cfg.module.gcn3d.support_num)})


def test_serving_step_checks_the_config_before_any_launch(dev):
    """neighbor_num = 31, the last taken: the tiny KRRN on the card runs
    and matches its CPU forward; 32 raises in build_infer_step, naming
    the config field, and nothing launches."""
    from pose_estimation_tpu_torch.serve import build_infer_step
    rng = np.random.RandomState(0)
    args = (rng.rand(2, 64, 64, 3).astype(np.float32),
            (rng.randn(2, 128, 3) * 0.05 + [0, 0, 0.8]).astype(np.float32),
            rng.randint(0, 64 * 64, (2, 128)).astype(np.int64),
            np.array([0, 1]))
    cpu_args = [torch.from_numpy(a) for a in args]
    cfg = _neighbours(TINY, 31)
    torch.manual_seed(0)
    model = KRRN(cfg).eval()
    with torch.no_grad():
        ref = model(*cpu_args)
        model.to(dev)
        build_infer_step(model, cfg)
        got = model(*[a.to(dev) for a in cpu_args])
    r = ref["pred_t"]
    assert ((got["pred_t"].cpu() - r).abs().max().item()
            <= 2e-3 * max(1.0, r.abs().max().item()))
    cfg = _neighbours(TINY, 32)
    model = KRRN(cfg).to(dev).eval()
    pointops.knn.launches = 0
    with pytest.raises(ValueError, match=r"module\.gcn3d\.neighbor_num"):
        build_infer_step(model, cfg)
    assert pointops.knn.launches == 0


CLI_CONFIG = """\
from pose_estimation_tpu_torch.configs import schema


def get_config():
    return schema.override(schema.Config(), **{
        "module.num_cls": 2, "data.num_regions": 8, "data.num_points": 128,
        "data.input_size": 64, "module.backbone_outc": 16,
        "module.stem_width": 8,
        "module.hrnet_stages": ((1, 1, (8, 8)), (1, 1, (8, 8, 16)),
                                (1, 1, (8, 8, 16, 16))),
        "module.xyznet": schema.HeadConfig(hidden=16),
        "module.nmlnet": schema.HeadConfig(hidden=16),
        "module.gcn3d": schema.Gcn3dConfig(neighbor_num=4, support_num=2),
        "train.amp": False, "train.batch_size": 2,
        "train.start_pose_epoch": 0})
"""


def test_cli_trains_on_a_linemod_tree_on_the_card(dev, tmp_path):
    """cli.py --dataset linemod on a fake BOP tree (PNG files written with
    OpenCV): one debug step (2 train_pbr frames at bs=2) and one
    eval batch on the card. Launches: the train step's 2 linear, 1
    surface, 8 KNN and 2 nearest-source (the up-sampling maps, the pose
    loss), then the eval forward's 2, 1, 8 and 2 (the up-sampling maps,
    ADD-S)."""
    import json

    from pose_estimation_tpu_torch import cli
    from pose_estimation_tpu_torch.data.testing import write_fake_bop_tree
    root = str(tmp_path / "bop")
    write_fake_bop_tree(root, num_objects=2, frames_per_object=1)
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text(CLI_CONFIG)
    for f in (gcn.linear_multi, gcn.surface_multi, pointops.knn,
              pointops.nearest_multi, gcn.aggregate):
        f.launches = 0
    assert cli.main(["--config", str(cfg_file), "--dataset", "linemod",
                     "--cls_type", "all", "--dataset_root", root,
                     "--log_dir", str(tmp_path / "run"), "--debug",
                     "--epochs", "1"]) == 0
    assert (gcn.linear_multi.launches, gcn.surface_multi.launches,
            pointops.knn.launches, pointops.nearest_multi.launches,
            gcn.aggregate.launches) == (4, 2, 16, 4, 0)
    train = [json.loads(x) for x in
             (tmp_path / "run" / "train.jsonl").read_text().splitlines()]
    evals = [json.loads(x) for x in
             (tmp_path / "run" / "eval.jsonl").read_text().splitlines()]
    assert len(train) == 1 and np.isfinite(train[0]["loss"])
    assert evals[0]["count"] == 2 and np.isfinite(evals[0]["add_dis"])


def _synthetic_batch(dev):
    from pose_estimation_tpu_torch.data.batching import make_batch
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    ds = SyntheticPoseDataset(num_objects=2, frames_per_object=2, im_h=240,
                              im_w=320, num_regions=8)
    batch = make_batch(ds, [0, 3], torch.Generator().manual_seed(0), 64, 128)
    return {k: v.to(dev) for k, v in batch.items()}


def test_bn_refine_adam_train_step_kernels_vs_plain(dev, monkeypatch):
    """The training options off in the shipped config (BatchNorm, the
    refine loss, Adam) on a tiny model: one step's losses, gradient norm
    and moved running statistics with the kernels against the plain
    versions from the same weights, statistics and draws; launches 2, 1,
    8 and 3 (the refine loss's ADD(-S) adds a nearest-source call)."""
    from pose_estimation_tpu_torch.train.optim import make_optimizer
    from pose_estimation_tpu_torch.train.state import TrainState
    from pose_estimation_tpu_torch.train.train_step import build_train_step
    cfg = schema.override(TINY, **{"module.norm": "bn", "train.refine": True,
                                   "train.optimizer.type": "Adam",
                                   "train.batch_size": 2})
    torch.manual_seed(0)
    model = KRRN(cfg).to(dev)
    tx = make_optimizer(cfg, total_steps=10)
    state = TrainState.create(model, tx,
                              torch.Generator(device=dev).manual_seed(0))
    step = build_train_step(model, tx, cfg)
    batch = _synthetic_batch(dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def run():
        model.load_state_dict(start)
        state.generator.manual_seed(1)
        losses = step.losses(batch, True, True, state.generator)
        grads = step.gradients(losses)
        gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
        return ({k: losses[k].item() for k in ("loss", "loss_refine")},
                float(gn), {k: v.clone() for k, v in model.named_buffers()})

    for f in (gcn.linear_multi, gcn.surface_multi, pointops.knn,
              pointops.nearest_multi):
        f.launches = 0
    got = run()
    assert (gcn.linear_multi.launches, gcn.surface_multi.launches,
            pointops.knn.launches,
            pointops.nearest_multi.launches) == (2, 1, 8, 3)
    for name in ("linear_multi", "surface_multi", "aggregate"):
        monkeypatch.setattr(gcn, name, getattr(gcn, f"{name}_plain"))
    for name in ("knn", "nearest_multi"):
        monkeypatch.setattr(pointops, name, getattr(pointops, f"{name}_plain"))
    ref = run()
    for k, v in ref[0].items():
        assert abs(got[0][k] - v) <= 2e-2 * max(1.0, abs(v)), k
    assert abs(got[1] - ref[1]) <= 2e-2 * ref[1]
    for k, v in ref[2].items():
        assert not torch.equal(v, start[k]), k
        assert (got[2][k] - v).abs().max() <= 1e-3 * max(1.0, v.abs().max())
    monkeypatch.undo()
    model.load_state_dict(start)
    m = step(state, batch, opt_pose=True)
    assert float(m["skipped_nonfinite"]) == 0.0
    assert all(torch.isfinite(v) for v in m.values())


def test_pnp_implicit_backward_on_the_card_matches_the_cpu(dev):
    from pose_estimation_tpu_torch.core.solvers.pnp import pnp_implicit
    g = torch.Generator().manual_seed(0)
    b, n = 4, 64
    pw = (torch.rand(b, n, 3, generator=g) - 0.5) * 0.2
    pose = torch.cat([torch.randn(b, 3, generator=g) * 0.5,
                      torch.tensor([[0.02, -0.01, 0.8]]).expand(b, 3)], -1)
    k = torch.tensor([[572.4, 0.0, 325.3], [0.0, 573.6, 242.0],
                      [0.0, 0.0, 1.0]]).expand(b, 3, 3)
    uv = torch.rand(b, n, 2, generator=g) * 40 + 300
    w = torch.rand(b, n, generator=g) + 0.1
    cot = torch.randn(b, 6, generator=g)
    grads = []
    for d in ("cpu", dev):
        args = [t.to(d).clone().requires_grad_() for t in (pw, uv, k)]
        out = pnp_implicit(pose.to(d), *args, w.to(d))
        (out * cot.to(d)).sum().backward()
        grads.append([a.grad.cpu() for a in args])
    for ref, got in zip(*grads):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()


def _group_step(norm, dev):
    """One train step of the tiny model (`norm`) from a seeded state:
    its metrics and the updated parameters."""
    from pose_estimation_tpu_torch.train.optim import make_optimizer
    from pose_estimation_tpu_torch.train.state import TrainState
    from pose_estimation_tpu_torch.train.train_step import build_train_step
    cfg = schema.override(TINY, **{"module.norm": norm,
                                   "train.batch_size": 2})
    torch.manual_seed(0)
    model = KRRN(cfg).to(dev)
    tx = make_optimizer(cfg, total_steps=10)
    state = TrainState.create(model, tx,
                              torch.Generator(device=dev).manual_seed(0))
    m = build_train_step(model, tx, cfg)(state, _synthetic_batch(dev),
                                         opt_pose=True)
    return ({k: v.item() for k, v in m.items()},
            {k: p.detach().clone() for k, p in model.named_parameters()})


def _step_delta(a, b):
    """(bit for bit, {metric: |delta| / max(1, |a|)}, parameters' max
    rel |delta|)."""
    (ma, pa), (mb, pb) = a, b
    dp = max((v - pb[k]).abs().max().item() / max(1.0, v.abs().max().item())
             for k, v in pa.items())
    return (ma == mb and dp == 0.0,
            {k: abs(v - mb[k]) / max(1.0, abs(v)) for k, v in ma.items()},
            dp)


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms where it has them (warnings
    where it has none), cuDNN's deterministic ones; restored after."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    yield
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    torch.backends.cudnn.deterministic = saved[2]


@pytest.mark.parametrize("norm", ["gn", "bn"])
def test_nccl_group_of_one_step_equals_no_group(dev, tmp_path, norm,
                                                deterministic):
    """A train step in a 1-process NCCL group against one without a group,
    from the same state (after a warm-up step): bit for bit where two
    steps without a group are. Where they are not (a backward that
    accumulates with atomics), each metric within 4x the two steps' own
    spread (at least 1e-6, and 1e-3 for the gradient norm, which varied
    by up to 3.8e-4 from run to run in chip_smoke.py phase 14) and the
    updated parameters within 1e-5 (Ranger's normalised update)."""
    from pose_estimation_tpu_torch.parallel import dist
    _group_step(norm, dev)                               # warm-up
    ref = _group_step(norm, dev)
    same_twice, spread, _ = _step_delta(ref, _group_step(norm, dev))
    assert dist.distributed_init("nccl", f"file://{tmp_path / 'store'}", 1,
                                 0)
    try:
        got = _group_step(norm, dev)
    finally:
        dist.destroy()
    same, delta, dp = _step_delta(ref, got)
    if same_twice:
        assert same, (delta, dp)
    else:
        floor = {"grad_norm": 1e-3}
        assert all(v <= max(4 * spread[k], floor.get(k, 1e-6))
                   for k, v in delta.items()), (spread, delta)
        assert dp <= 1e-5, dp


def test_ring_ops_on_one_rank_equal_the_kernels(dev, tmp_path):
    """A 1-process NCCL group: ring_min_dists is kernel 4's nearest
    distance bit for bit, ring_knn's indices are the KNN kernel's."""
    from pose_estimation_tpu_torch.parallel import dist
    from pose_estimation_tpu_torch.parallel.ring_pointops import (
        ring_knn, ring_min_dists)
    g = torch.Generator(device=dev).manual_seed(3)
    tgt, src, pts = (torch.rand(n, 3, generator=g, device=dev)
                     for n in (700, 900, 600))
    assert dist.distributed_init("nccl", f"file://{tmp_path / 'store'}", 1,
                                 0)
    try:
        d = ring_min_dists()(tgt, src)
        kd, ki = ring_knn(None, 10)(pts)
    finally:
        dist.destroy()
    assert torch.equal(d, pointops.nearest(tgt[None], src[None])[0][0])
    assert torch.equal(ki, pointops.knn(pts[None], pts[None], 10, True)[0])
    direct = ((pts[ki.long()] - pts[:, None]) ** 2).sum(-1).sqrt()
    torch.testing.assert_close(kd, direct, rtol=0, atol=1e-5)


# --- the transparent pipeline (kernel 4 at its shapes) ----------------------

def _transparent_batch(dev, b=4, h=32, m=16, seed=0):
    rng = np.random.RandomState(seed)
    mp = (rng.randn(b, m, 3) * 0.05).astype(np.float32)
    normal = rng.randn(b, h, h, 3).astype(np.float32)
    normal[:, :5] = 0.0
    batch = {
        "img": rng.rand(b, h, h, 3), "intrinsic": np.tile(
            [[300.0, 300.0, h / 2, h / 2]], (b, 1)),
        "xmap": np.tile(np.arange(h)[None, None, :], (b, h, 1)),
        "ymap": np.tile(np.arange(h)[None, :, None], (b, 1, h)),
        "d_scale": np.ones(b), "obj": np.arange(b) % 3,
        "target": mp + [0.0, 0.0, 0.8], "model_points": mp,
        "sym_mask": np.arange(b) % 2 == 0,
        "axis": np.tile([[0.0, 0.0, 1.0]], (b, 1)),
        "r": np.broadcast_to(np.eye(3), (b, 3, 3)),
        "t": np.tile([0.0, 0.0, 0.8], (b, 1)), "normal": normal,
        "depth": rng.rand(b, h, h, 1), "mask": rng.rand(b, h, h, 1)}
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.array(v))
        out[k] = (t.int() if k == "obj" else t.float()).to(dev)
    return out


def test_transparent_step_and_eval_launches_and_cpu_parity(dev):
    """The tiny TRPESNet (fp32) on the card: one kernel 4 launch a train
    step, one an eval batch, 1 + iters + 1 + 1 with ICP; the step's loss
    terms against the same step on the CPU (the plain version) at 1e-4
    relative, the eval's add_dis and ICP flags against the CPU's."""
    from pose_estimation_tpu_torch.models.transparent import TRPESNet
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        TransparentTrainStep, build_transparent_eval_step)
    torch.manual_seed(0)
    model = TRPESNet(32, 3)
    batch = _transparent_batch(dev)
    choose = torch.randperm(32 * 32, generator=torch.Generator()
                            .manual_seed(1))[:32]
    terms = {}
    for where in ("cuda", "cpu"):
        model.to(where)
        tb = {k: v.to(where) for k, v in batch.items()}
        step = TransparentTrainStep(model, None, dict.fromkeys(
            ("distance", "rotation", "normal", "depth", "mask"), 1.0))
        pointops.nearest_multi.launches = 0
        losses = step.losses(tb, choose.to(where))
        step.gradients(losses)
        terms[where] = {k: v.item() for k, v in losses.items()}
        if where == "cuda":
            assert pointops.nearest_multi.launches == 1
            for icp_on, want in ((False, 1), (True, 1 + 4 + 1 + 1)):
                ev = build_transparent_eval_step(model, icp_on, icp_iters=4,
                                                 icp_points=64)
                pointops.nearest_multi.launches = 0
                out = ev(tb)
                assert pointops.nearest_multi.launches == want
            cuda_out = {k: v.cpu() for k, v in out.items()}
        else:
            cpu_out = ev(tb)
    for k, v in terms["cpu"].items():
        assert abs(terms["cuda"][k] - v) <= 1e-4 * max(1.0, abs(v)), k
    torch.testing.assert_close(cuda_out["add_dis"], cpu_out["add_dis"],
                               rtol=1e-4, atol=1e-6)
    assert torch.equal(cuda_out["icp_accepted"], cpu_out["icp_accepted"])


def test_posenet_step_launches_and_cpu_parity(dev):
    """The tiny TransparentPoseNet (fp32, 48-px crops) on the card: one
    kernel 4 launch a train step from the same pixels and dropout masks,
    its loss terms (loss_b among them) against the CPU's at 1e-4
    relative; one launch an eval batch, its add_dis against the CPU's."""
    from pose_estimation_tpu_torch.models.pspnet import TransparentPoseNet
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        TransparentTrainStep, build_transparent_eval_step)
    torch.manual_seed(0)
    model = TransparentPoseNet(3, 32)
    batch = _transparent_batch(dev, h=48)
    batch["boundary"] = (batch["mask"] > 0.9).float()
    step = TransparentTrainStep(model, None, dict.fromkeys(
        ("distance", "rotation", "normal", "depth", "mask", "boundary"),
        1.0))
    choose, masks = step.draws(torch.Generator().manual_seed(1),
                               {k: v.cpu() for k, v in batch.items()})
    terms, adds = {}, {}
    for where in ("cuda", "cpu"):
        model.to(where)
        tb = {k: v.to(where) for k, v in batch.items()}
        pointops.nearest_multi.launches = 0
        losses = step.losses(tb, choose.to(where),
                             [m.to(where) for m in masks])
        step.gradients(losses)
        terms[where] = {k: v.item() for k, v in losses.items()}
        adds[where] = build_transparent_eval_step(model)(tb)["add_dis"].cpu()
        if where == "cuda":
            assert pointops.nearest_multi.launches == 2
    assert terms["cpu"]["loss_b"] > 0
    for k, v in terms["cpu"].items():
        assert abs(terms["cuda"][k] - v) <= 1e-4 * max(1.0, abs(v)), k
    torch.testing.assert_close(adds["cuda"], adds["cpu"], rtol=1e-4,
                               atol=1e-6)


def test_nearest_at_eps_zero_and_icp_on_the_card(dev):
    """Kernel 4 with eps = 0 (ICP's trimmed residual) equals the plain
    version bit for bit, a coincident pair at distance 0; gated ICP on
    the card against the CPU: the same accept flags, rotations and
    translations within 1e-4."""
    from pose_estimation_tpu_torch.core.solvers.icp import gated_icp_refine
    g = torch.Generator(device=dev).manual_seed(4)
    t = torch.randn(3, 256, 3, generator=g, device=dev) * 0.05
    s = torch.randn(3, 500, 3, generator=g, device=dev) * 0.05
    t[1, 7] = s[1, 11]
    got = pointops.nearest_multi(t, [s, s[:, :300].contiguous()], eps=0.0)
    ref = pointops.nearest_multi_plain(t, [s, s[:, :300].contiguous()],
                                       eps=0.0)
    for (d, i), (dp, ip) in zip(got, ref):
        assert torch.equal(d, dp) and torch.equal(i, ip)
    assert got[0][0][1, 7].item() == 0.0
    src = s[:, :200].contiguous()
    dst = (src[:, :64] + torch.tensor([0.004, -0.002, 0.003],
                                      device=dev)).contiguous()
    eye = torch.eye(3, device=dev).expand(3, 3, 3).contiguous()
    zero = torch.zeros(3, 3, device=dev)
    out = gated_icp_refine(src, dst, eye, zero, trim_fraction=0.3)
    cpu = gated_icp_refine(src.cpu(), dst.cpu(), eye.cpu(), zero.cpu(),
                           trim_fraction=0.3)
    assert torch.equal(out[2].cpu(), cpu[2])
    for a, b in zip(out[:2], cpu[:2]):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)


def test_farthest_point_sampling_on_the_card_equals_the_cpu(dev):
    g = torch.Generator().manual_seed(5)
    pts = torch.randn(3, 700, 3, generator=g)
    from pose_estimation_tpu_torch.core.pointops import (
        farthest_point_sampling)
    got = farthest_point_sampling(pts.to(dev), 64, start_index=3)
    assert got.is_cuda
    assert torch.equal(got.cpu(), farthest_point_sampling(pts, 64,
                                                          start_index=3))


def test_umeyama_ransac_and_epnp_on_the_card_match_the_cpu(dev):
    """umeyama_ransac with the same hypotheses: R, t, scale within 1e-5,
    the inlier mask equal; the full EPnP (both null bases) on 128-point
    scenes in a box of distinct sides within 1e-4 (the well-posed scenes
    of tests/test_torch_geometry_rest.py)."""
    from pose_estimation_tpu_torch.core.geometry import (
        axis_angle_to_matrix, umeyama_ransac)
    from pose_estimation_tpu_torch.core.solvers import epnp
    from pose_estimation_tpu_torch.tools.parity_check import make_scenes
    rng = np.random.RandomState(5)
    src = torch.from_numpy((rng.rand(64, 3) - 0.5).astype(np.float32) * 0.2)
    r = axis_angle_to_matrix(torch.from_numpy(rng.randn(3).astype(
        np.float32)))
    dst = 1.3 * src @ r.T + torch.tensor([0.1, -0.05, 0.8])
    dst[:12] += torch.from_numpy(rng.uniform(-0.3, 0.3, (12, 3)).astype(
        np.float32))
    hyp = torch.randint(0, 64, (128, 4), generator=torch.Generator()
                        .manual_seed(0))
    got = umeyama_ransac(None, src.to(dev), dst.to(dev), hypotheses=hyp)
    ref = umeyama_ransac(None, src, dst, hypotheses=hyp)
    for a, b in zip(got[:3], ref[:3]):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    assert torch.equal(got[3].cpu(), ref[3])

    scenes = make_scenes(4, 128, 1.0, 0.0, seed=1)
    box = torch.tensor([0.16, 0.10, 0.05], dtype=torch.float64) / 0.12
    pw = torch.stack([torch.from_numpy(s["pw"]) * box for s in scenes])
    r_gt = torch.stack([torch.from_numpy(s["r"]) for s in scenes])
    t_gt = torch.stack([torch.from_numpy(s["t"]) for s in scenes])
    k = torch.from_numpy(scenes[0]["k"])
    pc = pw @ r_gt.transpose(-1, -2) + t_gt[:, None]
    uv = pc @ k.T
    uv = uv[..., :2] / uv[..., 2:] + torch.from_numpy(
        rng.randn(4, 128, 2))
    args = [x.float() for x in (pw, uv, k.expand(4, 3, 3))]
    for basis in ("iterative", "eigh"):
        got = epnp(*(a.to(dev) for a in args), null_basis=basis)
        ref = epnp(*args, null_basis=basis)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)


def test_parity_check_backends_on_the_card(dev):
    """parity_check.run_backend on the card and on the CPU with the same
    draws: the rotation round trips within 1e-5 on both; each row's
    errors within chip_smoke.py's PARITY_TOL of the CPU's."""
    import chip_smoke
    from pose_estimation_tpu_torch.tools import parity_check
    scenes = parity_check.make_scenes(4, 128, 1.0, 0.25)
    draws = parity_check.draw(scenes)
    cpu = parity_check.run_backend(torch.device("cpu"), scenes, draws)
    card = parity_check.run_backend(dev, scenes, draws)
    for a, b in zip(card, cpu):
        assert a["rot_roundtrip"] <= 1e-5 and b["rot_roundtrip"] <= 1e-5
        for key, tol in chip_smoke.PARITY_TOL.items():
            assert abs(a[key] - b[key]) <= tol, (key, a[key], b[key])


# (channels, input side, output side) of every square resize of the main
# paths: the shipped HRNet's fuse layers and concat (96 to 256 channels),
# the KRRN heads' 64 -> 128, the UNet's 2x at 256-px crops, PSPNet's
# pyramid priors 3 -> 32 and 6 -> 32
RESIZE_SQUARES = [(96, 16, 32), (96, 8, 32), (96, 8, 16), (96, 4, 32),
                  (96, 4, 16), (128, 4, 8), (128, 8, 32), (256, 4, 32),
                  (128, 64, 128), (256, 16, 32), (128, 32, 64),
                  (64, 128, 256), (512, 3, 32), (512, 6, 32)]
# (planes, (h, w) in, (h, w) out): ragged widths, runs that cross rows and
# planes, a short last chunk, an unchanged height
RESIZE_RAGGED = [(6, (5, 7), (13, 21)), (3, (3, 3), (9, 37)),
                 (3, (2, 5), (3, 11)), (4, (4, 6), (16, 24)),
                 (5, (7, 9), (7, 30)), (1, (1, 1), (1, 3))]


def _resize_input(dev, shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev) * 3


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hi,ho", RESIZE_SQUARES)
def test_resize_equals_interpolate_bit_for_bit(dev, dt, c, hi, ho):
    """The kernel against F.interpolate (ATen's own kernel) at every
    resize shape of the main paths: the same bits."""
    x = _resize_input(dev, (2, c, hi, hi)).to(dt)
    got = resize.resize_bilinear(x, ho, ho)
    ref = resize.resize_bilinear_plain(x, ho, ho)
    assert got.shape == ref.shape and got.dtype == dt
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("planes,hw_in,hw_out", RESIZE_RAGGED)
def test_resize_ragged_widths_bit_for_bit(dev, dt, planes, hw_in, hw_out):
    x = _resize_input(dev, (1, planes, *hw_in), seed=1).to(dt)
    got = resize.resize_bilinear(x, *hw_out)
    assert torch.equal(got, resize.resize_bilinear_plain(x, *hw_out))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("shape,hw_out", [
    ((2, 96, 16, 16), (32, 32)), ((2, 128, 4, 4), (8, 8)),
    ((2, 20, 5, 7), (13, 21)), ((3, 3, 2, 5), (3, 11)),
    ((1, 17, 8, 8), (8, 30))])
def test_resize_channels_last_bit_for_bit(dev, dt, shape, hw_out):
    """A channels-last map (the BatchNorm models' layout from their NHWC
    input on): F.interpolate's values in F.interpolate's layout, lane
    counts that do and do not fill a 16-byte chunk, below and above the
    16 channels from which ATen takes its channels-last kernel, at ratios
    whose weights are not short binary fractions (so that the kernels'
    FMAs show)."""
    x = _resize_input(dev, shape, seed=4).to(dt).to(
        memory_format=torch.channels_last)
    got = resize.resize_bilinear(x, *hw_out)
    ref = resize.resize_bilinear_plain(x, *hw_out)
    assert got.stride() == ref.stride() and torch.equal(got, ref)


@pytest.mark.parametrize("dt,hi,ho,span", [(torch.float32, 8, 32, 4),
                                           (torch.bfloat16, 16, 32, 1),
                                           (torch.bfloat16, 64, 128, 1)])
def test_resize_backward_equals_interpolate(dev, dt, hi, ho, span):
    """The op's gradient is F.interpolate's: ATen's backward, which adds
    with atomics in no fixed order, so the output gradients are integers
    in [-span, span] and the ratios powers of 2, where every partial sum is
    exact in the dtype: then the two agree bit for bit."""
    x = _resize_input(dev, (2, 96, hi, hi), seed=2).to(dt)
    g = torch.Generator(device=dev).manual_seed(3)
    w = torch.randint(-span, span + 1, (2, 96, ho, ho), generator=g,
                      device=dev).to(dt)
    grads = []
    for fn in (resize.resize_bilinear, resize.resize_bilinear_plain):
        xg = x.clone().requires_grad_(True)
        fn(xg, ho, ho).backward(w)
        grads.append(xg.grad)
    assert grads[0].dtype == dt and torch.equal(*grads)


def test_resize_rejects_what_the_kernel_does_not_take(dev):
    x = torch.randn((2, 4, 8, 8), device=dev)
    with pytest.raises(TypeError):
        resize.resize_bilinear(x.double(), 16, 16)
    with pytest.raises(ValueError):
        resize.resize_bilinear(x[0], 16, 16)                    # 3-D
    with pytest.raises(ValueError):
        resize.resize_bilinear(x[..., ::2], 16, 16)             # strided
    with pytest.raises(ValueError):
        resize.resize_bilinear(x.transpose(2, 3), 16, 16)       # NCWH


@pytest.mark.parametrize("which,want", [("tiny", 15), ("tiny_bn", 15),
                                        ("shipped", 36)])
def test_krrn_forward_resize_launches(dev, which, want):
    """One launch a resize of the forward: the tiny HRNet's 1 + 3 + 6 fuse
    resizes, 3 for the concat and 2 in the heads (with BatchNorm too,
    whose maps are channels-last); the shipped one's 1 + 12 + 18 + 3 +
    2."""
    cfg = {"tiny": TINY, "shipped": schema.Config(),
           "tiny_bn": schema.override(TINY, **{"module.norm": "bn"})}[which]
    hw, n = cfg.data.input_size, cfg.data.num_points
    torch.manual_seed(0)
    model = KRRN(cfg).eval().to(dev)
    rng = np.random.RandomState(0)
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.rand(2, hw, hw, 3).astype(np.float32),
        (rng.randn(2, n, 3) * 0.05 + [0, 0, 0.8]).astype(np.float32),
        rng.randint(0, hw * hw, (2, n)).astype(np.int64), np.array([0, 1]))]
    resize.resize_bilinear.launches = 0
    with torch.no_grad():
        out = model(*args)
    assert resize.resize_bilinear.launches == want
    assert torch.isfinite(out["pred_t"]).all()

"""The port's CUDA kernels on a card, against their plain versions.

Every test here needs a CUDA card and skips without one. The file imports
no JAX; on the machine with the card it runs on its own:

  python -m pytest --noconftest -p no:cacheprovider -m gpu \
      tests/test_torch_gpu.py -q

(--noconftest skips tests/conftest.py, which sets JAX up for the CPU
tests.) chip_smoke.py checks the
serving path's full shapes; these tests cover small and ragged shapes, the
wrappers' input checks and the launch counts of a tiny model.
"""

import numpy as np
import pytest
import torch

from pose_estimation_tpu.configs import schema
from pose_estimation_tpu_torch.core.mathsafe import safe_normalize
from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.ops import _build, gcn, pointops

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


@pytest.mark.parametrize("n,m,o", [(300, 300, 16), (37, 90, 40),
                                   (64, 64, 128)])
def test_linear_multi_matches_plain(dev, n, m, o):
    nds, dirs, xs, ws, bs, idx, s = _gcn_inputs(dev, n, m, 6, o=o)
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
            tol = 2.0 ** -8 * max(1.0, b.abs().max().item())
            torch.testing.assert_close(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("nq,nk,k,ex", [(300, 300, 10, True),
                                        (75, 300, 4, True),
                                        (40, 1500, 16, False),
                                        (2000, 2000, 3, True)])
def test_knn_matches_plain(dev, nq, nk, k, ex):
    g = torch.Generator(device=dev).manual_seed(1)
    keys = torch.randn((2, nk, 3), generator=g, device=dev)
    q = (keys[:, ::nk // nq][:, :nq].contiguous() if ex
         else torch.randn((2, nq, 3), generator=g, device=dev))
    got = pointops.knn(q, keys, k, ex)
    ref = pointops.knn_plain(q, keys, k, ex)
    assert got.shape == (2, nq, k) and got.dtype == torch.int32
    assert (got == ref).float().mean().item() > 0.999


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    pts = torch.randn((2, 64, 3), device=dev)
    with pytest.raises(ValueError):
        pointops.knn(pts[:, ::2], pts, 4, True)           # not contiguous
    with pytest.raises(TypeError):
        pointops.knn(pts.double(), pts.double(), 4, True)
    with pytest.raises(ValueError):
        pointops.knn(pts, pts, 40, True)                   # k+1 > 17
    with pytest.raises(ValueError):
        pointops.knn(pts, pts.cpu(), 4, True)              # mixed devices
    nds, dirs, xs, ws, bs, idx, s = _gcn_inputs(dev, 16, 16, 4)
    with pytest.raises(ValueError):
        gcn.linear_multi(nds, dirs, xs, ws, bs, idx.long(), s)
    with pytest.raises(TypeError):
        gcn.linear_multi(nds, dirs, [x.half() for x in xs], ws, bs, idx, s)


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
        for f in (gcn.linear_multi, gcn.surface_multi, pointops.knn):
            f.launches = 0
        got = model(*[a.to(dev) for a in cpu_args])
    assert (gcn.linear_multi.launches, gcn.surface_multi.launches,
            pointops.knn.launches) == (2, 1, 8)
    for key, rtol in (("xyz_emb", 1e-4), ("pred_t", 2e-3)):
        r = ref[key]
        tol = rtol * max(1.0, r.abs().max().item())
        assert (got[key].cpu() - r).abs().max().item() <= tol, key


def test_library_is_built_once(dev):
    lib = _build.library()
    assert _build.library() is lib
    so = _build.BUILD_ROOT / _build.source_hash() / "libpose_kernels.so"
    assert so.exists()

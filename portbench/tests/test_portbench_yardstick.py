"""The frozen yardstick: the op files' least-time functions against
chip_smoke.py's at phase 3's shapes (kernel 6's at check_resize's), the
FLOP count against a hand count, and the trace reduction on traces of
known intervals."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import found, trace
from portbench.reference.layers import Conv, Dense, Precision
from portbench.spans import OP_PREFIX, STAGE_PREFIX, WINDOW

ROOT = Path(__file__).resolve().parents[2]
OPS = found.ops()


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    return pytest.importorskip("chip_smoke")


def _gcn(n, m, k, streams=3, cin=128, s=7, o=128, b=32, dt=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, m, (b, n, k), generator=g, dtype=torch.int32)
    nds = [torch.randn(b, n, k, 3, generator=g) for _ in range(streams)]
    dirs = [torch.randn(3, s * o, generator=g) for _ in range(streams)]
    xs = [torch.randn(b, m, cin, generator=g).to(dt) for _ in range(streams)]
    ws = [torch.randn(cin, s * o, generator=g) for _ in range(streams)]
    bs = [torch.randn(s * o, generator=g) for _ in range(streams)]
    return nds, dirs, xs, ws, bs, idx, s


@pytest.mark.parametrize("n", (1024, 256))
def test_linear_bound_is_chip_smokes(smoke, n):
    nds, dirs, xs, ws, bs, idx, s = _gcn(n, n, 10)
    want = smoke.bound(smoke.linear_bytes(nds, dirs, xs, ws, bs, idx, s),
                       smoke.linear_ops(nds, xs, ws, idx, s))[0] * 1e-3
    got = OPS["linear_multi"].least(nds, dirs, xs, ws, bs, idx, s)
    assert got == pytest.approx(want, rel=1e-12)


def test_aggregate_bound_is_chip_smokes(smoke):
    g = torch.Generator().manual_seed(1)
    nd = torch.randn(32, 1024, 10, 3, generator=g)
    dirs = torch.randn(3, 7 * 128, generator=g)
    feats = torch.randn(32, 1024, 7 * 128, generator=g).to(torch.bfloat16)
    idx = torch.randint(0, 1024, (32, 1024, 10), generator=g,
                        dtype=torch.int32)
    want = smoke.aggregate_bound(nd, dirs, feats, idx, 7)[0] * 1e-3
    assert OPS["aggregate"].least(nd, dirs, feats, idx, 7) == \
        pytest.approx(want, rel=1e-12)


def test_point_and_surface_bounds_are_chip_smokes(smoke):
    nb = smoke.nbytes
    q = torch.randn(32, 1024, 3)
    idx = torch.zeros(32, 1024, 10, dtype=torch.int32)
    want = smoke.bound(nb(q) + nb(idx), {"fp32": 32 * 1024 * 1024 * 9})[0]
    assert OPS["knn"].least(q, q, 10, True) == pytest.approx(want * 1e-3)
    t, s1, s2 = torch.randn(8, 1024, 3), torch.randn(8, 256, 3), \
        torch.randn(8, 64, 3)
    want = smoke.bound(nb(t, s1, s2) + 2 * 8 * 1024 * 8,
                       {"fp32": 8 * 1024 * 320 * 9})[0]
    assert OPS["nearest_multi"].least(t, [s1, s2]) == \
        pytest.approx(want * 1e-3)
    nds, dirs = _gcn(1024, 1024, 10)[:2]
    a = [x.to(torch.bfloat16) for x in nds]
    d = [x.to(torch.bfloat16) for x in dirs]
    so = 7 * 128
    want = smoke.bound(nb(*a, *d) + 32 * 1024 * 3 * 128 * 4,
                       {"fp32": 32 * 1024 * 10 * 3 * so * 7
                        + 32 * 1024 * 3 * 128 * 6})[0]
    assert OPS["surface_multi"].least(a, d, 7) == pytest.approx(want * 1e-3)


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("shape, side", (((256, 128, 64, 64), 128),
                                         ((256, 96, 16, 16), 32)))
def test_resize_bound_is_chip_smokes(smoke, shape, side, dtype):
    """check_resize's bound(nbytes(x, got), {}) at the heads' and the
    fuse's shapes (meta tensors: only their sizes are read)."""
    x = torch.empty(shape, dtype=dtype, device="meta")
    got = torch.empty(shape[:2] + (side, side), dtype=dtype, device="meta")
    want = smoke.bound(smoke.nbytes(x, got), {})[0] * 1e-3
    assert OPS["resize_bilinear"].least(x, side, side) == \
        pytest.approx(want, rel=1e-12)


def test_flops_of_a_conv_and_a_matmul():
    conv = Conv(16, 32, 3, stride=2, bias=True, q=Precision("fp32"))
    dense = Dense(64, 48, q=Precision("fp32"))
    for p in list(conv.parameters()) + list(dense.parameters()):
        torch.nn.init.normal_(p)
    with FlopCounterMode(display=False) as c:
        conv(torch.randn(2, 16, 20, 20))
    assert c.get_total_flops() == 2 * 2 * 32 * 10 * 10 * 16 * 3 * 3
    with FlopCounterMode(display=False) as c:
        dense(torch.randn(5, 7, 64))
    assert c.get_total_flops() == 2 * 5 * 7 * 64 * 48


def test_step_flops_counts_forward_and_backward():
    from portbench.flops import step_flops
    from portbench.gen.pool import make_pool
    from portbench.tests.tiny import tiny_cell
    _, _, cfg_file, mix = tiny_cell("trpesnet.train_bs8")
    batch = make_pool(cfg_file, dict(mix, pool_batches=1), 3)[0]
    fwd = step_flops(cfg_file, batch, train=False)
    both = step_flops(cfg_file, batch, train=True)
    assert fwd > 0 and 2.5 * fwd < both < 3.5 * fwd


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_trace_reduction():
    ev = [_ev(WINDOW, "user_annotation", 0, 100),
          _ev(STAGE_PREFIX + "forward", "user_annotation", 0, 60),
          _ev("aten::conv2d", "cpu_op", 5, 20),
          _ev("aten::cudnn_convolution", "cpu_op", 6, 10),
          _ev(OP_PREFIX + "knn", "user_annotation", 30, 10),
          _ev("cudaLaunchKernel", "cuda_runtime", 32, 1, correlation=7),
          _ev("cudaLaunchKernel", "cuda_runtime", 50, 1, correlation=8),
          _ev("knn_kernel", "kernel", 40, 10, tid=9, correlation=7),
          _ev("gemm", "kernel", 45, 15, tid=9, correlation=8),
          _ev("gemm", "kernel", 80, 30, tid=9, correlation=9)]
    r = trace.reduce({"traceEvents": ev})
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(40e-6)          # 40-60, 80-100
    assert r["op_device_s"] == {"knn": pytest.approx(10e-6)}
    assert r["unattributed"] == 1
    assert dict(r["device_ops"])["gemm"] == pytest.approx(35e-6)
    gaps = dict(r["idle_gaps"])
    assert gaps["no_stage___no_aten_op"] == pytest.approx(20e-6)
    assert gaps["forward___no_aten_op"] == pytest.approx(40e-6)


def test_trace_splits_device_time_by_op():
    """Two ops, one nested in another op's range: the ops' device times
    add up to the device time of the work launched inside any op range
    (the single sum the reduction kept before it split by op: 40 us)."""
    ev = [_ev(WINDOW, "user_annotation", 0, 200),
          _ev(OP_PREFIX + "knn", "user_annotation", 10, 20),
          _ev(OP_PREFIX + "aggregate", "user_annotation", 50, 40),
          _ev(OP_PREFIX + "surface_multi", "user_annotation", 60, 10),
          _ev(OP_PREFIX + "resize_bilinear", "user_annotation", 100, 10),
          _ev("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=1),
          _ev("cudaLaunchKernel", "cuda_runtime", 30, 1, correlation=2),
          _ev("cudaLaunchKernel", "cuda_runtime", 62, 1, correlation=3),
          _ev("cudaLaunchKernel", "cuda_runtime", 80, 1, correlation=4),
          _ev("cudaLaunchKernel", "cuda_runtime", 95, 1, correlation=5),
          _ev("cudaLaunchKernel", "cuda_runtime", 105, 1, correlation=6),
          _ev("k1", "kernel", 20, 5, tid=9, correlation=1),
          _ev("k2", "kernel", 40, 7, tid=9, correlation=2),
          _ev("k3", "kernel", 70, 11, tid=9, correlation=3),
          _ev("k4", "kernel", 90, 13, tid=9, correlation=4),
          _ev("k5", "kernel", 120, 17, tid=9, correlation=5),
          _ev("k6", "kernel", 140, 4, tid=9, correlation=6)]
    r = trace.reduce({"traceEvents": ev})
    us = pytest.approx
    assert r["op_device_s"] == {"knn": us(12e-6), "aggregate": us(24e-6),
                                "resize_bilinear": us(4e-6)}
    assert sum(r["op_device_s"].values()) == us(40e-6)
    assert r["unattributed"] == 0


def test_trace_of_a_cpu_profile():
    """A real profiler trace (CPU only here) reduces, with no device
    time."""
    import json
    import tempfile
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW):
            torch.randn(64, 64) @ torch.randn(64, 64)
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        r = trace.reduce(json.load(open(f.name)))
    assert r["busy_s"] == 0 and r["window_s"] > 0

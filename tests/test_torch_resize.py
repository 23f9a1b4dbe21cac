"""The bilinear resize op (ops/resize.py) on the CPU: the plain path, the
launch grid the wrapper hands the kernel, its entry's signature, and the
number of resizes a KRRN forward makes. The kernel itself runs only on a
card (tests/test_torch_gpu.py)."""

import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.models import layers
from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.ops import _build, resize

torch.set_num_threads(1)

# (planes, (h, w) out) of the main paths at 256 frames (the shipped HRNet's
# fuse layers and concat, the heads), the UNet's and PSPNet's at 8, and
# ragged widths
OUTPUTS = [(256 * 96, (32, 32)), (256 * 96, (16, 16)), (256 * 128, (8, 8)),
           (256 * 256, (32, 32)), (256 * 128, (128, 128)),
           (8 * 64, (256, 256)), (8 * 512, (32, 32)), (6, (13, 21)),
           (3, (9, 37)), (3, (3, 11)), (5, (7, 30)), (1, (1, 3)),
           (7, (1, 1))]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,hw", [((2, 3, 4, 4), (8, 8)),
                                      ((1, 5, 3, 3), (32, 32)),
                                      ((2, 2, 5, 7), (13, 21)),
                                      ((1, 4, 6, 6), (32, 32))])
def test_cpu_takes_the_plain_path(dt, shape, hw):
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape)
                         .astype(np.float32)).to(dt)
    resize.resize_bilinear.launches = 0
    got = resize.resize_bilinear(x, *hw)
    ref = F.interpolate(x, size=hw, mode="bilinear", align_corners=False)
    assert torch.equal(got, ref)
    assert torch.equal(layers.resize_bilinear(x, *hw), ref)
    assert resize.resize_bilinear.launches == 0


def test_cpu_gradient_is_interpolate_s():
    x = torch.randn(2, 3, 4, 5, dtype=torch.float64)
    w = torch.randn(2, 3, 8, 10, dtype=torch.float64)
    grads = []
    for fn in (resize.resize_bilinear, resize.resize_bilinear_plain):
        xg = x.clone().requires_grad_(True)
        (fn(xg, 8, 10) * w).sum().backward()
        grads.append(xg.grad)
    assert torch.equal(*grads)


@pytest.mark.parametrize("element_size", [4, 2])
@pytest.mark.parametrize("planes,hw", OUTPUTS)
def test_launch_plan_covers_every_output_once(planes, hw, element_size):
    """Thread t of the grid writes outputs [t * vec, t * vec + vec) below
    the total, one 16-byte store where the chunk is whole: every output
    exactly once, no block past the last chunk, and a short chunk only at
    the end (the scalar tail)."""
    total = planes * hw[0] * hw[1]
    p = resize.launch_plan(total, element_size)
    assert p.total == total and p.vec * element_size == 16
    assert p.threads % 32 == 0 and p.threads <= 1024
    threads = p.blocks * p.threads
    assert threads * p.vec >= total > (threads - p.threads) * p.vec
    assert p.tail == total % p.vec
    if total > 1 << 16:     # the grid's arithmetic above is the whole story
        return
    starts = np.arange(threads, dtype=np.int64) * p.vec
    starts = starts[starts < total]
    hits = np.zeros(total, np.int64)
    for j in range(p.vec):
        np.add.at(hits, starts[starts + j < total] + j, 1)
    assert (hits == 1).all()
    short = [s for s in starts if s + p.vec > total]
    assert len(short) == (p.tail > 0) and (not short or
                                           total - short[0] == p.tail)


@pytest.mark.parametrize("layout,images,lanes", [
    (torch.contiguous_format, 15, 1), (torch.channels_last, 3, 5)])
def test_entry_signature_matches_the_wrapper_s_arguments(monkeypatch, layout,
                                                         images, lanes):
    """pose_resize_bilinear's ctypes types against what _launch passes: a
    pointer for each tensor and the stream, a 64-bit count of images, and
    32-bit ints for the lanes, the sizes, the dtype code and the grid; a
    contiguous map is N * C images of one lane, a channels-last one N
    images of C lanes, and the output keeps the layout."""
    seen = []

    class Lib:
        pose_resize_bilinear = "entry"

    def launch(fn, dev, *args):
        seen.append((fn, args))
        return 0

    monkeypatch.setattr(_build, "library", lambda: Lib)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(resize.resize_bilinear, "launches", 0)
    x = torch.zeros((3, 5, 4, 6), dtype=torch.bfloat16).to(
        memory_format=layout)
    out = resize._launch(x, 9, 13)
    assert out.shape == (3, 5, 9, 13) and resize.resize_bilinear.launches == 1
    assert out.is_contiguous(memory_format=layout)
    (fn, args), = seen
    sig = _build._SIGNATURES["pose_resize_bilinear"]
    assert fn == "entry" and len(sig) == len(args) + 1     # + the stream
    assert sig[-1] is ctypes.c_void_p
    assert args[2:8] == (images, lanes, 4, 6, 9, 13)
    plan = resize.launch_plan(15 * 9 * 13, 2)
    assert args[8:] == (1, plan.vec, plan.blocks, plan.threads)
    limits = {ctypes.c_void_p: (0, 2 ** 64 - 1),
              ctypes.c_longlong: (-2 ** 63, 2 ** 63 - 1),
              ctypes.c_int: (-2 ** 31, 2 ** 31 - 1)}
    for t, a in zip(sig, args):
        lo, hi = limits[t]
        assert isinstance(a, int) and lo <= a <= hi, (t, a)
    assert sig[:3] == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]


def test_shipped_krrn_forward_makes_36_resizes(monkeypatch):
    """The shipped HRNet's 1 + 12 + 18 fuse resizes, 3 for its concat and
    the heads' 2, each one call of the op (on the meta device: shapes
    only)."""
    calls = []

    def counted(x, h, w):
        calls.append((tuple(x.shape), h, w))
        return resize.resize_bilinear_plain(x, h, w)

    monkeypatch.setattr(resize, "resize_bilinear", counted)
    with torch.device("meta"):
        model = KRRN(schema.Config(), dtype=torch.bfloat16)
        x = torch.empty((2, 3, 128, 128), dtype=torch.bfloat16)
        quarter, half = model.HRNet_0(x)
        model.XYZHead_0(quarter)
        model.NMLHead_0(half)
    assert len(calls) == 36
    assert calls.count(((2, 96, 16, 16), 32, 32)) == 9
    assert calls.count(((2, 128, 64, 64), 128, 128)) == 2


def test_layers_keeps_its_refusal_and_identity():
    x = torch.randn(1, 2, 8, 8)
    assert layers.resize_bilinear(x, 8, 8) is x
    with pytest.raises(ValueError):
        layers.resize_bilinear(x, 4, 16)

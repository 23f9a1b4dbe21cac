"""What the metric readers share. A reader takes the run's record and
returns a number, or None where the run holds nothing to read."""

from __future__ import annotations

import numpy as np

from portbench.roofline import BF16_DENSE_FLOP_S


def rate(run: dict, kind: str):
    """Units (frames or samples) completed in the window over its
    seconds, for a run of `kind`."""
    if run["kind"] != kind or not run["window_s"] > 0:
        return None
    return run["units"] / run["window_s"]


def span_ms(run: dict, stage: str):
    """The stage's CUDA-event span over the window, per call."""
    total, calls = (run.get("spans") or {}).get(stage, (0.0, 0))
    return total / calls if calls else None


# Kernels 1-5, the ops that `kernel_roofline.serve_fps` and
# `kernel_roofline.train` sum over. An op file added later (kernel 6,
# ops/resize_bilinear.py, on) gets a reading of its own and never enters
# this sum, so these two metrics read what they read before it.
KERNELS_1_5 = ("linear_multi", "surface_multi", "aggregate", "knn",
               "nearest_multi")


def op_roofline(run: dict, ops):
    """The least time that the calls of `ops` allow, from their shapes,
    over the device time of the work launched inside their spans, in %
    (None where the trace holds no device time of them)."""
    tr = run.get("trace")
    if not tr:
        return None
    got = [tr["ops"][op] for op in ops if op in tr["ops"]]
    device_s = sum(g[1] for g in got)
    if not device_s > 0:
        return None
    return 100.0 * sum(g[0] for g in got) / device_s


def mfu(run: dict):
    """The reference's FLOPs of a step times the traced steps, over the
    traced window and the bf16 dense peak, in %."""
    tr = run.get("trace")
    if not tr or not tr.get("flops_per_step") or not tr["steps"]:
        return None
    return (100.0 * tr["flops_per_step"] * tr["steps"]
            / tr["window_s"] / BF16_DENSE_FLOP_S)


def device_idle(run: dict):
    tr = run.get("trace")
    if not tr or not tr["window_s"] > 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

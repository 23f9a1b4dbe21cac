"""Reduction of a profiler trace (the Chrome trace JSON that
torch.profiler exports) to what the per-layer metrics read: the device's
busy time as the union of its operations' intervals within the traced
window, the operations that took most time, the longest idle gaps by what
the host was doing, and, op by op, the device time of the work launched
inside the op's spans."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

from portbench.spans import OP_PREFIX, STAGE_PREFIX, WINDOW

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def _clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.\-]", "_", name)[:64]


def union(intervals):
    """Merged, sorted [(start, end)] of `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _outermost(events):
    """(start, end, name) of the events no other contains, sorted."""
    out = []
    for s, e, name in sorted(events):
        if out and s < out[-1][1]:
            continue
        out.append((s, e, name))
    return out


def _op_ranges(ranges):
    """union() of (start, end, op) ranges, each merged interval named by
    the op of its outermost range (the first to start, the longest of
    those); ranges that only touch stay apart."""
    out = []
    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        if out and s < out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e, name])
    return [tuple(r) for r in out]


def _op_at(ranges, t):
    """The op of the merged op range holding t (ends included), or
    None."""
    i = bisect.bisect_right(ranges, (t, float("inf"), "")) - 1
    if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
        return ranges[i][2]
    return None


def _label_at(tops, t, default):
    i = bisect.bisect_right(tops, (t, float("inf"), "")) - 1
    if i >= 0 and tops[i][0] <= t < tops[i][1]:
        return tops[i][2]
    return default


def reduce(trace: dict) -> dict:
    """busy_s, window_s, device_ops, idle_gaps, op_device_s ({op: device
    seconds of the work launched inside its ranges}) and unattributed
    (device operations without a launch event) of a trace whose window is
    the profiler range named spans.WINDOW. An op range inside another (an
    op that calls another through its module) counts for the outer op, so
    the ops' device times add up to that of the work launched inside any
    op range."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("name") == WINDOW]
    if not win:
        raise ValueError("the trace holds no window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main_tid = win[0].get("tid")

    dev = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            s, d = float(e["ts"]), float(e["dur"])
            s0, s1 = max(s, w0), min(s + d, w1)
            if s1 > s0:
                dev.append((s0, s1, e["name"],
                            e.get("args", {}).get("correlation")))
    busy = union([(s, e) for s, e, _, _ in dev])
    busy_us = sum(e - s for s, e in busy)

    per_name = defaultdict(float)
    for s, e, name, _ in dev:
        per_name[_clean(name)] += (e - s) * 1e-6
    device_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]

    host = [e for e in events if e.get("tid") == main_tid
            and e.get("cat") in ("cpu_op", "user_annotation")]
    stages = _outermost([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          e["name"][len(STAGE_PREFIX):]) for e in host
                         if e["name"].startswith(STAGE_PREFIX)])
    ops = _outermost([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in host if e.get("cat") == "cpu_op"])
    gaps = defaultdict(float)
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            label = (f"{_label_at(stages, prev, 'no stage')} / "
                     f"{_label_at(ops, prev, 'no aten op')}")
            gaps[_clean(label)] += (s - prev) * 1e-6
        prev = max(prev, e)
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]

    op_ranges = _op_ranges([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                             e["name"][len(OP_PREFIX):]) for e in host
                            if e["name"].startswith(OP_PREFIX)])
    launched = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launched[c] = _op_at(op_ranges, float(e["ts"]))
    op_us, unattributed = defaultdict(float), 0
    for s, e, _, corr in dev:
        if corr not in launched:
            unattributed += 1
        elif launched[corr] is not None:
            op_us[launched[corr]] += e - s
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "device_ops": device_ops, "idle_gaps": idle_gaps,
            "op_device_s": {k: v * 1e-6 for k, v in op_us.items()},
            "unattributed": unattributed,
            "device_events": len(dev)}

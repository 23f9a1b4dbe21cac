"""Reduction of a profiler trace (the Chrome trace JSON that
torch.profiler exports) to what the per-layer metrics read: the device's
busy time as the union of its operations' intervals within the traced
window, the operations that took most time, the longest idle gaps by what
the host was doing, and the device time of the work launched inside the
op spans."""

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


def _inside(merged, t):
    """Index of the merged interval holding t, or -1."""
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i if i >= 0 and merged[i][0] <= t <= merged[i][1] else -1


def _outermost(events):
    """(start, end, name) of the events no other contains, sorted."""
    out = []
    for s, e, name in sorted(events):
        if out and s < out[-1][1]:
            continue
        out.append((s, e, name))
    return out


def _label_at(tops, t, default):
    i = bisect.bisect_right(tops, (t, float("inf"), "")) - 1
    if i >= 0 and tops[i][0] <= t < tops[i][1]:
        return tops[i][2]
    return default


def reduce(trace: dict) -> dict:
    """busy_s, window_s, device_ops, idle_gaps, op_device_s and
    unattributed (device operations without a launch event) of a trace
    whose window is the profiler range named spans.WINDOW."""
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

    op_spans = union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in host if e["name"].startswith(OP_PREFIX)])
    launched = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launched[c] = _inside(op_spans, float(e["ts"])) >= 0
    op_us, unattributed = 0.0, 0
    for s, e, _, corr in dev:
        if corr not in launched:
            unattributed += 1
        elif launched[corr]:
            op_us += e - s
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "device_ops": device_ops, "idle_gaps": idle_gaps,
            "op_device_s": op_us * 1e-6, "unattributed": unattributed,
            "device_events": len(dev)}

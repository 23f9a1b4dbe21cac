"""Reduction of a profiler trace (the Chrome trace JSON that
torch.profiler exports) to the program's own spans: the ranges that
pose_estimation_tpu_torch/utils/profiling.py opens on the main thread,
named with its prefix `pose/`, within the benchmark's window range.

For each span name: its ranges (cut to the window), their host time, the
device-idle time inside them (the window less the union of the device's
operations, trace.union), that idle time less the part their child
ranges hold (self), and the kernel launches the main thread makes inside
them. The idle time inside no range is `outside_idle_s`; the self idle
times and it add up to the window's idle time, which trace.reduce gives
as window_s - busy_s.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from portbench.spans import WINDOW
from portbench.trace import DEVICE_CATS, LAUNCH_CATS, union

PREFIX = "pose/"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")


class _Busy:
    """Busy time of merged intervals within any [a, b]."""

    def __init__(self, merged):
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.cum = [0.0]
        for s, e in merged:
            self.cum.append(self.cum[-1] + e - s)

    def within(self, a, b):
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0.0
        return (self.cum[j] - self.cum[i] - max(0.0, a - self.starts[i])
                - max(0.0, self.ends[j - 1] - b))


def reduce(trace: dict) -> dict:
    """{window_s, busy_s, idle_s, outside_idle_s, spans: {name: {calls,
    host_s, idle_s, self_idle_s, launches, self_launches}}} of a trace
    whose window is the profiler range named spans.WINDOW; times in
    seconds, launches counted on the main thread."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("name") == WINDOW]
    if not win:
        raise ValueError("the trace holds no window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main_tid = win[0].get("tid")

    def cut(e):
        s = float(e["ts"])
        return max(s, w0), min(s + float(e["dur"]), w1)

    busy = _Busy(union([c for c in (cut(e) for e in events
                                    if e.get("cat") in DEVICE_CATS)
                        if c[1] > c[0]]))
    launches = sorted(float(e["ts"]) for e in events
                      if e.get("tid") == main_tid
                      and e.get("cat") in LAUNCH_CATS
                      and e.get("name") in LAUNCHES
                      and w0 <= float(e["ts"]) < w1)
    ranges = []                    # (start, end, name), parents first
    for ev in events:
        if (ev.get("tid") == main_tid and ev.get("cat") == "user_annotation"
                and ev["name"].startswith(PREFIX)):
            s, e = cut(ev)
            if e > s:
                ranges.append((s, e, ev["name"][len(PREFIX):]))
    ranges.sort(key=lambda r: (r[0], -r[1]))

    out = defaultdict(lambda: {"calls": 0, "host_s": 0.0, "idle_s": 0.0,
                               "self_idle_s": 0.0, "launches": 0,
                               "self_launches": 0})
    stack = []        # [end, name, idle, launches] of the open ranges
    top_idle = 0.0

    def close(frame):
        end, name, idle, n = frame
        out[name]["self_idle_s"] += idle
        out[name]["self_launches"] += n

    for s, e, name in ranges:
        while stack and stack[-1][0] <= s:
            close(stack.pop())
        idle = (e - s) - busy.within(s, e)
        n = bisect.bisect_left(launches, e) - bisect.bisect_left(launches, s)
        r = out[name]
        r["calls"] += 1
        r["host_s"] += (e - s) * 1e-6
        r["idle_s"] += idle * 1e-6
        r["launches"] += n
        if stack:
            stack[-1][2] -= idle * 1e-6
            stack[-1][3] -= n
        else:
            top_idle += idle
        stack.append([e, name, idle * 1e-6, n])
    while stack:
        close(stack.pop())

    window = w1 - w0
    idle = window - busy.within(w0, w1)
    return {"window_s": window * 1e-6, "busy_s": (window - idle) * 1e-6,
            "idle_s": idle * 1e-6, "outside_idle_s": (idle - top_idle) * 1e-6,
            "spans": dict(out)}

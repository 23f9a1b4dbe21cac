"""Spans from the benchmark's own files, for the traced run.

Stage spans wrap an entry object's stage methods (InferStep.forward and
.solve; TrainStep.losses, .gradients and .apply) as instance attributes:
CUDA events before and after each call give its time on the device's
stream, and a profiler range names the stage in the trace. Kernel spans
wrap the entry points of the ops that the cell's metrics name
(run.traced_ops) in their modules (program.wrap_ops) in a profiler range
each, and add up, op by op, the calls and the least time each call's
shapes allow (the op file's `least`) while the profiler runs.
"""

from __future__ import annotations

import functools

import torch

STAGE_PREFIX = "portbench.stage."
OP_PREFIX = "portbench.op."
WINDOW = "portbench.window"


class StageSpans:
    """CUDA-event spans around `obj`'s methods `names`."""

    def __init__(self, obj, names):
        self.events = {n: [] for n in names}
        for name in names:
            setattr(obj, name, self._wrap(name, getattr(obj, name)))

    def _wrap(self, name, fn):
        events = self.events[name]
        label = STAGE_PREFIX + name

        @functools.wraps(fn)
        def span(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(label):
                start.record()
                out = fn(*args, **kw)
                end.record()
            events.append((start, end))
            return out
        return span

    def reset(self):
        for v in self.events.values():
            v.clear()

    def totals_ms(self) -> dict:
        """{stage: (total ms, calls)}; synchronises."""
        torch.cuda.synchronize()
        return {n: (sum(s.elapsed_time(e) for s, e in ev), len(ev))
                for n, ev in self.events.items()}


class OpSpans:
    """A profiler range around every op call, and each op's least seconds
    and calls over the calls made while `counting` is set."""

    def __init__(self):
        self.counting = False
        self.ops = {}           # op -> [least seconds, calls]

    def hook(self, name, fn, least):
        label = OP_PREFIX + name
        acc = self.ops.setdefault(name, [0.0, 0])

        @functools.wraps(fn)
        def op(*args, **kw):
            if self.counting:
                acc[0] += least(*args, **kw)
                acc[1] += 1
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return op

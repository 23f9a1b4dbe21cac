"""Spans and counters inside the port (the counterpart of the JAX
package's utils/profiling.py).

    with profiling.span("krrn.backbone"):
        ...

    @profiling.spanned("serve.solve")      # each call a span
    def solve(...): ...

    profiling.count("host_syncs")

Off, the default, span() returns one shared null context and count()
returns at once: a module-level flag test is all either costs. On
(enable(True)), each span records its name, its id, its parent's id,
the id of its root (the outermost open span: the request or step it
belongs to), its host start and end (time.perf_counter_ns), a CUDA
event pair on the current stream when CUDA is available, and a
torch.profiler.record_function range named PREFIX + name, so that under
a profiler every span lies on the device trace's clock. A counter adds
to the innermost open span. While tracing is on and CUDA is available,
the CUDA sync debug mode is "warn" and every synchronizing CUDA
operation the tracing thread makes counts once as `host_syncs` instead
of being printed (the mode is a prototype of PyTorch's and does not see
every sync: torch.distributed's, for one); enable(False) restores the
mode, the warning filters and the warning display. Spans and counters
belong to the thread that enabled tracing, and stay in memory until
reset().
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
import warnings

import torch

PREFIX = "pose/"
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_NULL = contextlib.nullcontext()
_on = False
_cuda = False
_thread = None
_saved = None        # (sync debug mode, warning filters) while on
_shown = None        # warnings.showwarning as tracing found it
_stack = []          # the open spans, outermost first
_done = []           # the closed spans, in the order they closed
_counts = {}         # counter -> total, in spans or not
_ids = itertools.count(1)


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "child_ns", "counts", "events", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        parent = _stack[-1] if _stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent else None
        self.root = parent.root if parent else self.id
        self.child_ns, self.counts, self.events = 0, {}, None
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        if _cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        _stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        _stack.pop()
        if _stack:
            _stack[-1].child_ns += self.end_ns - self.start_ns
        _done.append(self)
        return False


def span(name: str):
    """A context manager: the span `name` while tracing is on (in the
    tracing thread), else the shared null context."""
    if not _on or threading.get_ident() != _thread:
        return _NULL
    return _Span(name)


def spanned(name: str):
    """A decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`, in the innermost open span."""
    if not _on or threading.get_ident() != _thread:
        return
    _counts[name] = _counts.get(name, 0) + n
    if _stack:
        c = _stack[-1].counts
        c[name] = c.get(name, 0) + n


def _show(message, category, filename, lineno, file=None, line=None):
    """warnings.showwarning while tracing is on: a sync warning counts
    (and from another thread is dropped); any other goes on to the
    display that was in place."""
    if issubclass(category, UserWarning) and str(message).startswith(
            SYNC_MESSAGE):
        count("host_syncs")
        return
    _shown(message, category, filename, lineno, file, line)


def enable(on: bool = True) -> None:
    """Turn tracing on or off; see the module's docstring."""
    global _on, _cuda, _thread, _saved, _shown
    on = bool(on)
    if on == _on:
        return
    if on:
        _cuda = torch.cuda.is_available()
        _thread = threading.get_ident()
        if _cuda:
            _saved = (torch.cuda.get_sync_debug_mode(), warnings.filters[:])
            _shown = warnings.showwarning
            warnings.filterwarnings("always", message=SYNC_MESSAGE,
                                    category=UserWarning)
            warnings.showwarning = _show
            torch.cuda.set_sync_debug_mode("warn")
    elif _saved is not None:
        mode, filters = _saved
        torch.cuda.set_sync_debug_mode(mode)
        warnings.filters[:] = filters
        warnings.showwarning = _shown
        _saved = None
    _on = on


def reset() -> None:
    """Drop the closed spans and the counters (the open spans stay)."""
    _done.clear()
    _counts.clear()


def records() -> list:
    """The closed spans, in the order they closed: dicts of name, id,
    parent, root (ids), start_ns, end_ns (host), child_ns (the host time
    its child spans cover) and counts (its own counters)."""
    return [{"name": s.name, "id": s.id, "parent": s.parent,
             "root": s.root, "start_ns": s.start_ns, "end_ns": s.end_ns,
             "child_ns": s.child_ns, "counts": dict(s.counts)}
            for s in _done]


def _synchronize() -> None:
    """torch.cuda.synchronize(), not counted as a host sync."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def report() -> dict:
    """{"spans": {name: {calls, host_ms, stream_ms, self_host_ms,
    counters, counters_inclusive}}, "counters": {name: total}} of the
    closed spans. host_ms is the spans' host time, self_host_ms that
    time less what their child spans cover, stream_ms the time between
    their CUDA events on the stream (None without CUDA); counters are
    the spans' own, counters_inclusive theirs and their descendants'.
    Synchronises the card."""
    if any(s.events is not None for s in _done):
        _synchronize()
    spans, below = {}, {}
    for s in _done:                       # children close before parents
        r = spans.setdefault(s.name, {
            "calls": 0, "host_ms": 0.0,
            "stream_ms": None if s.events is None else 0.0,
            "self_host_ms": 0.0, "counters": {}, "counters_inclusive": {}})
        ns = s.end_ns - s.start_ns
        r["calls"] += 1
        r["host_ms"] += ns * 1e-6
        r["self_host_ms"] += (ns - s.child_ns) * 1e-6
        if s.events is not None:
            r["stream_ms"] += s.events[0].elapsed_time(s.events[1])
        incl = below.pop(s.id, {})
        for k, v in s.counts.items():
            r["counters"][k] = r["counters"].get(k, 0) + v
            incl[k] = incl.get(k, 0) + v
        for k, v in incl.items():
            r["counters_inclusive"][k] = r["counters_inclusive"].get(k, 0) + v
        if s.parent is not None:
            up = below.setdefault(s.parent, {})
            for k, v in incl.items():
                up[k] = up.get(k, 0) + v
    return {"spans": spans, "counters": dict(_counts)}

"""The reduction of a trace to the program's spans (program_trace.reduce)
on a hand-built trace, and the readings of portbench.program_run."""

from __future__ import annotations

import pytest

from portbench import program_trace, trace
from portbench.program_run import readings
from portbench.spans import WINDOW


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": {}}


def _range(name, ts, dur, tid=1):
    return _ev("pose/" + name, "user_annotation", ts, dur, tid)


def _trace():
    return {"traceEvents": [
        _ev(WINDOW, "user_annotation", 0, 100),
        _range("pre", -10, 15),                  # cut by the window: 0-5
        _range("a", 10, 50),
        _range("b", 20, 20),                     # in a
        _range("b", 42, 6),                      # in a, all idle
        _range("c", 70, 50),                     # cut: 70-100
        _range("z", 0, 100, tid=2),              # another thread
        _ev("kernel", "kernel", 0, 8, tid=9),    # busy 0-8
        _ev("kernel", "kernel", 30, 5, tid=9),   # 30-35 (in b)
        _ev("kernel", "kernel", 50, 30, tid=9),  # 50-80
        _ev("copy", "gpu_memcpy", 95, 35, tid=9),   # cut: 95-100
        _ev("cudaLaunchKernel", "cuda_runtime", 12, 1),      # a's own
        _ev("cudaLaunchKernel", "cuda_runtime", 25, 1),      # b
        _ev("cudaMemcpyAsync", "cuda_runtime", 26, 1),       # no launch
        _ev("cudaLaunchKernel", "cuda_runtime", 26, 1, tid=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 65, 1),      # outside
        _ev("cuLaunchKernel", "cuda_driver", 75, 1),         # c
        _ev("cudaLaunchKernel", "cuda_runtime", 105, 1),     # after
    ]}


def test_reduce_nested_ranges_gaps_and_launches():
    r = program_trace.reduce(_trace())
    us = pytest.approx
    assert r["window_s"] == us(100e-6) and r["busy_s"] == us(48e-6)
    assert r["idle_s"] == us(52e-6)
    s = r["spans"]
    assert set(s) == {"pre", "a", "b", "c"}
    assert s["pre"] == {"calls": 1, "host_s": us(5e-6), "idle_s": us(0.0),
                        "self_idle_s": us(0.0), "launches": 0,
                        "self_launches": 0}
    # a: 10-60, busy 30-35 and 50-60; b: 20-40 (busy 5) and 42-48
    assert s["a"]["idle_s"] == us(35e-6) and s["a"]["host_s"] == us(50e-6)
    assert s["b"]["calls"] == 2 and s["b"]["idle_s"] == us(21e-6)
    assert s["a"]["self_idle_s"] == us(14e-6)
    assert s["b"]["self_idle_s"] == us(21e-6)
    assert s["c"]["idle_s"] == us(15e-6) and s["c"]["host_s"] == us(30e-6)
    assert (s["a"]["launches"], s["a"]["self_launches"]) == (2, 1)
    assert (s["b"]["launches"], s["c"]["launches"]) == (1, 1)
    assert r["outside_idle_s"] == us(2e-6)          # 5-8 is busy, 8-10 not


def test_idle_by_innermost_span_adds_up_to_the_windows():
    tr = _trace()
    r = program_trace.reduce(tr)
    whole = trace.reduce(tr)
    inner = sum(v["self_idle_s"] for v in r["spans"].values())
    assert inner + r["outside_idle_s"] == pytest.approx(
        whole["window_s"] - whole["busy_s"], abs=1e-12)


def test_reduce_needs_the_window():
    with pytest.raises(ValueError):
        program_trace.reduce({"traceEvents": [_range("a", 0, 1)]})


def _span(calls, stream_ms, syncs=None):
    return {"calls": calls, "stream_ms": stream_ms,
            "counters_inclusive": {} if syncs is None
            else {"host_syncs": syncs}}


def test_readings():
    report = {"spans": {"serve.request": _span(4, 40.0, 24),
                        "krrn.backbone": _span(4, 20.0),
                        "krrn.fusion": _span(4, 2.0)}}
    reduced = {"spans": {"serve.solve": {"idle_s": 1.0, "host_s": 4.0}}}
    assert readings("serve", report, reduced, 2) == {
        "backbone_ms": 5.0, "fusion_ms": 0.5, "host_syncs": 6.0,
        "solve_idle": 25.0}
    report = {"spans": {"train.step": _span(10, 900.0),
                        "optim.update": _span(10, 500.0)}}
    reduced = {"spans": {"train.apply": {"idle_s": 3.0, "host_s": 4.0,
                                         "launches": 7000}}}
    assert readings("train", report, reduced, 20) == {
        "optimizer_ms": 50.0, "apply_launches": 350.0, "apply_idle": 75.0,
        "host_syncs": 0.0}
    # a program without its spans (an older checkout) reads nothing
    assert set(readings("train", {"spans": {}}, {"spans": {}}, 20).values()
               ) == {None}

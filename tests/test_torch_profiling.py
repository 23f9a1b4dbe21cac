"""The port's spans and counters (utils/profiling.py) on the CPU, tiny
configs, one thread:
  off: span() is one shared null context that makes no profiler range
      and no CUDA event, and records nothing; the sync debug mode and
      the warning filters are not touched;
  on: the spans' parent and root ids, self time, counters in the
      innermost span and summed up the tree, the `pose/` ranges in a
      CPU profiler trace;
  InferStep, TrainStep and TransparentTrainStep (TRPESNet and the PSPNet
      generation, whose five pspnet.* spans lie in transparent.forward):
      the span names with their calls, and every output and the train
      state the same bits with tracing on and off;
  the host-sync counter with CUDA faked: each sync warning counts once
      and is not shown, enable(False) restores the mode, the filters and
      the display.
The two tests marked gpu count real syncs on a card (the PSPNet step's
spans none):

  python -m pytest --noconftest -p no:cacheprovider -m gpu \\
      tests/test_torch_profiling.py -q
"""

import copy
import json
import threading
import time
import warnings

import pytest
import torch

import torch_transparent_worker as W
from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.data.batching import make_batch
from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.ops import gcn, pointops
from pose_estimation_tpu_torch.serve import build_infer_step
from pose_estimation_tpu_torch.train.optim import make_optimizer
from pose_estimation_tpu_torch.train.state import TrainState
from pose_estimation_tpu_torch.train.train_step import build_train_step
from pose_estimation_tpu_torch.utils import profiling

torch.set_num_threads(1)

TINY = schema.override(schema.Config(), **{
    "module.num_cls": 2, "data.num_regions": 8, "data.num_points": 128,
    "data.input_size": 64, "module.backbone_outc": 16,
    "module.stem_width": 8,
    "module.hrnet_stages": ((1, 1, (8, 8)), (1, 1, (8, 8, 16)),
                            (1, 1, (8, 8, 16, 16))),
    "module.xyznet": schema.HeadConfig(hidden=16),
    "module.nmlnet": schema.HeadConfig(hidden=16),
    "module.gcn3d": schema.Gcn3dConfig(neighbor_num=4, support_num=2),
    "eval.num_pnp_points": 64, "eval.pnp_hypotheses": 8,
    "train.amp": False, "train.lr.warmup_iters": 0})

KRRN_SPANS = {"krrn.backbone": 1, "krrn.heads": 1, "krrn.fusion": 1,
              "krrn.pose": 1, "op.knn": 8, "op.linear_multi": 2,
              "op.surface_multi": 1}
APPLY_SPANS = {"train.apply": 1, "train.guard": 1, "optim.update": 1,
               "state.apply": 1}


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


@pytest.fixture(scope="module")
def krrn_batch():
    ds = SyntheticPoseDataset(num_objects=2, frames_per_object=1,
                              num_regions=8)
    return make_batch(ds, [0, 1], torch.Generator().manual_seed(0), 64, 128)


def _calls(report):
    return {k: v["calls"] for k, v in report["spans"].items()}


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def _assert_same(a, b, path="out"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def test_off_is_one_null_context_that_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("made while tracing is off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", refuse)
    filters, show = warnings.filters[:], warnings.showwarning
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b is profiling._NULL
    with a, b:
        profiling.count("host_syncs")

    @profiling.spanned("c")
    def f(x):
        return x + 1
    assert f(1) == 2
    assert profiling.records() == []
    assert profiling.report() == {"spans": {}, "counters": {}}
    assert warnings.filters == filters and warnings.showwarning is show


def test_spans_record_ids_self_time_and_counters():
    profiling.enable(True)
    profiling.count("x", 5)                      # outside every span
    with profiling.span("a"):
        profiling.count("x", 2)
        with profiling.span("b"):
            time.sleep(0.002)
        with profiling.span("c"):
            with profiling.span("d"):
                profiling.count("x")
                profiling.count("y")
            time.sleep(0.001)
    with profiling.span("a"):                    # a second root
        pass
    profiling.enable(False)
    with profiling.span("a"):                    # off again
        profiling.count("x")
    rec = _by_name(profiling.records())
    assert [r["name"] for r in profiling.records()] == ["b", "d", "c", "a",
                                                        "a"]
    a1, a2 = rec["a"]
    (b,), (c,), (d,) = rec["b"], rec["c"], rec["d"]
    assert a1["parent"] is None and a1["root"] == a1["id"]
    assert b["parent"] == c["parent"] == a1["id"] and d["parent"] == c["id"]
    assert {r["root"] for r in (b, c, d)} == {a1["id"]}
    assert a2["root"] == a2["id"] != a1["id"]
    dur = lambda r: r["end_ns"] - r["start_ns"]
    assert a1["child_ns"] == dur(b) + dur(c) and c["child_ns"] == dur(d)
    assert d["counts"] == {"x": 1, "y": 1} and a1["counts"] == {"x": 2}
    rep = profiling.report()
    assert _calls(rep) == {"a": 2, "b": 1, "c": 1, "d": 1}
    ra = rep["spans"]["a"]
    assert ra["host_ms"] == pytest.approx((dur(a1) + dur(a2)) * 1e-6)
    assert ra["self_host_ms"] == pytest.approx(
        ra["host_ms"] - (dur(b) + dur(c)) * 1e-6)
    assert rep["spans"]["b"]["host_ms"] >= 2.0
    assert ra["stream_ms"] is None              # no CUDA here
    assert ra["counters"] == {"x": 2}
    assert ra["counters_inclusive"] == {"x": 3, "y": 1}
    assert rep["spans"]["c"]["counters"] == {}
    assert rep["spans"]["c"]["counters_inclusive"] == {"x": 1, "y": 1}
    assert rep["counters"] == {"x": 8, "y": 1}
    profiling.reset()
    assert profiling.report() == {"spans": {}, "counters": {}}


def test_spans_are_the_tracing_threads():
    profiling.enable(True)
    seen = []

    def other():
        seen.append(profiling.span("t") is profiling._NULL)
        profiling.count("x")
    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive() and seen == [True]
    assert profiling.report() == {"spans": {}, "counters": {}}


def test_spanned_keeps_the_ops_launch_counters():
    for fn in (gcn.linear_multi, gcn.surface_multi, gcn.aggregate,
               pointops.knn, pointops.nearest_multi):
        assert isinstance(fn.launches, int) and fn.__wrapped__ is not fn


def test_spans_are_profiler_ranges(tmp_path):
    profiling.enable(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.randn(16, 16) @ torch.randn(16, 16)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = {e["name"]: e for e in events
              if e.get("name", "").startswith(profiling.PREFIX)}
    assert set(ranges) == {"pose/outer", "pose/inner"}
    o, i = ranges["pose/outer"], ranges["pose/inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


def test_infer_step_spans_and_bits(krrn_batch):
    torch.manual_seed(0)
    step = build_infer_step(KRRN(TINY).eval(), TINY)
    run = lambda: step(krrn_batch, generator=torch.Generator().manual_seed(1))
    off = run()
    profiling.enable(True)
    on = run()
    profiling.enable(False)
    _assert_same(off, on)
    rep = profiling.report()
    want = {"serve.request": 1, "serve.forward": 1, "serve.solve": 1,
            "pnp.hypotheses": 1, "pnp.score": 1, "pnp.refine": 1,
            "pnp.final": 1, **KRRN_SPANS}
    assert {k: _calls(rep)[k] for k in want} == want
    rec = _by_name(profiling.records())
    (request,) = rec["serve.request"]
    assert rec["serve.forward"][0]["parent"] == request["id"]
    assert rec["krrn.backbone"][0]["parent"] == rec["serve.forward"][0]["id"]
    assert rec["pnp.refine"][0]["parent"] == rec["serve.solve"][0]["id"]
    assert {r["root"] for r in profiling.records()} == {request["id"]}


def _snapshot(state, metrics):
    return {"metrics": metrics, "step": state.step,
            "params": {k: p.detach().clone()
                       for k, p in state.model.named_parameters()},
            "opt_state": state.opt_state,
            "generator": state.generator.get_state()}


def test_train_step_spans_and_bits(krrn_batch):
    torch.manual_seed(0)
    model = KRRN(TINY)
    tx = make_optimizer(TINY, total_steps=10)
    base = TrainState.create(model, tx, torch.Generator().manual_seed(2))
    step = build_train_step(model, tx, TINY)
    snaps = []
    for on in (False, True):
        state = copy.deepcopy(base)
        step.model = state.model
        profiling.enable(on)
        metrics = step(state, krrn_batch, opt_pose=True)
        profiling.enable(False)
        snaps.append(_snapshot(state, metrics))
    _assert_same(*snaps)
    want = {"train.step": 1, "train.losses": 1, "train.gradients": 1,
            **APPLY_SPANS, **KRRN_SPANS}
    assert {k: _calls(profiling.report())[k] for k in want} == want
    rec = _by_name(profiling.records())
    assert rec["optim.update"][0]["parent"] == rec["train.apply"][0]["id"]
    assert rec["krrn.fusion"][0]["parent"] == rec["train.losses"][0]["id"]


def test_transparent_train_step_spans_and_bits():
    batch = W.local_batch(W.tiny_batch())
    snaps = []
    for on in (False, True):
        state, step = W.port_setup(gen_seed=5)
        profiling.enable(on)
        metrics = step(state, batch)
        profiling.enable(False)
        snaps.append(_snapshot(state, metrics))
    _assert_same(*snaps)
    want = {"train.step": 1, "train.losses": 1, "transparent.forward": 1,
            "transparent.loss": 1, "op.nearest_multi": 1,
            "op.resize_bilinear": 10,   # the UNet's ten up blocks
            "train.gradients": 1, **APPLY_SPANS}
    assert _calls(profiling.report()) == want
    rec = _by_name(profiling.records())
    assert (rec["transparent.loss"][0]["parent"]
            == rec["train.losses"][0]["id"])


PSPNET_SPANS = ("pspnet.backbone", "pspnet.psp", "pspnet.decoder",
                "pspnet.geometry", "pspnet.points")


def test_pspnet_train_step_spans_and_bits():
    """The PSPNet generation's step: the five pspnet.* spans once each,
    children of transparent.forward, without host syncs; off, none is
    recorded and every output and the state are the same bits."""
    batch = W.local_batch(W.posenet_batch())
    snaps = []
    for on in (False, True):
        state, step = W.posenet_setup(gen_seed=5)
        profiling.enable(on)
        metrics = step(state, batch)
        profiling.enable(False)
        snaps.append(_snapshot(state, metrics))
        if not on:
            assert profiling.records() == []
    _assert_same(*snaps)
    want = {"train.step": 1, "train.losses": 1, "transparent.forward": 1,
            "transparent.loss": 1, "op.nearest_multi": 1,
            # the pyramid's 3 (its 6 x 6 prior is the map's own size) and
            # the decoder's 9
            "op.resize_bilinear": 12,
            "train.gradients": 1, **APPLY_SPANS,
            **{name: 1 for name in PSPNET_SPANS}}
    report = profiling.report()
    assert _calls(report) == want
    rec = _by_name(profiling.records())
    forward = rec["transparent.forward"][0]
    for name in PSPNET_SPANS:
        assert rec[name][0]["parent"] == forward["id"], name
        assert report["spans"][name]["counters_inclusive"].get(
            "host_syncs", 0) == 0, name
    order = sorted(PSPNET_SPANS, key=lambda n: rec[n][0]["start_ns"])
    assert order == list(PSPNET_SPANS)


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA reported available, the sync debug mode a plain value, no
    events: what enable() and the spans touch of CUDA."""
    mode = {"now": 0, "set": []}

    def set_mode(m):
        mode["set"].append(m)
        mode["now"] = {"default": 0, "warn": 1, "error": 2}.get(m, m)

    class Event:
        def __init__(self, **kw):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 0.5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    return mode


def _sync_warning():
    warnings.warn(profiling.SYNC_MESSAGE + " (Triggered internally at x)",
                  UserWarning)


def test_host_syncs_count_every_sync_and_restore(fake_cuda):
    with profiling.span("off"):                # off: nothing touched
        pass
    assert fake_cuda["set"] == []
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        filters, show = warnings.filters[:], warnings.showwarning
        profiling.enable(True)
        assert fake_cuda["now"] == 1
        with profiling.span("step"):
            with profiling.span("solve"):
                for _ in range(3):                 # one line, three syncs
                    _sync_warning()
            _sync_warning()
            warnings.warn("another warning", UserWarning)
            th = threading.Thread(target=_sync_warning)
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
        _sync_warning()
        rep = profiling.report()
        assert fake_cuda["now"] == 1               # report's sync: back
        profiling.enable(False)
        assert [str(w.message) for w in shown] == ["another warning"]
        assert warnings.filters == filters
        assert warnings.showwarning is show
    assert fake_cuda["now"] == 0 and fake_cuda["set"][0] == "warn"
    assert rep["spans"]["solve"]["counters"] == {"host_syncs": 3}
    assert rep["spans"]["step"]["counters"] == {"host_syncs": 1}
    assert rep["spans"]["step"]["counters_inclusive"] == {"host_syncs": 4}
    assert rep["spans"]["step"]["stream_ms"] == 0.5
    assert rep["counters"] == {"host_syncs": 5}


@pytest.mark.gpu
def test_host_syncs_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = torch.cuda.get_sync_debug_mode()
    x = torch.ones(1024, device="cuda")
    profiling.enable(True)
    with profiling.span("request"):
        y = x * 2
        with profiling.span("sync"):
            for _ in range(3):
                y.sum().item()
    profiling.enable(False)
    rep = profiling.report()
    assert torch.cuda.get_sync_debug_mode() == before
    assert rep["spans"]["sync"]["counters"] == {"host_syncs": 3}
    assert rep["spans"]["request"]["counters_inclusive"] == {"host_syncs": 3}
    assert rep["spans"]["request"]["stream_ms"] >= 0.0


@pytest.mark.gpu
def test_pspnet_spans_sync_free_on_a_card():
    """The tiny PSPNet train step on a card: its five spans count no host
    sync (the dropouts' keep_prob is filled on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    state, step = W.posenet_setup(gen_seed=5)
    state = TrainState.create(state.model.to("cuda"), step.tx,
                              torch.Generator(device="cuda").manual_seed(5))
    batch = {k: v.cuda() for k, v in
             W.local_batch(W.posenet_batch()).items()}
    step(state, batch)
    profiling.enable(True)
    step(state, batch)
    profiling.enable(False)
    spans = profiling.report()["spans"]
    for name in PSPNET_SPANS:
        assert spans[name]["calls"] == 1, name
        assert spans[name]["counters_inclusive"].get("host_syncs", 0) == 0, (
            name, spans[name]["counters_inclusive"])

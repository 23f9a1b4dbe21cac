"""BENCHMARK.json against the benchmark's contract, and every piece it
names found by name under portbench/."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    for w in bench["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in bench["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names)
    for kind in (bench["configs"], bench["workloads"], metrics):
        assert len({x["name"] for x in kind}) == len(kind)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_entries_have_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_pieces_found_by_name(bench):
    cfgs = {c["name"]: c for c in bench["configs"]}
    for c in cfgs.values():
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["name"] == c["name"]
    for w in bench["workloads"]:
        assert w["config"] in cfgs
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "limits" / f"{w['name']}.json").exists()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()


def test_every_cell_reports_what_it_must(bench):
    from portbench import run
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        own = {m["name"] for m in run.metrics_for(bench, w, False)}
        assert "setup_s" in own and len(own) >= 2
        layer = run.metrics_for(bench, w, True)
        assert layer and all(m["moves"] in own for m in layer)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])

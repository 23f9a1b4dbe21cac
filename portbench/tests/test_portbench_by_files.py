"""A model family, a cell and a kernel op enter the benchmark as new
files alone. Each test copies portbench/ and BENCHMARK.json into a
temporary directory, adds the files that a later change would add
(appending the new cell to BENCHMARK.json, as such a change does), runs a
tiny cell there on the CPU in a process of its own, and finds it
`correct` with every file that portbench/ held before unchanged."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import found, readers, run

ROOT = Path(__file__).resolve().parents[2]

FAMILY = "trcopy"
CONFIG = "trcopy_cleargrasp"
TRAFFIC = "train_bs4"
CELL = f"{FAMILY}.{TRAFFIC}"
PROGRAM_HALF = '''"""TRPESNet's program half under another name."""

from portbench.families.trpesnet.program import (  # noqa: F401
    build, call_train, train_step)
'''
REFERENCE_HALF = '''"""TRPESNet's reference half under another name."""

from portbench.families.trpesnet.reference import (  # noqa: F401
    flop_step, loss, pool, reference_model, tiny)
'''
OP = '''"""A stand-in op: the plain resize that kernel 6's CPU path calls; the
input read and the output written once."""

from portbench.roofline import bound, nbytes

ENTRY = ("pose_estimation_tpu_torch.ops.resize", "resize_bilinear_plain")


def least(x, h, w):
    n, c = x.shape[:2]
    return bound(nbytes(x) + n * c * h * w * x.element_size(), {})
'''
OP_METRIC = '''"""The stand-in op's roofline share, in %."""

from portbench import readers

OPS = ("standin",)


def read(run):
    return readers.op_roofline(run, OPS)
'''


def _copy(tmp: Path) -> Path:
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp)
    return tmp


def _hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _add(root: Path, files: dict):
    for rel, text in files.items():
        path = root / "portbench" / rel
        assert not path.exists(), rel           # new files only
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


def _env() -> dict:
    """The program from the repository, the benchmark from the copy (the
    working directory comes first on the path)."""
    return dict(os.environ, PYTHONPATH=str(ROOT))


def _run(root: Path, code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _tiny_run(workload: str, before: str = "", after: str = "") -> str:
    return (
        "import json, sys, time, torch\n"
        "from portbench import check, run\n"
        "from portbench.tests.tiny import tiny_cell\n"
        + before +
        f"b, c, f, m = tiny_cell({workload!r})\n"
        "code, out = run.run_cell(b, c, f, m, 2 ** 33 + 5, 0.2, False,\n"
        "    torch.device('cpu'), time.time(),\n"
        f"    check.load_limits({workload!r}))\n"
        "got = {'code': code, 'correct': out['correct'],\n"
        "       'metrics': sorted(out['metrics'])}\n"
        + after +
        "print(json.dumps(got))\n")


def test_a_family_enters_as_new_files(tmp_path):
    root = _copy(tmp_path)
    before = _hashes(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs/trpesnet_cleargrasp.json").read_text())
    cfg.update(name=CONFIG, model=FAMILY)
    mix = json.loads((pb / "traffic/train_bs8.json").read_text())
    mix.update(batch_size=4)
    _add(root, {
        f"families/{FAMILY}/program.py": PROGRAM_HALF,
        f"families/{FAMILY}/reference.py": REFERENCE_HALF,
        f"configs/{CONFIG}.json": json.dumps(cfg, indent=1),
        f"traffic/{TRAFFIC}.json": json.dumps(mix, indent=1),
        f"limits/{CELL}.json":
            (pb / "limits/trpesnet.train_bs8.json").read_text()})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    old = {c["name"]: c for c in bench["configs"]}["trpesnet_cleargrasp"]
    bench["configs"].append(dict(old, name=CONFIG,
                                 file=f"portbench/configs/{CONFIG}.json"))
    bench["workloads"].append({"name": CELL, "config": CONFIG,
                               "traffic": TRAFFIC, "chips": 1,
                               "why": "TRPESNet again, at batch 4"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "trpesnet.train_bs8" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    got = _run(root, _tiny_run(CELL, after=(
        "got['family'] = sys.modules["
        f"'portbench.families.{FAMILY}.reference'].__file__\n")))
    assert got["code"] == 0 and got["correct"] is True
    assert got["metrics"] == ["setup_s", "train_samples_per_s"]
    assert Path(got["family"]).is_relative_to(root)
    contract = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "portbench/tests/test_portbench_contract.py"], cwd=root,
        env=_env(), capture_output=True, text=True, timeout=300)
    assert contract.returncode == 0, contract.stdout[-3000:]
    after = _hashes(root)
    assert {k: after[k] for k in before} == before


def test_an_op_enters_as_new_files(tmp_path):
    root = _copy(tmp_path)
    before = _hashes(root)
    _add(root, {"ops/standin.py": OP,
                "metrics/standin_roofline.train.py": OP_METRIC})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "standin_roofline.train", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "ops and csrc",
        "moves": "train_samples_per_s", "workloads": ["trpesnet.train_bs8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    wrap = ("from portbench import program, spans\n"
            "op_spans = spans.OpSpans()\n"
            "b, c, _, _ = run.load_cell('trpesnet.train_bs8')\n"
            "wrapped = run.traced_ops(b, c)\n"
            "program.wrap_ops(op_spans.hook, wrapped)\n"
            "op_spans.counting = True\n")
    read = ("got['wrapped'] = wrapped\n"
            "got['ops'] = op_spans.ops\n"
            "got['launches'] = sorted(program.launches())\n"
            "got['read'] = run.read_metric('standin_roofline.train',\n"
            "    {'trace': {'ops': {'standin': (1e-3, 4e-3, 3)}}})\n")
    got = _run(root, _tiny_run("trpesnet.train_bs8", before=wrap, after=read))
    assert got["code"] == 0 and got["correct"] is True
    assert got["wrapped"] == sorted(readers.KERNELS_1_5 + ("standin",))
    least, calls = got["ops"]["standin"]
    assert calls > 0 and least > 0
    assert "resize.resize_bilinear_plain" in got["launches"]
    assert got["read"] == 25.0
    after = _hashes(root)
    assert {k: after[k] for k in before} == before


@pytest.mark.parametrize("workload, ops", [
    ("krrn.serve_bs256", readers.KERNELS_1_5 + ("resize_bilinear",)),
    ("trpesnet.train_bs8", readers.KERNELS_1_5)])
def test_a_traced_run_wraps_only_the_ops_its_metrics_read(workload, ops):
    bench, cell, _, _ = run.load_cell(workload)
    assert run.traced_ops(bench, cell) == sorted(ops)


def test_an_unknown_name_fails_with_the_path_looked_for():
    for look, path in ((lambda: found.family("nosuch", "reference"),
                        "families/nosuch/reference.py"),
                       (lambda: found.driver("nosuch"), "drivers/nosuch.py")):
        with pytest.raises(FileNotFoundError, match=path):
            look()

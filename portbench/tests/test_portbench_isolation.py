"""Nothing that the benchmark runs loads JAX or the JAX package, and the
reference (the plain models, the families' reference halves and the op
files) imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
JAX_SIDE = {"jax", "jaxlib", "flax", "pose_estimation_tpu"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_no_program():
    halves = sorted(HERE.glob("families/*/reference.py"))
    ops = sorted(HERE.glob("ops/*.py"))
    assert len(halves) >= 2 and len(ops) >= 6
    files = sorted(HERE.glob("reference/*.py")) + halves + ops
    for f in files:
        bad = _imports(f) & (JAX_SIDE | {"pose_estimation_tpu_torch"})
        assert not bad, (f.name, bad)


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, torch\n"
        "from portbench import check, run\n"
        "from portbench.tests.tiny import tiny_cell\n"
        "for w in ('krrn.serve_bs256', 'trpesnet.train_bs8'):\n"
        "    b, c, f, m = tiny_cell(w)\n"
        "    code, out = run.run_cell(b, c, f, m, 7, 0.2, False,\n"
        "        torch.device('cpu'), time.time(), check.load_limits(w))\n"
        "    assert code == 0, code\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n"
        "print(sorted(n for n in sys.modules\n"
        "             if n.startswith(('portbench.families.',\n"
        "                              'portbench.ops.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    loaded = set(eval(lines[-2]))
    assert not loaded & JAX_SIDE, loaded & JAX_SIDE
    assert "pose_estimation_tpu_torch" in loaded
    pieces = set(eval(lines[-1]))
    want = {f"portbench.families.{m}.{h}" for m in ("krrn", "trpesnet")
            for h in ("program", "reference")}
    want |= {f"portbench.ops.{p.stem}" for p in HERE.glob("ops/*.py")
             if p.stem != "__init__"}
    assert want <= pieces, want - pieces

"""The pieces of the benchmark that its data names, found by that name
under portbench/ and imported there:

- a model family, by a configuration file's `model` key: its program
  half `families/<model>/program.py` (the one place besides program.py
  that imports the program) and its reference half
  `families/<model>/reference.py` (plain PyTorch, none of the program);
- a traffic driver, by a traffic file's `driver` key:
  `drivers/<driver>.py`, whose class is `Driver`;
- a kernel op, by a metric file's `OPS` or by the op files present:
  `ops/<op>.py`, the op's entry point in the program and the least time
  of a call.

No file of the harness lists them, so a later change adds a family, a
driver or an op by adding its files."""

from __future__ import annotations

import importlib
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def module(*parts: str):
    """The module portbench/<parts>.py, imported once; a name that is not
    a Python identifier, or a missing file, fails with the path looked
    for."""
    path = HERE.joinpath(*parts[:-1], parts[-1] + ".py")
    if not all(NAME.match(p) for p in parts) or not path.is_file():
        raise FileNotFoundError(f"portbench: no file {path}")
    return importlib.import_module(".".join(("portbench",) + parts))


def family(model: str, half: str):
    """The `half` ("program" or "reference") of the model family."""
    return module("families", model, half)


def driver(name: str) -> type:
    return module("drivers", name).Driver


def op(name: str):
    return module("ops", name)


def ops() -> dict:
    """{op: its module} of every op file, in the order of their names."""
    return {p.stem: op(p.stem)
            for p in sorted((HERE / "ops").glob("*.py"))
            if p.stem != "__init__"}

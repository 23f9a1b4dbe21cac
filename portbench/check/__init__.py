"""The comparison that decides `correct`: the numbers that a cell's
outputs give against the plain reference, each with its limit from
portbench/limits/<workload>.json."""

from __future__ import annotations

import json
from pathlib import Path

LIMITS = Path(__file__).resolve().parent.parent / "limits"


def load_limits(workload: str) -> dict:
    """{number: limit} of the workload."""
    with open(LIMITS / f"{workload}.json") as f:
        return {k: float(v["limit"]) for k, v in json.load(f)["numbers"].items()}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a NaN is not)."""
    return all(numbers[k] <= limits[k] for k in limits)

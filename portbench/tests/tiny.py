"""Tiny configurations and mixes of the benchmark's cells, for the CPU."""

from __future__ import annotations

import copy

from portbench import found, run


def tiny_cell(workload: str):
    """(bench, cell, cfg_file, mix) of `workload` cut to a CPU size."""
    bench, cell, cfg_file, mix = run.load_cell(workload)
    cfg_file = copy.deepcopy(cfg_file)
    found.family(cfg_file["model"], "reference").tiny(cfg_file["schema"])
    mix = dict(mix, batch_size=min(mix["batch_size"], 2),
               pool_batches=3 if mix["driver"] == "train" else 2,
               warmup=dict(mix["warmup"], min_steps=1, min_seconds=0.0,
                           max_seconds=1.0, compare=1))
    return bench, cell, cfg_file, mix

"""Tiny configurations and mixes of the benchmark's cells, for the CPU."""

from __future__ import annotations

import copy

from portbench import run


def tiny_cell(workload: str):
    """(bench, cell, cfg_file, mix) of `workload` cut to a CPU size."""
    bench, cell, cfg_file, mix = run.load_cell(workload)
    cfg_file = copy.deepcopy(cfg_file)
    s = cfg_file["schema"]
    if cfg_file["model"] == "krrn":
        s["module"].update(
            num_cls=3, backbone_outc=16, stem_width=8,
            hrnet_stages=[[1, 1, [8, 8]], [1, 1, [8, 8, 16]],
                          [1, 1, [8, 8, 16, 16]]],
            xyznet={"hidden": 16, "out": 3}, nmlnet={"hidden": 16, "out": 3},
            gcn3d={"neighbor_num": 4, "support_num": 2})
        s["data"].update(num_regions=8, num_points=128, input_size=64)
        s["eval"].update(num_pnp_points=64, pnp_hypotheses=8)
    else:
        s["module"].update(num_cls=3)
        s["data"].update(num_points=32, input_size=32)
    mix = dict(mix, batch_size=min(mix["batch_size"], 2),
               pool_batches=3 if mix["driver"] == "train" else 2,
               warmup=dict(mix["warmup"], min_steps=1, min_seconds=0.0,
                           max_seconds=1.0, compare=1))
    return bench, cell, cfg_file, mix

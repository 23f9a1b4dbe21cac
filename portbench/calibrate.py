"""The readings that the limits of `correct` are set from, on the card at
the cell's own size:

  python -m portbench.calibrate --workload <name> --seeds 1,2,3 \\
      --seconds 2 [--control 3]

For each seed: the cell's set-up, a short window at the cell's load (as
many requests or steps as `--seconds` holds), the program's numbers
(the lower readings); for the first `--control` seeds also the control's
numbers and, for a training cell, the half-batch fault's (the upper
readings). One JSON line a seed, then the largest program reading and
the smallest control and fault readings of every number."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from portbench import found
    _, cell, cfg_file, mix = run.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    cls = found.driver(mix["driver"])
    lower, upper = {}, {}
    for j, seed in enumerate(int(s) for s in args.seeds.split(",")):
        d = cls(cfg_file, mix, seed, dev)
        run.warm_up(d, dict(mix["warmup"], max_seconds=10.0), time.perf_counter)
        t0, i = time.perf_counter(), 0
        while time.perf_counter() - t0 < args.seconds:
            d.step(i)
            i += 1
        d.release(i)
        gc.collect()
        torch.cuda.empty_cache()
        line = {"seed": seed, "steps": i, "program": d.check({})}
        for k, v in line["program"].items():
            if not k.startswith("_"):
                lower[k] = max(lower.get(k, 0.0), v)
        if j < args.control:
            ctl = d.control()
            ctl = ctl if "control" in ctl else {"control": ctl}
            line.update(ctl)
            for kind, nums in ctl.items():
                for k, v in nums.items():
                    if not k.startswith("_"):
                        key = f"{kind}.{k}"
                        upper[key] = min(upper.get(key, float("inf")), v)
        print(json.dumps(line), flush=True)
        del d
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell as `python -m portbench.run ... --trace 1` does, with the
program's own tracing (pose_estimation_tpu_torch/utils/profiling.py)
on from the stage spans' creation to the end of the window:

  python -m portbench.program_run --workload <name> --seed <n> \\
      --seconds <s> [--out <file.json>]

It wraps run.py's steps from outside and changes none of them: tracing
is turned on where run.py makes its stage spans and reset where it
resets them, the program's report is taken before Serve.release or
Train.release drops the program, and the profiler trace that
trace.reduce reads is reduced to the program's ranges too
(program_trace.reduce). Besides
run.py's output it prints the idle time by innermost program span, how
the program's ranges account for the window's idle time, and one last
JSON line: the window's rate, the program's report, the reduction, and
the per-request or per-step readings of the spans (`readings`).

Besides program.py it is the one file of the benchmark that imports the
program: its tracing module. The benchmark's own runs (portbench.run)
leave the program's tracing off.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

from portbench import run as run_mod


def readings(kind: str, report: dict, reduced: dict, traced_steps: int):
    """The per-request (serving) or per-step (training) numbers the
    program's spans and counter give: ms of stream time, host syncs,
    % of idle time, launches."""
    spans, ranges = report["spans"], reduced["spans"]

    def per(name, root):
        ms = spans.get(name, {}).get("stream_ms")
        calls = spans.get(root, {}).get("calls")
        return ms / calls if ms is not None and calls else None

    def syncs(root):
        r = spans.get(root)
        return (r["counters_inclusive"].get("host_syncs", 0) / r["calls"]
                if r else None)

    def idle(name):
        r = ranges.get(name)
        return 100.0 * r["idle_s"] / r["host_s"] if r else None

    if kind == "serve":
        return {"backbone_ms": per("krrn.backbone", "serve.request"),
                "fusion_ms": per("krrn.fusion", "serve.request"),
                "host_syncs": syncs("serve.request"),
                "solve_idle": idle("serve.solve")}
    apply = ranges.get("train.apply")
    return {"optimizer_ms": per("optim.update", "train.step"),
            "apply_launches": (apply["launches"] / traced_steps
                               if apply and traced_steps else None),
            "apply_idle": idle("train.apply"),
            "host_syncs": syncs("train.step")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="write the last line to this file too")
    args = ap.parse_args(argv)

    from pose_estimation_tpu_torch.utils import profiling
    from portbench import program_trace, spans, trace
    from portbench.drivers.serve import Serve
    from portbench.drivers.train import Train
    got = {}

    def after(obj, name, fn):
        orig = getattr(obj, name)

        @functools.wraps(orig)
        def wrapped(*a, **k):
            out = orig(*a, **k)
            fn(*a, out=out)
            return out
        setattr(obj, name, wrapped)

    def before(obj, name, fn):
        orig = getattr(obj, name)

        @functools.wraps(orig)
        def wrapped(*a, **k):
            fn(*a)
            return orig(*a, **k)
        setattr(obj, name, wrapped)

    def report(*_):
        if "program" not in got:
            got["program"] = profiling.report()
            profiling.enable(False)

    after(spans.StageSpans, "__init__",
          lambda *a, out: profiling.enable(True))
    after(spans.StageSpans, "reset", lambda *a, out: profiling.reset())
    after(trace, "reduce", lambda tr, out: got.setdefault(
        "program_trace", program_trace.reduce(tr)))
    before(Serve, "release", report)
    before(Train, "release", report)
    before(run_mod, "read_metric", lambda name, run: got.setdefault(
        "run", run))

    code = run_mod.main(["--workload", args.workload, "--seed",
                         str(args.seed), "--seconds", str(args.seconds),
                         "--trace", "1"])
    if code != 0 or "run" not in got:
        return code or 1
    run, reduced = got["run"], got["program_trace"]
    tr = run["trace"]
    self_idle = sorted(((k, v["self_idle_s"])
                        for k, v in reduced["spans"].items()),
                       key=lambda kv: -kv[1])
    run_mod.note("idle by innermost program span (s): "
                 + json.dumps(self_idle + [("outside every span",
                                            reduced["outside_idle_s"])]))
    accounted = (sum(v for _, v in self_idle) + reduced["outside_idle_s"])
    window_idle = tr["window_s"] - tr["busy_s"]
    run_mod.note(f"idle accounted {accounted:.6f} s, window idle "
                 f"{window_idle:.6f} s of {tr['window_s']:.6f} s: "
                 f"{100.0 * abs(accounted - window_idle) / tr['window_s']:.4f}"
                 f"% of the window apart")
    rate = run["units"] / run["window_s"]
    line = {"workload": args.workload, "seed": args.seed,
            "rate_per_s": rate, "steps": run["steps"],
            "readings": readings(run["kind"], got["program"], reduced,
                                 tr["steps"]),
            "program": got["program"], "program_trace": reduced}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(line, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

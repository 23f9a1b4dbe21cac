"""Run one cell of the benchmark once:

  python -m portbench.run --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout on a machine with the chips the cell asks
for. Set-up builds the program's objects, the seeded weights and the
cell's pool of inputs, and warms up; the window runs the cell's loop for
`--seconds`; then the program's objects are released and the plain
reference decides `correct`. The last line of standard output is one
JSON object: correct, attempted, failed, metrics, device (and with
--trace 1 breakdown), and last `checks`, each compared number beside its
limit. With --trace 0 the metrics are the cell's end-to-end metrics,
with --trace 1 its per-layer metrics, read from the stage and kernel
spans and from a profiler trace of the window's first `trace_seconds`.
"""

from __future__ import annotations

import time

WALL0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pose_estimation_tpu")


def process_start() -> float:
    """The process's start on the wall clock (Linux /proc), else the
    moment this module was first read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return WALL0


def forbidden_modules() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def load_cell(name: str):
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(ROOT / cfg["file"]) as f:
        cfg_file = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    return bench, cell, cfg_file, mix


def metrics_for(bench: dict, cell: dict, trace: bool) -> list:
    """The metric entries this cell reports in this kind of run."""
    name = cell["name"]
    e2e = bench["end_to_end"]

    def applies(m):
        return name in m.get("workloads", [name])
    own = [m for m in e2e if applies(m)]
    if not trace:
        return own
    moved = {m["name"] for m in own}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def metric_module(name: str):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"),
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, run: dict):
    return metric_module(name).read(run)


def traced_ops(bench: dict, cell: dict) -> list:
    """The kernel ops whose calls a traced run of `cell` wraps: those that
    its per-layer metric files name in `OPS`, and no other, so that an op
    file added later leaves the traced runs of cells that do not read it
    as they were."""
    return sorted({op for m in metrics_for(bench, cell, True)
                   for op in getattr(metric_module(m["name"]), "OPS", ())})


def gpu_state(index: int = 0) -> str:
    """The card's SM clock, power, power limit and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def load() -> str:
    """The host's load averages and runnable threads (/proc/loadavg)."""
    try:
        with open("/proc/loadavg") as f:
            return f.read().strip()
    except OSError:
        return "-"


def note(msg: str):
    print(msg, flush=True)


def warm_up(driver, spec: dict, now) -> list:
    """Steps until the least count and seconds are reached and the median
    of the last `compare` step times is within `settle` of the median of
    the `compare` before them, or `max_seconds` have passed."""
    import numpy as np
    times, t0, i = [], now(), 0
    k = spec["compare"]
    while True:
        ts = now()
        driver.step(i, record=False)
        times.append(now() - ts)
        i += 1
        el = now() - t0
        if el >= spec["max_seconds"]:
            break
        if i >= max(spec["min_steps"], 2 * k) and el >= spec["min_seconds"]:
            a = float(np.median(times[-k:]))
            b = float(np.median(times[-2 * k:-k]))
            if abs(a - b) <= spec["settle"] * b:
                break
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--times", help="write the window's step times (s), "
                    "one JSON list, to this file")
    args = ap.parse_args(argv)
    start = process_start()
    bench, cell, cfg_file, mix = load_cell(args.workload)
    build = ROOT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(build / sub))
    os.environ.setdefault("USE_FLAX", "0")

    import torch
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s), "
              f"this machine has {count}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from portbench import check
    keep = {}
    code, out = run_cell(bench, cell, cfg_file, mix, args.seed,
                         args.seconds, bool(args.trace),
                         torch.device("cuda", 0), start,
                         check.load_limits(cell["name"]), keep)
    if args.times:
        with open(args.times, "w") as f:
            json.dump(keep.get("latencies_s"), f)
    if code == 0:
        for k, (v, lim) in out["checks"].items():
            print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr,
                  flush=True)
        print(json.dumps(out), flush=True)
    return code


def run_cell(bench, cell, cfg_file, mix, seed, seconds, trace, dev, start,
             limits, keep=None):
    """(exit code, the result's object) of one run of `cell` on `dev`
    (the CPU too, for the tests, without tracing); `keep` (a dict) gets
    the window's step times."""
    import torch
    from portbench import check, found, program, spans, trace as trace_mod
    now = time.perf_counter
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    note(f"portbench: {cell['name']} seed {seed} seconds {seconds} trace "
         f"{int(trace)}; {name}; torch {torch.__version__} cuda "
         f"{torch.version.cuda}")
    note(f"host: cpus {os.cpu_count()}, affinity "
         f"{len(os.sched_getaffinity(0))}, torch threads "
         f"{torch.get_num_threads()}; card before set-up: "
         f"{gpu_state() if cuda else '-'}")
    t_imported = time.time()
    driver = found.driver(mix["driver"])(cfg_file, mix, seed, dev)
    stage_spans = op_spans = None
    if trace:
        stage_spans = spans.StageSpans(driver.entry, driver.stages)
        op_spans = spans.OpSpans()
        program.wrap_ops(op_spans.hook, traced_ops(bench, cell))
    warm = warm_up(driver, mix["warmup"], now)
    sync()
    mem_warm = torch.cuda.max_memory_allocated(dev) if cuda else 0
    flops = None
    if trace:
        from portbench.flops import step_flops
        flops = step_flops(cfg_file, driver.pool[0], driver.kind == "train")
        stage_spans.reset()
    launches0 = program.launches()
    card_before = gpu_state() if cuda else "-"
    load_before = load()
    setup_s = time.time() - start

    # ------------------------------------------------------------ window
    # a closed loop: one request or step at a time, back to back, each
    # timed from its start to its outputs on the host
    lat, traced_steps, prof, trace_file = [], 0, None, None
    t0 = last_end = now()
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        window_range = torch.profiler.record_function(spans.WINDOW)
        window_range.__enter__()
        op_spans.counting = True
    i = 0
    while True:
        ts = now()
        if ts - t0 >= seconds:
            break
        driver.step(i)
        te = last_end = now()
        lat.append(te - ts)
        i += 1
        if prof is not None and te - t0 >= mix["trace_seconds"]:
            sync()
            window_range.__exit__(None, None, None)
            op_spans.counting = False
            traced_steps = i
            prof.stop()
            fd, trace_file = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            prof.export_chrome_trace(trace_file)
            prof = None
    window_s = last_end - t0
    steps = len(lat)
    if keep is not None:
        keep["latencies_s"] = lat
    sync()
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches1 = program.launches()
    card_after = gpu_state() if cuda else "-"

    run = {"kind": driver.kind, "setup_s": setup_s, "window_s": window_s,
           "units": driver.units(steps), "steps": steps,
           "latencies_s": lat if driver.kind == "serve" else None}
    if trace:
        run["spans"] = stage_spans.totals_ms()
        with open(trace_file) as f:
            reduced = trace_mod.reduce(json.load(f))
        os.remove(trace_file)
        reduced.update(steps=traced_steps, flops_per_step=flops,
                       ops={op: (least, reduced["op_device_s"].get(op, 0.0),
                                 calls)
                            for op, (least, calls) in op_spans.ops.items()})
        run["trace"] = reduced
    note(f"set-up {setup_s:.3f} s: {t_imported - start:.3f} to the driver, "
         + ", ".join(f"{k} {v:.3f}" for k, v in driver.timings.items())
         + f", warm-up {sum(warm):.3f} in {len(warm)} steps "
         f"(last {', '.join(f'{t * 1e3:.1f}' for t in warm[-5:])} ms); "
         f"peak device memory after warm-up {mem_warm}, after the window "
         f"{mem_peak}")
    per_step = {k: (launches1[k] - launches0[k]) / max(steps, 1)
                for k in launches1}
    note(f"window {window_s:.4f} s: {steps} steps, {run['units']} "
         f"{'frames' if driver.kind == 'serve' else 'samples'}; launches a "
         f"step {json.dumps(per_step)}")
    note(f"card before the window: {card_before}; after: {card_after}; "
         f"load before {load_before}, after {load()}")
    if trace:
        tr = run["trace"]
        note(f"trace: {tr['steps']} steps in {tr['window_s']:.4f} s, busy "
             f"{tr['busy_s']:.4f} s, ops' least and device seconds and calls "
             f"{json.dumps(tr['ops'])}, device operations "
             f"{tr['device_events']} ({tr['unattributed']} without a launch "
             f"event), flops a step {flops}; spans (ms, calls) "
             + json.dumps(run["spans"]))

    # ----------------------------------------------------------- correct
    driver.release(steps)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = now()
    numbers = driver.check(limits)
    note(f"check {now() - t_check:.2f} s: " + json.dumps(numbers))
    correct = check.judge(numbers, limits)

    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the benchmark may not load: "
              f"{bad}", file=sys.stderr)
        return 4, None

    metrics = {}
    for m in metrics_for(bench, cell, trace):
        v = read_metric(m["name"], run)
        if v is None:
            print(f"portbench: metric {m['name']} has nothing to read",
                  file=sys.stderr)
            return 5, None
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu", "kind": name,
              "count": cell["chips"], "memory_peak_bytes": mem_peak}
    out = {"correct": correct, "attempted": steps, "failed": 0,
           "metrics": metrics, "device": device}
    if trace:
        tr = run["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = {k: [numbers[k], limits[k]] for k in limits}
    return 0, out


if __name__ == "__main__":
    sys.exit(main())

"""Where the serving step's time goes on the card.

Runs the shipped schema.Config() KRRN (bf16 activations, seeded random
weights) through serve.build_infer_step on a synthetic batch and reports:
  - the program's spans (utils/profiling.py) over --iters requests, each
    span's calls, host ms, stream ms (CUDA events; a span includes the
    device waiting on the host), self host ms and host syncs per
    request: serve.* (request, forward, solve), krrn.* (backbone, heads,
    fusion, pose), pnp.* (hypotheses, score, refine, final) and op.*
    (the five kernel entry points);
  - a torch.profiler window: kernel time by name and the device's busy
    share of the window (idle share = 1 - busy).
Needs a CUDA card; writes the report as JSON to --out as well.

  python -m pose_estimation_tpu_torch.tools.profile_serve \
      --out chiprun_out/profile_serve.json
"""

from __future__ import annotations

import argparse
import json
import time

SPANS = ("serve", "krrn", "pnp", "op")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA card")
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    from pose_estimation_tpu_torch.data.batching import make_batch
    from pose_estimation_tpu_torch.models.krrn import KRRN
    from pose_estimation_tpu_torch.serve import build_infer_step
    from pose_estimation_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = schema.Config()
    bs = args.batch_size
    ds = SyntheticPoseDataset(num_objects=cfg.module.num_cls,
                              frames_per_object=-(-bs // cfg.module.num_cls),
                              num_regions=cfg.data.num_regions)
    batch = make_batch(ds, list(range(bs)), torch.Generator().manual_seed(0),
                       cfg.data.input_size, cfg.data.num_points)
    batch = {k: v.to(dev) for k, v in batch.items()}
    torch.manual_seed(0)
    model = KRRN(cfg, dtype=torch.bfloat16).to(dev).eval()
    step = build_infer_step(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)

    for _ in range(3):
        step(batch, generator=gen)
    profiling.enable(True)
    for _ in range(args.iters):
        step(batch, generator=gen)
    profiling.enable(False)
    reqs = args.iters
    spans = {name: {"calls": r["calls"] / reqs,
                    "host_ms": r["host_ms"] / reqs,
                    "stream_ms": r["stream_ms"] / reqs,
                    "self_host_ms": r["self_host_ms"] / reqs,
                    "host_syncs": r["counters_inclusive"].get(
                        "host_syncs", 0) / reqs}
             for name, r in sorted(profiling.report()["spans"].items())
             if name.split(".")[0] in SPANS}
    profiling.reset()

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(batch, generator=gen)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only (kernels, memcpy/memset): CPU ops also carry
    # the time of the kernels they launch and would count it twice
    rows = [(e.key, _device_us(e) / 1e3 / 3, e.count // 3)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
    kernel_rows = sorted(rows, key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kernel_rows) * 3
    n_kernels = sum(r[2] for r in kernel_rows)

    report = {
        "device": torch.cuda.get_device_name(0),
        "batch_size": bs,
        "iters": reqs,
        "spans_per_request": spans,
        "profiler_window_ms_per_iter": window_ms / 3,
        "device_busy_ms_per_iter": busy_ms / 3,
        "device_idle_share": 1.0 - busy_ms / window_ms,
        "kernel_launches_per_iter": n_kernels,
        "top_kernels_ms_per_iter": [
            {"name": n[:120], "ms": ms, "calls": c}
            for n, ms, c in kernel_rows[:args.top]],
    }
    print(json.dumps(report, indent=1))
    if args.out:
        from pathlib import Path
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()

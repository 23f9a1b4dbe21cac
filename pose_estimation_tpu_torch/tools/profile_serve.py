"""Where the serving step's time goes on the card.

Runs the shipped schema.Config() KRRN (bf16 activations, seeded random
weights) through serve.build_infer_step on a synthetic batch and reports:
  - per-layer stream time (CUDA events before and after HRNet_0,
    XYZHead_0, NMLHead_0, FusionNetLite_0, PoseNet_0, the pose stage and
    the ADD(-S) metric; a span includes the device waiting on the host),
    medians over --iters;
  - host wall time per stage (synchronised);
  - a torch.profiler window: kernel time by name and the device's busy
    share of the window (idle share = 1 - busy).
Needs a CUDA card; writes the report as JSON to --out as well.

  python -m pose_estimation_tpu_torch.tools.profile_serve \
      --out chiprun_out/profile_serve.json
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

LAYERS = ("HRNet_0", "XYZHead_0", "NMLHead_0", "FusionNetLite_0",
          "PoseNet_0")


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
    from pose_estimation_tpu_torch.metrics.metric import pose_accuracy
    from pose_estimation_tpu_torch.models.krrn import KRRN
    from pose_estimation_tpu_torch.serve import build_infer_step

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

    spans = {name: [] for name in LAYERS + ("pose", "metric")}
    open_ev = {}

    def pre(name):
        def hook(mod, inp):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            open_ev[name] = ev
        return hook

    def post(name):
        def hook(mod, inp, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[name].append((open_ev.pop(name), ev))
        return hook

    handles = []
    for name in LAYERS:
        m = getattr(model, name)
        handles.append(m.register_forward_pre_hook(pre(name)))
        handles.append(m.register_forward_hook(post(name)))

    def run_once(record):
        xyz_emb, pred_t = step.forward(batch)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        c = torch.cuda.Event(enable_timing=True)
        a.record()
        out = step.solve(xyz_emb, pred_t, batch, generator=gen)
        b.record()
        pose_accuracy(out["pred_r"], pred_t.float(), batch["target_r"],
                      batch["target_t"], batch["model_points"],
                      batch["sym_mask"], batch["diameter"])
        c.record()
        if record:
            spans["pose"].append((a, b))
            spans["metric"].append((b, c))

    for _ in range(3):
        run_once(False)
    for v in spans.values():
        v.clear()
    host = {"forward": [], "pose": [], "total": []}
    for _ in range(args.iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xyz_emb, pred_t = step.forward(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step.solve(xyz_emb, pred_t, batch, generator=gen)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host["forward"].append((t1 - t0) * 1e3)
        host["pose"].append((t2 - t1) * 1e3)
        host["total"].append((t2 - t0) * 1e3)
    for v in spans.values():
        v.clear()
    for _ in range(args.iters):
        run_once(True)
    torch.cuda.synchronize()
    layer_ms = {k: statistics.median(a.elapsed_time(b) for a, b in v)
                for k, v in spans.items() if v}
    for h in handles:
        h.remove()

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            run_once(False)
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
        "host_ms_median": {k: statistics.median(v) for k, v in host.items()},
        "stream_ms_median_by_layer": layer_ms,
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

"""Batched image -> pose serving CLI (counterpart of tools/infer.py).

Builds KRRN (bf16 activations when the config's train.amp is set), loads
params from a JAX params .npz (save_params_npz format) or initialises them
from --seed, runs the two-stage serving program over the dataset and
writes one JSONL record per frame (rotation, regressed translation, PnP
translation, inlier count, reprojection MSE). A summary JSON line goes to
stdout.

Usage:
  python -m pose_estimation_tpu_torch.tools.infer --synthetic \
      --batch_size 32 --output poses.jsonl [--params params.npz] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time


def load_config(spec: str):
    from pose_estimation_tpu_torch.configs import schema
    factory = getattr(schema, spec, None)
    if factory is None:
        raise SystemExit(f"unknown config preset: {spec}")
    return factory()


def main(argv=None, cfg=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="lm_v3_1")
    p.add_argument("--params", default=None,
                   help="params-only .npz (save_params_npz format)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--frames_per_object", type=int, default=16)
    p.add_argument("--num_frames", type=int, default=None,
                   help="serve only the first N frames")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--output", default="poses.jsonl")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from pose_estimation_tpu_torch.data.batching import (
        eval_indices, make_batch)
    from pose_estimation_tpu_torch.device import resolve_device
    from pose_estimation_tpu_torch.models.krrn import KRRN
    from pose_estimation_tpu_torch.serve import build_infer_step

    if not args.synthetic:
        raise SystemExit("only --synthetic frames are ported; the LineMOD "
                         "readers are not")
    device = resolve_device(args.device)
    cfg = cfg or load_config(args.config)
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    dataset = SyntheticPoseDataset(num_objects=cfg.module.num_cls,
                                   frames_per_object=args.frames_per_object,
                                   num_regions=cfg.data.num_regions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    torch.manual_seed(args.seed)
    dtype = torch.bfloat16 if cfg.train.amp else torch.float32
    model = KRRN(cfg, dtype=dtype)
    if args.params:
        from pose_estimation_tpu_torch.convert import load_params_npz
        load_params_npz(model, args.params)
    model = model.to(device).eval()
    infer_step = build_infer_step(model, cfg)

    n_total = len(dataset) if args.num_frames is None else min(
        args.num_frames, len(dataset))
    batches, valid = eval_indices(n_total, args.batch_size)
    gen = torch.Generator().manual_seed(args.seed)
    solve_gen = torch.Generator(device=device).manual_seed(args.seed + 1)

    n_frames = 0
    t_first = t0 = time.perf_counter()
    with open(args.output, "w") as f:
        for bi, idx in enumerate(batches):
            batch = make_batch(dataset, idx, gen, cfg.data.input_size,
                               cfg.data.num_points)
            batch = {k: v.to(device) for k, v in batch.items()}
            out = infer_step(batch, generator=solve_gen)
            out = {k: v.float().cpu().numpy() for k, v in out.items()}
            if bi == 0:
                t0 = time.perf_counter()     # first batch includes warm-up
            cls = batch["cls"].cpu().numpy()
            for j in np.nonzero(valid[bi])[0]:
                f.write(json.dumps({
                    "index": int(idx[j]),
                    "cls": int(cls[j]),
                    "r": [[round(float(x), 6) for x in row]
                          for row in out["pred_r"][j]],
                    "t": [round(float(x), 6) for x in out["pred_t"][j]],
                    "pnp_t": [round(float(x), 6) for x in out["pnp_t"][j]],
                    "num_inliers": int(out["num_inliers"][j]),
                    "reproj_mse_px": round(float(out["mean_err"][j]), 4),
                }) + "\n")
                n_frames += 1
    wall = time.perf_counter() - t0
    steady = n_frames - int(valid[0].sum())
    summary = {
        "frames": n_frames,
        "output": args.output,
        "device": str(device),
        "wall_s": round(time.perf_counter() - t_first, 3),
        "steady_fps_with_host_data_prep": (
            round(steady / wall, 2) if steady > 0 and wall > 0 else None),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

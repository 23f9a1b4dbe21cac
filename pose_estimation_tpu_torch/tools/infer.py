"""Batched image -> pose serving CLI (counterpart of tools/infer.py).

Builds KRRN (bf16 activations when the config's train.amp is set), loads
its weights from this package's checkpoint directory (--ckpt: the latest
ckpt/<step>/state.pt of a training run, with a BatchNorm model's running
statistics), or from a params .npz in the flax layout (--params:
save_params_npz of either package; not for module.norm="bn", whose
statistics it lacks), or initialises them from --seed, runs the two-stage
serving program over the dataset the config names (mode "eval": the test
split) and writes one JSONL record per frame (rotation, regressed
translation, PnP translation, inlier count, reprojection MSE). A summary
JSON line goes to stdout.

Usage:
  python -m pose_estimation_tpu_torch.tools.infer --config cfg.py \
      --ckpt runs/exp/ckpt --dataset_root data/linemod --batch_size 32 \
      --output poses.jsonl [--max_batches N] [--device cpu]
  python -m pose_estimation_tpu_torch.tools.infer --synthetic \
      --params params.npz --output poses.jsonl
"""

from __future__ import annotations

import argparse
import json
import time


def load_weights(model, cfg, args, device):
    """--params, or --ckpt through CheckpointManager.restore into a
    TrainState of the config (its generator on `device`), or nothing."""
    if args.params and args.ckpt:
        raise SystemExit("--params and --ckpt are mutually exclusive; pass "
                         "one source of weights")
    if args.params:
        if cfg.module.norm == "bn":
            raise SystemExit(
                "--params npz carries no batch_stats; a BatchNorm-parity "
                "config (module.norm='bn') needs the full train state — "
                "use --ckpt <orbax dir> instead")
        from pose_estimation_tpu_torch.convert import load_params_npz
        load_params_npz(model, args.params)
    elif args.ckpt:
        import torch

        from pose_estimation_tpu_torch.train.checkpoint import (
            CheckpointManager)
        from pose_estimation_tpu_torch.train.optim import make_optimizer
        from pose_estimation_tpu_torch.train.state import TrainState
        state = TrainState.create(model, make_optimizer(cfg),
                                  torch.Generator(device=device))
        try:
            restored = CheckpointManager(args.ckpt).restore(state)
        except ValueError as e:
            raise SystemExit(f"{args.ckpt}: the checkpoint does not fit "
                             f"the config: {e}") from e
        if restored is None:
            raise SystemExit(f"no checkpoint found in {args.ckpt}")


def main(argv=None, cfg=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="lm_v3_1",
                   help="preset name in configs.schema or a .py file")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint directory of a training run (ckpt/)")
    p.add_argument("--params", default=None,
                   help="params-only .npz (save_params_npz format)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--dataset_root", default="data/linemod")
    p.add_argument("--frames_per_object", type=int, default=16)
    p.add_argument("--num_frames", type=int, default=None,
                   help="serve only the first N frames")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--output", default="poses.jsonl")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    p.add_argument("--enable_rot", action="store_true",
                   help="KRRN with its two rotation heads (the model the "
                        "checkpoint was trained with)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from pose_estimation_tpu_torch.cli import build_dataset, load_config
    from pose_estimation_tpu_torch.data.batching import eval_indices
    from pose_estimation_tpu_torch.data.prefetch import prefetched_epoch
    from pose_estimation_tpu_torch.device import resolve_device
    from pose_estimation_tpu_torch.models.krrn import KRRN
    from pose_estimation_tpu_torch.serve import build_infer_step

    device = resolve_device(args.device)
    cfg = cfg or load_config(args.config)
    dataset = build_dataset(cfg, args, mode="eval")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    torch.manual_seed(args.seed)
    dtype = torch.bfloat16 if cfg.train.amp else torch.float32
    model = KRRN(cfg, dtype=dtype, enable_rot=args.enable_rot).to(device)
    load_weights(model, cfg, args, device)
    model.eval()
    infer_step = build_infer_step(model, cfg)

    n_total = len(dataset) if args.num_frames is None else min(
        args.num_frames, len(dataset))
    batches, valid = eval_indices(n_total, args.batch_size)
    if args.max_batches is not None:
        batches, valid = batches[:args.max_batches], valid[:args.max_batches]
    solve_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    stream = prefetched_epoch(dataset, batches,
                              torch.Generator().manual_seed(args.seed),
                              cfg.data.input_size, cfg.data.num_points)

    n_frames = 0
    t_first = t0 = time.perf_counter()
    try:
        with open(args.output, "w") as f:
            for bi, batch in enumerate(stream):
                batch = {k: v.to(device) for k, v in batch.items()}
                out = infer_step(batch, generator=solve_gen)
                out = {k: v.float().cpu().numpy() for k, v in out.items()}
                if bi == 0:
                    t0 = time.perf_counter()  # first batch: warm-up
                cls = batch["cls"].cpu().numpy()
                for j in np.nonzero(valid[bi])[0]:
                    f.write(json.dumps({
                        "index": int(batches[bi][j]),
                        "cls": int(cls[j]),
                        "r": [[round(float(x), 6) for x in row]
                              for row in out["pred_r"][j]],
                        "t": [round(float(x), 6) for x in out["pred_t"][j]],
                        "pnp_t": [round(float(x), 6)
                                  for x in out["pnp_t"][j]],
                        "num_inliers": int(out["num_inliers"][j]),
                        "reproj_mse_px": round(float(out["mean_err"][j]), 4),
                    }) + "\n")
                    n_frames += 1
    finally:
        stream.close()
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

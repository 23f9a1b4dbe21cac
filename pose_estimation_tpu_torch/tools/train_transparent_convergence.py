"""Transparent-pipeline accuracy evidence (counterpart of
tools/train_transparent_convergence.py): train TRPESNet on the synthetic
transparent fixture, evaluate the trained model through the batched
confidence-argmax eval on a held-out pose split (pose_seed=7), and write
the per-object ADD(-S) table. With --refine the eval adds the gated
trimmed ICP against the completed depth (cfg.train.refine).

Every training batch is built once into a store on the device and each
step gathers its batch there. The run trains on the card unless given
--device cpu (no card raises), saves a final checkpoint under
<log_root>/trpes/ckpt, and with --eval_from_ckpt evaluates a saved
checkpoint without training.

  python -m pose_estimation_tpu_torch.tools.train_transparent_convergence \
      [--epochs 64] [--refine] [--device cpu]

writes build/convergence_transparent/results_transparent.json
(RESULTS_transparent.json is the JAX tool's); the logs and checkpoints go
under build/convergence_transparent.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def make_cfg(schema, epochs: int = 64, refine: bool = False):
    """A fixture-sized TRPESNet (96-px crops, 256 points, 4 classes,
    Adam): the JAX tool's configuration, field for field."""
    return schema.override(
        schema.transparent_cleargrasp(),
        **{"train.num_epoch": epochs,   # real horizon -> LR anneal engages
           "module.num_cls": 4, "data.num_points": 256,
           "data.input_size": 96, "train.batch_size": 16,
           "train.amp": True, "train.ckpt_every": 0,
           "train.refine": refine,  # eval-time trimmed ICP vs completed depth
           "train.lr.lr": 2e-4, "train.lr.warmup_iters": 100,
           "train.lr.anneal_point": 0.6,
           "train.optimizer": schema.OptimizerConfig(type="Adam")})


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=64)
    p.add_argument("--frames_per_object", type=int, default=256)
    p.add_argument("--out", default="build/convergence_transparent/"
                                    "results_transparent.json")
    p.add_argument("--log_root", default="build/convergence_transparent")
    p.add_argument("--refine", action="store_true",
                   help="eval-time trimmed-ICP refinement against the "
                        "predicted completed depth (cfg.train.refine)")
    p.add_argument("--eval_from_ckpt", default="",
                   help="skip training; rebuild the results from this "
                        "saved checkpoint dir (a run saves one at "
                        "<log_root>/trpes/ckpt)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    args = p.parse_args(argv)

    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.data.batching import epoch_indices
    from pose_estimation_tpu_torch.data.synthetic import (
        SyntheticTransparentDataset)
    from pose_estimation_tpu_torch.train.trainer import _generator
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        TransparentTrainer)

    cfg = make_cfg(schema, epochs=args.epochs, refine=args.refine)
    train_ds = SyntheticTransparentDataset(
        num_objects=4, frames_per_object=args.frames_per_object,
        im_h=240, im_w=320, num_regions=16, pose_seed=0, sym_objects=(3,),
        cache_frames=True)
    test_ds = SyntheticTransparentDataset(
        num_objects=4, frames_per_object=32,
        im_h=240, im_w=320, num_regions=16, pose_seed=7, sym_objects=(3,),
        cache_frames=True)
    tr = TransparentTrainer(cfg, train_ds, test_dataset=test_ds,
                            log_dir=f"{args.log_root}/trpes",
                            resume=args.eval_from_ckpt or None,
                            device=args.device)
    tr.init_state()

    train_sec = 0.0
    if not args.eval_from_ckpt:
        bs = cfg.train.batch_size
        print(f"[trpes] building device store ({len(train_ds)} samples)...",
              flush=True)
        starts = range(0, len(train_ds) - bs + 1, bs)
        stream = tr._batches(train_ds, [range(s, s + bs) for s in starts], 0)
        try:
            chunks = [tr._to_device(b) for b in stream]
        finally:
            stream.close()
        store = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
        t0 = time.time()
        for epoch in range(args.epochs):
            for idx in epoch_indices(_generator(cfg.seed, 1, epoch),
                                     len(train_ds), bs):
                i = torch.as_tensor(idx, device=tr.device)
                metrics = tr.train_step(tr.state,
                                        {k: v[i] for k, v in store.items()})
            if not np.isfinite(float(metrics["all_loss"])):
                print(f"[trpes] non-finite loss at epoch {epoch}; aborting",
                      flush=True)
                break
            if (epoch + 1) % 8 == 0:
                s = tr.test_epoch(epoch)
                print(f"[trpes] epoch {epoch}: {json.dumps(s['overall'])}",
                      flush=True)
        train_sec = time.time() - t0
        # the final checkpoint: eval-side variants rerun from here
        tr.ckpt.save(tr.state.step, tr.state, metrics={"final": 1.0})
    summary = tr.test_epoch(999)

    results = {
        "refine_icp": args.refine,
        **({"eval_from_ckpt": args.eval_from_ckpt}
           if args.eval_from_ckpt else {}),
        "fixture": "SyntheticTransparentDataset(4 objects, 1 symmetric, "
                   "held-out pose_seed=7 split)",
        "protocol": "batched TRPESNet eval: confidence-argmax point pose, "
                    "allocentric->egocentric rotation, ADD(-S) < 0.1 * "
                    "true max-pairwise diameter",
        "epochs": args.epochs,
        "steps": tr.state.step,
        "train_seconds": (None if args.eval_from_ckpt
                          else round(train_sec, 1)),
        "train_fps": (None if args.eval_from_ckpt
                      else round(tr.state.step * cfg.train.batch_size
                                 / max(train_sec, 1e-9), 1)),
        "per_object": summary["per_object"],
        "overall": summary["overall"],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results["overall"], indent=2))
    return results


if __name__ == "__main__":
    main()

"""Solver-settings sweep on a saved convergence checkpoint (counterpart
of tools/eval_solver_sweep.py).

Restores the checkpoint a train_synthetic_convergence run saved and
re-evaluates the held-out split (4 objects x 32 frames, pose_seed=7)
under four PnP-RANSAC settings (the cfg.eval default; 32 hypotheses, the
hard 2-px inliers, one LM start; 64 with the Cauchy reweighting; 64 with
four LM starts) without retraining: the cheap way to split the rotation
error's tail between the coordinate map's noise and the solver's slack.
On the card unless given --device cpu (no card raises).

  python -m pose_estimation_tpu_torch.tools.eval_solver_sweep \
      --ckpt build/convergence/raw_xyz/ckpt [--region_decode] [--out F]
"""

from __future__ import annotations

import argparse
import json

SWEEPS = {
    # {} = the cfg.eval defaults (h64 + robust + top4)
    "default": {},
    "h32_hard_top1": dict(pnp_hypotheses=32, robust_refine=False,
                          refine_top_k=1),
    "h64_robust": dict(pnp_hypotheses=64, robust_refine=True,
                       refine_top_k=1),
    "h64_top4": dict(pnp_hypotheses=64, robust_refine=False,
                     refine_top_k=4),
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--region_decode", action="store_true")
    p.add_argument("--epochs", type=int, default=160,
                   help="the training run's horizon (cfg parity only; it "
                        "changes nothing at eval)")
    p.add_argument("--out", default="")
    p.add_argument("--log_dir", default="build/eval_sweep")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    args = p.parse_args(argv)

    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    from pose_estimation_tpu_torch.serve import build_eval_step
    from pose_estimation_tpu_torch.tools import train_synthetic_convergence
    from pose_estimation_tpu_torch.train.trainer import Trainer

    cfg = train_synthetic_convergence.make_cfg(schema, args.region_decode,
                                               epochs=args.epochs)
    test_ds = SyntheticPoseDataset(
        num_objects=4, frames_per_object=32,
        im_h=240, im_w=320, num_regions=16, pose_seed=7, sym_objects=(3,),
        cache_frames=True)
    tr = Trainer(cfg, test_ds, test_dataset=test_ds, log_dir=args.log_dir,
                 resume=args.ckpt, device=args.device)
    tr.init_state()

    report = {}
    for name, kw in SWEEPS.items():
        tr.eval_step = build_eval_step(tr.model, cfg, **kw)
        s = tr.test_epoch(2000)
        report[name] = s["overall"]
        print(f"[sweep {name}] {json.dumps(s['overall'])}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()

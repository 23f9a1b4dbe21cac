"""Declarative ICP refinement demo (counterpart of
tools/refine_declarative.py): how much trimmed ICP against the depth
cloud improves perturbed poses on the synthetic fixture.

Rebuild of version/transparent/scripts/train_declarative.py (:42-109):
perturb the ground-truth pose of each frame by a fixed rotation angle
about a random axis and a fixed translation in a random direction,
refine it against the back-projected depth cloud (core.solvers.icp_refine:
a fixed number of trimmed ICP iterations, one nearest-source kernel
launch each on the card), and report the mean ADD, rotation and
translation errors before and after, and the last iteration's mean
residual. The source is the visible surface in the model frame (the
ground-truth coordinate map at the chosen pixels), as the prototype
aligns per-pixel coordinates against the cloud.

  python -m pose_estimation_tpu_torch.tools.refine_declarative \
      [--rot_deg 10] [--trans_mm 20] [--trim 0.3] [--device cpu]

prints the JSON report (rounded as the JAX tool prints it) and returns it
unrounded. Without a card it raises unless given --device cpu.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rot_deg", type=float, default=10.0)
    p.add_argument("--trans_mm", type=float, default=20.0)
    p.add_argument("--trim", type=float, default=0.3)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    args = p.parse_args(argv)

    from pose_estimation_tpu_torch.core.geometry.rotations import (
        angular_distance, axis_angle_to_matrix)
    from pose_estimation_tpu_torch.core.solvers.icp import icp_refine
    from pose_estimation_tpu_torch.data import batching
    from pose_estimation_tpu_torch.data.pipeline import denormalize_xyz
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    from pose_estimation_tpu_torch.device import resolve_device
    from pose_estimation_tpu_torch.metrics.metric import add_metric

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = SyntheticPoseDataset(num_objects=4,
                              frames_per_object=args.frames // 4 + 1,
                              im_h=240, im_w=320, num_regions=16)
    host = batching.make_batch(ds, list(range(args.frames)),
                               torch.Generator().manual_seed(0), 96, 512)
    batch = {k: v.to(dev) for k, v in host.items()}

    # perturb gt poses
    rng = np.random.RandomState(0)
    axis = rng.randn(args.frames, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    dr = axis_angle_to_matrix(torch.as_tensor(
        axis * np.radians(args.rot_deg), dtype=torch.float32, device=dev))
    r0 = dr @ batch["target_r"]
    dt = rng.randn(args.frames, 3)
    dt = dt / np.linalg.norm(dt, axis=-1, keepdims=True) * args.trans_mm / 1e3
    t0 = batch["target_t"] + torch.as_tensor(dt, dtype=torch.float32,
                                             device=dev)

    xyz = denormalize_xyz(batch["xyz"], batch["lf_border"], batch["extent"])
    b, s, _, _ = xyz.shape
    flat = xyz.reshape(b, s * s, 3)
    src = torch.gather(flat, 1, batch["choose"].long()[..., None].expand(
        -1, -1, 3))[:, :256].contiguous()
    r1, t1, res = icp_refine(src, batch["cloud"], r0, t0, iters=args.iters,
                             trim_fraction=args.trim)

    def summarize(r, t):
        dis = add_metric(r, t, batch["target_r"], batch["target_t"],
                         batch["model_points"], batch["sym_mask"])
        return {
            "add_mm": float(dis.mean()) * 1000,
            "rot_deg": float(angular_distance(r, batch["target_r"]).mean()),
            "trans_mm": float(torch.linalg.norm(
                t - batch["target_t"], dim=-1).mean()) * 1000,
        }

    out = {"noise": {"rot_deg": args.rot_deg, "trans_mm": args.trans_mm},
           "before": summarize(r0, t0),
           "after": summarize(r1, t1),
           "mean_residual_mm": float(res.mean()) * 1000}
    rounded = {k: ({kk: round(vv, 2) for kk, vv in v.items()}
                   if k in ("before", "after") else
                   v if k == "noise" else round(v, 2))
               for k, v in out.items()}
    print(json.dumps(rounded, indent=2))
    return out


if __name__ == "__main__":
    main()

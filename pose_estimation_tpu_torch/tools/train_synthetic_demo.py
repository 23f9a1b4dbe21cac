"""Learning-sanity demo (counterpart of tools/train_synthetic_demo.py):
train a medium KRRN (96-px crops, 512 points, a narrow HRNet, K=8, S=4,
3 classes, bf16, bs 16) on the synthetic fixture for 12 epochs (144
steps) and print the eval on 4 batches before and after: the end-to-end
"does it learn" check.

  python -m pose_estimation_tpu_torch.tools.train_synthetic_demo \
      [--log_dir build/train_demo] [--device cpu]

On the card unless given --device cpu (no card raises).
"""

from __future__ import annotations

import argparse
import json
import time


def make_cfg(schema):
    """The JAX demo's configuration, field for field."""
    return schema.override(
        schema.Config(),
        **{"module.num_cls": 3, "data.num_regions": 16,
           "data.num_points": 512, "data.input_size": 96,
           "module.backbone_outc": 64, "module.stem_width": 32,
           "module.hrnet_stages": ((1, 2, (32, 32)), (2, 2, (32, 32, 64)),
                                   (1, 2, (32, 32, 64, 64))),
           "module.xyznet": schema.HeadConfig(hidden=64),
           "module.nmlnet": schema.HeadConfig(hidden=64),
           "train.batch_size": 16, "train.amp": True,
           "train.start_pose_epoch": 0,
           "train.lr.lr": 3e-4, "train.lr.warmup_iters": 100,
           "module.gcn3d": schema.Gcn3dConfig(neighbor_num=8,
                                              support_num=4)})


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--log_dir", default="build/train_demo")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    args = p.parse_args(argv)

    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    from pose_estimation_tpu_torch.train.trainer import Trainer

    cfg = make_cfg(schema)
    ds = SyntheticPoseDataset(num_objects=3, frames_per_object=64,
                              im_h=240, im_w=320, num_regions=16)
    tr = Trainer(cfg, ds, log_dir=args.log_dir, device=args.device)
    tr.init_state()
    print("eval BEFORE training:")
    s0 = tr.test_epoch(0, max_batches=4)
    print(json.dumps(s0["overall"]))
    t0 = time.time()
    for epoch in range(12):
        tr.train_epoch(epoch)
    train_sec = time.time() - t0
    print(f"trained 12 epochs in {train_sec:.0f}s, "
          f"step={tr.state.step}")
    print("eval AFTER training:")
    s1 = tr.test_epoch(99, max_batches=4)
    print(json.dumps(s1["overall"]))
    return {"before": s0["overall"], "after": s1["overall"],
            "steps": tr.state.step, "train_seconds": train_sec}


if __name__ == "__main__":
    main()

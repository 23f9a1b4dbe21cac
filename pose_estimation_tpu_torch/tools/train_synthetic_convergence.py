"""Accuracy-evidence run (counterpart of
tools/train_synthetic_convergence.py): train KRRN on the synthetic
fixture, evaluate the trained model through the full PnP eval path on a
held-out pose split (pose_seed=7), and write the per-object ADD(-S)
table, for each variant asked for:

  raw_xyz          the mini config (96-px crops, 512 points, a narrow
                   HRNet, K=8, S=4, 4 classes)
  region_decoded   the same with module.xyz_offset_decode
  capacity         a fuller model (128-px crops, 1024 points, a wider
                   HRNet, K=10, S=7)
  region_capacity  capacity with region decoding
  flagship         the unmodified schema.Config() (full HRNet, 13 classes,
                   128-px crops, 1024 points, 64 regions), only the
                   training knobs set

Every training sample is preprocessed once into a store on the device
(build_device_store) and each step gathers its batch there. The run
trains on the card unless given --device cpu (no card raises), saves a
final checkpoint under <log_root>/<variant>/ckpt, and with
--eval_from_ckpt evaluates a saved checkpoint without training.

  python -m pose_estimation_tpu_torch.tools.train_synthetic_convergence \
      [--variants raw_xyz,flagship] [--epochs 160] [--device cpu]

writes build/convergence/results_synthetic.json (RESULTS_synthetic.json
is the JAX tool's) under a file lock, merged with the file's variants with
--append; the logs and checkpoints go under build/convergence.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def make_cfg(schema, region_decode: bool = False, epochs: int = 160,
             capacity: bool = False, flagship: bool = False):
    """capacity=True: a fuller model + finer inputs (128px crops, 1024
    points, wider HRNet). flagship=True: the unmodified schema.Config()
    model/data settings, only the training-run knobs (epochs/LR/batch)
    set. The JAX tool's configurations, field for field."""
    if flagship:
        return schema.override(
            schema.Config(),
            **{"train.num_epoch": epochs,
               "train.batch_size": 16, "train.amp": True,
               "train.start_pose_epoch": 0,
               "train.ckpt_every": 0,
               "train.lr.lr": 3e-4, "train.lr.warmup_iters": 100,
               "train.lr.anneal_point": 0.5,
               "module.xyz_offset_decode": region_decode})
    if capacity:
        size = {"data.num_regions": 16, "data.num_points": 1024,
                "data.input_size": 128,
                "module.backbone_outc": 128, "module.stem_width": 48,
                "module.hrnet_stages": ((1, 3, (48, 48)),
                                        (3, 3, (48, 48, 96)),
                                        (2, 3, (48, 48, 96, 96))),
                "module.xyznet": schema.HeadConfig(hidden=128),
                "module.nmlnet": schema.HeadConfig(hidden=128),
                "module.gcn3d": schema.Gcn3dConfig(neighbor_num=10,
                                                   support_num=7),
                "train.lr.anneal_point": 0.5}
    else:
        size = {"data.num_regions": 16, "data.num_points": 512,
                "data.input_size": 96,
                "module.backbone_outc": 64, "module.stem_width": 32,
                "module.hrnet_stages": ((1, 2, (32, 32)),
                                        (2, 2, (32, 32, 64)),
                                        (1, 2, (32, 32, 64, 64))),
                "module.xyznet": schema.HeadConfig(hidden=64),
                "module.nmlnet": schema.HeadConfig(hidden=64),
                "module.gcn3d": schema.Gcn3dConfig(neighbor_num=8,
                                                   support_num=4),
                "train.lr.anneal_point": 0.6}
    return schema.override(
        schema.Config(),
        **{"train.num_epoch": epochs,   # real horizon -> LR anneal engages
           "module.num_cls": 4,
           "module.xyz_offset_decode": region_decode,
           "train.batch_size": 16, "train.amp": True,
           "train.start_pose_epoch": 0,
           "train.ckpt_every": 0,
           "train.lr.lr": 3e-4, "train.lr.warmup_iters": 100,
           **size})


# name -> (region_decode, capacity, flagship)
SPEC = {"raw_xyz": (False, False, False),
        "region_decoded": (True, False, False),
        "capacity": (False, True, False),
        "region_capacity": (True, True, False),
        "flagship": (False, False, True)}


def build_device_store(dataset, cfg, generator, device, chunk: int = 16):
    """Every full chunk of the dataset preprocessed once (the crop and
    choose draws from `generator`) and stacked on `device`: {key: [n,
    ...]}. Each step then gathers its batch on the device."""
    from pose_estimation_tpu_torch.data import batching
    chunks = [batching.make_batch(dataset, range(start, start + chunk),
                                  generator, cfg.data.input_size,
                                  cfg.data.num_points)
              for start in range(0, len(dataset) - chunk + 1, chunk)]
    return {k: torch.cat([c[k] for c in chunks]).to(device)
            for k in chunks[0]}


def run_variant(name: str, region_decode: bool, epochs: int,
                train_ds, test_ds, store, log_root: str,
                refine_epochs: int = 0, ablation: bool = False,
                capacity: bool = False, flagship: bool = False,
                eval_from_ckpt: str = "", device="cuda"):
    """Train (unless `eval_from_ckpt`) and evaluate one variant; its
    results entry. eval_from_ckpt: restore that checkpoint directory and
    run only the eval (and the ablation)."""
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.data.batching import epoch_indices
    from pose_estimation_tpu_torch.serve import build_eval_step
    from pose_estimation_tpu_torch.train.train_step import build_train_step
    from pose_estimation_tpu_torch.train.trainer import Trainer, _generator

    total_epochs = epochs + refine_epochs
    cfg = make_cfg(schema, region_decode, epochs=total_epochs,
                   capacity=capacity, flagship=flagship)
    tr = Trainer(cfg, train_ds, test_dataset=test_ds,
                 log_dir=f"{log_root}/{name}",
                 resume=eval_from_ckpt or None, device=device)
    tr.init_state()

    # the last `refine_epochs` epochs add the differentiable-PnP ADD term
    # (cfg.train.refine) on the same optimizer and LR horizon
    refine_step = None
    if refine_epochs and not eval_from_ckpt:
        cfg_ref = schema.override(cfg, **{"train.refine": True})
        refine_step = build_train_step(tr.model, tr.tx, cfg_ref)

    bs = cfg.train.batch_size
    t0 = time.time()
    train_epochs = 0 if eval_from_ckpt else total_epochs
    for epoch in range(train_epochs):
        step_fn = (refine_step if refine_step is not None
                   and epoch >= epochs else tr.train_step)
        for idx in epoch_indices(_generator(cfg.seed, 1, epoch),
                                 len(train_ds), bs):
            i = torch.as_tensor(idx, device=tr.device)
            metrics = step_fn(tr.state, {k: v[i] for k, v in store.items()},
                              opt_pose=True)
        # once an epoch, not a step: the divergence check syncs the host
        if not np.isfinite(float(metrics["loss"])):
            print(f"[{name}] non-finite loss at epoch {epoch}; aborting",
                  flush=True)
            break
        if (epoch + 1) % 8 == 0:
            s = tr.test_epoch(epoch)
            print(f"[{name}] epoch {epoch}: "
                  f"{json.dumps(s['overall'])}", flush=True)
    train_sec = time.time() - t0
    if not eval_from_ckpt:
        # the final checkpoint: eval-side experiments rerun from here
        tr.ckpt.save(tr.state.step, tr.state, metrics={"final": 1.0})
    summary = tr.test_epoch(999)
    frames = tr.state.step * cfg.train.batch_size
    result = {
        "variant": name,
        "region_decode": region_decode,
        "epochs": epochs,
        "refine_epochs": refine_epochs,
        "steps": tr.state.step,
        "train_seconds": None if eval_from_ckpt else round(train_sec, 1),
        "train_fps": (None if eval_from_ckpt
                      else round(frames / max(train_sec, 1e-9), 1)),
        "per_object": summary["per_object"],
        "overall": summary["overall"],
    }
    if eval_from_ckpt:
        result["eval_from_ckpt"] = eval_from_ckpt
    if ablation:
        # solver settings on the same trained weights, as deltas from the
        # cfg.eval default (h64 + Cauchy-robust LM + top-4 multi-start)
        abl = {}
        variants = {
            "h32_hard_top1": dict(pnp_hypotheses=32, robust_refine=False,
                                  refine_top_k=1),
            "no_robust": dict(robust_refine=False),
            "top1": dict(refine_top_k=1),
            "p512": dict(num_pnp_points=512),
        }
        if region_decode:
            variants["hard_decode"] = dict(hard=True)
        for aname, kw in variants.items():
            acfg = cfg
            if kw.pop("hard", False):
                acfg = schema.override(
                    cfg, **{"module.region_soft_decode": False})
            tr.eval_step = build_eval_step(tr.model, acfg, **kw)
            s = tr.test_epoch(1000)
            abl[aname] = s["overall"]
            print(f"[{name}] ablation {aname}: "
                  f"{json.dumps(s['overall'])}", flush=True)
        result["eval_ablation"] = abl
    return result


def merge_variants(existing, produced):
    """This run's variant entries overlaid on the file's current ones
    (read at write time); this run's win name collisions."""
    ours = {v["variant"] for v in produced}
    return [v for v in existing if v["variant"] not in ours] + produced


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=160)
    p.add_argument("--refine_epochs", type=int, default=0,
                   help="extra epochs with the differentiable-PnP ADD "
                        "term (cfg.train.refine) after the main phase")
    p.add_argument("--frames_per_object", type=int, default=512)
    p.add_argument("--out", default="build/convergence/results_synthetic.json")
    p.add_argument("--log_root", default="build/convergence")
    p.add_argument("--variants", default="raw_xyz,region_decoded",
                   help="comma list of " + "|".join(SPEC))
    p.add_argument("--append", action="store_true",
                   help="merge into an existing --out file instead of "
                        "overwriting (replaces same-named variants)")
    p.add_argument("--eval_from_ckpt", default="",
                   help="skip training; rebuild the (single) variant's "
                        "entry by evaluating this checkpoint dir")
    p.add_argument("--eval_ablation", action="store_true",
                   help="after training, re-evaluate the checkpoint under "
                        "alternative solver settings")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    args = p.parse_args(argv)

    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    from pose_estimation_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    wanted = [v.strip() for v in args.variants.split(",") if v.strip()]
    unknown = [v for v in wanted if v not in SPEC]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}")
    if args.eval_from_ckpt and len(wanted) != 1:
        raise SystemExit("--eval_from_ckpt takes exactly one variant")

    # 4 objects, one symmetric (class 3) for ADD-S; the datasets and the
    # device store are shared by variants at the same region count / crop
    ds_cache: dict = {}

    def get_datasets(num_regions: int):
        if num_regions not in ds_cache:
            ds_cache[num_regions] = (
                SyntheticPoseDataset(
                    num_objects=4,
                    frames_per_object=args.frames_per_object,
                    im_h=240, im_w=320, num_regions=num_regions,
                    pose_seed=0, sym_objects=(3,), cache_frames=True),
                SyntheticPoseDataset(
                    num_objects=4, frames_per_object=32,
                    im_h=240, im_w=320, num_regions=num_regions,
                    pose_seed=7, sym_objects=(3,), cache_frames=True))
        return ds_cache[num_regions]

    results = {"fixture": "SyntheticPoseDataset v2 (4 objects, 1 symmetric "
                          "[ADD-S], multi-octave object-frame texture, "
                          "held-out pose_seed=7 split)",
               "protocol": "full PnP eval path (EPnP-RANSAC rotation on the "
                           "device + regressed translation); thresholds "
                           "ADD(-S) < {0.1, 0.05, 0.02} * diameter, "
                           "5deg5cm; AUC over [0, 0.1m]",
               "variants": []}
    produced = []
    store, store_key = None, None
    for name in wanted:
        region_decode, capacity, flagship = SPEC[name]
        cfg_v = make_cfg(schema, region_decode, epochs=args.epochs,
                         capacity=capacity, flagship=flagship)
        train_ds, test_ds = get_datasets(cfg_v.data.num_regions)
        need = (cfg_v.data.input_size, cfg_v.data.num_points,
                cfg_v.data.num_regions)
        if not args.eval_from_ckpt and store_key != need:
            print(f"building device store ({len(train_ds)} samples, "
                  f"crop {need[0]}, {need[1]} pts)...", flush=True)
            store = None    # the previous store's memory goes first
            store = build_device_store(train_ds, cfg_v,
                                       torch.Generator().manual_seed(777),
                                       dev)
            store_key = need
        produced.append(run_variant(
            name, region_decode, args.epochs, train_ds, test_ds, store,
            args.log_root, refine_epochs=args.refine_epochs,
            ablation=args.eval_ablation, capacity=capacity,
            flagship=flagship, eval_from_ckpt=args.eval_from_ckpt,
            device=dev))

    # an exclusive lock across read -> merge -> write, so that two runs
    # finishing together cannot each rebuild from pre-merge contents; the
    # write goes through a rename, so readers never see a torn file
    import fcntl
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if args.append and os.path.isfile(args.out):
            with open(args.out) as f:
                results = json.load(f)
        results["variants"] = merge_variants(results.get("variants", []),
                                             produced)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results, f, indent=2)
        os.replace(tmp, args.out)
    print(json.dumps({v["variant"]: v["overall"]
                      for v in results["variants"]}, indent=2))
    return results


if __name__ == "__main__":
    main()

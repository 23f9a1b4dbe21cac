"""Per-component timing of the eval path (counterpart of
pose_estimation_tpu/tools/profile_eval.py): the same components, in the
same order, at the same sizes (schema.Config(), bs=32, bf16 activations,
seeded random weights, a synthetic batch):

  model   KRRN forward with and without fusion (opt_pose True / False)
  hrnet   the HRNet backbone alone
  fusion  FusionNetLite alone
  ops     KNN N=1024 k=10; the wide-table aggregate N=1024 S*O=896;
          nearest_index 1024 <- 256; the fused linear aggregate kernel and
          its plain version at level 0; the fused surface kernel; the
          theta-only aggregate; a PoolLayer; the wide-table aggregate at
          the level-1 size N=256
  pnp     batched PnP-RANSAC, b=32, 32 hypotheses, 256 points

Each component is timed over --reps calls after one warm-up call: on the
card with CUDA events around the calls (ms per call), on the CPU with the
host clock. One line per component, then a JSON line with all of them.
PROFILE_ONLY (or --only) picks tags, comma separated.

  python -m pose_estimation_tpu_torch.tools.profile_eval [--reps 10]
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _timer(dev, reps):
    import torch

    def timed(fn):
        with torch.inference_mode():
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(reps):
                    fn()
                b.record()
                b.synchronize()
                return a.elapsed_time(b) / reps
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
    return timed


def main(argv=None, cfg=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card raises) or cpu")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--only", default=os.environ.get("PROFILE_ONLY", ""),
                   help="comma-separated tags: model,hrnet,fusion,ops,pnp")
    args = p.parse_args(argv)

    import torch

    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.core import pointops as po
    from pose_estimation_tpu_torch.core.solvers.pnp import pnp_ransac
    from pose_estimation_tpu_torch.data.batching import make_batch
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    from pose_estimation_tpu_torch.device import resolve_device
    from pose_estimation_tpu_torch.models.fusion import FusionNetLite
    from pose_estimation_tpu_torch.models.gcn3d import PoolLayer
    from pose_estimation_tpu_torch.models.hrnet import DEFAULT_STAGES, HRNet
    from pose_estimation_tpu_torch.models.krrn import KRRN
    from pose_estimation_tpu_torch.ops import gcn

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or schema.Config()
    m = cfg.module
    bs, n = 32, cfg.data.num_points
    dtype = torch.bfloat16
    want = lambda tag: not args.only or tag in args.only.split(",")
    timed = _timer(dev, args.reps)
    times = {}

    def record(name, fn):
        times[name] = ms = timed(fn)
        print(f"{name:44s} {ms:10.4f} ms", flush=True)

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={name} bs={bs} n={n} reps={args.reps}", flush=True)
    ds = SyntheticPoseDataset(num_objects=min(4, m.num_cls),
                              frames_per_object=8,
                              num_regions=cfg.data.num_regions)
    batch = make_batch(ds, [i % len(ds) for i in range(bs)],
                       torch.Generator().manual_seed(0), cfg.data.input_size,
                       n)
    batch = {k: v.to(dev) for k, v in batch.items()}
    torch.manual_seed(0)
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *shape, dt=torch.float32: torch.randn(
        shape, generator=g, device=dev).to(dt)

    if want("model"):
        model = KRRN(cfg, dtype=dtype).to(dev).eval()
        fwd = lambda opt: model(batch["img"], batch["cloud"], batch["choose"],
                                batch["cls"], opt_pose=opt)
        record("KRRN full forward (opt_pose)", lambda: fwd(True)["pred_t"])
        record("KRRN forward no-fusion (opt_pose=False)",
               lambda: fwd(False)["xyz_emb"])
        del model
    if want("hrnet"):
        hr = HRNet(3, m.backbone_outc, m.hrnet_stages or DEFAULT_STAGES,
                   m.stem_width, m.norm, dtype).to(dev).eval()
        img = batch["img"].permute(0, 3, 1, 2)
        record("HRNet backbone", lambda: hr(img.to(dtype))[0])
    verts = batch["cloud"].float().contiguous()
    if want("fusion"):
        fus = FusionNetLite(m.gcn3d.neighbor_num, m.gcn3d.support_num,
                            m.norm, dtype).to(dev).eval()
        xyz_emb, nml_emb = r(bs, n, 3), r(bs, n, 3)
        record("FusionNetLite", lambda: fus(verts, xyz_emb, nml_emb))

    if want("ops"):
        s, so, n1 = 7, 128 * 7, min(256, n)
        record(f"knn_indices N={n} k=10", lambda: po.knn_indices(verts, 10))
        idx = po.knn_indices(verts, 10)
        feats = r(bs, n, so, dt=dtype)
        dirs = r(3, so)
        nd = po.neighbor_directions(verts, idx)
        record(f"gcn_aggregate N={n} C={so}",
               lambda: gcn.aggregate(nd, dirs, feats, idx, s))
        src = verts[:, :n1].contiguous()
        record(f"nearest_index {n}<-{n1}", lambda: po.nearest_index(verts, src))
        nds3 = [nd, nd * 0.5, nd * 0.25]
        dirs3 = [r(3, so) for _ in range(3)]
        xs3 = [r(bs, n, 128, dt=dtype) for _ in range(3)]
        ws3 = [r(128, so, dt=dtype) * 0.1 for _ in range(3)]
        bs3 = [r(so, dt=dtype) * 0.1 for _ in range(3)]
        record("linear_multi fused kernel lvl0",
               lambda: gcn.linear_multi(nds3, dirs3, xs3, ws3, bs3, idx, s))
        record("linear_multi plain lvl0",
               lambda: gcn.linear_multi_plain(nds3, dirs3, xs3, ws3, bs3, idx,
                                              s))
        record("surface_multi fused kernel",
               lambda: gcn.surface_multi(nds3, dirs3, s))
        record("gcn_aggregate theta-only (ConvSurface)",
               lambda: gcn.aggregate(nd, dirs, None, idx, s))
        pool = PoolLayer(4, 4)
        f128 = r(bs, n, 128, dt=dtype)
        record(f"PoolLayer N={n} rate=4", lambda: pool(verts, f128))
        verts1 = verts[:, :n1].contiguous()
        idx1 = po.knn_indices(verts1, 10)
        nd1 = po.neighbor_directions(verts1, idx1)
        feats1 = r(bs, n1, so, dt=dtype)
        record(f"gcn_aggregate N={n1} (level1)",
               lambda: gcn.aggregate(nd1, dirs, feats1, idx1, s))

    if want("pnp"):
        pw = r(bs, 256, 3) * 0.05
        uv = torch.rand((bs, 256, 2), generator=g, device=dev) * 100
        kmat = batch["k"][:1].expand(bs, 3, 3)
        record(f"pnp_ransac b={bs} h=32",
               lambda: pnp_ransac(pw, uv, kmat, generator=g,
                                  num_hypotheses=32, inlier_px=2.0)["t"])
    print(json.dumps({"device": name, "batch_size": bs, "ms": times}))
    return times


if __name__ == "__main__":
    main()

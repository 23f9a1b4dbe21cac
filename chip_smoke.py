#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

  python3 chip_smoke.py

Phases (each raises on failure, the script then exits non-zero):
  1. require CUDA; print the card and its power limit (nvidia-smi);
  2. build the port's CUDA kernels from csrc/ (ops/_build.py);
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes (bs=32) in fp32 and bf16: max |error| and the
     median times of both (CUDA events);
  4. the pose stage fed ground-truth normalised coordinates of a synthetic
     batch: mean rotation error < 1 deg and ADD@0.1d >= 0.9;
  5. the shipped schema.Config() KRRN (full HRNet, 13 classes, 1024
     points, bf16 activations, seeded random weights) served through
     serve.build_infer_step on a synthetic bs=32 batch: finite outputs,
     launches per forward exactly 2 (linear aggregate), 1 (surface
     aggregate), 8 (KNN), the kernel path against the plain path on the
     same weights and batch, stage times and frames/s;
  6. the serving CLI (tools/infer.py) on 64 synthetic frames at batch 32,
     which must write 64 JSONL records;
and checks that nothing of JAX or of the JAX package was imported.
The last two lines are the kernels' JSON summary ... and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BS = 32

# (name, source, TPU kernel it replaces)
KERNELS = {
    "linear_multi": ("pose_estimation_tpu_torch/csrc/gcn.cu",
                     "pose_estimation_tpu/ops/pallas_gcn.py:209"),
    "surface_multi": ("pose_estimation_tpu_torch/csrc/gcn.cu",
                      "pose_estimation_tpu/ops/pallas_gcn.py:469"),
    "knn": ("pose_estimation_tpu_torch/csrc/knn.cu",
            "pose_estimation_tpu/ops/pallas_pointops.py:121"),
}


def log(msg):
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of fn() on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def plain_kernels():
    """Route the serving path through the kernels' plain PyTorch versions
    for a reference run on the card (this script's comparison only; the
    package itself has no such switch)."""
    from pose_estimation_tpu_torch.ops import gcn, pointops
    saved = (gcn.linear_multi, gcn.surface_multi, pointops.knn)
    gcn.linear_multi = gcn.linear_multi_plain
    gcn.surface_multi = gcn.surface_multi_plain
    pointops.knn = pointops.knn_plain
    try:
        yield
    finally:
        gcn.linear_multi, gcn.surface_multi, pointops.knn = saved


def reset_counts():
    from pose_estimation_tpu_torch.ops import gcn, pointops
    gcn.linear_multi.launches = 0
    gcn.surface_multi.launches = 0
    pointops.knn.launches = 0


def read_counts():
    from pose_estimation_tpu_torch.ops import gcn, pointops
    return {"linear_multi": gcn.linear_multi.launches,
            "surface_multi": gcn.surface_multi.launches,
            "knn": pointops.knn.launches}


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _cloud(g, b, n, dev):
    import torch
    pts = torch.randn((b, n, 3), generator=g, device=dev) * 0.04
    return (pts + torch.tensor([0.0, 0.0, 0.8], device=dev)).contiguous()


def check_knn(dev, g):
    """Self: N=1024 k=10, N=256 k=10, N=64 k=8; cross (exclude self):
    256 vs 1024 and 64 vs 256 queries/keys with k=4. Compared: the fp64
    squared distances of the chosen neighbours at each rank, relative
    1e-5 (exact index equality is not required: a last-bit difference may
    reorder a near-tie)."""
    import torch
    from pose_estimation_tpu_torch.ops import pointops
    cases = [("self", 1024, 1024, 10), ("self", 256, 256, 10),
             ("self", 64, 64, 8), ("cross", 256, 1024, 4),
             ("cross", 64, 256, 4)]
    worst, ms, plain_ms, same = 0.0, 0.0, 0.0, []
    for kind, nq, nk, k in cases:
        keys = _cloud(g, BS, nk, dev)
        q = keys if kind == "self" else keys[:, ::nk // nq].contiguous()
        got = pointops.knn(q, keys, k, True)
        ref = pointops.knn_plain(q, keys, k, True)

        def d64(idx):
            kk = torch.gather(keys.double(), 1, idx.long().reshape(BS, -1, 1)
                              .expand(-1, -1, 3)).reshape(BS, nq, k, 3)
            return ((kk - q.double()[:, :, None]) ** 2).sum(-1)

        dg, dr = d64(got), d64(ref)
        rel = ((dg - dr).abs() / dr.abs().clamp(min=1e-12)).max().item()
        worst = max(worst, rel)
        same.append((got == ref).float().mean().item())
        t_k = cuda_ms(lambda: pointops.knn(q, keys, k, True))
        t_p = cuda_ms(lambda: pointops.knn_plain(q, keys, k, True), reps=5)
        n_calls = 4 if kind == "cross" and nk == 1024 else 1
        ms += t_k * n_calls
        plain_ms += t_p * n_calls
        log(f"  knn {kind} q={nq} keys={nk} k={k}: max rel dist err "
            f"{rel:.2e}, index agreement {same[-1]:.6f}, kernel {t_k:.4f} ms,"
            f" plain {t_p:.4f} ms")
        if not rel <= 1e-5:
            raise AssertionError(f"knn {kind} {nq}x{nk}: distance error {rel}")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "tolerance": "relative 1e-5 on fp64 neighbour distances"}


def _gcn_inputs(g, dev, n, m, k, streams=3, cin=128, s=7, o=128):
    import torch
    from pose_estimation_tpu_torch.core.mathsafe import safe_normalize
    from pose_estimation_tpu_torch.ops import pointops
    pts = _cloud(g, BS, n, dev)
    idx = pointops.knn(pts, pts, k, True)
    nds, dirs, xs, ws, bs = [], [], [], [], []
    for _ in range(streams):
        nds.append(safe_normalize(torch.randn((BS, n, k, 3), generator=g,
                                              device=dev)))
        dirs.append(safe_normalize(torch.randn((3, s * o), generator=g,
                                               device=dev), dim=0))
        xs.append(torch.relu(torch.randn((BS, m, cin), generator=g,
                                         device=dev)))
        ws.append(torch.randn((cin, s * o), generator=g, device=dev) * 0.05)
        bs.append(torch.randn((s * o,), generator=g, device=dev) * 0.05)
    return nds, dirs, xs, ws, bs, idx, s


def check_surface(dev, g):
    """Level 0: B=32, N=1024, K=10, 3 streams, S=7, O=128. Outputs are
    rounded to bf16 by definition, so the tolerance is one bf16 ulp of the
    largest output: a last-bit difference in an fp32 dot may flip one
    rounding."""
    import torch
    from pose_estimation_tpu_torch.ops import gcn
    nds, dirs, _, _, _, _, s = _gcn_inputs(g, dev, 1024, 1024, 10)
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        a = [t.to(dt) for t in nds]
        d = [t.to(dt) for t in dirs]
        got = torch.cat(gcn.surface_multi(a, d, s), -1)
        ref = torch.cat(gcn.surface_multi_plain(a, d, s), -1)
        err = (got - ref).abs().max().item()
        tol = ref.abs().max().item() * 2.0 ** -8
        log(f"  surface_multi {dt}: max |err| {err:.3e} (tol {tol:.3e}), "
            f"max |ref| {ref.abs().max().item():.3f}")
        if not err <= tol:
            raise AssertionError(f"surface_multi {dt}: {err} > {tol}")
        worst = max(worst, err)
    a = [t.to(torch.bfloat16) for t in nds]
    d = [t.to(torch.bfloat16) for t in dirs]
    ms = cuda_ms(lambda: gcn.surface_multi(a, d, s))
    plain_ms = cuda_ms(lambda: gcn.surface_multi_plain(a, d, s), reps=5)
    log(f"  surface_multi bf16 level 0: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "tolerance": "one bf16 ulp of max|ref|"}


def check_linear(dev, g):
    """Level 0 (N=M=1024) and level 1 (N=M=256): B=32, K=10, 3 streams,
    Cin=128, S=7, O=128. fp32: 1e-4 * max(1, max|ref|) (the support
    table's sums run in another order than cuBLAS's). bf16: 2e-2 *
    max(1, max|ref|) (the bf16 support table may round an entry the other
    way, 2^-8 relative, and the max over k can then switch neighbour)."""
    import torch
    from pose_estimation_tpu_torch.ops import gcn
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for n in (1024, 256):
        nds, dirs, xs, ws, bs, idx, s = _gcn_inputs(g, dev, n, n, 10)
        for dt, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x = [t.to(dt) for t in xs]
            got = torch.cat(gcn.linear_multi(nds, dirs, x, ws, bs, idx, s), -1)
            ref = torch.cat(gcn.linear_multi_plain(nds, dirs, x, ws, bs, idx,
                                                   s), -1)
            err = (got - ref).abs().max().item()
            tol = rtol * max(1.0, ref.abs().max().item())
            log(f"  linear_multi N={n} {dt}: max |err| {err:.3e} "
                f"(tol {tol:.3e}), max |ref| {ref.abs().max().item():.3f}")
            if not err <= tol:
                raise AssertionError(f"linear_multi N={n} {dt}: {err} > {tol}")
            worst = max(worst, err)
        x = [t.to(torch.bfloat16) for t in xs]
        t_k = cuda_ms(lambda: gcn.linear_multi(nds, dirs, x, ws, bs, idx, s))
        t_p = cuda_ms(lambda: gcn.linear_multi_plain(nds, dirs, x, ws, bs,
                                                     idx, s), reps=5)
        log(f"  linear_multi bf16 N={n}: kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms")
        ms += t_k
        plain_ms += t_p
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "tolerance": "fp32 1e-4, bf16 2e-2, times max(1, max|ref|)"}


# ---------------------------------------------------------------------------
# Phases 4-6
# ---------------------------------------------------------------------------

def synthetic_batch(cfg, dev, seed=0):
    import torch
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    from pose_estimation_tpu_torch.data.batching import make_batch
    ds = SyntheticPoseDataset(num_objects=cfg.module.num_cls,
                              frames_per_object=4,
                              num_regions=cfg.data.num_regions)
    gen = torch.Generator().manual_seed(seed)
    batch = make_batch(ds, list(range(BS)), gen, cfg.data.input_size,
                       cfg.data.num_points)
    return {k: v.to(dev) for k, v in batch.items()}


def check_solver_on_gt(cfg, batch, dev):
    import torch
    from pose_estimation_tpu_torch.metrics.metric import pose_accuracy
    from pose_estimation_tpu_torch.serve import build_infer_step
    step = build_infer_step(None, cfg)
    b, s = batch["xyz"].shape[:2]
    xyz_gt = torch.gather(batch["xyz"].reshape(b, s * s, 3), 1,
                          batch["choose"].long()[..., None].expand(-1, -1, 3))
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    out = step.solve(xyz_gt, batch["target_t"], batch, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc = pose_accuracy(out["pred_r"], out["pnp_t"], batch["target_r"],
                        batch["target_t"], batch["model_points"],
                        batch["sym_mask"], batch["diameter"])
    rot = acc["rot_deg"].mean().item()
    add = acc["add_ok"].mean().item()
    log(f"  gt coordinates -> PnP: mean rot err {rot:.4f} deg, "
        f"ADD@0.1d {add:.3f}, solve {wall * 1e3:.1f} ms (first call)")
    if not (rot < 1.0 and add >= 0.9):
        raise AssertionError(f"solver on gt: rot {rot} deg, ADD {add}")


def serve_full_width(cfg, batch, dev):
    import torch
    from pose_estimation_tpu_torch.models.krrn import KRRN
    from pose_estimation_tpu_torch.serve import build_infer_step
    torch.manual_seed(0)
    model = KRRN(cfg, dtype=torch.bfloat16).to(dev).eval()
    step = build_infer_step(model, cfg)
    gen = torch.Generator(device=dev)

    gen.manual_seed(1)
    out = step(batch, generator=gen)                     # warm-up
    torch.cuda.synchronize()

    # the main path, once, between resetting and reading the counts
    reset_counts()
    gen.manual_seed(1)
    xyz_emb, pred_t = step.forward(batch)
    out = step.solve(xyz_emb, pred_t, batch, generator=gen)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  launches in one serving step: {counts}")
    if counts != {"linear_multi": 2, "surface_multi": 1, "knn": 8}:
        raise AssertionError(f"launch counts {counts} != 2/1/8")
    for k, v in out.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f"non-finite {k}")
    log(f"  outputs finite; median inliers "
        f"{out['num_inliers'].float().median().item():.0f} of "
        f"{cfg.eval.num_pnp_points}")

    with plain_kernels():
        xyz_p, t_p = step.forward(batch)
    e_xyz = (xyz_emb.float() - xyz_p.float()).abs().max().item()
    e_t = (pred_t.float() - t_p.float()).abs().max().item()
    # xyz_emb runs no kernel of the port: only cuDNN's run-to-run
    # differences are allowed. pred_t goes through all three in bf16.
    tol_xyz = 1e-3 * max(1.0, xyz_p.abs().max().item())
    tol_t = 2e-2 * max(1.0, t_p.abs().max().item())
    log(f"  kernel path vs plain path (same weights, batch): xyz_emb max "
        f"|err| {e_xyz:.3e} (tol {tol_xyz:.3e}), pred_t max |err| "
        f"{e_t:.3e} m (tol {tol_t:.3e})")
    if not (e_xyz <= tol_xyz and e_t <= tol_t):
        raise AssertionError(f"kernel vs plain path: {e_xyz}, {e_t}")

    def timed(fn, iters=10):
        ts = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return ts[len(ts) // 2] * 1e3

    fwd_ms = timed(lambda: step.forward(batch))
    solve_ms = timed(lambda: step.solve(xyz_emb, pred_t, batch,
                                        generator=gen))
    e2e_ms = timed(lambda: step(batch, generator=gen))
    with plain_kernels():
        fwd_plain_ms = timed(lambda: step.forward(batch), iters=5)
    log(f"  stage times (median, bs={BS}): forward {fwd_ms:.2f} ms "
        f"(plain kernels {fwd_plain_ms:.2f} ms), pose {solve_ms:.2f} ms, "
        f"end to end {e2e_ms:.2f} ms = {BS / e2e_ms * 1e3:.1f} frames/s")
    return counts


def run_cli(cfg):
    from pose_estimation_tpu_torch.tools import infer
    out_dir = ROOT / "build" / "smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "poses.jsonl"
    summary = infer.main(["--synthetic", "--frames_per_object", "5",
                          "--num_frames", "64", "--batch_size", str(BS),
                          "--output", str(path)], cfg=cfg)
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    log(f"  tools/infer.py: {len(records)} records, {summary}")
    if len(records) != 64:
        raise AssertionError(f"{len(records)} JSONL records, expected 64")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "pose_estimation_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_line()

    log(f"[1] device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    from pose_estimation_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
        f"(hash {_build.source_hash()})")
    name, spill = "?", ""
    for line in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            log(f"    ptxas {name}: {line.split(':', 1)[1].strip()}; {spill}")

    log("[3] kernels vs plain versions (bs=32, serving-path shapes)")
    g = torch.Generator(device=dev).manual_seed(0)
    results = {"linear_multi": check_linear(dev, g),
               "surface_multi": check_surface(dev, g),
               "knn": check_knn(dev, g)}

    from pose_estimation_tpu_torch.configs import schema
    cfg = schema.Config()
    log("[4] pose stage on ground-truth coordinates (synthetic bs=32)")
    batch = synthetic_batch(cfg, dev)
    check_solver_on_gt(cfg, batch, dev)

    log("[5] full-width KRRN (schema.Config(), bf16) through "
        "serve.build_infer_step")
    counts = serve_full_width(cfg, batch, dev)

    log("[6] serving CLI, 64 synthetic frames at batch 32")
    run_cli(cfg)

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "optax",
                                           "pose_estimation_tpu"))
    if loaded:
        raise AssertionError(f"the JAX side was imported: {loaded[:5]}")

    kernels = []
    for name, (src, tpu) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

  python3 chip_smoke.py

Phases (each raises on failure, the script then exits non-zero):
  1. require CUDA; print the card and its power limit (nvidia-smi);
  2. build the port's CUDA kernels from csrc/ (ops/_build.py); ptxas's
     registers and spills, and the HGMMA (tensor-core) instructions per
     kernel in the library's SASS (cuobjdump): kernel 1's bf16 table pass
     must have some; kernel 5's packed bf16 instructions;
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes (bs=32) in fp32 and bf16, kernel 1 also at the
     full FusionNet's level-1 shapes, the surface aggregate bit for bit,
     the nearest-source kernel at the train step's (bs=8: the pose loss,
     and the two up-sampling maps in one call), at the serving path's
     merged call (bs=32) and at 8192 x 8192 points with its backward,
     distances and indices bit for bit, the wide-table aggregate at the
     profiler's shape and at the full FusionNet's fm_4 (S=2) bit for bit
     with its backward; kernels 1 and 5 also with an infinite table row,
     a NaN nd entry and a NaN direction column (the plain version's NaN
     positions): max |error|, the median times of both (CUDA events), the
     least time the card could take (bound) and, where one PyTorch call
     computes the same function, its time; KNN's indices must equal the
     plain version's; then the device time of each CUDA kernel of kernels
     1-5 at these shapes (torch.profiler) beside the wrappers' event
     times; the bilinear resize kernel at the heads' 64 -> 128 and a fuse
     layer's 16 -> 32 (bf16, 256 frames) bit for bit against
     F.interpolate, its wrapper's and its own device time, the bound,
     F.interpolate's time and ATen's grid and block; the Ranger kernel
     at the TRPESNet and PSPNet leaf sets (a clipped sync step and a
     plain one) against the leaf path on the card, its device time by
     kernel against its byte bound, the leaf path's time, the launches
     of each a step;
  4. the pose stage fed ground-truth normalised coordinates of a synthetic
     batch: mean rotation error < 1 deg and ADD@0.1d >= 0.9;
  5. the shipped schema.Config() KRRN (full HRNet, 13 classes, 1024
     points, bf16 activations, seeded random weights) served through
     serve.build_infer_step on a synthetic bs=32 batch: finite outputs,
     launches per forward exactly 2 (linear aggregate), 1 (surface
     aggregate), 8 (KNN), 1 (nearest source: the two up-sampling maps in
     one call), 0 (wide-table aggregate), 36 (bilinear resize: phases
     7, 9 and 10 hold it too; elsewhere it is printed), the kernel path
     against the plain path on the same weights and batch, stage times
     and frames/s;
  6. the serving CLI (tools/infer.py) on 64 synthetic frames at batch 32,
     which must write 64 JSONL records;
  7. training at full width (schema.Config(), bf16 activations, bs=8,
     seeded random weights, synthetic frames): one step's loss and
     gradient norm with the kernels against the plain versions from the
     same state and batch; launches per train step exactly 2 (linear),
     1 (surface), 8 (KNN), 2 (nearest source: the pose loss, and the two
     up-sampling maps in one call); 30 steps on one fixed batch at lr 3e-4
     without warmup: finite losses, no skipped step, the mean of the last
     5 losses below the first; the median step time, its forward / backward /
     optimizer split, samples/s, the peak device memory, the full step
     with the plain versions, and the device's busy time over 3 profiled
     steps;
  8. the training CLI (cli.py --synthetic --debug --epochs 1) with a config
     that starts the pose branch at epoch 0: JSONL train records and an
     eval summary with add_dis;
  9. phase 5 with the full FusionNet (fusion_variant="full", S=7):
     launches per forward exactly 3 (linear), 1, 8, 1, 0;
 10. the full-fusion model at S=2, full widths otherwise, where its first
     fuse layer is wide: one serving forward (launches 3/1/8/1/1, against
     the plain path) and one train step at bs=8 (launches 3/1/8/2/1; loss
     and gradient norm against the plain versions);
 11. tools/profile_eval in full: every component prints a time;
 12. the LineMOD path at full width: a fake BOP tree (2 objects, 24
     frames each in train_pbr and test, 480x640, depth_scale 0.5) written
     with OpenCV as the JAX package's writer writes it, the host's ms per
     frame for dataset[i] + frame_to_sample, the training CLI on it (--dataset
     linemod --cls_type all, one debug epoch, the shipped config with the
     pose branch from epoch 0, bs=8: 5 steps and one eval pass), whose
     launches must be exactly 5 x the train step's + 6 x an eval
     forward's (phase 7's, plus the ADD(-S) metric's nearest-source
     call), its frames/s; the CLI's --eval_mode on the test split (6 eval
     forwards); tools/infer.py --ckpt from that run's checkpoint (32
     records) and tools/eval_standalone.py (2 batches of train_pbr, as
     the JAX tool reads it);
 13. the training options off in the shipped config: schema.Config() with
     module.norm="bn", train.refine and Adam (bf16, bs=8, synthetic
     frames, the pose branch on): one step with the kernels against the
     plain versions from the same weights, running statistics, Adam state
     and draws (loss, loss_refine and gradient norm at phase 7's
     tolerance, the moved statistics within 2e-2); launches per step
     exactly 2, 1, 8, 3 (the refine loss's ADD(-S) adds a nearest-source
     call), 0; 20 steps on one batch (finite, none skipped, the last 5
     losses' mean below the first, every running statistic finite and
     moved); the step time, its split, the refine term's own time and
     the device's busy time over 3 profiled steps;
     the trained model served at bs=32 on its running statistics
     (launches 2/1/8/1/0, against the plain path, which must leave the
     statistics as they were); the training CLI with the options and
     --enable_rot (one debug epoch of 26 synthetic frames: 3 train steps
     and 4 eval forwards, launches held) and tools/infer.py --ckpt
     --enable_rot from its checkpoint (32 records); KRRN(enable_rot=True)
     on the trained weights: pred_r finite and orthonormal within 4 bf16
     ulps;
 14. multi-GPU training as far as one card holds it (schema.Config()
     with the pose branch from epoch 0): (a) the trainer (3 steps at
     bs=8, one eval of 9 frames) in a 1-process NCCL group against no
     group, step for step (bit for bit where two runs without a group
     are; the card's backward accumulates with atomics, so otherwise the
     first step's loss terms bit for bit, its gradient norm within 1e-3,
     the parameters within 1e-5), launches 2/1/8/2/0 a
     step, 6 all-reduces a step; the step's time with and without the
     group and the gradient all-reduce's own; (b) two processes sharing
     the card (gloo on CUDA tensors; which collectives gloo takes on
     them is probed and printed) at bs=4 against one process at bs=8
     from the same weights and generator seed: the first step's loss
     terms, gradient norm, updated parameters and running statistics
     within 2e-2 x max(1, |ref|) for the GroupNorm config (bf16) and for
     BatchNorm with the refine loss in bf16 and in fp32 (BatchNorm's
     gradient norm, and in bf16 loss_refine, printed, not held:
     MGPU_UNHELD), both ranks bit
     for bit equal, launches and all-reduces a step (6, plus 2 for each
     BatchNorm); the sharded eval of the 9 frames (shards of 5 and 4)
     merged, every frame counted once; (c) ring_min_dists and ring_knn
     over those two ranks against kernel 4 and KNN on the whole cloud;
 15. the transparent pipeline at schema.transparent_cleargrasp() (TRPESNet
     on the UNet at 64-128-256-512-512, 256-px crops, 1000 points, 500
     model points, 5 objects, bf16, bs=8, seeded weights, synthetic
     frames): (a) kernel 4 at the confidence ADD(-S) loss's shape (B=8,
     500,000 predicted points against 500) and at ICP's (256 against
     500, eps = 0, a coincident pair at distance 0): distances and
     indices bit for bit, the loss shape's backward at phase 3's
     tolerance, the times, the bound and torch.cdist + min's time;
     (b) one step's loss terms and gradient norm with the kernel
     against the plain versions from the same state, batch and pixels
     (2e-2 x max(1, |ref|)), launches a step exactly 0/0/0/1/0; (c) 30
     steps on one batch at lr 3e-4 without warmup (finite, none
     skipped, the last 5 losses' mean below the first), the step time,
     its split, samples/s, the peak memory, the device's busy time over
     3 profiled steps; (d) the eval step at bs 8 with ICP off and on
     (launches 1 and 13: ADD-S, 10 ICP iterations, the two trimmed
     residuals in one call, the refined ADD-S), the kernel path against
     the plain path (add_dis, add_dis_icp at 1e-5, the accept flags
     equal), frames/s; (e) the training CLI on the ClearGrasp fixture
     (tests/golden/cleargrasp's two frames copied to 8 a split, the
     shipped config: one step and one eval batch) and
     tools/eval_transparent.py --ckpt from its checkpoint on the val
     split, launches held; (f) the transparent trainer in a 1-process
     NCCL group against no group, 2 steps: the first step's loss terms
     bit for bit;
 16. the PSPNet generation, schema.transparent_cleargrasp() with
     module.transparent_model="posenet" (TransparentPoseNet: the dilated
     ResNet18, the PSP pyramid, the three-branch decoder, the mask and
     boundary head, 256-px crops, 1000 points, 500 model points, 5
     objects, bf16, bs=8, seeded weights, synthetic frames): (a) one
     step's loss terms (loss_b among them, positive) and gradient norm
     with the kernel against the plain versions from the same state,
     batch, pixels and dropout masks (2e-2 x max(1, |ref|)), launches a
     step exactly 0/0/0/1/0; (b) 30 steps on one batch at lr 3e-4
     without warmup, held as 15(c), the step time, its split, samples/s,
     the peak memory and the device's busy time over 3 profiled steps;
     (c) the eval step at bs 8 with ICP off and on, held as 15(d),
     launches 1 and 13, frames/s; (d) one step each of
     TRPESNet(use_transformer=True), TRPESNet(use_equalized=True) and
     TransparentPoseNet(use_transformer=True) at full width (attention
     over 1000 points at 8, 4 and 2 heads), kernel against plain as (a),
     launches 0/0/0/1/0, the step time; (e) the training CLI with a
     --config setting transparent_model="posenet" on the ClearGrasp
     fixture (one step, one eval batch) and tools/eval_transparent.py
     --ckpt from its checkpoint, launches held;
 17. the tools on the card (outputs under build/smoke/tools, deleted at
     the end): (a) phase 8's run directory: the tb/train and tb/eval
     event files parsed with the port's reader (every CRC checked), each
     float of the JSONL records under its tag and step, the overlay
     image in the eval stream and viz/epoch_0000.png decoded with OpenCV
     to its shape; (b) tools/parity_check.py on the card and the CPU (16
     scenes x 128 points, the RANSAC subsets and Umeyama hypotheses
     drawn once on the CPU): the rotation round trips within 1e-5, each
     cross-backend median delta within PARITY_TOL; (c)
     tools/refine_declarative.py at its defaults on the card against
     the port's CPU run within 1e-4 x max(1, |CPU's|), the translation
     error falling,
     launches 0/0/0/12/0 (10 ICP iterations, 2 ADD(-S)); (d)
     tools/train_synthetic_convergence.py --variants raw_xyz,flagship
     (2 epochs of 64 frames at bs 16, the full-width flagship being the
     unmodified schema.Config()), launches exactly the steps x phase 7's
     train step + the eval batches x an eval forward, each variant's
     samples/s and per-object table; --eval_from_ckpt on raw_xyz
     reproducing its table within 1e-4; tools/eval_solver_sweep.py on
     raw_xyz's checkpoint (4 x 8 eval forwards); (e)
     tools/train_transparent_convergence.py --refine (2 epochs of 32
     frames): launches 1 a train step and 13 an eval batch with ICP;
and checks that nothing of JAX or of the JAX package was imported.
The last lines are the kernels' JSON summary, the card's name and power
limit, and {"ok": true, "device": {...}}.

  python3 chip_smoke.py --split-from DIR

builds the package under DIR (an earlier commit unpacked there) and prints
only phase 3's kernel split for it, so that two versions of the kernels
can be compared on one card.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

from portbench import roofline
from portbench.roofline import nbytes

ROOT = Path(__file__).resolve().parent
BS = 32
TRAIN_BS = 8

# (name, source, TPU kernel it replaces)
KERNELS = {
    "linear_multi": ("pose_estimation_tpu_torch/csrc/gcn.cu",
                     "pose_estimation_tpu/ops/pallas_gcn.py:209"),
    "surface_multi": ("pose_estimation_tpu_torch/csrc/gcn.cu",
                      "pose_estimation_tpu/ops/pallas_gcn.py:469"),
    "knn": ("pose_estimation_tpu_torch/csrc/knn.cu",
            "pose_estimation_tpu/ops/pallas_pointops.py:121"),
    "min_dists": ("pose_estimation_tpu_torch/csrc/min_dists.cu",
                  "pose_estimation_tpu/ops/pallas_pointops.py:45"),
    "aggregate": ("pose_estimation_tpu_torch/csrc/gcn.cu",
                  "pose_estimation_tpu/ops/pallas_gcn.py:588"),
    "resize_bilinear": ("pose_estimation_tpu_torch/csrc/resize.cu",
                        "none: jax.image.resize, XLA"),
    "ranger_apply": ("pose_estimation_tpu_torch/csrc/ranger.cu",
                     "none: optax's chain, XLA"),
}

# launches per serving forward / train step on each path
LITE_SERVE = {"linear_multi": 2, "surface_multi": 1, "knn": 8,
              "min_dists": 1, "aggregate": 0}
LITE_TRAIN = dict(LITE_SERVE, min_dists=2)
FULL_SERVE = dict(LITE_SERVE, linear_multi=3)
FULL_S2_SERVE = dict(FULL_SERVE, aggregate=1)
FULL_S2_TRAIN = dict(FULL_S2_SERVE, min_dists=2)
# resizes a forward of the shipped HRNet and heads: 1 + 12 + 18 in the fuse
# layers, 3 for the concat, 2 in the heads (their backward launches none);
# held where the path runs the shipped HRNet, printed elsewhere
SHIPPED_RESIZES = {"resize_bilinear": 36}

def bound(n_bytes, ops):
    """(bound_ms, bound_by): the benchmark's least time for the work
    (portbench/roofline.py: the H100's peaks; `ops` maps a PEAK_OPS_S key
    to a count) in milliseconds, and whether the bytes or the operations
    set it."""
    least_s = roofline.bound(n_bytes, ops)
    return (least_s * 1e3, "bytes" if n_bytes / roofline.HBM_BYTES_S
            >= least_s else "operations")


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
    from pose_estimation_tpu_torch.ops import gcn, pointops, resize
    saved = (gcn.linear_multi, gcn.surface_multi, gcn.aggregate,
             pointops.knn, pointops.nearest_multi, resize.resize_bilinear)
    gcn.linear_multi = gcn.linear_multi_plain
    gcn.surface_multi = gcn.surface_multi_plain
    gcn.aggregate = gcn.aggregate_plain
    pointops.knn = pointops.knn_plain
    pointops.nearest_multi = pointops.nearest_multi_plain
    resize.resize_bilinear = resize.resize_bilinear_plain
    try:
        yield
    finally:
        (gcn.linear_multi, gcn.surface_multi, gcn.aggregate, pointops.knn,
         pointops.nearest_multi, resize.resize_bilinear) = saved


def reset_counts():
    from pose_estimation_tpu_torch.ops import gcn, optim, pointops, resize
    optim.ranger_apply.launches = 0
    gcn.linear_multi.launches = 0
    gcn.surface_multi.launches = 0
    gcn.aggregate.launches = 0
    pointops.knn.launches = 0
    pointops.nearest_multi.launches = 0
    resize.resize_bilinear.launches = 0


def read_counts():
    from pose_estimation_tpu_torch.ops import gcn, optim, pointops, resize
    return {"linear_multi": gcn.linear_multi.launches,
            "surface_multi": gcn.surface_multi.launches,
            "knn": pointops.knn.launches,
            "min_dists": pointops.nearest_multi.launches,
            "aggregate": gcn.aggregate.launches,
            "resize_bilinear": resize.resize_bilinear.launches,
            "ranger_apply": optim.ranger_apply.launches}


def launches_match(counts, want):
    """Each op that `want` names launched as often as it says; an op it
    leaves out (the resize, on a path whose HRNet is not the shipped one)
    is printed, not held."""
    return all(counts.get(k) == v for k, v in want.items())


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _cloud(g, b, n, dev):
    import torch
    pts = torch.randn((b, n, 3), generator=g, device=dev) * 0.04
    return (pts + torch.tensor([0.0, 0.0, 0.8], device=dev)).contiguous()


# the serving forward's searches: (kind, queries, keys, k, calls per
# forward); the cross searches exclude their first column as well
KNN_CASES = (("self", 1024, 1024, 10, 1), ("cross", 256, 1024, 4, 4),
             ("self", 256, 256, 10, 1), ("cross", 64, 256, 4, 1),
             ("self", 64, 64, 8, 1))
# KNN at its limits in the split (no forward's shapes): the largest search
# at kk = 11 (the forward's), 17 (the most before kk was widened), 24 and
# 32, on a cloud and on points whose ties overflow every candidate list
KNN_LIMIT_K = (10, 16, 23, 31)


def check_knn(dev, g):
    """Self: N=1024 k=10, N=256 k=10, N=64 k=8; cross (exclude self):
    256 vs 1024 and 64 vs 256 queries/keys with k=4. The indices must equal
    the plain version's (the kernel's distances are bit-exact and its
    merge keeps the stable sort's tie rule); the fp64 squared distances of
    the chosen neighbours at each rank are checked as well, relative
    1e-5."""
    import torch
    from pose_estimation_tpu_torch.ops import pointops
    worst, ms, plain_ms, lib_ms, same = 0.0, 0.0, 0.0, 0.0, []
    n_bytes, n_ops = 0, 0
    for kind, nq, nk, k, n_calls in KNN_CASES:
        keys = _cloud(g, BS, nk, dev)
        q = keys if kind == "self" else keys[:, ::nk // nq].contiguous()
        got = pointops.knn(q, keys, k, True)
        kk = k + 1
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
        # the library yardstick: one cdist and one topk
        t_l = cuda_ms(lambda: torch.topk(torch.cdist(q, keys), kk, dim=-1,
                                         largest=False))
        ms += t_k * n_calls
        plain_ms += t_p * n_calls
        lib_ms += t_l * n_calls
        # per pair: dot (5), the norms' sum and -2 dot (3), one compare
        n_bytes += n_calls * (nbytes(keys) + (0 if kind == "self" else
                                              nbytes(q)) + nbytes(got))
        n_ops += n_calls * BS * nq * nk * 9
        log(f"  knn {kind} q={nq} keys={nk} k={k}: max rel dist err "
            f"{rel:.2e}, index agreement {same[-1]:.6f}, kernel {t_k:.4f} ms,"
            f" plain {t_p:.4f} ms, cdist+topk {t_l:.4f} ms")
        if not (rel <= 1e-5 and torch.equal(got, ref)):
            raise AssertionError(f"knn {kind} {nq}x{nk}: distance error "
                                 f"{rel}, index agreement {same[-1]}")
    b_ms, b_by = bound(n_bytes, {"fp32": n_ops})
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "tolerance": "indices equal; relative 1e-5 on fp64 neighbour "
                         "distances"}


def check_min_dists(dev, g):
    """The nearest-source kernel at a train step's two calls (B=8: the pose
    loss's 1024 predicted points against 500 model points; the two
    up-sampling maps, 1024 points against 256 and 64, in one call), at the
    serving path's merged call (B=32) and at N=M=8192, where the TPU
    wrapper would take its Pallas kernel: distances and indices equal to
    the plain version's (the same operation order, so bit for bit). The
    backward at the pose-loss shape against autograd through the plain
    expression: 1e-3 * max(1, max|ref|) (the two forms round the
    cancelling expanded distance differently). The entry's times are the
    train step's two calls; the serving call's go under "serving_maps"."""
    import torch
    from pose_estimation_tpu_torch.ops import pointops
    worst, ms, plain_ms, lib_ms, n_bytes, n_ops = 0.0, 0.0, 0.0, 0.0, 0, 0
    serving = None
    for label, b, n, sizes in (("train, pose loss", TRAIN_BS, 1024, (500,)),
                               ("train, up-sampling maps", TRAIN_BS, 1024,
                                (256, 64)),
                               ("serving, up-sampling maps", BS, 1024,
                                (256, 64)),
                               ("8192^2", TRAIN_BS, 8192, (8192,))):
        t = _cloud(g, b, n, dev)
        srcs = [_cloud(g, b, m, dev) for m in sizes]
        got = pointops.nearest_multi(t, srcs)
        ref = pointops.nearest_multi_plain(t, srcs)
        err = max((d - dp).abs().max().item()
                  for (d, _), (dp, _) in zip(got, ref))
        same = min((i == ip).float().mean().item()
                   for (_, i), (_, ip) in zip(got, ref))
        t_k = cuda_ms(lambda: pointops.nearest_multi(t, srcs))
        t_p = cuda_ms(lambda: pointops.nearest_multi_plain(t, srcs), reps=5)
        # per pair: dot (5), the norms' sum and -2 dot (3), one compare
        c_bytes = nbytes(t, *srcs) + len(srcs) * b * n * 8
        c_ops = b * n * sum(sizes) * 9
        b_ms, b_by = bound(c_bytes, {"fp32": c_ops})
        log(f"  min_dists {label}, B={b} {n}x{sizes}: max |err| {err:.3e}, "
            f"index agreement {same:.6f}, kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        if not (err == 0.0 and same == 1.0):
            raise AssertionError(f"min_dists {label}: {err}, {same}")
        if n == 8192:
            continue
        t_l = cuda_ms(lambda: [torch.cdist(t, s).min(dim=-1) for s in srcs])
        log(f"    cdist + min, one per cloud: {t_l:.4f} ms")
        if label.startswith("serving"):
            serving = {"ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": t_l}
            continue
        ms += t_k
        plain_ms += t_p
        lib_ms += t_l
        n_bytes += c_bytes
        n_ops += c_ops
    b = TRAIN_BS
    t = _cloud(g, b, 1024, dev).requires_grad_()
    s = _cloud(g, b, 500, dev).requires_grad_()
    w = torch.rand((b, 1024), generator=g, device=dev)
    gt, gs = torch.autograd.grad((pointops.min_dists(t, s) * w).sum(),
                                 (t, s))
    d2 = pointops.sqdist(t, s).min(dim=-1).values
    plain = torch.sqrt(torch.clamp(d2, min=1e-16))
    rt, rs = torch.autograd.grad((plain * w).sum(), (t, s))
    for name, got, ref in (("target", gt, rt), ("source", gs, rs)):
        err = (got - ref).abs().max().item()
        tol = 1e-3 * max(1.0, ref.abs().max().item())
        log(f"  min_dists backward, {name} gradient: max |err| {err:.3e} "
            f"(tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"min_dists backward {name}: {err} > {tol}")
        worst = max(worst, err)
    b_ms, b_by = bound(n_bytes, {"fp32": n_ops})
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "serving_maps": serving,
            "tolerance": "forward exact; backward 1e-3 * max(1, max|ref|)"}


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
    """Level 0: B=32, N=1024, K=10, 3 streams, S=7, O=128, nd and dirs in
    fp32 and in bf16: bit for bit (the kernel keeps the plain version's
    dot order without FMA, and takes relu and the bf16 rounding after the
    max over k, which gives the same bits)."""
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
        equal = (got == ref).float().mean().item()
        log(f"  surface_multi {dt}: max |err| {err:.3e}, bit-equal share "
            f"{equal:.6f}, max |ref| {ref.abs().max().item():.3f}")
        if not torch.equal(got, ref):
            raise AssertionError(f"surface_multi {dt}: {err}, {equal}")
        worst = max(worst, err)
    a = [t.to(torch.bfloat16) for t in nds]
    d = [t.to(torch.bfloat16) for t in dirs]
    ms = cuda_ms(lambda: gcn.surface_multi(a, d, s))
    plain_ms = cuda_ms(lambda: gcn.surface_multi_plain(a, d, s), reps=5)
    b, n, k, _ = a[0].shape
    so = d[0].shape[-1]
    # per (point, slot, stream, support, channel): dot (5), relu, max
    b_ms, b_by = bound(nbytes(*a, *d) + b * n * len(a) * (so // s) * 4,
                       {"fp32": b * n * k * len(a) * so * 7
                        + b * n * len(a) * (so // s) * (s - 1)})
    log(f"  surface_multi bf16 level 0: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "tolerance": "bit for bit"}


def check_linear(dev, g):
    """Level 0 (N=M=1024) and level 1 (N=M=256): B=32, K=10, 3 streams,
    Cin=128, S=7, O=128. fp32: 1e-4 * max(1, max|ref|) (the support
    table's sums run in another order than cuBLAS's). bf16: 2e-2 *
    max(1, max|ref|) (the bf16 support table may round an entry the other
    way, 2^-8 relative, and the max over k can then switch neighbour)."""
    import torch
    from pose_estimation_tpu_torch.ops import gcn
    worst, ms, plain_ms, n_bytes, ops = 0.0, 0.0, 0.0, 0, {}
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
        n_bytes += linear_bytes(nds, dirs, x, ws, bs, idx, s)
        for kind, v in linear_ops(nds, x, ws, idx, s).items():
            ops[kind] = ops.get(kind, 0) + v
    worst = max(worst, check_linear_full(dev, g))
    check_linear_nan(dev, g)
    b_ms, b_by = bound(n_bytes, ops)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "tolerance": "fp32 1e-4, bf16 2e-2, times max(1, max|ref|)"}


def _pick(g, dev, vals, shape):
    import torch
    v = torch.tensor(vals, device=dev)
    return v[torch.randint(0, len(vals), shape, generator=g, device=dev)]


def check_linear_nan(dev, g):
    """Kernel 1 at level 0 (B=32, N=M=1024, K=10, 3 streams, Cin=128, S=7,
    O=128) on inputs with few significant bits, where theta, the table and
    the products are exact whatever the order, so the kernel equals the
    plain version bit for bit; then with an inf in an input row (its table
    row +-inf, NaN where W is 0; NaN where theta is 0), a NaN nd entry and
    a NaN direction column: the plain version's NaN positions
    (assert_close with rtol = atol = 0 and equal_nan)."""
    import torch
    from pose_estimation_tpu_torch.ops import gcn, pointops
    s, o, n, k, cin = 7, 128, 1024, 10, 128
    pts = _cloud(g, BS, n, dev)
    idx = pointops.knn(pts, pts, k, True)
    nds = [_pick(g, dev, [0.0, 1.0, -1.0, 0.5, -0.5, 0.25], (BS, n, k, 3))
           for _ in range(3)]
    dirs = [_pick(g, dev, [0.0, 1.0, -0.5, 0.5, -0.25], (3, s * o))
            for _ in range(3)]
    xs = [_pick(g, dev, [0.0, 1.0, -1.0, 2.0, 0.5], (BS, n, cin))
          for _ in range(3)]
    ws = [_pick(g, dev, [0.0, 0.25, -0.5, 0.5, 1.0], (cin, s * o))
          for _ in range(3)]
    bs = [_pick(g, dev, [0.0, 0.125, -0.125], (s * o,)) for _ in range(3)]
    for poisoned in (False, True):
        if poisoned:
            xs[0][0, idx[0, 100, 2], 7] = float("inf")
            nds[1][1, 200, 4, 1] = float("nan")
            dirs[2][0, 2 * o + 9] = float("nan")
        for dt in (torch.float32, torch.bfloat16):
            x = [t.to(dt) for t in xs]
            got = gcn.linear_multi(nds, dirs, x, ws, bs, idx, s)
            ref = gcn.linear_multi_plain(nds, dirs, x, ws, bs, idx, s)
            nan = sum(r.isnan().sum().item() for r in ref)
            log(f"  linear_multi level 0 {dt}, exact inputs"
                f"{', poisoned' if poisoned else ''}: {nan} NaN outputs in "
                f"the plain version")
            if poisoned and not nan:
                raise AssertionError("linear_multi: no NaN to compare")
            for a, r in zip(got, ref):
                torch.testing.assert_close(a, r, rtol=0, atol=0,
                                           equal_nan=True)


def linear_bytes(nds, dirs, xs, ws, bs, idx, s):
    """Inputs read once, the fp32 output [B, N, streams*O] written once."""
    b, n, _ = idx.shape
    return (nbytes(*nds, *dirs, *xs, *ws, *bs, idx)
            + b * n * len(nds) * (ws[0].shape[-1] // s) * 4)


def linear_ops(nds, xs, ws, idx, s):
    """The support table once per point (a bf16 product: tensor cores),
    then per (point, slot, stream, support, channel) dot (5), relu,
    product and max, and the support sums."""
    b, n, k = idx.shape
    m, cin = xs[0].shape[1:]
    so, st = ws[0].shape[-1], len(nds)
    return {"bf16_tensor": 2 * b * m * cin * so * st,
            "fp32": b * n * k * st * so * 8 + b * n * st * (so // s) * (s - 1)
            + b * m * st * so}


def check_linear_full(dev, g):
    """Kernel 1 at the full FusionNet's new level-1 shapes (B=32, N=M=256,
    K=10, S=7, O=256): the streams' conv2 (Cin 128) and the extra
    ConvLayers (Cin 256); fp32 and bf16 at check_linear's tolerances,
    with the peak device memory of the plain comparison."""
    import torch
    from pose_estimation_tpu_torch.ops import gcn
    worst = 0.0
    for cin in (128, 256):
        nds, dirs, xs, ws, bs, idx, s = _gcn_inputs(g, dev, 256, 256, 10,
                                                    cin=cin, o=256)
        for dt, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x = [t.to(dt) for t in xs]
            got = torch.cat(gcn.linear_multi(nds, dirs, x, ws, bs, idx, s), -1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ref = torch.cat(gcn.linear_multi_plain(nds, dirs, x, ws, bs, idx,
                                                   s), -1)
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            err = (got - ref).abs().max().item()
            tol = rtol * max(1.0, ref.abs().max().item())
            log(f"  linear_multi full FusionNet level 1, Cin {cin} -> O 256 "
                f"{dt}: max |err| {err:.3e} (tol {tol:.3e}); plain version "
                f"peak {peak:.2f} GiB above its inputs")
            if not err <= tol:
                raise AssertionError(f"linear_multi Cin {cin} {dt}: {err}")
            worst = max(worst, err)
        x = [t.to(torch.bfloat16) for t in xs]
        t_k = cuda_ms(lambda: gcn.linear_multi(nds, dirs, x, ws, bs, idx, s))
        t_p = cuda_ms(lambda: gcn.linear_multi_plain(nds, dirs, x, ws, bs,
                                                     idx, s), reps=5)
        b_ms, b_by = bound(linear_bytes(nds, dirs, x, ws, bs, idx, s),
                           linear_ops(nds, x, ws, idx, s))
        log(f"  linear_multi bf16 Cin {cin} -> O 256: kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return worst


def _agg_inputs(g, dev, b, n, k, d, s, o):
    """Kernel 5's inputs as the wide ConvLayer passes them: nd and dirs in
    fp32, and X @ W + b ([B, M, (S+1)*O], the first O columns the layer's
    centre term), of which the table is a column slice (`_table`)."""
    import torch
    from pose_estimation_tpu_torch.core.mathsafe import safe_normalize
    from pose_estimation_tpu_torch.ops import pointops
    pts = _cloud(g, b, n, dev)
    idx = pointops.knn(pts, pts, k, True)
    nd = safe_normalize(torch.randn((b, n, k, d), generator=g, device=dev))
    dirs = safe_normalize(torch.randn((d, s * o), generator=g, device=dev),
                          dim=0)
    wide = torch.randn((b, n, (s + 1) * o), generator=g, device=dev)
    return nd, dirs, wide, idx


def _table(wide, o, dt, name="fm_4"):
    """The table in dtype dt: at fm_4 a view, as the wide ConvLayer passes
    it; at the profiler's shape its own tensor, as profile_eval's."""
    f = wide.to(dt)[..., o:]
    return f.contiguous() if name == "profiler" else f


# kernel 5's shapes: the full FusionNet's fm_4 at S=2 (its first fuse
# layer), and the component profiler's (tools/profile_eval.py)
AGG_SHAPES = (("profiler", (1024, 10, 3, 7, 128)),
              ("fm_4", (64, 8, 9, 2, 256)))


def aggregate_bound(nd, dirs, feats, idx, s):
    """Inputs read once, the fp32 output written once; per (point, slot,
    support, channel) a D-term dot (2D - 1), relu, product and max, then
    the support sums: packed bf16x2 operations for a bf16 table, fp32
    otherwise."""
    import torch
    b, n, k, d = nd.shape
    so = dirs.shape[-1]
    kind = "bf16_packed" if feats.dtype == torch.bfloat16 else "fp32"
    return bound(nbytes(nd, dirs, feats, idx) + b * n * (so // s) * 4,
                 {kind: b * n * k * so * (2 * d + 2)
                  + b * n * (so // s) * (s - 1)})


def check_aggregate(dev, g):
    """Kernel 5 against aggregate_plain at the profiler's shape (B=32,
    N=M=1024, K=10, D=3, S=7, O=128) and at the full FusionNet's fm_4 at
    S=2 (B=32, N=M=64, K=8, D=9, S*O=512), fp32 and bf16 tables: bit for
    bit (torch.equal); then with an inf table row, -inf in part of
    another, a NaN nd entry and a NaN direction column: the plain
    version's NaN positions (rtol = atol = 0, equal_nan). The backward at
    fm_4's shape in fp32 against autograd through the plain version:
    1e-3 * max(1, max|ref|). The entry's times and bound are fm_4's with a
    bf16 table (the main path's)."""
    import torch
    from pose_estimation_tpu_torch.ops import gcn
    worst, res = 0.0, {}
    for name, (n, k, d, s, o) in AGG_SHAPES:
        nd, dirs, wide, idx = _agg_inputs(g, dev, BS, n, k, d, s, o)
        for dt in (torch.float32, torch.bfloat16):
            f = _table(wide, o, dt, name)
            got = gcn.aggregate(nd, dirs, f, idx, s)
            ref = gcn.aggregate_plain(nd, dirs, f, idx, s)
            err = (got - ref).abs().max().item()
            log(f"  aggregate {name} {dt}: max |err| {err:.3e}, bit-equal "
                f"share {(got == ref).float().mean().item():.6f}, max |ref| "
                f"{ref.abs().max().item():.3f}")
            if not torch.equal(got, ref):
                raise AssertionError(f"aggregate {name} {dt}: {err}")
            bad = f.clone()
            bad[0, idx[0, 7, 2]] = float("inf")
            bad[-1, idx[-1, 9, 0], ::3] = -float("inf")
            nd_bad, dirs_bad = nd.clone(), dirs.clone()
            nd_bad[1, 5, 1, d - 1] = float("nan")
            dirs_bad[1, o + 3] = float("nan")
            got = gcn.aggregate(nd_bad, dirs_bad, bad, idx, s)
            ref = gcn.aggregate_plain(nd_bad, dirs_bad, bad, idx, s)
            log(f"  aggregate {name} {dt}, poisoned: "
                f"{ref.isnan().sum().item()} NaN and "
                f"{ref.isinf().sum().item()} infinite outputs in the plain "
                f"version")
            if not ref.isnan().any():
                raise AssertionError(f"aggregate {name}: no NaN to compare")
            torch.testing.assert_close(got, ref, rtol=0, atol=0,
                                       equal_nan=True)
        f = _table(wide, o, torch.bfloat16, name)
        t_k = cuda_ms(lambda: gcn.aggregate(nd, dirs, f, idx, s))
        t_p = cuda_ms(lambda: gcn.aggregate_plain(nd, dirs, f, idx, s),
                      reps=5)
        b_ms, b_by = aggregate_bound(nd, dirs, f, idx, s)
        log(f"  aggregate {name} bf16: kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        res[name] = {"ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
                     "bound_by": b_by}
    zero = gcn.aggregate(torch.ones((1, 4, 1, 3), device=dev),
                         torch.full((3, 8), -0.0, device=dev),
                         torch.ones((1, 4, 8), device=dev,
                                    dtype=torch.bfloat16),
                         torch.zeros((1, 4, 1), dtype=torch.int32,
                                     device=dev), 1)
    log(f"  aggregate: relu of theta = -0 gives "
        f"{'-0' if zero.signbit().all() else '+0'} (torch.relu: -0)")
    feats = _table(wide, o, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (nd, dirs, feats)]
    twins = [t.clone().requires_grad_() for t in (nd, dirs, feats)]
    cot = torch.randn(leaves[0].shape[:2] + (o,), generator=g, device=dev)
    gcn.aggregate(*leaves, idx, s).backward(cot)
    gcn.aggregate_plain(*twins, idx, s).backward(cot)
    for what, a, r in zip(("nd", "dirs", "feats"), leaves, twins):
        err = (a.grad - r.grad).abs().max().item()
        tol = 1e-3 * max(1.0, r.grad.abs().max().item())
        log(f"  aggregate backward fm_4 fp32, {what} gradient: "
            f"max |err| {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"aggregate backward {what}: {err} > {tol}")
        worst = max(worst, err)
    return dict(res["fm_4"], max_abs_err=worst, library_ms=None,
                profiler_shape=res["profiler"],
                tolerance="forward bit for bit (NaN positions equal); "
                          "backward 1e-3 * max(1, max|ref|)")


# (label, input shape, output side) of the resize check: the heads'
# upsample2x and a fuse layer's 16 -> 32, at 256 frames
RESIZE_SHAPES = (("heads 64 -> 128", (256, 128, 64, 64), 128),
                 ("fuse 16 -> 32", (256, 96, 16, 16), 32))


def check_resize(dev, g, reps=10):
    """The bilinear resize kernel at RESIZE_SHAPES in bf16: bit for bit
    against its plain version (F.interpolate), the wrapper's time and its
    own kernel's device time (torch.profiler), the plain version's, the
    bound (bytes) and F.interpolate's time as the library's (the plain
    version is that call); ATen's grid and block from the profiler's
    trace. Returns the sums over the shapes and each shape's row."""
    import tempfile
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from pose_estimation_tpu_torch.ops import resize
    rows = {}
    for label, shape, side in RESIZE_SHAPES:
        x = (torch.randn(shape, generator=g, device=dev) * 3).bfloat16()
        got = resize.resize_bilinear(x, side, side)
        ref = resize.resize_bilinear_plain(x, side, side)
        if not torch.equal(got, ref):
            raise AssertionError(f"resize {label}: not bit for bit, max |err| "
                                 f"{(got.float() - ref.float()).abs().max()}")
        library = lambda: F.interpolate(x, size=(side, side), mode="bilinear",
                                        align_corners=False)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                resize.resize_bilinear(x, side, side)
            library()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            prof.export_chrome_trace(f"{tmp}/trace.json")
            events = json.loads(Path(f"{tmp}/trace.json").read_text())
        kernels = [e for e in events["traceEvents"]
                   if e.get("cat") == "kernel"]
        own = [e["dur"] for e in kernels if "resize_kernel" in e["name"]]
        aten = [e for e in kernels if "upsample_bilinear2d" in e["name"]]
        if len(own) != reps or len(aten) != 1:
            raise AssertionError(f"resize {label}: {len(own)} kernel events "
                                 f"of {reps}, {len(aten)} of ATen's")
        b_ms, b_by = bound(nbytes(x, got), {})
        row = {"ms": cuda_ms(lambda: resize.resize_bilinear(x, side, side)),
               "device_ms": sorted(own)[reps // 2] / 1e3,
               "plain_ms": cuda_ms(lambda: resize.resize_bilinear_plain(
                   x, side, side), reps=5),
               "library_ms": cuda_ms(library, reps=5),
               "bound_ms": b_ms, "bound_by": b_by,
               "aten_grid": aten[0]["args"].get("grid"),
               "aten_block": aten[0]["args"].get("block")}
        log(f"  resize {label} {tuple(shape)} bf16: bit for bit; kernel "
            f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, F.interpolate {row['library_ms']:.4f}"
            f" ms (grid {row['aten_grid']}, block {row['aten_block']}), "
            f"bound {b_ms:.4f} ms ({b_ms / row['device_ms']:.1%} of it on "
            f"the device)")
        rows[label] = row
    total = {k: sum(r[k] for r in rows.values())
             for k in ("ms", "device_ms", "plain_ms", "library_ms",
                       "bound_ms")}
    return dict(total, max_abs_err=0.0, bound_by="bytes", shapes=rows,
                tolerance="bit for bit")


RANGER_MODELS = ("trpesnet", "pspnet")
RANGER_TOL = 1e-6
RANGER_KERNELS = ("rg_reduce", "rg_finish", "rg_update")


def ranger_leaves(which):
    """{name: shape} of the parameters of the transparent model `which`
    (TRPESNet or the PSPNet generation) at schema.transparent_cleargrasp()."""
    import torch
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        build_model)
    cfg = schema.transparent_cleargrasp()
    if which == "pspnet":
        cfg = schema.override(cfg, **{"module.transparent_model": "posenet"})
    return {k: tuple(p.shape)
            for k, p in build_model(cfg, device="meta").named_parameters()}


def _ranger_gaps(got, ref):
    """The largest |got - ref| of each state (parameters, mu, nu, slow)
    over every leaf, as a share of the state's largest |ref| in the model;
    the worst (share, state, leaf)."""
    worst = (0.0, "", "")
    for s, a, b in zip(("params", "mu", "nu", "slow"), got, ref):
        top = max(float(v.abs().max()) for v in b.values())
        for k in b:
            worst = max(worst, (float((a[k] - b[k]).abs().max()) / top, s, k))
    return worst


def ranger_leaf_path(tx, params, grads, state, loss):
    """The train step's leaf path on the same tensors (what
    Optimizer.apply runs through TrainState.apply_gradients): the guard,
    Ranger.update and the add; state replaced in place; (gnorm,
    finite)."""
    from pose_estimation_tpu_torch.train.optim import nan_guard
    grads, gnorm, finite = nan_guard(grads, loss)
    updates, new = tx.update(grads, state, params)
    for k, p in params.items():
        p.add_(updates[k])
    state.update(new)
    return gnorm, finite


def check_ranger(dev, g, reps=20):
    """The Ranger kernel (ops/optim.py:ranger_apply) at the transparent
    models' leaf sets, the convolutions' gradients channels-last as cuDNN
    gives them: a clipped Lookahead sync step and a plain step against the
    train step's leaf path on the card (parameters, mu, nu and slow
    within RANGER_TOL of their largest magnitude in the model, the norm
    within RANGER_TOL; the reductions' order is the only departure); the
    wrapper's time and its kernels' device time (torch.profiler), the leaf
    path's time, the launches of each in a step, and the bound (bytes:
    the gradient read twice, the parameter and both moments read and
    written, the slow weight too on a sync step, over 3.35 TB/s). Returns
    TRPESNet's row with every model's under "shapes"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pose_estimation_tpu_torch.ops import optim as ops_optim
    from pose_estimation_tpu_torch.train.optim import Ranger
    rows = {}
    for which in RANGER_MODELS:
        shapes = ranger_leaves(which)
        n = sum(math.prod(s) for s in shapes.values())
        params = {k: torch.randn(s, generator=g, device=dev) * 0.05
                  for k, s in shapes.items()}
        tx = Ranger(lambda c: 3e-4, grad_clip=10.0)
        state = tx.init(params)
        state["count"] = 5
        twin = ({k: v.clone() for k, v in params.items()},
                {"count": 5, **{s: {k: v.clone() for k, v in state[s].items()}
                                for s in ("mu", "nu", "slow")}})
        loss = torch.tensor(1.0, device=dev)
        worst = (0.0, "", "")
        for norm in (30.0, 3.0):            # clipped sync; plain
            grads = {k: torch.randn(s, generator=g, device=dev).contiguous(
                memory_format=torch.channels_last if len(s) == 4
                else torch.contiguous_format) for k, s in shapes.items()}
            total = float(torch.sqrt(sum((x.double() ** 2).sum()
                                         for x in grads.values())))
            for x in grads.values():
                x.mul_(norm / total)
            args = tx.step_args(state["count"])
            got = ops_optim.ranger_apply(params, grads, state, loss, **args)
            ref = ranger_leaf_path(tx, twin[0], grads, twin[1], loss)
            gn, ref_gn = float(got[0]), float(ref[0])
            if (bool(got[1]) != bool(ref[1])
                    or abs(gn - ref_gn) > RANGER_TOL * ref_gn):
                raise AssertionError(f"ranger {which}: norm {gn}, finite "
                                     f"{bool(got[1])} against {ref_gn}, "
                                     f"{bool(ref[1])}")
            worst = max(worst, _ranger_gaps(
                (params, *(state[s] for s in ("mu", "nu", "slow"))),
                (twin[0], *(twin[1][s] for s in ("mu", "nu", "slow")))))
        if worst[0] > RANGER_TOL:
            raise AssertionError(f"ranger {which}: {worst[1]} of {worst[2]} "
                                 f"off by {worst[0]:.3g} of its largest")
        row = {"leaves": len(shapes), "elements": n, "max_rel_err": worst[0]}
        for sync in (False, True):
            args = tx.step_args(5 if sync else 6)
            step = lambda: ops_optim.ranger_apply(params, grads, state, loss,
                                                  **args)
            plain = lambda: ranger_leaf_path(
                tx, twin[0], grads, dict(twin[1], count=args["count"] - 1),
                loss)
            step()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    step()
                torch.cuda.synchronize()
            on_card = torch.autograd.DeviceType.CUDA
            device = [e for e in prof.events() if e.device_type == on_card]
            split = {k: sum(e.device_time for e in device if k in e.name)
                     / reps / 1e3 for k in RANGER_KERNELS}
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                plain()
                torch.cuda.synchronize()
            plain_launches = sum(e.device_type == on_card
                                 for e in prof.events())
            b_ms, _ = bound(n * (40 if sync else 32), {})
            tag = "sync" if sync else "step"
            row[tag] = {"ms": cuda_ms(step, reps=reps),
                        "device_ms": sum(split.values()), "split_ms": split,
                        "plain_ms": cuda_ms(plain, reps=5),
                        "bound_ms": b_ms, "launches": len(device) // reps,
                        "plain_launches": plain_launches}
            r = row[tag]
            log(f"  ranger {which} ({len(shapes)} leaves, {n} fp32, {tag}): "
                f"within {worst[0]:.2g}; kernel {r['ms']:.4f} ms (device "
                f"{r['device_ms']:.4f}: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in split.items())
                + f"), {r['launches']} launches; plain {r['plain_ms']:.4f} "
                f"ms, {plain_launches} launches; bound {b_ms:.4f} ms "
                f"({b_ms / r['device_ms']:.1%} of it on the device)")
        rows[which] = row
    top = rows[RANGER_MODELS[0]]["step"]
    return dict(ms=top["ms"], device_ms=top["device_ms"],
                plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by="bytes", library_ms=None,
                max_abs_err=max(r["max_rel_err"] for r in rows.values()),
                tolerance=f"{RANGER_TOL} of each state's largest magnitude",
                shapes=rows)


# ---------------------------------------------------------------------------
# Phases 4-6
# ---------------------------------------------------------------------------

def synthetic_batch(cfg, dev, seed=0, indices=None):
    import torch
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    from pose_estimation_tpu_torch.data.batching import make_batch
    ds = SyntheticPoseDataset(num_objects=cfg.module.num_cls,
                              frames_per_object=4,
                              num_regions=cfg.data.num_regions)
    gen = torch.Generator().manual_seed(seed)
    batch = make_batch(ds, list(range(BS)) if indices is None else indices,
                       gen, cfg.data.input_size, cfg.data.num_points)
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


def serve_full_width(cfg, batch, dev, variant="lite",
                     want=dict(LITE_SERVE, **SHIPPED_RESIZES),
                     timing=True, model=None):
    """The `variant` KRRN of `cfg` (bf16, seeded random weights), or
    `model`, through serve.build_infer_step: launch counts of one step
    against `want`, finite outputs, the kernel path against the plain
    path, and (with `timing`) the stage times."""
    import torch
    from pose_estimation_tpu_torch.models.krrn import KRRN
    from pose_estimation_tpu_torch.serve import build_infer_step
    if model is None:
        torch.manual_seed(0)
        model = KRRN(cfg, dtype=torch.bfloat16,
                     fusion_variant=variant).to(dev).eval()
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
    if not launches_match(counts, want):
        raise AssertionError(f"launch counts {counts} != {want}")
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
    if not timing:
        return counts

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


def _sync_ms(fn):
    """fn()'s result and its wall milliseconds, synchronised on both
    sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _train_setup(cfg, dev, variant="lite", batch=None):
    """The `variant` KRRN train step of `cfg` on one fixed batch of
    TRAIN_BS frames, one of each of the first classes (or `batch`), at the
    demo's learning rate without warmup: (state, step, batch)."""
    import torch
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.models.krrn import KRRN
    from pose_estimation_tpu_torch.train.optim import make_optimizer
    from pose_estimation_tpu_torch.train.state import TrainState
    from pose_estimation_tpu_torch.train.train_step import build_train_step
    cfg = schema.override(cfg, **{"train.lr.lr": 3e-4,
                                  "train.lr.warmup_iters": 0})
    if batch is None:
        batch = synthetic_batch(cfg, dev, seed=3,
                                indices=[4 * j for j in range(TRAIN_BS)])
    torch.manual_seed(0)
    dtype = torch.bfloat16 if cfg.train.amp else torch.float32
    model = KRRN(cfg, dtype=dtype, fusion_variant=variant).to(dev)
    tx = make_optimizer(cfg, total_steps=1000)
    state = TrainState.create(model, tx,
                              torch.Generator(device=dev).manual_seed(0))
    return state, build_train_step(model, tx, cfg), batch


def _step_vs_plain(state, step, batch):
    """One step's loss and gradient norm with the kernels against the
    plain versions, from the same state, batch and draws."""
    import torch

    def loss_and_gnorm():
        state.generator.manual_seed(1)
        losses = step.losses(batch, True, True, state.generator)
        grads = step.gradients(losses)
        gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
        return losses["loss"].item(), gn.item()

    loss_and_gnorm()                                     # warm-up
    (l_k, g_k), ms_k = _sync_ms(loss_and_gnorm)
    with plain_kernels():
        (l_p, g_p), ms_p = _sync_ms(loss_and_gnorm)
    log(f"  one step's forward + backward from the same state and batch: "
        f"loss {l_k:.6f} (plain {l_p:.6f}), gradient norm {g_k:.6f} (plain "
        f"{g_p:.6f}); {ms_k:.1f} ms with the kernels, {ms_p:.1f} ms plain")
    if not (abs(l_k - l_p) <= 2e-2 * max(1.0, abs(l_p))
            and abs(g_k - g_p) <= 2e-2 * g_p):
        raise AssertionError(f"train step kernel vs plain: loss {l_k} / "
                             f"{l_p}, grad norm {g_k} / {g_p}")


def _counted_step(state, step, batch, want):
    """The main path, once, between resetting and reading the counts."""
    import torch
    reset_counts()
    step(state, batch, opt_pose=True)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  launches in one train step: {counts}")
    if not launches_match(counts, want):
        raise AssertionError(f"launch counts {counts} != {want}")
    return counts


def train_full_width(cfg, dev):
    """Phase 7: the KRRN train step of `cfg` (the shipped config)."""
    import torch
    state, step, batch = _train_setup(cfg, dev)
    _step_vs_plain(state, step, batch)
    counts = _counted_step(state, step, batch,
                           dict(LITE_TRAIN, **SHIPPED_RESIZES))

    torch.cuda.reset_peak_memory_stats()
    losses, skipped, times, split = [], 0.0, [], []
    for i in range(30):
        if i < 25:
            m, t = _sync_ms(lambda: step(state, batch, opt_pose=True))
        else:
            out, t1 = _sync_ms(lambda: step.losses(batch, True, True,
                                                   state.generator))
            grads, t2 = _sync_ms(lambda: step.gradients(out))
            m, t3 = _sync_ms(lambda: step.apply(state, out, grads))
            parts, t = (t1, t2, t3), t1 + t2 + t3
            split.append(parts)
        times.append(t)
        losses.append(m["loss"].item())
        skipped += m["skipped_nonfinite"].item()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first, last5 = losses[0], sum(losses[-5:]) / 5
    log(f"  30 steps on one batch: loss {first:.4f} -> mean of the last 5 "
        f"{last5:.4f}; skipped {skipped:.0f}; losses "
        + " ".join(f"{x:.4f}" for x in losses))
    if not (all(x == x and abs(x) < float("inf") for x in losses)
            and skipped == 0 and last5 < first):
        raise AssertionError(f"training did not run clean: {losses}, "
                             f"skipped {skipped}")
    med = _median(times[:25])
    fwd, bwd, opt = (_median([p[j] for p in split]) for j in range(3))
    log(f"  train step (bs={TRAIN_BS}, bf16), median of 25: {med:.2f} ms = "
        f"{TRAIN_BS / med * 1e3:.2f} samples/s; split (median of 5, synced "
        f"between stages): forward + loss {fwd:.2f} ms, backward {bwd:.2f} "
        f"ms, guard + optimizer {opt:.2f} ms; peak memory {peak:.2f} GiB")
    plain_times, kern_times = [], []
    for _ in range(3):
        with plain_kernels():
            plain_times.append(_sync_ms(lambda: step(state, batch))[1])
        kern_times.append(_sync_ms(lambda: step(state, batch))[1])
    log(f"  full train step, kernels vs plain versions (alternating, median "
        f"of 3): {_median(kern_times):.2f} ms vs {_median(plain_times):.2f} "
        f"ms")
    profile_steps(lambda: step(state, batch), 3)
    return counts


def full_fusion_s2(cfg, batch, dev):
    """Phase 10: the full-fusion KRRN at S=2 (full widths otherwise),
    where its first fuse layer is wide: one serving forward and one train
    step (bs=8) with their launch counts, the forward against the plain
    path and the step's loss and gradient norm against the plain
    versions' from the same state, batch and draws."""
    from pose_estimation_tpu_torch.configs import schema
    cfg = schema.override(cfg, **{"module.gcn3d": schema.Gcn3dConfig(
        neighbor_num=cfg.module.gcn3d.neighbor_num, support_num=2)})
    serve_counts = serve_full_width(cfg, batch, dev, "full",
                                    dict(FULL_S2_SERVE, **SHIPPED_RESIZES),
                                    timing=False)
    state, step, train_batch = _train_setup(cfg, dev, "full")
    _step_vs_plain(state, step, train_batch)
    return serve_counts, _counted_step(
        state, step, train_batch, dict(FULL_S2_TRAIN, **SHIPPED_RESIZES))


PROFILE_COMPONENTS = 14


def run_profiler():
    """Phase 11: tools/profile_eval in full, in a process of its own; every
    component must print a time."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "pose_estimation_tpu_torch.tools.profile_eval"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"profile_eval failed:\n{out.stdout[-3000:]}\n"
                           f"{out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"  {line}")
    times = json.loads(lines[-1])["ms"]
    log(f"  {len(times)} components timed in "
        f"{time.perf_counter() - t0:.1f} s")
    if not (len(times) == PROFILE_COMPONENTS
            and all(0 < t < float("inf") for t in times.values())):
        raise AssertionError(f"profile_eval printed {times}")


def _kernel_name(mangled):
    """The kernel's own name from its mangled one, templates dropped."""
    m = re.match(r"_Z(\d+)", mangled)
    return mangled[m.end():m.end() + int(m.group(1))] if m else mangled


def ptxas_summary(build_log):
    """Registers (max over instantiations) and spill bytes per kernel."""
    per, name = {}, "?"
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            per.setdefault(name, [0, 0, 0])
            per[name][2] += 1
        elif "spill stores" in line:
            per[name][1] += int(re.search(r"(\d+) bytes spill stores",
                                          line).group(1))
        elif "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            per[name][0] = max(per[name][0], regs)
    return per


def sass_counts(opcodes):
    """Instructions per kernel in the built library's SASS (cuobjdump
    -sass) whose opcode starts with one of `opcodes`: {kernel: {opcode:
    n}}."""
    from pose_estimation_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    so = _build.BUILD_ROOT / _build.source_hash() / "libpose_kernels.so"
    out = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr[-2000:]}")
    per, name = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
            per.setdefault(name, {})
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name is not None and m and m.group(1).startswith(opcodes):
            op = m.group(1)
            per[name][op] = per[name].get(op, 0) + 1
    return per


OWN_KERNELS = ("table_kernel", "table_wgmma_kernel", "linear_agg_kernel",
               "knn_kernel", "surface_kernel", "min_dists_kernel",
               "agg_kernel", "wide_agg_kernel")


def kernel_split(dev, reps=10):
    """Device time of each CUDA kernel of kernels 1-5 at phase 3's shapes
    (bf16 for kernel 1; kernel 2 with bf16 and with fp32 nd and dirs;
    kernel 5 at fm_4 and the profiler's shape with fp32 nd and dirs and a
    bf16 table, fm_4's a column slice as the wide ConvLayer passes it),
    from torch.profiler's CUDA activity, beside the wrapper's CUDA-event
    time (which adds the wrapper's host cost where the host is slower than
    the card). Kernels that are not the port's own are the wrapper's
    PyTorch casts and copies ("other"). Kernel 4 at the serving path's two
    up-sampling maps (B=32, 1024 targets against 256 and 64 sources), one
    at a time and as a forward makes them (one merged call where the
    package has nearest_multi, else two calls), and at B=8, 8192 x 8192.
    Returns {case: {"wrapper_ms", "calls", kernel name: ms per call}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pose_estimation_tpu_torch.ops import gcn, pointops
    g = torch.Generator(device=dev).manual_seed(5)
    # (label, calls per forward (0: not a forward's shape), fn,
    #  ((kernel names, launches per fn), ...))
    cases = []
    for label, n, cin, o in (("level 0", 1024, 128, 128),
                             ("level 1", 256, 128, 128),
                             ("full level 1, Cin 128", 256, 128, 256),
                             ("full level 1, Cin 256", 256, 256, 256)):
        nds, dirs, xs, ws, bs, idx, s = _gcn_inputs(g, dev, n, n, 10,
                                                    cin=cin, o=o)
        x = [t.to(torch.bfloat16) for t in xs]
        cases.append((f"linear_multi {label}", 1,
                      lambda a=(nds, dirs, x, ws, bs, idx, s):
                      gcn.linear_multi(*a),
                      ((("table_wgmma_kernel", "table_kernel"), 1),
                       (("linear_agg_kernel",), 1))))
    nds, dirs, _, _, _, _, s = _gcn_inputs(g, dev, 1024, 1024, 10)
    for dt in (torch.bfloat16, torch.float32):
        a = [t.to(dt) for t in nds]
        d = [t.to(dt) for t in dirs]
        cases.append((f"surface_multi level 0, {str(dt)[6:]} nd and dirs",
                      1, lambda a=a, d=d: gcn.surface_multi(a, d, s),
                      ((("surface_kernel",), 1),)))
    for kind, nq, nk, k, calls in KNN_CASES:
        keys = _cloud(g, BS, nk, dev)
        q = keys if kind == "self" else keys[:, ::nk // nq].contiguous()
        cases.append((f"knn {kind} {nq}x{nk} k={k}", calls,
                      lambda a=(q, keys, k): pointops.knn(*a, True),
                      ((("knn_kernel",), 1),)))
    try:
        from pose_estimation_tpu_torch.ops.limits import KNN_MAX_KK
    except ImportError:     # a tree from before the limits module
        KNN_MAX_KK = 17
    spread = _cloud(g, BS, 1024, dev)
    dup = _cloud(g, BS, 4, dev).repeat_interleave(256, dim=1).contiguous()
    for k in KNN_LIMIT_K:
        for pts, what in ((spread, "a cloud"),
                          (dup, "4 points x256, every query rescans")):
            label = f"knn self 1024x1024 k={k}, {what}"
            if k + 1 > KNN_MAX_KK:
                log(f"  split {label}: kk = {k + 1} not taken by this tree")
                continue
            cases.append((label, 0,
                          lambda a=(pts, pts, k): pointops.knn(*a, True),
                          ((("knn_kernel",), 1),)))
    md = (("min_dists_kernel",), 1)
    t = _cloud(g, BS, 1024, dev)
    maps = [_cloud(g, BS, m, dev) for m in (256, 64)]
    for src in maps:
        cases.append((f"min_dists B={BS} 1024x{src.shape[1]}", 0,
                      lambda a=(t, src): pointops.nearest(*a), (md,)))
    if hasattr(pointops, "nearest_multi"):
        cases.append((f"min_dists B={BS} 1024x(256, 64), the up-sampling "
                      "maps in one call", 1,
                      lambda: pointops.nearest_multi(t, maps), (md,)))
    else:
        cases.append((f"min_dists B={BS} 1024x(256, 64), the up-sampling "
                      "maps in two calls", 1,
                      lambda: [pointops.nearest(t, m) for m in maps],
                      ((md[0], 2),)))
    big = [_cloud(g, TRAIN_BS, 8192, dev) for _ in range(2)]
    cases.append((f"min_dists B={TRAIN_BS} 8192x8192", 0,
                  lambda: pointops.nearest(*big), (md,)))
    for name, (n, k, d, s, o) in AGG_SHAPES:
        nd, dirs, wide, idx = _agg_inputs(g, dev, BS, n, k, d, s, o)
        f = _table(wide, o, torch.bfloat16, name)
        cases.append((f"aggregate {name}", int(name == "fm_4"),
                      lambda a=(nd, dirs, f, idx, s): gcn.aggregate(*a),
                      ((("wide_agg_kernel", "agg_kernel"), 1),)))
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    res = {}
    for label, calls, fn, own in cases:
        wrapper = cuda_ms(fn)
        # a window now and then comes back with events missing: take one in
        # which each kernel of the call (`own`: groups of names, the earlier
        # commits' included) shows up as often as the call launches it
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            row, seen = {"wrapper_ms": wrapper, "calls": calls}, {}
            for e in prof.key_averages():
                if not (str(e.device_type).endswith("CUDA")
                        and dev_us(e) > 0):
                    continue
                m = re.search(r"\b(\w+)(<|\()", e.key)
                name = (m.group(1) if m and m.group(1) in OWN_KERNELS
                        else "other")
                row[name] = row.get(name, 0.0) + dev_us(e) / 1e3 / reps
                seen[name] = seen.get(name, 0) + e.count
            if all(sum(seen.get(k, 0) for k in group) == reps * per_call
                   for group, per_call in own):
                break
        else:
            raise AssertionError(f"split {label}: events missing, {seen}")
        device = sum(v for k, v in row.items() if k in OWN_KERNELS)
        per = f" (x{calls} per forward)" if calls else ""
        log(f"  split {label}{per}: wrapper {wrapper:.4f} ms; device "
            + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                        if k not in ("wrapper_ms", "calls"))
            + f" ms; wrapper - own kernels {wrapper - device:.4f} ms")
        res[label] = row
    knn = [r for k, r in res.items() if k.startswith("knn")]
    dev_ms = sum(r["calls"] * r.get("knn_kernel", 0.0) for r in knn)
    wrap_ms = sum(r["calls"] * r["wrapper_ms"] for r in knn)
    log(f"  split: the 8 KNN searches of a forward, device {dev_ms:.4f} ms, "
        f"wrapper {wrap_ms:.4f} ms, host cost {(wrap_ms - dev_ms) / 8:.4f} "
        f"ms per call")
    maps = next(r for k, r in res.items() if "up-sampling" in k)
    log(f"  split: the up-sampling maps of a forward, device "
        f"{maps.get('min_dists_kernel', 0.0):.4f} ms, wrapper "
        f"{maps['wrapper_ms']:.4f} ms")
    return res


def profile_steps(fn, n):
    """Device busy time of n calls of fn under torch.profiler: the sum of
    the device's own kernel and copy time against the wall time of the
    window, and the five largest kernels. The profiler slows the host, so
    the idle share it shows is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        _, wall = _sync_ms(lambda: [fn() for _ in range(n)])
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # device-side rows only: a CPU op's own device time is the time of the
    # kernels it launches, which would count them twice
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in rows) / 1e3
    rows.sort(key=dev_us, reverse=True)
    top = "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3 / n:.2f} ms x"
                    f"{e.count // n}" for e in rows[:5])
    log(f"  profiled {n} train steps: wall {wall / n:.2f} ms/step, device "
        f"busy {busy / n:.2f} ms/step, idle share {1 - busy / wall:.3f}; "
        f"largest per step: {top}")


TRAIN_CONFIG = ("schema.override(schema.Config(dataset='synthetic'),\n"
                "                           **{'train.start_pose_epoch': 0})")


def _lines(path):
    return [json.loads(x) for x in Path(path).read_text().splitlines()]


def write_config(config_expr=TRAIN_CONFIG, name="train_config") -> Path:
    """build/smoke/<name>.py, whose get_config() returns `config_expr`."""
    out_dir = ROOT / "build" / "smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg_file = out_dir / f"{name}.py"
    cfg_file.write_text(
        "from pose_estimation_tpu_torch.configs import schema\n"
        "from pose_estimation_tpu_torch.configs.schema import (  # noqa\n"
        "    Gcn3dConfig, HeadConfig)\n\n\n"
        f"def get_config():\n    return {config_expr}\n")
    return cfg_file


def run_train_cli(config_expr=TRAIN_CONFIG):
    """Phase 8: the training CLI, one debug epoch with the pose branch, on
    the config `config_expr` builds (the shipped one, the pose branch from
    epoch 0)."""
    from pose_estimation_tpu_torch import cli
    run_dir = ROOT / "build" / "smoke" / "train_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg_file = write_config(config_expr)
    t0 = time.perf_counter()
    cli.main(["--config", str(cfg_file), "--synthetic", "--debug",
              "--epochs", "1", "--frames_per_object", "2",
              "--log_dir", str(run_dir)])
    wall = time.perf_counter() - t0
    train, evals = _lines(run_dir / "train.jsonl"), _lines(
        run_dir / "eval.jsonl")
    log(f"  cli.py: {len(train)} train record(s), first {train[0]}; eval "
        f"{evals[-1]}; {wall:.1f} s")
    if not (train and train[0]["loss_add"] > 0 and evals
            and "add_dis" in evals[-1]):
        raise AssertionError("training CLI wrote no train or eval records")


# phase 12: the shipped config (dataset="linemod") on both objects of the
# tree, the pose branch from epoch 0; the tree at classic LineMOD's frame
# size
LINEMOD_CONFIG = ("schema.override(schema.Config(cls_type='all'),\n"
                  "                           **{'train.start_pose_epoch': 0})")
BOP_TREE = dict(num_objects=2, frames_per_object=24,
                splits=("train_pbr", "test"), im_h=480, im_w=640)
DEBUG_STEPS = 5
# an eval forward: the serving forward plus the ADD(-S) metric's
# nearest-source call (metrics.metric.add_metric)
LITE_EVAL = dict(LITE_SERVE, min_dists=2)


def _check_counts(what, counts, times):
    """counts == the sum over `times` ({path: (n, launches a call)}) of n
    x launches a call."""
    want = {k: sum(n * c[k] for n, c in times.values()) for k in LITE_SERVE}
    formula = " + ".join(f"{n} {p} x {c}" for p, (n, c) in times.items())
    log(f"  launches over {what}: {counts}; expected {formula} = {want}")
    if not launches_match(counts, want):
        raise AssertionError(f"{what}: launch counts {counts} != {want}")


def dataset_item_split_ms(ds, i, repeats=5):
    """Median ms of the two parts of a BOP reader's dataset[i]: OpenCV's
    decode of the frame's RGB and depth PNGs, and the label splat
    (render_frame) at the frame's gt pose."""
    import cv2

    from pose_estimation_tpu_torch.data.synthetic import render_frame
    sdir, im_id, oid, r, t, k, _ = ds.index[i]
    rgb_path = str(Path(sdir, "rgb", f"{im_id:06d}.png"))
    depth_path = str(Path(sdir, "depth", f"{im_id:06d}.png"))
    times = {"decode rgb": [], "decode depth": [], "splat": []}
    for _ in range(repeats):
        t0 = time.perf_counter()
        cv2.cvtColor(cv2.imread(rgb_path), cv2.COLOR_BGR2RGB)
        t1 = time.perf_counter()
        h, w = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED).shape
        t2 = time.perf_counter()
        render_frame(ds.objects[oid], r, t, k=k, im_h=h, im_w=w)
        t3 = time.perf_counter()
        for key, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
            times[key].append(dt * 1e3)
    return {key: _median(v) for key, v in times.items()}


def run_linemod_cli(config_expr=LINEMOD_CONFIG):
    """Phase 12: the real-data path at full width. A BOP tree of PNG
    files written with OpenCV (the readers decode them with OpenCV, as
    the JAX readers do), then the training CLI on it (--dataset linemod,
    one debug epoch, the shipped config with the pose branch from epoch
    0, bs=8), the CLI's eval mode on its test split, the serving CLI
    from the run's checkpoint and tools/eval_standalone.py. Returns the
    launch counts of the training CLI's run."""

    import torch
    from pose_estimation_tpu_torch import cli
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.data.batching import frame_to_sample
    from pose_estimation_tpu_torch.data.linemod import LinemodDataset
    from pose_estimation_tpu_torch.data.testing import write_fake_bop_tree
    from pose_estimation_tpu_torch.tools import eval_standalone, infer

    import cv2
    log(f"  OpenCV {cv2.__version__}")
    out_dir = ROOT / "build" / "smoke"
    root = out_dir / "bop"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_fake_bop_tree(str(root), **BOP_TREE)
    n_png = len(list(root.rglob("*.png")))
    log(f"  fake BOP tree {BOP_TREE}, depth_scale 0.5: {n_png} PNG files "
        f"in {time.perf_counter() - t0:.1f} s")

    cfg_file = write_config(config_expr, "linemod_config")
    cfg = cli.load_config(str(cfg_file))
    bs = cfg.train.batch_size
    ds = LinemodDataset(str(root), mode="train", cls_type="all", cfg=cfg)
    gen = torch.Generator().manual_seed(0)
    t_read = t_sample = 0.0
    n_host = 8
    for i in range(-1, n_host):             # frame -1: warm-up, not timed
        if i == 0:
            t_read = t_sample = 0.0
        t0 = time.perf_counter()
        frame = ds[i]
        t1 = time.perf_counter()
        frame_to_sample(frame, ds.objects_by_cls[frame["cls_id"]],
                        cfg.data.input_size, cfg.data.num_points,
                        generator=gen)
        t_sample += time.perf_counter() - t1
        t_read += t1 - t0
    log(f"  host data prep, {frame['rgb'].shape[1]}x{frame['rgb'].shape[0]}"
        f" frames, mean of frames 0-{n_host - 1}: dataset[i] {t_read / n_host * 1e3:.2f}"
        f" ms + frame_to_sample {t_sample / n_host * 1e3:.2f} ms = "
        f"{(t_read + t_sample) / n_host * 1e3:.2f} ms per frame")
    split = dataset_item_split_ms(ds, 0)
    log("  dataset[0]'s parts, median of 5: " + ", ".join(
        f"{key} {ms:.2f} ms" for key, ms in split.items()))

    run_dir = out_dir / "linemod_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    args = ["--config", str(cfg_file), "--dataset", "linemod", "--cls_type",
            "all", "--dataset_root", str(root)]
    n_train = len(ds)
    steps = min(DEBUG_STEPS, n_train // bs)
    evals = -(-n_train // bs)
    reset_counts()
    t0 = time.perf_counter()
    cli.main(args + ["--debug", "--epochs", "1", "--log_dir", str(run_dir)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    _check_counts("the training CLI", counts,
                  {"train steps": (steps, LITE_TRAIN),
                   "eval forwards": (evals, LITE_EVAL)})
    train, ev = _lines(run_dir / "train.jsonl"), _lines(run_dir / "eval.jsonl")
    frames = steps * bs + n_train
    log(f"  cli.py --dataset linemod: {steps} steps on train_pbr, eval of "
        f"its {n_train} frames; {wall:.2f} s = {frames / wall:.2f} frames/s "
        f"(train and eval frames, host data prep and warm-up included); "
        f"train {train[0]}; eval {ev[-1]}")
    if not (train and all(math.isfinite(r["loss"]) for r in train)
            and train[0]["skipped_nonfinite"] == 0
            and math.isfinite(ev[-1]["add_dis"])
            and ev[-1]["count"] == n_train):
        raise AssertionError("training CLI on the LineMOD tree")

    n_test = len(LinemodDataset(str(root), mode="eval", cls_type="all",
                                cfg=cfg))
    reset_counts()
    t0 = time.perf_counter()
    cli.main(args + ["--eval_mode", "--log_dir", str(out_dir / "lm_eval")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_counts("cli.py --eval_mode", read_counts(),
                  {"eval forwards": (-(-n_test // bs), LITE_EVAL)})
    ev = _lines(out_dir / "lm_eval" / "eval.jsonl")[-1]
    log(f"  cli.py --eval_mode: {n_test} test frames in {wall:.2f} s = "
        f"{n_test / wall:.2f} frames/s; {ev}")
    if ev["count"] != n_test or not math.isfinite(ev["add_dis"]):
        raise AssertionError(f"eval mode summary {ev}")

    path = out_dir / "lm_poses.jsonl"
    summary = infer.main(args[:2] + ["--ckpt", str(run_dir / "ckpt"),
                                     "--dataset_root", str(root),
                                     "--batch_size", str(BS),
                                     "--max_batches", "1",
                                     "--output", str(path)])
    records = _lines(path)
    log(f"  tools/infer.py --ckpt: {len(records)} records, {summary}")
    if len(records) != BS or {r["cls"] for r in records} != {0, 1}:
        raise AssertionError(f"{len(records)} records, expected {BS}")

    got = eval_standalone.main(args[:2] + ["--ckpt", str(run_dir / "ckpt"),
                                           "--dataset_root", str(root),
                                           "--max_batches", "2",
                                           "--log_dir",
                                           str(out_dir / "lm_standalone")])
    log(f"  tools/eval_standalone.py: overall {got['overall']}")
    if (got["overall"]["count"] != 2 * bs
            or not set(got["per_object"]) <= {"0", "1"}):
        raise AssertionError(f"eval_standalone summary {got['overall']}")
    return counts


# phase 13: the KRRN training options the shipped config leaves off
OPTIONS = {"module.norm": "bn", "train.refine": True,
           "train.optimizer.type": "Adam"}
OPTIONS_CONFIG = ("schema.override(schema.Config(dataset='synthetic'),\n"
                  "                           **{**%r,\n"
                  "                              'train.start_pose_epoch': 0})"
                  % OPTIONS)
# the refine loss's ADD(-S) runs the nearest-source kernel once more
OPTIONS_TRAIN = dict(LITE_TRAIN, min_dists=3)
OPTIONS_STEPS = 20
# bf16 carries 8 bits of mantissa: |R^T R - I| of pred_r within 4 ulps of 1
ORTHO_TOL = 4 * 2.0 ** -7


def train_options_full_width(cfg, serve_batch, dev):
    """Phase 13: schema.Config() with module.norm="bn", train.refine and
    Adam (bf16, bs=8, synthetic frames, the pose branch on): one step with
    the kernels against the plain versions from the same weights, running
    statistics, Adam state and draws; the launches of a step; 20 steps on
    one batch (finite, none skipped, the mean of the last 5 losses below
    the first, running statistics finite and moved); the step time, its
    split and the refine term's own time; serving the trained model at
    bs=32 on its running statistics; the training CLI with the options
    and --enable_rot (one debug epoch, launches held) and its checkpoint
    served through tools/infer.py --ckpt --enable_rot; and
    KRRN(enable_rot=True)'s pred_r on the trained weights. Returns
    the launch counts of the train step, the serving step and the
    rotation model's forward."""
    import copy

    import torch
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.models.krrn import KRRN
    from pose_estimation_tpu_torch.tools import infer
    from pose_estimation_tpu_torch.train.optim import Adam
    from pose_estimation_tpu_torch.train.train_step import build_refine_loss
    cfg = schema.override(cfg, **OPTIONS)
    state, step, batch = _train_setup(cfg, dev)
    model = state.model
    if not isinstance(step.tx, Adam):
        raise AssertionError(f"optimizer {type(step.tx).__name__}")

    start = copy.deepcopy((model.state_dict(), state.opt_state))

    def one(plain):
        model.load_state_dict(start[0])
        state.generator.manual_seed(1)
        with plain_kernels() if plain else contextlib.nullcontext():
            out = step.losses(batch, True, True, state.generator)
            grads = step.gradients(out)
        gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
        return (out["loss"].item(), out["loss_refine"].item(), gn.item(),
                {k: v.clone() for k, v in model.named_buffers()})

    one(False)                                           # warm-up
    (l_k, r_k, g_k, bufs_k), ms_k = _sync_ms(lambda: one(False))
    (l_p, r_p, g_p, bufs_p), ms_p = _sync_ms(lambda: one(True))
    e_buf = max((bufs_k[k] - v).abs().max().item() / max(
        1.0, v.abs().max().item()) for k, v in bufs_p.items())
    log(f"  one step's forward + backward from the same weights, running "
        f"statistics and draws: loss {l_k:.6f} (plain {l_p:.6f}), "
        f"loss_refine {r_k:.6f} (plain {r_p:.6f}), gradient norm {g_k:.6f} "
        f"(plain {g_p:.6f}), running statistics max rel |err| {e_buf:.3e}; "
        f"{ms_k:.1f} ms with the kernels, {ms_p:.1f} ms plain")
    if not (abs(l_k - l_p) <= 2e-2 * max(1.0, abs(l_p))
            and abs(r_k - r_p) <= 2e-2 * max(1.0, abs(r_p))
            and abs(g_k - g_p) <= 2e-2 * g_p and e_buf <= 2e-2):
        raise AssertionError(f"options step kernel vs plain: loss {l_k} / "
                             f"{l_p}, refine {r_k} / {r_p}, grad norm {g_k} "
                             f"/ {g_p}, running statistics {e_buf}")
    model.load_state_dict(start[0])
    state.opt_state = copy.deepcopy(start[1])
    stats0 = {k: v.clone() for k, v in model.named_buffers()}

    counts = _counted_step(state, step, batch, OPTIONS_TRAIN)
    losses, refine, skipped, times, split = [], [], 0.0, [], []
    for i in range(OPTIONS_STEPS):
        if i < OPTIONS_STEPS - 5:
            m, t = _sync_ms(lambda: step(state, batch, opt_pose=True))
        else:
            out, t1 = _sync_ms(lambda: step.losses(batch, True, True,
                                                   state.generator))
            grads, t2 = _sync_ms(lambda: step.gradients(out))
            m, t3 = _sync_ms(lambda: step.apply(state, out, grads))
            split.append((t1, t2, t3))
            t = t1 + t2 + t3
        times.append(t)
        losses.append(m["loss"].item())
        refine.append(m["loss_refine"].item())
        skipped += m["skipped_nonfinite"].item()
    first, last5 = losses[0], sum(losses[-5:]) / 5
    moved = sum(not torch.equal(v, stats0[k])
                for k, v in model.named_buffers())
    finite = all(torch.isfinite(v).all() for v in model.buffers())
    log(f"  {OPTIONS_STEPS} steps on one batch: loss {first:.4f} -> mean of "
        f"the last 5 {last5:.4f}; skipped {skipped:.0f}; loss_refine "
        f"{refine[0]:.4f} -> {refine[-1]:.4f}; {moved} of "
        f"{len(stats0)} running statistics moved, all finite: {finite}")
    if not (all(math.isfinite(x) for x in losses + refine) and skipped == 0
            and last5 < first and finite and moved == len(stats0)):
        raise AssertionError(f"options training did not run clean: {losses}"
                             f", skipped {skipped}, moved {moved}")

    refine_loss = build_refine_loss(cfg)
    with torch.no_grad():
        fwd = model(batch["img"], batch["cloud"], batch["choose"],
                    batch["cls"], opt_pose=True, train=False)

    def refine_term():
        xyz = fwd["xyz_emb"].detach().requires_grad_()
        refine_loss(dict(fwd, xyz_emb=xyz), batch,
                    state.generator).backward()

    refine_term()                                        # warm-up
    refine_ms = _median([_sync_ms(refine_term)[1] for _ in range(10)])
    med = _median(times[:-5])
    fwd_ms, bwd_ms, opt_ms = (_median([p[j] for p in split])
                              for j in range(3))
    log(f"  train step (bs={TRAIN_BS}, bf16, BN + refine + Adam), median of "
        f"{OPTIONS_STEPS - 5}: {med:.2f} ms = {TRAIN_BS / med * 1e3:.2f} "
        f"samples/s; split (median of 5, synced between stages): forward + "
        f"loss {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms, guard + Adam "
        f"{opt_ms:.2f} ms; the refine term alone (forward + backward from "
        f"xyz_emb, median of 10) {refine_ms:.2f} ms")
    profile_steps(lambda: step(state, batch), 3)

    before = {k: v.clone() for k, v in model.named_buffers()}
    serve_counts = serve_full_width(cfg, serve_batch, dev, model=model)
    if any(not torch.equal(v, before[k]) for k, v in model.named_buffers()):
        raise AssertionError("serving changed the running statistics")

    from pose_estimation_tpu_torch import cli
    out_dir = ROOT / "build" / "smoke"
    run_dir = out_dir / "options_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg_file = write_config(OPTIONS_CONFIG, "options_config")
    n_frames, bs = cfg.module.num_cls * 2, cli.load_config(
        str(cfg_file)).train.batch_size
    reset_counts()
    cli.main(["--config", str(cfg_file), "--synthetic", "--debug",
              "--epochs", "1", "--frames_per_object", "2", "--log_dir",
              str(run_dir), "--enable_rot"])
    torch.cuda.synchronize()
    _check_counts("the training CLI with the options and --enable_rot",
                  read_counts(),
                  {"train steps": (min(DEBUG_STEPS, n_frames // bs),
                                   OPTIONS_TRAIN),
                   "eval forwards": (-(-n_frames // bs), LITE_EVAL)})
    train, ev = _lines(run_dir / "train.jsonl"), _lines(run_dir / "eval.jsonl")
    log(f"  cli.py --enable_rot: train {train[0]}; eval {ev[-1]}")
    if not (math.isfinite(train[0]["loss_refine"])
            and train[0]["skipped_nonfinite"] == 0
            and math.isfinite(ev[-1]["add_dis"])):
        raise AssertionError("training CLI with the options")
    path = out_dir / "options_poses.jsonl"
    summary = infer.main(["--config", str(cfg_file), "--synthetic",
                          "--frames_per_object", "3", "--num_frames",
                          str(BS), "--batch_size", str(BS), "--ckpt",
                          str(run_dir / "ckpt"), "--output", str(path),
                          "--enable_rot"])
    records = _lines(path)
    log(f"  tools/infer.py --ckpt --enable_rot (that run's BN statistics, "
        f"Adam state and rotation heads restored): {len(records)} records, "
        f"{summary}")
    if len(records) != BS or not all(
            math.isfinite(x) for r in records for x in r["t"]):
        raise AssertionError(f"{len(records)} records, expected {BS}")

    torch.manual_seed(0)
    rot = KRRN(cfg, dtype=torch.bfloat16, enable_rot=True).to(dev)
    fresh = [k for k in rot.state_dict() if ".RotBase_" in k]
    missing = rot.load_state_dict(model.state_dict(), strict=False)[0]
    if sorted(missing) != sorted(fresh):
        raise AssertionError(f"rotation model: {missing[:3]} not loaded")
    reset_counts()
    with torch.no_grad():
        out = rot(serve_batch["img"], serve_batch["cloud"],
                  serve_batch["choose"], serve_batch["cls"])
    torch.cuda.synchronize()
    rot_counts = read_counts()
    r = out["pred_r"].float()
    eye = torch.eye(3, device=dev)
    ortho = (r.transpose(-1, -2) @ r - eye).abs().max().item()
    det = torch.linalg.det(r)
    log(f"  KRRN(enable_rot=True) forward (bs={BS}, bf16, the trained "
        f"model's weights and running statistics, fresh rotation heads): "
        f"pred_r {tuple(r.shape)}, max |R^T R - I| {ortho:.3e} "
        f"(tol {ORTHO_TOL:.3e}), det in [{det.min().item():.4f}, "
        f"{det.max().item():.4f}]; launches {rot_counts}")
    if not (r.shape == (BS, 3, 3) and torch.isfinite(r).all()
            and ortho <= ORTHO_TOL and launches_match(rot_counts, LITE_SERVE)):
        raise AssertionError(f"pred_r: ortho {ortho}, counts {rot_counts}")
    return counts, serve_counts, rot_counts


# ---------------------------------------------------------------------------
# Phase 14: multi-GPU training on the one card
# ---------------------------------------------------------------------------

MGPU_CONFIG = {"train.start_pose_epoch": 0}
MGPU_VARIANTS = {"gn": {},
                 "bn_refine": {"module.norm": "bn", "train.refine": True},
                 "bn_refine_fp32": {"module.norm": "bn", "train.refine": True,
                                    "train.amp": False}}
# Printed, not held, for BatchNorm. In bf16 the last bit by which the
# mean of two ranks' means differs from one mean flips bf16 roundings,
# and the 277 BatchNorms spread the flips (on the tiny model on the CPU,
# 93% of the activations differ by the 48th BatchNorm, xyz_emb by 4.25%:
# tests/test_torch_dist.py::test_batchnorm_conditioning), so the refine
# loss's PnP and the gradient part ways;
# the fp32 run holds loss_refine. In fp32 the gradient itself is
# ill-conditioned: E[x^2] - E[x]^2 over the small maps cancels, and on the
# tiny model one process's fp32 gradient norm is 8.6% off its fp64 one
# while two ranks and one process agree in fp64 to 1e-7
# (tests/test_torch_dist.py), so two fp32 orders of summation differ by
# percents (2.4% there) in the norm: it is printed.
MGPU_UNHELD = {"bn_refine": ("loss_refine", "grad_norm"),
               "bn_refine_fp32": ("grad_norm",)}
MGPU_TRAIN_STEPS = 3
MGPU_STEP_TOL = 2e-2
# the first step's gradient norm from one state and batch: runs with and
# without a group of one varied by 5.7e-5 to 3.8e-4 (relative) from run
# to run on the card, pairs of runs without a group alike (atomicAdd in
# the backward)
MGPU_FIRST_NORM_TOL = 1e-3
# collectives a train step adds (all all_reduce): the four masked means'
# counts, the loss terms, the gradient; and two for each BatchNorm (its
# statistics in the forward and their gradient in the backward)
STEP_COLLECTIVES, BN_COLLECTIVES = 6, 2
RING_POINTS, RING_KNN_POINTS, RING_K = 8192, 4096, 10
MGPU_TIMEOUT_S = 480


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def counted_collectives():
    """Count torch.distributed.all_reduce calls, the one collective of a
    train step, while the block runs (a one-element list)."""
    import torch.distributed as tdist
    n, inner = [0], tdist.all_reduce

    def counted(*args, **kw):
        n[0] += 1
        return inner(*args, **kw)

    tdist.all_reduce = counted
    try:
        yield n
    finally:
        tdist.all_reduce = inner


def _mgpu_test_set(cfg):
    """9 synthetic test frames: shards of 5 and 4 on two ranks."""
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    return SyntheticPoseDataset(num_objects=3, frames_per_object=3,
                                num_regions=cfg.data.num_regions,
                                pose_seed=11, cache_frames=True)


def _trainer_run(cfg, train, test, log_dir, dev):
    """Trainer.train_epoch for MGPU_TRAIN_STEPS steps (bs 8), then
    test_epoch: each step's metrics, launches and parameters, and the eval
    summary."""
    import torch
    from pose_estimation_tpu_torch.train.trainer import Trainer
    shutil.rmtree(log_dir, ignore_errors=True)
    tr = Trainer(cfg, train, test, log_dir=str(log_dir), device=str(dev))
    tr.init_state()
    steps, inner = [], tr.train_step

    def recorded(state, batch, opt_pose=True):
        reset_counts()
        m = inner(state, batch, opt_pose=opt_pose)
        torch.cuda.synchronize()
        steps.append(({k: v.item() for k, v in m.items()}, read_counts(),
                      {k: p.detach().clone()
                       for k, p in state.model.named_parameters()}))
        return m

    tr.train_step = recorded
    tr.train_epoch(0, steps=MGPU_TRAIN_STEPS)
    summary = tr.test_epoch(0)
    if len(steps) != MGPU_TRAIN_STEPS:
        raise AssertionError(f"the trainer ran {len(steps)} steps")
    return steps, summary


def _runs_delta(a, b):
    """Two trainer runs step for step: (bit for bit, [per step {metric:
    |delta| / max(1, |a|)}], max rel |delta| of the parameters)."""
    import torch
    same, steps, dp = True, [], 0.0
    for (ma, _, pa), (mb, _, pb) in zip(a, b, strict=True):
        steps.append({k: abs(v - mb[k]) / max(1.0, abs(v))
                      for k, v in ma.items()})
        same &= ma == mb
        for k, v in pa.items():
            same &= torch.equal(v, pb[k])
            dp = max(dp, (v - pb[k]).abs().max().item()
                     / max(1.0, v.abs().max().item()))
    return same, steps, dp


def _fmt_deltas(steps):
    return "; ".join(", ".join(f"{k} {v:.1e}" for k, v in d.items() if v)
                     or "none" for d in steps)


def _posed(model, batch):
    """`batch` with xy_choosed at the refine loss's 128 points made the
    projections, at a pose 0.2 rad and 3.7 cm off the ground truth plus
    0.05 px of seeded noise, of the points the refine loss reads off the
    model's training-mode xyz_emb: a PnP problem with one clear solution.
    On a random model's own points RANSAC's hypotheses tie on inlier
    counts and the last bit of an input picks the winner, so two ranks
    and one process could not be compared. The running statistics are
    left as they were."""
    import torch
    from pose_estimation_tpu_torch.data.pipeline import denormalize_xyz
    saved = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad():
        out = model(batch["img"], batch["cloud"], batch["choose"],
                    batch["cls"], opt_pose=False, train=True)
        for k, v in model.named_buffers():
            v.copy_(saved[k])
        n = batch["choose"].shape[1]
        sel = torch.arange(128, device=out["xyz_emb"].device) * max(
            n // 128, 1) % n
        pw = denormalize_xyz(out["xyz_emb"][:, sel].float(),
                             batch["lf_border"], batch["extent"])
        c, s = math.cos(0.2), math.sin(0.2)
        off = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                           device=pw.device)
        r = batch["target_r"] @ off
        t = batch["target_t"] + torch.tensor([0.02, -0.01, 0.03],
                                             device=pw.device)
        proj = (pw @ r.transpose(1, 2) + t[:, None]) @ batch[
            "k"].transpose(1, 2)
        g = torch.Generator(device=pw.device).manual_seed(13)
        uv = proj[..., :2] / proj[..., 2:] + 0.05 * torch.randn(
            proj[..., :2].shape, generator=g, device=pw.device)
        xy = batch["xy_choosed"].clone()
        xy[:, sel] = uv
    return dict(batch, xy_choosed=xy)


def _ring_clouds(dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(7)
    return [torch.rand(n, 3, generator=g, device=dev) * 0.2
            for n in (RING_POINTS, RING_POINTS, RING_KNN_POINTS)]


def _probe_gloo_cuda(dev, world):
    """Which collectives gloo takes on CUDA tensors: 'ok' or the error.
    An op gloo lacks raises on every rank before any traffic."""
    import torch
    import torch.distributed as tdist
    x = torch.ones(4, device=dev)
    ops = {
        "all_reduce": lambda: tdist.all_reduce(x.clone()),
        "broadcast": lambda: tdist.broadcast(x.clone(), 0),
        "all_gather": lambda: tdist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "all_gather_into_tensor": lambda: tdist.all_gather_into_tensor(
            torch.empty(4 * world, device=dev), x),
        "reduce_scatter_tensor": lambda: tdist.reduce_scatter_tensor(
            torch.empty(4 // world, device=dev), x.clone()),
        "all_to_all_single": lambda: tdist.all_to_all_single(
            torch.empty_like(x), x),
    }
    out = {}
    for name, fn in ops.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # recorded: the probe's finding
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"
    return out


def _probe_p2p(dev, rank, world):
    """isend / irecv of CUDA tensors through gloo (the ring stages its
    blocks through the host instead), with a timeout."""
    import datetime

    import torch
    import torch.distributed as tdist
    x = torch.full((4,), float(rank), device=dev)
    y = torch.empty_like(x)
    try:
        reqs = tdist.batch_isend_irecv([
            tdist.P2POp(tdist.isend, x, (rank + 1) % world),
            tdist.P2POp(tdist.irecv, y, (rank - 1) % world)])
        for req in reqs:
            req.wait(timeout=datetime.timedelta(seconds=20))
        torch.cuda.synchronize()
        want = float((rank - 1) % world)
        return "ok" if bool((y == want).all()) else f"wrong values {y}"
    except Exception as e:  # recorded: the probe's finding
        return f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"


def _mgpu_rank(rank, world, init, out_dir, device):
    """One of two ranks sharing the card (gloo on CUDA tensors): its rows
    of one step of each variant, the sharded eval, its shards of the ring
    ops; rank_<r>.pt, then the p2p probe's p2p_<r>.json."""
    import torch
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.models.layers import BatchNorm
    from pose_estimation_tpu_torch.parallel import dist
    from pose_estimation_tpu_torch.parallel.ring_pointops import (
        ring_knn, ring_min_dists)
    from pose_estimation_tpu_torch.train.trainer import Trainer
    out_dir = Path(out_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.distributed_init("gloo", init, world, rank):
        raise RuntimeError("rank did not join the group")
    out = {"probe": _probe_gloo_cuda(dev, world)}
    cfg = torch.load(out_dir / "config.pt", weights_only=False)
    for variant, over in MGPU_VARIANTS.items():
        full = torch.load(out_dir / f"batch_{variant}.pt")
        rows = {k: dist.rank_rows(v).to(dev) for k, v in full.items()}
        state, step, _ = _train_setup(schema.override(cfg, **over), dev,
                                      batch=rows)
        reset_counts()
        with counted_collectives() as n:
            m = step(state, rows, opt_pose=True)
            torch.cuda.synchronize()
        res = {"metrics": {k: v.item() for k, v in m.items()},
               "launches": read_counts(), "collectives": n[0],
               "batchnorms": sum(isinstance(x, BatchNorm)
                                 for x in state.model.modules()),
               "params": {k: p.detach().cpu()
                          for k, p in state.model.named_parameters()},
               "buffers": {k: b.cpu()
                           for k, b in state.model.named_buffers()}}
        res["ms"] = _median([_sync_ms(lambda: step(state, rows))[1]
                             for _ in range(3)])
        out[variant] = res
        del state, step
        torch.cuda.empty_cache()
    test = _mgpu_test_set(cfg)
    tr = Trainer(cfg, test, test, log_dir=str(out_dir / f"eval_{rank}"),
                 device=device)
    tr.init_state()
    reset_counts()
    summary = tr.test_epoch(0)
    out["eval"] = {"overall": summary["overall"],
                   "per_object": {k: v["count"] for k, v in
                                  summary["per_object"].items()},
                   "launches": read_counts()}
    tgt, src, pts = (dist.rank_rows(c) for c in _ring_clouds(dev))
    ring_d, knn = ring_min_dists(), ring_knn(None, RING_K)
    ring_d(tgt, src)
    knn(pts)                                             # warm-up
    reset_counts()
    (d, (kd, ki)), ms = _sync_ms(lambda: (ring_d(tgt, src), knn(pts)))
    out["ring"] = {"min_dists": d.cpu(), "knn_dists": kd.cpu(),
                   "knn_idx": ki.cpu(), "launches": read_counts(), "ms": ms}
    torch.save(out, out_dir / f"rank_{rank}.pt")
    (out_dir / f"p2p_{rank}.json").write_text(
        json.dumps(_probe_p2p(dev, rank, world)))
    dist.destroy()


def _spawn_ranks(world, init, out_dir, device):
    """Start `world` rank processes; wait for each one's rank_<r>.pt
    (MGPU_TIMEOUT_S in all), then up to 60 s more for the p2p probe.
    A rank that dies before its results, or a timeout, raises; every
    process is stopped before this returns."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mgpu_rank,
                         args=(r, world, init, str(out_dir), device))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + MGPU_TIMEOUT_S
        while not all((out_dir / f"rank_{r}.pt").exists()
                      for r in range(world)):
            dead = [p.exitcode for p in procs if p.exitcode is not None]
            if dead or time.monotonic() > deadline:
                raise RuntimeError(f"a rank failed or timed out: exit codes "
                                   f"{[p.exitcode for p in procs]}")
            time.sleep(1)
        for p in procs:
            p.join(timeout=60)
        return [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def _leaf_err(got: dict, ref: dict) -> float:
    return max((g - ref[k]).abs().max().item()
               / max(1.0, ref[k].abs().max().item())
               for k, g in got.items())


def multi_gpu_one_card(cfg, dev):
    """Phase 14: data-parallel training as far as one card can hold it.
    (a) a 1-process NCCL group against no group, step for step through
    the trainer; the step's time with and without the group and the
    gradient all-reduce's own; (b) two processes sharing the card (gloo
    on CUDA tensors) against one process at bs 8, for the shipped
    GroupNorm config and for BatchNorm with the refine loss, and the
    sharded eval merged; (c) the ring ops over those two ranks against
    the kernels on the whole cloud. Returns the launch counts by path."""
    import torch
    import torch.distributed as tdist
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    from pose_estimation_tpu_torch.ops import pointops as kops
    from pose_estimation_tpu_torch.parallel import dist
    cfg = schema.override(cfg, **MGPU_CONFIG)
    out_dir = ROOT / "build" / "smoke" / "mgpu"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    torch.save(cfg, out_dir / "config.pt")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    paths = {}

    log("  (a) a 1-process NCCL group against no group, through the "
        f"trainer: {MGPU_TRAIN_STEPS} steps at bs {TRAIN_BS}, one eval")
    train = SyntheticPoseDataset(
        num_objects=cfg.module.num_cls,
        frames_per_object=-(-MGPU_TRAIN_STEPS * TRAIN_BS
                            // cfg.module.num_cls),
        num_regions=cfg.data.num_regions, cache_frames=True)
    test = _mgpu_test_set(cfg)
    ref, ref_eval = _trainer_run(cfg, train, test, out_dir / "nogroup", dev)
    again, _ = _trainer_run(cfg, train, test, out_dir / "nogroup_again",
                            dev)
    state, step, batch = _train_setup(cfg, dev)
    step(state, batch)                                   # warm-up
    step_ms = lambda: _median([_sync_ms(lambda: step(state, batch))[1]
                               for _ in range(10)])
    ms_before = step_ms()
    if not dist.distributed_init(backend, f"tcp://localhost:{_free_port()}",
                                 1, 0):
        raise AssertionError(f"no {backend} group")
    try:
        got, got_eval = _trainer_run(cfg, train, test, out_dir / "nccl", dev)
        ms_group = step_ms()
        with counted_collectives() as n:
            step(state, batch)
            torch.cuda.synchronize()
        grads = [torch.randn_like(p) for p in state.model.parameters()]
        flat = torch.cat([g.reshape(-1) for g in grads])
        reduce_ms = cuda_ms(lambda: dist.all_reduce_mean(grads))
        raw_ms = cuda_ms(lambda: tdist.all_reduce(flat))
        mib = flat.numel() * flat.element_size() / 2 ** 20
    finally:
        dist.destroy()
    ms_after = step_ms()
    n_grads = len(grads)
    del state, step, grads, flat
    torch.cuda.empty_cache()
    same_ng, d_ng, dp_ng = _runs_delta(ref, again)
    same, d_g, dp = _runs_delta(ref, got)
    counts = [c for _, c, _ in ref + again + got]
    paths["train_nccl_group"] = got[0][1]
    log(f"  no group twice: bit for bit {same_ng}, parameters max rel "
        f"|delta| {dp_ng:.3e}, metrics by step: {_fmt_deltas(d_ng)}")
    log(f"  NCCL group of one against no group: bit for bit {same}, "
        f"parameters {dp:.3e}, metrics by step: {_fmt_deltas(d_g)}; losses "
        f"{[m['loss'] for m, _, _ in got]} (no group "
        f"{[m['loss'] for m, _, _ in ref]}), gradient norms "
        f"{[m['grad_norm'] for m, _, _ in got]} (no group "
        f"{[m['grad_norm'] for m, _, _ in ref]})")
    log(f"  eval under the group: {got_eval['overall']} (no group "
        f"{ref_eval['overall']['count']} samples, add_dis "
        f"{ref_eval['overall']['add_dis']})")
    log(f"  train step (bs {TRAIN_BS}, fixed batch), median of 10: no group "
        f"{ms_before:.2f} ms, NCCL group of one {ms_group:.2f} ms, no group "
        f"again {ms_after:.2f} ms; collectives a step {n[0]}; the gradient "
        f"all-reduce ({n_grads} tensors, {mib:.1f} MiB in one buffer: "
        f"flatten, all_reduce, divide, copy back) {reduce_ms:.3f} ms, "
        f"NCCL's all_reduce of the buffer alone {raw_ms:.3f} ms")
    if not all(launches_match(c, LITE_TRAIN) for c in counts):
        raise AssertionError(f"launches per trainer step {counts}")
    if n[0] != STEP_COLLECTIVES:
        raise AssertionError(f"{n[0]} collectives a step")
    if got_eval["overall"]["count"] != len(test):
        raise AssertionError(f"eval counted {got_eval['overall']['count']}")
    # Bit for bit where the card repeats itself bit for bit. Where it does
    # not (its backward accumulates with atomics), the first step, from
    # one state and batch, holds the forward's loss terms bit for bit and
    # the gradient norm at MGPU_FIRST_NORM_TOL; the parameters stay within
    # 1e-5 over every step (Ranger's normalised update); later loss terms
    # at the phase's 2e-2.
    first = {k: v for k, v in d_g[0].items() if k != "grad_norm"}
    ok = same if same_ng else (
        not any(first.values())
        and d_g[0]["grad_norm"] <= MGPU_FIRST_NORM_TOL
        and dp <= 1e-5 and all(v <= MGPU_STEP_TOL for d in d_g[1:]
                               for k, v in d.items() if k != "grad_norm"))
    if not ok:
        raise AssertionError("NCCL group of one vs no group")

    log("  (b) two processes sharing the card (gloo on CUDA tensors), bs 4 "
        f"each, against one process at bs {TRAIN_BS}; (c) the ring ops over "
        "the two ranks")
    refs = {}
    for variant, over in MGPU_VARIANTS.items():
        vcfg = schema.override(cfg, **over)
        state, step, batch = _train_setup(vcfg, dev)
        if vcfg.train.refine:
            batch = _posed(state.model, batch)
        torch.save({k: v.cpu() for k, v in batch.items()},
                   out_dir / f"batch_{variant}.pt")
        m = step(state, batch, opt_pose=True)
        refs[variant] = {
            "metrics": {k: v.item() for k, v in m.items()},
            "params": {k: p.detach().cpu()
                       for k, p in state.model.named_parameters()},
            "buffers": {k: b.cpu() for k, b in state.model.named_buffers()}}
        refs[variant]["ms"] = _median([_sync_ms(lambda: step(state, batch))[1]
                                       for _ in range(3)])
        del state, step, batch
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    codes = _spawn_ranks(2, f"tcp://localhost:{_free_port()}", out_dir,
                         str(dev))
    wall = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank_{r}.pt") for r in range(2)]
    p2p = [json.loads((out_dir / f"p2p_{r}.json").read_text())
           if (out_dir / f"p2p_{r}.json").exists()
           else f"no result (exit code {codes[r]})" for r in range(2)]
    log(f"  the two ranks ran in {wall:.1f} s (exit codes {codes}); gloo on "
        f"CUDA tensors: {ranks[0]['probe']}; isend/irecv: {p2p}")
    if ranks[0]["probe"]["all_reduce"] != "ok":
        raise AssertionError("gloo refused all_reduce on CUDA tensors")
    for variant in MGPU_VARIANTS:
        r0, r1 = (r[variant] for r in ranks)
        want = refs[variant]
        same_ranks = (r0["metrics"] == r1["metrics"] and all(
            torch.equal(v, r1[t][k]) for t in ("params", "buffers")
            for k, v in r0[t].items()))
        e_m = {k: abs(r0["metrics"][k] - v) / max(1.0, abs(v))
               for k, v in want["metrics"].items()}
        held = max(v for k, v in e_m.items()
                   if k not in MGPU_UNHELD.get(variant, ()))
        e_p = _leaf_err(r0["params"], want["params"])
        e_b = _leaf_err(r0["buffers"], want["buffers"]) if want[
            "buffers"] else 0.0
        log(f"  {variant}: ranks equal bit for bit {same_ranks}; loss "
            f"{r0['metrics']['loss']:.6f} (one process "
            f"{want['metrics']['loss']:.6f}), gradient norm "
            f"{r0['metrics']['grad_norm']:.4f} "
            f"({want['metrics']['grad_norm']:.4f})"
            + (f", loss_refine {r0['metrics']['loss_refine']:.6f} "
               f"({want['metrics']['loss_refine']:.6f})"
               if "loss_refine" in want["metrics"] else "")
            + f"; max rel |err| metrics {max(e_m.values()):.3e} (held "
            f"{held:.3e}), updated "
            f"parameters {e_p:.3e}, running statistics {e_b:.3e}; "
            f"launches a step {r0['launches']}, collectives "
            f"{r0['collectives']} ({r0['batchnorms']} BatchNorms); step {r0['ms']:.2f} / {r1['ms']:.2f} ms "
            f"a rank (one process at bs {TRAIN_BS}: {want['ms']:.2f} ms)")
        if not (same_ranks and held <= MGPU_STEP_TOL
                and e_p <= MGPU_STEP_TOL and e_b <= MGPU_STEP_TOL
                and all(math.isfinite(v) for v in r0["metrics"].values())):
            raise AssertionError(f"{variant}: two ranks vs one process")
        if r0["collectives"] != (STEP_COLLECTIVES
                                 + BN_COLLECTIVES * r0["batchnorms"]):
            raise AssertionError(f"{variant}: {r0['collectives']} "
                                 "collectives a step")
        want_l = OPTIONS_TRAIN if "refine" in variant else LITE_TRAIN
        if not all(launches_match(r[variant]["launches"], want_l)
                   for r in ranks):
            raise AssertionError(f"{variant}: launches "
                                 f"{[r[variant]['launches'] for r in ranks]}")
        paths[f"train_2_ranks_{variant}"] = r0["launches"]
    evals = [r["eval"] for r in ranks]
    log(f"  sharded eval of {len(test)} frames (shards of 5 and 4, padded "
        f"to one batch of {cfg.train.batch_size} a rank): merged counts "
        f"{[e['overall']['count'] for e in evals]}, "
        f"per object {evals[0]['per_object']}, add_dis "
        f"{[e['overall']['add_dis'] for e in evals]}; launches on rank 0 "
        f"{evals[0]['launches']}")
    if not all(e["overall"] == evals[0]["overall"]
               and e["overall"]["count"] == len(test)
               and sum(e["per_object"].values()) == len(test)
               for e in evals):
        raise AssertionError(f"eval merge: {evals}")

    tgt, src, pts = _ring_clouds(dev)
    d_ref = kops.nearest(tgt[None], src[None])[0][0].cpu()
    i_ref = kops.knn(pts[None], pts[None], RING_K, True)[0].cpu()
    d_got = torch.cat([r["ring"]["min_dists"] for r in ranks])
    i_got = torch.cat([r["ring"]["knn_idx"] for r in ranks])
    kd = torch.cat([r["ring"]["knn_dists"] for r in ranks])
    kd_ref = torch.sqrt(torch.clamp(
        ((pts[i_ref.long().to(dev)] - pts[:, None]) ** 2).sum(-1),
        min=1e-16)).cpu()
    e_d = (d_got - d_ref).abs().max().item()
    e_kd = (kd - kd_ref).abs().max().item()
    log(f"  ring_min_dists over 2 ranks ({RING_POINTS} x {RING_POINTS} "
        f"points; blocks on kernel 4) against kernel 4 on the whole cloud: "
        f"max |err| {e_d:.3e}; ring_knn ({RING_KNN_POINTS} points, k "
        f"{RING_K}): indices equal {torch.equal(i_got, i_ref)}, distances "
        f"max |err| {e_kd:.3e}; both on rank 0 {ranks[0]['ring']['ms']:.2f} "
        f"ms, launches {ranks[0]['ring']['launches']}")
    if not (e_d <= 1e-6 and torch.equal(i_got, i_ref) and e_kd <= 1e-4):
        raise AssertionError(f"ring ops: {e_d}, {e_kd}")
    paths["ring_2_ranks"] = ranks[0]["ring"]["launches"]
    return paths


# ---------------------------------------------------------------------------
# Phase 15: the transparent pipeline
# ---------------------------------------------------------------------------

NO_LAUNCH = dict.fromkeys(LITE_SERVE, 0)
# launches per transparent train step (the symmetric chamfer), eval batch
# (ADD-S) and eval batch with ICP (10 iterations, the two trimmed
# residuals in one call, the refined pose's ADD-S)
TRANSPARENT_TRAIN = dict(NO_LAUNCH, min_dists=1)
TRANSPARENT_EVAL = dict(NO_LAUNCH, min_dists=1)
ICP_ITERS = 10
TRANSPARENT_EVAL_ICP = dict(NO_LAUNCH, min_dists=1 + ICP_ITERS + 1 + 1)
ICP_POINTS = 256
TRANSPARENT_STEPS = 30
PLAIN_CHUNK = 1 << 16
# the transparent fixture's objects with a symmetric chamfer in the loss
TRANSPARENT_SYM = (0, 2)


def _plain_min_dists_grads(t, s, w, chunk=PLAIN_CHUNK):
    """Autograd through the plain expression sqrt(max(min_j d, eps^2))
    of sum(min_dists(t, s) * w), in blocks of targets (a whole
    500,000 x 500 graph would not fit): (d target, d source)."""
    import torch
    from pose_estimation_tpu_torch.ops import pointops
    gt, gs = [], torch.zeros_like(s)
    for tc, wc in zip(t.split(chunk, 1), w.split(chunk, 1)):
        tc = tc.detach().requires_grad_()
        sc = s.detach().requires_grad_()
        d2 = pointops.sqdist(tc, sc).min(dim=-1).values
        plain = torch.sqrt(torch.clamp(d2, min=1e-16))
        a, b = torch.autograd.grad((plain * wc).sum(), (tc, sc))
        gt.append(a)
        gs += b
    return torch.cat(gt, 1), gs


def check_transparent_kernel(dev, g, b, n, m):
    """Phase 15(a): kernel 4 at the transparent loss's shape (b x n
    predicted points against b x m model points, one call a train step)
    and at ICP's (ICP_POINTS observed points against the model, eps = 0,
    with a coincident pair): distances and indices bit for bit against
    the plain version, the loss shape's backward against autograd
    through the plain expression (1e-3 x max(1, max|ref|), phase 3's),
    the times, the bound and the library call's time (torch.cdist + min,
    in the plain version's blocks)."""
    import torch
    from pose_estimation_tpu_torch.ops import pointops
    t = _cloud(g, b, n, dev)
    s = _cloud(g, b, m, dev)
    got = pointops.nearest_multi(t, [s])[0]
    ref = pointops.nearest_multi_plain(t, [s])[0]
    err = (got[0] - ref[0]).abs().max().item()
    same = torch.equal(got[1], ref[1])
    t_k = cuda_ms(lambda: pointops.nearest_multi(t, [s]), reps=10)
    t_p = cuda_ms(lambda: pointops.nearest_multi_plain(t, [s]), reps=3,
                  warmup=1)
    t_l = cuda_ms(lambda: [torch.cdist(tc, s).min(dim=-1)
                           for tc in t.split(PLAIN_CHUNK, 1)], reps=3,
                  warmup=1)
    # per pair: dot (5), the norms' sum and -2 dot (3), one compare
    b_ms, b_by = bound(nbytes(t, s) + b * n * 8, {"fp32": b * n * m * 9})
    log(f"  kernel 4 at the loss's shape, B={b} {n}x{m} "
        f"({b * n * m:.3e} pairs): max |err| {err:.3e}, indices equal "
        f"{same}; kernel {t_k:.4f} ms ({b * n * m / t_k * 1e3:.3e} "
        f"pairs/s), plain {t_p:.4f} ms, cdist + min {t_l:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    if not (err == 0.0 and same):
        raise AssertionError(f"kernel 4 at {n}x{m}: {err}, {same}")
    tg = t.clone().requires_grad_()
    sg = s.clone().requires_grad_()
    w = torch.rand((b, n), generator=g, device=dev)
    gk = torch.autograd.grad((pointops.min_dists(tg, sg) * w).sum(),
                             (tg, sg))
    gp = _plain_min_dists_grads(t, s, w)
    worst = 0.0
    for name, a, r in zip(("target", "source"), gk, gp):
        e = (a - r).abs().max().item()
        tol = 1e-3 * max(1.0, r.abs().max().item())
        log(f"  its backward, {name} gradient: max |err| {e:.3e} (tol "
            f"{tol:.3e})")
        if not e <= tol:
            raise AssertionError(f"kernel 4 backward {name}: {e} > {tol}")
        worst = max(worst, e)
    del tg, sg, gk, gp, w
    ti = _cloud(g, b, ICP_POINTS, dev)
    ti[0, 0] = s[0, 7]
    got = pointops.nearest_multi(ti, [s, s.flip(1).contiguous()], eps=0.0)
    ref = pointops.nearest_multi_plain(ti, [s, s.flip(1).contiguous()],
                                       eps=0.0)
    e_i = max((a[0] - r[0]).abs().max().item() for a, r in zip(got, ref))
    same_i = all(torch.equal(a[1], r[1]) for a, r in zip(got, ref))
    zero = got[0][0][0, 0].item()
    t_i = cuda_ms(lambda: pointops.nearest(ti, s, eps=0.0))
    log(f"  kernel 4 at ICP's shape, B={b} {ICP_POINTS}x{m}, eps = 0, two "
        f"clouds: max |err| {e_i:.3e}, indices equal {same_i}, the "
        f"coincident pair's distance {zero}; one cloud {t_i:.4f} ms")
    if not (e_i == 0.0 and same_i and zero == 0.0):
        raise AssertionError(f"kernel 4 at eps = 0: {e_i}, {same_i}, {zero}")
    del t, s
    torch.cuda.empty_cache()
    return {"shape": f"B={b}, {n} x {m}", "max_abs_err": worst, "ms": t_k,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_l, "icp_ms": t_i}


def _transparent_dataset(cfg, frames_per_object=2):
    """A cached SyntheticTransparentDataset of the config's objects (480 x
    640 frames, TRANSPARENT_SYM symmetric)."""
    from pose_estimation_tpu_torch.data.synthetic import (
        SyntheticTransparentDataset)
    return SyntheticTransparentDataset(
        num_objects=cfg.module.num_cls, frames_per_object=frames_per_object,
        num_regions=cfg.data.num_regions, sym_objects=TRANSPARENT_SYM,
        cache_frames=True)


def _transparent_setup(cfg, dev, make_model=None):
    """The config's transparent model (or make_model()'s; seeded weights)
    and its train step at lr 3e-4 without warmup: (state, step)."""
    import torch
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.train.optim import make_optimizer
    from pose_estimation_tpu_torch.train.state import TrainState
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        TransparentTrainStep, build_model, loss_weights)
    cfg = schema.override(cfg, **{"train.lr.lr": 3e-4,
                                  "train.lr.warmup_iters": 0})
    torch.manual_seed(0)
    model = (make_model() if make_model else build_model(cfg)).to(dev)
    tx = make_optimizer(cfg, total_steps=1000)
    state = TrainState.create(model, tx,
                              torch.Generator(device=dev).manual_seed(0))
    return state, TransparentTrainStep(model, tx, loss_weights(cfg))


def _transparent_step_vs_plain(state, step, batch):
    """Phases 15(b), 16(a) and (d): every loss term and the gradient norm
    of one step with the kernel against the plain versions, from the same
    state, batch and draws (the model family's: the pixels, and
    TransparentPoseNet's dropout masks): 2e-2 x max(1, |ref|). Returns
    the kernel path's terms and its forward + backward ms."""
    import torch
    draws = step.draws(torch.Generator(device=batch["img"].device)
                       .manual_seed(1), batch)

    def terms():
        losses = step.losses(batch, *draws)
        grads = step.gradients(losses)
        out = {k: v.item() for k, v in losses.items()}
        out["grad_norm"] = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                          for g in grads.values())).item()
        return out

    terms()                                              # warm-up
    got, ms_k = _sync_ms(terms)
    with plain_kernels():
        ref, ms_p = _sync_ms(terms)
    errs = {k: abs(v - ref[k]) / max(1.0, abs(ref[k])) for k, v in got.items()}
    log("  one step's forward + backward, kernel vs plain (same state, batch"
        " and pixels): " + ", ".join(f"{k} {v:.6f} ({ref[k]:.6f})"
                                     for k, v in got.items())
        + f"; max rel |err| {max(errs.values()):.3e}; {ms_k:.1f} ms with the"
        f" kernel, {ms_p:.1f} ms plain")
    if not all(v <= 2e-2 for v in errs.values()):
        raise AssertionError(f"transparent step kernel vs plain: {errs}")
    return got, ms_k


def _counted_transparent_step(state, step, batch, want):
    """The train step, once, between resetting and reading the counts."""
    import torch
    reset_counts()
    step(state, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  launches in one train step: {counts}")
    if not launches_match(counts, want):
        raise AssertionError(f"transparent step launches {counts}")
    return counts


def _transparent_train_run(state, step, batch, steps):
    """Phases 15(c) and 16(b): `steps` steps on one batch; the last 5
    split into forward + loss, backward and guard + optimizer, synced
    between the stages. Holds finite losses, no skipped step and the mean
    of the last 5 losses below the first; returns (median step ms of the
    others, the split's medians, peak GiB, the losses)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    losses, skipped, times, split = [], 0.0, [], []
    for i in range(steps):
        if i < steps - 5:
            mt, t = _sync_ms(lambda: step(state, batch))
        else:
            draws = step.draws(state.generator, batch)
            out, t1 = _sync_ms(lambda: step.losses(batch, *draws))
            grads, t2 = _sync_ms(lambda: step.gradients(out))
            mt, t3 = _sync_ms(lambda: step.apply(state, out, grads))
            t = t1 + t2 + t3
            split.append((t1, t2, t3))
        times.append(t)
        losses.append(mt["all_loss"].item())
        skipped += mt["skipped_nonfinite"].item()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first, last5 = losses[0], sum(losses[-5:]) / 5
    log(f"  {steps} steps: loss {first:.4f} -> mean of the last 5 "
        f"{last5:.4f}; skipped {skipped:.0f}; losses "
        + " ".join(f"{x:.4f}" for x in losses))
    if not (all(math.isfinite(x) for x in losses) and skipped == 0
            and last5 < first):
        raise AssertionError(f"transparent training did not run clean: "
                             f"{losses}, skipped {skipped}")
    return (_median(times[:-5]),
            tuple(_median([p[j] for p in split]) for j in range(3)), peak,
            losses)


def _transparent_eval(model, batch, refine, want, reps=5):
    """Phase 15(d): the eval step on `batch`, kernel path against plain
    path, its launches and frames/s."""
    import torch
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        build_transparent_eval_step)
    ev = build_transparent_eval_step(model, refine_icp=refine,
                                     icp_iters=ICP_ITERS,
                                     icp_points=ICP_POINTS)
    ev(batch)                                            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    out = ev(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    with plain_kernels():
        ref = ev(batch)
    bs = batch["img"].shape[0]
    ms = _median([_sync_ms(lambda: ev(batch))[1] for _ in range(reps)])
    keys = ("add_dis", "add_dis_icp") if refine else ("add_dis",)
    errs = {k: ((out[k] - ref[k]).abs() / ref[k].abs().clamp(min=1.0))
            .max().item() for k in keys}
    flags = (torch.equal(out["icp_accepted"], ref["icp_accepted"])
             if refine else True)
    log(f"  eval step, bs {bs}, ICP {'on' if refine else 'off'}: launches "
        f"{counts}; add_dis mean {out['add_dis'].mean().item():.4f} m"
        + (f", add_dis_icp mean {out['add_dis_icp'].mean().item():.4f} m, "
           f"accepted {out['icp_accepted'].sum().item():.0f} of {bs}"
           if refine else "")
        + f"; kernel vs plain max rel |err| {errs}, accept flags equal "
        f"{flags}; {ms:.2f} ms = {bs / ms * 1e3:.1f} frames/s")
    finite = all(torch.isfinite(v.float()).all() for v in out.values())
    if not (finite and launches_match(counts, want) and flags
            and all(e <= 1e-5 for e in errs.values())):
        raise AssertionError(f"transparent eval (ICP {refine}): finite "
                             f"{finite}, launches {counts}, {errs}, {flags}")
    return counts, bs / ms * 1e3


def write_cleargrasp_tree(root: Path, copies: int = 4) -> Path:
    """tests/golden/cleargrasp's two frames, each `copies` times under new
    frame ids, as a train and a val split of cup-with-waves, with its
    mesh: 2 x copies instances a split."""
    src = ROOT / "tests" / "golden" / "cleargrasp"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(src / "models", root / "models")
    obj = "cup-with-waves"
    for split in ("train", "val"):
        for sub in (src / f"{obj}-train").iterdir():
            out = root / f"{obj}-{split}" / sub.name
            out.mkdir(parents=True)
            for f in sorted(sub.iterdir()):
                stem, rest = f.name.split("-", 1)
                for c in range(copies):
                    shutil.copy(f, out / f"{int(stem) + 2 * c:06d}-{rest}")
    return root


def run_transparent_cli(want_step, want_eval, config="transparent_cleargrasp",
                        name="transparent"):
    """Phases 15(e) and 16(e): the training CLI on the ClearGrasp fixture
    at `config` (the shipped preset, or a file; one debug epoch: 1 step of
    8, one eval batch), then tools/eval_transparent.py --ckpt from its
    checkpoint on the val split; their launch counts. Outputs under
    build/smoke/<name>."""
    import torch
    from pose_estimation_tpu_torch import cli
    from pose_estimation_tpu_torch.tools import eval_transparent
    out = ROOT / "build" / "smoke" / name
    tree = write_cleargrasp_tree(out / "cleargrasp")
    run_dir = out / "cli_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["--config", config, "--dataset_root", str(tree), "--debug",
              "--epochs", "1", "--log_dir", str(run_dir)])
    torch.cuda.synchronize()
    wall, counts = time.perf_counter() - t0, read_counts()
    train, evals = _lines(run_dir / "train.jsonl"), _lines(
        run_dir / "eval.jsonl")
    log(f"  cli.py --dataset cleargrasp (8 instances, bs 8): {len(train)} "
        f"train record(s), first {train[0]}; eval {evals[-1]}; {wall:.1f} s")
    _check_counts("the CLI run", counts, {"train steps": (1, want_step),
                                          "eval batches": (1, want_eval)})
    if not (math.isfinite(train[0]["all_loss"]) and evals
            and evals[-1]["count"] == 8 and "add_dis" in evals[-1]):
        raise AssertionError("transparent CLI: no train or eval records")
    reset_counts()
    summary = eval_transparent.main(
        ["--config", config, "--ckpt",
         str(run_dir / "ckpt"), "--dataset_root", str(tree), "--log_dir",
         str(out / "eval_tool")])
    torch.cuda.synchronize()
    tool_counts = read_counts()
    log(f"  tools/eval_transparent.py --ckpt on the val split: "
        f"{summary['overall']}")
    _check_counts("the eval tool", tool_counts,
                  {"eval batches": (1, want_eval)})
    if summary["overall"]["count"] != 8:
        raise AssertionError(f"eval tool: {summary['overall']}")
    return counts, tool_counts


def _transparent_trainer_run(cfg, ds, log_dir, dev, steps):
    """TransparentTrainer.train_epoch for `steps` steps: each step's
    metrics and launches."""
    import torch
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        TransparentTrainer)
    shutil.rmtree(log_dir, ignore_errors=True)
    tr = TransparentTrainer(cfg, ds, log_dir=str(log_dir), device=str(dev))
    tr.init_state()
    recorded, inner = [], tr.train_step

    def step(state, batch):
        reset_counts()
        m = inner(state, batch)
        torch.cuda.synchronize()
        recorded.append(({k: v.item() for k, v in m.items()}, read_counts()))
        return m

    tr.train_step = step
    tr.train_epoch(0, steps=steps)
    if len(recorded) != steps:
        raise AssertionError(f"the transparent trainer ran {len(recorded)} "
                             "steps")
    return recorded


def transparent_group_of_one(cfg, ds, dev, steps=2):
    """Phase 15(f): the transparent trainer in a 1-process NCCL group
    against no group: the first step's loss terms bit for bit (the
    gradient norm at phase 14's MGPU_FIRST_NORM_TOL: the card's backward
    accumulates with atomics)."""
    from pose_estimation_tpu_torch.parallel import dist
    out_dir = ROOT / "build" / "smoke" / "transparent"
    ref = _transparent_trainer_run(cfg, ds, out_dir / "nogroup", dev, steps)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.distributed_init(backend, f"tcp://localhost:{_free_port()}",
                                 1, 0):
        raise AssertionError(f"no {backend} group")
    try:
        got = _transparent_trainer_run(cfg, ds, out_dir / "group", dev, steps)
    finally:
        dist.destroy()
    first = {k: v for k, v in got[0][0].items() if k != "grad_norm"}
    want = {k: v for k, v in ref[0][0].items() if k != "grad_norm"}
    d_norm = abs(got[0][0]["grad_norm"] - ref[0][0]["grad_norm"]) / max(
        1.0, ref[0][0]["grad_norm"])
    log(f"  transparent trainer, {backend} group of one against no group, "
        f"{steps} steps at bs {cfg.train.batch_size}: first step's loss "
        f"terms bit for bit {first == want}, gradient norm rel |delta| "
        f"{d_norm:.3e}; losses {[m['all_loss'] for m, _ in got]} (no group "
        f"{[m['all_loss'] for m, _ in ref]}); launches a step "
        f"{got[0][1]}")
    if not (first == want and d_norm <= MGPU_FIRST_NORM_TOL
            and all(launches_match(c, TRANSPARENT_TRAIN)
                    for _, c in ref + got)):
        raise AssertionError("transparent trainer: group of one vs no group")
    return got[0][1]


def transparent_full_width(dev):
    """Phase 15: schema.transparent_cleargrasp() on the card (bf16,
    bs 8, seeded weights, synthetic frames at 256 px): (a) kernel 4 at the
    loss's and ICP's shapes, (b) a step with the kernel against the plain
    versions, its launches, (c) 30 steps on one batch, (d) the eval step
    with and without ICP, (e) the CLI and the eval tool on the ClearGrasp
    fixture, (f) the trainer in a 1-process NCCL group. Returns
    (kernel 4's row at the loss's shape, launches by path)."""
    import torch
    from pose_estimation_tpu_torch.configs import schema
    t_phase = time.perf_counter()
    cfg = schema.transparent_cleargrasp()
    bs, n_pts = cfg.train.batch_size, cfg.data.num_points
    m = min(500, n_pts)
    g = torch.Generator(device=dev).manual_seed(15)
    log("  (a) kernel 4 at the loss's and ICP's shapes")
    row = check_transparent_kernel(dev, g, bs, n_pts * m, m)

    from pose_estimation_tpu_torch.data.transparent_batching import (
        make_transparent_batch)
    batch = {k: v.to(dev) for k, v in make_transparent_batch(
        _transparent_dataset(cfg), list(range(bs)), seed=0,
        img_size=cfg.data.input_size, num_model=m).items()}
    state, step = _transparent_setup(cfg, dev)
    prec = "bf16" if cfg.train.amp else "fp32"
    log(f"  (b) one step (bs {bs}, {prec}, {n_pts} points, {m} model "
        f"points, {cfg.data.input_size} px) with the kernel against the "
        "plain versions")
    _transparent_step_vs_plain(state, step, batch)
    paths = {"transparent_train": _counted_transparent_step(
        state, step, batch, TRANSPARENT_TRAIN)}

    log(f"  (c) {TRANSPARENT_STEPS} steps on one batch at lr 3e-4")
    med, (fwd, bwd, opt), peak, _ = _transparent_train_run(
        state, step, batch, TRANSPARENT_STEPS)
    log(f"  transparent train step (bs={bs}, {prec}), median of "
        f"{TRANSPARENT_STEPS - 5}: {med:.2f} ms = {bs / med * 1e3:.2f} "
        f"samples/s; split (median of 5, synced between stages): forward + "
        f"loss {fwd:.2f} ms, backward {bwd:.2f} ms, guard + optimizer "
        f"{opt:.2f} ms; peak memory {peak:.2f} GiB")
    profile_steps(lambda: step(state, batch), 3)

    log("  (d) the eval step at bs 8, ICP off and on")
    model = state.model
    paths["transparent_eval"], fps = _transparent_eval(
        model, batch, False, TRANSPARENT_EVAL)
    paths["transparent_eval_icp"], fps_icp = _transparent_eval(
        model, batch, True, TRANSPARENT_EVAL_ICP)
    del state, step, model, batch
    torch.cuda.empty_cache()

    log("  (e) the training CLI and tools/eval_transparent.py on the "
        "ClearGrasp fixture (the shipped config)")
    paths["transparent_cli"], paths["transparent_eval_tool"] = \
        run_transparent_cli(TRANSPARENT_TRAIN, TRANSPARENT_EVAL)

    log("  (f) the transparent trainer in a 1-process NCCL group")
    paths["transparent_nccl_group"] = transparent_group_of_one(
        cfg, _transparent_dataset(cfg, frames_per_object=4), dev)
    row.update(train_step_ms=med, samples_s=bs / med * 1e3,
               eval_frames_s=fps, eval_icp_frames_s=fps_icp,
               peak_gib=peak)
    log(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return row, paths


# ---------------------------------------------------------------------------
# Phase 16: the PSPNet generation (transparent_model="posenet")
# ---------------------------------------------------------------------------

POSENET_CONFIG = ("schema.override(schema.transparent_cleargrasp(),\n"
                  "                           **{'module.transparent_model':"
                  " 'posenet'})")
POSENET_STEPS = 30
# (d): the options the shipped config leaves off, (family, keywords)
POSENET_OPTIONS = (("trpes", {"use_transformer": True}),
                   ("trpes", {"use_equalized": True}),
                   ("posenet", {"use_transformer": True}))


def posenet_full_width(dev):
    """Phase 16: the PSPNet generation at schema.transparent_cleargrasp()
    with transparent_model="posenet" on the card (bf16, bs 8, seeded
    weights, synthetic frames at 256 px): (a) a step with the kernel
    against the plain versions and its launches, (b) 30 steps on one
    batch, (c) the eval step with and without ICP, (d) one step of each
    model option, (e) the CLI and the eval tool on the ClearGrasp fixture
    with a posenet config. Returns (the phase's numbers, launches by
    path)."""
    import torch
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.data.transparent_batching import (
        make_transparent_batch)
    from pose_estimation_tpu_torch.train.transparent_trainer import FAMILIES
    t_phase = time.perf_counter()
    cfg = schema.override(schema.transparent_cleargrasp(),
                          **{"module.transparent_model": "posenet"})
    bs, n_pts = cfg.train.batch_size, cfg.data.num_points
    m = min(500, n_pts)
    prec = "bf16" if cfg.train.amp else "fp32"
    dtype = torch.bfloat16 if cfg.train.amp else torch.float32
    batch = {k: v.to(dev) for k, v in make_transparent_batch(
        _transparent_dataset(cfg), list(range(bs)), seed=0,
        img_size=cfg.data.input_size, num_model=m).items()}
    state, step = _transparent_setup(cfg, dev)
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"  (a) one TransparentPoseNet step ({n_params / 1e6:.2f} M "
        f"parameters; bs {bs}, {prec}, {n_pts} points, {m} model points, "
        f"{cfg.data.input_size} px) with the kernel against the plain "
        "versions, from the same pixels and dropout masks")
    got, _ = _transparent_step_vs_plain(state, step, batch)
    if not got["loss_b"] > 0:
        raise AssertionError(f"the boundary term is {got['loss_b']}")
    paths = {"posenet_train": _counted_transparent_step(
        state, step, batch, TRANSPARENT_TRAIN)}

    log(f"  (b) {POSENET_STEPS} steps on one batch at lr 3e-4 (dropout on)")
    med, (fwd, bwd, opt), peak, losses = _transparent_train_run(
        state, step, batch, POSENET_STEPS)
    rises = sum(b > a for a, b in zip(losses, losses[1:]))
    log(f"  PSPNet train step (bs={bs}, {prec}), median of "
        f"{POSENET_STEPS - 5}: {med:.2f} ms = {bs / med * 1e3:.2f} "
        f"samples/s; split (median of 5, synced between stages): forward + "
        f"loss {fwd:.2f} ms, backward {bwd:.2f} ms, guard + optimizer "
        f"{opt:.2f} ms; peak memory {peak:.2f} GiB; the loss rose on "
        f"{rises} of {POSENET_STEPS - 1} steps")
    profile_steps(lambda: step(state, batch), 3)

    log("  (c) the eval step at bs 8, ICP off and on")
    paths["posenet_eval"], fps = _transparent_eval(
        state.model, batch, False, TRANSPARENT_EVAL)
    paths["posenet_eval_icp"], fps_icp = _transparent_eval(
        state.model, batch, True, TRANSPARENT_EVAL_ICP)
    del state, step
    torch.cuda.empty_cache()

    log("  (d) one step of each option the shipped config leaves off")
    options = {}
    for family, kw in POSENET_OPTIONS:
        label = (f"{FAMILIES[family].__name__}("
                 f"{', '.join(f'{k}=True' for k in kw)})")
        st, sp = _transparent_setup(cfg, dev, lambda: FAMILIES[family](
            num_points=n_pts, num_obj=cfg.module.num_cls, dtype=dtype, **kw))
        log(f"  {label}:")
        _transparent_step_vs_plain(st, sp, batch)
        paths[f"{family}_{'_'.join(kw)}"] = _counted_transparent_step(
            st, sp, batch, TRANSPARENT_TRAIN)
        options[label] = _median([_sync_ms(lambda: sp(st, batch))[1]
                                  for _ in range(3)])
        log(f"  {label}: train step {options[label]:.2f} ms (median of 3)")
        del st, sp
        torch.cuda.empty_cache()
    del batch

    log("  (e) the training CLI and tools/eval_transparent.py on the "
        "ClearGrasp fixture with a posenet config")
    paths["posenet_cli"], paths["posenet_eval_tool"] = run_transparent_cli(
        TRANSPARENT_TRAIN, TRANSPARENT_EVAL,
        str(write_config(POSENET_CONFIG, "posenet_config")), "posenet")
    log(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return ({"train_step_ms": med, "samples_s": bs / med * 1e3,
             "eval_frames_s": fps, "eval_icp_frames_s": fps_icp,
             "peak_gib": peak, "option_step_ms": options}, paths)


# ---------------------------------------------------------------------------
# Phase 17: the tools on the card
# ---------------------------------------------------------------------------

TOOLS_DIR = ROOT / "build" / "smoke" / "tools"
# parity_check's cross-backend limits, card against CPU, on each row's
# median (PERF.md section 6): EPnP's PCA control points nearly tie
# on the tool's cube scenes, and the Umeyama pose, exact to fp32, is read
# through arccos near 0 degrees
PARITY_TOL = {"epnp_deg": 0.05, "epnp_m": 5e-4, "ransac_deg": 0.01,
              "ransac_m": 1e-4, "umeyama_deg": 0.1, "umeyama_m": 1e-5,
              "rot_roundtrip": 1e-5}
REFINE_TOL = 1e-4
CONVERGENCE_ARGS = ["--epochs", "2", "--frames_per_object", "16"]
TRANSPARENT_TOOL_ARGS = ["--epochs", "2", "--frames_per_object", "8",
                         "--refine"]
OVERLAY_CROPS = 4               # the overlay's crops at phase 8's bs of 8


def check_tb_run(run_dir: Path) -> None:
    """(a): a training run's event files, parsed with the port's framing
    (every CRC checked), hold each float of its JSONL records under its
    tag and step; the eval stream holds the overlay, and
    viz/epoch_0000.png decodes to the grid's shape."""
    import cv2

    from pose_estimation_tpu_torch.utils.tb import read_events
    for name in ("train", "eval"):
        (path,) = (run_dir / "tb" / name).iterdir()
        events = read_events(str(path))
        got = {(e["step"], tag) for e in events for tag, _ in e["values"]}
        want = {(r["step"], k) for r in _lines(run_dir / f"{name}.jsonl")
                for k, v in r.items()
                if k not in ("step", "time") and isinstance(v, float)}
        if not want or not want <= got:
            raise AssertionError(f"tb/{name}: {sorted(want - got)[:5]} "
                                 "missing")
        log(f"  tb/{name}: {len(events)} records, {len(got)} (step, tag) "
            f"pairs, every CRC checked")
    images = [v for e in events for tag, v in e["values"]
              if tag == "eval/pred_vs_gt"]
    grid = cv2.imread(str(run_dir / "viz" / "epoch_0000.png"))
    if not images or grid is None:
        raise AssertionError("the eval overlay is missing")
    shape = (images[0]["height"], images[0]["width"], 3)
    if grid.shape != shape or grid.shape[1] != OVERLAY_CROPS * grid.shape[0]:
        raise AssertionError(f"overlay {grid.shape}, its image {shape}")
    log(f"  viz/epoch_0000.png: {grid.shape} ({OVERLAY_CROPS} crops), as "
        "the event file's image")


def _parity(report: dict) -> None:
    """(b): the round trips and each cross-backend median delta."""
    for name, rows in report["backends"].items():
        if rows["rot_roundtrip"]["max"] > PARITY_TOL["rot_roundtrip"]:
            raise AssertionError(f"{name}: rotation round trip "
                                 f"{rows['rot_roundtrip']['max']}")
    delta = report["cross_backend_delta"]
    log(f"  cross-backend median deltas {delta}; limits {PARITY_TOL}")
    bad = {k: v for k, v in delta.items() if v > PARITY_TOL[k]}
    if bad:
        raise AssertionError(f"parity_check deltas over their limits: {bad}")


def _refine_close(a: dict, b: dict) -> float:
    """The largest difference of two refine_declarative reports, each
    value's over max(1, |b's|): the mm and degree figures come from fp32
    poses whose translations are 0.6-1.1 m, where an ulp is 6e-5 mm."""
    pairs = [(a[p][k], b[p][k]) for p in ("before", "after") for k in a[p]]
    pairs.append((a["mean_residual_mm"], b["mean_residual_mm"]))
    return max(abs(x - y) / max(1.0, abs(y)) for x, y in pairs)


def _per_object_delta(a: dict, b: dict) -> float:
    if sorted(a) != sorted(b):
        raise AssertionError(f"objects {sorted(a)} != {sorted(b)}")
    return max(abs(a[c][k] - b[c][k]) for c in a for k in a[c])


def tools_on_the_card(dev):
    """Phase 17: (a) phase 8's run directory: the TensorBoard mirror and
    the overlay; (b) parity_check, card and CPU; (c) refine_declarative
    on the card against the port's CPU run; (d) train_synthetic_
    convergence (raw_xyz and flagship), --eval_from_ckpt and
    eval_solver_sweep on raw_xyz's checkpoint; (e) train_transparent_
    convergence with ICP. Outputs under build/smoke/tools, deleted at the
    end. Returns the launches by path."""
    import torch
    from pose_estimation_tpu_torch.tools import (
        eval_solver_sweep, parity_check, refine_declarative,
        train_synthetic_convergence as conv, train_transparent_convergence)
    t_phase = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    TOOLS_DIR.mkdir(parents=True)
    paths = {}

    log("  (a) the TensorBoard mirror and the overlay of phase 8's run")
    check_tb_run(ROOT / "build" / "smoke" / "train_run")

    log("  (b) tools/parity_check.py: 16 scenes x 128 points, the card "
        "and the CPU from the same draws")
    _parity(parity_check.main(["--out", str(TOOLS_DIR / "parity.json")]))

    log("  (c) tools/refine_declarative.py (16 frames, 10 deg / 20 mm, "
        "trim 0.3, 10 iterations), the card and the CPU")
    reset_counts()
    card, ms = _sync_ms(lambda: refine_declarative.main([]))
    paths["tool_refine"] = read_counts()
    cpu = refine_declarative.main(["--device", "cpu"])
    want = dict(NO_LAUNCH, min_dists=ICP_ITERS + 2)      # + 2 ADD(-S)
    _check_counts("refine_declarative", paths["tool_refine"],
                  {"the run": (1, want)})
    diff = _refine_close(card, cpu)
    log(f"  card {json.dumps(card)} in {ms:.0f} ms; CPU {json.dumps(cpu)}; "
        f"largest difference {diff:.3g} x max(1, |CPU's|) (limit "
        f"{REFINE_TOL})")
    if not card["after"]["trans_mm"] < card["before"]["trans_mm"]:
        raise AssertionError("ICP did not reduce the translation error")
    if diff > REFINE_TOL:
        raise AssertionError(f"refine_declarative card vs CPU: {diff}")

    log("  (d) tools/train_synthetic_convergence.py --variants "
        "raw_xyz,flagship " + " ".join(CONVERGENCE_ARGS))
    runs = TOOLS_DIR / "convergence"
    reset_counts()
    res = conv.main(CONVERGENCE_ARGS + [
        "--variants", "raw_xyz,flagship", "--log_root", str(runs),
        "--out", str(TOOLS_DIR / "results_synthetic.json")])
    torch.cuda.synchronize()
    paths["tool_convergence"] = read_counts()
    steps = sum(v["steps"] for v in res["variants"])
    evals = 2 * 128 // 16            # one test_epoch of 128 frames each
    _check_counts("train_synthetic_convergence", paths["tool_convergence"],
                  {"train steps": (steps, LITE_TRAIN),
                   "eval forwards": (evals, LITE_EVAL)})
    for v in res["variants"]:
        log(f"  {v['variant']}: {v['steps']} steps in {v['train_seconds']} s"
            f" = {v['train_fps']} samples/s; per object "
            f"{json.dumps(v['per_object'])}")
    raw = res["variants"][0]
    ckpt = str(runs / "raw_xyz" / "ckpt")
    reset_counts()
    again = conv.main(["--variants", "raw_xyz", "--eval_from_ckpt", ckpt,
                       "--log_root", str(TOOLS_DIR / "again"),
                       "--out", str(TOOLS_DIR / "again.json")])
    paths["tool_eval_from_ckpt"] = read_counts()
    delta = _per_object_delta(again["variants"][0]["per_object"],
                              raw["per_object"])
    log(f"  --eval_from_ckpt: the per-object table within {delta:.3g} of "
        "the run's")
    if delta > 1e-4:
        raise AssertionError(f"--eval_from_ckpt table off by {delta}")
    reset_counts()
    sweep = eval_solver_sweep.main(["--ckpt", ckpt, "--log_dir",
                                    str(TOOLS_DIR / "sweep")])
    paths["tool_sweep"] = read_counts()
    _check_counts("eval_solver_sweep", paths["tool_sweep"],
                  {"eval forwards": (4 * 128 // 16, LITE_EVAL)})
    log(f"  eval_solver_sweep: {json.dumps(sweep)}")

    log("  (e) tools/train_transparent_convergence.py "
        + " ".join(TRANSPARENT_TOOL_ARGS))
    reset_counts()
    tres = train_transparent_convergence.main(TRANSPARENT_TOOL_ARGS + [
        "--log_root", str(TOOLS_DIR / "transparent"),
        "--out", str(TOOLS_DIR / "results_transparent.json")])
    paths["tool_transparent"] = read_counts()
    _check_counts("train_transparent_convergence", paths["tool_transparent"],
                  {"train steps": (tres["steps"], TRANSPARENT_TRAIN),
                   "eval batches with ICP": (128 // 16,
                                             TRANSPARENT_EVAL_ICP)})
    log(f"  trpes: {tres['steps']} steps in {tres['train_seconds']} s = "
        f"{tres['train_fps']} samples/s; {json.dumps(tres['overall'])}")
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    log(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return paths


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--split-from", metavar="DIR",
                    help="only build and print phase 3's kernel split for "
                         "the package under DIR (an unpacked earlier "
                         "commit, say), for a before/after on one card")
    args = ap.parse_args(argv)
    pkg_root = Path(args.split_from).resolve() if args.split_from else ROOT
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (pkg_root / "pose_estimation_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no checkout of the repository at {pkg_root}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(pkg_root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_line()
    t_start = time.perf_counter()

    log(f"[1] device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    from pose_estimation_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
        f"(hash {_build.source_hash()}) from {pkg_root}")
    if args.split_from:
        log("[3] kernel split only")
        print(json.dumps({"split_from": str(pkg_root), "card": card,
                          "split": kernel_split(dev)}))
        return 0
    for name, (regs, spill, n) in ptxas_summary(_build.build_log).items():
        log(f"    ptxas {name}: {n} instantiation(s), at most {regs} "
            f"registers, {spill} bytes spilled in all")
    sass = sass_counts(("HGMMA", "HFMA2", "HMUL2", "HADD2", "HMNMX2"))
    log("    HGMMA instructions in the SASS: " + (", ".join(
        f"{k} {sum(v for o, v in c.items() if o.startswith('HGMMA'))}"
        for k, c in sass.items() if any(o.startswith("HGMMA") for o in c))
        or "none"))
    if not any(o.startswith("HGMMA") for o in sass.get("table_wgmma_kernel",
                                                         {})):
        raise AssertionError("kernel 1's table pass has no HGMMA")
    # kernel 5's packed bf16 arithmetic (all instantiations): an HFMA2 with
    # a product and a sum of two variables would be a fused multiply-add
    log(f"    packed half-precision instructions in wide_agg_kernel: "
        f"{sass.get('wide_agg_kernel', {})}")

    log("[3] kernels vs plain versions (bs=32 serving shapes; bs=8 train "
        "shapes for min_dists)")
    g = torch.Generator(device=dev).manual_seed(0)
    results = {"linear_multi": check_linear(dev, g),
               "surface_multi": check_surface(dev, g),
               "knn": check_knn(dev, g),
               "min_dists": check_min_dists(dev, g),
               "aggregate": check_aggregate(dev, g),
               "resize_bilinear": check_resize(dev, g),
               "ranger_apply": check_ranger(dev, g)}
    split = kernel_split(dev)
    for name, _ in AGG_SHAPES:
        row = split[f"aggregate {name}"]
        device = row.get("wide_agg_kernel", 0.0)
        r = results["aggregate"]
        (r if name == "fm_4" else r["profiler_shape"])["device_ms"] = device

    from pose_estimation_tpu_torch.configs import schema
    cfg = schema.Config()
    log("[4] pose stage on ground-truth coordinates (synthetic bs=32)")
    batch = synthetic_batch(cfg, dev)
    check_solver_on_gt(cfg, batch, dev)

    log("[5] full-width KRRN (schema.Config(), bf16) through "
        "serve.build_infer_step")
    paths = {"serve_lite": serve_full_width(cfg, batch, dev)}

    log("[6] serving CLI, 64 synthetic frames at batch 32")
    run_cli(cfg)

    log("[7] full-width KRRN training step (schema.Config(), bf16, bs=8)")
    paths["train_lite"] = train_full_width(cfg, dev)

    log("[8] training CLI, one debug epoch (synthetic, pose branch on)")
    run_train_cli()

    log("[9] full-fusion KRRN (schema.Config(), fusion_variant='full', "
        "bf16) through serve.build_infer_step")
    paths["serve_full"] = serve_full_width(
        cfg, batch, dev, "full", dict(FULL_SERVE, **SHIPPED_RESIZES))

    log("[10] full-fusion KRRN at S=2 (wide fm_4): one serving forward, "
        "one train step (bs=8)")
    paths["serve_full_s2"], paths["train_full_s2"] = full_fusion_s2(
        cfg, batch, dev)

    log("[11] tools/profile_eval, in full")
    run_profiler()

    log("[12] the LineMOD path: a BOP tree of PNG files, the training CLI, "
        "its eval mode, the serving CLI and eval_standalone (schema.Config(),"
        " bf16, bs=8)")
    paths["cli_linemod"] = run_linemod_cli()

    log("[13] the training options off in the shipped config: BatchNorm, "
        "the refine loss, Adam (schema.Config(), bf16, bs=8), serving on "
        "the running statistics, the rotation heads")
    (paths["train_options"], paths["serve_options"],
     paths["rot_forward"]) = train_options_full_width(cfg, batch, dev)

    log("[14] multi-GPU training on the one card (schema.Config(), bf16): "
        "a 1-process NCCL group, two processes sharing the card, the ring "
        "ops")
    paths.update(multi_gpu_one_card(cfg, dev))

    log("[15] the transparent pipeline (schema.transparent_cleargrasp(), "
        "bf16, bs=8): kernel 4 at 500,000 x 500, the train step, 30 steps, "
        "the eval with ICP, the CLI and eval tool on the ClearGrasp fixture,"
        " a 1-process NCCL group")
    transparent_row, transparent_paths = transparent_full_width(dev)
    paths.update(transparent_paths)
    results["min_dists"]["transparent_loss"] = transparent_row

    log("[16] the PSPNet generation (transparent_model='posenet', bf16, "
        "bs=8): the train step, 30 steps, the eval with ICP, the model "
        "options, the CLI and eval tool on the ClearGrasp fixture")
    posenet_row, posenet_paths = posenet_full_width(dev)
    paths.update(posenet_paths)
    results["min_dists"]["posenet"] = posenet_row

    log("[17] the tools on the card: the TensorBoard mirror and overlays, "
        "parity_check, refine_declarative, the convergence tools and the "
        "solver sweep")
    paths.update(tools_on_the_card(dev))

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "optax",
                                           "pose_estimation_tpu"))
    if loaded:
        raise AssertionError(f"the JAX side was imported: {loaded[:5]}")

    kernels = []
    for name, (src, tpu) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu,
                        "launches": paths["train_full_s2"].get(name),
                        "launches_by_path": {p: c.get(name)
                                             for p, c in paths.items()},
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        **{k: r[k] for k in ("device_ms", "profiler_shape",
                                             "serving_maps",
                                             "transparent_loss", "posenet",
                                             "shapes")
                           if k in r}})
    log(f"chip_smoke: all 17 phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Rank processes of tests/test_torch_dist.py.

Each rank joins a gloo group through the port's distributed_init on a
FileStore (no port to clash over between test workers), runs the port's
multi-process paths on the CPU at the tiny config of the verify recipe,
and saves what it saw (torch.save, <out_dir>/<task>_<rank>.pt) for the
test process to hold against the JAX package and against one process.
It imports torch, numpy and the port only.

The injected training draws (`injected_draws`) are the test's own: the
PoolLayer permutations `pool_perm(i, n)` in call order and one dropout
mask at the global batch's shape, which the test also hands to the JAX
step; the RANSAC subsets go in as `subset_ids`.
"""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import torch

TINY_STAGES = ((1, 1, (8, 8)), (1, 1, (8, 8, 16)), (1, 1, (8, 8, 16, 16)))
TOTAL_STEPS = 40
VARIANTS = {"gn": {},
            "bn_refine": {"module.norm": "bn", "train.refine": True}}
KEEP_SEED, SUBSET_SEED = 7, 11


def overrides(schema) -> dict:
    """The verify recipe's tiny model (fp32) in `schema`'s types: the
    port's or the JAX package's config module."""
    return {
        "module.num_cls": 2, "data.num_regions": 8, "data.num_points": 128,
        "data.input_size": 64, "module.backbone_outc": 16,
        "module.stem_width": 8, "module.hrnet_stages": TINY_STAGES,
        "module.xyznet": schema.HeadConfig(hidden=16),
        "module.nmlnet": schema.HeadConfig(hidden=16),
        "module.gcn3d": schema.Gcn3dConfig(neighbor_num=4, support_num=2),
        "train.batch_size": 4, "train.amp": False,
        "train.lr.lr": 1e-3, "train.lr.warmup_iters": 0,
        "eval.num_pnp_points": 32, "eval.pnp_hypotheses": 8,
        "eval.refine_top_k": 2}


def config(schema, variant: str):
    return schema.override(schema.Config(dataset="synthetic"),
                           **overrides(schema), **VARIANTS[variant])


def pool_perm(i: int, n: int) -> np.ndarray:
    """The i-th PoolLayer permutation of a forward (n points)."""
    return np.random.RandomState(100 + i).permutation(n)


def keep_mask(shape) -> np.ndarray:
    """TBase's dropout keep mask at the global batch's shape."""
    return np.random.RandomState(KEEP_SEED).rand(*shape) < 0.8


def subsets(b: int, h: int, n: int, size: int = 6) -> np.ndarray:
    """[b, h, size] RANSAC subsets of distinct points of n."""
    rng = np.random.RandomState(SUBSET_SEED)
    return np.stack([[rng.permutation(n)[:size] for _ in range(h)]
                     for _ in range(b)]).astype(np.int64)


@contextlib.contextmanager
def injected_draws(keep: np.ndarray):
    """The port's training forward with the PoolLayer samples taken from
    pool_perm in call order and TBase's dropout mask `keep` (global
    batch; each rank keeps its rows, as dropout() does)."""
    from pose_estimation_tpu_torch.models import gcn3d, posenet
    calls = [0]
    pool_fwd, drop = gcn3d.PoolLayer.forward, posenet.dropout

    def pool(self, vertices, feature_map, sample=None, generator=None):
        if sample is None and generator is not None:
            n = vertices.shape[-2]
            sample = torch.from_numpy(
                pool_perm(calls[0], n)[:n // self.pooling_rate])
            calls[0] += 1
        return pool_fwd(self, vertices, feature_map, sample, generator)

    gcn3d.PoolLayer.forward = pool
    posenet.dropout = lambda x, rate, generator=None, k=None: drop(
        x, rate, generator, torch.from_numpy(keep))
    try:
        yield
    finally:
        gcn3d.PoolLayer.forward, posenet.dropout = pool_fwd, drop


def port_setup(variant: str, gen_seed: int = 0, dtype=torch.float32):
    """(state, step) of the tiny port model, its weights seeded 1, its
    parameters and activations in `dtype`."""
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.models.krrn import KRRN
    from pose_estimation_tpu_torch.train.optim import make_optimizer
    from pose_estimation_tpu_torch.train.state import TrainState
    from pose_estimation_tpu_torch.train.train_step import build_train_step
    cfg = config(schema, variant)
    torch.manual_seed(1)
    model = KRRN(cfg, dtype=dtype).to(dtype)
    tx = make_optimizer(cfg, total_steps=TOTAL_STEPS)
    state = TrainState.create(model, tx,
                              torch.Generator().manual_seed(gen_seed))
    return state, build_train_step(model, tx, cfg)


def posed_batch(batch: dict, variant: str, noise_px: float = 0.05) -> dict:
    """`batch` with xy_choosed made the projections, at a pose 0.2 rad and
    3.7 cm off the ground truth plus `noise_px` of seeded noise, of the
    points that the refine loss reads off the seeded model's xyz_emb in
    training mode: a PnP problem with one clear solution, whose ADD to
    the ground truth the refine loss then measures. On the random model's raw
    coordinates RANSAC is ill-posed: hypotheses tie on inlier counts and
    rounding picks the winner (tests/test_torch_train_options.py's refine
    test uses near-truth coordinates for the same reason)."""
    from pose_estimation_tpu_torch.data.pipeline import denormalize_xyz
    state, _ = port_setup(variant)
    tb = local_batch(batch)
    with torch.no_grad():
        out = state.model(tb["img"], tb["cloud"], tb["choose"], tb["cls"],
                          opt_pose=False, train=True)
        pw = denormalize_xyz(out["xyz_emb"].float(), tb["lf_border"],
                             tb["extent"])
        c, s_ = np.cos(0.2), np.sin(0.2)
        off = torch.tensor([[c, -s_, 0], [s_, c, 0], [0, 0, 1]],
                           dtype=torch.float32)
        r = tb["target_r"] @ off
        t = tb["target_t"] + torch.tensor([0.02, -0.01, 0.03])
        cam = pw @ r.transpose(1, 2) + t[:, None]
        proj = cam @ tb["k"].transpose(1, 2)
        uv = proj[..., :2] / proj[..., 2:]
    rng = np.random.RandomState(13)
    uv = uv.numpy() + noise_px * rng.randn(*uv.shape).astype(np.float32)
    return dict(batch, xy_choosed=uv.astype(np.float32))


def local_batch(batch: dict, dtype=torch.float32) -> dict:
    """This rank's rows of a global numpy batch, as torch tensors, the
    floating ones in `dtype`."""
    from pose_estimation_tpu_torch.parallel import dist
    out = {}
    for k, v in batch.items():
        t = dist.rank_rows(torch.from_numpy(np.array(v)))
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return out


def snapshot(state, metrics: dict) -> dict:
    from pose_estimation_tpu_torch import convert
    params, stats = convert.flax_trees(state.model)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": params, "stats": stats, "step": state.step,
            "generator": state.generator.get_state()}


def step_injected(variant: str, batch: dict) -> dict:
    """One step with the injected draws (the JAX comparison)."""
    state, step = port_setup(variant)
    b = next(iter(batch.values())).shape[0]
    keep = keep_mask((b, batch["cloud"].shape[1], 256))
    sub = torch.from_numpy(subsets(b, 8, 128))
    tb = local_batch(batch)
    with injected_draws(keep):
        losses = step.losses(tb, True, True, state.generator,
                             sub if step.refine_loss else None)
        metrics = step.apply(state, losses, step.gradients(losses))
    return snapshot(state, metrics)


def step_seeded(variant: str, batch: dict, steps: int = 2,
                dtype=torch.float32) -> dict:
    """`steps` steps with the generator's own draws, seeded 5 on every
    rank (the one-process comparison), in `dtype`."""
    state, step = port_setup(variant, gen_seed=5, dtype=dtype)
    tb = local_batch(batch, dtype)
    out = []
    for _ in range(steps):
        out.append(snapshot(state, step(state, tb, opt_pose=True,
                                        train=True)))
    return {"steps": out}


def bn_conditioning(batch: dict, dtype=torch.float32) -> dict:
    """The BatchNorm + refine model's step gradient norm in `dtype` (the
    generator seeded 5, the gradient averaged over the group), and in
    bf16 the training forward's BatchNorm outputs and xyz_emb, this
    rank's rows."""
    from pose_estimation_tpu_torch.models.layers import BatchNorm
    state, step = port_setup("bn_refine", gen_seed=5, dtype=dtype)
    losses = step.losses(local_batch(batch, dtype), True, True,
                         state.generator)
    grads = step.gradients(losses)
    norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                for g in grads.values())))
    bf16, _ = port_setup("bn_refine", dtype=torch.bfloat16)
    outs = []
    for m in bf16.model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(
                lambda mod, x, y: outs.append(y.detach().float()))
    tb = local_batch(batch)
    with torch.no_grad():
        out = bf16.model(tb["img"], tb["cloud"], tb["choose"], tb["cls"],
                         opt_pose=False, train=True)
    return {"grad_norm": norm, "bn_outputs": outs,
            "xyz_emb": out["xyz_emb"].float()}


def masked_means(payload: dict) -> dict:
    """masked_mean and map_loss('l1') on this rank's rows of arrays whose
    valid-pixel counts differ by rank: the value averaged over the group
    (what the step logs) and the gradient of the averaged objective."""
    from pose_estimation_tpu_torch.losses.map_loss import map_loss, masked_mean
    from pose_estimation_tpu_torch.parallel import dist
    pp, valid, pred, target = (dist.rank_rows(torch.from_numpy(payload[k]))
                               for k in ("pp", "valid", "pred", "target"))
    out = {"counts": dist.all_gather_array(
        np.array([int(valid.sum())]))[:, 0].tolist()}
    for name, x, fn in (
            ("masked_mean", pp, lambda t: masked_mean(t, valid.float())),
            ("l1", pred, lambda t: map_loss("l1", t, target, valid))):
        x = x.clone().requires_grad_()
        loss = fn(x)
        (g,) = torch.autograd.grad(loss, x)
        out[name] = float(dist.mean_dict({"v": loss.detach()})["v"])
        out[name + "_grad"] = (g / dist.world_size()).numpy()
    return out


def eval_merge(payload: dict) -> dict:
    """A per-object table fed this rank's rows (ragged: rank 0 two
    batches, rank 1 one), merged over the group."""
    from pose_estimation_tpu_torch.metrics.metric import PerObjectAccumulator
    from pose_estimation_tpu_torch.parallel import dist
    acc = PerObjectAccumulator(4)
    for cls, metrics in payload["eval_feeds"][dist.rank()]:
        acc.update(cls, metrics)
    return {"summary": acc.all_reduce_across_processes().summary()}


def trainer(payload: dict) -> dict:
    """The trainer on the uneven shards of tests/mp_worker.py (15 train
    and 9 test samples, bs 4, log directories of their own per rank):
    one epoch and one eval with the overlay on, then a second trainer on
    the same directories, where rank 0 finds a checkpoint and rank 1
    none."""
    from pose_estimation_tpu_torch.configs import schema
    from pose_estimation_tpu_torch.data.synthetic import SyntheticPoseDataset
    from pose_estimation_tpu_torch.parallel import dist
    from pose_estimation_tpu_torch.train.trainer import Trainer
    cfg = schema.override(config(schema, "gn"), **{
        "module.num_cls": 3, "train.eval_viz": True, "train.ckpt_every": 0,
        "train.num_epoch": 1})
    train = SyntheticPoseDataset(num_objects=3, frames_per_object=5,
                                 im_h=240, im_w=320, num_regions=8)
    test = SyntheticPoseDataset(num_objects=3, frames_per_object=3,
                                im_h=240, im_w=320, num_regions=8,
                                pose_seed=11)
    log_dir = os.path.join(payload["out_dir"], f"run_{dist.rank()}")
    tr = Trainer(cfg, train, test, log_dir=log_dir, device="cpu")
    tr.init_state()
    state = tr.train_epoch(0)
    summary = tr.test_epoch(0)
    files = sorted(f for f in os.listdir(log_dir) if f.endswith(".jsonl"))
    logged = sorted(os.path.relpath(os.path.join(d, f), log_dir)
                    for d, _, fs in os.walk(log_dir) for f in fs
                    if not d.startswith(os.path.join(log_dir, "ckpt")))
    again = Trainer(cfg, train, test, log_dir=log_dir, device="cpu")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        restored = again.init_state()
    return {"train_steps": state.step, "summary": summary, "files": files,
            "logged": logged,
            "ckpt_steps": tr.ckpt.steps(), "restored_step": restored.step,
            "printed": printed.getvalue(),
            "lr": [float(tr.tx.schedule(i)) for i in range(6)]}


def ring(payload: dict) -> dict:
    """ring_min_dists and ring_knn on this rank's shards."""
    from pose_estimation_tpu_torch.parallel import dist
    from pose_estimation_tpu_torch.parallel.ring_pointops import (
        ring_knn, ring_min_dists)
    tgt, src, pts = (dist.rank_rows(torch.from_numpy(payload[k]))
                     for k in ("tgt", "src", "pts"))
    dists, idx = ring_knn(None, payload["k"])(pts)
    return {"min_dists": ring_min_dists()(tgt, src).numpy(),
            "knn_dists": dists.numpy(), "knn_idx": idx.numpy()}


TASKS = {
    "injected_gn": lambda p: step_injected("gn", p["batch"]),
    "injected_bn_refine": lambda p: step_injected("bn_refine",
                                                  p["posed_batch"]),
    "seeded_gn": lambda p: step_seeded("gn", p["batch"]),
    "seeded_bn_refine": lambda p: step_seeded(
        "bn_refine", p["posed_batch"], dtype=torch.float64),
    "bn_conditioning": lambda p: bn_conditioning(p["posed_batch"]),
    "masked_means": masked_means,
    "eval_merge": eval_merge,
    "trainer": trainer,
    "ring": ring,
}


def run(rank: int, world: int, store: str, tasks: list, payload: dict):
    """One rank: join the group, run `tasks`, save each one's result."""
    torch.set_num_threads(1)
    from pose_estimation_tpu_torch.parallel import dist
    if not dist.distributed_init("gloo", f"file://{store}", world, rank):
        raise RuntimeError("distributed_init did not join the group")
    try:
        for name in tasks:
            torch.save(TASKS[name](payload),
                       os.path.join(payload["out_dir"], f"{name}_{rank}.pt"))
    finally:
        dist.destroy()

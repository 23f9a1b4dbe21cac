"""The transparent pipeline's train step, eval step and trainer
(counterpart of train/transparent_trainer.py), for both generations of
the transparent model (cfg.module.transparent_model: "trpes", TRPESNet on
the UNet; "posenet", TransparentPoseNet on the PSPNet), on one device or
on each rank of a process group (parallel.dist) with the JAX step's
global-batch semantics.

  batch -> the model's forward at its training draws from the state's
  generator (TRPESNet: `choose` = torch.randperm(H*W)[:n], one set for
  the whole batch, drawn alike on every rank; TransparentPoseNet: `choose`
  [B, n] drawn per sample with replacement, then the decoder's seven
  dropout masks, each at the global batch's shape, dist.draw_rows) ->
  transparent_loss (with TransparentPoseNet's boundary term) -> gradients
  (averaged over the group in one flat buffer) -> NaN guard -> Ranger or
  Adam update, in place

(TrainStep's stages and guard, the total under "all_loss"). The eval
step picks each sample's most confident hypothesis, converts it from
allocentric to egocentric, scores ADD(-S), the rotation and the
translation error, and with `refine_icp` runs the gated ICP of the model
points against the back-projected completed depth at the pixels of the
highest predicted mask. Kernel 4 launches once a train step (the
symmetric chamfer) and once an eval batch (ADD-S), 13 times with ICP (10
iterations, the two trimmed residuals in one launch, the refined pose's
ADD-S). The eval forward takes the strided pixels arange(n) *
max(hw // n, 1) % hw (for TransparentPoseNet broadcast to [B, n]) and no
dropout.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pose_estimation_tpu_torch.configs.schema import Config
from pose_estimation_tpu_torch.core.geometry.allocentric import (
    allo_to_ego_matrix)
from pose_estimation_tpu_torch.core.geometry.rotations import (
    angular_distance, quat_to_matrix)
from pose_estimation_tpu_torch.core.solvers.icp import gated_icp_refine
from pose_estimation_tpu_torch.data.batching import (
    epoch_indices, eval_indices)
from pose_estimation_tpu_torch.data.prefetch import Prefetcher
from pose_estimation_tpu_torch.data.transparent_batching import (
    make_transparent_batch)
from pose_estimation_tpu_torch.losses.transparent_loss import (
    transparent_loss)
from pose_estimation_tpu_torch.metrics.metric import (
    PerObjectAccumulator, add_metric)
from pose_estimation_tpu_torch.models.pspnet import (
    DROPOUT_RATES, PSP_SIZES, TransparentPoseNet, dropout_shapes,
    feature_size)
from pose_estimation_tpu_torch.models.transparent import TRPESNet
from pose_estimation_tpu_torch.parallel import dist
from pose_estimation_tpu_torch.train.state import TrainState
from pose_estimation_tpu_torch.train.train_step import TrainStep
from pose_estimation_tpu_torch.train.trainer import Trainer, _generator
from pose_estimation_tpu_torch.utils.profiling import span, spanned

# cfg.module.transparent_model -> the model family
FAMILIES = {"trpes": TRPESNet, "posenet": TransparentPoseNet}


def loss_weights(cfg: Config) -> dict:
    """The config's loss weights under the transparent loss's names."""
    lw = cfg.train.loss
    return {"distance": lw.weight_pose, "rotation": lw.weight_region,
            "normal": lw.weight_normal, "depth": lw.weight_xyz,
            "mask": lw.weight_mask, "boundary": lw.weight_mask}


def build_model(cfg: Config, device="cpu"):
    """The config's transparent model, by cfg.module.transparent_model
    (FAMILIES), bf16 activations with train.amp. Another name, or
    TransparentPoseNet on a crop too small for its PSP pyramid, raises
    ValueError."""
    family = FAMILIES.get(cfg.module.transparent_model)
    if family is None:
        raise ValueError(f"transparent_model="
                         f"{cfg.module.transparent_model!r}: not one of "
                         f"{sorted(FAMILIES)}")
    if (family is TransparentPoseNet
            and feature_size(cfg.data.input_size) < max(PSP_SIZES)):
        raise ValueError(f"transparent_model='posenet' at "
                         f"data.input_size={cfg.data.input_size}: the PSP "
                         f"pyramid needs {max(PSP_SIZES)}x{max(PSP_SIZES)} "
                         "features, a crop of at least 48 px")
    dtype = torch.bfloat16 if cfg.train.amp else torch.float32
    return family(num_points=cfg.data.num_points,
                  num_obj=cfg.module.num_cls, dtype=dtype).to(device)


def eval_choose(hw: int, n: int, device) -> torch.Tensor:
    """The eval pixels: arange(n) * max(hw // n, 1) % hw."""
    return torch.arange(n, device=device) * max(hw // n, 1) % hw


def apply_transparent_model(model, batch: dict, choose=None,
                            masks=None) -> dict:
    """The model's outputs under the loss's names: quat, trans, conf,
    normal, depth, mask, and TransparentPoseNet's color and boundary.
    `choose` None: the eval pixels; `masks`: TransparentPoseNet's dropout
    keep masks in training (None: no dropout)."""
    args = (batch["img"], batch["intrinsic"], batch["xmap"], batch["ymap"],
            batch["d_scale"], batch["obj"])
    if isinstance(model, TransparentPoseNet):
        if choose is None:
            b, h, w, _ = batch["img"].shape
            choose = eval_choose(h * w, model.num_points,
                                 batch["img"].device).expand(b, -1)
        return model(*args, choose, masks)
    rx, tx, cx, n, d, m = model(*args, choose)
    return {"quat": rx, "trans": tx, "conf": cx, "normal": n, "depth": d,
            "mask": m}


def draw_choose(generator: torch.Generator, hw: int, n: int) -> torch.Tensor:
    """TRPESNet's training pixels: the first n of one permutation of H*W
    from `generator` (on its device), shared by the batch."""
    return torch.randperm(hw, generator=generator,
                          device=generator.device)[:n]


def draw_posenet(generator: torch.Generator, b: int, h: int, w: int,
                 n: int) -> tuple:
    """TransparentPoseNet's training draws from `generator` (on its
    device), this rank's rows of draws made at the global batch's shape
    (dist.draw_rows), in this order: the pixels [b, n], each sample's
    drawn with replacement (JAX's randint), then the decoder's seven
    dropout keep masks (dropout_shapes, kept with probability 1 - rate)."""
    dev = generator.device
    choose = dist.draw_rows(lambda s: torch.randint(
        0, h * w, s, generator=generator, device=dev), (b, n))
    masks = [dist.draw_rows(lambda s, r=rate: torch.rand(
        s, generator=generator, device=dev) < 1.0 - r, shape)
        for shape, rate in zip(dropout_shapes(b, h, w), DROPOUT_RATES)]
    return choose, masks


class TransparentTrainStep(TrainStep):
    """step(state, batch) -> metrics dict of 0-d device tensors (the loss
    terms, skipped_nonfinite, grad_norm); `weights` as loss_weights
    gives them. `draws(generator, batch)` makes the training draws of the
    model's family, and `losses(batch, choose, masks=None)` takes them
    explicitly (a test hands over the JAX step's)."""

    total = "all_loss"

    def __init__(self, model, tx, weights: dict):
        self.model, self.tx, self.weights = model, tx, weights

    def draws(self, generator: torch.Generator, batch: dict) -> tuple:
        """(choose, masks): TRPESNet's pixels and None, or
        TransparentPoseNet's draw_posenet."""
        b, h, w, _ = batch["img"].shape
        if isinstance(self.model, TransparentPoseNet):
            return draw_posenet(generator, b, h, w, self.model.num_points)
        return draw_choose(generator, h * w, self.model.num_points), None

    @spanned("train.losses")
    def losses(self, batch: dict, choose: torch.Tensor,
               masks: list | None = None) -> dict:
        with span("transparent.forward"):
            pred = apply_transparent_model(self.model, batch, choose, masks)
        with span("transparent.loss"):
            return transparent_loss(pred, batch, self.weights)

    @spanned("train.step")
    def __call__(self, state: TrainState, batch: dict) -> dict:
        losses = self.losses(batch, *self.draws(state.generator, batch))
        return self.apply(state, losses, self.gradients(losses))


def build_transparent_eval_step(model, refine_icp: bool = False,
                                icp_iters: int = 10, icp_trim: float = 0.3,
                                icp_points: int = 256,
                                icp_accept_margin: float = 0.15):
    """eval_step(batch) -> dict of [B, ...] tensors: add_dis, pred_r,
    pred_t, pred_normal / depth / mask, rot_deg, trans_m, and with
    refine_icp add_dis_icp, rot_deg_icp, trans_m_icp, icp_residual,
    icp_accepted, pred_r_icp, pred_t_icp. The pose in fp32 from the
    heads' values."""

    @torch.no_grad()
    def eval_step(batch: dict) -> dict:
        pred = apply_transparent_model(model, batch)
        conf = pred["conf"][..., 0]
        best = torch.argmax(conf, dim=1)
        take = lambda x: torch.gather(
            x, 1, best[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]
        quat, trans = take(pred["quat"]), take(pred["trans"])
        # in the heads' dtype, as the JAX step; the products below in fp32
        r_ego = allo_to_ego_matrix(trans, quat_to_matrix(quat)).float()
        trans = trans.float()
        dis = add_metric(r_ego, trans, batch["r"], batch["t"],
                         batch["model_points"], batch["sym_mask"])
        out = {"add_dis": dis, "pred_r": r_ego, "pred_t": trans,
               "pred_normal": pred["normal"], "pred_depth": pred["depth"],
               "pred_mask": pred["mask"],
               "rot_deg": angular_distance(r_ego, batch["r"]),
               "trans_m": torch.linalg.norm(trans - batch["t"], dim=-1)}
        if refine_icp:
            out.update(_icp(pred, batch, r_ego, trans, icp_iters, icp_trim,
                            icp_points, icp_accept_margin))
        return out

    return eval_step


def _icp(pred, batch, r_ego, trans, iters, trim, points, margin) -> dict:
    """The gated ICP of the eval step: the completed depth back-projected
    with the zoomed intrinsics (metres = depth x d_scale), the `points`
    pixels of the highest predicted mask (a stable descending sort: ties
    to the lower pixel, as lax.top_k) as the observed cloud."""
    d, m = pred["depth"], pred["mask"]
    b, hh, ww, _ = d.shape
    z = d[..., 0].float() * batch["d_scale"][:, None, None]
    fx, fy, cx, cy = (batch["intrinsic"][:, i, None, None] for i in range(4))
    px = (batch["xmap"] - cx) * z / fx
    py = (batch["ymap"] - cy) * z / fy
    cloud = torch.stack([px, py, z], -1).reshape(b, hh * ww, 3)
    score = m[..., 0].float().reshape(b, hh * ww)
    idx = torch.sort(score, dim=-1, descending=True,
                     stable=True).indices[:, :points]
    dst = torch.gather(cloud, 1, idx[..., None].expand(-1, -1, 3))
    r_out, t_out, accept, resid = gated_icp_refine(
        batch["model_points"].float(), dst, r_ego, trans, iters=iters,
        trim_fraction=trim, accept_margin=margin)
    return {"add_dis_icp": add_metric(r_out, t_out, batch["r"], batch["t"],
                                      batch["model_points"],
                                      batch["sym_mask"]),
            "rot_deg_icp": angular_distance(r_out, batch["r"]),
            "trans_m_icp": torch.linalg.norm(t_out - batch["t"], dim=-1),
            "icp_residual": resid, "icp_accepted": accept.float(),
            "pred_r_icp": r_out, "pred_t_icp": t_out}


class TransparentTrainer(Trainer):
    """Epoch loop of the transparent pipeline: fit / test / checkpoints
    / resume on the steps above. The card unless the caller passes
    device="cpu". It shares the KRRN trainer's restore (init_state: a
    stale checkpoint starts fresh; under a group loaded on every rank or
    on none), fit and device transfer; under a process group each rank
    trains and evaluates its shard (epoch_indices / eval_indices), the LR
    horizon is the shards', rank 0 logs and saves, and the eval tables
    are merged before the summary. The NaN guard observes each step as
    it ends, as the JAX transparent trainer does: an abort after
    max_consecutive non-finite steps comes at the JAX trainer's step, and
    the emergency checkpoint holds the state of the step it is saved
    under.

    test_epoch evaluates `test_dataset`, as both KRRN trainers do. Here
    the port departs from the JAX TransparentTrainer on purpose: that one
    takes the batch count from its test_dataset but reads the frames of
    its training dataset.

    The ADD threshold of an object is 0.1 x the diameter of its first
    500 model points, taken when the object is first evaluated (the JAX
    trainer takes every object's at construction, which a tree holding
    fewer than num_cls objects' meshes cannot give)."""

    def __init__(self, cfg: Config, dataset, test_dataset=None,
                 log_dir: str = "runs/transparent", model=None,
                 resume: str | None = None, device="cuda"):
        super().__init__(cfg, dataset, test_dataset, log_dir, model, resume,
                         device=device)
        self._diameters: dict[int, float] = {}

    def default_model(self, enable_rot: bool = False):
        return build_model(self.cfg)

    def build_steps(self):
        # train.refine gates the eval's ICP against the completed depth
        return (TransparentTrainStep(self.model, self.tx,
                                     loss_weights(self.cfg)),
                build_transparent_eval_step(self.model,
                                            refine_icp=self.cfg.train.refine))

    def diameter(self, obj_id: int) -> float:
        if obj_id not in self._diameters:
            mp = np.asarray(self.dataset.model_points(obj_id))[:500]
            d2 = ((mp[:, None] - mp[None]) ** 2).sum(-1)
            self._diameters[obj_id] = float(np.float32(np.sqrt(d2.max())))
        return self._diameters[obj_id]

    def _batches(self, dataset, index_batches, seed0: int) -> Prefetcher:
        cfg = self.cfg

        def gen():
            for bi, idx in enumerate(index_batches):
                yield make_transparent_batch(
                    dataset, idx, seed=seed0 + bi,
                    img_size=cfg.data.input_size,
                    num_model=min(500, cfg.data.num_points))

        return Prefetcher(gen())

    def train_epoch(self, epoch: int, steps: int | None = None):
        cfg = self.cfg
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        batches = epoch_indices(_generator(cfg.seed, 1, epoch),
                                len(self.dataset), cfg.train.batch_size,
                                self.shard_count, self.shard_index)
        if steps is not None:
            batches = batches[:steps]
        t0 = time.time()
        stream = self._batches(self.dataset, batches, epoch * 131)
        try:
            for bi, batch in enumerate(stream):
                metrics = self.train_step(self.state, self._to_device(batch))
                # the guard reads this step's metrics (one host sync a
                # step, as the JAX transparent trainer waits for each)
                if self.guard.observe(self.state.step, metrics,
                                      train_state=self.state):
                    self.log.log(self.state.step,
                                 {"epoch": epoch, "aborted_divergence": 1.0},
                                 echo=True)
                    break
                if bi % 20 == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["epoch"] = epoch
                    m["sec_per_step"] = (time.time() - t0) / (bi + 1)
                    self.log.log(self.state.step, m)
                if (cfg.train.ckpt_every
                        and self.state.step % cfg.train.ckpt_every == 0):
                    self.ckpt.save(self.state.step, self.state,
                                   metrics={"periodic": 1.0})
        finally:
            stream.close()
        return self.state

    def test_epoch(self, epoch: int, max_batches: int | None = None):
        """Full-coverage eval of the test set (every sample once, the
        padding masked out, the ranks' tables merged): ADD(-S) at 0.1d,
        the rotation and translation errors, 5 deg / 5 cm, and with ICP
        the same after refinement and its accept rate."""
        cfg = self.cfg
        acc = PerObjectAccumulator(cfg.module.num_cls)
        batches, valid = eval_indices(len(self.test_dataset),
                                      cfg.train.batch_size,
                                      self.shard_count, self.shard_index)
        if max_batches is not None:
            batches, valid = batches[:max_batches], valid[:max_batches]
        stream = self._batches(self.test_dataset, batches,
                               epoch * 131 + 7777)
        try:
            for bi, batch in enumerate(stream):
                out = self.eval_step(self._to_device(batch))
                keep = valid[bi]
                cls = batch["obj"].numpy().reshape(-1)[keep]
                thresh = 0.1 * np.array([self.diameter(int(c)) for c in cls],
                                        np.float32)
                row = lambda k: out[k].float().cpu().numpy().reshape(-1)[keep]
                dis, rdeg, tm = row("add_dis"), row("rot_deg"), row("trans_m")
                metrics = {"add_dis": dis,
                           "add_ok": (dis < thresh).astype(np.float32),
                           "rot_deg": rdeg, "trans_m": tm,
                           "deg_cm_ok": ((rdeg < 5.0) & (tm < 0.05)
                                         ).astype(np.float32)}
                if "add_dis_icp" in out:
                    dis_i = row("add_dis_icp")
                    metrics.update({
                        "add_dis_icp": dis_i,
                        "add_ok_icp": (dis_i < thresh).astype(np.float32),
                        "rot_deg_icp": row("rot_deg_icp"),
                        "trans_m_icp": row("trans_m_icp"),
                        "icp_accepted": row("icp_accepted")})
                acc.update(cls, metrics)
        finally:
            stream.close()
        summary = acc.all_reduce_across_processes().summary()
        mean_dis = summary["overall"].get("add_dis", float("inf"))
        self.eval_log.log(self.state.step,
                          {"epoch": epoch, **summary["overall"]}, echo=True)
        if mean_dis < self.state.best_dis:
            self.state.best_dis = float(np.float32(mean_dis))
            self.ckpt.save(self.state.step, self.state,
                           metrics={"add_dis": mean_dis})
        if (cfg.train.lr.scheduler == "manual"
                and mean_dis < cfg.train.lr.decay_margin):
            self.state.lr_scale = float(np.float32(
                self.state.lr_scale * cfg.train.lr.decay_rate))
        return summary

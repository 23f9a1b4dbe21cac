"""The KRRN training step (counterpart of
parallel/train_step.py:29-35,98-173), on one device or on each rank of a
process group (parallel.dist) with the JAX step's global-batch semantics.

  batch -> (offset-decode target rewrite) -> KRRN forward (train draws
  from the state's generator; BatchNorm on the batch's statistics, moving
  the running ones) -> krrn_loss (+ weight_refine x the differentiable-
  PnP refine loss with train.refine) -> gradients of every parameter
  (averaged over the group in one flat buffer) -> NaN guard -> Ranger or
  Adam update, in place.

The NaN guard is the JAX package's, to the letter: the global gradient
norm is taken before clipping; when it or the loss is not finite the
gradients are zeroed and the update still runs, so the moments, the count
and Lookahead's count all advance; the step reports skipped_nonfinite.
Under a group the gradient and the loss terms are averaged over it before
the guard, so every rank reads the global norm and loss, takes the same
skip decision and applies the same update; the masked means, BatchNorm's
statistics and the draws with a batch axis are the global batch's (see
parallel/dist.py). Nothing in the step waits for the device: its metrics
stay tensors.
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.configs.schema import Config
from pose_estimation_tpu_torch.core.geometry.rotations import (
    axis_angle_to_matrix)
from pose_estimation_tpu_torch.core.solvers.pnp import (
    pnp_implicit, pnp_ransac)
from pose_estimation_tpu_torch.data.pipeline import denormalize_xyz
from pose_estimation_tpu_torch.losses.pose_loss import krrn_loss, pose_loss
from pose_estimation_tpu_torch.parallel import dist
from pose_estimation_tpu_torch.serve import region_base_at_choose
from pose_estimation_tpu_torch.train.optim import Ranger, nan_guard
from pose_estimation_tpu_torch.train.state import TrainState
from pose_estimation_tpu_torch.utils.profiling import span, spanned


def loss_weights_dict(cfg: Config) -> dict:
    lw = cfg.train.loss
    return {"weight_xyz": lw.weight_xyz, "weight_region": lw.weight_region,
            "weight_mask": lw.weight_mask, "weight_normal": lw.weight_normal,
            "weight_pose": lw.weight_pose}


def offset_targets(batch: dict) -> dict:
    """xyz targets as offsets from the gt region's centre (0 off the
    labelled pixels): what the xyz head learns when
    cfg.module.xyz_offset_decode is set."""
    b, h, w = batch["region"].shape
    rows = batch["region"].long().reshape(b, h * w, 1).expand(-1, -1, 3)
    base = torch.gather(batch["region_points"], 1, rows).reshape(b, h, w, 3)
    batch = dict(batch)
    batch["xyz"] = torch.where(batch["valid"][..., None],
                               batch["xyz"] - base,
                               torch.zeros_like(batch["xyz"]))
    return batch


def build_refine_loss(cfg: Config, num_points: int = 128,
                      num_hypotheses: int = 8):
    """The train-time differentiable-PnP ADD loss (train.refine):
    refine_loss(out, batch, generator=None, subset_ids=None) -> 0-d.

    xyz_emb in fp32 (plus the soft region decode under
    xyz_offset_decode) at `num_points` strided points, denormalised; a
    PnP-RANSAC solve without gradients (`num_hypotheses` subsets from
    `generator`, or `subset_ids` [B x world_size, H, 6], the global
    batch's, as pnp_ransac takes them; inliers at 2 px; 3 LM
    iterations); pnp_implicit re-attaches the gradient to the points at
    the solution, weighted by its inliers + 1e-3; then the ADD(-S) loss
    of that pose against the batch's targets."""
    offset_decode = cfg.module.xyz_offset_decode

    def refine_loss(out, batch, generator=None, subset_ids=None):
        xyz_emb = out["xyz_emb"].float()
        if offset_decode:
            xyz_emb = xyz_emb + region_base_at_choose(out, batch, soft=True)
        n = batch["choose"].shape[1]
        stride = max(n // num_points, 1)
        sel = torch.arange(num_points, device=xyz_emb.device) * stride % n
        pw = denormalize_xyz(xyz_emb[:, sel], batch["lf_border"],
                             batch["extent"])
        uv = batch["xy_choosed"][:, sel]
        with torch.no_grad():
            pnp = pnp_ransac(pw, uv, batch["k"],
                             generator=generator, subset_ids=subset_ids,
                             num_hypotheses=num_hypotheses, inlier_px=2.0,
                             refine_iters=3)
        wts = pnp["inliers"].float() + 1e-3
        pose6 = pnp_implicit(pnp["pose6"], pw, uv, batch["k"], wts)
        return pose_loss(axis_angle_to_matrix(pose6[:, :3]), pose6[:, 3:],
                         batch["target"], batch["model_points"],
                         batch["sym_mask"])

    return refine_loss


class TrainStep:
    """step(state, batch, opt_pose=True, train=True) -> metrics dict of
    0-d device tensors (the loss terms, skipped_nonfinite and grad_norm,
    the global norm before clipping). `train=False` runs the
    deterministic eval forward (strided pools, no dropout). The three
    stages are methods of their own: `losses`, `gradients`, `apply`;
    `gradients` and `apply` read the total under the key `total`."""

    total = "loss"

    def __init__(self, model, tx, cfg: Config):
        self.model, self.tx, self.cfg = model, tx, cfg
        self.weights = loss_weights_dict(cfg)
        self.refine_loss = (build_refine_loss(cfg) if cfg.train.refine
                            else None)

    @spanned("train.losses")
    def losses(self, batch: dict, opt_pose: bool = True, train: bool = True,
               generator=None, subset_ids=None) -> dict:
        """The loss terms; with train.refine and opt_pose also loss_refine,
        its RANSAC subsets drawn from `generator` after the forward's
        draws, or injected as `subset_ids` (the global batch's)."""
        if self.cfg.module.xyz_offset_decode:
            batch = offset_targets(batch)
        out = self.model(batch["img"], batch["cloud"], batch["choose"],
                         batch["cls"], opt_pose=opt_pose, train=train,
                         generator=generator)
        losses = krrn_loss(out, batch, self.weights, opt_pose=opt_pose)
        if self.refine_loss is not None and opt_pose:
            losses["loss_refine"] = self.refine_loss(out, batch, generator,
                                                     subset_ids)
            w = self.cfg.train.loss.weight_refine
            losses["loss"] = losses["loss"] + w * losses["loss_refine"]
        return losses

    @spanned("train.gradients")
    def gradients(self, losses: dict) -> dict:
        """Gradient of the total loss for every parameter; zeros for the
        ones the loss does not reach (the pose branch without opt_pose),
        as jax.grad gives. Under a group, averaged over it (views of one
        flat buffer)."""
        names, params = zip(*self.model.named_parameters())
        grads = torch.autograd.grad(losses[self.total], params,
                                    allow_unused=True,
                                    materialize_grads=True)
        return dict(zip(names, dist.all_reduce_mean(grads)))

    @spanned("train.apply")
    def apply(self, state: TrainState, losses: dict, grads: dict) -> dict:
        """The guard and the update from `grads` (already averaged over
        the group); the metrics are the loss terms averaged over the
        group, the guard's decision and the gradient norm. Ranger on the
        card runs both in one hand-written kernel (state.apply_ranger);
        on the CPU, and Adam anywhere, they run leaf by leaf."""
        metrics = dist.mean_dict({k: v.detach() for k, v in losses.items()})
        loss = metrics[self.total]
        if isinstance(self.tx, Ranger) and loss.is_cuda:
            gnorm, finite = state.apply_ranger(self.tx, grads, loss)
        else:
            with torch.no_grad(), span("train.guard"):
                grads, gnorm, finite = nan_guard(grads, loss)
            state.apply_gradients(self.tx, grads)
        metrics["skipped_nonfinite"] = (~finite).float()
        metrics["grad_norm"] = gnorm
        return metrics

    @spanned("train.step")
    def __call__(self, state: TrainState, batch: dict, opt_pose: bool = True,
                 train: bool = True) -> dict:
        losses = self.losses(batch, opt_pose, train, state.generator)
        return self.apply(state, losses, self.gradients(losses))


def build_train_step(model, tx, cfg: Config) -> TrainStep:
    return TrainStep(model, tx, cfg)

"""Serving and eval programs (counterpart of parallel/train_step.py:186-319).

Two stages, kept as two functions as in the JAX package:
  forward  KRRN forward (+ optional region decode) -> (xyz_emb, pred_t)
  solve    strided subset of the chosen pixels -> denormalise -> batched
           PnP-RANSAC (fp32 whatever the model's dtype)
build_infer_step adds nothing that reads a ground-truth field;
build_eval_step adds the ADD(-S) metrics.
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.configs.schema import Config
from pose_estimation_tpu_torch.core.solvers.pnp import pnp_ransac
from pose_estimation_tpu_torch.data.pipeline import denormalize_xyz
from pose_estimation_tpu_torch.metrics.metric import pose_accuracy
from pose_estimation_tpu_torch.models.gcn3d import ConvLayer
from pose_estimation_tpu_torch.ops import check_config


def region_base_at_choose(out: dict, batch: dict, soft: bool) -> torch.Tensor:
    """Region-head decode at the chosen pixels [B, N, 3]: softmax-expected
    region centre (soft) or the argmax centre."""
    b, h, w, r1 = out["region"].shape
    idx = batch["choose"].long()[..., None].expand(-1, -1, r1)
    region_emb = torch.gather(out["region"].reshape(b, h * w, r1), 1, idx)
    pts = batch["region_points"]
    if soft:
        wgt = torch.softmax(region_emb.float(), -1)
        return torch.einsum("bnr,brc->bnc", wgt, pts)
    arg = torch.argmax(region_emb, -1)
    return torch.gather(pts, 1, arg[..., None].expand(-1, -1, 3))


def _resolve(cfg: Config, num_pnp_points, pnp_hypotheses, robust_refine,
             refine_top_k):
    ev = cfg.eval
    pick = lambda v, d: d if v is None else v
    return (pick(num_pnp_points, ev.num_pnp_points),
            pick(pnp_hypotheses, ev.pnp_hypotheses),
            pick(robust_refine, ev.robust_refine),
            pick(refine_top_k, ev.refine_top_k))


class InferStep:
    """infer_step(batch, generator=None, subset_ids=None) -> dict with
    pred_r [B,3,3], pred_t [B,3] (regressed), pnp_t [B,3], num_inliers [B],
    mean_err [B]. `forward` and `solve` are the two stages."""

    def __init__(self, model, cfg: Config, num_pnp_points=None,
                 pnp_hypotheses=None, robust_refine=None, refine_top_k=None):
        self.model, self.cfg = model, cfg
        (self.num_pnp_points, self.pnp_hypotheses, self.robust_refine,
         self.refine_top_k) = _resolve(cfg, num_pnp_points, pnp_hypotheses,
                                       robust_refine, refine_top_k)

    @torch.inference_mode()
    def forward(self, batch: dict):
        out = self.model(batch["img"], batch["cloud"], batch["choose"],
                         batch["cls"], opt_pose=True)
        xyz_emb = out["xyz_emb"]
        if self.cfg.module.xyz_offset_decode:
            xyz_emb = xyz_emb + region_base_at_choose(
                out, batch, soft=self.cfg.module.region_soft_decode)
        return xyz_emb, out["pred_t"]

    @torch.inference_mode()
    def solve(self, xyz_emb, pred_t, batch: dict, generator=None,
              subset_ids=None):
        n = batch["choose"].shape[1]
        stride = max(n // self.num_pnp_points, 1)
        sel = torch.arange(self.num_pnp_points,
                           device=xyz_emb.device) * stride % n
        pw = denormalize_xyz(xyz_emb[:, sel].float(), batch["lf_border"],
                             batch["extent"])
        uv = batch["xy_choosed"][:, sel]
        pnp = pnp_ransac(pw, uv, batch["k"], generator=generator,
                         subset_ids=subset_ids,
                         num_hypotheses=self.pnp_hypotheses, inlier_px=2.0,
                         robust_refine=self.robust_refine,
                         refine_top_k=self.refine_top_k)
        return {"pred_r": pnp["r"], "pred_t": pred_t, "pnp_t": pnp["t"],
                "num_inliers": pnp["num_inliers"],
                "mean_err": pnp["mean_err"]}

    def __call__(self, batch: dict, generator=None, subset_ids=None):
        xyz_emb, pred_t = self.forward(batch)
        return self.solve(xyz_emb, pred_t, batch, generator, subset_ids)


class EvalStep(InferStep):
    """InferStep plus ADD(-S) / pose-accuracy metrics against the batch's
    ground truth."""

    def solve(self, xyz_emb, pred_t, batch, generator=None, subset_ids=None):
        out = super().solve(xyz_emb, pred_t, batch, generator, subset_ids)
        acc = pose_accuracy(out["pred_r"], pred_t.float(), batch["target_r"],
                            batch["target_t"], batch["model_points"],
                            batch["sym_mask"], batch["diameter"])
        acc.update(pnp_t=out["pnp_t"], pred_r=out["pred_r"], pred_t=pred_t,
                   num_inliers=out["num_inliers"])
        return acc


def linear_layers(model) -> list:
    """(S, O, dtype) of each narrow 3-D ConvLayer of `model`: the layers
    whose aggregates the fusion nets hand linear_multi."""
    found = {(m.support_num, m.out_channel, m.dtype): None
             for m in model.modules()
             if isinstance(m, ConvLayer) and m.narrow
             and m.directions.shape[0] == 3}
    return list(found)


def check_model(model, cfg: Config) -> None:
    """For a model on a card, raise before the first launch if `cfg` or
    the model's layers give a kernel a shape it does not take
    (ops.check_config)."""
    if model is not None and next(model.parameters()).is_cuda:
        check_config(cfg, linear_layers(model))


def build_infer_step(model, cfg: Config, **solver_kw) -> InferStep:
    check_model(model, cfg)
    return InferStep(model, cfg, **solver_kw)


def build_eval_step(model, cfg: Config, **solver_kw) -> EvalStep:
    check_model(model, cfg)
    return EvalStep(model, cfg, **solver_kw)

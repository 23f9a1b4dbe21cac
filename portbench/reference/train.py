"""Plain float32 training of the reference models: the KRRN loss terms,
the gradient by autograd, the NaN guard, clipping by the global norm,
gradient centralisation and Ranger (RAdam, then Lookahead every 6
steps), with the constants the configuration's optimizer states."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.layers import safe_norm

_EPS = 1e-6


# ------------------------------------------------------------------ losses

def masked_mean(per_pixel, valid):
    return torch.sum(per_pixel * valid) / torch.clamp(torch.sum(valid),
                                                      min=1.0)


def nearest_distance(target, source, eps=1e-8, chunk=1 << 15):
    """Distance [B, n] to the nearest source point: the nearest found
    without gradients in blocks of targets, the distance taken again with
    them, sqrt(max(|t - s|^2, eps^2))."""
    with torch.no_grad():
        idx = torch.cat([torch.cdist(t, source).argmin(-1)
                         for t in target.split(chunk, dim=1)], 1)
    s = torch.gather(source, 1, idx[..., None].expand(-1, -1, 3))
    return torch.sqrt(torch.clamp(torch.sum((target - s) ** 2, -1),
                                  min=eps * eps))


def add_distance(pred_points, target_points, sym_mask):
    direct = safe_norm(pred_points - target_points).mean(-1)
    chamfer = nearest_distance(pred_points, target_points).mean(-1)
    return torch.where(sym_mask > 0, chamfer, direct)


def krrn_loss(out, batch, weights):
    """xyz L1, normal cosine and region cross entropy over the labelled
    pixels, mask cross entropy over every pixel, ADD(-S) of the regressed
    translation with the true rotation."""
    valid = batch["valid"].float()
    loss_xyz = masked_mean(torch.abs(out["xyz"] - batch["xyz"]).sum(-1),
                           valid)
    dot = torch.sum(out["normal"] * batch["normal"], -1)
    cos = 1.0 - dot / torch.clamp(safe_norm(out["normal"])
                                  * safe_norm(batch["normal"]), min=_EPS)
    loss_normal = masked_mean(cos, valid)

    def ce(logits, target):
        logp = torch.log(torch.softmax(logits, dim=-1) + _EPS)
        return -torch.gather(logp, -1, target.long()[..., None])[..., 0]

    loss_region = masked_mean(ce(out["region"], batch["region"]), valid)
    loss_mask = masked_mean(ce(out["mask"], batch["multi_cls_mask"]),
                            torch.ones_like(valid))
    pred_points = (batch["model_points"] @ batch["target_r"].transpose(-1, -2)
                   + out["pred_t"][:, None, :])
    loss_add = add_distance(pred_points, batch["target"],
                            batch["sym_mask"]).mean()
    total = (weights["weight_xyz"] * loss_xyz
             + weights["weight_region"] * loss_region
             + weights["weight_mask"] * loss_mask
             + weights["weight_normal"] * loss_normal
             + weights["weight_pose"] * loss_add)
    return total


# --------------------------------------------------------------- optimizer

def axis0_dim(name: str) -> int:
    """The dim of a leaf that the optimizer's gradient centralisation
    keeps: 2 for a convolution's weight (the kernel row of [out, in, kh,
    kw], and of a transposed convolution's [in, out, kh, kw]), 1 for a
    Dense weight's input, 0 for every other leaf."""
    parts = name.split(".")
    module = parts[-2] if len(parts) > 1 else ""
    if parts[-1] == "weight" and module.startswith(("Conv_",
                                                    "ConvTranspose_")):
        return 2
    if parts[-1] == "weight" and module.startswith("Dense_"):
        return 1
    return 0


def centralise(name, g):
    if g.ndim <= 1:
        return g
    keep = axis0_dim(name)
    return g - g.mean(dim=[d for d in range(g.ndim) if d != keep],
                      keepdim=True)


class Ranger:
    """Clip by the global norm, centralise, RAdam (b1 .95, b2 .999, eps
    1e-5, rectified from rho >= 5), x -lr, Lookahead (6, 0.5)."""

    b1, b2, eps, threshold = 0.95, 0.999, 1e-5, 5.0
    sync_period, alpha = 6, 0.5

    def __init__(self, lr, grad_clip):
        self.lr, self.grad_clip = lr, grad_clip

    def init(self, params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
                "slow": {k: p.clone() for k, p in params.items()}}

    def clip(self, grads):
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if not self.grad_clip or gnorm < self.grad_clip:
            return grads
        return {k: g / gnorm * self.grad_clip for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params, grads, state):
        """Updates `params` in place; returns the centralised, clipped
        gradient the moments took."""
        grads = self.clip(grads)
        count = state["count"] + 1
        b2t = self.b2 ** count
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        ro = ro_inf - 2 * count * b2t / (1.0 - b2t)
        r = (math.sqrt((ro - 4) * (ro - 2) * ro_inf
                       / ((ro_inf - 4) * (ro_inf - 2) * ro))
             if ro >= self.threshold else None)
        c1, c2 = 1.0 - self.b1 ** count, 1.0 - b2t
        seen = {}
        for k, p in params.items():
            v = centralise(k, grads[k])
            seen[k] = v
            mu = (1 - self.b1) * v + self.b1 * state["mu"][k]
            nu = (1 - self.b2) * v * v + self.b2 * state["nu"][k]
            u = mu / c1
            if r is not None:
                u = r * u / (torch.sqrt(nu / c2) + self.eps)
            new = p - self.lr * u
            if count % self.sync_period == 0:
                new = state["slow"][k] + self.alpha * (new - state["slow"][k])
                state["slow"][k] = new.clone()
            p.copy_(new)
            state["mu"][k], state["nu"][k] = mu, nu
        state["count"] = count
        return seen


def leaf_gap(prog: dict, ref: dict, keep=None) -> dict:
    """Leaf by leaf, |norm(prog) - norm(ref)| over the larger of the
    leaf's reference norm and the median leaf's: the median over the
    leaves, the worst and its name; `keep` names the leaves compared (all
    by default). A NaN counts as the worst."""
    names = [k for k in ref if keep is None or k in keep]
    ref_n = {k: float(torch.linalg.vector_norm(ref[k].double()))
             for k in names}
    med = float(np.median(list(ref_n.values())))
    gaps = {}
    for k in names:
        p = float(torch.linalg.vector_norm(prog[k].double()))
        g = abs(p - ref_n[k]) / max(ref_n[k], med, 1e-30)
        gaps[k] = g if g == g else float("inf")
    at = max(gaps, key=gaps.get)
    return {"median": float(np.median(list(gaps.values()))),
            "worst": gaps[at], "at": at}

"""Per-pixel map losses with invalid-pixel masking (counterpart of
losses/map_loss.py). NHWC maps; each loss is normalised by the count of
valid pixels, over the global batch under a process group."""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.core.mathsafe import safe_norm
from pose_estimation_tpu_torch.parallel import dist

_EPS = 1e-6


def l1_map(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-pixel L1 summed over channels: [B,H,W,C] -> [B,H,W]."""
    return torch.sum(torch.abs(pred - target), dim=-1)


def cosine_map(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity along channels; the norms are safe_norm's, so
    an exactly-zero prediction vector has a finite gradient."""
    dot = torch.sum(pred * target, dim=-1)
    return 1.0 - dot / torch.clamp(safe_norm(pred) * safe_norm(target),
                                   min=_EPS)


def ce_map(pred_logits: torch.Tensor, target_idx: torch.Tensor
           ) -> torch.Tensor:
    """Per-pixel cross entropy, logits [B,H,W,C], labels [B,H,W]; the eps
    sits inside the log, as in the reference."""
    logp = torch.log(torch.softmax(pred_logits, dim=-1) + _EPS)
    return -torch.gather(logp, -1, target_idx.long()[..., None])[..., 0]


def masked_mean(per_pixel: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Sum over valid pixels / number of valid pixels (at least 1).

    Under a process group the mean is over the global batch, as the JAX
    step's: the count is summed over the group (no gradient) and the
    local sum scaled by world_size / count, so that the mean over the
    ranks of this value, which the step logs, is the global masked mean
    and the averaged gradient is its gradient."""
    total = torch.sum(per_pixel * valid)
    count = dist.all_reduce_sum(torch.sum(valid))
    mean = total / torch.clamp(count, min=1.0)
    n = dist.world_size()
    return mean * n if n > 1 else mean


def map_loss(kind: str, pred: torch.Tensor, target: torch.Tensor,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """kind in {'l1', 'cosine', 'ce'}. Without `valid`: a pixel is valid
    where the target is nonzero on any channel (l1, cosine) or nonzero
    (ce), the reference's rule."""
    if kind == "l1":
        pp = l1_map(pred, target)
        v = (target != 0).any(-1) if valid is None else valid
    elif kind == "cosine":
        pp = cosine_map(pred, target)
        v = (target != 0).any(-1) if valid is None else valid
    elif kind == "ce":
        pp = ce_map(pred, target)
        v = target != 0 if valid is None else valid
    else:
        raise ValueError(kind)
    return masked_mean(pp, v.to(pp.dtype))

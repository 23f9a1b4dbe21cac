"""Gradient-safe norms (counterpart of pose_estimation_tpu.core.mathsafe).

The clamp sits inside the sqrt, sqrt(max(|x|^2, eps^2)), so the value
matches F.normalize and the gradient stays finite at x == 0.
"""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-8) -> torch.Tensor:
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=eps * eps))


def safe_normalize(x: torch.Tensor, dim: int = -1,
                   eps: float = 1e-8) -> torch.Tensor:
    return x / safe_norm(x, dim=dim, keepdim=True, eps=eps)

"""Output decoding (counterpart of models/decode.py): region
classification to coordinates, and the mask's argmax. Maps are NHWC,
as in the JAX package.

decode_xyz_soft takes the softmax expectation of the region centres
(a sum over the regions); the reference divides it by the region count
as well, which `reference_mean=True` reproduces for parity checks.
"""

from __future__ import annotations

import torch


def decode_xyz_soft(xyz_off: torch.Tensor, region_logits: torch.Tensor,
                    region_points: torch.Tensor,
                    reference_mean: bool = False) -> torch.Tensor:
    """xyz_off [B, H, W, 3] offsets, region_logits [B, H, W, R + 1],
    region_points [B, R + 1, 3] (index 0: the background, the origin)
    -> [B, H, W, 3]."""
    w = torch.softmax(region_logits, dim=-1)
    base = torch.einsum("bhwr,brc->bhwc", w, region_points)
    if reference_mean:
        base = base / region_logits.shape[-1]
    return xyz_off + base


def decode_xyz_hard(xyz_off: torch.Tensor, region_logits: torch.Tensor,
                    region_points: torch.Tensor) -> torch.Tensor:
    """The argmax region's centre plus the offset (the standalone eval's
    decoding)."""
    idx = torch.argmax(region_logits, dim=-1)                 # [B, H, W]
    onehot = torch.nn.functional.one_hot(
        idx, region_logits.shape[-1]).to(xyz_off.dtype)
    base = torch.einsum("bhwr,brc->bhwc", onehot, region_points)
    return xyz_off + base


def mask_argmax(mask_logits: torch.Tensor) -> torch.Tensor:
    """Multi-class mask logits [B, H, W, C + 1] -> int32 mask [B, H, W]."""
    return torch.argmax(mask_logits, dim=-1).to(torch.int32)

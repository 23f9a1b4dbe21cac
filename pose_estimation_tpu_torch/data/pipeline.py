"""Eval-time sample preparation (counterpart of data/pipeline.py).

Full RGB-D frame -> model-ready crop sample: mask bbox -> square crop
warped to a static size -> `choose` (exactly num_points valid pixels,
wrap-padded) -> cloud backprojected at the chosen pixels -> normalised
labels. One frame at a time, on whatever device the frame lies on.
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.core.geometry.warp import (
    bilinear_sample, crop_affine_coords, nearest_sample)


def square_bbox_from_mask(mask: torch.Tensor, pad: float = 1.2,
                          min_size: float = 40.0):
    """[H, W] mask -> (center [2] (x, y), side)."""
    h, w = mask.shape
    rows = (mask > 0).any(1).to(torch.int32)
    cols = (mask > 0).any(0).to(torch.int32)
    rmin = torch.argmax(rows)
    rmax = h - 1 - torch.argmax(rows.flip(0))
    cmin = torch.argmax(cols)
    cmax = w - 1 - torch.argmax(cols.flip(0))
    center = torch.stack([(cmin + cmax) * 0.5, (rmin + rmax) * 0.5]).to(
        torch.float32)
    side = torch.clamp(torch.maximum(rmax - rmin, cmax - cmin) * pad,
                       min=min_size)
    return center, side.to(torch.float32)


def choose_valid_pixels(noise: torch.Tensor, valid: torch.Tensor, num: int):
    """`num` flat pixel ids, valid pixels first in the order of `noise`
    (uniform [S*S], the random draw made explicit), wrap-padded when fewer
    are valid. Returns (choose [num] int32, count)."""
    flat = valid.reshape(-1)
    priority = torch.where(flat, 1.0 + noise, noise)
    # lax.top_k order: descending, ties to the lower index
    idx = torch.sort(priority, descending=True, stable=True).indices[:num]
    count = flat.sum().to(torch.int32)
    pos = torch.arange(num, device=flat.device)
    wrapped = idx[pos % torch.clamp(count, min=1)]
    choose = torch.where(pos < count, idx, wrapped)
    return choose.to(torch.int32), count


def prepare_sample(frame: dict, lf_border: torch.Tensor,
                   extent: torch.Tensor, crop_size: int = 128,
                   num_points: int = 1024, noise: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> dict:
    """frame: rgb [H,W,3], depth [H,W], mask [H,W], coordinate [H,W,3],
    normal [H,W,3], region [H,W], k [3,3]; optional det_center/det_side.
    `noise` (uniform [crop_size**2]) orders the choose draw; without it one
    is drawn from `generator`."""
    if "det_center" in frame:
        center = frame["det_center"].to(torch.float32)
        side = frame["det_side"].to(torch.float32)
    else:
        center, side = square_bbox_from_mask(frame["mask"])
    coords = crop_affine_coords(center, side, (crop_size, crop_size))

    rgb = bilinear_sample(frame["rgb"], coords)
    depth = nearest_sample(frame["depth"], coords)
    coordinate = nearest_sample(frame["coordinate"], coords)
    normal = nearest_sample(frame["normal"], coords)
    region = nearest_sample(frame["region"].to(torch.float32),
                            coords).to(torch.int32)
    mask = nearest_sample(frame["mask"].to(torch.float32), coords) > 0.5

    valid = mask & (depth > 0) & (coordinate != 0).any(-1)
    if noise is None:
        noise = torch.rand(crop_size * crop_size, generator=generator,
                           device=valid.device)
    choose, count = choose_valid_pixels(noise, valid, num_points)

    xy_choosed = coords.reshape(-1, 2)[choose.long()]
    d_choosed = depth.reshape(-1)[choose.long()]
    k = frame["k"]
    px = (xy_choosed[:, 0] - k[0, 2]) * d_choosed / k[0, 0]
    py = (xy_choosed[:, 1] - k[1, 2]) * d_choosed / k[1, 1]
    cloud = torch.stack([px, py, d_choosed], -1)

    vm = valid[..., None]
    xyz = torch.where(vm, (coordinate - lf_border) / extent,
                      torch.zeros_like(coordinate))
    return {
        "img": rgb,
        "cloud": cloud,
        "choose": choose,
        "choose_count": count,
        "xyz": xyz,
        "normal": torch.where(vm, normal, torch.zeros_like(normal)),
        "region": torch.where(valid, region, torch.zeros_like(region)),
        "valid": valid,
        "xy_choosed": xy_choosed,
        "bbox_center": center,
        "bbox_side": side,
    }


def denormalize_xyz(xyz_norm: torch.Tensor, lf_border: torch.Tensor,
                    extent: torch.Tensor) -> torch.Tensor:
    """Model coords = xyz * extent + lf_border; batched [B, ..., 3] with
    [B, 3] borders, or unbatched [3]."""
    if lf_border.ndim == 2:
        shape = lf_border.shape[:1] + (1,) * (xyz_norm.ndim - 2) + (3,)
        lf_border = lf_border.reshape(shape)
        extent = extent.reshape(shape)
    return xyz_norm * extent + lf_border

"""Affine crop coordinates, samplers and crop_resize (counterpart of
core/geometry/warp.py); single image, [H, W] or [H, W, C]."""

from __future__ import annotations

import torch


def crop_affine_coords(center: torch.Tensor, side, out_size: tuple[int, int],
                       rot_deg: float = 0.0) -> torch.Tensor:
    """Source (x, y) coordinates [out_h, out_w, 2] of a square crop of side
    `side` (a number, [] or [2], the x component used) centred at
    `center` [2] and rotated by `rot_deg` (cv2.warpAffine anchor at
    (out_w/2, out_h/2), as get_affine_transform builds it)."""
    out_h, out_w = out_size
    dev = center.device
    side = torch.as_tensor(side, dtype=torch.float32, device=dev)
    if side.ndim == center.ndim:                     # the [2] form
        side = side[..., 0]
    dx = (torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
          - out_w * 0.5).expand(out_h, out_w)
    dy = (torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
          - out_h * 0.5).expand(out_h, out_w)
    if rot_deg:
        rot = torch.deg2rad(torch.tensor(rot_deg, dtype=torch.float32,
                                         device=dev))
        cos_r, sin_r = torch.cos(rot), torch.sin(rot)
        dx, dy = cos_r * dx - sin_r * dy, sin_r * dx + cos_r * dy
    s = (side / float(out_w)).double()
    # center + d * s rounded once, as the jitted JAX program computes it
    # (XLA contracts the multiply-add into an FMA): the float64 sum of an
    # exact float32 product, rounded to float32
    return torch.stack([center[0].double() + dx.double() * s,
                        center[1].double() + dy.double() * s], -1).float()


def _fetch(img, yi, xi, fill):
    h, w, _ = img.shape
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    vals = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
    return torch.where(valid[..., None], vals, torch.full_like(vals, fill))


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    """cv2.warpAffine(INTER_LINEAR, borderValue=fill) semantics."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = (x - x0)[..., None]
    ty = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    v00 = _fetch(img, y0i, x0i, fill)
    v01 = _fetch(img, y0i, x0i + 1, fill)
    v10 = _fetch(img, y0i + 1, x0i, fill)
    v11 = _fetch(img, y0i + 1, x0i + 1, fill)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    out = top * (1 - ty) + bot * ty
    return out[..., 0] if squeeze else out


def nearest_sample(img: torch.Tensor, coords: torch.Tensor,
                   fill: float = 0.0) -> torch.Tensor:
    """cv2.INTER_NEAREST; rounding half to even, as jnp.round."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    xi = torch.round(coords[..., 0]).to(torch.int64)
    yi = torch.round(coords[..., 1]).to(torch.int64)
    out = _fetch(img, yi, xi, fill)
    return out[..., 0] if squeeze else out


def crop_resize(img: torch.Tensor, center, scale, out_size,
                rot_deg: float = 0.0, method: str = "bilinear"):
    """crop_resize_by_warp_affine (lib/transform/coordinate.py:11-22): the
    square window of side `scale` at `center`, rotated by `rot_deg`,
    resampled to `out_size` (an int or (h, w)); img [H, W] or [H, W, C],
    one image."""
    if isinstance(out_size, int):
        out_size = (out_size, out_size)
    center = torch.as_tensor(center, dtype=torch.float32, device=img.device)
    coords = crop_affine_coords(center, scale, out_size, rot_deg)
    sampler = bilinear_sample if method == "bilinear" else nearest_sample
    return sampler(img, coords)

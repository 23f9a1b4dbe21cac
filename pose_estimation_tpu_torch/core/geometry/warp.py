"""Affine crop coordinates and samplers (counterpart of
core/geometry/warp.py); single image, [H, W] or [H, W, C]."""

from __future__ import annotations

import torch


def crop_affine_coords(center: torch.Tensor, side: torch.Tensor,
                       out_size: tuple[int, int]) -> torch.Tensor:
    """Source (x, y) coordinates [out_h, out_w, 2] of an unrotated square
    crop of side `side` centred at `center` [2] (cv2.warpAffine anchor at
    (out_w/2, out_h/2), as get_affine_transform builds it)."""
    out_h, out_w = out_size
    dev = center.device
    dx = (torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
          - out_w * 0.5).expand(out_h, out_w)
    dy = (torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
          - out_h * 0.5).expand(out_h, out_w)
    s = (side.to(torch.float32) / float(out_w)).double()
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

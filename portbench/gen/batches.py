"""KRRN samples from full frames, for the benchmark's traffic (a frozen
copy of the program's crop, choose and batching code: core/geometry/
warp.py, data/pipeline.py, data/batching.py). One frame at a time on the
host: mask bbox -> square crop warped to a fixed size -> `choose`
(exactly num_points valid pixels, wrap-padded) -> cloud back-projected at
the chosen pixels -> normalised labels; stacked into [B, ...] tensors.
"""

from __future__ import annotations

import numpy as np
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


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def frame_to_sample(frame: dict, obj, crop_size: int, num_points: int,
                    noise: torch.Tensor | None = None,
                    generator: torch.Generator | None = None) -> dict:
    """One rendered/loaded frame + object meta -> sample dict."""
    tframe = {
        "rgb": _t(frame["rgb"]),
        "depth": _t(frame["depth"]),
        "mask": torch.as_tensor(np.asarray(frame["mask"])),
        "coordinate": _t(frame["coordinate"]),
        "normal": _t(frame["normal"]),
        "region": _t(frame["region"], torch.int32),
        "k": _t(frame["k"]),
    }
    if "det_center" in frame:
        tframe["det_center"] = _t(frame["det_center"])
        tframe["det_side"] = _t(frame["det_side"])
    s = prepare_sample(tframe, _t(obj.lf_border), _t(obj.extent),
                       crop_size, num_points, noise=noise,
                       generator=generator)
    t = np.asarray(frame["t"], np.float32)
    if "t_noise" in frame:
        tn = np.asarray(frame["t_noise"], np.float32)
        s["cloud"] = s["cloud"] + _t(tn)
        t = t + tn
    cls_id = int(frame["cls_id"])
    r = np.asarray(frame["r"], np.float32)
    region_points = np.concatenate(
        [np.zeros((1, 3), np.float32), obj.fps_centers], axis=0)
    region_points = (region_points - obj.lf_border) / obj.extent
    s.update({
        "cls": torch.tensor(cls_id, dtype=torch.int32),
        "multi_cls_mask": torch.where(s["valid"], cls_id + 1, 0).to(
            torch.int32),
        "target": _t(obj.model_points @ r.T + t),
        "model_points": _t(obj.model_points),
        "target_r": _t(r),
        "target_t": _t(t),
        "sym_mask": torch.tensor(float(obj.sym)),
        "lf_border": _t(obj.lf_border),
        "extent": _t(obj.extent),
        "region_points": _t(region_points),
        "diameter": torch.tensor(float(obj.diameter)),
        "k": tframe["k"],
    })
    return s


def make_batch(dataset, indices, generator: torch.Generator | None = None,
               crop_size: int = 128, num_points: int = 1024,
               noises=None) -> dict:
    """Stack samples for `indices` into one dict of [B, ...] tensors.
    `noises` (one uniform [crop_size**2] per index) injects the choose
    draws; otherwise they come from `generator`."""
    by_cls = getattr(dataset, "objects_by_cls", None) or dataset.objects
    samples = []
    for j, i in enumerate(indices):
        frame = dataset[int(i)]
        obj = by_cls[frame["cls_id"]]
        samples.append(frame_to_sample(
            frame, obj, crop_size, num_points,
            noise=None if noises is None else noises[j],
            generator=generator))
    return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}

"""TRPESNet samples from full frames, for the benchmark's traffic (a
frozen copy of the program's data/transparent_batching.py): square mask
bbox -> 256-px crop, zoomed intrinsics, d_scale depth normalisation,
pixel-coordinate maps, unit normals, the boundary label, model points and
the posed target. Host-side numpy and OpenCV; runs in set-up only.
"""

from __future__ import annotations

import numpy as np


def square_bbox(mask: np.ndarray) -> tuple[int, int, int, int]:
    """Square bbox (rmin, rmax, cmin, cmax) containing the mask, clamped
    into the image (get_square_bbox, cleargrasp/dataset.py:838-930)."""
    h, w = mask.shape
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    if not rows.any():
        return 0, min(h, w), 0, min(h, w)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    rmax += 1
    cmax += 1
    side = int(max(rmax - rmin, cmax - cmin))
    side = min(side, h, w)
    rc = (rmin + rmax) // 2
    cc = (cmin + cmax) // 2
    rmin = int(np.clip(rc - side // 2, 0, h - side))
    cmin = int(np.clip(cc - side // 2, 0, w - side))
    return rmin, rmin + side, cmin, cmin + side


def boundary_label(mask_u8: np.ndarray) -> np.ndarray:
    """One-pixel object contour via erosion-XOR (replaces
    cv2.findContours rasterization, dataset.py:253-266)."""
    m = mask_u8.astype(bool)
    er = np.zeros_like(m)
    er[1:-1, 1:-1] = (m[1:-1, 1:-1] & m[:-2, 1:-1] & m[2:, 1:-1]
                      & m[1:-1, :-2] & m[1:-1, 2:])
    return (m & ~er).astype(np.float32)


def frame_to_transparent_sample(frame: dict, model_points: np.ndarray,
                                rng: np.random.RandomState,
                                img_size: int = 256,
                                num_model: int = 500) -> dict:
    """frame keys: rgb [H,W,3] float0..1, depth [H,W] meters,
    normal [H,W,3] camera-frame, mask [H,W] bool, r [3,3], t [3],
    k [3,3], cls_id int, axis [3]. Returns the TRPESNet sample dict."""
    import cv2

    h, w = frame["depth"].shape
    mask = np.asarray(frame["mask"], bool)
    rmin, rmax, cmin, cmax = square_bbox(mask)
    side = rmax - rmin

    rs = lambda a, interp=cv2.INTER_LINEAR: cv2.resize(
        a[rmin:rmax, cmin:cmax].astype(np.float32), (img_size, img_size),
        interpolation=interp)

    img = rs(frame["rgb"])
    mask_c = rs(mask.astype(np.float32), cv2.INTER_NEAREST)
    depth_c = rs(frame["depth"], cv2.INTER_NEAREST)
    normal_c = rs(frame["normal"], cv2.INTER_NEAREST)
    nrm = np.linalg.norm(normal_c, axis=-1, keepdims=True)
    normal_c = np.where(nrm > 1e-6, normal_c / np.maximum(nrm, 1e-6), 0.0)

    # zoomed-camera scaling (dataset.py:513-520): s_zoom scales pixel
    # units; d_scale normalizes depth so the network sees O(1) values and
    # GeoNet un-normalizes via the same scalar.
    s_zoom = img_size / float(side)
    d_scale = img_size * 1.0 / float(side)
    depth_n = depth_c / d_scale

    base = np.arange(img_size, dtype=np.float32)
    # original pixel coordinate of resized pixel p is (p / s_zoom + offset);
    # in zoomed-camera units that is p + offset * s_zoom — matching the
    # s_zoom-scaled intrinsics below (dataset.py:518-519,546).
    xmap = np.broadcast_to(base[None, :], (img_size, img_size)) \
        + cmin * s_zoom                                   # u (columns)
    ymap = np.broadcast_to(base[:, None], (img_size, img_size)) \
        + rmin * s_zoom                                   # v (rows)

    k = np.asarray(frame["k"], np.float32)
    intrinsic = np.array([k[0, 0], k[1, 1], k[0, 2], k[1, 2]],
                         np.float32) * s_zoom

    mp = np.asarray(model_points, np.float32)
    if len(mp) > num_model:
        mp = mp[rng.choice(len(mp), num_model, replace=False)]
    elif len(mp) < num_model:
        mp = mp[rng.choice(len(mp), num_model, replace=True)]
    r = np.asarray(frame["r"], np.float32)
    t = np.asarray(frame["t"], np.float32)
    target = mp @ r.T + t

    return {
        "img": img.astype(np.float32),
        "intrinsic": intrinsic,
        "xmap": xmap.astype(np.float32),
        "ymap": ymap.astype(np.float32),
        "d_scale": np.float32(d_scale),
        "obj": np.int32(frame["cls_id"]),
        "target": target.astype(np.float32),
        "model_points": mp,
        "sym_mask": np.float32(frame.get("sym", 0.0)),
        "axis": np.asarray(frame["axis"], np.float32),
        "r": r, "t": t,
        "normal": normal_c.astype(np.float32),
        "depth": depth_n[..., None].astype(np.float32),
        "mask": mask_c[..., None].astype(np.float32),
        "boundary": boundary_label(mask_c)[..., None],
    }


def make_transparent_batch(dataset, indices, seed: int = 0,
                           img_size: int = 256, num_model: int = 500):
    """Stack samples into one [B, ...] batch dict of CPU tensors (NHWC
    maps, as the JAX batch). `dataset[i]` yields a transparent frame;
    `dataset.model_points(cls_id)` yields the object's model points
    (meters)."""
    import torch

    samples = []
    for j, i in enumerate(indices):
        frame = dataset[int(i)]
        mp = dataset.model_points(frame["cls_id"])
        rng = np.random.RandomState((seed * 100003 + int(i)) % (2 ** 31))
        samples.append(frame_to_transparent_sample(
            frame, mp, rng, img_size=img_size, num_model=num_model))
    out = {}
    for k in samples[0]:
        out[k] = torch.from_numpy(np.stack([np.asarray(s[k])
                                            for s in samples]))
    return out

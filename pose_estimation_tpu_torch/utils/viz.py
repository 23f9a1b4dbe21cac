"""Pose overlays on images, host-side numpy and OpenCV (counterpart of
utils/viz.py, carried over unchanged; tests/test_torch_tb_viz.py pins the
grids and PNG files equal).

Rebuild of the reference's viz stack: tools/viz/view.py, version/
transparent/lib/viz/visualization.py (DrawPred: projected points / axes)
and lib/proj_bboxs.py (NOCS-style 3D bbox drawing with align_rotation for
symmetric objects). OpenCV is imported where it is used.
"""

from __future__ import annotations

import numpy as np


def project(points: np.ndarray, r: np.ndarray, t: np.ndarray,
            k: np.ndarray) -> np.ndarray:
    pc = points @ r.T + t
    uv = pc[:, :2] / np.maximum(pc[:, 2:], 1e-8)
    return uv * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]


def bbox_corners(extent: np.ndarray, lf_border: np.ndarray) -> np.ndarray:
    """8 corners of the object-frame bbox."""
    mins, maxs = lf_border, lf_border + extent
    return np.array([[x, y, z] for x in (mins[0], maxs[0])
                     for y in (mins[1], maxs[1])
                     for z in (mins[2], maxs[2])], np.float32)


_BOX_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3),
              (4, 5), (4, 6), (5, 7), (6, 7),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_pose_bbox(img: np.ndarray, r, t, k, extent, lf_border,
                   color=(0, 255, 0), thickness=1) -> np.ndarray:
    """Draw the projected 3D bounding box (proj_bboxs.py:66-112 analog)."""
    import cv2
    out = np.ascontiguousarray(img.copy())
    uv = project(bbox_corners(np.asarray(extent), np.asarray(lf_border)),
                 np.asarray(r), np.asarray(t), np.asarray(k))
    uv = uv.astype(int)
    for a, b in _BOX_EDGES:
        cv2.line(out, tuple(uv[a]), tuple(uv[b]), color, thickness)
    return out


def draw_axes(img: np.ndarray, r, t, k, length: float = 0.05,
              thickness=2) -> np.ndarray:
    """Draw object axes (x red, y green, z blue)."""
    import cv2
    out = np.ascontiguousarray(img.copy())
    pts = np.array([[0, 0, 0], [length, 0, 0], [0, length, 0],
                    [0, 0, length]], np.float32)
    uv = project(pts, np.asarray(r), np.asarray(t), np.asarray(k)).astype(int)
    for i, color in zip((1, 2, 3),
                        [(0, 0, 255), (0, 255, 0), (255, 0, 0)]):
        cv2.line(out, tuple(uv[0]), tuple(uv[i]), color, thickness)
    return out


def align_rotation(r: np.ndarray) -> np.ndarray:
    """Zero the rotation about the symmetry (Y) axis for viz of symmetric
    objects (proj_bboxs.py align_rotation analog): keep only the rotation
    taking +y to R@+y."""
    y = r[:, 1]
    z = np.array([0.0, 0.0, 1.0])
    x = np.cross(y, z)
    n = np.linalg.norm(x)
    if n < 1e-6:
        return r
    x /= n
    z = np.cross(x, y)
    return np.stack([x, y, z], axis=1)


def save_eval_grid(path: str, batch: dict, pred_r, pred_t,
                   max_images: int = 4) -> str:
    """Save a pred-vs-gt 3D-bbox overlay strip for the first few eval crops
    (the reference logs pred/gt image grids each test epoch —
    version/transparent/train.py:310-317,375-406). Green = GT, red = pred.

    Points project with the original K; crop pixels follow by inverting the
    CenterNet crop affine (core/geometry/warp.py crop_affine_coords:
    dst = (src - center) * S/side + S/2), composed into K as a left affine.
    """
    import cv2
    n = min(max_images, len(np.asarray(pred_r)))
    tiles = []
    for i in range(n):
        img = np.clip(np.asarray(batch["img"][i]) * 255.0,
                      0, 255).astype(np.uint8)
        s = img.shape[0]
        center = np.asarray(batch["bbox_center"][i], np.float32)
        side = float(np.asarray(batch["bbox_side"][i]))
        a = s / max(side, 1e-6)
        affine = np.array([[a, 0, s * 0.5 - a * center[0]],
                           [0, a, s * 0.5 - a * center[1]],
                           [0, 0, 1]], np.float32)
        k_crop = affine @ np.asarray(batch["k"][i], np.float32)
        ext = np.asarray(batch["extent"][i])
        lf = np.asarray(batch["lf_border"][i])
        out = draw_pose_bbox(img, np.asarray(batch["target_r"][i]),
                             np.asarray(batch["target_t"][i]), k_crop,
                             ext, lf, color=(0, 255, 0))
        out = draw_pose_bbox(out, np.asarray(pred_r[i]),
                             np.asarray(pred_t[i]), k_crop,
                             ext, lf, color=(255, 0, 0))
        tiles.append(out)
    grid = np.concatenate(tiles, axis=1)
    cv2.imwrite(path, grid[..., ::-1])  # RGB -> BGR
    return grid  # RGB uint8, for mirroring into the TB image stream


def draw_points(img: np.ndarray, points, r, t, k, color=(255, 0, 0)):
    import cv2
    out = np.ascontiguousarray(img.copy())
    uv = project(np.asarray(points), np.asarray(r), np.asarray(t),
                 np.asarray(k)).astype(int)
    h, w = out.shape[:2]
    for u, v in uv:
        if 0 <= u < w and 0 <= v < h:
            cv2.circle(out, (u, v), 1, color, -1)
    return out

"""Synthetic RGB-D pose fixture: procedural objects + point-splat renderer.

The JAX package's data/synthetic.py (KRRN part) carried over unchanged so
the port stands without it; tests/test_torch_slice.py pins that both
render the same frames.

Two roles (SURVEY.md sections 4, 7.3):
1. the end-to-end test fixture replacing the unavailable LineMOD download —
   every pipeline stage (crop, choose, backproject, train, PnP eval) runs
   against frames rendered here;
2. the label-regeneration engine: the reference's datasets load precomputed
   coordinate/region/normal pickles produced by scripts NOT in the repo
   (dataset/linemod/batchdataset.py:200-210); this module derives those
   labels from mesh + pose (model-coordinate map = splatted object-frame
   coords; region = nearest FPS center; normals = rotated mesh normals),
   which is exactly what the missing offline scripts must have done.

Pure numpy on the host (runs once per sample at dataset-build time); the
per-step device pipeline lives in data/pipeline.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SynObject:
    """A procedural closed surface with per-point normals."""
    points: np.ndarray       # [M, 3] object-frame surface points (meters)
    normals: np.ndarray      # [M, 3] object-frame unit normals
    fps_centers: np.ndarray  # [R, 3] region centers (object frame)
    diameter: float
    extent: np.ndarray       # [3] bbox size
    lf_border: np.ndarray    # [3] bbox min corner
    model_points: np.ndarray  # [P, 3] sparse model points for ADD
    sym: bool = False        # symmetric object (eggbox/glue semantics)


def make_object(seed: int, num_surface: int = 20000, num_model: int = 500,
                num_regions: int = 16, radius: float = 0.04,
                sym: bool = False) -> SynObject:
    """Random smooth star-shaped object (deformed sphere), ~LineMOD scale."""
    rng = np.random.RandomState(seed)
    dirs = rng.randn(num_surface, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    # smooth radial deformation from a few spherical harmonics-ish lobes
    lobes = rng.randn(6, 3)
    lobes /= np.linalg.norm(lobes, axis=-1, keepdims=True)
    amp = rng.uniform(0.05, 0.25, 6)
    r = radius * (1.0 + (amp * (dirs @ lobes.T) ** 2).sum(-1))
    pts = dirs * r[:, None]
    # normals: gradient of the implicit radial field ~ dirs (approx; fine
    # for loss targets). Orthogonalize against local surface by mixing.
    normals = dirs.copy()

    # FPS for region centers
    fps_idx = _fps_numpy(pts, num_regions, rng)
    model_idx = rng.choice(num_surface, num_model, replace=False)
    lf = pts.min(0)
    ext = pts.max(0) - lf
    diam = float(np.linalg.norm(ext))
    return SynObject(
        points=pts.astype(np.float32),
        normals=normals.astype(np.float32),
        fps_centers=pts[fps_idx].astype(np.float32),
        diameter=diam, extent=ext.astype(np.float32),
        lf_border=lf.astype(np.float32),
        model_points=pts[model_idx].astype(np.float32),
        sym=sym)


def _fps_numpy(pts: np.ndarray, k: int, rng) -> np.ndarray:
    idx = [int(rng.randint(len(pts)))]
    d = np.full(len(pts), np.inf)
    for _ in range(k - 1):
        d = np.minimum(d, ((pts - pts[idx[-1]]) ** 2).sum(-1))
        idx.append(int(d.argmax()))
    return np.array(idx)


DEFAULT_K = np.array([[572.4114, 0., 325.2611],
                      [0., 573.57043, 242.04899],
                      [0., 0., 1.]], np.float32)


# Fixed channel-mixing directions for the texture octaves (object-
# independent; shapes differ per object, and per-class heads separate
# classes — shared texture statistics are fine and keep SynObject lean).
_TEX_M1 = np.array([[0.36, -0.80, 0.48], [0.80, 0.48, 0.36],
                    [-0.48, 0.36, 0.80]], np.float32)
_TEX_M2 = np.array([[0.0, 0.6, -0.8], [-0.6, 0.64, 0.48],
                    [0.8, 0.48, 0.36]], np.float32)
_TEX_M3 = np.array([[0.69, 0.69, 0.23], [-0.23, 0.69, -0.69],
                    [-0.69, 0.23, 0.69]], np.float32)


def render_frame(obj: SynObject, r: np.ndarray, t: np.ndarray,
                 k: np.ndarray = DEFAULT_K, im_h: int = 480, im_w: int = 640,
                 rng: np.random.RandomState | None = None):
    """Point-splat z-buffer render -> full-frame RGB-D + dense labels.

    Returns dict with: rgb [H,W,3] float, depth [H,W] meters, mask [H,W],
    coordinate [H,W,3] (object-frame coords, 0 at bg — the '-coordinate.pkl'
    label), normal [H,W,3] (camera-frame, 0 at bg — '-normal.pkl'),
    region [H,W] int (0 bg, 1..R nearest FPS center — '-region.pkl'),
    pose (r, t).
    """
    rng = rng or np.random.RandomState(0)
    pc = obj.points @ r.T + t
    z = pc[:, 2]
    u = np.round(pc[:, 0] / z * k[0, 0] + k[0, 2]).astype(np.int64)
    v = np.round(pc[:, 1] / z * k[1, 1] + k[1, 2]).astype(np.int64)
    ok = (u >= 0) & (u < im_w) & (v >= 0) & (v < im_h) & (z > 1e-6)

    flat = v[ok] * im_w + u[ok]
    order = np.argsort(z[ok])[::-1]  # far first; near overwrites
    flat_o = flat[order]
    src = np.nonzero(ok)[0][order]

    depth = np.zeros(im_h * im_w, np.float32)
    winner = np.full(im_h * im_w, -1, np.int64)
    depth[flat_o] = z[ok][order]
    winner[flat_o] = src

    mask = winner >= 0
    widx = winner[mask]
    coordinate = np.zeros((im_h * im_w, 3), np.float32)
    coordinate[mask] = obj.points[widx]
    normal_cam = np.zeros((im_h * im_w, 3), np.float32)
    normal_cam[mask] = obj.normals[widx] @ r.T

    # region label: nearest FPS center of the surface point (+1; 0 = bg)
    d2 = ((obj.points[widx][:, None] - obj.fps_centers[None]) ** 2).sum(-1)
    region = np.zeros(im_h * im_w, np.int32)
    region[mask] = d2.argmin(-1) + 1

    # Shaded rgb from normals + multi-octave object-frame texture.
    # Coordinate-regression targets need appearance ANCHORED to object-
    # frame position (LineMOD objects are textured, batchdataset.py's
    # frames); fixture v1's single |sin(40p)| octave spanned < 1 period
    # across a 5 cm object — per-point coords were unobservable up to
    # surface sliding, measured as a ~12 deg PnP-rotation floor that no
    # solver setting recovered (RESULTS eval_ablation, r3).
    shade = np.clip(-normal_cam[:, 2], 0.05, 1.0)
    p = obj.points
    albedo = np.clip(
        0.35 + 0.40 * np.abs(np.sin(p * 40.0))
        + 0.20 * np.sin(p @ _TEX_M1.T * 150.0)    # ~4 cm period
        + 0.15 * np.sin(p @ _TEX_M2.T * 450.0)    # ~1.4 cm
        + 0.10 * np.sin(p @ _TEX_M3.T * 1200.0),  # ~5 mm
        0.05, 1.0)
    rgb = np.zeros((im_h * im_w, 3), np.float32)
    rgb[mask] = albedo[widx] * shade[mask][:, None]
    bg = rng.rand(im_h, im_w, 3).astype(np.float32) * 0.2
    rgb = rgb.reshape(im_h, im_w, 3)
    rgb = np.where(mask.reshape(im_h, im_w, 1), rgb, bg)

    return {
        "rgb": rgb,
        "depth": depth.reshape(im_h, im_w),
        "mask": mask.reshape(im_h, im_w),
        "coordinate": coordinate.reshape(im_h, im_w, 3),
        "normal": normal_cam.reshape(im_h, im_w, 3),
        "region": region.reshape(im_h, im_w),
        "r": r.astype(np.float32),
        "t": t.astype(np.float32),
        "k": k.astype(np.float32),
    }


def random_pose(rng: np.random.RandomState):
    """Random rotation + translation in the camera frustum, LineMOD-like."""
    a = rng.randn(3, 3)
    q, _ = np.linalg.qr(a)
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    t = np.array([rng.uniform(-0.15, 0.15), rng.uniform(-0.1, 0.1),
                  rng.uniform(0.6, 1.1)])
    return q.astype(np.float32), t.astype(np.float32)


class SyntheticPoseDataset:
    """Iterable dataset of rendered frames for `num_objects` procedural
    objects — the stand-in for PoseDataset (batchdataset.py:33-818) in tests
    and CPU benchmarks. Index -> full-frame sample dict + object meta."""

    def __init__(self, num_objects: int = 3, frames_per_object: int = 8,
                 seed: int = 0, im_h: int = 480, im_w: int = 640,
                 num_regions: int = 16, pose_seed: int = 0,
                 sym_objects: tuple = (), cache_frames: bool = False):
        """`pose_seed` shifts the pose RNG only (same objects, disjoint
        poses — the train/held-out split). `sym_objects`: class ids to mark
        symmetric (eggbox/glue semantics for ADD-S coverage).
        `cache_frames` memoizes rendered frames by index (poses are
        deterministic per index, so this is lossless): the splat render is
        ~150 ms/frame on the single host CPU, which makes multi-epoch
        training host-bound without it (~3.4 MB per 240x320 frame)."""
        self.objects = [make_object(seed + i, num_regions=num_regions,
                                    sym=i in sym_objects)
                        for i in range(num_objects)]
        self.frames_per_object = frames_per_object
        self.seed = seed
        self.pose_seed = pose_seed
        self.im_h, self.im_w = im_h, im_w
        # DEFAULT_K is calibrated for 640x480; scale to the render size so
        # the principal point stays inside the image.
        self.k = DEFAULT_K.copy()
        self.k[0] *= im_w / 640.0
        self.k[1] *= im_h / 480.0
        self._frame_cache: dict | None = {} if cache_frames else None

    @property
    def objects_by_cls(self):
        return self.objects  # already a 0-based list

    def __len__(self):
        return len(self.objects) * self.frames_per_object

    def __getitem__(self, i):
        if self._frame_cache is not None and i in self._frame_cache:
            return self._frame_cache[i]
        obj_id = i % len(self.objects)
        obj = self.objects[obj_id]
        rng = np.random.RandomState(self.seed * 7919
                                    + self.pose_seed * 1000003 + i)
        r, t = random_pose(rng)
        frame = render_frame(obj, r, t, k=self.k, im_h=self.im_h,
                             im_w=self.im_w, rng=rng)
        frame["cls_id"] = obj_id
        if self._frame_cache is not None:
            self._frame_cache[i] = frame
        return frame

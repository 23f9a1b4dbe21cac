"""Cleargrasp transparent-object dataset reader (counterpart of the JAX
package's data/cleargrasp.py, carried over unchanged but for the EXR
module's import; tests/test_torch_transparent_data.py pins the frames equal
bit for bit).

Rebuild of version/transparent/datasets/cleargrasp/dataset.py: per-image
instance extraction with EXR ground-truth normals/depth, json world poses,
per-object symmetry axes, and the BathPoseDataset single-instance 256x256
resize variant (:695-824). The reference's per-image variable-length
instance lists (a dynamic-shape hazard, SURVEY.md section 7.3.2) become
one-instance-per-sample records with a fixed crop size.

Layout (cleargrasp-dataset-train):
  <root>/<object-name>-train/
    rgb-imgs/XXXXXX-rgb.jpg
    depth-imgs-rectified/XXXXXX-depth-rectified.exr
    camera-normals/XXXXXX-cameraNormals.exr
    variant-masks/XXXXXX-variantMasks.exr
    json-files/XXXXXX-masks.json
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

# Per-object symmetry axes (dataconfig/config.yaml:18-23: cup Z, flower XZ,
# heart XY, square Z, stemless Z) as (x, y, z) weight masks for the
# axis-symmetry rotation loss.
CLEARGRASP_OBJECTS = {
    "cup-with-waves": np.array([0.0, 0.0, 1.0], np.float32),
    "flower-bath-bomb": np.array([1.0, 0.0, 1.0], np.float32),
    "heart-bath-bomb": np.array([1.0, 1.0, 0.0], np.float32),
    "square-plastic-bottle": np.array([0.0, 0.0, 1.0], np.float32),
    "stemless-plastic-champagne-glass": np.array([0.0, 0.0, 1.0],
                                                 np.float32),
}


def load_obj_mesh(path: str):
    """Minimal wavefront .obj parse -> (verts [V,3], faces [F,3] int)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1
                       for tok in line.split()[1:]]
                for j in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[j], idx[j + 1]])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int64).reshape(-1, 3))


def sample_points_from_mesh(path: str, n: int,
                            seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling (the lib/utils.py:126-201
    sampler the reference's get_model uses, cleargrasp/dataset.py:669-687)."""
    verts, faces = load_obj_mesh(path)
    if len(faces) == 0:
        rng = np.random.RandomState(seed)
        return verts[rng.choice(len(verts), n, replace=len(verts) < n)]
    tri = verts[faces]                                    # [F,3,3]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    rng = np.random.RandomState(seed)
    fi = rng.choice(len(faces), n, p=area / area.sum())
    u = rng.rand(n, 1)
    v = rng.rand(n, 1)
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    t = tri[fi]
    return (t[:, 0] + u * (t[:, 1] - t[:, 0])
            + v * (t[:, 2] - t[:, 0])).astype(np.float32)


def read_exr(path: str) -> np.ndarray:
    """EXR decode (cleargrasp/dataset.py:328-341 uses cv2's OpenEXR
    bindings). The native numpy codec (data/exr.py) is primary — many
    cv2 builds, including this image's, ship without OpenEXR — with cv2
    as the fallback for compressions the native reader doesn't cover
    (PIZ/PXR24/B44/DWA)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    from pose_estimation_tpu_torch.data import exr
    try:
        return exr.read_exr(path).astype(np.float32)
    except NotImplementedError:
        pass
    import cv2
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"{path}: undecodable EXR (native reader "
                         "lacks its compression; cv2 lacks OpenEXR)")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img.astype(np.float32)


@dataclasses.dataclass
class ClearGraspInstance:
    obj_name: str
    obj_id: int
    rgb_path: str
    depth_path: str
    normal_path: str
    mask_path: str
    r: np.ndarray
    t: np.ndarray
    k: np.ndarray
    instance_id: int


class ClearGraspDataset:
    """One sample per (frame, instance), filtered by visible area
    (cleargrasp/dataset.py:207-215)."""

    def __init__(self, root: str, split: str = "train",
                 min_visible_px: int = 900, crop_size: int = 256,
                 num_points: int = 1000):
        self.root = root
        self.crop_size = crop_size
        self.num_points = num_points
        self.names = sorted(CLEARGRASP_OBJECTS.keys())
        self.instances: list[ClearGraspInstance] = []
        suffix = "-train" if split == "train" else "-val"
        for oid, name in enumerate(self.names):
            odir = os.path.join(root, f"{name}{suffix}")
            jdir = os.path.join(odir, "json-files")
            if not os.path.isdir(jdir):
                continue
            for jf in sorted(os.listdir(jdir)):
                stem = jf.split("-")[0]
                meta = json.load(open(os.path.join(jdir, jf)))
                k = _intrinsics_from_meta(meta)
                for inst_id, inst in _iter_instances(meta):
                    r, t = _pose_from_meta(inst)
                    if r is None:
                        continue
                    self.instances.append(ClearGraspInstance(
                        obj_name=name, obj_id=oid,
                        rgb_path=os.path.join(
                            odir, "rgb-imgs", f"{stem}-rgb.jpg"),
                        depth_path=os.path.join(
                            odir, "depth-imgs-rectified",
                            f"{stem}-depth-rectified.exr"),
                        normal_path=os.path.join(
                            odir, "camera-normals",
                            f"{stem}-cameraNormals.exr"),
                        mask_path=os.path.join(
                            odir, "variant-masks",
                            f"{stem}-variantMasks.exr"),
                        r=r, t=t, k=k, instance_id=inst_id))

    def __len__(self):
        return len(self.instances)

    def axis(self, obj_id: int) -> np.ndarray:
        return CLEARGRASP_OBJECTS[self.names[obj_id]]

    def model_points(self, obj_id: int,
                     num_points: int = 10000) -> np.ndarray:
        """Surface samples of the object's .obj mesh from <root>/models/
        (get_model, cleargrasp/dataset.py:669-687). The square bottle's
        mesh is stored at 1/10 scale — the reference multiplies its
        rotation by 10 (dataset.py:489-490), which is equivalent to
        scaling the model points; done here explicitly."""
        if not hasattr(self, "_model_cache"):
            self._model_cache = {}
        if obj_id not in self._model_cache:
            name = self.names[obj_id]
            path = os.path.join(self.root, "models", f"{name}.obj")
            pts = sample_points_from_mesh(path, num_points, seed=obj_id)
            if name == "square-plastic-bottle":
                pts = pts * 10.0
            self._model_cache[obj_id] = pts
        return self._model_cache[obj_id]

    def __getitem__(self, i):
        import cv2
        inst = self.instances[i]
        rgb = cv2.cvtColor(cv2.imread(inst.rgb_path),
                           cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        depth = read_exr(inst.depth_path)
        if depth.ndim == 3:
            depth = depth[..., 0]
        normal = read_exr(inst.normal_path)
        variant = read_exr(inst.mask_path)
        if variant.ndim == 3:
            variant = variant[..., 0]
        mask = variant == float(inst.instance_id)
        return {
            "rgb": rgb, "depth": depth, "normal": normal,
            "mask": mask, "r": inst.r, "t": inst.t, "k": inst.k,
            "cls_id": inst.obj_id,
            "axis": self.axis(inst.obj_id),
        }


def _intrinsics_from_meta(meta: dict) -> np.ndarray:
    cam = meta.get("camera", {})
    fov_x = cam.get("field_of_view", {}).get("x_axis_rads", 1.2112)
    w = meta.get("image", {}).get("width_px", 1920)
    h = meta.get("image", {}).get("height_px", 1080)
    fx = w / (2.0 * np.tan(fov_x / 2.0))
    return np.array([[fx, 0, w / 2.0], [0, fx, h / 2.0], [0, 0, 1]],
                    np.float32)


def _iter_instances(meta: dict):
    objs = meta.get("variants", {}).get("masks_and_poses_by_pixel_value", {})
    for pixel_value, inst in objs.items():
        yield int(pixel_value), inst


def _pose_from_meta(inst: dict):
    """World pose -> camera pose. The json stores quaternion + location in
    the blender world frame with the camera at a known pose
    (cleargrasp/dataset.py:204-239)."""
    try:
        q = inst["pose"]["rotation"]["quaternion"]
        loc = inst["pose"]["location"]
    except (KeyError, TypeError):
        return None, None
    w, x, y, z = q[3], q[0], q[1], q[2]  # json is (x,y,z,w)
    r = _quat_to_mat(np.array([w, x, y, z], np.float64))
    t = np.array(loc, np.float64)
    # blender camera looks down -Z with +Y up; convert to CV convention
    flip = np.diag([1.0, -1.0, -1.0])
    return (flip @ r).astype(np.float32), (flip @ t).astype(np.float32)


def _quat_to_mat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])

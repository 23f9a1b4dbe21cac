"""LineMOD dataset readers — preprocessed and BOP layouts.

Rebuild of dataset/linemod/batchdataset.py (preprocessed layout: per-object
rgb/depth/gt.yml + precomputed label pickles) and dataset/linemod/lm_bop.py
(BOP layout: scene_gt.json / scene_camera.json / ply models).

Key structural difference: the reference REQUIRES precomputed
coordinate/region/normal pickles produced by scripts not in its repo
(batchdataset.py:200-210). This reader REGENERATES those labels on the fly
from mesh + pose via the point-splat renderer (data/synthetic.render_frame
machinery) — the derivation SURVEY.md section 7.3.5 calls for:
  coordinate map = z-buffer splat of object-frame coords,
  region = nearest of the FPS centers, normal = rotated mesh normals.

Frames come out in the same dict schema as the synthetic dataset, so
data/batching.frame_to_sample and the whole train/eval stack work
unchanged.

The JAX package's data/linemod.py carried over unchanged, but for the
imports of OpenCV and PyYAML: each is imported where the JAX reader
imports it (OpenCV when a reader is built, PyYAML where a .yml file is
read), and without it the ImportError names the tree or the file.
tests/test_torch_data.py pins the frames equal to the JAX reader's.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from pose_estimation_tpu_torch.data.synthetic import (
    SynObject, _fps_numpy, render_frame)

# 13-object list and symmetric ids (batchdataset.py:42,76: eggbox=10,
# glue=11 are symmetric).
LINEMOD_OBJECTS = [1, 2, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15]
LINEMOD_NAMES = ["ape", "benchvise", "camera", "can", "cat", "driller",
                 "duck", "eggbox", "glue", "holepuncher", "iron", "lamp",
                 "phone"]
SYM_OBJ_IDS = {10, 11}

LINEMOD_K = np.array([[572.4114, 0., 325.2611],
                      [0., 573.57043, 242.04899],
                      [0., 0., 1.]], np.float32)


def require_cv2(path: str):
    """OpenCV, for the images under `path`."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: reading these images needs OpenCV "
                          "(cv2), which is not installed") from e
    return cv2


def require_yaml(path: str):
    """PyYAML, for the .yml file `path`."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"{path}: reading this file needs PyYAML, which "
                          "is not installed") from e
    return yaml


def load_ply_points(path: str, max_points: int | None = None):
    """Minimal PLY reader (ascii or binary_little_endian) -> points,
    normals (or None). Replaces plyfile (lm_bop.py:528-544)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_vert = int(next(l.split()[2] for l in header
                          if l.startswith("element vertex")))
        props = []
        in_vertex = False
        for l in header:
            if l.startswith("element"):
                in_vertex = l.startswith("element vertex")
            elif l.startswith("property") and in_vertex:
                parts = l.split()
                props.append((parts[-1], parts[1]))

        type_map = {"float": "f4", "float32": "f4", "double": "f8",
                    "uchar": "u1", "uint8": "u1", "int": "i4",
                    "uint": "u4", "short": "i2", "ushort": "u2"}
        if fmt == "ascii":
            rows = []
            for _ in range(n_vert):
                rows.append(f.readline().split()[:len(props)])
            arr = np.array(rows, np.float64)
            data = {name: arr[:, i] for i, (name, _) in enumerate(props)}
        else:
            dtype = np.dtype([(name, "<" + type_map[t]) for name, t in props])
            raw = np.frombuffer(f.read(n_vert * dtype.itemsize), dtype=dtype,
                                count=n_vert)
            data = {name: raw[name].astype(np.float64)
                    for name, _ in props}

    pts = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
    normals = None
    if "nx" in data:
        normals = np.stack([data["nx"], data["ny"], data["nz"]],
                           -1).astype(np.float32)
    if max_points and len(pts) > max_points:
        sel = np.random.RandomState(0).choice(len(pts), max_points,
                                              replace=False)
        pts = pts[sel]
        normals = normals[sel] if normals is not None else None
    return pts, normals


def _object_from_points(pts_m: np.ndarray, normals: np.ndarray | None,
                        num_regions: int, num_model: int = 500,
                        sym: bool = False,
                        diameter: float | None = None) -> SynObject:
    """`diameter`: true max-pairwise diameter in meters (BOP
    models_info 'diameter'/1000, lm_bop.py:178). Falls back to the bbox
    diagonal, which is >= the true diameter and therefore loosens
    ADD(-S) < 0.1*d thresholds — only acceptable for synthetic fixtures."""
    rng = np.random.RandomState(0)
    if normals is None:
        # radial approximation about the centroid
        c = pts_m.mean(0)
        normals = pts_m - c
        normals /= np.maximum(
            np.linalg.norm(normals, axis=-1, keepdims=True), 1e-8)
    lf = pts_m.min(0)
    ext = pts_m.max(0) - lf
    model_idx = rng.choice(len(pts_m), min(num_model, len(pts_m)),
                           replace=False)
    return SynObject(
        points=pts_m.astype(np.float32),
        normals=normals.astype(np.float32),
        fps_centers=pts_m[_fps_numpy(pts_m, num_regions, rng)].astype(
            np.float32),
        diameter=float(np.linalg.norm(ext)) if diameter is None
        else float(diameter),
        extent=ext.astype(np.float32),
        lf_border=lf.astype(np.float32),
        model_points=pts_m[model_idx].astype(np.float32),
        sym=sym)


class LinemodBOPDataset:
    """BOP-layout reader (lm_bop.py): root/{models,test|train_pbr}/...

    root/
      models/obj_XXXXXX.ply, models_info.json   (mm units)
      <split>/<scene>/rgb/*.png, depth/*.png,
                     scene_gt.json, scene_camera.json
    """

    # splits whose frames are empty-background renders needing a paste
    # (the reference pastes COCO backgrounds on its `render`-type frames,
    # lm_bop.py:235-244; BOP synthetic subtrees named like these carry
    # renders on black)
    PASTE_SPLITS = ("train_synt", "train_render", "render")

    def __init__(self, root: str, split: str = "test",
                 cls_type: str = "all", num_regions: int = 64,
                 depth_scale: float = 1000.0,
                 object_ids: list[int] | None = None,
                 sym_ids: set[int] | None = None,
                 object_names: list[str] | None = None,
                 eval_bboxes: bool = False,
                 background_dir: str | None = None,
                 seed: int = 0):
        self._cv2 = require_cv2(root)  # host-side decode only
        self.root = root
        self.split = split
        self.num_regions = num_regions
        self.depth_scale = depth_scale
        self.epoch = 0
        self.seed = seed
        self._background_dir = background_dir
        self._backgrounds = None  # lazy BackgroundBank
        self.sym_ids = SYM_OBJ_IDS if sym_ids is None else sym_ids
        # yolov3 detection bboxes for eval crops instead of gt masks
        # (lm_bop.py:100-101,170) — gt-mask crops inflate eval accuracy.
        self.eval_bboxes = {}
        if eval_bboxes:
            bb_path = os.path.join(root, "test", "test_bboxes",
                                   "bbox_yolov3_all.json")
            if os.path.isfile(bb_path):
                with open(bb_path) as f:
                    self.eval_bboxes = json.load(f)

        models_dir = os.path.join(root, "models")
        info_path = os.path.join(models_dir, "models_info.json")
        with open(info_path) as f:
            self.models_info = {int(k): v for k, v in json.load(f).items()}

        all_ids = object_ids if object_ids is not None else LINEMOD_OBJECTS
        names = object_names if object_names is not None else LINEMOD_NAMES
        wanted = (all_ids if cls_type == "all"
                  else [all_ids[names.index(cls_type)]])
        self.objects = {}
        self.obj_index = {}
        self._objects_by_cls = []
        for oid in wanted:
            ply = os.path.join(models_dir, f"obj_{oid:06d}.ply")
            if not os.path.isfile(ply):
                continue  # subset trees (single-object downloads) are legal
            pts, nrm = load_ply_points(ply, max_points=20000)
            diam_mm = self.models_info.get(oid, {}).get("diameter")
            obj = _object_from_points(
                pts / 1000.0, nrm, num_regions,
                sym=oid in self.sym_ids,
                diameter=None if diam_mm is None else diam_mm / 1000.0)
            self.obj_index[oid] = len(self.objects)
            self.objects[oid] = obj
            self._objects_by_cls.append(obj)

        self.index = []  # (scene_dir, im_id, obj_id, R, t, K, depth_scale)
        # `split` may be a list of subtrees composed into one index —
        # YCB-V trains on real + synthetic frames jointly
        # (version/transparent/datasets/ycb/dataset.py:43-50 builds the
        # train list from both sources).
        splits = [split] if isinstance(split, str) else list(split)
        scene_dirs = []
        for sp in splits:
            split_dir = os.path.join(root, sp)
            scene_dirs += [os.path.join(split_dir, s)
                           for s in sorted(os.listdir(split_dir))]
        for sdir in scene_dirs:
            gt_p = os.path.join(sdir, "scene_gt.json")
            cam_p = os.path.join(sdir, "scene_camera.json")
            if not (os.path.isfile(gt_p) and os.path.isfile(cam_p)):
                continue
            with open(gt_p) as f:
                gts = json.load(f)
            with open(cam_p) as f:
                cams = json.load(f)
            for im_id, instances in gts.items():
                cam_k = np.array(cams[im_id]["cam_K"],
                                 np.float32).reshape(3, 3)
                # BOP per-image depth unit: png * depth_scale = mm
                # (train_pbr stores 0.1; lm test stores 1.0)
                dscale = float(cams[im_id].get("depth_scale", 1.0))
                for inst in instances:
                    oid = int(inst["obj_id"])
                    if oid not in self.objects:
                        continue
                    r = np.array(inst["cam_R_m2c"],
                                 np.float32).reshape(3, 3)
                    t = np.array(inst["cam_t_m2c"],
                                 np.float32) / 1000.0
                    self.index.append(
                        (sdir, int(im_id), oid, r, t, cam_k, dscale))

    def __len__(self):
        return len(self.index)

    def set_epoch(self, epoch: int):
        """DistributedSampler.set_epoch analog for augmentation: the
        trainer calls this each epoch so per-sample RNG draws differ
        across visits (subclass hooks fold self.epoch into their seed)."""
        self.epoch = int(epoch)

    @property
    def objects_list(self):
        return list(self.objects.values())

    @property
    def objects_by_cls(self):
        """Objects indexed by the 0-based `cls_id` emitted in frames — the
        batching contract (data/batching.make_batch). `self.objects` stays
        keyed by BOP object id (1..15)."""
        return self._objects_by_cls

    def __getitem__(self, i):
        sdir, im_id, oid, r, t, k, dscale = self.index[i]
        cv2 = self._cv2
        rgb_path = os.path.join(sdir, "rgb", f"{im_id:06d}.png")
        if not os.path.isfile(rgb_path):
            rgb_path = os.path.join(sdir, "rgb", f"{im_id:06d}.jpg")
        rgb = cv2.cvtColor(cv2.imread(rgb_path), cv2.COLOR_BGR2RGB)
        depth_path = os.path.join(sdir, "depth", f"{im_id:06d}.png")
        depth = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED).astype(
            np.float32) * dscale / self.depth_scale

        obj = self.objects[oid]
        h, w = depth.shape
        # regenerate labels by splatting the model at the gt pose
        frame = render_frame(obj, r, t, k=k, im_h=h, im_w=w)
        frame["rgb"] = rgb.astype(np.float32) / 255.0
        # real depth where the splat says object; keeps sensor noise
        frame["depth"] = np.where(frame["mask"] & (depth > 0), depth, 0.0)
        frame["mask"] = frame["mask"] & (depth > 0)
        frame["cls_id"] = self.obj_index[oid]
        frame["obj_id"] = oid
        det = self.eval_bboxes.get(f"{oid}/{im_id}")
        if det:
            x, y, bw, bh = det[0]["bbox_est"]
            frame["det_center"] = np.array([x + bw / 2.0, y + bh / 2.0],
                                           np.float32)
            frame["det_side"] = np.float32(max(bw, bh) * 1.2)
        return self._post_frame(frame, depth, i, sdir)

    def _post_frame(self, frame: dict, depth_full: np.ndarray, i: int,
                    sdir: str) -> dict:
        """Subclass hook after frame assembly; receives the full-frame
        depth (frame['depth'] is already masked to the target object).

        Base behavior: frames from an empty-background render split
        (PASTE_SPLITS) get a random background pasted over their
        non-rendered pixels — the reference's COCO paste for `render`
        frames (lm_bop.py:235-244). YCB-V overrides with its own paste +
        augmentation."""
        import os
        parts = os.path.normpath(sdir).split(os.sep)
        if any(p in self.PASTE_SPLITS for p in parts):
            if self._backgrounds is None:
                from pose_estimation_tpu_torch.data.augment import BackgroundBank
                self._backgrounds = BackgroundBank(self._background_dir)
            from pose_estimation_tpu_torch.data.augment import paste_background
            rng = np.random.RandomState(
                (self.seed * 77003 + self.epoch * 9176723 + i) % (2 ** 31))
            scene_mask = (depth_full > 0).astype(np.int32)
            frame["rgb"] = paste_background(rng, frame["rgb"], scene_mask,
                                            self._backgrounds)
        return frame


class LinemodClassicDataset:
    """Classic preprocessed LineMOD layout (batchdataset.py:33-818):

    root/
      models/obj_XX.ply (mm) [+ models_info.yml with diameters]
      data/XX/{rgb,depth,mask}/NNNN.png, gt.yml, train.txt, test.txt
      renders/<name>/file_list.txt + *.pkl   (optional synthetic)
      fuse/<name>/file_list.txt + *.pkl      (optional synthetic)
      segnet_results/XX_label/NNNN_label.png (optional eval masks)

    Labels (coordinate/region/normal) are REGENERATED from mesh + gt pose
    by the splat renderer — the reference instead loads pickles produced by
    offline scripts not in its repo (batchdataset.py:200-210).

    Train-list composition (batchdataset.py:130-145): real x3 + NUM_SYN
    sampled renders + NUM_SYN sampled fuse when part_syn, else real x11 +
    all synthetic. Eval mode uses segnet masks (batchdataset.py:212-219)
    when present.
    """

    def __init__(self, root: str, mode: str = "train", cls_type: str = "all",
                 num_regions: int = 64, num_syn: int = 1000,
                 part_syn: bool = True, add_noise: bool = False,
                 noise_trans: float = 0.03, background_dir: str = "",
                 seed: int = 0):
        self._cv2 = require_cv2(root)
        self.root = root
        self.mode = mode
        self.num_regions = num_regions
        self.add_noise = add_noise and mode == "train"
        self.noise_trans = noise_trans
        self.seed = seed
        self.epoch = 0
        from pose_estimation_tpu_torch.data.augment import BackgroundBank
        self.backgrounds = BackgroundBank(background_dir or None)

        wanted = (LINEMOD_OBJECTS if cls_type == "all"
                  else [LINEMOD_OBJECTS[LINEMOD_NAMES.index(cls_type)]])

        self.models_info = self._load_models_info()
        self.objects = {}
        self.obj_index = {}
        self._objects_by_cls = []
        self.index = []  # real: ('real', oid, im_id) / syn: ('syn', oid, path)
        rng = np.random.RandomState(seed)
        for oid in wanted:
            cls_root = os.path.join(root, "data", f"{oid:02d}")
            ply = os.path.join(root, "models", f"obj_{oid:02d}.ply")
            if not (os.path.isdir(cls_root) and os.path.isfile(ply)):
                continue
            pts, nrm = load_ply_points(ply, max_points=20000)
            diam_mm = self.models_info.get(oid, {}).get("diameter")
            obj = _object_from_points(
                pts / 1000.0, nrm, num_regions,
                sym=oid in SYM_OBJ_IDS,
                diameter=None if diam_mm is None else diam_mm / 1000.0)
            self.obj_index[oid] = len(self.objects)
            self.objects[oid] = obj
            self._objects_by_cls.append(obj)

            gt_path = os.path.join(cls_root, "gt.yml")
            with open(gt_path) as f:
                meta = require_yaml(gt_path).safe_load(f)
            self._meta = getattr(self, "_meta", {})
            self._meta[oid] = meta

            list_file = "train.txt" if mode == "train" else "test.txt"
            ids = self._read_lines(os.path.join(cls_root, list_file))
            real = [("real", oid, im_id) for im_id in ids]
            if mode == "train":
                name = LINEMOD_NAMES[LINEMOD_OBJECTS.index(oid)]
                syn = self._syn_list(name, oid, num_syn, part_syn, rng)
                # real x3 (+ x11 when not part_syn) — batchdataset.py:136-143
                reps = 3 if part_syn else 11
                self.index += real * reps + syn
            else:
                self.index += real

    @staticmethod
    def _read_lines(path):
        if not os.path.isfile(path):
            return []
        with open(path) as f:
            return [l.strip() for l in f if l.strip()]

    def _load_models_info(self):
        for fname in ("models_info.yml", "models_info.json"):
            p = os.path.join(self.root, "models", fname)
            if os.path.isfile(p):
                loader = (json.load if fname.endswith(".json")
                          else require_yaml(p).safe_load)
                with open(p) as f:
                    return {int(k): v for k, v in loader(f).items()}
        return {}

    def _syn_list(self, name, oid, num_syn, part_syn, rng):
        out = []
        for kind in ("renders", "fuse"):
            d = os.path.join(self.root, kind, name)
            part = os.path.join(d, "file_list_part_5000.txt")
            full = os.path.join(d, "file_list.txt")
            if part_syn and os.path.isfile(part):
                lst = self._read_lines(part)
                lst = [lst[i] for i in
                       rng.choice(len(lst), min(num_syn, len(lst)),
                                  replace=False)]
            else:
                lst = self._read_lines(full)
            out += [("syn", oid, p) for p in lst]
        return out

    @property
    def objects_by_cls(self):
        return self._objects_by_cls

    def __len__(self):
        return len(self.index)

    def _frame_from_pose(self, obj, r, t, k, im_h, im_w, rgb, depth, mask):
        frame = render_frame(obj, r, t, k=k, im_h=im_h, im_w=im_w)
        frame["rgb"] = rgb
        frame["depth"] = np.where(frame["mask"] & (depth > 0), depth, 0.0)
        frame["mask"] = frame["mask"] & (depth > 0) & mask
        return frame

    def set_epoch(self, epoch: int):
        """Per-epoch reseed of augmentation draws (see BOP reader)."""
        self.epoch = int(epoch)

    def __getitem__(self, i):
        cv2 = self._cv2
        kind, oid, ref = self.index[i]
        obj = self.objects[oid]
        # Fresh augmentation draws every visit (torchvision transforms
        # re-sample per __getitem__ in the reference): fold the epoch set
        # by the trainer into the per-sample seed, else jitter/noise/
        # background collapse to one fixed draw per sample for the whole
        # run.
        rng = np.random.RandomState(
            (self.seed * 33331 + self.epoch * 9176723 + i) % (2 ** 31))
        if kind == "real":
            cls_root = os.path.join(self.root, "data", f"{oid:02d}")
            im = int(ref)
            rgb = cv2.cvtColor(
                cv2.imread(os.path.join(cls_root, "rgb", f"{im:04d}.png")),
                cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
            depth = cv2.imread(
                os.path.join(cls_root, "depth", f"{im:04d}.png"),
                cv2.IMREAD_UNCHANGED).astype(np.float32) / 1000.0
            # eval: segnet detection masks (batchdataset.py:212-219)
            seg = os.path.join(self.root, "segnet_results",
                               f"{oid:02d}_label", f"{im:04d}_label.png")
            if self.mode == "eval" and os.path.isfile(seg):
                label = cv2.imread(seg, cv2.IMREAD_UNCHANGED)
                mask = (np.asarray(label) == 255)
                if mask.ndim == 3:
                    mask = mask[..., 0]
            else:
                mpath = os.path.join(cls_root, "mask", f"{im:04d}.png")
                if os.path.isfile(mpath):
                    lab = cv2.imread(mpath, cv2.IMREAD_UNCHANGED)
                    mask = np.asarray(lab).reshape(lab.shape[0],
                                                   lab.shape[1], -1)
                    mask = mask[..., 0] == 255
                else:
                    mask = depth > 0
            # gt.yml meta: list per im; select this object's entry
            # (batchdataset.py:230-236, driller scene lists many objects)
            entries = self._meta[oid][im]
            entry = next((e for e in entries if e.get("obj_id") == oid),
                         entries[0])
            r = np.array(entry["cam_R_m2c"], np.float32).reshape(3, 3)
            t = np.array(entry["cam_t_m2c"], np.float32) / 1000.0
            h, w = depth.shape
            # classic LineMOD is 640x480 with fixed intrinsics
            # (batchdataset.py:79-87); scale for resized trees/fixtures
            k = LINEMOD_K.copy()
            k[0] *= w / 640.0
            k[1] *= h / 480.0
        else:  # synthetic pkl (renders/fuse — batchdataset.py:264-337)
            with open(os.path.join(self.root, ref), "rb") as f:
                data = pickle.load(f)
            rgb = np.asarray(data["rgb"])[:, :, :3].astype(np.float32)
            if rgb.max() > 2.0:
                rgb = rgb / 255.0
            depth = np.asarray(data["depth"]).astype(np.float32)
            labels = np.asarray(data["mask"])
            rt = np.asarray(data["RT"], np.float32)
            r, t = rt[:, :3], rt[:, 3]
            k = np.asarray(data.get("K", LINEMOD_K), np.float32)
            if data.get("rnd_typ") == "fuse":
                mask = labels == self.obj_index[oid] + 1
            else:
                mask = labels > 0
                if self.add_noise or self.mode == "train":
                    # render frames have empty backgrounds: paste one
                    # (lm_bop.py:235-244)
                    from pose_estimation_tpu_torch.data.augment import (
                        paste_background)
                    rgb = paste_background(rng, rgb, mask.astype(np.int32),
                                           self.backgrounds)
            if mask.ndim == 3:
                mask = mask[..., 0]
            h, w = depth.shape

        frame = self._frame_from_pose(obj, r, t, k, h, w, rgb, depth, mask)
        if self.add_noise:
            from pose_estimation_tpu_torch.data.augment import (
                color_jitter, translation_noise)
            frame["rgb"] = color_jitter(rng, frame["rgb"])
            frame["t_noise"] = translation_noise(rng, self.noise_trans)
        frame["cls_id"] = self.obj_index[oid]
        frame["obj_id"] = oid
        return frame


def _is_classic_tree(root: str) -> bool:
    data_dir = os.path.join(root, "data")
    if not os.path.isdir(data_dir):
        return False
    return any(os.path.isfile(os.path.join(data_dir, d, "gt.yml"))
               for d in os.listdir(data_dir))


class LinemodDataset:
    """CLI entry point: dispatches on the on-disk layout — classic
    preprocessed trees (data/XX/gt.yml) -> LinemodClassicDataset; BOP trees
    (scene_gt.json) -> LinemodBOPDataset. Construction returns the concrete
    reader via __new__."""

    def __new__(cls, root: str, mode: str = "train", cls_type: str = "all",
                cfg=None):
        num_regions = cfg.data.num_regions if cfg else 64
        if _is_classic_tree(root):
            return LinemodClassicDataset(
                root, mode=mode, cls_type=cls_type, num_regions=num_regions,
                num_syn=cfg.data.num_syn if cfg else 1000,
                part_syn=cfg.data.part_syn if cfg else True,
                add_noise=bool(cfg.train.noise) if cfg else False,
                noise_trans=cfg.train.noise if cfg else 0.03,
                background_dir=cfg.data.back if cfg else "")
        split = {"train": "train_pbr", "test": "test",
                 "eval": "test"}.get(mode, mode)
        return LinemodBOPDataset(root, split=split, cls_type=cls_type,
                                 num_regions=num_regions,
                                 eval_bboxes=(mode == "eval"))

"""Test fixtures: write a tiny on-disk BOP tree from synthetic objects.

The reference's datasets can only be exercised against the real LineMOD
download; this module renders procedural objects (data/synthetic.py) and
writes a real BOP directory layout (models/*.ply + models_info.json,
<split>/<scene>/{rgb,depth}/*.png + scene_gt.json + scene_camera.json —
the files lm_bop.py:117-130 reads), so the disk-reader -> batch -> train
-> eval path is testable end-to-end without any dataset download.

The JAX package's data/testing.py carried over unchanged: the same files,
byte for byte (tests/test_torch_data.py).
"""

from __future__ import annotations

import json
import os

import numpy as np

from pose_estimation_tpu_torch.data.synthetic import (
    SynObject, make_object, random_pose, render_frame)

BOP_K = np.array([[572.4114, 0., 160.0],
                  [0., 573.57043, 120.0],
                  [0., 0., 1.]], np.float32)


def write_ply(path: str, points_mm: np.ndarray, normals: np.ndarray):
    """ASCII PLY with x,y,z,nx,ny,nz vertex properties."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points_mm)}\n")
        for p in ("x", "y", "z", "nx", "ny", "nz"):
            f.write(f"property float {p}\n")
        f.write("end_header\n")
        for p, n in zip(points_mm, normals):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                    f"{n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")


def write_fake_bop_tree(root: str, num_objects: int = 2,
                        frames_per_object: int = 4,
                        splits: tuple = ("train_pbr", "test"),
                        im_h: int = 240, im_w: int = 320,
                        depth_scale: float = 0.5, seed: int = 0,
                        max_ply_points: int = 3000) -> list[SynObject]:
    """Write a miniature BOP tree under `root` and return the objects.

    `depth_scale` intentionally != 1.0 so readers that ignore
    scene_camera.json's per-image depth_scale produce visibly wrong
    clouds (the train_pbr 0.1 bug class, ADVICE round 1).
    """
    objs = [make_object(seed + i, num_surface=6000, num_regions=16)
            for i in range(num_objects)]

    models_dir = os.path.join(root, "models")
    os.makedirs(models_dir, exist_ok=True)
    info = {}
    rng = np.random.RandomState(seed)
    for i, obj in enumerate(objs):
        oid = i + 1
        sel = rng.choice(len(obj.points), min(max_ply_points,
                                              len(obj.points)),
                         replace=False)
        write_ply(os.path.join(models_dir, f"obj_{oid:06d}.ply"),
                  obj.points[sel] * 1000.0, obj.normals[sel])
        # true max-pairwise diameter on the model points (mm)
        mp = obj.model_points
        d2 = ((mp[:, None] - mp[None]) ** 2).sum(-1)
        info[str(oid)] = {
            "diameter": float(np.sqrt(d2.max())) * 1000.0,
            "min_x": float(obj.lf_border[0]) * 1000.0,
            "min_y": float(obj.lf_border[1]) * 1000.0,
            "min_z": float(obj.lf_border[2]) * 1000.0,
            "size_x": float(obj.extent[0]) * 1000.0,
            "size_y": float(obj.extent[1]) * 1000.0,
            "size_z": float(obj.extent[2]) * 1000.0,
        }
    with open(os.path.join(models_dir, "models_info.json"), "w") as f:
        json.dump(info, f)

    import cv2
    k = BOP_K
    for si, split in enumerate(splits):
        sdir = os.path.join(root, split, "000001")
        for sub in ("rgb", "depth"):
            os.makedirs(os.path.join(sdir, sub), exist_ok=True)
        scene_gt, scene_cam = {}, {}
        im_id = 0
        for oi, obj in enumerate(objs):
            for fi in range(frames_per_object):
                frng = np.random.RandomState(seed + 1000 * si
                                             + 100 * oi + fi)
                r, t = random_pose(frng)
                frame = render_frame(obj, r, t, k=k, im_h=im_h, im_w=im_w,
                                     rng=frng)
                rgb8 = (np.clip(frame["rgb"], 0, 1) * 255).astype(np.uint8)
                cv2.imwrite(os.path.join(sdir, "rgb", f"{im_id:06d}.png"),
                            cv2.cvtColor(rgb8, cv2.COLOR_RGB2BGR))
                # png * depth_scale = mm  (BOP convention)
                d16 = np.round(frame["depth"] * 1000.0
                               / depth_scale).astype(np.uint16)
                cv2.imwrite(os.path.join(sdir, "depth", f"{im_id:06d}.png"),
                            d16)
                scene_gt[str(im_id)] = [{
                    "obj_id": oi + 1,
                    "cam_R_m2c": [float(x) for x in r.reshape(-1)],
                    "cam_t_m2c": [float(x) for x in t * 1000.0],
                }]
                scene_cam[str(im_id)] = {
                    "cam_K": [float(x) for x in k.reshape(-1)],
                    "depth_scale": depth_scale,
                }
                im_id += 1
        with open(os.path.join(sdir, "scene_gt.json"), "w") as f:
            json.dump(scene_gt, f)
        with open(os.path.join(sdir, "scene_camera.json"), "w") as f:
            json.dump(scene_cam, f)
    return objs


def write_fake_classic_tree(root: str, num_objects: int = 2,
                            frames_per_object: int = 4,
                            syn_per_object: int = 2,
                            im_h: int = 240, im_w: int = 320,
                            seed: int = 0,
                            max_ply_points: int = 3000) -> list[SynObject]:
    """Classic preprocessed LineMOD layout (batchdataset.py):
    models/obj_XX.ply + models_info.yml, data/XX/{rgb,depth,mask}/NNNN.png
    + gt.yml + train.txt/test.txt, renders/<name>/*.pkl synthetic frames
    with file_list.txt, segnet_results eval masks. Objects map onto the
    first `num_objects` LINEMOD ids (1=ape, 2=benchvise...)."""
    import pickle

    import cv2
    import yaml

    from pose_estimation_tpu_torch.data.linemod import (
        LINEMOD_K, LINEMOD_NAMES, LINEMOD_OBJECTS)

    objs = [make_object(seed + i, num_surface=6000, num_regions=16)
            for i in range(num_objects)]
    rng = np.random.RandomState(seed)

    models_dir = os.path.join(root, "models")
    os.makedirs(models_dir, exist_ok=True)
    info = {}
    for i, obj in enumerate(objs):
        oid = LINEMOD_OBJECTS[i]
        sel = rng.choice(len(obj.points),
                         min(max_ply_points, len(obj.points)), replace=False)
        write_ply(os.path.join(models_dir, f"obj_{oid:02d}.ply"),
                  obj.points[sel] * 1000.0, obj.normals[sel])
        mp = obj.model_points
        d2 = ((mp[:, None] - mp[None]) ** 2).sum(-1)
        info[oid] = {"diameter": float(np.sqrt(d2.max())) * 1000.0,
                     "min_x": float(obj.lf_border[0]) * 1000.0,
                     "min_y": float(obj.lf_border[1]) * 1000.0,
                     "min_z": float(obj.lf_border[2]) * 1000.0,
                     "size_x": float(obj.extent[0]) * 1000.0,
                     "size_y": float(obj.extent[1]) * 1000.0,
                     "size_z": float(obj.extent[2]) * 1000.0}
    with open(os.path.join(models_dir, "models_info.yml"), "w") as f:
        yaml.safe_dump(info, f)

    # LINEMOD_K is calibrated for 640x480: scale to the render size
    k = LINEMOD_K.copy()
    k[0] *= im_w / 640.0
    k[1] *= im_h / 480.0
    half = frames_per_object // 2
    for i, obj in enumerate(objs):
        oid = LINEMOD_OBJECTS[i]
        name = LINEMOD_NAMES[i]
        cls_root = os.path.join(root, "data", f"{oid:02d}")
        for sub in ("rgb", "depth", "mask"):
            os.makedirs(os.path.join(cls_root, sub), exist_ok=True)
        seg_dir = os.path.join(root, "segnet_results", f"{oid:02d}_label")
        os.makedirs(seg_dir, exist_ok=True)
        gt = {}
        for fi in range(frames_per_object):
            frng = np.random.RandomState(seed + 100 * i + fi)
            r, t = random_pose(frng)
            frame = render_frame(obj, r, t, k=k, im_h=im_h, im_w=im_w,
                                 rng=frng)
            rgb8 = (np.clip(frame["rgb"], 0, 1) * 255).astype(np.uint8)
            cv2.imwrite(os.path.join(cls_root, "rgb", f"{fi:04d}.png"),
                        cv2.cvtColor(rgb8, cv2.COLOR_RGB2BGR))
            cv2.imwrite(os.path.join(cls_root, "depth", f"{fi:04d}.png"),
                        np.round(frame["depth"] * 1000.0).astype(np.uint16))
            m255 = (frame["mask"].astype(np.uint8) * 255)
            cv2.imwrite(os.path.join(cls_root, "mask", f"{fi:04d}.png"),
                        np.stack([m255] * 3, -1))
            cv2.imwrite(os.path.join(seg_dir, f"{fi:04d}_label.png"), m255)
            rows = np.any(frame["mask"], 1)
            cols = np.any(frame["mask"], 0)
            rmin, rmax = np.where(rows)[0][[0, -1]]
            cmin, cmax = np.where(cols)[0][[0, -1]]
            gt[fi] = [{"obj_id": oid,
                       "cam_R_m2c": [float(x) for x in r.reshape(-1)],
                       "cam_t_m2c": [float(x) for x in t * 1000.0],
                       "obj_bb": [int(cmin), int(rmin),
                                  int(cmax - cmin), int(rmax - rmin)]}]
        with open(os.path.join(cls_root, "gt.yml"), "w") as f:
            yaml.safe_dump(gt, f)
        with open(os.path.join(cls_root, "train.txt"), "w") as f:
            f.write("\n".join(f"{fi:04d}" for fi in range(half)))
        with open(os.path.join(cls_root, "test.txt"), "w") as f:
            f.write("\n".join(f"{fi:04d}"
                              for fi in range(half, frames_per_object)))

        # synthetic renders: the pkl schema of _load_syn_data
        # (batchdataset.py:264-337)
        rnd_dir = os.path.join(root, "renders", name)
        os.makedirs(rnd_dir, exist_ok=True)
        rel_paths = []
        for si in range(syn_per_object):
            frng = np.random.RandomState(seed + 5000 + 100 * i + si)
            r, t = random_pose(frng)
            frame = render_frame(obj, r, t, k=k, im_h=im_h, im_w=im_w,
                                 rng=frng)
            pkl = {"rgb": (np.clip(frame["rgb"], 0, 1) * 255
                           ).astype(np.uint8),
                   "depth": frame["depth"].astype(np.float32),
                   "mask": frame["mask"].astype(np.uint8),
                   "RT": np.concatenate([r, t[:, None]],
                                        1).astype(np.float32),
                   "K": k, "rnd_typ": "render"}
            rel = os.path.join("renders", name, f"{si}.pkl")
            with open(os.path.join(root, rel), "wb") as f:
                pickle.dump(pkl, f)
            rel_paths.append(rel)
        for lst in ("file_list.txt", "file_list_part_5000.txt"):
            with open(os.path.join(rnd_dir, lst), "w") as f:
                f.write("\n".join(rel_paths))
    return objs

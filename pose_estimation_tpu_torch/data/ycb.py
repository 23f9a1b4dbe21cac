"""YCB-Video (BOP layout) dataset reader.

Rebuild of version/transparent/datasets/ycb/dataset.py: 21 objects,
symmetric indices {12, 15, 18, 19, 20} (dataset.py:98), real + synthetic
train lists, two intrinsics sets (CMU / UW, dataset.py:79-87), ply model
loading (:420-437). Shares the BOP reading/label-regeneration machinery
with the LineMOD reader.

The JAX package's data/ycb.py carried over unchanged.
"""

from __future__ import annotations

import numpy as np

from pose_estimation_tpu_torch.data.linemod import LinemodBOPDataset

YCB_NUM_OBJECTS = 21
YCB_SYM_IDS = {13, 16, 19, 20, 21}  # 1-based BOP obj ids of sym objects
# (0-based indices [12, 15, 18, 19, 20] in the reference's 21-object list)

K_UW = np.array([[1066.778, 0.0, 312.9869],
                 [0.0, 1067.487, 241.3109],
                 [0.0, 0.0, 1.0]], np.float32)
K_CMU = np.array([[1077.836, 0.0, 323.7872],
                  [0.0, 1078.189, 279.6921],
                  [0.0, 0.0, 1.0]], np.float32)

# 21-object class list (version/transparent/datasets/ycb/dataset.py classes
# file order; BOP obj ids are 1-based positions in this list).
YCB_NAMES = [
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
    "011_banana", "019_pitcher_base", "021_bleach_cleanser", "024_bowl",
    "025_mug", "035_power_drill", "036_wood_block", "037_scissors",
    "040_large_marker", "051_large_clamp", "052_extra_large_clamp",
    "061_foam_brick"]


class YCBVideoDataset(LinemodBOPDataset):
    """BOP-layout YCB-V; per-scene intrinsics come from scene_camera.json
    so the CMU/UW split (dataset.py:79-87) is handled transparently, and
    the per-image BOP depth_scale (0.1 for YCB-V: png units are 0.1 mm)
    comes from the same file — the divisor here only converts mm -> m.

    split='train' composes BOTH the real and synthetic subtrees
    (train_real + train_synt) into one index, the reference's
    train_data_list.txt semantics (dataset.py:43-50); synthetic frames
    get a random background pasted over their empty pixels
    (dataset.py:236-244 pastes COCO val2017; here a BackgroundBank —
    point `background_dir` at a COCO download, or it falls back to
    procedural textures so training never blocks on one) plus the
    standard color-jitter / translation-noise augmentation.
    """

    TRAIN_SPLITS = ("train_real", "train_synt")

    def __init__(self, root: str, split: str = "test",
                 cls_type: str = "all", num_regions: int = 64,
                 depth_scale: float = 1000.0,
                 augment: bool | None = None,
                 background_dir: str | None = None,
                 noise_trans: float = 0.03, seed: int = 0):
        import os
        if split == "train":
            splits = [s for s in self.TRAIN_SPLITS
                      if os.path.isdir(os.path.join(root, s))]
            splits = splits or ["train"]
        else:
            splits = [split]
        self.augment = (split == "train") if augment is None else augment
        self.noise_trans = noise_trans
        self.seed = seed
        from pose_estimation_tpu_torch.data.augment import BackgroundBank
        self.backgrounds = BackgroundBank(background_dir)
        super().__init__(root, split=splits, cls_type=cls_type,
                         num_regions=num_regions, depth_scale=depth_scale,
                         object_ids=list(range(1, YCB_NUM_OBJECTS + 1)),
                         sym_ids=YCB_SYM_IDS, object_names=YCB_NAMES)

    def is_symmetric(self, obj_id: int) -> bool:
        return obj_id in YCB_SYM_IDS

    def _post_frame(self, frame: dict, depth_full: np.ndarray, i: int,
                    sdir: str) -> dict:
        import os
        rng = np.random.RandomState(
            (self.seed * 77003 + self.epoch * 9176723 + i) % (2 ** 31))
        parts = os.path.normpath(sdir).split(os.sep)
        if "train_synt" in parts:
            # synthetic renders have empty backgrounds; keep every
            # rendered pixel (full-frame depth > 0 covers all objects,
            # not just the target instance) and paste elsewhere
            from pose_estimation_tpu_torch.data.augment import paste_background
            scene_mask = (depth_full > 0).astype(np.int32)
            frame["rgb"] = paste_background(rng, frame["rgb"], scene_mask,
                                            self.backgrounds)
        if self.augment:
            from pose_estimation_tpu_torch.data.augment import (
                color_jitter, translation_noise)
            frame["rgb"] = color_jitter(rng, frame["rgb"])
            frame["t_noise"] = translation_noise(rng, self.noise_trans)
        return frame

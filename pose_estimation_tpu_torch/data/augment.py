"""Training-time augmentation: color jitter, translation noise, background
paste.

Rebuild of the reference's augmentation surface:
- `trancolor = ColorJitter(0.2, 0.2, 0.2, 0.05)` applied to train RGB
  (batchdataset.py add_noise path; version/transparent/.../dataset.py:465)
- `noise_trans`: uniform translation jitter added to the depth cloud and
  the gt translation together (DenseFusion-style; batchdataset.py train
  branch) — teaches the t-head tolerance to depth-calibration shifts
- COCO-style background paste for synthetic 'render' frames whose
  background is empty (lm_bop.py:235-244); backgrounds come from a
  user-provided image directory (cfg.data.back) or a procedural texture
  when none is configured.

Host-side numpy; runs in the prefetcher thread per frame.
The JAX package's data/augment.py carried over unchanged (every
RandomState draw in the same order).
"""

from __future__ import annotations

import os

import numpy as np


def color_jitter(rng: np.random.RandomState, rgb: np.ndarray,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2, hue: float = 0.05) -> np.ndarray:
    """torchvision ColorJitter(0.2,0.2,0.2,0.05) equivalent on float RGB
    in [0,1]."""
    img = rgb.astype(np.float32)
    # brightness: multiply
    img = img * rng.uniform(1 - brightness, 1 + brightness)
    # contrast: blend with mean gray
    mean = img.mean()
    img = mean + (img - mean) * rng.uniform(1 - contrast, 1 + contrast)
    # saturation: blend with per-pixel gray
    gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
    img = (gray[..., None]
           + (img - gray[..., None]) * rng.uniform(1 - saturation,
                                                   1 + saturation))
    # hue: rotate channels slightly via a small rotation in RG/GB planes
    h = rng.uniform(-hue, +hue) * 2.0 * np.pi
    c, s = np.cos(h), np.sin(h)
    one3 = 1.0 / 3.0
    sq3 = 1.0 / np.sqrt(3.0)
    m = (np.full((3, 3), one3 * (1.0 - c), np.float32)
         + np.eye(3, dtype=np.float32) * c
         + sq3 * s * np.array([[0, -1, 1], [1, 0, -1], [-1, 1, 0]],
                              np.float32))
    img = img @ m.T
    return np.clip(img, 0.0, 1.0)


def translation_noise(rng: np.random.RandomState, noise_trans: float):
    """Uniform [-noise_trans, +noise_trans]^3 shift (meters), to be added
    to BOTH the depth cloud and target_t so geometry stays consistent."""
    return rng.uniform(-noise_trans, noise_trans, 3).astype(np.float32)


class BackgroundBank:
    """Random background images for synthetic-render paste
    (lm_bop.py:235-244 uses COCO). Falls back to procedural noise
    textures when no directory is configured, so training never blocks
    on an external download."""

    def __init__(self, directory: str | None = None):
        self.paths = []
        if directory and os.path.isdir(directory):
            exts = (".jpg", ".jpeg", ".png")
            self.paths = [os.path.join(directory, f)
                          for f in sorted(os.listdir(directory))
                          if f.lower().endswith(exts)]

    def sample(self, rng: np.random.RandomState, h: int, w: int
               ) -> np.ndarray:
        if self.paths:
            import cv2
            p = self.paths[rng.randint(len(self.paths))]
            img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
            img = cv2.resize(img, (w, h)).astype(np.float32) / 255.0
            return img
        # procedural: low-frequency colored noise
        small = rng.rand(h // 8 + 1, w // 8 + 1, 3).astype(np.float32)
        ys = np.linspace(0, small.shape[0] - 1, h).astype(np.int64)
        xs = np.linspace(0, small.shape[1] - 1, w).astype(np.int64)
        return small[ys][:, xs]


def paste_background(rng: np.random.RandomState, rgb: np.ndarray,
                     mask: np.ndarray, bank: BackgroundBank) -> np.ndarray:
    """Replace background pixels (mask==0) with a sampled background."""
    h, w = mask.shape
    bg = bank.sample(rng, h, w)
    return np.where(mask[..., None] > 0, rgb, bg)

"""Batch assembly (counterpart of data/batching.py): frames from a dataset
(data.synthetic) -> stacked sample dicts of torch tensors on the host."""

from __future__ import annotations

import numpy as np
import torch

from pose_estimation_tpu_torch.data.pipeline import prepare_sample


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


def epoch_indices(generator: torch.Generator, num_samples: int,
                  batch_size: int, shard_count: int = 1,
                  shard_index: int = 0) -> np.ndarray:
    """Shuffled index batches [n_batches, batch_size] of shard
    `shard_index` for one training epoch: one permutation from
    `generator` (the same on every process), every shard_count-th entry
    of it, the tail shorter than a batch dropped. Every shard runs the
    same (num_samples // shard_count) // batch_size batches, the JAX
    arithmetic: a process with one batch more would enter the step's
    collectives alone and hang the group."""
    perm = torch.randperm(num_samples, generator=generator).numpy()
    perm = perm[shard_index::shard_count]
    n_batches = (num_samples // shard_count) // batch_size
    return perm[: n_batches * batch_size].reshape(n_batches, batch_size)


def eval_indices(num_samples: int, batch_size: int, shard_count: int = 1,
                 shard_index: int = 0):
    """Deterministic full-coverage eval batches (indices, valid) of shard
    `shard_index`: every shard_count-th sample, the last batches padded
    with index 0 and valid=False, so that every shard runs the longest
    shard's ceil(ceil(num_samples / shard_count) / batch_size) batches."""
    ids = np.arange(num_samples)[shard_index::shard_count]
    longest = -(-num_samples // max(shard_count, 1))
    n_batches = max(1, -(-longest // batch_size))
    pad = n_batches * batch_size - len(ids)
    valid = np.concatenate([np.ones(len(ids), bool), np.zeros(pad, bool)])
    ids = np.concatenate([ids, np.zeros(pad, ids.dtype)])
    return (ids.reshape(n_batches, batch_size),
            valid.reshape(n_batches, batch_size))

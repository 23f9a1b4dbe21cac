"""The general traffic generator: a pool of distinct batches for a
configuration, drawn from the seed, made on the host in set-up.

The mix file gives `batch_size` and `pool_batches`; every pool holds
pool_batches x batch_size distinct frames of the configuration's objects
in a shuffled order. A serving pool adds each batch's RANSAC subsets,
[B, hypotheses, 6] indices into the solver's points, drawn here and
handed to the program and to the reference alike."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench import found
from portbench.gen.batches import frame_to_sample
from portbench.gen.synthetic import (SyntheticPoseDataset,
                                     SyntheticTransparentDataset)
from portbench.gen.transparent import frame_to_transparent_sample

THREADS = 4
DATASETS = {"pose": SyntheticPoseDataset,
            "transparent": SyntheticTransparentDataset}

# the keys InferStep reads, and the subsets
SERVE_KEYS = ("img", "cloud", "choose", "cls", "lf_border", "extent",
              "xy_choosed", "k", "region_points")
SYM_OBJECTS = (1, 3)


def seeds(seed: int, n: int = 6) -> list:
    """n 31-bit seeds derived from any whole number (the synthetic
    frames take the dataset seed under 1e5 and the pose seed under 2e3:
    their RandomState seeds stay under 2**32)."""
    return [int(s) % (2 ** 31 - 1) for s in
            np.random.SeedSequence(abs(int(seed))).generate_state(n)]


def subsets(rng: np.random.RandomState, b: int, n: int, hypotheses: int,
            size: int = 6) -> torch.Tensor:
    """[b, hypotheses, size] int64: each a duplicate-free draw of `size`
    of n points."""
    keys = rng.rand(b, hypotheses, n)
    return torch.from_numpy(np.argsort(keys, -1)[..., :size].copy())


def _krrn_sample(args, ds):
    i, noise, crop, npts = args
    frame = ds[int(i)]
    return frame_to_sample(frame, ds.objects[frame["cls_id"]], crop, npts,
                           noise=noise)


def _transparent_sample(args, ds):
    i, seed, size = args
    frame = ds[int(i)]
    rng = np.random.RandomState((seed * 100003 + int(i)) % (2 ** 31))
    return frame_to_transparent_sample(frame, ds.model_points(frame["cls_id"]),
                                       rng, img_size=size)


def samples(kind: str, kw: dict, fn, args: list) -> list:
    """fn(a, dataset) for each a of `args`, the dataset
    DATASETS[kind](**kw), on THREADS threads (numpy and torch release the
    interpreter lock in the render's large operations: 2.3x on 4 threads;
    every frame has its own draws, so the result is the same)."""
    ds = DATASETS[kind](**kw)
    with ThreadPoolExecutor(THREADS) as ex:
        return list(ex.map(lambda a: fn(a, ds), args))


def krrn_pool(schema: dict, mix: dict, seed: int, serve: bool) -> list:
    s = seeds(seed)
    bs, nb = mix["batch_size"], mix["pool_batches"]
    ncls = schema["module"]["num_cls"]
    frames = bs * nb
    kw = dict(num_objects=ncls, frames_per_object=-(-frames // ncls),
              seed=s[0] % 100000, pose_seed=s[1] % 2000,
              num_regions=schema["data"]["num_regions"],
              sym_objects=SYM_OBJECTS)
    rng = np.random.RandomState(s[2])
    order = rng.permutation(ncls * kw["frames_per_object"])[:frames]
    g = torch.Generator().manual_seed(s[3])
    d, ev = schema["data"], schema["eval"]
    crop = d["input_size"]
    args = [(i, torch.rand(crop * crop, generator=g), crop, d["num_points"])
            for i in order]
    got = samples("pose", kw, _krrn_sample, args)
    pool = []
    for j in range(nb):
        rows = got[j * bs:(j + 1) * bs]
        batch = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        if serve:
            batch = {k: batch[k] for k in SERVE_KEYS}
            batch["subset_ids"] = subsets(rng, bs, ev["num_pnp_points"],
                                          ev["pnp_hypotheses"])
        pool.append(batch)
    return pool


def transparent_pool(schema: dict, mix: dict, seed: int) -> list:
    s = seeds(seed)
    bs, nb = mix["batch_size"], mix["pool_batches"]
    ncls = schema["module"]["num_cls"]
    frames = bs * nb
    kw = dict(num_objects=ncls, frames_per_object=-(-frames // ncls),
              seed=s[0] % 100000, pose_seed=s[1] % 2000,
              sym_objects=SYM_OBJECTS)
    order = np.random.RandomState(s[2]).permutation(
        ncls * kw["frames_per_object"])[:frames]
    got = samples("transparent", kw, _transparent_sample,
                  [(i, s[3] % 100000, schema["data"]["input_size"])
                   for i in order])
    return [{k: torch.from_numpy(np.stack([np.asarray(r[k]) for r in
                                           got[j * bs:(j + 1) * bs]]))
             for k in got[0]} for j in range(nb)]


def make_pool(cfg_file: dict, mix: dict, seed: int) -> list:
    """The mix's pool of batches (CPU tensors) for the configuration, from
    its model family's reference half (which calls a generator here)."""
    return found.family(cfg_file["model"], "reference").pool(
        cfg_file["schema"], mix, seed)

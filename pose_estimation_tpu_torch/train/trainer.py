"""Trainer (counterpart of train/trainer.py): epoch loops, eval with the
on-device pose recovery of serve.EvalStep, best-model tracking, manual LR
decay, checkpoints, JSONL metrics mirrored into TensorBoard event files
(log_dir/tb/<name>), and with cfg.train.eval_viz a pred-vs-gt overlay of
each eval's first batch (log_dir/viz/epoch_XXXX.png and the eval stream's
"eval/pred_vs_gt" image). The card unless the caller passes device="cpu"
(no card raises).

Under a process group (parallel.dist) each rank is one shard, as in the
JAX trainer: disjoint train and eval shards of equal batch counts, the LR
horizon over the shards, the step's reductions over the global batch
(train.train_step), the eval tables merged before the summary, so that
best_dis and the LR decay agree on every rank, logs written by rank 0 and
checkpoints saved by rank 0 and loaded on every rank or on none; the
event files and the overlay are rank 0's too.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from pose_estimation_tpu_torch.configs.schema import Config
from pose_estimation_tpu_torch.data.batching import (
    epoch_indices, eval_indices)
from pose_estimation_tpu_torch.data.prefetch import prefetched_epoch
from pose_estimation_tpu_torch.device import resolve_device
from pose_estimation_tpu_torch.metrics.metric import PerObjectAccumulator
from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.parallel import dist
from pose_estimation_tpu_torch.serve import build_eval_step
from pose_estimation_tpu_torch.train.checkpoint import CheckpointManager
from pose_estimation_tpu_torch.train.guards import TrainGuard
from pose_estimation_tpu_torch.train.optim import make_optimizer
from pose_estimation_tpu_torch.train.state import TrainState
from pose_estimation_tpu_torch.train.train_step import build_train_step


class MetricsLogger:
    """Appends one JSON record per call to log_dir/<name>.jsonl and, with
    `tb`, mirrors its float entries into log_dir/tb/<name> (utils.tb, the
    JAX MetricsLogger's event files); with enabled=False (the ranks but 0
    of a group) it writes nothing."""

    def __init__(self, log_dir: str, name: str = "train", tb: bool = True,
                 enabled: bool = True):
        self.enabled = enabled
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self.tb = None
        if tb and enabled:
            from pose_estimation_tpu_torch.utils.tb import EventWriter
            self.tb = EventWriter(os.path.join(log_dir, "tb", name))

    def log(self, step: int, payload: dict, echo: bool = False):
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: (float(v) if isinstance(v, (int, float, np.floating,
                                                   torch.Tensor))
                        and not isinstance(v, bool) else v)
                    for k, v in payload.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self.tb.add_scalar(k, v, rec["step"])
            self.tb.flush()
        if echo:
            print(json.dumps(rec), flush=True)

    def log_image(self, step: int, tag: str, img):
        """Mirror an HWC uint8 image into the event file."""
        if self.tb is not None:
            self.tb.add_image(tag, np.asarray(img), int(step))
            self.tb.flush()


def _generator(seed: int, stream: int, epoch: int, device="cpu"):
    """A generator per (stream, epoch), as the JAX trainer folds the epoch
    into a per-stream key."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1000 + stream) * 1_000_003 + epoch)


class Trainer:
    def __init__(self, cfg: Config, dataset, test_dataset=None,
                 log_dir: str = "runs/default", model=None,
                 resume: str | None = None,
                 resume_backbone_only: bool = False, device="cuda",
                 enable_rot: bool = False):
        """`model` (default: the config's KRRN with seeded random
        weights, with the rotation heads when `enable_rot`) is moved to
        `device`; `test_dataset` (default: `dataset`) is what test_epoch
        evaluates."""
        self.cfg = cfg
        self.dataset = dataset
        self.test_dataset = test_dataset or dataset
        dist.check_mesh(cfg.mesh)
        self.shard_count, self.shard_index = dist.world_size(), dist.rank()
        self.primary = self.shard_index == 0
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.manual_seed(cfg.seed)
        self.model = (model or self.default_model(enable_rot)
                      ).to(self.device)
        # the LR horizon: the steps this rank runs over its shards
        steps_per_epoch = max(1, len(dataset) // (cfg.train.batch_size
                                                  * self.shard_count))
        self.tx = make_optimizer(
            cfg, total_steps=steps_per_epoch * cfg.train.num_epoch)
        self.train_step, self.eval_step = self.build_steps()
        self.log = MetricsLogger(log_dir, "train", enabled=self.primary)
        self.eval_log = MetricsLogger(log_dir, "eval", enabled=self.primary)
        self.ckpt = CheckpointManager(os.path.join(log_dir, "ckpt"))
        self.resume = resume
        self.resume_backbone_only = resume_backbone_only
        self.guard = TrainGuard(ckpt_manager=self.ckpt)
        self.state = None

    def default_model(self, enable_rot: bool = False):
        """The config's KRRN (bf16 activations with train.amp)."""
        dtype = torch.bfloat16 if self.cfg.train.amp else torch.float32
        return KRRN(self.cfg, dtype=dtype, enable_rot=enable_rot)

    def build_steps(self):
        """(train step, eval step) of self.model; on a card the eval step
        checks cfg against the kernels' limits (ops.check_config) before
        anything launches."""
        return (build_train_step(self.model, self.tx, self.cfg),
                build_eval_step(self.model, self.cfg))

    def init_state(self) -> TrainState:
        """A fresh state (the model's seeded random weights), then the
        latest checkpoint of `resume`, or of this run's own directory,
        loaded into it when there is one. A checkpoint that does not fit
        the model (another config) is skipped, as the JAX trainer skips
        it: the run starts from the fresh state, which the failed restore
        leaves untouched (TrainState.check_state_dict checks before
        anything loads). Under a group every rank reads the checkpoint,
        and it is loaded only where every rank read the same step and
        found it fits; otherwise every rank starts fresh. With
        `resume_backbone_only`, only the parameters of `resume` whose name
        and shape match are copied in (as many on every rank, or it
        raises); the optimizer state, the step and the generator stay
        fresh."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.state = TrainState.create(self.model, self.tx, gen)
        if self.resume and self.resume_backbone_only:
            # load_part_module equivalent (lib/utils/utlis.py:37-52)
            n = CheckpointManager(self.resume).merge_partial_params(
                self.model)
            counts = dist.all_gather_array(np.array([n]))[:, 0]
            if (counts != n).any():
                raise RuntimeError(f"partial restore from {self.resume}: "
                                   f"the ranks merged {counts.tolist()} "
                                   "parameters")
            if self.primary:
                print(f"[trainer] partial restore: {n} matching param leaves "
                      f"from {self.resume}")
            return self.state
        source = (CheckpointManager(self.resume) if self.resume
                  else self.ckpt)
        step, sd, failed = source.latest_step(), None, None
        if step is not None:
            try:
                sd = source.read(step)
                self.state.check_state_dict(sd)
            except Exception as e:  # incompatible/stale checkpoint
                failed = type(e).__name__
        views = dist.all_gather_array(
            np.array([-1 if step is None else step, failed is None]))
        if failed is not None:
            print(f"[trainer] checkpoint restore failed ({failed});"
                  " starting fresh")
        elif not views[:, 1].all() or (views[:, 0] != views[0, 0]).any():
            print(f"[trainer] rank {self.shard_index}: the ranks read "
                  f"checkpoint steps {views[:, 0].tolist()}, not all "
                  "restorable; starting fresh")
        elif sd is not None:
            self.state.load_state_dict(sd)
        return self.state

    def _to_device(self, batch: dict) -> dict:
        return {k: v.to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def train_epoch(self, epoch: int, steps: int | None = None):
        cfg = self.cfg
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        gen = _generator(cfg.seed, 1, epoch)
        batches = epoch_indices(gen, len(self.dataset), cfg.train.batch_size,
                                self.shard_count, self.shard_index)
        if steps is not None:
            batches = batches[:steps]
        opt_pose = (cfg.train.enable_pose
                    and epoch >= cfg.train.start_pose_epoch)
        t0 = time.time()
        stream = prefetched_epoch(self.dataset, batches, gen,
                                  cfg.data.input_size, cfg.data.num_points)
        prev = None     # the guard reads the previous step's metrics, so
        try:            # the host never waits for the current step
            for bi, batch in enumerate(stream):
                metrics = self.train_step(self.state, self._to_device(batch),
                                          opt_pose=opt_pose)
                if prev is not None and self.guard.observe(
                        self.state.step - 1, prev, train_state=self.state):
                    self.log.log(self.state.step,
                                 {"epoch": epoch, "aborted_divergence": 1.0},
                                 echo=True)
                    break
                prev = metrics
                if bi % 20 == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["epoch"] = epoch
                    m["sec_per_step"] = (time.time() - t0) / (bi + 1)
                    self.log.log(self.state.step, m)
                if (cfg.train.ckpt_every
                        and self.state.step % cfg.train.ckpt_every == 0):
                    self.ckpt.save(self.state.step, self.state,
                                   metrics={"periodic": 1.0})
        finally:
            stream.close()
        return self.state

    def test_epoch(self, epoch: int, max_batches: int | None = None):
        """Full-coverage eval of the test set: every sample once, in
        order, sharded over the group; the padding is masked out of the
        accumulator, and the ranks' tables are merged before the
        summary."""
        cfg = self.cfg
        acc = PerObjectAccumulator(cfg.module.num_cls)
        batches, valid = eval_indices(len(self.test_dataset),
                                      cfg.train.batch_size,
                                      self.shard_count, self.shard_index)
        if max_batches is not None:
            batches, valid = batches[:max_batches], valid[:max_batches]
        solve_gen = _generator(cfg.seed, 2, epoch, self.device)
        stream = prefetched_epoch(self.test_dataset, batches,
                                  _generator(cfg.seed, 3, epoch),
                                  cfg.data.input_size, cfg.data.num_points)
        try:
            for bi, batch in enumerate(stream):
                out = self.eval_step(self._to_device(batch),
                                     generator=solve_gen)
                keep = valid[bi]
                acc.update(batch["cls"].numpy()[keep],
                           {k: v.float().cpu().numpy()[keep]
                            for k, v in out.items() if v.ndim == 1})
                if bi == 0 and cfg.train.eval_viz and self.primary:
                    self.save_overlay(epoch, batch, out)
        finally:
            stream.close()
        summary = acc.all_reduce_across_processes().summary()
        mean_dis = summary["overall"].get("add_dis", float("inf"))
        self.eval_log.log(self.state.step,
                          {"epoch": epoch, **summary["overall"]}, echo=True)
        if mean_dis < self.state.best_dis:
            self.state.best_dis = float(np.float32(mean_dis))
            self.ckpt.save(self.state.step, self.state,
                           metrics={"add_dis": mean_dis})
        if (cfg.train.lr.scheduler == "manual"
                and mean_dis < cfg.train.lr.decay_margin):
            self.state.lr_scale = float(np.float32(
                self.state.lr_scale * cfg.train.lr.decay_rate))
        return summary

    def save_overlay(self, epoch: int, batch: dict, out: dict):
        """The pred-vs-gt box overlay of the first crops of `batch` (the
        host batch) at the eval's poses: log_dir/viz/epoch_XXXX.png and the
        eval stream's image; best-effort, as the JAX trainer's (it needs
        OpenCV)."""
        from pose_estimation_tpu_torch.utils.viz import save_eval_grid
        viz_dir = os.path.join(os.path.dirname(self.log.path), "viz")
        os.makedirs(viz_dir, exist_ok=True)
        try:
            grid = save_eval_grid(
                os.path.join(viz_dir, f"epoch_{epoch:04d}.png"), batch,
                out["pred_r"].float().cpu().numpy(),
                out["pred_t"].float().cpu().numpy())
            self.eval_log.log_image(epoch, "eval/pred_vs_gt", grid)
        except Exception as e:  # viz is best-effort (needs cv2)
            print(f"[trainer] eval viz skipped: {e}")

    def fit(self, num_epochs: int | None = None,
            steps_per_epoch: int | None = None, eval_every: int = 1):
        if self.state is None:
            self.init_state()
        num_epochs = num_epochs or self.cfg.train.num_epoch
        for epoch in range(num_epochs):
            self.train_epoch(epoch, steps_per_epoch)
            if (epoch + 1) % eval_every == 0:
                self.test_epoch(epoch)
        return self.state

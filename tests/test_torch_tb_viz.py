"""The port's TensorBoard writer, pose overlays and the trainer's mirror
against the JAX package's, on the CPU.

- utils/tb.py: CRC32C, the PNG encoder and the event files byte for byte
  with the JAX writer's (time.time and socket.gethostname patched to the
  same values in both); the port's reader checks every CRC and reads the
  JAX files back;
- utils/viz.py: each drawing function's array exactly (uint8) and
  save_eval_grid's grid and PNG bytes, on the same batch and poses;
- train/trainer.py: MetricsLogger's JSONL and event files byte for byte
  with the JAX MetricsLogger's for the same records and image; the
  Trainer (tiny config, eval_viz on, the default) writes tb/train,
  tb/eval and viz/epoch_XXXX.png, every float of its JSONL records at its
  step in the event files, the overlay equal to the JAX save_eval_grid
  of the eval's first batch and poses; the transparent trainer mirrors
  its scalars. Rank 0 alone writes them under a group:
  tests/test_torch_dist.py::test_trainer_logs_and_overlays_on_rank_0_only.
"""

import json
import socket
import time

import cv2
import numpy as np
import pytest
import torch

from pose_estimation_tpu.train.trainer import MetricsLogger as JLogger
from pose_estimation_tpu.utils import tb as jtb
from pose_estimation_tpu.utils import viz as jviz
from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.data.batching import make_batch
from pose_estimation_tpu_torch.data.synthetic import (
    SyntheticPoseDataset, SyntheticTransparentDataset)
from pose_estimation_tpu_torch.train.trainer import MetricsLogger, Trainer
from pose_estimation_tpu_torch.utils import tb, viz

torch.set_num_threads(1)

TINY = {"module.num_cls": 2, "data.num_regions": 8, "data.num_points": 128,
        "data.input_size": 64, "module.backbone_outc": 16,
        "module.stem_width": 8,
        "module.hrnet_stages": ((1, 1, (8, 8)), (1, 1, (8, 8, 16)),
                                (1, 1, (8, 8, 16, 16))),
        "module.xyznet": schema.HeadConfig(hidden=16),
        "module.nmlnet": schema.HeadConfig(hidden=16),
        "module.gcn3d": schema.Gcn3dConfig(neighbor_num=4, support_num=2),
        "train.batch_size": 2, "train.amp": False, "train.ckpt_every": 0,
        "train.start_pose_epoch": 0, "eval.num_pnp_points": 32,
        "eval.pnp_hypotheses": 8}


@pytest.fixture
def frozen(monkeypatch):
    """The same wall times and host name in both packages' writers: call
    the returned function before each package's run to restart the
    clock."""
    clock = []

    def restart():
        clock[:] = [iter(np.arange(1.7e9, 1.7e9 + 1000, 0.25))]

    restart()
    monkeypatch.setattr(time, "time", lambda: float(next(clock[0])))
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    return restart


def _only_file(d):
    files = list(d.iterdir())
    assert len(files) == 1, files
    return files[0]


# --------------------------------------------------------------------- tb
def test_crc32c_and_png_equal_the_jax_encoders():
    for data in (b"", b"123456789", bytes(32), bytes(range(256)) * 3):
        assert tb.crc32c(data) == jtb.crc32c(data)
        assert tb._masked_crc(data) == jtb._masked_crc(data)
    assert tb.crc32c(b"123456789") == 0xE3069283    # RFC 3720
    rng = np.random.RandomState(0)
    for img in (rng.randint(0, 255, (17, 23, 3), np.uint8),
                rng.randint(0, 255, (9, 4), np.uint8),
                rng.randint(0, 255, (5, 6, 1), np.uint8)):
        assert tb._encode_png(img) == jtb._encode_png(img)
    for n in (0, 1, 127, 128, 300, 2 ** 40, -1, -300):
        assert tb._varint(n) == jtb._varint(n)


def _write(mod, d):
    w = mod.EventWriter(str(d))
    w.add_scalar("loss/total", 1.5, 7)
    w.add_scalar("lr", 1e-4, 8)
    w.add_scalar("neg", -2.25, -3)
    img = np.random.RandomState(1).randint(0, 255, (11, 13, 3), np.uint8)
    w.add_image("eval/grid", img, 3)
    w.add_image("gray", img[..., 0], 4)
    w.flush()
    w.close()
    return w.path, img


def test_event_files_byte_for_byte(tmp_path, frozen):
    jpath, img = _write(jtb, tmp_path / "jax")
    frozen()
    path, _ = _write(tb, tmp_path / "port")
    assert path.split("/")[-1] == jpath.split("/")[-1]
    with open(jpath, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()
    events = tb.read_events(jpath)
    assert events[0]["file_version"] == "brain.Event:2"
    got = [(e["step"], tag, v) for e in events[1:] for tag, v in e["values"]]
    assert got[0] == (7, "loss/total", 1.5)
    assert got[1][:2] == (8, "lr") and abs(got[1][2] - 1e-4) < 1e-11
    assert got[2] == (-3, "neg", -2.25)
    (step, tag, image), (_, tag2, gray) = got[3], got[4]
    assert (step, tag) == (3, "eval/grid")
    assert (image["height"], image["width"], image["colorspace"]) == (
        11, 13, 3)
    dec = cv2.imdecode(np.frombuffer(image["png"], np.uint8),
                       cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(dec[..., ::-1], img)
    assert (tag2, gray["colorspace"]) == ("gray", 1)


def test_reader_checks_every_crc(tmp_path):
    path, _ = _write(tb, tmp_path)
    raw = bytearray(open(path, "rb").read())
    # the length's bytes, the data's, the data CRC's
    for pos in (3, 40, len(raw) - 2):
        bad = bytearray(raw)
        bad[pos] ^= 0x01
        p = tmp_path / f"bad_{pos}"
        p.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match="bad"):
            tb.read_events(str(p))
    (tmp_path / "torn").write_bytes(bytes(raw[:-3]))
    with pytest.raises(ValueError):
        tb.read_events(str(tmp_path / "torn"))


# -------------------------------------------------------------------- viz
def _eval_batch():
    ds = SyntheticPoseDataset(num_objects=2, frames_per_object=2, im_h=120,
                              im_w=160, num_regions=8)
    batch = make_batch(ds, [0, 1, 2], torch.Generator().manual_seed(0), 64,
                       128)
    rng = np.random.RandomState(2)
    pred_r = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(3)])
    pred_r *= np.linalg.det(pred_r)[:, None, None]
    pred_t = batch["target_t"].numpy() + rng.randn(3, 3) * 0.01
    return batch, pred_r.astype(np.float32), pred_t.astype(np.float32)


def test_drawing_functions_equal_the_jax_ones():
    batch, pred_r, pred_t = _eval_batch()
    img = np.zeros((120, 160, 3), np.uint8)      # the full frame
    k = batch["k"][0].numpy()
    r, t = pred_r[0], pred_t[0]
    ext, lf = batch["extent"][0].numpy(), batch["lf_border"][0].numpy()
    pts = batch["model_points"][0].numpy()
    np.testing.assert_array_equal(viz.project(pts, r, t, k),
                                  jviz.project(pts, r, t, k))
    np.testing.assert_array_equal(viz.bbox_corners(ext, lf),
                                  jviz.bbox_corners(ext, lf))
    for fn in ("draw_pose_bbox", "draw_axes"):
        extra = (ext, lf) if fn == "draw_pose_bbox" else ()
        got = getattr(viz, fn)(img, r, t, k, *extra)
        np.testing.assert_array_equal(got, getattr(jviz, fn)(img, r, t, k,
                                                             *extra))
        assert got.dtype == np.uint8 and (got != img).any()
    np.testing.assert_array_equal(viz.draw_points(img, pts, r, t, k),
                                  jviz.draw_points(img, pts, r, t, k))
    np.testing.assert_array_equal(viz.align_rotation(r),
                                  jviz.align_rotation(r))
    np.testing.assert_array_equal(viz.align_rotation(np.eye(3)[:, [0, 2, 1]]),
                                  jviz.align_rotation(np.eye(3)[:, [0, 2,
                                                                    1]]))


def test_eval_grid_and_png_equal_the_jax_ones(tmp_path):
    batch, pred_r, pred_t = _eval_batch()
    jbatch = {k: v.numpy() for k, v in batch.items()}
    ref = jviz.save_eval_grid(str(tmp_path / "jax.png"), jbatch, pred_r,
                              pred_t, max_images=2)
    got = viz.save_eval_grid(str(tmp_path / "port.png"), batch, pred_r,
                             pred_t, max_images=2)
    assert got.dtype == np.uint8 and got.shape == (64, 128, 3)
    np.testing.assert_array_equal(got, ref)
    assert (tmp_path / "port.png").read_bytes() == (
        tmp_path / "jax.png").read_bytes()


# ---------------------------------------------------------------- trainer
def test_metrics_logger_byte_for_byte(tmp_path, frozen):
    """Both loggers fed the same records and image write the same JSONL
    lines and event files (floats mirrored, ints as floats, strings and
    bools JSONL only)."""
    img = np.random.RandomState(3).randint(0, 255, (8, 24, 3), np.uint8)
    for name, cls in (("jax", JLogger), ("port", MetricsLogger)):
        frozen()
        log = cls(str(tmp_path / name), "eval")
        log.log(1, {"loss": 2.0, "note": "jsonl only", "count": 3,
                    "f32": np.float32(0.25), "flag": True})
        log.log(2, {"loss": 1.0, "epoch": 0})
        log.log_image(0, "eval/pred_vs_gt", img)
    for sub in ("eval.jsonl",):
        assert (tmp_path / "jax" / sub).read_text() == (
            tmp_path / "port" / sub).read_text()
    ja = _only_file(tmp_path / "jax" / "tb" / "eval")
    po = _only_file(tmp_path / "port" / "tb" / "eval")
    assert ja.name == po.name and ja.read_bytes() == po.read_bytes()
    off = MetricsLogger(str(tmp_path / "off"), "train", enabled=False)
    off.log(1, {"loss": 1.0})
    off.log_image(0, "x", img)
    assert list((tmp_path / "off").iterdir()) == []


def _jsonl(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def _scalars(d):
    return [(e["step"], tag, v) for e in tb.read_events(str(_only_file(d)))
            for tag, v in e["values"] if not isinstance(v, dict)]


def _mirrored(records):
    return [(r["step"], k, float(np.float32(v))) for r in records
            for k, v in r.items() if k not in ("step", "time")
            and isinstance(v, float)]


def test_trainer_writes_the_tb_streams_and_the_overlay(tmp_path,
                                                       monkeypatch):
    cfg = schema.override(schema.Config(dataset="synthetic"), **TINY)
    ds = SyntheticPoseDataset(num_objects=2, frames_per_object=2, im_h=120,
                              im_w=160, num_regions=8)
    tr = Trainer(cfg, ds, log_dir=str(tmp_path), device="cpu")
    tr.init_state()
    tr.train_epoch(0)
    seen = {}
    port_save = viz.save_eval_grid

    def spy(path, batch, pred_r, pred_t, max_images=4):
        seen["grid"] = jviz.save_eval_grid(
            str(tmp_path / "jax.png"),
            {k: v.numpy() for k, v in batch.items()}, pred_r, pred_t,
            max_images)
        seen["poses"] = pred_r, pred_t
        return port_save(path, batch, pred_r, pred_t, max_images)

    monkeypatch.setattr(viz, "save_eval_grid", spy)
    tr.test_epoch(0, max_batches=1)
    assert _scalars(tmp_path / "tb" / "train") == _mirrored(
        _jsonl(tmp_path / "train.jsonl"))
    ev = _jsonl(tmp_path / "eval.jsonl")
    assert _scalars(tmp_path / "tb" / "eval") == _mirrored(ev)
    assert {"add_dis", "rot_deg", "epoch", "count"} <= set(ev[0])
    images = [(e["step"], tag, v) for e in tb.read_events(
        str(_only_file(tmp_path / "tb" / "eval"))) for tag, v in e["values"]
        if isinstance(v, dict)]
    assert [(s, t) for s, t, _ in images] == [(0, "eval/pred_vs_gt")]
    png = tmp_path / "viz" / "epoch_0000.png"
    grid = cv2.imread(str(png))[..., ::-1]
    assert grid.shape == (64, 128, 3)
    np.testing.assert_array_equal(grid, seen["grid"])
    assert png.read_bytes() == (tmp_path / "jax.png").read_bytes()
    assert seen["poses"][0].shape == (2, 3, 3)
    dec = cv2.imdecode(np.frombuffer(images[0][2]["png"], np.uint8),
                       cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(dec, grid)

    off = schema.override(cfg, **{"train.eval_viz": False})
    tr2 = Trainer(off, ds, log_dir=str(tmp_path / "off"), device="cpu")
    tr2.init_state()
    tr2.test_epoch(0, max_batches=1)
    assert not (tmp_path / "off" / "viz").exists()


def test_transparent_trainer_mirrors_its_scalars(tmp_path):
    from pose_estimation_tpu_torch.train.transparent_trainer import (
        TransparentTrainer)
    cfg = schema.override(schema.transparent_cleargrasp(), **{
        "module.num_cls": 2, "data.num_points": 32, "data.input_size": 32,
        "train.batch_size": 2, "train.amp": False, "train.ckpt_every": 0})
    ds = SyntheticTransparentDataset(num_objects=2, frames_per_object=1,
                                     im_h=120, im_w=160, num_regions=8)
    tr = TransparentTrainer(cfg, ds, log_dir=str(tmp_path), device="cpu")
    tr.init_state()
    tr.train_epoch(0)
    tr.test_epoch(0)
    for name in ("train", "eval"):
        records = _jsonl(tmp_path / f"{name}.jsonl")
        assert records and _scalars(tmp_path / "tb" / name) == _mirrored(
            records)
    assert "all_loss" in _jsonl(tmp_path / "train.jsonl")[0]
    assert not (tmp_path / "viz").exists()      # as the JAX trainer's

"""The port's data layer against the JAX package's, on the CPU.

- OpenCV and PyYAML are imported where the JAX readers import them, never
  at import time, and without them the error names the tree or the file;
- the readers (data/linemod.py, data/ycb.py, data/augment.py): the JAX
  readers' frames exactly (every key, its dtype, its values) on every
  index of the golden BOP tree (with its JPEG frame), the golden classic
  tree in train and eval mode, fake BOP trees with a background-paste
  split and with detection boxes, a fake classic tree with augmentation
  over two epochs, a YCB-V tree, one class, and the LinemodDataset
  dispatch;
- data/testing.py: the JAX writer's files, byte for byte (the pickles'
  contents), and its objects;
- make_batch on LineMOD frames with injected choose draws against the JAX
  make_batch.
"""

import ast
import dataclasses
import json
import os
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pose_estimation_tpu.data import batching as jbatching
from pose_estimation_tpu.data import linemod as jlinemod
from pose_estimation_tpu.data import testing as jtesting
from pose_estimation_tpu.data import ycb as jycb
from pose_estimation_tpu_torch.data import batching, linemod, ycb
from pose_estimation_tpu_torch.data import testing as ttesting

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"


def _assert_same_value(a, b, what):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray)), what
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(b, a, err_msg=what)


def _assert_same_objects(ref, got):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        for f in dataclasses.fields(a):
            _assert_same_value(getattr(a, f.name), getattr(b, f.name),
                               f.name)


def _assert_same_frames(ref, got, epochs=(None,)):
    """Every index of two readers gives the same frame dict."""
    assert type(got).__name__ == type(ref).__name__
    assert len(got) == len(ref) > 0
    _assert_same_objects(ref.objects_by_cls, got.objects_by_cls)
    for epoch in epochs:
        if epoch is not None:
            ref.set_epoch(epoch)
            got.set_epoch(epoch)
        for i in range(len(ref)):
            fa, fb = ref[i], got[i]
            assert sorted(fa) == sorted(fb), i
            for k in fa:
                _assert_same_value(fa[k], fb[k], f"index {i}, key {k}")


# ---------------------------------------------------------------------------
# Optional libraries
# ---------------------------------------------------------------------------

def test_readers_without_opencv_or_pyyaml(monkeypatch):
    """The readers import OpenCV where the JAX readers do (when a reader is
    built) and PyYAML where a .yml file is read; without them the
    ImportError names the tree or the file."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="models_info.yml: .*PyYAML"):
        linemod.LinemodClassicDataset(str(GOLDEN / "classic"),
                                      num_regions=16)
    monkeypatch.setitem(sys.modules, "cv2", None)
    bop = str(GOLDEN / "bop")
    with pytest.raises(ImportError, match=f"{bop}: .*OpenCV"):
        linemod.LinemodBOPDataset(bop, object_ids=[1, 2], num_regions=16)
    with pytest.raises(ImportError, match="classic: .*OpenCV"):
        linemod.LinemodClassicDataset(str(GOLDEN / "classic"),
                                      num_regions=16)


def test_no_module_imports_cv2_or_yaml_at_import_time():
    banned = {"cv2", "yaml", "PIL"}
    offenders = []

    def visit(node, path):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        offenders.extend(f"{path.name}: {n}" for n in names
                         if n.split(".")[0] in banned)
        for child in ast.iter_child_nodes(node):
            visit(child, path)

    files = sorted((REPO / "pose_estimation_tpu_torch").rglob("*.py"))
    for path in files + [REPO / "chip_smoke.py"]:
        visit(ast.parse(path.read_text()), path)
    assert not offenders, offenders
    assert {"linemod.py", "augment.py", "testing.py"} <= {p.name
                                                          for p in files}


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bop_tree(tmp_path_factory):
    """A JAX-written BOP tree with a render split (background paste), a
    background image directory and detection boxes for the test split."""
    root = str(tmp_path_factory.mktemp("bop"))
    jtesting.write_fake_bop_tree(root, num_objects=2, frames_per_object=2,
                                 splits=("train_pbr", "train_render",
                                         "test"))
    ds = jlinemod.LinemodBOPDataset(root, split="test", num_regions=16,
                                    object_ids=[1, 2])
    dets = {}
    for i in range(len(ds)):
        _, im_id, oid, *_ = ds.index[i]
        ys, xs = np.nonzero(ds[i]["mask"])
        dets[f"{oid}/{im_id}"] = [{"bbox_est": [
            int(xs.min()) - 2, int(ys.min()) - 2,
            int(xs.max() - xs.min()) + 4, int(ys.max() - ys.min()) + 4]}]
    bb_dir = os.path.join(root, "test", "test_bboxes")
    os.makedirs(bb_dir)
    with open(os.path.join(bb_dir, "bbox_yolov3_all.json"), "w") as f:
        json.dump(dets, f)
    back = os.path.join(root, "backgrounds")
    os.makedirs(back)
    rng = np.random.RandomState(7)
    for j, (h, w) in enumerate(((50, 70), (90, 40))):
        cv2.imwrite(os.path.join(back, f"{j}.png"),
                    rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    return root


@pytest.fixture(scope="module")
def classic_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("classic"))
    jtesting.write_fake_classic_tree(root, num_objects=2,
                                     frames_per_object=2, syn_per_object=2)
    return root


@pytest.fixture(scope="module")
def ycb_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ycb"))
    jtesting.write_fake_bop_tree(root, num_objects=2, frames_per_object=2,
                                 splits=("train_real", "train_synt", "test"),
                                 seed=3)
    return root


def test_golden_bop_frames_match_jax():
    kw = dict(split="test", object_ids=[1, 2], num_regions=16)
    root = str(GOLDEN / "bop")
    ref = jlinemod.LinemodBOPDataset(root, **kw)
    got = linemod.LinemodBOPDataset(root, **kw)
    assert any(e[1] == 1 for e in got.index)        # the JPEG frame
    _assert_same_frames(ref, got)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_golden_classic_frames_match_jax(mode):
    kw = dict(mode=mode, cls_type="ape", num_regions=16)
    root = str(GOLDEN / "classic")
    _assert_same_frames(jlinemod.LinemodClassicDataset(root, **kw),
                        linemod.LinemodClassicDataset(root, **kw))


@pytest.mark.parametrize("split", ["train_pbr", "train_render", "test"])
def test_fake_bop_frames_match_jax(bop_tree, split):
    """train_render pastes a background from the image directory over two
    epochs; the test split carries the detection boxes (det_center)."""
    kw = dict(split=split, num_regions=16, object_ids=[1, 2],
              eval_bboxes=split == "test")
    if split == "train_render":
        kw["background_dir"] = os.path.join(bop_tree, "backgrounds")
    ref = jlinemod.LinemodBOPDataset(bop_tree, **kw)
    got = linemod.LinemodBOPDataset(bop_tree, **kw)
    _assert_same_frames(ref, got, epochs=(0, 1) if split == "train_render"
                        else (None,))
    if split == "test":
        assert "det_center" in got[0]


def test_fake_classic_augmented_frames_match_jax(classic_tree):
    """Real frames x3 and synthetic pickles (pasted background), color
    jitter and t_noise, drawn anew for each epoch."""
    kw = dict(mode="train", num_regions=16, add_noise=True)
    ref = jlinemod.LinemodClassicDataset(classic_tree, **kw)
    got = linemod.LinemodClassicDataset(classic_tree, **kw)
    assert any(kind == "syn" for kind, *_ in got.index)
    _assert_same_frames(ref, got, epochs=(0, 1))
    got.set_epoch(0)
    f0 = got[0]["t_noise"]
    got.set_epoch(1)
    assert not np.array_equal(f0, got[0]["t_noise"])


def test_fake_classic_eval_frames_match_jax(classic_tree):
    kw = dict(mode="eval", num_regions=16)
    _assert_same_frames(jlinemod.LinemodClassicDataset(classic_tree, **kw),
                        linemod.LinemodClassicDataset(classic_tree, **kw))


@pytest.mark.parametrize("split", ["train", "test"])
def test_ycb_frames_match_jax(ycb_tree, split):
    """train composes train_real + train_synt (pasted) with jitter and
    t_noise."""
    kw = dict(split=split, num_regions=8)
    ref = jycb.YCBVideoDataset(ycb_tree, **kw)
    got = ycb.YCBVideoDataset(ycb_tree, **kw)
    _assert_same_frames(ref, got, epochs=(0, 1) if split == "train"
                        else (None,))


def test_single_class_selection_matches_jax(bop_tree, classic_tree):
    ref = jlinemod.LinemodBOPDataset(bop_tree, split="test",
                                     cls_type="benchvise", num_regions=16)
    got = linemod.LinemodBOPDataset(bop_tree, split="test",
                                    cls_type="benchvise", num_regions=16)
    assert set(got.objects) == {2}
    _assert_same_frames(ref, got)
    kw = dict(mode="train", cls_type="ape", num_regions=16)
    ref = jlinemod.LinemodClassicDataset(classic_tree, **kw)
    got = linemod.LinemodClassicDataset(classic_tree, **kw)
    assert set(got.objects) == {1}
    _assert_same_frames(ref, got)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_linemod_dataset_dispatch_matches_jax(bop_tree, classic_tree, mode):
    from pose_estimation_tpu.configs import schema as jschema
    from pose_estimation_tpu_torch.configs import schema
    over = {"data.num_regions": 16, "train.noise": 0.02}
    jcfg = jschema.override(jschema.Config(), **over)
    cfg = schema.override(schema.Config(), **over)
    assert linemod._is_classic_tree(classic_tree)
    assert not linemod._is_classic_tree(bop_tree)
    for root in (bop_tree, classic_tree):
        ref = jlinemod.LinemodDataset(root, mode=mode, cls_type="all",
                                      cfg=jcfg)
        got = linemod.LinemodDataset(root, mode=mode, cls_type="all",
                                     cfg=cfg)
        _assert_same_frames(ref, got)


# ---------------------------------------------------------------------------
# data/testing.py
# ---------------------------------------------------------------------------

def _tree_files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


@pytest.mark.parametrize("layout", ["bop", "classic"])
def test_writer_matches_jax(layout, tmp_path):
    write = {"bop": "write_fake_bop_tree",
             "classic": "write_fake_classic_tree"}[layout]
    a, b = tmp_path / "jax", tmp_path / "port"
    ref = getattr(jtesting, write)(str(a), num_objects=2,
                                   frames_per_object=2, im_h=60, im_w=80)
    got = getattr(ttesting, write)(str(b), num_objects=2,
                                   frames_per_object=2, im_h=60, im_w=80)
    _assert_same_objects(ref, got)
    files = _tree_files(a)
    assert files == _tree_files(b)
    n_png = 0
    for rel in files:
        n_png += rel.endswith(".png")
        if rel.endswith(".pkl"):
            with open(a / rel, "rb") as fa, open(b / rel, "rb") as fb:
                pa, pb = pickle.load(fa), pickle.load(fb)
            assert sorted(pa) == sorted(pb)
            for k in pa:
                _assert_same_value(pa[k], pb[k], f"{rel}: {k}")
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    assert n_png >= 8


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def test_make_batch_on_linemod_frames_matches_jax(bop_tree, classic_tree):
    """Detection-box crops (BOP test split) and t_noise frames (classic
    train with augmentation), the choose draws injected as in
    test_torch_slice.py::test_make_batch_matches_jax."""
    cases = (
        (jlinemod.LinemodBOPDataset(bop_tree, split="test", num_regions=16,
                                    object_ids=[1, 2], eval_bboxes=True),
         linemod.LinemodBOPDataset(bop_tree, split="test", num_regions=16,
                                   object_ids=[1, 2], eval_bboxes=True)),
        (jlinemod.LinemodClassicDataset(classic_tree, num_regions=16,
                                        add_noise=True),
         linemod.LinemodClassicDataset(classic_tree, num_regions=16,
                                       add_noise=True)))
    idx = [0, 3]
    crop, npts = 32, 64
    key = jax.random.PRNGKey(0)
    noises = [torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(key, j), (crop * crop,)))) for j in range(2)]
    for ref_ds, got_ds in cases:
        ref = {k: np.asarray(v) for k, v in jbatching.make_batch(
            ref_ds, idx, key, crop, npts).items()}
        got = batching.make_batch(got_ds, idx, None, crop, npts,
                                  noises=noises)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)

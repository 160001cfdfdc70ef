"""The port's VOC evaluation against the JAX package's, on the CPU.

- `voc_ap`, `eval_detection_voc` and the file-based `voc_eval`: equal APs,
  with `use_07_metric` on and off, on the same detections and the same
  annotation XMLs (written by tests/test_torch_voc_data.py's tree);
- `eval_post_process` (decode, clip, min size, one class-batched NMS):
  kept sets and scores equal on score-separated inputs, boxes within 4
  ulps of the image's extent (XLA:CPU's `exp` differs from torch's in the
  last bit for some inputs, and so do the decoded box widths);
- `write_voc_detection_files` and `get_prediction_files` (with a stand-in
  detector that returns the same raw head outputs in both frameworks):
  byte-identical result files;
- `MetricWriter`: byte-identical event records and JSONL with the wall
  clock pinned.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_voc_data import IDS, write_voc_tree
from tf_eager_object_detection_tpu.evaluation import pascal_eval_files as jax_files
from tf_eager_object_detection_tpu.evaluation import voc_eval as jax_voc_eval
from tf_eager_object_detection_tpu.training import metrics as jax_metrics
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.data.label_map import PASCAL_CLASSES
from tf_eager_object_detection_tpu_torch.data.voc import parse_voc_xml
from tf_eager_object_detection_tpu_torch.evaluation import pascal_eval_files as port_files
from tf_eager_object_detection_tpu_torch.evaluation import voc_eval
from tf_eager_object_detection_tpu_torch.training import metrics

FLAGS = [False, True]
MEANS, STDS = (0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return write_voc_tree(str(tmp_path_factory.mktemp("voc")))


def _ground_truth(voc_root):
    return {i: parse_voc_xml(os.path.join(voc_root, "Annotations", f"{i}.xml")) for i in IDS}


def _detections(voc_root, seed):
    """per_image[i][c] = [N, 5] around each image's ground truth: jittered
    copies (some matches, some duplicates, some misses) plus random boxes."""
    rng = np.random.RandomState(seed)
    gt = _ground_truth(voc_root)
    per_image = []
    for i in IDS:
        h, w = gt[i]["height"], gt[i]["width"]
        dets = [np.zeros((0, 5)) for _ in PASCAL_CLASSES]
        for o in gt[i]["objects"]:
            c = PASCAL_CLASSES.index(o["name"])
            box = np.asarray(o["bbox"]) - 1 + rng.uniform(-6, 6, (rng.randint(0, 3), 4))
            dets[c] = np.concatenate([dets[c], np.c_[box, rng.uniform(0, 1, len(box))]])
        for _ in range(rng.randint(0, 4)):
            c = rng.randint(20)
            x1, y1 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            box = [x1, y1, x1 + rng.uniform(5, w / 2), y1 + rng.uniform(5, h / 2)]
            dets[c] = np.concatenate([dets[c], [box + [rng.uniform()]]])
        per_image.append(dets)
    return per_image


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# --------------------------------------------------------------------- APs
@pytest.mark.parametrize("use_07", FLAGS)
def test_voc_ap_matches_jax(use_07):
    rng = np.random.RandomState(4)
    for n in (0, 1, 7, 50):
        rec = np.sort(rng.uniform(0, 1, n))
        prec = rng.uniform(0, 1, n)
        assert voc_eval.voc_ap(rec, prec, use_07) == jax_voc_eval.voc_ap(rec, prec, use_07)


@pytest.mark.parametrize("use_07", FLAGS)
def test_eval_detection_voc_matches_jax(use_07):
    rng = np.random.RandomState(9)
    args = [[], [], [], [], [], []]
    for _ in range(8):
        ng, nd = rng.randint(0, 5), rng.randint(0, 8)
        gts = np.sort(rng.uniform(0, 100, (ng, 2, 2)), 1).reshape(ng, 4)[:, [0, 2, 1, 3]]
        dets = np.concatenate([gts + rng.uniform(-5, 5, gts.shape),
                               rng.uniform(0, 100, (nd, 4))])
        dets[:, 2:] = np.maximum(dets[:, 2:], dets[:, :2] + 1)
        glabels = rng.randint(1, 5, ng)
        for a, v in zip(args, (dets, np.concatenate([glabels, rng.randint(1, 6, nd)]),
                               rng.uniform(0, 1, len(dets)), gts, glabels,
                               rng.uniform(0, 1, ng) < 0.2)):
            a.append(v)
    got = voc_eval.eval_detection_voc(*args, use_07_metric=use_07)
    want = jax_voc_eval.eval_detection_voc(*args, use_07_metric=use_07)
    assert got["classes"] == want["classes"]
    np.testing.assert_array_equal(got["ap"], want["ap"])
    assert got["map"] == want["map"] and 0 < got["map"] < 1


@pytest.mark.parametrize("use_07", FLAGS)
def test_voc_eval_files_match_jax(voc_root, tmp_path, use_07):
    """Per-class result files written by the port, scored by both
    frameworks' file-based `voc_eval` against the tree's XMLs (each with
    its own annotation cache, then again from the cache)."""
    fmt = str(tmp_path / "det_{}.txt")
    port_files.write_voc_detection_files(_detections(voc_root, 1), IDS, PASCAL_CLASSES, fmt)
    anno = os.path.join(voc_root, "Annotations", "{}.xml")
    imageset = os.path.join(voc_root, "ImageSets", "Main", "test.txt")
    aps = []
    for cls in PASCAL_CLASSES:
        for _ in range(2):  # the second pass reads the pickled cache
            got = voc_eval.voc_eval(fmt, anno, imageset, cls, str(tmp_path / "cp"), 0.5, use_07)
            want = jax_voc_eval.voc_eval(fmt, anno, imageset, cls, str(tmp_path / "cj"), 0.5,
                                         use_07)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        aps.append(got[2])
    assert 0 < np.mean(aps) < 1


# -------------------------------------------------------- post-processing
def _raw_outputs(seed, r=40, c=21):
    """Score-separated raw head outputs of one image: softmax [R, C] of
    distinct logits, deltas [R, C, 4], rois [R, 4] on a 300x400 image,
    roi_valid [R] with a few invalid slots."""
    rng = np.random.RandomState(seed)
    logits = rng.permutation(r * c).reshape(r, c).astype(np.float32) * 0.01
    sm = np.exp(logits - logits.max(1, keepdims=True))
    sm = (sm / sm.sum(1, keepdims=True)).astype(np.float32)
    deltas = rng.normal(0, 1, (r, c, 4)).astype(np.float32)
    xy = rng.uniform(0, 300, (r, 2))
    rois = np.concatenate([xy, xy + rng.uniform(10, 150, (r, 2))], 1).astype(np.float32)
    valid = rng.uniform(size=r) > 0.1
    return sm, deltas, rois, valid


KW = dict(score_threshold=0.0, nms_iou_threshold=0.3, min_size=10.0, target_means=MEANS,
          target_stds=STDS)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("clip", [True, False])
def test_eval_post_process_matches_jax(seed, clip):
    sm, deltas, rois, valid = _raw_outputs(seed)
    got = port_files.eval_post_process(*map(torch.from_numpy, (sm, deltas, rois, valid)),
                                       300.0, 400.0, max_per_class=30, clip_deltas=clip, **KW)
    want = jax_files.eval_post_process(*map(jnp.asarray, (sm, deltas, rois, valid)), 300.0,
                                       400.0, num_classes=21, max_per_class=30,
                                       clip_deltas=clip, **KW)
    (gb, gs, gv), (wb, ws, wv) = [t.numpy() for t in got], [np.asarray(t) for t in want]
    np.testing.assert_array_equal(gv, wv)
    assert gv.any() and not gv.all()
    np.testing.assert_array_equal(gs[gv], ws[wv])
    # a few ulps of the image's extent: the coordinates are sums and
    # differences of values up to 400 px, whatever their own size
    np.testing.assert_allclose(gb[gv], wb[wv], rtol=0, atol=4 * np.spacing(np.float32(400)))
    assert gb.shape == (20, 30, 4)


def test_cap_per_image_matches_jax(voc_root):
    for dets in _detections(voc_root, 2):
        for cap in (0, 1, 3, 100):
            for g, w in zip(port_files._cap_per_image(dets, cap),
                            jax_files._cap_per_image(dets, cap)):
                np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- result files
def test_write_voc_detection_files_byte_identical(voc_root, tmp_path):
    per_image = _detections(voc_root, 3)
    per_image[2] = None  # an image without results writes no line
    got = port_files.write_voc_detection_files(per_image, IDS, PASCAL_CLASSES,
                                               str(tmp_path / "p_{}.txt"))
    want = jax_files.write_voc_detection_files(per_image, IDS, PASCAL_CLASSES,
                                               str(tmp_path / "j_{}.txt"))
    assert len(got) == 20
    assert [_read(p) for p in got] == [_read(p) for p in want]
    assert any(_read(p) for p in got)


class _Stand:
    """A detector stand-in: raw head outputs looked up by the image index
    stored in each image's first pixel, as the framework's tensors."""

    def __init__(self, outputs, to, takes_params):
        self.cfg = dict(config_factory("pascal", "faster_rcnn"))
        self.num_classes = 21
        self.outputs, self.to, self.takes_params = outputs, to, takes_params

    def im_detect_batch(self, *args):
        images, _, scales = args[1:] if self.takes_params else args
        idx = [int(i) for i in np.asarray(images)[:, 0, 0, 0]]
        sm, deltas, rois, valid = (np.stack([self.outputs[i][k] for i in idx]) for k in range(4))
        rois = rois / np.asarray(scales)[:, None, None]
        return tuple(self.to(a) for a in (sm, deltas, rois, valid))


def test_get_prediction_files_byte_identical(tmp_path):
    """Both frameworks' `get_prediction_files` over the same stream (two
    buckets, batch 2, a partial batch) and the same raw head outputs."""
    outputs = [_raw_outputs(10 + i) for i in range(5)]
    items = []
    for i in range(5):
        image = np.zeros((16, 24, 3) if i % 2 else (24, 16, 3), np.float32)
        image[0, 0, 0] = i
        items.append((image, np.asarray(image.shape[:2]), 1.0 + 0.25 * i, 300, 400))
    ids = [f"img{i}" for i in range(5)]
    kw = dict(max_objects_per_class=8, max_objects_per_image=30, batch_size=2)
    got = port_files.get_prediction_files(_Stand(outputs, torch.from_numpy, False), iter(items),
                                          ids, str(tmp_path / "p_{}.txt"), **kw)
    want = jax_files.get_prediction_files(_Stand(outputs, jnp.asarray, True), None, iter(items),
                                          ids, str(tmp_path / "j_{}.txt"), **kw)
    assert [_read(p) for p in got] == [_read(p) for p in want]
    lines = sum(_read(p).count(b"\n") for p in got)
    assert 5 <= lines <= 5 * 30


def test_ground_truth_as_detections_scores_one(voc_root, tmp_path):
    """The tree's ground truth written as detections: AP exactly 1 for every
    class with a ground truth (the check chip_smoke.py makes on the card's
    eval path); with `use_07_metric`, exactly the float sum of eleven 1/11."""
    gt = _ground_truth(voc_root)
    per_image = [[np.asarray([list(np.asarray(o["bbox"]) - 1) + [1.0] for o in gt[i]["objects"]
                              if o["name"] == c]).reshape(-1, 5) for c in PASCAL_CLASSES]
                 for i in IDS]
    fmt = str(tmp_path / "gt_{}.txt")
    port_files.write_voc_detection_files(per_image, IDS, PASCAL_CLASSES, fmt)
    present = {o["name"] for g in gt.values() for o in g["objects"] if not o["difficult"]}
    eleven = 0.0
    for _ in range(11):
        eleven += 1.0 / 11.0
    for use_07 in FLAGS:
        for cls in present:
            _, _, ap = voc_eval.voc_eval(fmt, os.path.join(voc_root, "Annotations", "{}.xml"),
                                         os.path.join(voc_root, "ImageSets", "Main", "test.txt"),
                                         cls, str(tmp_path / "cache"), 0.5, use_07)
            assert ap == (eleven if use_07 else 1.0), cls


# ------------------------------------------------------------------ metrics
def test_metric_writer_byte_identical(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    image = np.random.RandomState(0).randint(0, 255, (12, 20, 3)).astype(np.uint8)
    for name, mod in (("port", metrics), ("jax", jax_metrics)):
        w = mod.MetricWriter(str(tmp_path / name), name="train")
        w.write_scalars(1, {"total_loss": 1.5, "rpn_cls_loss": np.float32(0.25)})
        w.write_scalars(20, {"lr": 1e-3})
        w.write_image(20, "boxes", image)
        w.flush()
        w.close()
    got, want = sorted(os.listdir(tmp_path / "port")), sorted(os.listdir(tmp_path / "jax"))
    assert got == want and len(got) == 2
    for f in got:
        assert _read(tmp_path / "port" / f) == _read(tmp_path / "jax" / f), f
    metrics.MetricWriter(None).write_scalars(0, {"x": 1.0})  # no log dir: writes nothing

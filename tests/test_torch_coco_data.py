"""The port's COCO data path against the JAX package's, on the CPU.

A small COCO tree in a temporary directory (PIL JPEGs; category ids 1, 18
and 90; four landscape images and a portrait one; a crowd annotation and a
zero-width box, both left out of training; a 16-px-high image that is
filtered out):

- `CocoDataset`: kept images, label maps, paths, boxes and labels equal;
- `coco_train_batches`: equal batch for batch over two epochs at batch 1
  and 2 with shuffle and augmentation, and once in file order;
- `coco_eval_iterator` and both COCO modes of `dataset_factory` equal;
- `coco_rehearsal.generate` writes the JAX script's JSONs and JPEGs byte
  for byte for a seed, and `draw_image80` draws the same arrays;
- an unreadable image raises IOError in the COCO and the Pascal readers.
"""

import importlib.util
import itertools
import json
import os
import sys

import numpy as np
import pytest

from tf_eager_object_detection_tpu.data import coco as jax_coco
from tf_eager_object_detection_tpu.data import dataset_factory as jax_factory_mod
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.data import coco
from tf_eager_object_detection_tpu_torch.data import dataset_factory as port_factory_mod
from tf_eager_object_detection_tpu_torch.data import pascal
from tf_eager_object_detection_tpu_torch.scripts import coco_rehearsal

from test_torch_voc_data import _equal_batches, _equal_items, write_voc_tree

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (height, width) of the kept images: four landscape, one portrait
SIZES = [(96, 128), (96, 128), (100, 120), (96, 128), (128, 96)]


def write_coco_tree(root):
    """Images and an instances JSON -> (annotation file, image dir)."""
    from PIL import Image

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    rng = np.random.RandomState(0)
    images, annotations = [], []

    def annotate(image_id, cat, bbox, iscrowd=0):
        annotations.append({"id": len(annotations) + 1, "image_id": image_id,
                            "category_id": cat, "bbox": bbox, "area": bbox[2] * bbox[3],
                            "iscrowd": iscrowd})

    for i, (h, w) in enumerate(SIZES):
        name = f"img_{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
            os.path.join(img_dir, name))
        images.append({"id": 100 + i, "file_name": name, "height": h, "width": w})
        for _ in range(2 + i % 2):
            x, y = int(rng.randint(0, w - 40)), int(rng.randint(0, h - 40))
            annotate(100 + i, int(rng.choice([1, 18, 90])),
                     [x, y, int(rng.randint(10, 40)), int(rng.randint(10, 40))])
    annotate(101, 18, [5, 5, 30, 30], iscrowd=1)  # left out of training
    annotate(102, 90, [10, 10, 0, 20])  # zero width: left out
    annotate(103, 1, [110.5, 80.0, 40.0, 30.0])  # reaches past the image: clipped
    # a tiny image (min edge < 32) with a box: filtered out
    Image.fromarray(rng.randint(0, 255, (16, 100, 3), np.uint8)).save(
        os.path.join(img_dir, "tiny.jpg"))
    images.append({"id": 999, "file_name": "tiny.jpg", "height": 16, "width": 100})
    annotate(999, 1, [1, 1, 10, 10])
    ann = {"images": images, "annotations": annotations,
           "categories": [{"id": 90, "name": "toothbrush"}, {"id": 1, "name": "person"},
                          {"id": 18, "name": "dog"}]}
    path = os.path.join(root, "instances.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path, img_dir


@pytest.fixture(scope="module")
def coco_tree(tmp_path_factory):
    return write_coco_tree(str(tmp_path_factory.mktemp("coco")))


def _cfg():
    cfg = dict(config_factory("coco", "faster_rcnn"))
    cfg.update(image_min_size=60, image_max_size=100, tpu_max_gt_boxes=6,
               tpu_image_buckets=[[64, 104], [104, 64]])
    return cfg


def test_coco_dataset_matches_jax(coco_tree):
    got, want = coco.CocoDataset(*coco_tree), jax_coco.CocoDataset(*coco_tree)
    assert len(got) == len(want) == len(SIZES)
    assert got.cat_id_to_label == want.cat_id_to_label == {1: 1, 18: 2, 90: 3}
    assert got.label_to_cat_id == want.label_to_cat_id
    assert got.cat_names == want.cat_names
    assert got.images == want.images and got.anns == want.anns
    n_boxes = 0
    for i in range(len(got)):
        g, w = got.item(i), want.item(i)
        assert g[0] == w[0] and g[3:] == w[3:]
        for a, b in zip(g[1:3], w[1:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert (g[1] >= 0).all() and (g[1] <= 1).all()
        n_boxes += len(g[1])
    assert n_boxes == 13  # 12 drawn + the clipped one; no crowd, zero-width or tiny-image box
    np.testing.assert_array_equal(got.item(3)[1][-1], np.float32([80 / 96, 110.5 / 128, 1, 1]))


def _batches(mod, ds, n, **kw):
    it = mod.coco_train_batches(ds, _cfg(), num_workers=2, **kw)
    try:
        return list(itertools.islice(it, n))
    finally:
        it.close()


# batches of two epochs: batch 1 -> 5 an epoch; batch 2 -> two landscape
# pairs and the portrait one padded
@pytest.mark.parametrize("batch,n", [(1, 10), (2, 6)])
def test_train_batches_over_two_epochs_match_jax(coco_tree, batch, n):
    kw = dict(batch_size=batch, shuffle=True, augment=True, seed=3)
    got = _batches(coco, coco.CocoDataset(*coco_tree), n, **kw)
    want = _batches(jax_coco, jax_coco.CocoDataset(*coco_tree), n, **kw)
    _equal_batches(got, want)
    assert {b["images"].shape for b in got} == {(batch, 64, 104, 3), (batch, 104, 64, 3)}
    if batch == 2:  # the lone portrait image is padded with itself
        portrait = [b for b in got if b["images"].shape[1] == 104]
        assert len(portrait) == 2
        np.testing.assert_array_equal(portrait[0]["images"][0], portrait[0]["images"][1])
    # the two epochs differ (each epoch shuffles anew)
    first = [b["image_hw"].tolist() for b in got[:n // 2]]
    assert first != [b["image_hw"].tolist() for b in got[n // 2:]] or batch == 2


def test_train_batches_in_file_order_match_jax(coco_tree):
    kw = dict(batch_size=2, shuffle=False, augment=False, repeat=False)
    got = list(coco.coco_train_batches(coco.CocoDataset(*coco_tree), _cfg(), **kw))
    want = list(jax_coco.coco_train_batches(jax_coco.CocoDataset(*coco_tree), _cfg(), **kw))
    _equal_batches(got, want)
    assert len(got) == 3 and got[0]["gt_mask"][:, :2].all()


@pytest.mark.parametrize("ptype,fmt", [("caffe", None), ("tf", None), ("caffe", "rgb")])
def test_eval_iterator_matches_jax(coco_tree, ptype, fmt):
    it, ds = coco.coco_eval_iterator(*coco_tree, _cfg(), ptype, image_format=fmt)
    jit, jds = jax_coco.coco_eval_iterator(*coco_tree, _cfg(), ptype, image_format=fmt)
    got, want = list(it), list(jit)
    _equal_items(got, want)
    assert [g[5] for g in got] == [100, 101, 102, 103, 104]
    assert ds.label_to_cat_id == jds.label_to_cat_id


def test_dataset_factory_coco_matches_jax(coco_tree):
    ann, img_dir = coco_tree
    train = dict(model_config=_cfg(), annotation_file=ann, image_dir=img_dir, batch_size=2,
                 repeat=False, seed=4)
    _equal_batches(list(port_factory_mod.dataset_factory("coco", "train", train)),
                   list(jax_factory_mod.dataset_factory("coco", "train", train)))
    val = dict(model_config=_cfg(), annotation_file=ann, image_dir=img_dir)
    (it, ds), (jit, jds) = (port_factory_mod.dataset_factory("coco", "val", val),
                            jax_factory_mod.dataset_factory("coco", "val", val))
    _equal_items(list(it), list(jit))
    assert ds.images == jds.images


# ------------------------------------------------------------- unreadable
def test_unreadable_image_raises_ioerror(coco_tree, tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    with pytest.raises(IOError, match="cannot read"):
        pascal._read_image(str(bad))
    with pytest.raises(IOError, match="cannot read"):
        jax_coco._read_image(str(bad))
    # the COCO eval iterator over a tree whose first image is unreadable
    ann, img_dir = coco_tree
    with open(ann) as f:
        data = json.load(f)
    data["images"][0]["file_name"] = str(bad)  # os.path.join keeps an absolute name
    broken = tmp_path / "broken.json"
    broken.write_text(json.dumps(data))
    it, _ = coco.coco_eval_iterator(str(broken), img_dir, _cfg(), num_workers=1)
    with pytest.raises(IOError, match="cannot read"):
        next(it)


def test_unreadable_voc_image_raises_ioerror(tmp_path):
    voc_root = write_voc_tree(str(tmp_path / "voc"))
    ids = open(os.path.join(voc_root, "ImageSets", "Main", "test.txt")).read().split()
    with open(os.path.join(voc_root, "JPEGImages", ids[0] + ".jpg"), "wb") as f:
        f.write(b"\xff\xd8 truncated")
    cfg = dict(config_factory("pascal", "faster_rcnn"), image_min_size=128, image_max_size=192,
               tpu_image_buckets=[[128, 192], [192, 128]])
    it, _ = pascal.pascal_eval_iterator(voc_root, "test", cfg, num_workers=1)
    with pytest.raises(IOError, match="cannot read"):
        next(it)


def test_read_image_with_pil_raises_ioerror(tmp_path, monkeypatch):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    monkeypatch.setattr(pascal, "cv2", None)
    with pytest.raises(IOError):
        pascal._read_image(str(bad))


# -------------------------------------------------------------- rehearsal
def _jax_rehearsal():
    """The root script, loaded as JAX's test of it loads it (its directory
    on the path for its `voc_rehearsal` import)."""
    scripts = os.path.join(_ROOT, "scripts")
    sys.path.insert(0, scripts)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_coco_rehearsal", os.path.join(scripts, "coco_rehearsal.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(scripts)
    return mod


def test_draw_image80_matches_jax():
    jax_mod = _jax_rehearsal()
    assert coco_rehearsal.COCO_CAT_IDS == jax_mod.COCO_CAT_IDS
    assert len(coco_rehearsal.COCO_CAT_IDS) == 80
    for seed in range(3):
        img, objs = coco_rehearsal.draw_image80(np.random.RandomState(seed))
        jimg, jobjs = jax_mod.draw_image80(np.random.RandomState(seed))
        np.testing.assert_array_equal(img, jimg)
        assert objs == jobjs and len(objs) >= 3


def test_generate_byte_identical_to_jax(tmp_path):
    jax_mod = _jax_rehearsal()
    got = coco_rehearsal.generate(str(tmp_path / "port"), 3, 2, seed=0)
    want = jax_mod.generate(str(tmp_path / "jax"), 3, 2, seed=0)
    assert got == want
    files = []
    for sub in ("", "images"):
        names = sorted(f for f in os.listdir(tmp_path / "port" / sub)
                       if os.path.isfile(tmp_path / "port" / sub / f))
        assert names == sorted(f for f in os.listdir(tmp_path / "jax" / sub)
                               if os.path.isfile(tmp_path / "jax" / sub / f))
        files += [os.path.join(sub, n) for n in names]
    assert len(files) == 7  # two JSONs, five JPEGs
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    ds = coco.CocoDataset(str(tmp_path / "port" / "instances_train.json"),
                          str(tmp_path / "port" / "images"))
    assert ds.cat_id_to_label == {c: i + 1 for i, c in enumerate(coco_rehearsal.COCO_CAT_IDS)}

"""The port's VOC data path against the JAX package's, on the CPU.

The test writes a small VOC tree to a temporary directory (annotation
XMLs, JPEGs written by cv2, image sets) and feeds both frameworks the same
files: label maps, parsed annotations, Example encodings and TFRecord
files (byte-identical), the TFRecords of `create_pascal_tf_records`
(byte-identical), the eval iterators and the train batches (equal arrays
for the same seed) and `dataset_factory`. Everything here is exact.
"""

import os
import sys

import cv2
import numpy as np
import pytest

from tf_eager_object_detection_tpu.data import dataset_factory as jax_factory_mod
from tf_eager_object_detection_tpu.data import label_map as jax_label_map
from tf_eager_object_detection_tpu.data import pascal as jax_pascal
from tf_eager_object_detection_tpu.data import tfrecord as jax_tfrecord
from tf_eager_object_detection_tpu.data import voc as jax_voc
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.data import dataset_factory as port_factory_mod
from tf_eager_object_detection_tpu_torch.data import label_map, pascal, tfrecord, voc

SIZES = [(120, 160), (160, 120), (96, 128), (128, 96), (140, 100), (100, 150)]
IDS = [f"{i:06d}" for i in range(len(SIZES))]
LABEL_MAP = """
item { id: 1 name: 'aeroplane' display_name: "Aeroplane" }
item {
  name: "person"
  id: 15
  display_name: 'Person'
}
item { id: 20 name: 'tvmonitor' }
"""


def _xml(image_id, h, w, objects):
    objs = "".join(
        f"<object><name>{name}</name><pose>Left</pose><truncated>{trunc}</truncated>"
        f"<difficult>{diff}</difficult><bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin>"
        f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>"
        for name, diff, trunc, (x1, y1, x2, y2) in objects)
    return (f"<annotation><folder>VOC2007</folder><filename>{image_id}.jpg</filename>"
            f"<size><width>{w}</width><height>{h}</height><depth>3</depth></size>"
            f"{objs}</annotation>")


def write_voc_tree(root, sizes=SIZES, seed=0):
    """`root`/VOC2007 with JPEGs, annotations of 1-4 objects each (some
    difficult, one without a difficult tag) and the image sets trainval and
    test (every image). Returns the VOC2007 path."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "VOC2007")
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    classes = label_map.PASCAL_CLASSES
    for image_id, (h, w) in zip(IDS, sizes):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([xx * 255.0 / w, yy * 255.0 / h, rng.uniform(0, 255, (h, w))], -1)
        cv2.imwrite(os.path.join(base, "JPEGImages", f"{image_id}.jpg"), img.astype(np.uint8))
        objects = []
        for _ in range(rng.randint(1, 5)):
            x1, y1 = rng.randint(1, w // 2), rng.randint(1, h // 2)
            box = (x1, y1, rng.randint(x1 + 8, w + 1), rng.randint(y1 + 8, h + 1))
            objects.append((classes[rng.randint(20)], int(rng.uniform() < 0.2), 0, box))
        text = _xml(image_id, h, w, objects)
        if image_id == IDS[1]:  # an object without a difficult tag
            text = text.replace("<difficult>0</difficult>", "", 1).replace(
                "<difficult>1</difficult>", "", 1)
        with open(os.path.join(base, "Annotations", f"{image_id}.xml"), "w") as f:
            f.write(text)
    for mode in ("trainval", "test"):
        with open(os.path.join(base, "ImageSets", "Main", f"{mode}.txt"), "w") as f:
            f.write("".join(f"{i}\n" for i in IDS))
    return base


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return write_voc_tree(str(tmp_path_factory.mktemp("voc")))


@pytest.fixture(scope="module")
def records(voc_root, tmp_path_factory):
    """The tree's test set as 2 TFRecord shards, written by the port."""
    out = str(tmp_path_factory.mktemp("records"))
    return voc.create_pascal_tf_records(os.path.dirname(voc_root), "2007", "test", out, 2)


def _cfg():
    cfg = dict(config_factory("pascal", "faster_rcnn"))
    cfg.update(image_min_size=128, image_max_size=192, tpu_max_gt_boxes=8,
               tpu_image_buckets=[[128, 192], [192, 128]])
    return cfg


def _equal_items(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _equal_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ----------------------------------------------------------------- label map
@pytest.mark.parametrize("display", [False, True])
def test_label_map_matches_jax(display, tmp_path):
    path = tmp_path / "map.pbtxt"
    path.write_text(LABEL_MAP)
    assert label_map.parse_label_map(LABEL_MAP) == jax_label_map.parse_label_map(LABEL_MAP)
    for src in (LABEL_MAP, str(path)):
        assert (label_map.get_label_map_dict(src, use_display_name=display)
                == jax_label_map.get_label_map_dict(src, use_display_name=display))
    assert label_map.pascal_label_map_dict() == jax_label_map.pascal_label_map_dict()
    assert label_map.PASCAL_CLASSES == jax_label_map.PASCAL_CLASSES


def test_label_map_rejects_negative_ids():
    with pytest.raises(ValueError):
        label_map.get_label_map_dict("item { id: -1 name: 'x' }")


# --------------------------------------------------------------- annotations
@pytest.mark.parametrize("image_id", IDS)
def test_parse_voc_xml_matches_jax(voc_root, image_id):
    path = os.path.join(voc_root, "Annotations", f"{image_id}.xml")
    assert voc.parse_voc_xml(path) == jax_voc.parse_voc_xml(path)


# ------------------------------------------------------ Examples, TFRecords
EXAMPLES = {
    "voc": {"image/height": ("int64", [375]), "image/filename": ("bytes", [b"000005.jpg"]),
            "image/object/bbox/xmin": ("float", [0.1, 0.25, 0.999]),
            "image/object/class/label": ("int64", [9, 15, 20]),
            "image/object/class/text": ("bytes", [b"chair", b"person", b"tvmonitor"])},
    "negative_and_large_ints": {"v": ("int64", [-1, -(2**63), 2**63 - 1, 0, 300])},
    "empty_lists": {"a": ("int64", []), "b": ("float", []), "c": ("bytes", [])},
    "long_bytes": {"img": ("bytes", [bytes(range(256)) * 40]), "f": ("float", [1e-30, -2.5])},
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_encode_example_byte_identical_and_round_trips(name):
    feats = EXAMPLES[name]
    blob = tfrecord.encode_example(feats)
    assert blob == jax_tfrecord.encode_example(feats)
    got = tfrecord.decode_example(blob)
    assert got == jax_tfrecord.decode_example(blob)
    assert got.keys() == feats.keys()
    for k, (kind, values) in feats.items():
        assert got[k][0] == kind
        if kind == "float":
            np.testing.assert_array_equal(np.float32(got[k][1]), np.float32(values))
        else:
            assert list(got[k][1]) == list(values)


def test_tfrecord_files_byte_identical(tmp_path):
    recs = [tfrecord.encode_example(e) for e in EXAMPLES.values()] + [b"", b"x" * 1000]
    paths = [str(tmp_path / "port.tfrecords"), str(tmp_path / "jax.tfrecords")]
    for path, writer in zip(paths, (tfrecord.TFRecordWriter, jax_tfrecord.TFRecordWriter)):
        with writer(path) as w:
            for r in recs:
                w.write(r)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert list(tfrecord.read_tfrecords(paths[0], check_crc=True)) == recs


def test_corrupt_tfrecord_is_refused(tmp_path):
    path = str(tmp_path / "r.tfrecords")
    with tfrecord.TFRecordWriter(path) as w:
        w.write(b"payload")
    data = bytearray(open(path, "rb").read())
    data[14] ^= 1  # a payload byte
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError):
        list(tfrecord.read_tfrecords(path, check_crc=True))


@pytest.mark.parametrize("n", [0, 1, 9, 100, 4097])
def test_crc_table_matches_google_crc32c(n):
    google_crc32c = pytest.importorskip("google_crc32c")
    data = np.random.RandomState(n).bytes(n)
    table = tfrecord._crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    assert crc ^ 0xFFFFFFFF == google_crc32c.value(data) == tfrecord._crc32c(data)


@pytest.mark.parametrize("shards", [1, 3])
def test_create_pascal_tf_records_byte_identical(voc_root, tmp_path, shards):
    root = os.path.dirname(voc_root)
    got = voc.create_pascal_tf_records(root, "2007", "trainval", str(tmp_path / "p"), shards)
    want = jax_voc.create_pascal_tf_records(root, "2007", "trainval", str(tmp_path / "j"), shards)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


# ---------------------------------------------------------- decoding, iterators
def test_decode_jpeg_matches_jax(voc_root):
    with open(os.path.join(voc_root, "JPEGImages", f"{IDS[0]}.jpg"), "rb") as f:
        data = f.read()
    got = pascal.decode_jpeg(data)
    np.testing.assert_array_equal(got, jax_pascal._decode_jpeg(data))
    assert got.shape == SIZES[0] + (3,) and got.dtype == np.uint8


def test_decode_jpeg_with_pil_when_cv2_is_absent(voc_root, monkeypatch):
    pytest.importorskip("PIL")
    with open(os.path.join(voc_root, "JPEGImages", f"{IDS[0]}.jpg"), "rb") as f:
        data = f.read()
    monkeypatch.setattr(pascal, "cv2", None)
    monkeypatch.setattr(jax_pascal, "cv2", None)
    np.testing.assert_array_equal(pascal.decode_jpeg(data), jax_pascal._decode_jpeg(data))


def test_decode_jpeg_without_a_decoder_raises(voc_root, monkeypatch):
    """No cv2 and no PIL (as on a machine with neither): decoding raises a
    clear error, it does not return a wrong image."""
    with open(os.path.join(voc_root, "JPEGImages", f"{IDS[0]}.jpg"), "rb") as f:
        data = f.read()
    monkeypatch.setattr(pascal, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="ROADMAP item 10"):
        pascal.decode_jpeg(data)


@pytest.mark.parametrize("ptype,fmt", [("caffe", None), ("tf", None), ("caffe", "rgb")])
def test_eval_iterator_matches_jax(voc_root, ptype, fmt):
    cfg = _cfg()
    it, ids = pascal.pascal_eval_iterator(voc_root, "test", cfg, ptype, image_format=fmt)
    jit, jids = jax_pascal.pascal_eval_iterator(voc_root, "test", cfg, ptype, image_format=fmt)
    assert ids == jids == IDS
    _equal_items(list(it), list(jit))


def test_eval_iterator_from_tf_records_matches_jax(records):
    cfg = _cfg()
    it, ids = pascal.pascal_eval_iterator_from_tf_records(records, cfg)
    jit, jids = jax_pascal.pascal_eval_iterator_from_tf_records(records, cfg)
    assert ids == jids and sorted(ids) == IDS
    _equal_items(list(it), list(jit))


@pytest.mark.parametrize("batch,shuffle,augment", [(1, False, False), (2, True, True),
                                                   (4, True, True)])
def test_train_batches_match_jax(records, batch, shuffle, augment):
    cfg = _cfg()
    kw = dict(batch_size=batch, shuffle=shuffle, repeat=False, seed=3, augment=augment)
    got = list(pascal.pascal_train_batches(records, cfg, **kw))
    _equal_batches(got, list(jax_pascal.pascal_train_batches(records, cfg, **kw)))
    assert sum(b["images"].shape[0] for b in got) >= len(IDS)
    assert all(b["gt_mask"].any(axis=1).all() for b in got)


def test_train_batches_repeat_over_epochs_like_jax(records):
    cfg = _cfg()
    kw = dict(batch_size=2, shuffle=True, repeat=True, seed=5)
    got, want = pascal.pascal_train_batches(records, cfg, **kw), \
        jax_pascal.pascal_train_batches(records, cfg, **kw)
    _equal_batches([next(got) for _ in range(9)], [next(want) for _ in range(9)])
    got.close()
    want.close()


def test_parse_pascal_example_matches_jax(records):
    for rec in tfrecord.read_tfrecords(records[0]):
        _equal_items([pascal.parse_pascal_example(rec)], [jax_pascal.parse_pascal_example(rec)])


# ------------------------------------------------------------ dataset factory
def test_dataset_factory_pascal_matches_jax(voc_root, records):
    cfg = _cfg()
    train = dict(model_config=cfg, tf_records_list=records, batch_size=2, repeat=False, seed=2)
    _equal_batches(list(port_factory_mod.dataset_factory("pascal", "train", train)),
                   list(jax_factory_mod.dataset_factory("pascal", "train", train)))
    test = dict(model_config=cfg, root_path=voc_root)
    it, ids = port_factory_mod.dataset_factory("pascal", "test", test)
    jit, jids = jax_factory_mod.dataset_factory("pascal", "test", test)
    assert ids == jids
    _equal_items(list(it), list(jit))


@pytest.mark.parametrize("mode", ["train", "val"])
def test_dataset_factory_coco_is_not_ported(mode):
    """COCO is ported now (the name is older): its modes dispatch to the COCO
    data functions as JAX's do, so a config without an annotation file raises
    the same KeyError in both (tests/test_torch_coco_data.py holds the data)."""
    for factory in (port_factory_mod.dataset_factory, jax_factory_mod.dataset_factory):
        with pytest.raises(KeyError, match="annotation_file"):
            factory("coco", mode, dict(model_config=_cfg()))


def test_dataset_factory_rejects_unknown_modes():
    with pytest.raises(ValueError):
        port_factory_mod.dataset_factory("pascal", "val", dict(model_config=_cfg()))

"""Pascal VOC training batches and eval iterators
(port of `tf_eager_object_detection_tpu/data/pascal.py`).

- `pascal_train_batches`: TFRecords -> random flip -> caffe or tf
  normalization -> resize -> pad to a bucket -> padded batch dicts, one
  bucket per batch.
- `pascal_eval_iterator` (a VOC tree) and
  `pascal_eval_iterator_from_tf_records`: (image, image_hw, scale, raw_h,
  raw_w) per image, in `preprocessing.preprocess_eval_image`'s form, and
  the image ids.

Images are decoded and preprocessed in a small thread pool, each with a
`np.random.RandomState` seeded from the iterator's seed, so a seed gives
the same batches. JPEGs are decoded by cv2 where it is installed, else by
PIL; where neither is, decoding raises (a decoder that needs neither is
ROADMAP item 10). The JAX module's native decoder (`tpu_native_decode`) is
not carried over.
"""

from __future__ import annotations

import io
import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from tf_eager_object_detection_tpu_torch.data.preprocessing import (
    preprocess_eval_image,
    preprocess_train_image,
)
from tf_eager_object_detection_tpu_torch.data.tfrecord import decode_example, read_tfrecords
from tf_eager_object_detection_tpu_torch.data.voc import read_image_set

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

__all__ = [
    "decode_jpeg",
    "parse_pascal_example",
    "pascal_train_batches",
    "pascal_eval_iterator",
    "pascal_eval_iterator_from_tf_records",
]


def _pil():
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            "decoding a JPEG needs cv2 or PIL, and neither is installed; a decoder "
            "of the port's own is ROADMAP item 10"
        ) from None
    return Image


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> RGB uint8 [H, W, 3]."""
    if cv2 is not None:
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    return np.asarray(_pil().open(io.BytesIO(data)).convert("RGB"))


def _read_image(path: str) -> np.ndarray:
    """An image file -> RGB uint8 [H, W, 3]; IOError if it cannot be read."""
    if cv2 is not None:
        img = cv2.imread(path)
        if img is None:
            raise IOError(f"cannot read {path}")
        return img[..., ::-1]
    return np.asarray(_pil().open(path).convert("RGB"))  # PIL raises an OSError (IOError)


def parse_pascal_example_raw(record: bytes):
    """Serialized Example -> (JPEG bytes, boxes [N, 4] normalized yxyx, labels [N])."""
    feats = decode_example(record)
    jpeg = feats["image/encoded"][1][0]
    ymin, xmin, ymax, xmax = (np.asarray(feats.get(f"image/object/bbox/{k}", ("float", []))[1])
                              for k in ("ymin", "xmin", "ymax", "xmax"))
    boxes = (np.stack([ymin, xmin, ymax, xmax], axis=1).astype(np.float32) if len(ymin)
             else np.zeros((0, 4), np.float32))
    labels = np.asarray(feats.get("image/object/class/label", ("int64", []))[1], np.int32)
    return jpeg, boxes, labels


def parse_pascal_example(record: bytes):
    """Serialized Example -> (RGB image, boxes [N, 4] normalized yxyx, labels [N])."""
    jpeg, boxes, labels = parse_pascal_example_raw(record)
    return decode_jpeg(jpeg), boxes, labels


def _stack_batch(group):
    imgs, hws, boxes, masks, labels = zip(*group)
    return {
        "images": np.stack(imgs),
        "image_hw": np.stack(hws),
        "gt_boxes": np.stack(boxes),
        "gt_mask": np.stack(masks),
        "gt_labels": np.stack(labels),
    }


def pascal_train_batches(
    tfrecord_paths: Sequence[str],
    cfg: dict,
    batch_size: int = 1,
    shuffle: bool = True,
    repeat: bool = True,
    seed: int = 0,
    augment: bool = True,
    preprocessing_type: str = "caffe",
    num_workers: int = 4,
) -> Iterator[dict]:
    """Padded batch dicts from TFRecords: images [B, Hb, Wb, 3], image_hw
    [B, 2], gt_boxes [B, G, 4] xyxy pixels, gt_mask [B, G], gt_labels
    [B, G]; every image of a batch in one bucket. Each epoch reads the
    records anew; at its end an incomplete group is filled by repeating its
    last element."""
    paths = list(tfrecord_paths)
    py_rng = random.Random(seed)

    def load(args):
        record, img_seed = args
        image, boxes, labels = parse_pascal_example(record)
        return preprocess_train_image(image, boxes, labels, cfg, np.random.RandomState(img_seed),
                                      augment=augment, preprocessing_type=preprocessing_type)

    pool = ThreadPoolExecutor(num_workers)
    try:
        while True:
            records = [r for p in paths for r in read_tfrecords(p)]
            if shuffle:
                py_rng.shuffle(records)
            seeds = [py_rng.randrange(2**31) for _ in records]
            buckets: dict = {}
            for item in pool.map(load, zip(records, seeds)):
                key = item[0].shape[:2]
                buckets.setdefault(key, []).append(item)
                if len(buckets[key]) == batch_size:
                    yield _stack_batch(buckets.pop(key))
            for group in buckets.values():
                group += [group[-1]] * (batch_size - len(group))
                yield _stack_batch(group)
            if not repeat:
                return
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def _mapped(load: Callable, items: Iterable, num_workers: int) -> Iterator:
    pool = ThreadPoolExecutor(num_workers)
    try:
        yield from pool.map(load, items)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def pascal_eval_iterator_from_tf_records(
    tfrecord_paths: Sequence[str],
    cfg: dict,
    preprocessing_type: str = "caffe",
    num_workers: int = 4,
    image_format: Optional[str] = None,
):
    """(iterator of (image, image_hw, scale, raw_h, raw_w), image ids from the
    stored filenames) over TFRecords."""
    records = [r for p in tfrecord_paths for r in read_tfrecords(p)]
    image_ids = []
    for rec in records:
        name = decode_example(rec).get("image/filename", ("bytes", [b""]))[1][0].decode()
        image_ids.append(os.path.splitext(name)[0])

    def load(rec):
        image = decode_jpeg(parse_pascal_example_raw(rec)[0])
        return preprocess_eval_image(image, cfg, preprocessing_type, image_format=image_format)

    return _mapped(load, records, num_workers), image_ids


def pascal_eval_iterator(
    root_path: str,
    mode: str,
    cfg: dict,
    preprocessing_type: str = "caffe",
    num_workers: int = 4,
    image_format: Optional[str] = None,
):
    """(iterator of (image, image_hw, scale, raw_h, raw_w), image ids) over
    the `mode` image set of a VOC tree (`root_path` = .../VOC2007)."""
    image_ids = read_image_set(os.path.join(root_path, "ImageSets", "Main", f"{mode}.txt"))
    img_dir = os.path.join(root_path, "JPEGImages")

    def load(image_id):
        image = _read_image(os.path.join(img_dir, image_id + ".jpg"))
        return preprocess_eval_image(image, cfg, preprocessing_type, image_format=image_format)

    return _mapped(load, image_ids, num_workers), image_ids

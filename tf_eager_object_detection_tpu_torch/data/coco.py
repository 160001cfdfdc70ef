"""COCO training batches and eval iterators without pycocotools
(port of `tf_eager_object_detection_tpu/data/coco.py`).

The annotation JSON is read directly:

- category ids map to contiguous labels 1..K in sorted-id order;
- `iscrowd` annotations are left out of training;
- images with a min edge below 32, or with no box of positive width and
  height, are dropped;
- `coco_train_batches` yields the padded batch dicts of
  `data/pascal.py::pascal_train_batches` (the same shuffle, per-image
  seeds, augmentation and bucket flushing as the JAX module for a seed);
- `coco_eval_iterator` yields (image, image_hw, scale, raw_h, raw_w,
  img_id) per image in the annotation file's order.
"""

from __future__ import annotations

import json
import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from tf_eager_object_detection_tpu_torch.data.pascal import _mapped, _read_image, _stack_batch
from tf_eager_object_detection_tpu_torch.data.preprocessing import (
    preprocess_eval_image,
    preprocess_train_image,
)

__all__ = ["CocoDataset", "coco_train_batches", "coco_eval_iterator"]


class CocoDataset:
    """An index over a COCO instances JSON."""

    def __init__(self, annotation_file: str, image_dir: str, min_edge: int = 32):
        with open(annotation_file) as f:
            data = json.load(f)
        self.image_dir = image_dir
        cat_ids = sorted(c["id"] for c in data["categories"])
        self.cat_id_to_label = {cid: i + 1 for i, cid in enumerate(cat_ids)}
        self.label_to_cat_id = {v: k for k, v in self.cat_id_to_label.items()}
        self.cat_names = {c["id"]: c["name"] for c in data["categories"]}

        anns_by_img: Dict[int, List[dict]] = {}
        for ann in data["annotations"]:
            if ann.get("iscrowd", 0):
                continue
            anns_by_img.setdefault(ann["image_id"], []).append(ann)

        self.images: List[dict] = []
        self.anns: Dict[int, List[dict]] = {}
        for img in data["images"]:
            if min(img["height"], img["width"]) < min_edge:
                continue
            boxes = [a for a in anns_by_img.get(img["id"], [])
                     if a["bbox"][2] > 0 and a["bbox"][3] > 0]
            if not boxes:
                continue
            self.images.append(img)
            self.anns[img["id"]] = boxes

    def __len__(self):
        return len(self.images)

    def item(self, idx: int) -> Tuple[str, np.ndarray, np.ndarray, int, int, int]:
        """-> (path, boxes yxyx in [0, 1] [N, 4], labels [N], h, w, img_id)."""
        img = self.images[idx]
        h, w = img["height"], img["width"]
        anns = self.anns[img["id"]]
        boxes = np.zeros((len(anns), 4), np.float32)
        labels = np.zeros((len(anns),), np.int32)
        for i, a in enumerate(anns):
            x, y, bw, bh = a["bbox"]
            boxes[i] = [y / h, x / w, (y + bh) / h, (x + bw) / w]
            labels[i] = self.cat_id_to_label[a["category_id"]]
        np.clip(boxes, 0.0, 1.0, out=boxes)
        return os.path.join(self.image_dir, img["file_name"]), boxes, labels, h, w, img["id"]


def coco_train_batches(
    dataset: CocoDataset,
    cfg: dict,
    batch_size: int = 1,
    shuffle: bool = True,
    repeat: bool = True,
    seed: int = 0,
    augment: bool = True,
    preprocessing_type: str = "caffe",
    num_workers: int = 4,
) -> Iterator[dict]:
    """Padded batch dicts (`pascal_train_batches`' contract), every image of
    a batch in one bucket. Each epoch shuffles the image order, then draws
    one seed per image for its augmentation; at its end an incomplete group
    is filled by repeating its last element."""
    py_rng = random.Random(seed)

    def load(args):
        idx, img_seed = args
        path, boxes, labels, _, _, _ = dataset.item(idx)
        return preprocess_train_image(_read_image(path), boxes, labels, cfg,
                                      np.random.RandomState(img_seed), augment=augment,
                                      preprocessing_type=preprocessing_type)

    pool = ThreadPoolExecutor(num_workers)
    try:
        while True:
            order = list(range(len(dataset)))
            if shuffle:
                py_rng.shuffle(order)
            seeds = [py_rng.randrange(2**31) for _ in order]
            buckets: dict = {}
            for item in pool.map(load, zip(order, seeds)):
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


def coco_eval_iterator(
    annotation_file: str,
    image_dir: str,
    cfg: dict,
    preprocessing_type: str = "caffe",
    num_workers: int = 4,
    image_format: Optional[str] = None,
):
    """(iterator of (image, image_hw, scale, raw_h, raw_w, img_id), the
    dataset) over the annotation file's kept images, in its order."""
    ds = CocoDataset(annotation_file, image_dir)

    def load(idx):
        path, _, _, h, w, img_id = ds.item(idx)
        img, hw, scale, raw_h, raw_w = preprocess_eval_image(
            _read_image(path), cfg, preprocessing_type, image_format=image_format)
        return img, hw, scale, raw_h, raw_w, img_id

    return _mapped(load, range(len(ds)), num_workers), ds

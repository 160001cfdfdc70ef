"""The data API's dispatch (port of
`tf_eager_object_detection_tpu/data/dataset_factory.py`).

    dataset_factory("pascal", "train", configs) -> iterator of batch dicts
    dataset_factory("pascal", "test", configs) -> (iterator, image ids)
    dataset_factory("coco", "train", configs) -> iterator of batch dicts
    dataset_factory("coco", "val", configs) -> (iterator, CocoDataset)

`configs` holds the dataset function's keyword arguments (TFRecord paths,
the VOC root, the COCO annotation file and image directory, batch size,
...) and the model config under 'model_config'.
"""

from __future__ import annotations

from tf_eager_object_detection_tpu_torch.data.coco import (
    CocoDataset,
    coco_eval_iterator,
    coco_train_batches,
)
from tf_eager_object_detection_tpu_torch.data.pascal import (
    pascal_eval_iterator,
    pascal_train_batches,
)

__all__ = ["dataset_factory"]


def dataset_factory(dataset_type: str, mode: str, configs: dict):
    cfg = configs["model_config"]
    if dataset_type == "pascal" and mode == "train":
        return pascal_train_batches(
            configs["tf_records_list"],
            cfg,
            batch_size=configs.get("batch_size", 1),
            shuffle=configs.get("shuffle", True),
            repeat=configs.get("repeat", True),
            seed=configs.get("seed", 0),
            augment=configs.get("argument", True),
            preprocessing_type=configs.get("preprocessing_type", "caffe"),
        )
    if dataset_type == "pascal" and mode == "test":
        return pascal_eval_iterator(
            configs["root_path"],
            configs.get("image_set", "test"),
            cfg,
            preprocessing_type=configs.get("preprocessing_type", "caffe"),
        )
    if dataset_type == "coco" and mode == "train":
        return coco_train_batches(
            CocoDataset(configs["annotation_file"], configs["image_dir"]),
            cfg,
            batch_size=configs.get("batch_size", 1),
            shuffle=configs.get("shuffle", True),
            repeat=configs.get("repeat", True),
            seed=configs.get("seed", 0),
            augment=configs.get("argument", True),
            preprocessing_type=configs.get("preprocessing_type", "caffe"),
        )
    if dataset_type == "coco" and mode == "val":
        return coco_eval_iterator(
            configs["annotation_file"],
            configs["image_dir"],
            cfg,
            preprocessing_type=configs.get("preprocessing_type", "caffe"),
        )
    raise ValueError(f"unknown dataset type {dataset_type} / mode {mode} combination")

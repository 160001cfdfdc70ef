"""Config factory (port of `tf_eager_object_detection_tpu/config/config_factory.py`).

    config_factory("pascal", "faster_rcnn")
"""

from tf_eager_object_detection_tpu_torch.config.faster_rcnn_config import (
    COCO_CONFIG,
    PASCAL_CONFIG,
)

__all__ = ["config_factory"]


def config_factory(data_type, model_type):
    if model_type == "faster_rcnn":
        if data_type == "pascal":
            return PASCAL_CONFIG
        if data_type == "coco":
            return COCO_CONFIG
    elif model_type == "fpn":
        raise NotImplementedError("fpn is not ported yet (ROADMAP queue 1, FPN serving)")
    raise ValueError(
        f"config for dataset type {data_type} and model type {model_type} doesn't exist"
    )

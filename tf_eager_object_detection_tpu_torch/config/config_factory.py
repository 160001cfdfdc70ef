"""Config factory (port of `tf_eager_object_detection_tpu/config/config_factory.py`).

    config_factory("pascal", "faster_rcnn")
    config_factory("pascal", "fpn")
"""

from tf_eager_object_detection_tpu_torch.config import fpn_config
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
        if data_type == "pascal":
            return fpn_config.PASCAL_CONFIG
    raise ValueError(
        f"config for dataset type {data_type} and model type {model_type} doesn't exist"
    )

"""Config factory (port of `tf_eager_object_detection_tpu/config/config_factory.py`).

    config_factory("pascal", "faster_rcnn")
    config_factory("pascal", "fpn")
    apply_config_overrides(dict(cfg), ["image_min_size=96", "tpu_compute_dtype=float32"])
"""

import json

from tf_eager_object_detection_tpu_torch.config import fpn_config
from tf_eager_object_detection_tpu_torch.config.faster_rcnn_config import (
    COCO_CONFIG,
    PASCAL_CONFIG,
)

__all__ = ["config_factory", "apply_config_overrides"]


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


def apply_config_overrides(cfg, overrides):
    """Apply command-line `KEY=JSON` overrides to a config dict, in place.

    Values parse as JSON; a bare string needs no quotes, but a value that
    starts like a number, list, dict or quoted string must parse. Unknown
    keys raise.
    """
    for item in overrides:
        key, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"config override expects KEY=JSON, got {item!r}")
        if key not in cfg:
            raise KeyError(f"unknown config key {key!r}")
        try:
            cfg[key] = json.loads(raw)
        except json.JSONDecodeError:
            if raw[:1] in "[{\"'0123456789-" or raw == "":
                raise ValueError(
                    f"config override {key}={raw!r} is not valid JSON "
                    "(quote bare strings only; lists/dicts/numbers must parse)"
                ) from None
            cfg[key] = raw
    return cfg

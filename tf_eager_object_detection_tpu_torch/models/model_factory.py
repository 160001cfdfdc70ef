"""Model construction (port of `tf_eager_object_detection_tpu/models/model_factory.py`).

    model_factory("faster_rcnn", "resnet50", cfg, device="cuda", seed=0)
"""

from __future__ import annotations

from tf_eager_object_detection_tpu_torch.models.faster_rcnn import FasterRCNNDetector

__all__ = ["model_factory"]


def model_factory(model_type: str, backbone: str, config: dict, device="cpu", seed: int = 0):
    if model_type == "faster_rcnn":
        if backbone in ("resnet50", "resnet101", "resnet152"):
            return FasterRCNNDetector(backbone, config, device=device, seed=seed)
        if backbone == "vgg16":
            raise NotImplementedError(
                "faster_rcnn/vgg16 is not ported yet (ROADMAP queue 1, other backbones)"
            )
        raise ValueError(f"unknown backbone {backbone} for faster_rcnn")
    if model_type == "fpn":
        raise NotImplementedError("fpn is not ported yet (ROADMAP queue 1, FPN serving)")
    raise ValueError(f"unknown model type {model_type}")

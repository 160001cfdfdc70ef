"""Model construction (port of `tf_eager_object_detection_tpu/models/model_factory.py`).

    model_factory("faster_rcnn", "vgg16", cfg)                # on the card
    model_factory("fpn", "resnet50", cfg, device="cpu", seed=0)

Faster R-CNN takes vgg16 or resnet50/101/152, FPN a ResNet (its
`tpu_fpn_backbone_style` picks the keras or the slim one); anything else
raises ValueError, as in JAX. Detectors run on the card unless `device`
says otherwise; asking for CUDA where there is none raises.
"""

from __future__ import annotations

from tf_eager_object_detection_tpu_torch.models.faster_rcnn import FasterRCNNDetector
from tf_eager_object_detection_tpu_torch.models.fpn import FPNDetector

__all__ = ["model_factory"]

_DETECTORS = {"faster_rcnn": FasterRCNNDetector, "fpn": FPNDetector}


def model_factory(model_type: str, backbone: str, config: dict, device="cuda", seed: int = 0):
    if model_type not in _DETECTORS:
        raise ValueError(f"unknown model type {model_type}")
    return _DETECTORS[model_type](backbone, config, device=device, seed=seed)

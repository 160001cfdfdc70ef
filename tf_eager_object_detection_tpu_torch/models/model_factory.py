"""Model construction (port of `tf_eager_object_detection_tpu/models/model_factory.py`).

    model_factory("faster_rcnn", "resnet50", cfg)             # on the card
    model_factory("fpn", "resnet50", cfg, device="cpu", seed=0)

Detectors run on the card unless `device` says otherwise; asking for CUDA
where there is none raises.
"""

from __future__ import annotations

from tf_eager_object_detection_tpu_torch.models.detector import RESNET_DEPTHS
from tf_eager_object_detection_tpu_torch.models.faster_rcnn import FasterRCNNDetector
from tf_eager_object_detection_tpu_torch.models.fpn import FPNDetector

__all__ = ["model_factory"]

_DETECTORS = {"faster_rcnn": FasterRCNNDetector, "fpn": FPNDetector}


def model_factory(model_type: str, backbone: str, config: dict, device="cuda", seed: int = 0):
    if model_type not in _DETECTORS:
        raise ValueError(f"unknown model type {model_type}")
    if backbone in RESNET_DEPTHS:
        return _DETECTORS[model_type](backbone, config, device=device, seed=seed)
    if model_type == "faster_rcnn" and backbone == "vgg16":
        raise NotImplementedError(
            "faster_rcnn/vgg16 is not ported yet (ROADMAP item 6, other backbones)"
        )
    raise ValueError(f"unknown backbone {backbone} for {model_type}")

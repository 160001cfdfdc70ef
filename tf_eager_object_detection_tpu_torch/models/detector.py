"""What the port's two detectors share: device placement, seeded random
weights and the serving entry points.

- `predict(image, image_hw)` -> padded `Detections` for one image.
- `im_detect(image, image_hw, scale)` / `im_detect_batch(images, image_hw,
  scales)` -> raw-head outputs with rois rescaled by 1/scale, for the eval
  writers.

A subclass builds its modules, calls `_place(seed)`, and defines
`_detect(images, image_hw) -> (rois [B, R, 4], roi_valid [B, R],
roi_softmax [B, R, C], roi_deltas [B, R, C, 4])` and `min_edge`, the
smallest box side `predict` keeps.

Serving is float32 with TF32 off: on a CUDA device `_place` sets
`torch.backends.cudnn.allow_tf32` and `torch.backends.cuda.matmul.allow_tf32`
to False for the process. Entry points run on the card unless the caller
asks for the CPU; asking for CUDA where there is none raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from tf_eager_object_detection_tpu_torch.ops.prediction import Detections, post_ops_prediction

__all__ = ["ServingDetector", "resolve_device", "RESNET_DEPTHS"]

RESNET_DEPTHS = {"resnet50": 50, "resnet101": 101, "resnet152": 152}


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


class ServingDetector(nn.Module):
    model_type: str
    min_edge: float
    # init std of the layers the flax modules initialize with a fixed normal
    _FIXED_INIT_STD: Dict[str, float] = {}

    def __init__(self, backbone: str, config: Dict[str, Any], device):
        super().__init__()
        self.device = resolve_device(device)
        cfg = dict(config)
        if backbone not in RESNET_DEPTHS:
            raise NotImplementedError(
                f"backbone {backbone!r} is not ported yet (ROADMAP queue 1, other backbones)"
            )
        if cfg.get("tpu_compute_dtype", "float32") != "float32":
            raise NotImplementedError("the port serves float32 only; bf16 is a later item")
        self.cfg = cfg
        self.backbone_name = backbone
        self.num_classes = cfg["num_classes"]
        self.clip_deltas = not cfg.get("strict_reference_parity", False)

    def _init_std(self, name: str, fan_in: int) -> float:
        """Lecun normal (std = fan_in ** -0.5) unless the layer has a fixed std."""
        return self._FIXED_INIT_STD.get(name, 1.0 / math.sqrt(fan_in))

    @torch.no_grad()
    def _place(self, seed: int) -> None:
        """Seeded random init (normal draws from a CPU torch.Generator), then
        move to `self.device` and switch to eval."""
        gen = torch.Generator().manual_seed(seed)
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                std = self._init_std(name, mod.weight[0].numel())
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * std)
                mod.bias.zero_()
        self.to(self.device).eval()
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

    def _as_inputs(self, images, image_hw):
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        image_hw = torch.as_tensor(image_hw, device=self.device).long()
        return images, image_hw

    def _detect(self, images: torch.Tensor, image_hw: torch.Tensor):
        raise NotImplementedError

    @torch.inference_mode()
    def predict(self, image, image_hw) -> Detections:
        """Single padded image [Hp, Wp, 3] -> padded Detections."""
        cfg = self.cfg
        images, hw = self._as_inputs(image, image_hw)
        rois, roi_valid, roi_softmax, roi_deltas = self._detect(images[None], hw[None])
        return post_ops_prediction(
            roi_softmax[0],
            roi_deltas[0],
            rois[0],
            roi_valid[0],
            hw[0],
            hw[1],
            target_means=tuple(cfg["roi_proposal_means"]),
            target_stds=tuple(cfg["roi_proposal_stds"]),
            max_num_per_class=cfg["max_objects_per_class_per_image"],
            max_num_per_image=cfg["max_objects_per_image"],
            nms_iou_threshold=cfg["prediction_nms_iou_threshold"],
            score_threshold=cfg["prediction_score_threshold"],
            min_edge=self.min_edge,
            num_classes=self.num_classes,
            clip_deltas=self.clip_deltas,
        )

    @torch.inference_mode()
    def im_detect_batch(self, images, image_hw, scales):
        """images [B, Hp, Wp, 3], image_hw [B, 2], scales [B] ->
        (roi_softmax [B, R, C], roi_deltas [B, R, C, 4], rois/scale [B, R, 4],
        roi_valid [B, R])."""
        images, hw = self._as_inputs(images, image_hw)
        scales = torch.as_tensor(scales, dtype=torch.float32, device=self.device)
        rois, roi_valid, roi_softmax, roi_deltas = self._detect(images, hw)
        return roi_softmax, roi_deltas, rois / scales[:, None, None], roi_valid

    def im_detect(self, image, image_hw, scale):
        """Raw-head eval API for one image: (roi_softmax [R, C], roi_deltas
        [R, C, 4], rois/scale [R, 4], roi_valid [R])."""
        out = self.im_detect_batch(
            torch.as_tensor(image)[None], torch.as_tensor(image_hw)[None],
            torch.as_tensor(scale, dtype=torch.float32)[None],
        )
        return tuple(t[0] for t in out)
